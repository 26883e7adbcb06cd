"""The port's package rules: it imports nothing of JAX and nothing of the
JAX package, and every constant it copies equals the reference value.
"""

import ast
import os

import pytest

import shadow_tpu_torch

_PKG = os.path.dirname(os.path.abspath(shadow_tpu_torch.__file__))
_ROOT = os.path.dirname(_PKG)


def _port_files():
    out = [os.path.join(_ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(_PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, _ROOT) for p in out)


def _banned(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "shadow_tpu")


@pytest.mark.parametrize("rel", _port_files())
def test_torch_port_imports_no_jax(rel):
    with open(os.path.join(_ROOT, rel)) as f:
        tree = ast.parse(f.read(), filename=rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _banned(node.module):
            bad.append(node.module)
    assert not bad, f"{rel} imports {bad}"


def test_torch_port_file_list_is_complete():
    files = _port_files()
    for want in ("chip_smoke.py", "shadow_tpu_torch/ops/tcp_span.py",
                 "shadow_tpu_torch/ops/phold_span.py",
                 "shadow_tpu_torch/ops/queues.py",
                 "shadow_tpu_torch/ops/propagate.py",
                 "shadow_tpu_torch/tools/netgen.py",
                 "shadow_tpu_torch/tools/phold_span_profile.py",
                 "shadow_tpu_torch/tools/phold_span_ab.py",
                 "shadow_tpu_torch/core/manager.py",
                 "shadow_tpu_torch/core/config.py",
                 "shadow_tpu_torch/core/propagate_scalar.py",
                 "shadow_tpu_torch/trace/events.py",
                 "shadow_tpu_torch/trace/metrics.py",
                 "shadow_tpu_torch/trace/audit.py",
                 "shadow_tpu_torch/utils/object_counter.py",
                 "shadow_tpu_torch/utils/shadow_log.py",
                 "shadow_tpu_torch/utils/status_bar.py",
                 "shadow_tpu_torch/utils/pcap.py",
                 "shadow_tpu_torch/trace/recorder.py",
                 "shadow_tpu_torch/trace/netstat.py",
                 "shadow_tpu_torch/trace/fabricstat.py",
                 "shadow_tpu_torch/trace/kernstat.py",
                 "shadow_tpu_torch/trace/chrome.py",
                 "shadow_tpu_torch/tools/trace.py",
                 "shadow_tpu_torch/__main__.py") + tuple(
            f"shadow_tpu_torch/{m}.py" for m in _COPIES) + (
            "shadow_tpu_torch/host/process.py",
            "shadow_tpu_torch/host/syscalls.py"):
        assert want in files


# The object path's modules, each the port's copy of the JAX package's
# module of the same path.
_COPIES = ("core/event", "net/packet", "net/token_bucket", "net/codel",
           "net/router", "net/relay", "net/interface", "net/dns_wire",
           "host/status", "host/condition", "host/descriptor", "host/cpu",
           "host/socket_udp", "host/socket_tcp", "tcp/connection",
           "tcp/__init__", "host/apps", "host/host", "host/process",
           "host/syscalls", "core/propagate_scalar",
           # the managed path's
           "host/shim_abi", "host/child_watcher", "host/futex",
           "host/signals", "host/files", "host/epoll", "host/socket_unix",
           "host/socket_netlink", "host/socket_native",
           "host/syscalls_native", "host/managed",
           "svc/plane", "svc/containment")


def _module(path: str, pkg: str):
    import importlib
    name = f"{pkg}.{path.replace('/', '.')}".removesuffix(".__init__")
    return importlib.import_module(name)


def _constants(mod) -> dict:
    """Every module-level UPPER_CASE value of plain data (the copied
    constants: sizes, times, flags, names, tables)."""
    out = {}
    for n, v in vars(mod).items():
        if n.isupper() and not n.startswith("__") and isinstance(
                v, (int, float, str, bytes, tuple, frozenset, dict)):
            if isinstance(v, dict):
                # a registry of classes or functions: by their names
                v = {k: getattr(x, "__name__", x) for k, x in v.items()}
            out[n] = v
    return out


@pytest.mark.parametrize("path", _COPIES)
def test_torch_object_path_constants_pinned(path):
    """Every constant a copied object-path or managed-path module keeps
    equals the JAX package's value of the same name (the shim's IPC ABI
    in host/shim_abi.py among them), and each such module keeps one."""
    port = _constants(_module(path, "shadow_tpu_torch"))
    ref = _constants(_module(path, "shadow_tpu"))
    for n, v in port.items():
        assert n in ref, f"{path}: {n} is not the reference's"
        assert v == ref[n], f"{path}: {n}"
    if path not in ("tcp/__init__", "core/propagate_scalar", "net/router",
                    "host/syscalls", "host/process", "host/descriptor",
                    "host/condition", "host/cpu", "host/futex",
                    "host/child_watcher",
                    "host/epoll", "host/socket_unix", "svc/plane"):
        assert port, path


def test_torch_object_path_tables_pinned():
    """The tables the object path reads from trace/events.py and the app
    registry's names."""
    from shadow_tpu.host import apps as ref_apps
    from shadow_tpu.trace import events as ref
    from shadow_tpu_torch.host import apps as port_apps
    from shadow_tpu_torch.trace import events as port
    assert port.TEL_BY_REASON == ref.TEL_BY_REASON
    assert (port.MARK_THRESH_PKTS, port.MARK_THRESH_BYTES) == \
        (ref.MARK_THRESH_PKTS, ref.MARK_THRESH_BYTES)
    assert (port.SC_SERVICED, port.SC_PARKED, port.SC_NATIVE,
            port.SC_SHIM, port.SC_PROTO) == \
        (ref.SC_SERVICED, ref.SC_PARKED, ref.SC_NATIVE, ref.SC_SHIM,
         ref.SC_PROTO)
    assert (port.RC_OK, port.RC_ERR, port.RC_NATIVE, port.RC_NONE,
            port.RC_NAMES) == (ref.RC_OK, ref.RC_ERR, ref.RC_NATIVE,
                               ref.RC_NONE, ref.RC_NAMES)
    assert sorted(port_apps.APP_REGISTRY) == sorted(ref_apps.APP_REGISTRY)


# (port module, JAX module, names): every copied constant, pinned.
_TCP = ("C_IDLE C_R1 C_R2 C_TCPIN C_DRAIN C_ACKDATA C_PUSH C_FLUSH C_ARM "
        "C_APP C_TMR TK_RELAY TK_TCP TK_APP S_READABLE S_WRITABLE "
        "ASYS_SEND ASYS_RECV ASYS_N F_FIN F_SYN F_RST F_PSH F_ACK F_ECE "
        "F_CWR MSS ECN_ECT0 ECN_CE DCTCP_SHIFT DCTCP_G_SHIFT "
        "DCTCP_MAX_ALPHA DCTCP_K_PKTS DCTCP_K_BYTES CC_DCTCP "
        "MARK_THRESH_PKTS MARK_THRESH_BYTES MARK_N MAX_WINDOW "
        "TCP_TOTAL_HDR MIN_RTO_NS MAX_RTO_NS DELACK_NS WMEM_MAX RMEM_MAX "
        "MTU CODEL_TARGET_NS CODEL_HARD_LIMIT REFILL_NS TR_SND TR_DRP "
        "TR_RCV RSN_CODEL RSN_RTRLIMIT RSN_LOSS RSN_UNREACH RSN_HOSTDOWN "
        "RSN_LINKDOWN TEL_CODEL TEL_RTR_LIMIT TEL_LOSS_EDGE "
        "TEL_UNREACHABLE TEL_HOST_DOWN TEL_LINK_DOWN TEL_REASM_FULL "
        "TEL_RECVWIN_TRUNC TEL_N AB_TRACE AB_OUT AB_STRUCT "
        "ROUTE_KEYS TCP_KEYS PK_KEYS").split()
_PHOLD = ("I64_MAX C_IDLE C_R1 C_R2 C_M_STEP C_S_STEP C_M_RECV C_S_POST "
          "TK_RELAY TK_APP TK_APP_TIMEOUT S_READABLE S_WRITABLE "
          "ASYS_SENDTO ASYS_RECVFROM ASYS_NANOSLEEP ASYS_N "
          "PAYLOAD_LEN MTU CODEL_TARGET_NS CODEL_HARD_LIMIT REFILL_NS "
          "TR_SND TR_DRP TR_RCV RSN_NONE RSN_RCVBUF RSN_NOSOCK RSN_NOROUTE "
          "RSN_LOSS RSN_UNREACH RSN_HOSTDOWN RSN_LINKDOWN TEL_CODEL "
          "TEL_RTR_LIMIT TEL_LOSS_EDGE TEL_UNREACHABLE TEL_NO_ROUTE "
          "TEL_NO_SOCKET TEL_RECVBUF_FULL TEL_HOST_DOWN TEL_LINK_DOWN "
          "TEL_N KS_POP KS_STEP KS_CODEL KS_INET_OUT KS_ARM KS_TIMERS "
          "KS_N PK_KEYS AB_TRACE AB_OUT AB_STRUCT").split()
_EVENTS = ("EL_DEVICE_SPAN EL_ENGINE_SPAN EL_ENGINE_ROUTED EL_ENGINE_COLD "
           "EL_ENGINE_ABORT EL_ENGINE_TRANSIENT EL_ENGINE_FAMILY "
           "EL_ENGINE_OFF EL_ENGINE_PYLIMIT EL_ROUND_BOUNDARY "
           "EL_ROUND_OUTBOX EL_ROUND_GATE EL_ROUND_CALLBACK "
           "EL_ROUND_FORCED EL_ROUND_SCHED EL_OBJ_PCAP EL_OBJ_CPU "
           "EL_OBJ_PYTASK EL_OBJ_OTHER EL_DEVICE_SHARDED "
           "EL_ENGINE_EXCHANGE EL_ENGINE_UNSHARDED EL_SVC_QUIESCENT EL_N "
           "EL_NAMES TEL_CODEL TEL_RTR_LIMIT TEL_WIRE_N TEL_N TEL_NAMES "
           "MARK_N MARK_NAMES SC_N SC_NAMES "
           # the sim-time channels' tables and record layouts
           "FLIGHT_REC_BYTES FR_ROUND FR_SPAN_START FR_SPAN_COMMIT "
           "FR_SPAN_ABORT FR_FAULT_KILL FR_FAULT_RESTORE FR_FAULT_LINK_DOWN "
           "FR_FAULT_LINK_UP FR_FAULT_BLACKHOLE FR_FAULT_CLEAR "
           "FR_FAULT_QUARANTINE FR_N REC.format REC.size REC_DTYPE FAM_CPP "
           "FAM_PHOLD FAM_TCP FAM_NAMES TEL_LOSS_EDGE TEL_UNREACHABLE "
           "TEL_NO_ROUTE TEL_NO_SOCKET TEL_TCP_STATE TEL_BACKLOG_FULL "
           "TEL_UDP_FILTER TEL_RECVBUF_FULL TEL_BUCKET_DEFER TEL_HOST_DOWN "
           "TEL_LINK_DOWN TEL_REASM_FULL TEL_RECVWIN_TRUNC TEL_REC_BYTES "
           "TEL_REC.format TEL_DTYPE FB_ACT_CODEL FB_ACT_TB_OUT FB_ACT_TB_IN "
           "FB_ACT_LINK FB_REC_BYTES FB_REC.format FB_DTYPE FCT_F_COMPLETE "
           "FCT_F_RECEIVER FCT_REC_BYTES FCT_REC.format FCT_DTYPE FAB_MAGIC "
           "FAB_VERSION FAB_HDR.format FAB_HDR_BYTES KS_POP KS_STEP "
           "KS_CODEL KS_ON_PACKET KS_REASM KS_ACK KS_PUSH KS_FLUSH "
           "KS_INET_OUT KS_ARM KS_TIMERS KS_EXCHANGE KS_N KS_NAMES "
           "KS_REC_BYTES KS_REC.format").split()
PINS = (
    [("shadow_tpu_torch.ops.phold_span", "shadow_tpu.ops.phold_span", n, n)
     for n in _PHOLD]
    + [("shadow_tpu_torch.ops.phold_span", "shadow_tpu.ops.phold_span",
        f"PholdSpanRunner.{n}", f"PholdSpanRunner.{n}")
       for n in ("CAP_I", "CAP_T", "CAP_R", "CAP_S", "CAP_C", "CAP_P",
                 "MAX_ROUNDS")]
    + [("shadow_tpu_torch.ops.phold_span", "shadow_tpu.ops.pallas_queues",
        "CODEL_INTERVAL_NS", "CODEL_INTERVAL_NS")]
    + [("shadow_tpu_torch.ops.queues", "shadow_tpu.ops.phold_span", n, n)
       for n in ("REFILL_NS", "CODEL_TARGET_NS", "MTU")]
    + [("shadow_tpu_torch.ops.tcp_span", "shadow_tpu.ops.tcp_span", n, n)
       for n in _TCP]
    + [("shadow_tpu_torch.ops.tcp_span", "shadow_tpu.ops.tcp_span",
        f"TcpSpanRunner.{n}", f"TcpSpanRunner.{n}")
       for n in ("CAP_I", "CAP_T", "CAP_CQ", "CAP_OP", "MAX_ROUNDS")]
    + [("shadow_tpu_torch.ops.span_mesh", "shadow_tpu.ops.span_mesh", n, n)
       for n in ("AB_TRACE", "AB_OUT", "AB_STRUCT", "AB_EXCH")]
    # The residency classes of both families' codec columns.
    + [(f"shadow_tpu_torch.ops.{m}", f"shadow_tpu.ops.{m}", n, n)
       for m in ("phold_span", "tcp_span")
       for n in ("RESIDENT_STATIC", "RESIDENT_DERIVED", "RESIDENT_CARRIED")]
    + [("shadow_tpu_torch.ops.queues", "shadow_tpu.ops.pallas_queues",
        "CODEL_INTERVAL_NS", "CODEL_INTERVAL_NS")]
    + [("shadow_tpu_torch.core.rng", "shadow_tpu.core.rng", n, n)
       for n in ("STREAM_PACKET_LOSS", "STREAM_HOST", "_PARITY", "_ROT_A",
                 "_ROT_B")]
    + [("shadow_tpu_torch.core.simtime", "shadow_tpu.core.simtime", n, n)
       for n in ("NSEC_PER_USEC", "NSEC_PER_MSEC", "NSEC_PER_SEC",
                 "EMUTIME_SIMULATION_START", "TIME_NEVER",
                 "SIMTIME_INVALID")]
    + [("shadow_tpu_torch.host.engine_app", "shadow_tpu.host.engine_app",
        n, n) for n in ("KIND_SERVER", "KIND_CLIENT", "KIND_UDP_FLOOD",
                        "KIND_UDP_SINK", "KIND_UDP_MESH", "KIND_PHOLD",
                        "KIND_UDP_ECHO", "KIND_UDP_PING")]
    + [("shadow_tpu_torch.host.host", "shadow_tpu.core.event", n, n)
       for n in ("KIND_PACKET", "KIND_LOCAL")]
    + [("shadow_tpu_torch.core.config", "shadow_tpu.core.config", n, n)
       for n in ("SCHEDULERS", "QDISC_MODES")]
    # The per-round propagator's route law.
    + [("shadow_tpu_torch.ops.propagate", "shadow_tpu.ops.propagate", n, n)
       for n in ("_MIN_BUCKET", "ROUTE_HOST", "ROUTE_DEVICE", "ROUTE_PROBE",
                 "DeviceRouteModel.REPROBE_EVERY",
                 "DeviceRouteModel.REPROBE_CAP",
                 "DeviceRouteModel.PROBE_BUDGET_FRAC")]
    + [("shadow_tpu_torch.ops.propagate", "shadow_tpu.ops.propagate",
        "I64_MAX", "_I64_MAX")]
    # The reason and cause tables the run outputs name.
    + [("shadow_tpu_torch.trace.events", "shadow_tpu.trace.events", n, n)
       for n in _EVENTS]
    + [("shadow_tpu_torch.trace.metrics", "shadow_tpu.trace.metrics",
        "CHANNELS", "CHANNELS")]
    # The channel writers' constants and the span loops' sample rows.
    + [("shadow_tpu_torch.trace.fabricstat", "shadow_tpu.tcp.connection",
        "MSS", "MSS")]
    + [("shadow_tpu_torch.utils.pcap", "shadow_tpu.net.packet",
        "PROTO_UDP", "PROTO_UDP")]
    + [("shadow_tpu_torch.ops.tcp_span", "shadow_tpu.ops.tcp_span",
        f"TcpSpanRunner.{n}", f"TcpSpanRunner.{n}")
       for n in ("TEL_ROWS", "FAB_ROWS")]
    + [("shadow_tpu_torch.ops.tcp_span", "shadow_tpu.ops.tcp_span", n, n)
       for n in ("TEL_FIELDS", "ST_ESTABLISHED")]
    + [("shadow_tpu_torch.ops.phold_span", "shadow_tpu.ops.phold_span",
        "PholdSpanRunner.FAB_ROWS", "PholdSpanRunner.FAB_ROWS")]
    + [("shadow_tpu_torch.core.config", "shadow_tpu.core.config",
        "ON_FAILURE_POLICIES", "ON_FAILURE_POLICIES")]
    # The reports' constants: the Chrome export's processes and track
    # cap, the kernel observatory's bounds and dispatch keys.
    + [("shadow_tpu_torch.trace.chrome", "shadow_tpu.trace.chrome", n, n)
       for n in ("PID_SIM", "PID_WALL", "PID_NETSTAT", "PID_SYSCALL",
                 "PID_FABRIC", "PID_KERN", "DEFAULT_TOP_N")]
    + [("shadow_tpu_torch.trace.kernstat", "shadow_tpu.trace.kernstat", n, n)
       for n in ("STAGE_MAX_PASSES", "LOW_OCCUPANCY_PERMILLE",
                 "DISPATCH_KEYS")]
)


def _get(modname, path):
    import importlib
    obj = importlib.import_module(modname)
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("port_mod,ref_mod,port_name,ref_name", PINS,
                         ids=[f"{p.split('.')[-1]}.{n}"
                              for p, _r, n, _rn in PINS])
def test_torch_constant_pinned(port_mod, ref_mod, port_name, ref_name):
    assert _get(port_mod, port_name) == _get(ref_mod, ref_name)


def test_torch_packet_dtypes_pinned():
    """The codec's column dtypes (the port widens them to int64 on the
    device and restores them for the engine import)."""
    from shadow_tpu.ops import tcp_span as ref
    from shadow_tpu_torch.ops import tcp_span as port
    assert port.PK_DTYPES == ref.PK_DTYPES


@pytest.mark.parametrize("loop", ["tcp_span", "phold_span"])
def test_torch_span_loop_causes_name_the_tables_entries(loop):
    """The drop-cause indices the span loops keep stay where they are;
    each names the same cause in the port's table as in the JAX
    package's."""
    import importlib

    from shadow_tpu.trace import events as ref
    from shadow_tpu_torch.trace import events as port
    mod = importlib.import_module(f"shadow_tpu_torch.ops.{loop}")
    names = [n for n in dir(mod) if n.startswith("TEL_")
             and isinstance(getattr(mod, n), int) and n != "TEL_N"]
    assert names
    for n in names:
        assert port.TEL_NAMES[getattr(mod, n)] == \
            ref.TEL_NAMES[getattr(ref, n)], n
    assert mod.TEL_N == port.TEL_N


@pytest.mark.parametrize("cls", ["GeneralConfig", "ExperimentalConfig"])
def test_torch_config_sections_carry_every_reference_field(cls):
    """Every field of the reference's section, at its default (so
    processed-config.yaml can carry it)."""
    import shadow_tpu.core.config as ref
    import shadow_tpu_torch.core.config as port
    r, p = getattr(ref, cls)(), getattr(port, cls)()
    assert list(p.__dataclass_fields__) == list(r.__dataclass_fields__)
    for f in p.__dataclass_fields__:
        assert getattr(p, f) == getattr(r, f), f


def test_torch_config_defaults_pinned():
    """Experimental defaults the slice reads equal the reference's."""
    from shadow_tpu.core.config import ExperimentalConfig as R
    from shadow_tpu_torch.core.config import ExperimentalConfig as P
    r, p = R(), P()
    for f in p.__dataclass_fields__:
        assert getattr(p, f) == getattr(r, f), f
