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
                 "shadow_tpu_torch/core/manager.py"):
        assert want in files


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


def test_torch_config_defaults_pinned():
    """Experimental defaults the slice reads equal the reference's."""
    from shadow_tpu.core.config import ExperimentalConfig as R
    from shadow_tpu_torch.core.config import ExperimentalConfig as P
    r, p = R(), P()
    for f in p.__dataclass_fields__:
        assert getattr(p, f) == getattr(r, f), f
