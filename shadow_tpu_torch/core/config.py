"""Simulation configuration: the same YAML as the JAX package.

The port's copy of `shadow_tpu/core/config.py` (`ConfigOptions`): it
reads the same sections, keys and unit syntax, and keeps the values
this slice serves.  A key or value that needs a path the port has not
ported yet raises NotImplementedError naming the ROADMAP item, instead
of running some other path silently.

The slice: engine-resident hosts (the tgen TCP apps and the UDP/PHOLD
apps) under `experimental.scheduler: tpu`: the TCP and PHOLD/udp-mesh
device spans and the per-round propagation kernel on the card, the C++
engine serving every round the device does not (C++ spans, and the
per-round rounds the route model gives its twin).
`tpu_min_device_batch <= 0` forces every round through the kernel.
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass, field
from typing import Any

import yaml

from shadow_tpu_torch.host.engine_app import ENGINE_ARGC, argv_fits
from shadow_tpu_torch.net import graph as netgraph
from shadow_tpu_torch.utils import units

SCHEDULERS = ("thread_per_core", "thread_per_host", "serial", "tpu")
QDISC_MODES = ("fifo", "round_robin")

# ROADMAP queue A items that the refusals below name.
_RM_OBJECT = ("ROADMAP A2b (object-path hosts and the propagator's "
              "object leg)")
_RM_CLI = "ROADMAP A4 (port CLI and bench)"
_RM_SHARDED = "ROADMAP A5 (sharded multi-GPU)"
_RM_OBS = ("ROADMAP A7 (observatories, checkpoint and faults, managed "
           "processes)")


def _onoff(v):
    """YAML 1.1 reads bare on/off as booleans; accept both spellings."""
    return ("on" if v else "off") if isinstance(v, bool) else str(v)


@dataclass
class ProcessConfig:
    path: str
    args: list[str] = field(default_factory=list)
    start_time_ns: int = 0
    expected_final_state: Any = "exited 0"


@dataclass
class HostConfig:
    name: str
    network_node_id: int
    processes: list[ProcessConfig]
    ip_addr: int | None = None
    bandwidth_down_bits: int | None = None  # overrides graph-node default
    bandwidth_up_bits: int | None = None
    tcp_cc: str = "reno"
    tcp_ecn: bool = False


@dataclass
class GeneralConfig:
    stop_time_ns: int = 0
    seed: int = 1
    bootstrap_end_time_ns: int = 0
    parallelism: int = 0  # 0 = auto (num cores)
    data_directory: str = "shadow.data"


@dataclass
class NetworkConfig:
    graph: netgraph.NetworkGraph = None
    use_shortest_path: bool = True


@dataclass
class ExperimentalConfig:
    scheduler: str = "thread_per_core"
    runahead_ns: int | None = None  # None = auto (graph min latency)
    use_dynamic_runahead: bool = False
    interface_qdisc: str = "fifo"
    socket_send_buffer: int = 131_072
    socket_recv_buffer: int = 174_760
    socket_send_autotune: bool = True
    socket_recv_autotune: bool = True
    tpu_min_device_batch: int = 2048
    tpu_device_spans: str = "auto"
    span_overlap: str = "auto"
    # Accepted for YAML compatibility: in the port the hand kernels run
    # whenever the span state lies on the card, whatever this says.
    pallas_queue_kernels: str = "off"
    dev_span_k_init: int = 32
    dev_span_k_floor: int = 16
    dev_span_k_shrink: int = 4
    dctcp_k_pkts: int = 20
    dctcp_k_bytes: int = 30_000


# experimental keys this slice reads: yaml key -> (attr, converter).
_EXP_KEYS = {
    "scheduler": ("scheduler", str),
    "runahead": ("runahead_ns", units.parse_time_ns),
    "use_dynamic_runahead": ("use_dynamic_runahead", bool),
    "interface_qdisc": ("interface_qdisc", str),
    "socket_send_buffer": ("socket_send_buffer", units.parse_bytes),
    "socket_recv_buffer": ("socket_recv_buffer", units.parse_bytes),
    "socket_send_autotune": ("socket_send_autotune", bool),
    "socket_recv_autotune": ("socket_recv_autotune", bool),
    "tpu_min_device_batch": ("tpu_min_device_batch", int),
    "tpu_device_spans": ("tpu_device_spans", _onoff),
    "span_overlap": ("span_overlap", _onoff),
    "pallas_queue_kernels": ("pallas_queue_kernels", _onoff),
    "dev_span_k_init": ("dev_span_k_init", int),
    "dev_span_k_floor": ("dev_span_k_floor", int),
    "dev_span_k_shrink": ("dev_span_k_shrink", int),
    "dctcp_k_pkts": ("dctcp_k_pkts", int),
    "dctcp_k_bytes": ("dctcp_k_bytes", units.parse_bytes),
}

# Reference keys that change nothing on the engine-resident path
# (managed-process timing, sharded sizing, wall-side knobs;
# tpu_max_packets_per_round chunks only the object path's sends, A2b).
_EXP_INERT = frozenset({
    "max_unapplied_cpu_latency", "unblocked_syscall_latency",
    "unblocked_vdso_latency", "native_preemption_enabled",
    "native_preemption_native_interval",
    "native_preemption_sim_interval", "native_file_io_bandwidth",
    "tpu_max_packets_per_round", "tpu_exchange_capacity",
    "tpu_donate_buffers", "chrome_top_n", "syscall_service_plane",
    "managed_death_poll", "managed_watchdog", "managed_spawn_stagger",
    "pcap_span_cap", "use_cpu_pinning", "report_errors_to_stderr",
    "netstat_interval", "fabricstat_interval",
})

# Reference keys whose value needs an unported path: yaml key ->
# (predicate on the raw value that says the path is needed, ROADMAP item).
_EXP_REFUSED = {
    "strace_logging_mode": (lambda v: _onoff(v) != "off", _RM_OBS),
    "host_cpu_threshold": (lambda v: v is not None, _RM_OBJECT),
    "host_cpu_precision": (lambda v: v is not None, _RM_OBJECT),
    "host_cpu_event_cost": (lambda v: units.parse_time_ns(v) != 0,
                            _RM_OBJECT),
    "tpu_shards": (lambda v: int(v) != 1, _RM_SHARDED),
    "native_dataplane": (lambda v: _onoff(v) == "off", _RM_OBJECT),
    "flight_recorder": (lambda v: _onoff(v) != "off", _RM_OBS),
    "sim_netstat": (lambda v: _onoff(v) != "off", _RM_OBS),
    "sim_fabricstat": (lambda v: _onoff(v) != "off", _RM_OBS),
    "syscall_observatory": (lambda v: _onoff(v) != "off", _RM_OBS),
    "kernel_observatory": (lambda v: _onoff(v) != "off", _RM_OBS),
    "openssl_crypto_noop": (bool, _RM_OBS),
    "use_perf_timers": (bool, _RM_OBJECT),
}


def _refuse(what: str, item: str):
    raise NotImplementedError(
        f"shadow_tpu_torch does not serve {what} yet: {item}")


@dataclass
class ConfigOptions:
    general: GeneralConfig
    network: NetworkConfig
    experimental: ExperimentalConfig
    hosts: dict[str, HostConfig]

    @classmethod
    def from_yaml_text(cls, text: str,
                       base_dir: str = ".") -> "ConfigOptions":
        raw = yaml.safe_load(text)
        if not isinstance(raw, dict):
            raise ValueError("config root must be a mapping")
        return cls.from_dict(raw, base_dir=base_dir)

    @classmethod
    def from_file(cls, path: str) -> "ConfigOptions":
        import os
        with open(path) as f:
            return cls.from_yaml_text(f.read(),
                                      base_dir=os.path.dirname(path) or ".")

    @classmethod
    def from_dict(cls, raw: dict, base_dir: str = ".") -> "ConfigOptions":
        raw = {k: v for k, v in raw.items() if not str(k).startswith("x-")}
        unknown = set(raw) - {"general", "network", "experimental",
                              "hosts", "host_option_defaults",
                              "checkpoint", "faults"}
        if unknown:
            raise ValueError(f"unknown config sections: {sorted(unknown)}")
        if raw.get("checkpoint") is not None:
            _refuse("checkpoint:", _RM_OBS)
        if raw.get("faults"):
            _refuse("faults:", _RM_OBS)

        g = raw.get("general", {}) or {}
        if bool(g.get("progress", False)):
            _refuse("general.progress (heartbeat lines)", _RM_CLI)
        general = GeneralConfig(
            stop_time_ns=units.parse_time_ns(
                _require(g, "stop_time", "general")),
            seed=int(g.get("seed", 1)),
            bootstrap_end_time_ns=units.parse_time_ns(
                g.get("bootstrap_end_time", 0)),
            parallelism=int(g.get("parallelism", 0)),
            data_directory=str(g.get("data_directory", "shadow.data")),
        )

        n = raw.get("network", {}) or {}
        network = NetworkConfig(
            graph=_load_graph(_require(n, "graph", "network"), base_dir),
            use_shortest_path=bool(n.get("use_shortest_path", True)),
        )

        experimental = _experimental(raw.get("experimental", {}) or {})
        hosts = _hosts(raw)
        return cls(general=general, network=network,
                   experimental=experimental, hosts=hosts)


def _experimental(e: dict) -> ExperimentalConfig:
    out = ExperimentalConfig()
    for key, v in e.items():
        if key in _EXP_KEYS:
            attr, conv = _EXP_KEYS[key]
            setattr(out, attr, conv(v))
        elif key in _EXP_REFUSED:
            needs, item = _EXP_REFUSED[key]
            if needs(v):
                _refuse(f"experimental.{key}: {v}", item)
        elif key not in _EXP_INERT:
            raise ValueError(f"unknown experimental key {key!r}")
    if out.scheduler not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {out.scheduler!r}; "
                         f"expected one of {SCHEDULERS}")
    if out.scheduler != "tpu":
        _refuse(f"scheduler: {out.scheduler} (the object path)",
                _RM_OBJECT)
    if out.interface_qdisc not in QDISC_MODES:
        raise ValueError(f"unknown interface_qdisc "
                         f"{out.interface_qdisc!r}")
    if out.tpu_device_spans not in ("auto", "force", "on", "off"):
        raise ValueError(f"unknown tpu_device_spans "
                         f"{out.tpu_device_spans!r}")
    if out.span_overlap not in ("off", "on", "auto"):
        raise ValueError(f"unknown span_overlap {out.span_overlap!r}")
    if out.pallas_queue_kernels not in ("off", "on"):
        raise ValueError(f"unknown pallas_queue_kernels "
                         f"{out.pallas_queue_kernels!r}")
    for k in ("dev_span_k_init", "dev_span_k_floor", "dev_span_k_shrink",
              "dctcp_k_pkts", "dctcp_k_bytes"):
        if getattr(out, k) < 1:
            raise ValueError(f"{k} must be >= 1")
    return out


def _tcp_block(section: str, d) -> tuple[str, bool]:
    """One `tcp:` block -> (cc, ecn)."""
    if not isinstance(d, dict):
        raise ValueError(f"{section}.tcp: must be a mapping")
    unknown = set(d) - {"cc", "ecn"}
    if unknown:
        raise ValueError(f"{section}.tcp: unknown key(s) {sorted(unknown)}")
    cc = str(d.get("cc", "reno"))
    if cc not in ("reno", "dctcp"):
        raise ValueError(f"{section}.tcp.cc: expected one of "
                         f"('reno', 'dctcp'), got {cc!r}")
    ecn = d.get("ecn", False)
    if isinstance(ecn, str):
        if ecn not in ("on", "off"):
            raise ValueError(f"{section}.tcp.ecn: expected 'on' or "
                             f"'off', got {ecn!r}")
        ecn = ecn == "on"
    ecn = bool(ecn)
    if cc == "dctcp" and not ecn:
        raise ValueError(f"{section}.tcp: cc=dctcp requires ecn=on "
                         f"(without an echo the controller degenerates "
                         f"to reno)")
    return cc, ecn


def _host_options(section: str, d: dict) -> dict:
    unknown = set(d) - {"pcap_enabled", "pcap_capture_size",
                        "native_dataplane", "tcp"}
    if unknown:
        raise ValueError(f"{section}: unsupported option(s) "
                         f"{sorted(unknown)}")
    return d


def _hosts(raw: dict) -> dict[str, HostConfig]:
    hosts_raw = raw.get("hosts", {}) or {}
    if not hosts_raw:
        raise ValueError("config must define at least one host")
    defaults = _host_options("host_option_defaults",
                             raw.get("host_option_defaults", {}) or {})
    if "tcp" in defaults:
        _tcp_block("host_option_defaults", defaults["tcp"])
    hosts = {}
    for name, h in hosts_raw.items():
        h = h or {}
        opt = dict(defaults)
        opt.update(_host_options(f"hosts.{name}.host_options",
                                 h.get("host_options", {}) or {}))
        if bool(h.get("pcap_enabled", opt.get("pcap_enabled", False))):
            _refuse(f"hosts.{name}: pcap capture", _RM_OBS)
        if not bool(h.get("native_dataplane",
                          opt.get("native_dataplane", True))):
            _refuse(f"hosts.{name}: native_dataplane false", _RM_OBJECT)
        procs = []
        for p in h.get("processes", []) or []:
            where = f"hosts.{name}.processes[{len(procs)}]"
            path = str(_require(p, "path", f"hosts.{name}.processes"))
            args = p.get("args", [])
            if isinstance(args, str):
                args = shlex.split(args)
            args = [str(a) for a in args]
            _check_engine_app(where, path, args)
            if "shutdown_time" in p:
                _refuse(f"{where}: shutdown_time (signal delivery)",
                        _RM_OBS)
            if str(p.get("on_failure", "abort")) != "abort":
                _refuse(f"{where}: on_failure", _RM_OBS)
            procs.append(ProcessConfig(
                path=path, args=args,
                start_time_ns=units.parse_time_ns(p.get("start_time", 0)),
                expected_final_state=_validate_final_state(
                    p.get("expected_final_state", "exited 0"), where)))
        bw_down = h.get("bandwidth_down")
        bw_up = h.get("bandwidth_up")
        tcp_raw = h.get("tcp", opt.get("tcp"))
        tcp_cc, tcp_ecn = (("reno", False) if tcp_raw is None
                           else _tcp_block(f"hosts.{name}", tcp_raw))
        hosts[str(name)] = HostConfig(
            name=str(name),
            network_node_id=int(_require(h, "network_node_id",
                                         f"hosts.{name}")),
            processes=procs,
            ip_addr=(netgraph.parse_ip(h["ip_addr"])
                     if "ip_addr" in h else None),
            bandwidth_down_bits=(units.parse_bandwidth_bits(bw_down)
                                 if bw_down is not None else None),
            bandwidth_up_bits=(units.parse_bandwidth_bits(bw_up)
                               if bw_up is not None else None),
            tcp_cc=tcp_cc, tcp_ecn=tcp_ecn)
    return hosts


def _check_engine_app(where: str, path: str, args: list[str]) -> None:
    """Only engine-resident apps are served: anything else runs on the
    object path or under the shim."""
    if path not in ENGINE_ARGC:
        _refuse(f"{where}: {path} (object-path or managed process)",
                _RM_OBS if "/" in path else _RM_OBJECT)
    if not argv_fits(path, args):
        _refuse(f"{where}: {path} with args {args} (object-path app)",
                _RM_OBJECT)


def _require(mapping: dict, key: str, where: str):
    if key not in mapping:
        raise ValueError(f"missing required config key {where}.{key}")
    return mapping[key]


def _validate_final_state(v, where: str):
    if isinstance(v, str):
        if v in ("running", "any"):
            return v
        parts = v.split()
        if parts and parts[0] == "exited" and len(parts) <= 2:
            try:
                if len(parts) == 2:
                    int(parts[1])
                return v
            except ValueError:
                pass
        if parts and parts[0] == "signaled":
            _refuse(f"{where}: expected_final_state {v!r} (signal "
                    f"delivery)", _RM_OBS)
    raise ValueError(
        f"{where}: invalid expected_final_state {v!r} (expected "
        f"'running', 'any', 'exited [code]', or 'signaled [SIG]')")


def _load_graph(gspec: dict, base_dir: str) -> netgraph.NetworkGraph:
    gtype = gspec.get("type", "gml")
    if gtype in netgraph.BUILTIN_GRAPHS:
        return netgraph.NetworkGraph.named(gtype)
    if gtype != "gml":
        raise ValueError(f"unknown graph type {gtype!r}")
    if "inline" in gspec:
        return netgraph.NetworkGraph.from_gml(gspec["inline"])
    if "file" in gspec:
        import os
        path = gspec["file"]["path"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        with open(path) as f:
            return netgraph.NetworkGraph.from_gml(f.read())
    raise ValueError("network.graph needs 'inline' or 'file.path'")
