"""Simulation configuration: the same YAML as the JAX package.

The port's copy of `shadow_tpu/core/config.py` (`ConfigOptions`): it
reads the same sections, keys and unit syntax, carries every value the
reference carries (with the reference's defaults), and writes the same
`processed-config.yaml` (`to_processed_dict`).  A key or value that
needs a path the port has not ported yet raises NotImplementedError
naming the ROADMAP item, instead of running some other path silently.

What the port serves: the internal apps on engine-resident and
object-path hosts under every scheduler.  `scheduler: tpu`: the TCP and
PHOLD/udp-mesh device spans and the per-round propagation kernel on the
card, the C++ engine serving every round the device does not (C++
spans, and the per-round rounds the route model gives its twin);
`tpu_min_device_batch <= 0` forces every round through the kernel;
`native_dataplane: off` puts every host on the object path, whose
sends the same kernel propagates.  `scheduler: thread_per_core` with
`native_dataplane: on`: the engine baseline, every round on the
per-round path over OS threads with the engine's scalar propagation,
no device at all.  `serial`, `thread_per_host` and the pure-Python
`thread_per_core`: the object path on the CPU.  Per-host
`native_dataplane: false` and the CPU model keep a host on the object
path beside the engine's hosts.
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass, field
from typing import Any

import yaml

from shadow_tpu_torch.net import graph as netgraph
from shadow_tpu_torch.utils import units

SCHEDULERS = ("thread_per_core", "thread_per_host", "serial", "tpu")
QDISC_MODES = ("fifo", "round_robin")
ON_FAILURE_POLICIES = ("abort", "quarantine", "restart")

# ROADMAP queue A items that the refusals below name.
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
    environment: dict[str, str] = field(default_factory=dict)
    start_time_ns: int = 0
    shutdown_time_ns: int | None = None
    shutdown_signal: str = "SIGTERM"
    expected_final_state: Any = "exited 0"
    on_failure: str = "abort"
    restart_budget: int = 2


@dataclass
class HostConfig:
    name: str
    network_node_id: int
    processes: list[ProcessConfig]
    ip_addr: int | None = None
    bandwidth_down_bits: int | None = None  # overrides graph-node default
    bandwidth_up_bits: int | None = None
    pcap_enabled: bool = False
    pcap_capture_size: int = 65535
    native_dataplane: bool = True
    tcp_cc: str = "reno"
    tcp_ecn: bool = False


@dataclass
class GeneralConfig:
    stop_time_ns: int = 0
    seed: int = 1
    bootstrap_end_time_ns: int = 0
    parallelism: int = 0  # 0 = auto (num cores)
    data_directory: str = "shadow.data"
    template_directory: str | None = None
    progress: bool = False
    heartbeat_interval_ns: int = units.parse_time_ns("1 s")
    log_level: str = "info"
    # Managed-process timing: inert on the internal apps.
    model_unblocked_syscall_latency: bool = True


@dataclass
class NetworkConfig:
    graph: netgraph.NetworkGraph = None
    use_shortest_path: bool = True


@dataclass
class ExperimentalConfig:
    """Every reference key, at the reference's default.  The ones that
    shape a run the port serves are read by the Manager; the others
    are carried into processed-config.yaml, or refused when their value
    needs an unported path (`_EXP_REFUSED`)."""
    scheduler: str = "thread_per_core"
    runahead_ns: int | None = None  # None = auto (graph min latency)
    use_dynamic_runahead: bool = False
    interface_qdisc: str = "fifo"
    socket_send_buffer: int = 131_072
    socket_recv_buffer: int = 174_760
    socket_send_autotune: bool = True
    socket_recv_autotune: bool = True
    strace_logging_mode: str = "off"
    max_unapplied_cpu_latency_ns: int = units.parse_time_ns("20 us")
    unblocked_syscall_latency_ns: int = units.parse_time_ns("1 us")
    host_cpu_threshold_ns: int | None = None
    host_cpu_precision_ns: int | None = None
    host_cpu_event_cost_ns: int = 0
    native_preemption_enabled: bool = False
    native_preemption_native_interval_ns: int = \
        units.parse_time_ns("10 ms")
    native_preemption_sim_interval_ns: int = units.parse_time_ns("10 ms")
    native_file_io_bandwidth_bps: int = units.parse_bytes("1 GiB")
    unblocked_vdso_latency_ns: int = units.parse_time_ns("10 ns")
    # The object path's outbox chunk under `tpu`.
    tpu_max_packets_per_round: int = 1 << 20
    tpu_min_device_batch: int = 2048
    tpu_shards: int = 1
    tpu_exchange_capacity: int = 1 << 12
    native_dataplane: str = "auto"
    tpu_device_spans: str = "auto"
    tpu_donate_buffers: str = "off"
    span_overlap: str = "auto"
    # Accepted for YAML compatibility: in the port the hand kernels run
    # whenever the span state lies on the card, whatever this says.
    pallas_queue_kernels: str = "off"
    dev_span_k_init: int = 32
    dev_span_k_floor: int = 16
    dev_span_k_shrink: int = 4
    flight_recorder: str = "off"
    sim_netstat: str = "off"
    netstat_interval_ns: int = 0
    sim_fabricstat: str = "off"
    fabricstat_interval_ns: int = 0
    chrome_top_n: int = 16
    syscall_observatory: str = "off"
    kernel_observatory: str = "off"
    syscall_service_plane: str = "auto"
    managed_death_poll_ns: int = 2_000_000_000
    managed_watchdog_ns: int = 0
    managed_spawn_stagger_ns: int = 0
    pcap_span_cap: int = 64
    dctcp_k_pkts: int = 20
    dctcp_k_bytes: int = 30_000
    use_cpu_pinning: bool = True
    openssl_crypto_noop: bool = False
    use_perf_timers: bool = False
    report_errors_to_stderr: bool = True


# experimental keys: yaml key -> (attr, converter), the reference's list.
_EXP_KEYS = {
    "scheduler": ("scheduler", str),
    "runahead": ("runahead_ns", units.parse_time_ns),
    "use_dynamic_runahead": ("use_dynamic_runahead", bool),
    "interface_qdisc": ("interface_qdisc", str),
    "socket_send_buffer": ("socket_send_buffer", units.parse_bytes),
    "socket_recv_buffer": ("socket_recv_buffer", units.parse_bytes),
    "socket_send_autotune": ("socket_send_autotune", bool),
    "socket_recv_autotune": ("socket_recv_autotune", bool),
    "strace_logging_mode": ("strace_logging_mode", str),
    "max_unapplied_cpu_latency": ("max_unapplied_cpu_latency_ns",
                                  units.parse_time_ns),
    "unblocked_syscall_latency": ("unblocked_syscall_latency_ns",
                                  units.parse_time_ns),
    "unblocked_vdso_latency": ("unblocked_vdso_latency_ns",
                               units.parse_time_ns),
    "host_cpu_threshold": ("host_cpu_threshold_ns", units.parse_time_ns),
    "host_cpu_precision": ("host_cpu_precision_ns", units.parse_time_ns),
    "host_cpu_event_cost": ("host_cpu_event_cost_ns", units.parse_time_ns),
    "native_preemption_enabled": ("native_preemption_enabled", bool),
    "native_preemption_native_interval": (
        "native_preemption_native_interval_ns", units.parse_time_ns),
    "native_preemption_sim_interval": (
        "native_preemption_sim_interval_ns", units.parse_time_ns),
    "native_file_io_bandwidth": ("native_file_io_bandwidth_bps",
                                 units.parse_bytes),
    "tpu_max_packets_per_round": ("tpu_max_packets_per_round", int),
    "tpu_min_device_batch": ("tpu_min_device_batch", int),
    "tpu_shards": ("tpu_shards", int),
    "tpu_exchange_capacity": ("tpu_exchange_capacity", int),
    "native_dataplane": ("native_dataplane", _onoff),
    "tpu_device_spans": ("tpu_device_spans", _onoff),
    "tpu_donate_buffers": ("tpu_donate_buffers", _onoff),
    "span_overlap": ("span_overlap", _onoff),
    "pallas_queue_kernels": ("pallas_queue_kernels", _onoff),
    "dev_span_k_init": ("dev_span_k_init", int),
    "dev_span_k_floor": ("dev_span_k_floor", int),
    "dev_span_k_shrink": ("dev_span_k_shrink", int),
    "flight_recorder": ("flight_recorder", _onoff),
    "sim_netstat": ("sim_netstat", _onoff),
    "netstat_interval": ("netstat_interval_ns", units.parse_time_ns),
    "sim_fabricstat": ("sim_fabricstat", _onoff),
    "fabricstat_interval": ("fabricstat_interval_ns", units.parse_time_ns),
    "chrome_top_n": ("chrome_top_n", int),
    "syscall_observatory": ("syscall_observatory", _onoff),
    "kernel_observatory": ("kernel_observatory", _onoff),
    "syscall_service_plane": ("syscall_service_plane", _onoff),
    "managed_death_poll": ("managed_death_poll_ns", units.parse_time_ns),
    "managed_watchdog": ("managed_watchdog_ns", units.parse_time_ns),
    "managed_spawn_stagger": ("managed_spawn_stagger_ns",
                              units.parse_time_ns),
    "pcap_span_cap": ("pcap_span_cap", int),
    "dctcp_k_pkts": ("dctcp_k_pkts", int),
    "dctcp_k_bytes": ("dctcp_k_bytes", units.parse_bytes),
    "use_cpu_pinning": ("use_cpu_pinning", bool),
    "openssl_crypto_noop": ("openssl_crypto_noop", bool),
    "use_perf_timers": ("use_perf_timers", bool),
    "report_errors_to_stderr": ("report_errors_to_stderr", bool),
}

# Values that need an unported path: attr -> (predicate on the parsed
# value that says the path is needed, ROADMAP item).  Every other key
# changes nothing on the paths the port serves (managed-process timing,
# sharded sizing, wall-side knobs) or is read by the Manager.
_EXP_REFUSED = {
    "strace_logging_mode": (lambda v: v != "off", _RM_OBS),
    "tpu_shards": (lambda v: v != 1, _RM_SHARDED),
    "syscall_observatory": (lambda v: v != "off", _RM_OBS),
    "openssl_crypto_noop": (bool, _RM_OBS),
}

# The reference's closed value sets.
_EXP_CHOICES = {
    "scheduler": SCHEDULERS,
    "interface_qdisc": QDISC_MODES,
    "tpu_device_spans": ("auto", "force", "on", "off"),
    "span_overlap": ("off", "on", "auto"),
    "pallas_queue_kernels": ("off", "on"),
    "tpu_donate_buffers": ("off", "on"),
    "flight_recorder": ("off", "wall", "on"),
    "sim_netstat": ("off", "on"),
    "sim_fabricstat": ("off", "on"),
    "syscall_observatory": ("off", "wall", "on"),
    "kernel_observatory": ("off", "wall", "on"),
    "syscall_service_plane": ("off", "auto", "on"),
}


def _refuse(what: str, item: str):
    raise NotImplementedError(
        f"shadow_tpu_torch does not serve {what} yet: {item}")


def check_scheduler(exp: ExperimentalConfig) -> None:
    """Every scheduler of the reference is served: `tpu`, the engine
    `thread_per_core` baseline (`native_dataplane: on`), and the object
    path's `serial`, `thread_per_host` and pure-Python
    `thread_per_core` (`native_dataplane` auto or off)."""
    if exp.scheduler not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {exp.scheduler!r}; "
                         f"expected one of {SCHEDULERS}")


def _ns(v: int | None):
    return None if v is None else f"{int(v)} ns"


@dataclass
class ConfigOptions:
    general: GeneralConfig
    network: NetworkConfig
    experimental: ExperimentalConfig
    hosts: dict[str, HostConfig]

    def to_processed_dict(self) -> dict:
        """The fully-resolved options as a re-loadable YAML structure,
        the reference's `to_processed_dict` key for key (its
        `checkpoint:` and `faults:` sections are refused here, so never
        written).  Every value is explicit, defaults included; time
        values render as '<n> ns' so from_yaml_text() round-trips."""
        g, e = self.general, self.experimental
        out = {
            "general": {
                "stop_time": _ns(g.stop_time_ns),
                "seed": g.seed,
                "bootstrap_end_time": _ns(g.bootstrap_end_time_ns),
                "parallelism": g.parallelism,
                "data_directory": g.data_directory,
                "template_directory": g.template_directory,
                "progress": g.progress,
                "heartbeat_interval": _ns(g.heartbeat_interval_ns),
                "log_level": g.log_level,
                "model_unblocked_syscall_latency":
                    g.model_unblocked_syscall_latency,
            },
            "network": {
                "graph": {"type": "gml",
                          "inline": self.network.graph.gml_text},
                "use_shortest_path": self.network.use_shortest_path,
            },
            "experimental": {
                "scheduler": e.scheduler,
                "runahead": _ns(e.runahead_ns),
                "use_dynamic_runahead": e.use_dynamic_runahead,
                "interface_qdisc": e.interface_qdisc,
                "socket_send_buffer": e.socket_send_buffer,
                "socket_recv_buffer": e.socket_recv_buffer,
                "socket_send_autotune": e.socket_send_autotune,
                "socket_recv_autotune": e.socket_recv_autotune,
                "strace_logging_mode": e.strace_logging_mode,
                "max_unapplied_cpu_latency":
                    _ns(e.max_unapplied_cpu_latency_ns),
                "unblocked_syscall_latency":
                    _ns(e.unblocked_syscall_latency_ns),
                "unblocked_vdso_latency": _ns(e.unblocked_vdso_latency_ns),
                "host_cpu_threshold": _ns(e.host_cpu_threshold_ns),
                "host_cpu_precision": _ns(e.host_cpu_precision_ns),
                "host_cpu_event_cost": _ns(e.host_cpu_event_cost_ns),
                "native_preemption_enabled": e.native_preemption_enabled,
                "native_preemption_native_interval":
                    _ns(e.native_preemption_native_interval_ns),
                "native_preemption_sim_interval":
                    _ns(e.native_preemption_sim_interval_ns),
                "native_file_io_bandwidth":
                    f"{e.native_file_io_bandwidth_bps} B",
                "tpu_max_packets_per_round": e.tpu_max_packets_per_round,
                "tpu_min_device_batch": e.tpu_min_device_batch,
                "tpu_shards": e.tpu_shards,
                "tpu_exchange_capacity": e.tpu_exchange_capacity,
                "native_dataplane": e.native_dataplane,
                "tpu_device_spans": e.tpu_device_spans,
                "tpu_donate_buffers": e.tpu_donate_buffers,
                "span_overlap": e.span_overlap,
                "pallas_queue_kernels": e.pallas_queue_kernels,
                "dev_span_k_init": e.dev_span_k_init,
                "dev_span_k_floor": e.dev_span_k_floor,
                "dev_span_k_shrink": e.dev_span_k_shrink,
                "flight_recorder": e.flight_recorder,
                "sim_netstat": e.sim_netstat,
                "netstat_interval": _ns(e.netstat_interval_ns),
                "sim_fabricstat": e.sim_fabricstat,
                "fabricstat_interval": _ns(e.fabricstat_interval_ns),
                "chrome_top_n": e.chrome_top_n,
                "syscall_observatory": e.syscall_observatory,
                "kernel_observatory": e.kernel_observatory,
                "syscall_service_plane": e.syscall_service_plane,
                "managed_death_poll": _ns(e.managed_death_poll_ns),
                "managed_watchdog": _ns(e.managed_watchdog_ns),
                "managed_spawn_stagger": _ns(e.managed_spawn_stagger_ns),
                "pcap_span_cap": e.pcap_span_cap,
                "dctcp_k_pkts": e.dctcp_k_pkts,
                "dctcp_k_bytes": e.dctcp_k_bytes,
                "openssl_crypto_noop": e.openssl_crypto_noop,
                "use_cpu_pinning": e.use_cpu_pinning,
                "use_perf_timers": e.use_perf_timers,
                "report_errors_to_stderr": e.report_errors_to_stderr,
            },
            "hosts": {},
        }
        for name in sorted(self.hosts):
            h = self.hosts[name]
            procs = []
            for p in h.processes:
                procs.append({
                    "path": p.path,
                    "args": list(p.args),
                    "environment": dict(p.environment),
                    "start_time": _ns(p.start_time_ns),
                    "shutdown_time": _ns(p.shutdown_time_ns),
                    "shutdown_signal": p.shutdown_signal,
                    "expected_final_state": p.expected_final_state,
                    "on_failure": p.on_failure,
                    "restart_budget": p.restart_budget,
                })
            out["hosts"][name] = {
                "network_node_id": h.network_node_id,
                "ip_addr": (netgraph.format_ip(h.ip_addr)
                            if h.ip_addr is not None else None),
                "bandwidth_down": h.bandwidth_down_bits,
                "bandwidth_up": h.bandwidth_up_bits,
                "pcap_enabled": h.pcap_enabled,
                "pcap_capture_size": h.pcap_capture_size,
                "native_dataplane": h.native_dataplane,
                "tcp": {"cc": h.tcp_cc,
                        "ecn": "on" if h.tcp_ecn else "off"},
                "processes": procs,
            }

        def prune(x):
            # Omit None values: absent and null are not equivalent to
            # the loader (e.g. shutdown_time's presence check).
            if isinstance(x, dict):
                return {k: prune(v) for k, v in x.items()
                        if v is not None}
            if isinstance(x, list):
                return [prune(v) for v in x]
            return x

        return prune(out)

    @classmethod
    def from_yaml_text(cls, text: str,
                       base_dir: str = ".") -> "ConfigOptions":
        # libyaml's parser where PyYAML has it (the same safe
        # constructors and resolvers; a 10,000-host config parses ~4x
        # faster), the pure-Python one otherwise.
        raw = yaml.load(text, Loader=getattr(yaml, "CSafeLoader",
                                             yaml.SafeLoader))
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
        general = GeneralConfig(
            stop_time_ns=units.parse_time_ns(
                _require(g, "stop_time", "general")),
            seed=int(g.get("seed", 1)),
            bootstrap_end_time_ns=units.parse_time_ns(
                g.get("bootstrap_end_time", 0)),
            parallelism=int(g.get("parallelism", 0)),
            data_directory=str(g.get("data_directory", "shadow.data")),
            template_directory=g.get("template_directory"),
            progress=bool(g.get("progress", False)),
            heartbeat_interval_ns=units.parse_time_ns(
                g.get("heartbeat_interval", "1 s")),
            log_level=str(g.get("log_level", "info")),
            model_unblocked_syscall_latency=bool(
                g.get("model_unblocked_syscall_latency", True)),
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
        if key not in _EXP_KEYS:
            raise ValueError(f"unknown experimental key {key!r}")
        attr, conv = _EXP_KEYS[key]
        setattr(out, attr, conv(v))
    for attr, choices in _EXP_CHOICES.items():
        if getattr(out, attr) not in choices:
            raise ValueError(f"unknown {attr} {getattr(out, attr)!r}; "
                             f"expected one of {choices}")
    for k in ("dev_span_k_init", "dev_span_k_floor", "dev_span_k_shrink",
              "dctcp_k_pkts", "dctcp_k_bytes", "chrome_top_n",
              "pcap_span_cap"):
        if getattr(out, k) < 1:
            raise ValueError(f"{k} must be >= 1")
    for attr, (needs, item) in _EXP_REFUSED.items():
        v = getattr(out, attr)
        if needs(v):
            key = next(k for k, (a, _c) in _EXP_KEYS.items() if a == attr)
            _refuse(f"experimental.{key}: {v}", item)
    check_scheduler(out)
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
        pcap_enabled = bool(h.get("pcap_enabled",
                                  opt.get("pcap_enabled", False)))
        native_dataplane = bool(h.get("native_dataplane",
                                      opt.get("native_dataplane", True)))
        procs = []
        for p in h.get("processes", []) or []:
            where = f"hosts.{name}.processes[{len(procs)}]"
            path = str(_require(p, "path", f"hosts.{name}.processes"))
            args = p.get("args", [])
            if isinstance(args, str):
                args = shlex.split(args)
            args = [str(a) for a in args]
            if "/" in path:
                _refuse(f"{where}: {path} (a managed process)", _RM_OBS)
            if "shutdown_time" in p:
                _refuse(f"{where}: shutdown_time (signal delivery)",
                        _RM_OBS)
            on_failure = str(p.get("on_failure", "abort"))
            if on_failure not in ON_FAILURE_POLICIES:
                raise ValueError(f"{where}: unknown on_failure "
                                 f"{on_failure!r}; expected one of "
                                 f"{ON_FAILURE_POLICIES}")
            if on_failure != "abort":
                _refuse(f"{where}: on_failure", _RM_OBS)
            restart_budget = int(p.get("restart_budget", 2))
            if restart_budget < 1:
                raise ValueError(f"{where}: restart_budget must be >= 1")
            procs.append(ProcessConfig(
                path=path, args=args,
                environment={str(k): str(v) for k, v in
                             (p.get("environment") or {}).items()},
                start_time_ns=units.parse_time_ns(p.get("start_time", 0)),
                shutdown_signal=str(p.get("shutdown_signal", "SIGTERM")),
                expected_final_state=_validate_final_state(
                    p.get("expected_final_state", "exited 0"), where),
                restart_budget=restart_budget))
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
            pcap_enabled=pcap_enabled,
            pcap_capture_size=units.parse_bytes(
                h.get("pcap_capture_size",
                      opt.get("pcap_capture_size", 65535))),
            native_dataplane=native_dataplane,
            tcp_cc=tcp_cc, tcp_ecn=tcp_ecn)
    return hosts


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
