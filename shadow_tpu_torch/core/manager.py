"""Manager: build a simulation, run the conservative round loop, and
write the run's data directory.

The port's counterpart of `shadow_tpu/core/manager.py`.  A host runs on
one of two planes: the C++ engine (`native/netplane.cpp`: its inet
plane, its apps and their TCP state; under `tpu` unless
`native_dataplane: off`, and under the engine `thread_per_core`
baseline), or the object path (host/host.py's Python network devices,
host/apps.py's internal apps over host/socket_*.py and tcp/): every
host under `serial`, `thread_per_host` and the pure-Python
`thread_per_core`, and, beside engine hosts, those with per-host
`native_dataplane: false` or the CPU model.  The loop picks the global
minimum next-event time and serves the rounds from it.  Under
`scheduler: tpu` with the engine it does so in one of three ways,
exactly as the reference does:

- a device span: whole conservative windows of exported state stepped
  in PyTorch on the card and imported back transactionally, by the
  PHOLD/udp-mesh family (ops/phold_span.py) or, when the sim is not
  PHOLD-shaped, by the TCP steady-stream family (ops/tcp_span.py); a
  span that follows a clean one reuses its output on the card, and
  with `span_overlap` on the next window runs while the host imports
  this one (ops/span_mesh.py);
- a C++ span (engine.run_span): whole windows inside one engine call,
  capped before the first window that could touch a host with
  Python-side work (an object-path host, or an engine host's spawn
  task); a span whose round sent to an object-path host ends there and
  hands those packets back (exports);
- one per-round iteration: hosts with Python-side work run through
  Host.execute, the rest in one engine batch, and the propagator
  (ops/propagate.py) propagates the round's packets: the object path's
  outbox in chunks, then the engine's round, each on the card
  (`stt_propagate_round`) or through a bit-identical twin, as its route
  model decides.

`tpu_min_device_batch <= 0` forces every round through the kernel:
no span of either kind runs, and no round goes to a twin.

Under the CPU schedulers every round takes the per-round path and no
torch device is resolved: the object path's sends propagate one by one
(core/propagate_scalar.py) and the engine baseline's hosts run over
`general.parallelism` OS threads with the engine's C++ twin.
`thread_per_host` runs one task a host on a pool, `thread_per_core`
blocks of hosts claimed off a shared cursor (`use_cpu_pinning` pins the
pool's threads), and `use_perf_timers` times each host's execution
serially.

Every round is credited one eligibility reason (trace/audit.py); the
heartbeat and status bar follow `general.progress`; `write_data_dir`
writes what the reference writes for these runs: processed-config.yaml,
hosts.txt, the processes' stdout and stderr, packet-trace.txt and
sim-stats.json (trace/metrics.py's two channels).

The sim-time channels, each opt-in as in the reference: the flight
recorder (`flight-sim.bin`, and `flight-wall.json` from its wall half),
sim-netstat (`telemetry-sim.bin`), the fabric observatory
(`fabric-sim.bin`) and the kernel observatory (`kernel-sim.bin`), and
pcap (`hosts/<name>/{lo,eth0}.pcap`).  The engine records its own rounds
and C++ spans (drained after each span and sampled at each per-round
boundary); a device span samples on the card (or in its plain loop) and
its runner appends the rows after the span's import; the object-path
hosts' connections and queues are sampled at each per-round boundary
after the engine's block.  An engine host's pcap is captured by the
engine and drained every round and span, its spans capped at
`pcap_span_cap` rounds (the engine keeps a pcap host's sim off device
spans, as the reference's does); an object-path host's interfaces write
theirs as packets pass.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from shadow_tpu_torch.core.config import ConfigOptions, check_scheduler
from shadow_tpu_torch.core.event import TaskRef
from shadow_tpu_torch.core.propagate_scalar import (ScalarPropagator,
                                                    deliver_engine_exports)
from shadow_tpu_torch.core.rng import STREAM_PACKET_LOSS, mix_key
from shadow_tpu_torch.core.simtime import TIME_NEVER
from shadow_tpu_torch.host import apps as app_registry
from shadow_tpu_torch.host.cpu import Cpu
from shadow_tpu_torch.host.engine_app import (EngineAppProcess,
                                              engine_app_args)
from shadow_tpu_torch.host.host import Host
from shadow_tpu_torch.host.process import Process
from shadow_tpu_torch.host.signals import parse_signal
from shadow_tpu_torch.host.syscalls import SyscallHandler
from shadow_tpu_torch.host.syscalls_native import NativeSyscallHandler
from shadow_tpu_torch.net.dns import Dns
from shadow_tpu_torch.net.graph import IpAssignment, routing_arrays
from shadow_tpu_torch.trace import events as trev
from shadow_tpu_torch.trace.audit import EligibilityAudit
from shadow_tpu_torch.trace.metrics import MetricsRegistry
from shadow_tpu_torch.utils import object_counter
from shadow_tpu_torch.utils.device import resolve_device
from shadow_tpu_torch.utils.shadow_log import LOG


@dataclass
class SimSummary:
    end_time_ns: int = 0
    busy_end_ns: int = 0  # window end of the last round that ran events
    rounds: int = 0
    span_rounds: int = 0  # of which: served inside C++/device spans
    events: int = 0
    packets_sent: int = 0
    packets_recv: int = 0
    packets_dropped: int = 0
    syscalls: int = 0
    plugin_errors: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.plugin_errors


class Runahead:
    """Round width: the smallest latency any packet can experience
    bounds how far hosts may run without hearing from each other."""

    def __init__(self, config_ns: int | None, graph_min_ns: int,
                 dynamic: bool):
        self._value = config_ns if config_ns is not None else graph_min_ns
        self._value = max(int(self._value), 1)
        self.dynamic = dynamic

    def get(self) -> int:
        return self._value

    def update_lowest_used_latency(self, latency_ns: int) -> None:
        if self.dynamic and 0 < latency_ns < self._value:
            self._value = latency_ns

    def sync_from_span(self, value_ns: int) -> None:
        """Adopt the (only ever lowered) width a span computed."""
        if 0 < value_ns < self._value:
            self._value = int(value_ns)


# A device span that legitimately made no progress (window boundary),
# distinct from a failed/aborted one.
ZERO_PROGRESS = object()


def span_overlap_on(mode: str, device) -> bool:
    """Resolve `experimental.span_overlap` for a Manager on `device`.

    `auto` speculates only on the card, where window K+1 runs on the
    device while the host imports window K.  On the CPU the "device" is
    the same cores the host work needs, so a speculative window cannot
    hide behind it and only adds work.  Results are identical either
    way; this decides wall-side routing only."""
    if mode == "auto":
        return torch.device(device).type == "cuda"
    return mode == "on"


class SpawnTask:
    """One configured process spawn.  On an engine host an app with an
    engine twin spawns engine-side; a path no internal app claims runs
    as a managed process (a real binary under the shim); otherwise the
    app runs as an internal (Python-coroutine) process, over the object
    path's sockets or, on an engine host, the engine's."""

    __slots__ = ("pcfg", "index", "bufs")

    def __init__(self, pcfg, index: int, bufs):
        self.pcfg = pcfg
        self.index = index
        self.bufs = bufs  # (send_buf, recv_buf, send_at, recv_at)

    def __call__(self, h) -> None:
        pcfg = self.pcfg
        if h.plane is not None:
            spec = engine_app_args(pcfg, h.dns)
            if spec is not None:
                kind, a, b, c, d, e = spec[:6]
                extra = spec[6:]  # the peer-IP buffer of udp-mesh / phold
                send_buf, recv_buf, send_at, recv_at = self.bufs
                process = EngineAppProcess(
                    h, f"{pcfg.path}.{self.index}",
                    expected_final_state=pcfg.expected_final_state)
                process.spawn_tag = self.index
                process.app_idx = h.plane.engine.app_spawn(
                    h.id, kind, a, b, c, d, e, send_buf, recv_buf,
                    int(send_at), int(recv_at), h.now(), *extra)
                return
        factory = app_registry.lookup(pcfg.path)
        if factory is None and "/" in pcfg.path:
            # A path: a real Linux binary under the shim (host/managed.py).
            # A bare name never falls through to $PATH.
            from shadow_tpu_torch.host.managed import ManagedProcess
            process = ManagedProcess(
                h, f"{os.path.basename(pcfg.path)}.{self.index}",
                [pcfg.path] + list(pcfg.args), pcfg.environment,
                expected_final_state=pcfg.expected_final_state,
                work_dir=h.data_path)
            process.spawn_tag = self.index
            process.start_native(h, pcfg.path)
            return
        process = Process(h, f"{pcfg.path}.{self.index}", pcfg.args,
                          pcfg.environment,
                          expected_final_state=pcfg.expected_final_state)
        process.spawn_tag = self.index
        if factory is None:
            process.stderr += (f"[shadow-tpu] unknown app "
                               f"{pcfg.path!r}\n").encode()
            process.exited = True
            process.exit_code = 127
            return
        process.start(h, factory(process, pcfg.args))


class ShutdownTask:
    """A process's `shutdown_time`: deliver its signal to every process
    its paired SpawnTask created (matched by spawn_tag)."""

    __slots__ = ("index", "signal")

    def __init__(self, index: int, signal: int):
        self.index = index
        self.signal = signal

    def __call__(self, h) -> None:
        for proc in list(h.processes.values()):
            if getattr(proc, "spawn_tag", None) == self.index \
                    and not proc.exited:
                proc.raise_signal(h, self.signal)


def is_managed(pcfg) -> bool:
    """The one managed-process predicate (SpawnTask's dispatch rule): a
    path that no internal app claims."""
    return "/" in pcfg.path and app_registry.lookup(pcfg.path) is None


class Manager:
    def __init__(self, config: ConfigOptions, device=None):
        object_counter.reset()
        exp = config.experimental
        check_scheduler(exp)
        sched = exp.scheduler
        self.tpu = sched == "tpu"
        # The CPU schedulers are the CPU runs the user asked for: no torch
        # device, no card.
        self.device = resolve_device(device) if self.tpu else None
        self.config = config
        graph = config.network.graph
        lat, thr = routing_arrays(graph, config.network.use_shortest_path)
        self.graph = graph
        self.latency_ns = lat
        self.loss_thresholds = thr
        self.dns = Dns()
        bufs = (exp.socket_send_buffer, exp.socket_recv_buffer,
                exp.socket_send_autotune, exp.socket_recv_autotune)
        self.syscall_handler = SyscallHandler(*bufs)
        self.syscall_handler_native = NativeSyscallHandler(*bufs)
        # The preloads, built once here (never by hosts spawning on
        # worker threads); a failed build raises.
        managed = any(is_managed(p) for h in config.hosts.values()
                      for p in h.processes)
        # Which shim build ran goes into sim-stats.json's wall channel.
        self.shim_build = None
        if managed:
            from shadow_tpu_torch.native import ensure_shim_built, shim_build
            self.shim_build = shim_build(ensure_shim_built())
            if self.shim_build != "full":
                import warnings
                warnings.warn(
                    "this kernel refuses the shim's rdtsc trap (gVisor): "
                    "the shim is built without it and without its vDSO "
                    "patch, so a managed binary that executes rdtsc, or "
                    "calls the vDSO without libc, reads the host's clock")
        crypto_noop_path = None
        if exp.openssl_crypto_noop:
            from shadow_tpu_torch.native import ensure_crypto_noop_built
            crypto_noop_path = ensure_crypto_noop_built()

        # Hosts in sorted-name order: host ids, and with them every RNG
        # stream and ordering tiebreak, are config-deterministic.  Spawn
        # tasks draw their event seqs from the host's own counter, before
        # the engine takes the host over (the reference's order).
        ipa = IpAssignment()
        self.hosts: list[Host] = []
        seed = config.general.seed
        for host_id, name in enumerate(sorted(config.hosts)):
            hcfg = config.hosts[name]
            node = graph.by_gml_id.get(hcfg.network_node_id)
            if node is None:
                raise ValueError(f"host {name!r}: unknown network_node_id "
                                 f"{hcfg.network_node_id}")
            ip = ipa.assign(node.index, hcfg.ip_addr)
            bw_down = hcfg.bandwidth_down_bits or node.bandwidth_down_bits
            bw_up = hcfg.bandwidth_up_bits or node.bandwidth_up_bits
            if not bw_down or not bw_up:
                raise ValueError(f"host {name!r}: no bandwidth configured "
                                 "(host or graph node must provide it)")
            host = Host(host_id, name, ip, node.index, seed, bw_down,
                        bw_up, qdisc=exp.interface_qdisc)
            host.tcp_cc = hcfg.tcp_cc
            host.tcp_ecn = hcfg.tcp_ecn
            host.dctcp_k_pkts = exp.dctcp_k_pkts
            host.dctcp_k_bytes = exp.dctcp_k_bytes
            if exp.host_cpu_threshold_ns is not None:
                host.cpu = Cpu(threshold=exp.host_cpu_threshold_ns,
                               precision=exp.host_cpu_precision_ns)
                host.cpu_event_cost_ns = exp.host_cpu_event_cost_ns
            # The managed path's syscall latency model, preemption and
            # native file I/O billing.
            host.syscall_latency_ns = (
                exp.unblocked_syscall_latency_ns
                if config.general.model_unblocked_syscall_latency else 0)
            if exp.native_preemption_enabled:
                host.preempt_native_ns = \
                    exp.native_preemption_native_interval_ns
                host.preempt_sim_ns = exp.native_preemption_sim_interval_ns
            host.max_unapplied_ns = exp.max_unapplied_cpu_latency_ns
            host.death_poll_ns = exp.managed_death_poll_ns
            host.crypto_noop = crypto_noop_path
            bw = exp.native_file_io_bandwidth_bps
            if config.general.model_unblocked_syscall_latency and bw > 0:
                host.native_io_ns_per_kib = max(
                    1, (1_000_000_000 * 1024) // bw)
            host.dns = self.dns
            host.syscall_handler = self.syscall_handler
            host.syscall_handler_native = self.syscall_handler_native
            host.data_path = os.path.join(config.general.data_directory,
                                          "hosts", name)
            self.dns.register(host_id, ip, name)
            self.hosts.append(host)
            for i, pcfg in enumerate(hcfg.processes):
                host.schedule_task_at(pcfg.start_time_ns,
                                      TaskRef("spawn",
                                              SpawnTask(pcfg, i, bufs)))
                if pcfg.shutdown_time_ns is not None:
                    host.schedule_task_at(
                        pcfg.shutdown_time_ns,
                        TaskRef("shutdown", ShutdownTask(
                            i, parse_signal(pcfg.shutdown_signal
                                            or "SIGTERM"))))

        self.runahead = Runahead(exp.runahead_ns, graph.min_latency_ns(),
                                 exp.use_dynamic_runahead)

        # Managed hosts are known from the config.  Their service goes to
        # the service plane's host-affine workers when it is on, and
        # `py_pinned` keeps their Python-work flag True for the whole
        # run, so the engine's span loop stops before any window that
        # would touch one (the quiescence gate).
        managed_hosts = []
        for host in self.hosts:
            host.svc_managed = any(
                is_managed(p) for p in config.hosts[host.name].processes)
            if host.svc_managed:
                host.py_pinned = True
                managed_hosts.append(host)
        # Failure containment (the hang watchdog and the spawn gate),
        # after the resource preflight.
        self.containment = None
        if managed_hosts:
            from shadow_tpu_torch.svc.containment import (
                ContainmentPlane, preflight_managed)
            preflight_managed(sum(
                1 for host in managed_hosts
                for p in config.hosts[host.name].processes
                if is_managed(p)))
            self.containment = ContainmentPlane(
                watchdog_ns=exp.managed_watchdog_ns)
            for host in managed_hosts:
                host.containment = self.containment
                host.spawn_stagger_ns = exp.managed_spawn_stagger_ns
        # The syscall service plane: `on`, or `auto` with more than one
        # worker (parallelism 0 = the core count); off under perf timers.
        svc_workers = max(1, int(config.general.parallelism
                                 or os.cpu_count() or 1))
        svc_mode = exp.syscall_service_plane
        self.svc = None
        if managed_hosts and not exp.use_perf_timers and (
                svc_mode == "on" or (svc_mode == "auto"
                                     and svc_workers > 1)):
            from shadow_tpu_torch.svc import SyscallServicePlane
            self.svc = SyscallServicePlane(
                max(1, min(svc_workers, len(managed_hosts))))
            for host in managed_hosts:
                # Advertised to the shim through the IPC block.
                host.svc_active = True
        self._managed_mask = None  # built in _init_next_times

        # The C++ engine: every host runs on it under `tpu` (unless
        # `native_dataplane: off`) and under the engine `thread_per_core`
        # baseline (`native_dataplane: on`), but for the hosts that stay
        # on the object path: per-host `native_dataplane: false` and the
        # CPU model.  Both planes meet in the propagators.
        native_mode = exp.native_dataplane
        self.plane = None
        if (self.tpu and native_mode != "off") or \
                (sched == "thread_per_core" and native_mode == "on"):
            from shadow_tpu_torch.native import plane as native_plane
            self.plane = native_plane.NativePlane(self.hosts)
            qdisc_rr = exp.interface_qdisc == "round_robin"
            for host in self.hosts:
                if host.cpu is None and \
                        config.hosts[host.name].native_dataplane:
                    self.plane.add_host(host, qdisc_rr)
            self.plane.engine.set_dctcp_k(exp.dctcp_k_pkts,
                                          exp.dctcp_k_bytes)
        eng = self.plane.engine if self.plane is not None else None
        threaded = sched in ("thread_per_core", "thread_per_host")
        self._per_host_tasks = sched == "thread_per_host"
        if self.tpu:
            from shadow_tpu_torch.ops.propagate import TpuPropagator
            self.propagator = TpuPropagator(
                lat, thr, seed, config.general.bootstrap_end_time_ns,
                runahead=self.runahead,
                min_device_batch=exp.tpu_min_device_batch,
                device=self.device, hosts=self.hosts, dns=self.dns,
                max_batch=exp.tpu_max_packets_per_round)
        else:
            self.propagator = ScalarPropagator(
                self.hosts, self.dns, lat, thr, seed,
                config.general.bootstrap_end_time_ns,
                # The service plane runs managed hosts concurrently even
                # under `serial`.
                threaded=threaded or self.svc is not None,
                runahead=self.runahead)
        for host in self.hosts:
            host._send_packet_fn = self.propagator.send
        if eng is not None:
            # Routing state for the engine's scalar propagation twin.
            k0, k1 = mix_key(seed, STREAM_PACKET_LOSS)
            eng.set_routing(
                np.ascontiguousarray([h.node_index for h in self.hosts],
                                     dtype=np.int32),
                np.ascontiguousarray([h.ip for h in self.hosts],
                                     dtype=np.uint32),
                lat, thr, lat.shape[0], k0, k1,
                config.general.bootstrap_end_time_ns, TIME_NEVER)
            self.propagator.engine = eng
        # Pcap capture: the engine records its hosts' packets, drained
        # each round and span into the writers; an object-path host's
        # interfaces write theirs as they pass.  The files are the same.
        self._pcap_engine: list = []  # (host, writer_lo, writer_eth)
        for host in self.hosts:
            hcfg = config.hosts[host.name]
            if not hcfg.pcap_enabled:
                continue
            from shadow_tpu_torch.utils.pcap import PcapWriter
            hdir = os.path.join(config.general.data_directory, "hosts",
                                host.name)
            os.makedirs(hdir, exist_ok=True)
            writers = tuple(
                PcapWriter(os.path.join(hdir, f"{name}.pcap"),
                           hcfg.pcap_capture_size)
                for name in ("lo", "eth0"))
            if host.plane is not None:
                for ifidx in (0, 1):
                    eng.set_pcap(host.id, ifidx, True)
                self._pcap_engine.append((host,) + writers)
            else:
                host.lo.pcap, host.eth0.pcap = writers
        # OS-thread width for the engine's run_hosts_mt sections.
        self._mt_threads = config.general.parallelism or os.cpu_count() or 1
        self._perf_timers = exp.use_perf_timers
        if self._perf_timers and threaded:
            # Per-host timing means something only serially (threads
            # share the GIL).
            print("[shadow-tpu] use_perf_timers forces serial host "
                  "execution; parallelism ignored", file=sys.stderr)
            threaded = False
        self._pool = None
        if threaded:
            workers = config.general.parallelism or os.cpu_count() or 1
            self._pool = ThreadPoolExecutor(
                max_workers=min(workers, len(self.hosts)),
                initializer=(_make_pinner() if exp.use_cpu_pinning
                             else None))
            self._steal_lock = threading.Lock()
        # Always on (integer adds a round or span): the metrics registry
        # and the eligibility audit feed sim-stats.json.
        self.metrics = MetricsRegistry()
        self.audit = EligibilityAudit()
        # The sim-time channels (opt-in).  "on" flight recording is the
        # sim event stream and the wall phases, "wall" the phases only.
        self.flight = None
        if exp.flight_recorder in ("on", "wall"):
            from shadow_tpu_torch.trace.recorder import FlightRecorder
            self.flight = FlightRecorder(sim=exp.flight_recorder == "on")
            if self.flight.sim is not None and eng is not None:
                eng.set_flight(1)  # the engine's ring: C++ span rounds
            self.propagator.wall = self.flight.wall
        self.netstat = None
        if exp.sim_netstat == "on":
            from shadow_tpu_torch.trace.netstat import NetstatChannel
            self.netstat = NetstatChannel(exp.netstat_interval_ns)
            if eng is not None:
                eng.set_netstat(1, max(int(exp.netstat_interval_ns), 1))
        self.fabric = None
        if exp.sim_fabricstat == "on":
            from shadow_tpu_torch.trace.fabricstat import FabricChannel
            self.fabric = FabricChannel(exp.fabricstat_interval_ns)
            if eng is not None:
                eng.set_fabric(1, max(int(exp.fabricstat_interval_ns), 1))
        self.kern = None
        if exp.kernel_observatory == "on":
            from shadow_tpu_torch.trace.kernstat import KernChannel
            self.kern = KernChannel()
        # Rounds and packets served inside spans (the reference credits
        # them to its propagator's split; the port's propagator counts
        # its per-round rounds only).
        self._span_busy_rounds = 0
        self._span_packets = 0
        self._dev_busy_rounds = 0
        self._dev_packets = 0
        self._nt = None
        self._py_work = None
        self._dev_span = None      # the PHOLD/udp-mesh family's runner
        self._dev_span_tcp = None  # the TCP family's runner

    # ------------------------------------------------------------------
    # The round loop
    # ------------------------------------------------------------------

    def _init_next_times(self) -> None:
        """The shared next-event snapshot (one slot a host) and the
        Python-work flags.  From here on each host writes its own slot
        at the end of execute() and cross-host deliveries lower the
        destination's slot; the engine writes its hosts' in place.
        Object-path hosts' flags stay True; engine hosts' follow their
        Python heap and inbox, but a managed host's stays True.  The
        managed mask marks the hosts the service plane drains."""
        nt = np.empty(len(self.hosts), dtype=np.int64)
        for h in self.hosts:
            t = h.next_event_time()
            nt[h.id] = TIME_NEVER if t is None else t
        pw = np.ones(len(self.hosts), dtype=bool)
        for h in self.hosts:
            h._nt_list = nt
            if h.plane is not None:
                h._py_work_arr = pw
                pw[h.id] = bool(h.queue._heap) or bool(h._inbox) \
                    or h.py_pinned
        self._nt = nt
        self._py_work = pw
        mng = np.array([h.svc_managed for h in self.hosts], dtype=bool)
        self._managed_mask = mng if mng.any() else None
        if self.plane is not None:
            self.plane.engine.set_nt(nt)
            self.plane.engine.set_py_work(pw)

    def _min_next_event(self) -> int | None:
        best = int(self._nt.min())
        return None if best >= TIME_NEVER else best

    def _object_block_reason(self, py_min: int) -> int:
        """Why the earliest-due Python-side host keeps this round off the
        span path: an engine host's transient Python work, or an
        object-path host by cause (CPU model, pcap, other config)."""
        idx = np.flatnonzero(self._py_work & (self._nt == py_min))
        h = self.hosts[int(idx[0])]
        if h.plane is not None:
            return trev.EL_OBJ_PYTASK
        if h.cpu is not None:
            return trev.EL_OBJ_CPU
        if self.config.hosts[h.name].pcap_enabled:
            return trev.EL_OBJ_PCAP
        return trev.EL_OBJ_OTHER

    def _svc_excluded(self, mask):
        """`mask` without the managed hosts when the service plane
        drains them."""
        if self.svc is not None and self._managed_mask is not None:
            return mask & ~self._managed_mask
        return mask

    def _active_hosts(self, until: int) -> list:
        """Hosts whose execute(until) has work by the shared snapshot."""
        hosts = self.hosts
        mask = self._svc_excluded(self._nt < until)
        return [hosts[i] for i in np.flatnonzero(mask)]

    def _run_engine_batch(self, until: int, nthreads: int) -> list:
        """Hosts whose pending work is all engine-side run the window in
        one C call (over `nthreads` OS threads); returns the hosts that
        need the Python path."""
        eng = self.plane.engine
        mask = self._svc_excluded(self._nt < until)
        fast = np.flatnonzero(mask & ~self._py_work)
        slow = np.flatnonzero(mask & self._py_work)
        if fast.size:
            stop = eng.run_hosts_mt(
                np.ascontiguousarray(fast, dtype=np.uint32), until,
                nthreads)
            if stop >= 0:
                # A Python callback fired in the serial tail: finish that
                # host and the remainder through the merge loop.
                for hid in fast[stop:].tolist():
                    self.hosts[hid].execute(until)
        hosts = self.hosts
        return [hosts[i] for i in slow.tolist()]

    def _run_hosts(self, until: int) -> None:
        """One round's host execution under the configured scheduler.
        With the service plane on, the round's due managed hosts drain
        on its workers beside the walk of every other host, joined
        before the propagation barrier."""
        svc_join = None
        if self.svc is not None and self._managed_mask is not None:
            due = np.flatnonzero((self._nt < until) & self._managed_mask)
            if due.size:
                svc_join = self.svc.dispatch(
                    [self.hosts[i] for i in due.tolist()], until)
        try:
            self._run_hosts_inner(until)
        finally:
            if svc_join is not None:
                svc_join()

    def _run_hosts_inner(self, until: int) -> None:
        if self._perf_timers:
            # use_perf_timers: each host's execution wall, serially.
            for h in self.hosts:
                t0 = time.perf_counter_ns()
                h.execute(until)
                h.perf_exec_ns += time.perf_counter_ns() - t0
            return
        if self._pool is None:
            if self.plane is not None:
                active = self._run_engine_batch(until, self._mt_threads)
            else:
                active = self._active_hosts(until)
            for h in active:
                h.execute(until)
            return
        if self._per_host_tasks:
            # thread_per_host: one task a host.
            list(self._pool.map(lambda h: h.execute(until),
                                self._active_hosts(until)))
            return
        if self.plane is not None:
            active = self._run_engine_batch(until,
                                            self._pool._max_workers)
        else:
            active = self._active_hosts(until)
        if not active:
            return
        # thread_per_core: workers claim blocks of hosts off one shared
        # cursor, so a thread that drew cheap hosts takes the rest of an
        # expensive neighbour's share.
        n = self._pool._max_workers
        block = max(1, len(active) // (n * 8))
        cursor = [0]
        lock = self._steal_lock

        def run_worker(_):
            while True:
                with lock:
                    i = cursor[0]
                    cursor[0] = i + block
                if i >= len(active):
                    return
                for h in active[i:i + block]:
                    h.execute(until)

        list(self._pool.map(run_worker, range(n)))

    def _drain_engine_pcap(self) -> None:
        eng = self.plane.engine
        for host, w_lo, w_eth in self._pcap_engine:
            for (ifidx, t, src, seq, proto, sip, sport, dip, dport,
                 payload, tcp) in eng.pcap_take(host.id):
                w = w_lo if ifidx == 0 else w_eth
                w.write_fields(t, src, seq, proto, sip, sport, dip, dport,
                               payload, tcp)

    def run(self) -> SimSummary:
        exp = self.config.experimental
        stop = self.config.general.stop_time_ns
        progress = self.config.general.progress
        heartbeat = self.config.general.heartbeat_interval_ns
        next_heartbeat = heartbeat
        wall_start = time.perf_counter()
        LOG.set_level(self.config.general.log_level)
        status = None
        heartbeat_lines = progress
        status_throttle = 0.2
        if progress:
            from shadow_tpu_torch.utils.status_bar import (StatusBar,
                                                           make_status)
            status = make_status(stop)
            # A redrawing bar and newline heartbeats garble each other on
            # one TTY: the bar subsumes the heartbeat there.  Elsewhere
            # every update is a log line, so throttle harder.
            heartbeat_lines = not isinstance(status, StatusBar)
            if heartbeat_lines:
                status_throttle = 1.0
        next_status_wall = 0.0
        summary = SimSummary()
        self._init_next_times()
        start = self._min_next_event()
        prop = self.propagator
        audit = self.audit
        eng = self.plane.engine if self.plane is not None else None
        flight = self.flight
        fr_sim = flight.sim if flight is not None else None
        fr_wall = flight.wall if flight is not None else None
        netstat = self.netstat
        fabric = self.fabric
        # Spans serve only the tpu scheduler with the engine; the CPU
        # schedulers keep the reference's per-round architecture, and so
        # do perf timers.  Forced-device mode (min_device_batch <= 0) is
        # the parity/audit path: every round must go through the kernel,
        # so spans (whose propagation runs the C++ twin or a span loop)
        # stay out.
        span_static = (self.tpu and eng is not None
                       and not self._perf_timers)
        span_ok = span_static and prop.route.min_device_batch > 0
        # Why the per-round path runs when spans are statically out.
        per_round_static = (trev.EL_ROUND_FORCED
                            if span_static and not span_ok
                            else trev.EL_ROUND_SCHED)
        # Device-resident spans: "auto" measures device vs C++ span
        # throughput per round and routes, "force"/"on" always take the
        # device, "off" disables.
        dev_mode = exp.tpu_device_spans
        dev_span_on = dev_mode in ("auto", "force", "on")
        dev_off_reason = (trev.EL_ENGINE_FAMILY if dev_span_on
                          else trev.EL_ENGINE_OFF)
        dev_ns_round = None   # EWMA wall ns/round, device spans
        cpp_ns_round = None   # EWMA wall ns/round, C++ spans
        dev_probe_countdown = 0
        dev_aborts_row = 0
        # Speculative multi-window sizing: double the batch while spans
        # run clean, shrink hard on an abort.
        dev_span_K = exp.dev_span_k_init
        dev_k_floor = exp.dev_span_k_floor
        dev_k_shrink = exp.dev_span_k_shrink
        # With engine pcap, spans stop every pcap_span_cap rounds for the
        # drain (the capture streams; a span must not buffer a sim).
        max_rounds = exp.pcap_span_cap if self._pcap_engine else 1024
        # The overlapped pipeline: every device dispatch also carries the
        # next window's max rounds (the doubling after a clean commit,
        # computed up front so the in-flight window's params match the
        # next dispatch).
        overlap_on = self._span_overlap_on()

        def progress_at(t: int) -> None:
            """The heartbeat and the status bar after a round or span
            that ended at sim time `t`."""
            nonlocal next_heartbeat, next_status_wall
            if heartbeat_lines and t >= next_heartbeat:
                self._log_heartbeat(t, stop, wall_start, sys.stderr)
                next_heartbeat = t + heartbeat
            if status is not None:
                wall = time.perf_counter()
                if wall >= next_status_wall:  # throttle redraws
                    status.update(t)
                    next_status_wall = wall + status_throttle

        def account_span(res, reason, device=False,
                         family=trev.FAM_CPP) -> int | None:
            rounds, busy_rounds, pkts, next_start, busy_end, ra = res
            base_round = summary.rounds
            summary.rounds += rounds
            summary.span_rounds += rounds
            summary.busy_end_ns = busy_end
            audit.add(reason, rounds)
            if fr_sim is not None:
                fr_sim.event(start, trev.FR_SPAN_START, family, 0,
                             base_round)
                if not device:
                    # The engine's per-round records of the span, with
                    # the manager's reason on them.
                    fr_sim.extend_engine(*eng.flight_take(), reason=reason)
                fr_sim.event(busy_end, trev.FR_SPAN_COMMIT, family, pkts,
                             rounds)
            if not device:
                # A C++ span's samples, from the engine's rings (a device
                # span's runner appends its own at commit).
                if netstat is not None:
                    netstat.extend(*eng.netstat_take())
                if fabric is not None:
                    fabric.extend(*eng.fabric_take())
            if self._pcap_engine:
                self._drain_engine_pcap()
            self.runahead.sync_from_span(ra)
            self._span_busy_rounds += busy_rounds
            self._span_packets += pkts
            if device:
                self._dev_busy_rounds += busy_rounds
                self._dev_packets += pkts
            progress_at(busy_end)
            return None if next_start >= TIME_NEVER else next_start

        while start is not None and start < stop:
            round_reason = per_round_static
            span_now = False
            if span_ok:
                if prop._outbox:
                    round_reason = trev.EL_ROUND_OUTBOX
                elif not prop.span_gate():
                    # A device measured winning per round keeps them.
                    round_reason = trev.EL_ROUND_GATE
                else:
                    span_now = True
            py_limit = None
            py_quiescent = False
            if span_now and self._py_work.any():
                # Python-side work pending (an engine host's spawn task,
                # or an object-path host in a mixed sim): spans may still
                # serve the stretch up to the earliest window that could
                # touch it.  An object-path host may also receive from
                # engine hosts mid-span: the engine then ends the span at
                # that round and hands the packets back (exports).
                py_min = int(self._nt[self._py_work].min())
                ra = self.runahead.get()
                if start > py_min - ra:
                    span_now = False
                    round_reason = self._object_block_reason(py_min)
                else:
                    py_limit = py_min - ra + 1
                    # The quiescence gate: when the earliest Python-side
                    # work is all managed hosts' (every managed process
                    # parked with no expiry before py_min), the span
                    # rounds below count as managed-quiescent.
                    if self._managed_mask is not None:
                        idx = np.flatnonzero(self._py_work
                                             & (self._nt == py_min))
                        py_quiescent = bool(idx.size) and bool(
                            self._managed_mask[idx].all())
            if span_now:
                limit = stop
                if heartbeat_lines:
                    # The loop regains control at the next heartbeat;
                    # `limit` never changes window sequencing, so the
                    # outputs are unaffected.
                    limit = min(limit, next_heartbeat)
                if py_limit is not None:
                    limit = min(limit, py_limit)
                # Why the rounds below land in a C++ span instead of a
                # device span (the audit's engine-span:* split).
                if py_limit is not None:
                    span_reason = (trev.EL_SVC_QUIESCENT if py_quiescent
                                   else trev.EL_ENGINE_PYLIMIT)
                elif not dev_span_on:
                    span_reason = dev_off_reason
                else:
                    span_reason = trev.EL_ENGINE_COLD
                use_dev = False
                if dev_span_on and py_limit is None:
                    if dev_mode in ("force", "on"):
                        use_dev = True
                    elif dev_ns_round is not None \
                            and cpp_ns_round is not None:
                        use_dev = dev_ns_round < cpp_ns_round
                        span_reason = trev.EL_ENGINE_ROUTED
                    elif dev_ns_round is None:
                        # Unmeasured: only long runs earn a probe (the
                        # reference's 1%-of-wall budget).
                        elapsed = time.perf_counter() - wall_start
                        use_dev = (dev_probe_countdown <= 0
                                   and elapsed * 0.01 >= 5.0)
                dev_retry_soon = False
                if use_dev:
                    t0 = time.perf_counter_ns()
                    res, runner = self._device_span(
                        start, stop, limit, min(max_rounds, dev_span_K),
                        spec_mr=(min(dev_span_K * 2, max_rounds)
                                 if overlap_on else 0))
                    if res is not None and res[0] == 0:
                        res = ZERO_PROGRESS  # e.g. a boundary due now
                    if res is not None and res is not ZERO_PROGRESS:
                        dev_aborts_row = 0
                        dev_span_K = min(dev_span_K * 2, max_rounds)
                        if runner.last_was_cold:
                            dev_probe_countdown = 0
                        else:
                            per = (time.perf_counter_ns() - t0) \
                                / max(res[0], 1)
                            dev_ns_round = per if dev_ns_round is None \
                                else 0.7 * dev_ns_round + 0.3 * per
                            dev_probe_countdown = 16
                        start = account_span(
                            res, trev.EL_DEVICE_SPAN, device=True,
                            family=(trev.FAM_TCP
                                    if runner is self._dev_span_tcp
                                    else trev.FAM_PHOLD))
                        continue
                    if res is None and runner.ineligible:
                        dev_span_on = False  # no device-span family fits
                        dev_off_reason = trev.EL_ENGINE_FAMILY
                        span_reason = trev.EL_ENGINE_FAMILY
                    elif res is None and runner.last_transient:
                        # Out of the TCP family's domain for now
                        # (handshake/close): cap the C++ span below so
                        # the device is re-probed within a few windows.
                        dev_retry_soon = True
                        span_reason = trev.EL_ENGINE_TRANSIENT
                    elif res is None:
                        # Abort: shrink the window batch, back off, and
                        # give up after repeated failures.
                        span_reason = trev.EL_ENGINE_ABORT
                        if fr_sim is not None:
                            fr_sim.event(
                                start, trev.FR_SPAN_ABORT,
                                trev.FAM_TCP if runner is self._dev_span_tcp
                                else trev.FAM_PHOLD,
                                runner.last_abort_code, 0)
                        dev_span_K = max(dev_k_floor,
                                         dev_span_K // dev_k_shrink)
                        dev_aborts_row += 1
                        dev_probe_countdown = 16 * dev_aborts_row
                        if dev_aborts_row >= 3:
                            dev_span_on = False
                            dev_off_reason = trev.EL_ENGINE_ABORT
                elif dev_span_on:
                    dev_probe_countdown -= 1

                t0 = time.perf_counter_ns()
                res = self.plane.engine.run_span(
                    start, stop, limit, self.runahead.get(),
                    int(self.runahead.dynamic),
                    min(max_rounds, 16) if dev_retry_soon else max_rounds,
                    self._mt_threads)
                if res is None:
                    span_ok = False  # callback-capable host: per-round
                    per_round_static = trev.EL_ROUND_CALLBACK
                    round_reason = per_round_static
                else:
                    exports = res[6]
                    res = res[:6]
                    if exports:
                        # Mixed sim: the span stopped at the round that
                        # addressed an object-path host; its packets are
                        # delivered at their recorded times.
                        deliver_engine_exports(self.hosts, exports)
                    if res[0]:
                        dt = time.perf_counter_ns() - t0
                        per = dt / res[0]
                        cpp_ns_round = per if cpp_ns_round is None \
                            else 0.7 * cpp_ns_round + 0.3 * per
                        if fr_wall is not None:
                            fr_wall.add("engine-span", dt, t0)
                        start = account_span(res, span_reason)
                        if exports:
                            # the deliveries lowered object hosts' slots
                            nxt = self._min_next_event()
                            if nxt is not None and (start is None
                                                    or nxt < start):
                                start = nxt
                        continue
                    # rounds == 0 (e.g. a heartbeat boundary due now):
                    # one per-round iteration.
                    round_reason = trev.EL_ROUND_BOUNDARY
            window_end = min(start + self.runahead.get(), stop)
            prop.begin_round(start, window_end)
            if flight is not None:
                pk0 = getattr(prop, "packets_batched", 0)
                t0 = fr_wall.now()
                self._run_hosts(window_end)
                t1 = fr_wall.now()
                fr_wall.add("host-loop", t1 - t0, t0)
                inflight_min = prop.finish_round()
                fr_wall.add("propagate", fr_wall.now() - t1, t1)
                if fr_sim is not None:
                    fr_sim.event(window_end, trev.FR_ROUND, round_reason,
                                 getattr(prop, "packets_batched", 0) - pk0,
                                 start)
            else:
                self._run_hosts(window_end)
                inflight_min = prop.finish_round()
            # The round boundary's samples, from the engine's rings.
            # The engine's block first, then the object-path hosts', each
            # in ascending host id.
            if netstat is not None and netstat.sampled(start, window_end):
                if eng is not None:
                    eng.netstat_sample(start, window_end)
                    netstat.extend(*eng.netstat_take())
                netstat.sample_object_hosts(self.hosts, window_end)
            if fabric is not None and fabric.sampled(start, window_end):
                if eng is not None:
                    eng.fabric_sample(start, window_end)
                    fabric.extend(*eng.fabric_take())
                fabric.sample_object_hosts(self.hosts, window_end)
            audit.add(round_reason, 1)
            if self._pcap_engine:
                self._drain_engine_pcap()
            summary.rounds += 1
            summary.busy_end_ns = window_end
            progress_at(window_end)
            nxt = self._min_next_event()
            if inflight_min is not None and (nxt is None
                                             or inflight_min < nxt):
                nxt = inflight_min
            start = nxt
        summary.end_time_ns = min(start, stop) if start is not None \
            else stop
        if self.containment is not None:
            # The end-of-run teardown of still-running binaries is not a
            # failure.
            self.containment.active = False
        if status is not None:
            status.finish(summary.end_time_ns)
        if self._pool is not None:
            self._pool.shutdown()
        if self.svc is not None:
            self.svc.shutdown()
        if overlap_on:
            # A window the run ended before landing: join and discard.
            for r in (self._dev_span, self._dev_span_tcp):
                if r is not None:
                    r.drop_inflight()
        prop.close()  # joins a probe in flight; re-raises its failure

        for h in self.hosts:
            h.merge_native_counters()
            summary.events += h.counters["events"]
            summary.packets_sent += h.counters["packets_sent"]
            summary.packets_recv += h.counters["packets_recv"]
            summary.packets_dropped += h.counters["packets_dropped"]
            summary.syscalls += h.counters["syscalls"]
            for proc in h.processes.values():
                if not proc.matches_expected_final_state():
                    state = (f"exited {proc.exit_code}" if proc.exited
                             else "running")
                    summary.plugin_errors.append(
                        f"{h.name}/{proc.name}: expected "
                        f"{proc.expected_final_state!r}, got {state!r}")
        # Teardown at one canonical instant — the simulation end — on
        # every host: the closes emit packets (FINs of mid-stream
        # connections) traced at the host's clock.
        for h in self.hosts:
            if h._now < summary.end_time_ns:
                h._now = summary.end_time_ns
        if eng is not None:
            eng.advance_clocks(summary.end_time_ns)
        from shadow_tpu_torch.host.managed import ManagedProcess
        for h in self.hosts:
            for proc in h.processes.values():
                if isinstance(proc, ManagedProcess) and not proc.exited:
                    proc.kill_native()
                    proc.collect_output()
                if not proc.exited:
                    # The forced teardown releases the fd tables.
                    proc.fds.close_all(h)
                    low = getattr(proc, "fds_low", None)
                    if low is not None:
                        low.close_all(h)
        # Object-path captures (an engine host's interfaces are never
        # built).
        for h in self.hosts:
            if h.net_built():
                for iface in (h.lo, h.eth0):
                    if iface.pcap is not None:
                        iface.pcap.close()
        if self._pcap_engine:
            self._drain_engine_pcap()
            for _h, w_lo, w_eth in self._pcap_engine:
                w_lo.close()
                w_eth.close()
        return summary

    # ------------------------------------------------------------------
    # Device spans
    # ------------------------------------------------------------------

    def _span_runner_args(self) -> tuple:
        return (self.plane.engine, self.latency_ns, self.loss_thresholds,
                np.ascontiguousarray([h.node_index for h in self.hosts],
                                     dtype=np.int32),
                np.ascontiguousarray([h.ip for h in self.hosts],
                                     dtype=np.uint32),
                self.config.general.seed,
                self.config.general.bootstrap_end_time_ns)

    def _span_overlap_on(self) -> bool:
        return self.tpu and span_overlap_on(
            self.config.experimental.span_overlap, self.device)

    def _configure_runner(self, runner):
        """A span runner's Manager-wide settings: the overlap, the flight
        recorder's wall phases and the channels whose records it appends
        at each commit (sim-netstat is the TCP family's alone: PHOLD has
        no TCP connection)."""
        runner.overlap = self._span_overlap_on()
        if self.flight is not None:
            runner.wall = self.flight.wall
        runner.fabric = self.fabric
        runner.kern = self.kern
        return runner

    def make_dev_span_runner(self):
        from shadow_tpu_torch.ops.phold_span import PholdSpanRunner
        runner = PholdSpanRunner(*self._span_runner_args(), tracing=True,
                                 device=self.device)
        return self._configure_runner(runner)

    def make_tcp_span_runner(self):
        from shadow_tpu_torch.ops.tcp_span import TcpSpanRunner
        runner = TcpSpanRunner(*self._span_runner_args(), tracing=True,
                               device=self.device)
        runner.dctcp_k = (self.config.experimental.dctcp_k_pkts,
                          self.config.experimental.dctcp_k_bytes)
        runner.netstat = self.netstat
        return self._configure_runner(runner)

    def _device_span(self, start: int, stop: int, limit: int,
                     max_rounds: int, spec_mr: int = 0):
        """One device-resident multi-round span, routed between the
        PHOLD/udp-mesh family and the TCP steady-stream family.  Returns
        (result, runner); result None = ineligible / transient / aborted
        (the engine state is untouched either way)."""
        args = (start, stop, limit, self.runahead.get(),
                self.runahead.dynamic, max_rounds)
        if self._dev_span is None:
            self._dev_span = self.make_dev_span_runner()
        phold = self._dev_span
        if not phold.ineligible:
            res = phold.try_span(*args, spec_mr=spec_mr)
            if res is not None or not phold.ineligible:
                return res, phold
        # permanently not PHOLD-shaped: the TCP family
        if self._dev_span_tcp is None:
            self._dev_span_tcp = self.make_tcp_span_runner()
        tcp = self._dev_span_tcp
        if tcp.ineligible:
            return None, tcp
        return tcp.try_span(*args, spec_mr=spec_mr), tcp

    def dispatch_summary(self) -> dict:
        """The dispatch block (sim-stats.json's `metrics.wall.dispatch`,
        and the CLI's `dispatch:` line): the reference's keys for every
        value the port has (the span/per-round split, the router's knob
        values, each device-span family's counters), and the port's own:
        `span_overlap_on`, the per-round propagator's `propagate` block
        and each family's kernel counters."""
        exp = self.config.experimental
        prop = self.propagator
        out = {
            "span_rounds": self.audit.span_rounds(),
            "rounds_dispatched": (getattr(prop, "rounds_dispatched", 0)
                                  + self._span_busy_rounds),
            "packets_batched": (getattr(prop, "packets_batched", 0)
                                + self._span_packets),
            "rounds_device": (getattr(prop, "rounds_device", 0)
                              + self._dev_busy_rounds),
            "packets_device": (getattr(prop, "packets_device", 0)
                               + self._dev_packets),
            # The engine-pcap span cap in effect (1024: no engine pcap,
            # the generic clamp).
            "pcap_span_cap": (exp.pcap_span_cap if self._pcap_engine
                              else 1024),
            "span_overlap": exp.span_overlap,
            "pallas_queue_kernels": exp.pallas_queue_kernels,
            "dev_span_k": {"init": exp.dev_span_k_init,
                           "floor": exp.dev_span_k_floor,
                           "shrink": exp.dev_span_k_shrink},
            "span_overlap_on": self._span_overlap_on(),
        }
        if self.tpu:
            out["propagate"] = prop.summary()
        for family, r in (("phold", self._dev_span),
                          ("tcp", self._dev_span_tcp)):
            if r is None:
                continue
            out[f"device_span_{family}"] = {
                "spans": r.spans,
                "rounds": r.rounds,
                "micro_iters": r.micro_iters,
                "aborts": r.aborts,
                "ineligible": r.ineligible,
                "transient_or_over_caps": r.over_caps,
                "resident_hits": r.resident_hits,
                "stale_drops": r.stale_drops,
                "dispatch_wall_s": round(r.device_wall_ns / 1e9, 6),
                "rolled_back_rounds": r.rolled_back_rounds,
                "rollback_wall_s": round(r.rollback_wall_ns / 1e9, 6),
                "abort_kinds": dict(r.abort_kind_counts()),
                "export_bytes": r.export_bytes,
                "import_bytes": r.import_bytes,
                "overlap": r.overlap_summary(),
                # The family's kernel launches over every dispatch: span
                # launches, and the windows a kernel stepped.
                "span_launches": r.spans_all,
                "kernel_windows": r.windows_all,
                "ks_spans": r.ks_spans,
                "ks_span_ms": round(r.ks_span_ms, 6),
                "ks_windows": r.ks_windows,
                "ks_window_ms": round(r.ks_window_ms, 6),
            }
        return out

    # ------------------------------------------------------------------
    # Counter sweeps (the engine leg of the reference's)
    # ------------------------------------------------------------------

    def drop_cause_totals(self) -> dict:
        """Packet-drop attribution summed over hosts: cause-name ->
        count (nonzero causes only; `unattributed` = drops with no
        TEL_* cause, which the conservation check rejects)."""
        causes = [0] * trev.TEL_N
        unattributed = 0
        for h in self.hosts:
            h.merge_native_counters()
            for i in range(trev.TEL_N):
                causes[i] += h.drop_causes[i]
            unattributed += h.drop_unattributed
        out = {trev.TEL_NAMES[i]: causes[i] for i in range(trev.TEL_N)
               if causes[i]}
        if unattributed:
            out["unattributed"] = unattributed
        return out

    def netstat_summary(self) -> dict:
        """Per-cause drop counts plus the TCP stream totals (segments /
        retransmits): the engine's, or with no engine the object-path
        connections'.  Wall-side reporting only."""
        out = {"drops": self.drop_cause_totals()}
        if self.plane is not None:
            out["tcp"] = self.plane.engine.netstat_totals()
            return out
        from shadow_tpu_torch.trace.netstat import iter_host_tcp_sockets
        totals = {"conns": 0, "segments_sent": 0, "segments_received": 0,
                  "retransmits": 0, "sacked_skips": 0, "reasm_discards": 0,
                  "rcvwin_trunc": 0}
        for h in self.hosts:
            if not h.net_built():
                continue
            for sock in iter_host_tcp_sockets(h):
                conn = sock.conn
                if conn is None:
                    continue
                totals["conns"] += 1
                totals["segments_sent"] += conn.segments_sent
                totals["segments_received"] += conn.segments_received
                totals["retransmits"] += conn.retransmit_count
                totals["sacked_skips"] += conn.sacked_skip_count
                totals["reasm_discards"] += conn.reasm_discards
                totals["rcvwin_trunc"] += conn.rcvwin_trunc
        out["tcp"] = totals
        return out

    def _fabric_host_counters(self, h) -> tuple | None:
        """One host's fabric counter tuple from whichever plane owns its
        queues; None for an object-path host that never built its
        network plane."""
        if h.plane is not None:
            return self.plane.engine.fabric_counters(h.id)
        if not h.net_built():
            return None
        from shadow_tpu_torch.trace.fabricstat import host_fabric_counters
        return host_fabric_counters(h)

    def _fabric_sweep(self) -> tuple:
        """One walk over every host's engine fabric counters: the
        conservation ledger and the hottest link's bits-sent / bw_up
        (link-seconds of uplink traffic).  For every host, CoDel packets
        and bytes enqueued must equal forwarded + dropped + queued +
        relay-parked, the drops must equal the TEL_CODEL + TEL_RTR_LIMIT
        causes, and the marks their MARK_* causes (at most one a packet
        enqueued)."""
        totals = {"enqueued_pkts": 0, "enqueued_bytes": 0,
                  "delivered_pkts": 0, "delivered_bytes": 0,
                  "dropped_pkts": 0, "dropped_bytes": 0,
                  "marked_pkts": 0, "queued_pkts": 0,
                  "queued_bytes": 0, "peak_queue_depth": 0,
                  "refill_stalls": 0, "violations": 0}
        mark_causes = [0] * trev.MARK_N
        max_link_s = 0.0
        for h in self.hosts:
            c = self._fabric_host_counters(h)
            if c is None:
                continue
            (enq_p, enq_b, fwd_p, fwd_b, drop_p, drop_b, marked,
             depth, qbytes, peak, r1s, r2s, _ps, bsent, _pr, _br,
             park_p, park_b) = c
            h.merge_native_counters()
            totals["enqueued_pkts"] += enq_p
            totals["enqueued_bytes"] += enq_b
            totals["delivered_pkts"] += fwd_p
            totals["delivered_bytes"] += fwd_b
            totals["dropped_pkts"] += drop_p
            totals["dropped_bytes"] += drop_b
            totals["marked_pkts"] += marked
            # a relay-parked packet is still inside the fabric
            totals["queued_pkts"] += depth + park_p
            totals["queued_bytes"] += qbytes + park_b
            totals["refill_stalls"] += r1s + r2s
            totals["peak_queue_depth"] = max(
                totals["peak_queue_depth"], peak)
            for i in range(trev.MARK_N):
                mark_causes[i] += h.mark_causes[i]
            if h.bw_up_bits:
                max_link_s = max(max_link_s, bsent * 8 / h.bw_up_bits)
            attributed = (h.drop_causes[trev.TEL_CODEL]
                          + h.drop_causes[trev.TEL_RTR_LIMIT])
            if enq_p != fwd_p + drop_p + depth + park_p \
                    or enq_b != fwd_b + drop_b + qbytes + park_b \
                    or drop_p != attributed \
                    or marked != sum(h.mark_causes) \
                    or marked > enq_p:
                totals["violations"] += 1
        totals["marks"] = {trev.MARK_NAMES[i]: mark_causes[i]
                           for i in range(trev.MARK_N) if mark_causes[i]}
        return totals, max_link_s

    def fabric_conservation(self) -> dict:
        """The conservation ledger (the counters are always on)."""
        return self._fabric_sweep()[0]

    def collect_fct_rows(self) -> list:
        """Every flow record: the engine's teardown log and its live
        connections with payload history, then each object-path host's
        (the channel's writer sorts them)."""
        rows: list = []
        if self.plane is not None:
            rows.extend(tuple(r) for r in self.plane.engine.fct_flows())
        from shadow_tpu_torch.trace.fabricstat import object_host_flow_rows
        for h in self.hosts:
            if h.plane is None and h.net_built():
                rows.extend(object_host_flow_rows(h))
        return rows

    def fabric_summary(self, end_time_ns: int) -> dict:
        """bench.py's `fabric` block: the conservation ledger's peak
        queue depth, refill stalls and marks, the hottest link's
        utilization over `end_time_ns`, the verdict, and FCT
        percentiles over one record a flow (the receiver's) where TCP
        flows exist."""
        from shadow_tpu_torch.trace.fabricstat import (percentile,
                                                       receiver_rows)
        cons, max_link_s = self._fabric_sweep()
        dur_s = end_time_ns / 1e9
        util = max_link_s / dur_s if dur_s > 0 else 0.0
        out = {
            "peak_queue_depth": cons["peak_queue_depth"],
            "refill_stalls": cons["refill_stalls"],
            "marked_pkts": cons["marked_pkts"],
            "marks": cons["marks"],
            "link_utilization": round(util, 4),
            "conservation": ("ok" if cons["violations"] == 0
                             else f"{cons['violations']} violations"),
        }
        durs = sorted(r[1] - r[0]
                      for r in receiver_rows(self.collect_fct_rows()))
        if durs:
            out["fct"] = {
                "flows": len(durs),
                "p50_ns": percentile(durs, 500),
                "p99_ns": percentile(durs, 990),
                "p999_ns": percentile(durs, 999),
            }
        return out

    def sc_disposition_totals(self) -> dict:
        """Syscall dispositions summed over hosts: SC name -> count
        (nonzero only).  They count the internal apps' Python-dispatched
        syscalls; engine-resident apps dispatch C++-side and sit outside
        this accounting."""
        totals = [0] * trev.SC_N
        for h in self.hosts:
            for i in range(trev.SC_N):
                totals[i] += h.sc_disp[i]
        return {trev.SC_NAMES[i]: totals[i] for i in range(trev.SC_N)
                if totals[i]}

    # ------------------------------------------------------------------
    # Progress
    # ------------------------------------------------------------------

    def _log_heartbeat(self, sim_now: int, stop: int, wall_start: float,
                       out) -> None:
        """Progress and resource heartbeat, the reference's lines after
        the port's prefix; the two resource lines keep the reference's
        words exactly (tornettools' parse_rusage.py matches them)."""
        wall = time.perf_counter() - wall_start
        pct = 100.0 * sim_now / stop if stop else 100.0
        for h in self.hosts:
            h.merge_native_counters()
        events = sum(h.counters["events"] for h in self.hosts)
        packets = sum(h.counters["packets_sent"] for h in self.hosts)
        mem_kb = _rss_kb()
        rate = (sim_now / 1e9) / wall if wall > 0 else 0.0
        print(f"[shadow-tpu-torch] heartbeat: sim {sim_now / 1e9:.3f}s / "
              f"{stop / 1e9:.3f}s ({pct:.1f}%), {rate:.2f} "
              f"sim-sec/wall-sec, events {events}, packets {packets}, "
              f"rss {mem_kb} kB", file=out, flush=True)
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)
        print(f"Process resource usage at simtime {sim_now} reported by "
              f"getrusage(): "
              f"ru_maxrss={ru.ru_maxrss / (1024 * 1024):.03f} GiB, "
              f"ru_utime={ru.ru_utime / 60:.03f} minutes, "
              f"ru_stime={ru.ru_stime / 60:.03f} minutes, "
              f"ru_nvcsw={ru.ru_nvcsw}, "
              f"ru_nivcsw={ru.ru_nivcsw}",
              file=out, flush=True)
        try:
            mem = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, _, v = line.partition(":")
                    parts = v.split()
                    if parts and parts[0].isdigit():
                        n = int(parts[0])
                        if len(parts) > 1 and parts[1] == "kB":
                            n *= 1024  # every value in bytes
                        mem[k.strip()] = n
            print(f"System memory usage in bytes at simtime {sim_now} ns "
                  f"reported by /proc/meminfo: {json.dumps(mem)}",
                  file=out, flush=True)
        except OSError:
            pass

    # ------------------------------------------------------------------
    # Outputs
    # ------------------------------------------------------------------

    def trace_lines(self) -> list[str]:
        lines = []
        for h in self.hosts:
            lines.extend(h.trace_lines())
        return lines

    def write_data_dir(self, summary: SimSummary) -> None:
        """The run's data directory, as the reference writes it for the
        same run: processed-config.yaml, hosts.txt, each process's
        stdout and stderr, packet-trace.txt, sim-stats.json and the
        files of the channels that are on (the pcaps are written as the
        run goes)."""
        import yaml
        base = self.config.general.data_directory
        os.makedirs(base, exist_ok=True)
        with open(os.path.join(base, "processed-config.yaml"), "w") as f:
            yaml.safe_dump(self.config.to_processed_dict(), f,
                           sort_keys=False, default_flow_style=False)
        with open(os.path.join(base, "hosts.txt"), "w") as f:
            f.write(self.dns.hosts_file_text())
        for h in self.hosts:
            hdir = os.path.join(base, "hosts", h.name)
            os.makedirs(hdir, exist_ok=True)
            for proc in h.processes.values():
                stem = os.path.join(hdir, f"{proc.name}.{proc.pid}")
                with open(stem + ".stdout", "wb") as f:
                    f.write(bytes(proc.stdout))
                with open(stem + ".stderr", "wb") as f:
                    f.write(bytes(proc.stderr))
        with open(os.path.join(base, "packet-trace.txt"), "w") as f:
            for line in self.trace_lines():
                f.write(line + "\n")
        for kind, delta in object_counter.leaks().items():
            LOG.warning(f"object leak: {delta} {kind} object(s) "
                        f"allocated but never closed")
        LOG.flush()
        syscall_hist: dict[str, int] = {}
        for h in self.hosts:
            for name, n in h.syscall_counts.items():
                syscall_hist[name] = syscall_hist.get(name, 0) + n
        reg = self.metrics
        # Wall channel: the scheduler's telemetry (the gate strips it).
        reg.ingest("dispatch", self.dispatch_summary(), channel="wall")
        if self.svc is not None:
            reg.ingest("svc", self.svc.wall_summary(), channel="wall")
        # Sim channel: deterministic and path-identical, byte-diffed.
        # The conservation contract: the wire causes sum to
        # packets_dropped; the two TCP receiver discards sit outside.
        reg.ingest("netstat.drops", self.drop_cause_totals(),
                   channel="sim")
        if self.netstat is not None:
            reg.gauge("netstat.records", channel="sim").set(
                self.netstat.records)
            reg.gauge("netstat.dropped", channel="sim").set(
                self.netstat.dropped)
            self.netstat.write(base)
        reg.ingest("fabric", self.fabric_conservation(), channel="sim")
        if self.fabric is not None:
            reg.gauge("fabric.records", channel="sim").set(
                self.fabric.records)
            reg.gauge("fabric.dropped", channel="sim").set(
                self.fabric.dropped)
            fct_rows = self.collect_fct_rows()
            reg.gauge("fabric.flows", channel="sim").set(len(fct_rows))
            self.fabric.write(base, fct_rows)
        if self.kern is not None:
            reg.gauge("kern.records", channel="sim").set(self.kern.records)
            reg.gauge("kern.dropped", channel="sim").set(self.kern.dropped)
            self.kern.write(base)
        reg.ingest("syscalls.dispositions", self.sc_disposition_totals(),
                   channel="sim")
        if self.containment is not None:
            # The fault ledger: the containment plane's record of every
            # containment action.
            ledger = self.containment.ledger()
            with open(os.path.join(base, "fault-ledger.json"), "w") as f:
                json.dump(ledger, f, indent=1, sort_keys=True)
            reg.gauge("containment.quarantines", channel="sim").set(
                len(ledger["ops"]))
        # One reason code per conservative round.
        reg.ingest("eligibility", self.audit.as_dict(), channel="wall")
        if self.shim_build is not None:
            reg.gauge("shim_build", channel="wall").set(self.shim_build)
        if self.flight is not None:
            reg.ingest("phases", {name: ns for name, (ns, _c) in
                                  self.flight.wall.phases.items()},
                       channel="wall")
            sim = self.flight.sim
            reg.gauge("flight.sim_records", channel="sim").set(
                sim.records if sim is not None else 0)
            reg.gauge("flight.sim_dropped", channel="sim").set(
                sim.dropped if sim is not None else 0)
            self.flight.write(base)
        stats = {
            "end_time_ns": summary.end_time_ns,
            "rounds": summary.rounds,
            "events": summary.events,
            "packets_sent": summary.packets_sent,
            "packets_recv": summary.packets_recv,
            "packets_dropped": summary.packets_dropped,
            "syscalls": summary.syscalls,
            "syscalls_by_name": syscall_hist,
            "metrics": reg.as_stats(),
            "objects": object_counter.snapshot(),
            "hosts": {h.name: dict(h.counters) for h in self.hosts},
        }
        if self._perf_timers:
            stats["perf"] = {"host_exec_ns":
                             {h.name: h.perf_exec_ns for h in self.hosts}}
        with open(os.path.join(base, "sim-stats.json"), "w") as f:
            json.dump(stats, f, indent=2, sort_keys=True)


def _topology_cpu_order(cpus: list[int]) -> list[int]:
    """The pool's CPU order: one logical CPU a physical core first
    (hyperthread siblings last), the cores interleaved round-robin over
    NUMA nodes, then the remaining siblings in the same order.  The input
    order when the topology is unreadable."""
    def read_int(path: str) -> int:
        try:
            with open(path) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return 0

    cpu_node: dict[int, int] = {}
    try:
        for entry in os.listdir("/sys/devices/system/node"):
            if not entry.startswith("node") or not entry[4:].isdigit():
                continue
            node = int(entry[4:])
            for sub in os.listdir(f"/sys/devices/system/node/{entry}"):
                if sub.startswith("cpu") and sub[3:].isdigit():
                    cpu_node[int(sub[3:])] = node
    except OSError:
        pass

    core_seen: set[tuple] = set()
    primaries: list[tuple] = []   # (node, pkg, core, cpu)
    siblings: list[tuple] = []
    for cpu in cpus:
        base = f"/sys/devices/system/cpu/cpu{cpu}/topology"
        pkg = read_int(f"{base}/physical_package_id")
        core = read_int(f"{base}/core_id")
        row = (cpu_node.get(cpu, 0), pkg, core, cpu)
        if (pkg, core) in core_seen:
            siblings.append(row)
        else:
            core_seen.add((pkg, core))
            primaries.append(row)

    def node_interleave(rows: list[tuple]) -> list[int]:
        by_node: dict[int, list[int]] = {}
        for node, _pkg, _core, cpu in sorted(rows):
            by_node.setdefault(node, []).append(cpu)
        out: list[int] = []
        queues = [by_node[n] for n in sorted(by_node)]
        while any(queues):
            for q in queues:
                if q:
                    out.append(q.pop(0))
        return out

    ordered = node_interleave(primaries) + node_interleave(siblings)
    return ordered if ordered else cpus


def _make_pinner():
    """`use_cpu_pinning`: each worker thread of the Python host pool pins
    itself to the next CPU in the topology order (its own affinity
    only); None when the affinity cannot be read."""
    import itertools

    try:
        cpus = sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return None
    if not cpus:
        return None
    cpus = _topology_cpu_order(cpus)
    counter = itertools.count()
    lock = threading.Lock()

    def pin():
        with lock:
            i = next(counter)
        try:
            os.sched_setaffinity(0, {cpus[i % len(cpus)]})
        except OSError:
            pass

    return pin


def _rss_kb() -> int:
    """Resident set size from /proc."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def run_simulation(config: ConfigOptions, device=None,
                   write_data: bool = False):
    """Build a Manager (under `scheduler: tpu` on `device`, default the
    card), run it, write the data directory when asked, and return
    (manager, summary)."""
    manager = Manager(config, device=device)
    summary = manager.run()
    if write_data:
        manager.write_data_dir(summary)
    return manager, summary
