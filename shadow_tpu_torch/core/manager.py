"""Manager: build an engine-resident simulation and run the conservative
round loop, with TCP device spans on the card.

The port's counterpart of `shadow_tpu/core/manager.py`, for
engine-resident hosts only.  Every host lives on the C++ engine
(`native/netplane.cpp`); the loop picks the global minimum next-event
time and serves the rounds from it in one of three ways, exactly as
the reference does under `scheduler: tpu`:

- a device span: whole conservative windows of exported state stepped
  in PyTorch on the card and imported back transactionally, by the
  PHOLD/udp-mesh family (ops/phold_span.py) or, when the sim is not
  PHOLD-shaped, by the TCP steady-stream family (ops/tcp_span.py); a
  span that follows a clean one reuses its output on the card, and
  with `span_overlap` on the next window runs while the host imports
  this one (ops/span_mesh.py);
- a C++ span (engine.run_span): whole windows inside one engine call;
- one per-round iteration: hosts with Python-side work (spawn tasks)
  run through Host.execute, the rest in one engine batch, and the
  propagator (ops/propagate.py) propagates the round's packets, on the
  card (`stt_propagate`) or through the engine's bit-identical C++
  twin, as its route model decides.

`tpu_min_device_batch <= 0` forces every round through the kernel:
no span of either kind runs, and no round goes to the twin.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.rng import STREAM_PACKET_LOSS, mix_key
from shadow_tpu_torch.core.simtime import TIME_NEVER
from shadow_tpu_torch.host.engine_app import (EngineAppProcess,
                                              engine_app_args)
from shadow_tpu_torch.host.host import Host
from shadow_tpu_torch.net.dns import Dns
from shadow_tpu_torch.net.graph import IpAssignment, routing_arrays
from shadow_tpu_torch.utils.device import resolve_device


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
    """One configured process spawn: an engine-resident app."""

    __slots__ = ("pcfg", "index", "spec", "bufs")

    def __init__(self, pcfg, index: int, spec, bufs):
        self.pcfg = pcfg
        self.index = index
        self.spec = spec  # engine_app_args tuple
        self.bufs = bufs  # (send_buf, recv_buf, send_at, recv_at)

    def __call__(self, h) -> None:
        kind, a, b, c, d, e = self.spec[:6]
        extra = self.spec[6:]  # the peer-IP buffer of udp-mesh / phold
        send_buf, recv_buf, send_at, recv_at = self.bufs
        process = EngineAppProcess(
            h, f"{self.pcfg.path}.{self.index}",
            expected_final_state=self.pcfg.expected_final_state)
        process.app_idx = h.plane.engine.app_spawn(
            h.id, kind, a, b, c, d, e, send_buf, recv_buf, int(send_at),
            int(recv_at), h.now(), *extra)


class Manager:
    def __init__(self, config: ConfigOptions, device=None):
        self.device = resolve_device(device)
        self.config = config
        graph = config.network.graph
        lat, thr = routing_arrays(graph, config.network.use_shortest_path)
        self.graph = graph
        self.latency_ns = lat
        self.loss_thresholds = thr
        self.dns = Dns()
        exp = config.experimental
        bufs = (exp.socket_send_buffer, exp.socket_recv_buffer,
                exp.socket_send_autotune, exp.socket_recv_autotune)

        # Hosts in sorted-name order: host ids — and with them every RNG
        # stream and ordering tiebreak — are config-deterministic.
        ipa = IpAssignment()
        self.hosts: list[Host] = []
        seed = config.general.seed
        pending = []
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
                        bw_up)
            host.tcp_cc = hcfg.tcp_cc
            host.tcp_ecn = hcfg.tcp_ecn
            self.dns.register(host_id, ip, name)
            self.hosts.append(host)
            pending.append((host, hcfg))
        # Spawn tasks draw their event seqs from the host's own counter
        # before the engine takes the host over (the reference's order).
        for host, hcfg in pending:
            for i, pcfg in enumerate(hcfg.processes):
                spec = engine_app_args(pcfg, self.dns)
                if spec is None:
                    raise NotImplementedError(
                        f"shadow_tpu_torch does not serve host "
                        f"{host.name!r} process {pcfg.path} "
                        f"{pcfg.args} yet: it needs the object path "
                        f"(ROADMAP A2b)")
                host.schedule_task_at(pcfg.start_time_ns,
                                      SpawnTask(pcfg, i, spec, bufs))

        self.runahead = Runahead(exp.runahead_ns, graph.min_latency_ns(),
                                 exp.use_dynamic_runahead)

        from shadow_tpu_torch.native import plane as native_plane
        self.plane = native_plane.NativePlane(self.hosts)
        qdisc_rr = exp.interface_qdisc == "round_robin"
        for host in self.hosts:
            self.plane.add_host(host, qdisc_rr)
        eng = self.plane.engine
        eng.set_dctcp_k(exp.dctcp_k_pkts, exp.dctcp_k_bytes)
        # Routing state for the engine's scalar propagation twin.
        k0, k1 = mix_key(seed, STREAM_PACKET_LOSS)
        eng.set_routing(
            np.ascontiguousarray([h.node_index for h in self.hosts],
                                 dtype=np.int32),
            np.ascontiguousarray([h.ip for h in self.hosts],
                                 dtype=np.uint32),
            lat, thr, lat.shape[0], k0, k1,
            config.general.bootstrap_end_time_ns, TIME_NEVER)
        from shadow_tpu_torch.ops.propagate import TpuPropagator
        self.propagator = TpuPropagator(
            lat, thr, seed,
            config.general.bootstrap_end_time_ns, runahead=self.runahead,
            min_device_batch=exp.tpu_min_device_batch, device=self.device)
        self.propagator.engine = eng
        # OS-thread width for the engine's run_hosts_mt sections.
        self._mt_threads = config.general.parallelism or os.cpu_count() or 1
        self._nt = None
        self._py_work = None
        self._dev_span = None      # the PHOLD/udp-mesh family's runner
        self._dev_span_tcp = None  # the TCP family's runner

    # ------------------------------------------------------------------
    # The round loop
    # ------------------------------------------------------------------

    def _init_next_times(self) -> None:
        """Shared next-event snapshot (one slot per host) and the
        Python-work flags; the engine writes both in place."""
        nt = np.empty(len(self.hosts), dtype=np.int64)
        pw = np.ones(len(self.hosts), dtype=bool)
        for h in self.hosts:
            t = h.next_event_time()
            nt[h.id] = TIME_NEVER if t is None else t
            h._nt_list = nt
            h._py_work_arr = pw
            pw[h.id] = bool(h.heap)
        self._nt = nt
        self._py_work = pw
        self.plane.engine.set_nt(nt)
        self.plane.engine.set_py_work(pw)

    def _min_next_event(self) -> int | None:
        best = int(self._nt.min())
        return None if best >= TIME_NEVER else best

    def _run_hosts(self, until: int) -> None:
        """Hosts whose pending work is entirely engine-side run the window
        in one C call; hosts with Python-side work run Host.execute."""
        eng = self.plane.engine
        mask = self._nt < until
        fast = np.flatnonzero(mask & ~self._py_work)
        slow = np.flatnonzero(mask & self._py_work)
        if fast.size:
            stop = eng.run_hosts_mt(
                np.ascontiguousarray(fast, dtype=np.uint32), until,
                self._mt_threads)
            if stop >= 0:
                # A Python callback fired in the serial tail: finish that
                # host and the remainder through the merge loop.
                for hid in fast[stop:].tolist():
                    self.hosts[hid].execute(until)
        for hid in slow.tolist():
            self.hosts[hid].execute(until)

    def run(self) -> SimSummary:
        exp = self.config.experimental
        stop = self.config.general.stop_time_ns
        wall_start = time.perf_counter()
        summary = SimSummary()
        self._init_next_times()
        start = self._min_next_event()
        prop = self.propagator
        # Forced-device mode (min_device_batch <= 0) is the parity/audit
        # path: every round must go through the kernel, so spans (whose
        # propagation runs the C++ twin or a span loop) stay out.
        span_ok = prop.route.min_device_batch > 0
        # Device-resident spans: "auto" measures device vs C++ span
        # throughput per round and routes, "force"/"on" always take the
        # device, "off" disables.
        dev_mode = exp.tpu_device_spans
        dev_span_on = dev_mode in ("auto", "force", "on")
        dev_ns_round = None   # EWMA wall ns/round, device spans
        cpp_ns_round = None   # EWMA wall ns/round, C++ spans
        dev_probe_countdown = 0
        dev_aborts_row = 0
        # Speculative multi-window sizing: double the batch while spans
        # run clean, shrink hard on an abort.
        dev_span_K = exp.dev_span_k_init
        dev_k_floor = exp.dev_span_k_floor
        dev_k_shrink = exp.dev_span_k_shrink
        max_rounds = 1024
        # The overlapped pipeline: every device dispatch also carries the
        # next window's max rounds (the doubling after a clean commit,
        # computed up front so the in-flight window's params match the
        # next dispatch).
        overlap_on = self._span_overlap_on()

        def account_span(res) -> int | None:
            rounds, busy_rounds, pkts, next_start, busy_end, ra = res
            summary.rounds += rounds
            summary.span_rounds += rounds
            summary.busy_end_ns = busy_end
            self.runahead.sync_from_span(ra)
            return None if next_start >= TIME_NEVER else next_start

        while start is not None and start < stop:
            # A device measured winning per round keeps the rounds.
            span_now = span_ok and prop.span_gate()
            py_limit = None
            if span_now and self._py_work.any():
                # Python-side work pending (spawn tasks): spans may still
                # serve the stretch up to the earliest window that could
                # touch it.
                py_min = int(self._nt[self._py_work].min())
                ra = self.runahead.get()
                if start > py_min - ra:
                    span_now = False
                else:
                    py_limit = py_min - ra + 1
            if span_now:
                limit = stop if py_limit is None else min(stop, py_limit)
                use_dev = False
                if dev_span_on and py_limit is None:
                    if dev_mode in ("force", "on"):
                        use_dev = True
                    elif dev_ns_round is not None \
                            and cpp_ns_round is not None:
                        use_dev = dev_ns_round < cpp_ns_round
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
                        start = account_span(res)
                        continue
                    if res is None and runner.ineligible:
                        dev_span_on = False  # no device-span family fits
                    elif res is None and runner.last_transient:
                        # Out of the TCP family's domain for now
                        # (handshake/close): cap the C++ span below so
                        # the device is re-probed within a few windows.
                        dev_retry_soon = True
                    elif res is None:
                        # Abort: shrink the window batch, back off, and
                        # give up after repeated failures.
                        dev_span_K = max(dev_k_floor,
                                         dev_span_K // dev_k_shrink)
                        dev_aborts_row += 1
                        dev_probe_countdown = 16 * dev_aborts_row
                        if dev_aborts_row >= 3:
                            dev_span_on = False
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
                else:
                    if res[6]:
                        raise RuntimeError(
                            "engine span exported packets to an "
                            "object-path host, which this slice never "
                            "builds")
                    res = res[:6]
                    if res[0]:
                        per = (time.perf_counter_ns() - t0) / res[0]
                        cpp_ns_round = per if cpp_ns_round is None \
                            else 0.7 * cpp_ns_round + 0.3 * per
                        start = account_span(res)
                        continue
            window_end = min(start + self.runahead.get(), stop)
            prop.begin_round(start, window_end)
            self._run_hosts(window_end)
            inflight_min = prop.finish_round()
            summary.rounds += 1
            summary.busy_end_ns = window_end
            nxt = self._min_next_event()
            if inflight_min is not None and (nxt is None
                                             or inflight_min < nxt):
                nxt = inflight_min
            start = nxt
        summary.end_time_ns = min(start, stop) if start is not None \
            else stop
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
        self.plane.engine.advance_clocks(summary.end_time_ns)
        for h in self.hosts:
            for proc in h.processes.values():
                proc.close_all()
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
        return span_overlap_on(self.config.experimental.span_overlap,
                               self.device)

    def make_dev_span_runner(self):
        from shadow_tpu_torch.ops.phold_span import PholdSpanRunner
        runner = PholdSpanRunner(*self._span_runner_args(), tracing=True,
                                 device=self.device)
        runner.overlap = self._span_overlap_on()
        return runner

    def make_tcp_span_runner(self):
        from shadow_tpu_torch.ops.tcp_span import TcpSpanRunner
        runner = TcpSpanRunner(*self._span_runner_args(), tracing=True,
                               device=self.device)
        runner.dctcp_k = (self.config.experimental.dctcp_k_pkts,
                          self.config.experimental.dctcp_k_bytes)
        runner.overlap = self._span_overlap_on()
        return runner

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
        """The run summary's dispatch section (the reference's
        `metrics.wall.dispatch` entries the port has): the overlap mode,
        the per-round propagator's `propagate` block, and, per
        device-span family that was tried, its span counts, residency,
        the `overlap` block and its kernel launches."""
        out = {"span_overlap": self.config.experimental.span_overlap,
               "span_overlap_on": self._span_overlap_on(),
               "propagate": self.propagator.summary()}
        for family, r in (("phold", self._dev_span),
                          ("tcp", self._dev_span_tcp)):
            if r is not None:
                out[f"device_span_{family}"] = {
                    "spans": r.spans,
                    "rounds": r.rounds,
                    "micro_iters": r.micro_iters,
                    "aborts": r.aborts,
                    "ineligible": r.ineligible,
                    "transient_or_over_caps": r.over_caps,
                    "resident_hits": r.resident_hits,
                    "stale_drops": r.stale_drops,
                    "overlap": r.overlap_summary(),
                }
        if self._dev_span is not None:
            # The PHOLD family's kernel launches over every dispatch: span
            # launches, and the windows a kernel stepped.
            r = self._dev_span
            out["device_span_phold"].update(span_launches=r.spans_all,
                                            kernel_windows=r.windows_all)
        if self._dev_span_tcp is not None:
            # The TCP family's kernel launches over every dispatch: span
            # launches, and the windows a kernel stepped.
            r = self._dev_span_tcp
            out["device_span_tcp"].update(span_launches=r.spans_all,
                                          kernel_windows=r.windows_all)
        return out

    # ------------------------------------------------------------------
    # Outputs
    # ------------------------------------------------------------------

    def trace_lines(self) -> list[str]:
        lines = []
        for h in self.hosts:
            lines.extend(h.trace_lines())
        return lines


def run_simulation(config: ConfigOptions, device=None):
    """Build a Manager on `device` (default: the card), run it, and
    return (manager, summary)."""
    manager = Manager(config, device=device)
    summary = manager.run()
    return manager, summary
