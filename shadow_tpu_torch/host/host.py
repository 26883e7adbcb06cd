"""Host: one emulated Linux system, the port's copy of
`shadow_tpu/host/host.py` (without checkpoint state and fault flags:
ROADMAP A7c).

A host owns its private event queue, the deterministic per-host RNG
stream, its process table and its canonical packet trace.  It runs one
of two planes:

- the object path (`plane` None): the network devices are Python
  objects (lo/eth0 interfaces, the CoDel router, three bandwidth
  relays; built at first touch), the apps are Python coroutines
  (host/apps.py) and the sockets and TCP are host/socket_*.py and
  tcp/connection.py;
- an engine host: the C++ engine owns the inet plane, the apps, their
  TCP state and the event/packet seq counters.  Round execution merges
  the Python heap (spawn tasks, and object-path packets in mixed sims)
  with the engine's events under the one total order
  (time, kind, src, seq).

A host is single-threaded: only cross-host packet pushes touch it from
outside, through its locked inbox.
"""

from __future__ import annotations

import threading
from collections import deque

from shadow_tpu_torch.core.event import (Event, EventQueue, KIND_LOCAL,
                                         KIND_PACKET, TaskRef)
from shadow_tpu_torch.core.rng import HostRng
from shadow_tpu_torch.core.simtime import TIME_NEVER
from shadow_tpu_torch.net.graph import LOCALHOST_IP, format_ip
from shadow_tpu_torch.net.interface import NetworkInterface
from shadow_tpu_torch.net.packet import PROTO_TCP
from shadow_tpu_torch.net.relay import Relay
from shadow_tpu_torch.net.router import Router
from shadow_tpu_torch.net.token_bucket import TokenBucket
from shadow_tpu_torch.trace.events import (MARK_N, SC_N, TEL_BY_REASON,
                                           TEL_N)

# Canonical trace kinds, in tiebreak order: a packet sent and dropped at
# the same instant sorts SND before DRP.
TRACE_SND = 0
TRACE_DRP = 1
TRACE_RCV = 2
_TRACE_NAMES = {TRACE_SND: "SND", TRACE_DRP: "DRP", TRACE_RCV: "RCV"}


class Host:
    # Per-host TCP stack options (`tcp: {cc, ecn}`; the Manager sets
    # them at build).
    tcp_cc = "reno"
    tcp_ecn = False
    # DCTCP marking threshold (experimental.dctcp_k_pkts/_bytes; the
    # object path's router marking law reads them).
    dctcp_k_pkts = 20
    dctcp_k_bytes = 30_000
    # Failure containment (svc/containment.py): set by the Manager on
    # hosts carrying managed processes, None everywhere else.  The
    # spawn stagger is its wall-only companion knob.
    containment = None
    spawn_stagger_ns = 0
    # The syscall observatory's wall profile and record channel (ROADMAP
    # A7b-2): the managed path's seams read them, None until then.
    sc_wall = None
    sc_log = None

    def __init__(self, host_id: int, name: str, ip: int, node_index: int,
                 seed: int, bw_down_bits: int, bw_up_bits: int,
                 qdisc: str = "fifo", mtu: int = 1500):
        self.id = host_id
        self.name = name
        self.ip = ip
        self.bw_down_bits = bw_down_bits
        self.bw_up_bits = bw_up_bits
        self.node_index = node_index
        self.rng = HostRng(seed, host_id)
        self.queue = EventQueue()
        # Cross-host deliveries land in a locked inbox, not the heap: the
        # owner pops its heap without a lock, and conservative windows
        # guarantee inbox events are never needed mid-round (their time
        # is >= the window end).  Drained at execute().
        self._inbox: deque = deque()
        self._inbox_lock = threading.Lock()
        self._inbox_min = TIME_NEVER  # earliest undrained delivery
        self._now = 0
        self._event_seq = 0
        self._packet_seq = 0
        self.processes: dict[int, object] = {}
        self._next_pid = 1000
        # The host CPU model (host/cpu.py): None unless
        # host_cpu_threshold is configured.
        self.cpu = None
        self.cpu_event_cost_ns = 0
        # The per-host output directory (managed processes' stdout and
        # stderr files); set by the Manager.
        self.data_path = None
        # AF_UNIX name table: fs paths and '@'-prefixed abstract names
        # (paths never touch the real file system).
        self.unix_ns: dict[str, object] = {}
        # The managed path's unblocked-syscall latency model and native
        # preemption (0 = off); the Manager sets them from the config.
        self.syscall_latency_ns = 1_000
        self.max_unapplied_ns = 20_000
        self.preempt_native_ns = 0
        self.preempt_sim_ns = 0
        # Native file I/O billing: simulated ns per KiB moved by
        # DO_NATIVE byte-I/O syscalls (0 = not modeled).
        self.native_io_ns_per_kib = 0
        # Network plane, built at first touch of any of its six objects
        # (__getattr__): engine hosts never use them.
        self._net_qdisc = qdisc
        self._net_mtu = mtu
        # Set by the Manager before the first round.
        self._send_packet_fn = None
        self.dns = None
        self.syscall_handler = None
        self.syscall_handler_native = None
        # The engine (native/plane.py) when attached: it owns this host's
        # inet plane and the event/packet seq counters.  None = the
        # object path.
        self.plane = None
        self._nsocks: dict[int, object] = {}  # engine token -> proxy
        self._native_merged = (0, 0, 0, 0)    # engine counters merged
        self._app_sys_merged: dict = {}       # engine-app syscalls merged
        # The Manager's shared next-event snapshot (one slot a host) and
        # Python-work flags: each host writes its own slot at the end of
        # execute(); cross-host deliveries lower the destination's slot
        # under the inbox lock.
        self._nt_list = None
        self._py_work_arr = None
        # A managed-process host's Python-work flag stays True for the
        # whole run: its packets always need Python-side servicing, and
        # the engine's span loop relies on the flag to stop before any
        # window that would touch it (the quiescence gate).
        self.py_pinned = False
        # Canonical packet trace: (time, kind, src_host, pkt_seq, text).
        self.trace_entries: list = []
        self.tracing_enabled = True
        self.counters = {"events": 0, "packets_sent": 0, "packets_recv": 0,
                         "packets_dropped": 0, "syscalls": 0}
        # Drop attribution: every trace_drop maps its reason to one TEL_*
        # cause (the engine's HostPlane::drop_causes twin), so the wire
        # causes sum to counters["packets_dropped"].
        self.drop_causes = [0] * TEL_N
        self.drop_unattributed = 0
        self._native_causes_merged = (0,) * (TEL_N + 1)
        # ECN marks by this host's router queue, one MARK_* cause each.
        self.mark_causes = [0] * MARK_N
        self._native_marks_merged = (0,) * MARK_N
        # FCT_REC field tuples of connections torn down before the
        # fabric artifact was written (the engine's fct_log twin).
        self.fct_log: list = []
        self.syscall_counts: dict[str, int] = {}
        # Dispositions of Python-dispatched syscalls, one SC_* code each.
        self.sc_disp = [0] * SC_N
        # use_perf_timers: cumulative wall ns spent executing this
        # host's events (the Manager fills it).
        self.perf_exec_ns = 0

    def count_syscall(self, name: str) -> None:
        self.counters["syscalls"] += 1
        counts = self.syscall_counts
        counts[name] = counts.get(name, 0) + 1

    # ------------------------------------------------------------------
    # Clock and scheduling
    # ------------------------------------------------------------------

    def now(self) -> int:
        return self._now

    def next_event_seq(self) -> int:
        if self.plane is not None:
            # One shared counter with the engine's own draws.
            return self.plane.engine.next_event_seq(self.id)
        s = self._event_seq
        self._event_seq += 1
        return s

    def next_packet_seq(self) -> int:
        if self.plane is not None:
            return self.plane.engine.next_packet_seq(self.id)
        s = self._packet_seq
        self._packet_seq += 1
        return s

    _NET_ATTRS = frozenset({"lo", "eth0", "router", "relay_loopback",
                            "relay_inet_out", "relay_inet_in"})

    def __getattr__(self, name):
        # Reached only while the attribute is missing, i.e. before the
        # network plane's first build.
        if name in Host._NET_ATTRS:
            self._build_net_plane()
            return object.__getattribute__(self, name)
        raise AttributeError(name)

    def net_built(self) -> bool:
        return "lo" in self.__dict__

    def _build_net_plane(self) -> None:
        qdisc = self._net_qdisc
        mtu = self._net_mtu
        self.lo = NetworkInterface(LOCALHOST_IP, "lo", qdisc)
        self.eth0 = NetworkInterface(self.ip, "eth0", qdisc)
        self.router = Router()
        self.relay_loopback = Relay(
            "lo", lambda host, now: self.lo.pop_packet(host, now), None)
        self.relay_inet_out = Relay(
            "inet-out", lambda host, now: self.eth0.pop_packet(host, now),
            TokenBucket.for_bandwidth(self.bw_up_bits, mtu))
        self.relay_inet_in = Relay(
            "inet-in",
            lambda host, now: self.router.pop_inbound(host, now),
            TokenBucket.for_bandwidth(self.bw_down_bits, mtu))

    def schedule_task_at(self, time: int, task: TaskRef) -> None:
        assert time >= self._now, f"task {task} scheduled in the past"
        self.queue.push(Event(time, KIND_LOCAL, self.id,
                              self.next_event_seq(), task))
        if self._py_work_arr is not None:
            self._py_work_arr[self.id] = True

    # ------------------------------------------------------------------
    # Round execution
    # ------------------------------------------------------------------

    def drain_inbox(self) -> None:
        """Move cross-host deliveries into the heap (owner thread only)."""
        if not self._inbox:
            return
        with self._inbox_lock:
            events, self._inbox = self._inbox, deque()
            self._inbox_min = TIME_NEVER
        for ev in events:
            self.queue.push(ev)

    def execute(self, until: int) -> None:
        if self.plane is not None:
            self._execute_native(until)
            return
        self.drain_inbox()
        q = self.queue
        cpu = self.cpu
        while True:
            t = q.peek_time()
            if t is None or t >= until:
                break
            ev = q.pop()
            if cpu is not None:
                # CPU-model push-back: while the modeled CPU is
                # saturated, events slip forward.
                cpu.update_time(ev.time)
                d = cpu.delay()
                if d > 0:
                    ev.time += d
                    q.push(ev)
                    continue
            self._now = ev.time
            self.counters["events"] += 1
            if ev.kind == KIND_PACKET:
                self.router.route_incoming_packet(self, ev.data)
            else:
                ev.data.execute(self)
            if cpu is not None and self.cpu_event_cost_ns:
                # A fixed modeled cost per event keeps runs bit-identical
                # while a flooded host's CPU saturates.
                cpu.add_delay(self.cpu_event_cost_ns)
        self._update_nt_slot()

    def _execute_native(self, until: int) -> None:
        """Round execution with the engine: it runs whole batches of its
        own events in one C call, bounded by the Python heap's head key
        and the window end.  A batch breaks whenever an engine event
        called back into Python (a status change may have scheduled a
        task that now precedes the engine's next event), so the merged
        dispatch order is the object path's single heap."""
        self.drain_inbox()
        q = self.queue
        heap = q._heap
        eng = self.plane.engine
        hid = self.id
        run_until = eng.run_until
        n_total = 0
        while True:
            if heap:
                lt, lk, lsrc, lseq = heap[0][:4]
            else:
                lt, lk, lsrc, lseq = until, 1, 0, 0
            n, last = run_until(hid, lt, lk, lsrc, lseq, until)
            if n:
                n_total += n
                if last > self._now:
                    self._now = last
                continue  # a callback may have scheduled a task
            if not heap or heap[0][0] >= until:
                break
            ev = q.pop()
            self._now = ev.time
            n_total += 1
            data = ev.data
            if ev.kind == KIND_PACKET:
                # Mixed planes only: a packet object from an object-path
                # host (engine-origin packets ride the engine inbox).
                if type(data) is int:
                    eng.deliver(hid, data, ev.time)
                else:
                    self.router.route_incoming_packet(self, data)
            else:
                data.execute(self)
        self.counters["events"] += n_total
        self._update_nt_slot()

    def _update_nt_slot(self) -> None:
        if self._nt_list is not None:
            t = self.next_event_time()
            if t is None:
                t = TIME_NEVER
            # Under the threaded schedulers another host's execute can
            # deliver into this inbox concurrently: folding the locked
            # inbox minimum in keeps the slot from going stale-high.
            with self._inbox_lock:
                if self._inbox_min < t:
                    t = self._inbox_min
                self._nt_list[self.id] = t
                if self._py_work_arr is not None:
                    # Under the same lock as a deliverer's True store.
                    self._py_work_arr[self.id] = \
                        bool(self.queue._heap) or bool(self._inbox) \
                        or self.py_pinned

    def next_event_time(self):
        t = self.queue.peek_time()
        if self.plane is not None:
            d = self.plane.engine.peek_next(self.id)
            if d is not None and (t is None or d[0] < t):
                return d[0]
        return t

    # ------------------------------------------------------------------
    # Packet plane wiring
    # ------------------------------------------------------------------

    def get_packet_device(self, dst_ip: int):
        """Where does a packet addressed to `dst_ip` go next?"""
        if dst_ip == LOCALHOST_IP:
            return self.lo
        if dst_ip == self.eth0.ip:
            return self.eth0
        return self.router

    def notify_router_has_packets(self) -> None:
        self.relay_inet_in.notify(self)

    def notify_interface_has_packets(self, iface) -> None:
        if iface is self.lo:
            self.relay_loopback.notify(self)
        else:
            self.relay_inet_out.notify(self)

    def send_packet(self, packet) -> None:
        """Cross-host exit point: the propagator owns propagation."""
        self.counters["packets_sent"] += 1
        self._send_packet_fn(self, packet)

    def deliver_packet_event(self, event) -> None:
        """Cross-host entry point (any thread): enqueue into the inbox.
        The event's time is >= the current window end, so the owner
        cannot need it before its next drain."""
        with self._inbox_lock:
            self._inbox.append(event)
            if event.time < self._inbox_min:
                self._inbox_min = event.time
            nt = self._nt_list
            if nt is not None and event.time < nt[self.id]:
                nt[self.id] = event.time
            if self._py_work_arr is not None:
                self._py_work_arr[self.id] = True

    # ------------------------------------------------------------------
    # Processes
    # ------------------------------------------------------------------

    def register_process(self, process) -> int:
        pid = self._next_pid
        self._next_pid += 1
        self.processes[pid] = process
        return pid

    # ------------------------------------------------------------------
    # Canonical packet trace
    # ------------------------------------------------------------------

    def trace_packet(self, kind: int, packet, extra: str = "",
                     at_time: int | None = None) -> None:
        if not self.tracing_enabled:
            return
        proto = "tcp" if packet.protocol == PROTO_TCP else "udp"
        text = (f"{_TRACE_NAMES[kind]} {proto} "
                f"{format_ip(packet.src_ip)}:{packet.src_port}>"
                f"{format_ip(packet.dst_ip)}:{packet.dst_port} "
                f"len={len(packet.payload)} "
                f"id={packet.src_host_id}.{packet.seq}"
                f"{' ' + extra if extra else ''}")
        t = self._now if at_time is None else at_time
        self.trace_entries.append(
            (t, kind, packet.src_host_id, packet.seq, text))

    def trace_drop(self, packet, reason: str,
                   at_time: int | None = None) -> None:
        """`at_time` lets the batched propagator record drops at the send
        instant after the round has moved on; the canonical sort makes
        the trace identical to the scalar path's."""
        self.counters["packets_dropped"] += 1
        cause = TEL_BY_REASON.get(reason)
        if cause is not None:
            self.drop_causes[cause] += 1
        else:
            self.drop_unattributed += 1
        self.trace_packet(TRACE_DRP, packet, reason, at_time=at_time)

    def count_mark(self, cause: int) -> None:
        """One CE mark by this host's router queue, attributed to the
        MARK_* threshold leg that fired."""
        self.mark_causes[cause] += 1

    def trace_snd(self, packet) -> None:
        self.trace_packet(TRACE_SND, packet)

    def trace_rcv(self, packet) -> None:
        self.counters["packets_recv"] += 1
        self.trace_packet(TRACE_RCV, packet)

    def merge_native_counters(self) -> None:
        """Fold the engine's counters into self.counters (incremental:
        safe to call from heartbeats and the final stats)."""
        if self.plane is None:
            return
        eng = self.plane.engine
        sent, recv, dropped, ev = eng.counters(self.id)
        ps, pr, pd, pe = self._native_merged
        self.counters["packets_sent"] += sent - ps
        self.counters["packets_recv"] += recv - pr
        self.counters["packets_dropped"] += dropped - pd
        self.counters["events"] += ev - pe
        self._native_merged = (sent, recv, dropped, ev)
        # Drop causes by the same delta discipline (the tuple carries
        # TEL_N causes and the unattributed tail), then the marks.
        causes = eng.drop_causes(self.id)
        prev = self._native_causes_merged
        for i in range(TEL_N):
            self.drop_causes[i] += causes[i] - prev[i]
        self.drop_unattributed += causes[TEL_N] - prev[TEL_N]
        self._native_causes_merged = tuple(causes)
        marks = eng.mark_causes(self.id)
        prev = self._native_marks_merged
        for i in range(MARK_N):
            self.mark_causes[i] += marks[i] - prev[i]
        self._native_marks_merged = tuple(marks)
        app_sys = eng.app_syscalls(self.id)
        if app_sys:
            prev = self._app_sys_merged
            total = 0
            for name, n in app_sys.items():
                delta = n - prev.get(name, 0)
                if delta:
                    self.syscall_counts[name] = \
                        self.syscall_counts.get(name, 0) + delta
                    total += delta
            self.counters["syscalls"] += total
            self._app_sys_merged = dict(app_sys)

    def trace_lines(self) -> list[str]:
        """Canonically sorted, scheduler-independent trace lines."""
        entries = self.trace_entries
        if self.plane is not None:
            entries = entries + self.plane.engine.trace_entries(self.id)
        return [f"{time} {self.name} {text}"
                for time, _k, _s, _q, text in sorted(entries)]
