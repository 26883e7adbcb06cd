"""Engine-resident hosts: the Python side of a host whose network plane,
apps and TCP state live in the C++ engine.

The port's counterpart of `shadow_tpu/host/host.py`, cut to what an
engine-resident host needs: its identity and RNG stream, a small
Python event heap for the spawn tasks, round execution that merges
that heap with the engine's events under the one total order
(time, kind, src, seq), counters folded in from the engine, and the
canonical trace lines, and the per-host drop-cause, mark-cause and
syscall-disposition counters the run outputs sum.
"""

from __future__ import annotations

import heapq

from shadow_tpu_torch.core.rng import HostRng
from shadow_tpu_torch.core.simtime import TIME_NEVER
from shadow_tpu_torch.trace.events import MARK_N, SC_N, TEL_N

# Event kinds: packets sort before local tasks at equal times.
KIND_PACKET = 0
KIND_LOCAL = 1


class Host:
    def __init__(self, host_id: int, name: str, ip: int, node_index: int,
                 seed: int, bw_down_bits: int, bw_up_bits: int):
        self.id = host_id
        self.name = name
        self.ip = ip
        self.node_index = node_index
        self.bw_down_bits = bw_down_bits
        self.bw_up_bits = bw_up_bits
        self.rng = HostRng(seed, host_id)
        self.tcp_cc = "reno"
        self.tcp_ecn = False
        # (time, kind, src, seq, task) entries; spawn tasks only.
        self.heap: list = []
        self._now = 0
        self._event_seq = 0
        self._next_pid = 1000
        self.processes: dict[int, object] = {}
        self.plane = None
        self.nsocks: dict[int, object] = {}  # engine token -> proxy
        self.counters = {"events": 0, "packets_sent": 0,
                         "packets_recv": 0, "packets_dropped": 0,
                         "syscalls": 0}
        self.syscall_counts: dict[str, int] = {}
        # Drop attribution: one TEL_* cause a drop (the engine's
        # HostPlane::drop_causes, merged below); `drop_unattributed`
        # counts drops without a cause, which the conservation check
        # rejects.
        self.drop_causes = [0] * TEL_N
        self.drop_unattributed = 0
        # ECN marks by this host's router queue, one MARK_* cause each.
        self.mark_causes = [0] * MARK_N
        # Syscall dispositions of Python-dispatched syscalls: none on an
        # engine-resident host (its apps dispatch C++-side).
        self.sc_disp = [0] * SC_N
        self._native_merged = (0, 0, 0, 0)
        self._native_causes_merged = (0,) * (TEL_N + 1)
        self._native_marks_merged = (0,) * MARK_N
        self._app_sys_merged: dict = {}
        # Shared per-host next-event snapshot and Python-work flags
        # (set by the Manager before the first round).
        self._nt_list = None
        self._py_work_arr = None

    def now(self) -> int:
        return self._now

    def next_event_seq(self) -> int:
        if self.plane is not None:
            # One shared counter with the engine's own draws.
            return self.plane.engine.next_event_seq(self.id)
        s = self._event_seq
        self._event_seq += 1
        return s

    def register_process(self, process) -> int:
        pid = self._next_pid
        self._next_pid += 1
        self.processes[pid] = process
        return pid

    def schedule_task_at(self, time: int, task) -> None:
        if time < self._now:
            raise ValueError(f"task {task!r} scheduled in the past")
        heapq.heappush(self.heap, (time, KIND_LOCAL, self.id,
                                   self.next_event_seq(), task))
        if self._py_work_arr is not None:
            self._py_work_arr[self.id] = True

    # -- round execution -------------------------------------------------

    def execute(self, until: int) -> None:
        """The engine runs whole batches of its own events in one C call,
        bounded by the Python heap's head key and the window end; a
        batch breaks whenever an engine event called back into Python,
        so the merged dispatch order is the reference's single heap."""
        heap = self.heap
        eng = self.plane.engine
        hid = self.id
        n_total = 0
        while True:
            if heap:
                lt, lk, lsrc, lseq = heap[0][:4]
            else:
                lt, lk, lsrc, lseq = until, 1, 0, 0
            n, last = eng.run_until(hid, lt, lk, lsrc, lseq, until)
            if n:
                n_total += n
                if last > self._now:
                    self._now = last
                continue  # a callback may have scheduled a task
            if not heap or heap[0][0] >= until:
                break
            t, _k, _s, _q, task = heapq.heappop(heap)
            self._now = t
            n_total += 1
            task(self)
        self.counters["events"] += n_total
        self._update_nt_slot()

    def next_event_time(self):
        t = self.heap[0][0] if self.heap else None
        d = self.plane.engine.peek_next(self.id)
        if d is not None and (t is None or d[0] < t):
            return d[0]
        return t

    def _update_nt_slot(self) -> None:
        if self._nt_list is None:
            return
        t = self.next_event_time()
        self._nt_list[self.id] = TIME_NEVER if t is None else t
        self._py_work_arr[self.id] = bool(self.heap)

    # -- counters and trace ----------------------------------------------

    def merge_native_counters(self) -> None:
        """Fold the engine's counters into self.counters (incremental)."""
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
        return [f"{time} {self.name} {text}" for time, _k, _s, _q, text
                in sorted(self.plane.engine.trace_entries(self.id))]
