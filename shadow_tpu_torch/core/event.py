"""Events, tasks, and the per-host event queue.

Mirrors the reference's deterministic total order on events
(src/main/core/work/event.rs:10-63): events sort by

    (time, packet-before-local, source host id, per-source sequence number)

so that two runs — and two *schedulers* (scalar CPU vs batched TPU) —
dispatch identical event interleavings. The per-source sequence number is
assigned by the sending host at push time, which keeps ordering decisions
local (no global atomic), exactly the property that lets hosts run in
parallel within a round.

The queue itself is a binary heap (src/main/core/work/event_queue.rs:10-54)
with the same monotonic-pop assertion the reference carries.

The port's copy of `shadow_tpu/core/event.py`.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Optional

# Event kinds: packets sort before local tasks at equal times
# (event.rs:41-53 gives packets priority so cross-host interleavings are
# independent of which host pushed first).
KIND_PACKET = 0
KIND_LOCAL = 1


class TaskRef:
    """A named host-local callback (ref: src/main/core/work/task.rs:12-44)."""

    __slots__ = ("fn", "name", "args")

    def __init__(self, name: str, fn: Callable, *args):
        self.fn = fn
        self.name = name
        self.args = args

    def execute(self, host) -> None:
        self.fn(host, *self.args)

    def __repr__(self) -> str:
        return f"TaskRef({self.name})"


class Event:
    __slots__ = ("time", "kind", "src_host_id", "seq", "data")

    def __init__(self, time: int, kind: int, src_host_id: int, seq: int, data: Any):
        self.time = time
        self.kind = kind
        self.src_host_id = src_host_id
        self.seq = seq
        self.data = data  # Packet for KIND_PACKET, TaskRef for KIND_LOCAL

    def sort_key(self):
        return (self.time, self.kind, self.src_host_id, self.seq)

    def __lt__(self, other: "Event") -> bool:
        return self.sort_key() < other.sort_key()

    def __repr__(self) -> str:
        k = "pkt" if self.kind == KIND_PACKET else "task"
        return f"Event(t={self.time}, {k}, src={self.src_host_id}, seq={self.seq})"


class EventQueue:
    """Min-heap of events for one host.

    Only the owning host pops; cross-host pushes are serialized by the
    scheduler (CPU: a mutex per queue as in worker.rs:597-607; TPU: the
    batched exchange delivers all pushes between rounds, so no lock is
    needed at all — a structural win of the round-synchronous design).
    """

    __slots__ = ("_heap", "_last_popped_time")

    def __init__(self):
        # Heap entries are (time, kind, src_host_id, seq, event) tuples:
        # heapq then compares native ints instead of calling
        # Event.__lt__ (millions of Python-level calls per run).  The
        # (src_host_id, seq) pair is unique per source, so comparison
        # never falls through to the Event object itself.
        self._heap: list[tuple] = []
        self._last_popped_time = 0

    def push(self, event: Event) -> None:
        heapq.heappush(self._heap, (event.time, event.kind,
                                    event.src_host_id, event.seq, event))

    def peek_time(self) -> Optional[int]:
        return self._heap[0][0] if self._heap else None

    def pop(self) -> Optional[Event]:
        if not self._heap:
            return None
        ev = heapq.heappop(self._heap)[4]
        # Determinism guard (event_queue.rs:33): time must never go backwards.
        assert ev.time >= self._last_popped_time, (
            f"event time moved backwards: {ev} after t={self._last_popped_time}")
        self._last_popped_time = ev.time
        return ev

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
