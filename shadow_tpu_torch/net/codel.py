"""CoDel active queue management (RFC 8289) for the per-host router.

Own implementation of the RFC algorithm with the Linux/reference
parameters (src/main/network/router/codel_queue.rs: TARGET 5ms,
INTERVAL 100ms, hard cap 1000 packets). All arithmetic is integer
nanoseconds; the control law's inverse-sqrt is computed with integer
math so the CPU and any future vectorized implementation agree bit-forr-bit.

The port's copy of `shadow_tpu/net/codel.py`.
"""

from __future__ import annotations

from collections import deque
from math import isqrt

from shadow_tpu_torch.net import packet as pkt
from shadow_tpu_torch.trace.events import MARK_THRESH_BYTES, MARK_THRESH_PKTS

TARGET_NS = 5_000_000       # 5 ms acceptable standing delay
INTERVAL_NS = 100_000_000   # 100 ms sliding window
HARD_LIMIT = 1000           # max queued packets (codel_queue.rs limit)

# DCTCP instantaneous marking threshold K (RFC 8257 4.1; netplane.cpp
# CoDelN twins): an ECT(0) packet arriving while the queue already
# holds >= K packets — or >= K bytes — is marked CE instead of waiting
# for the CoDel control law to drop it.  Both legs are checked against
# the queue state BEFORE this packet enqueues, packets first (the
# attributed MARK_* cause records which leg fired).  ~20 full-MTU
# packets ~= 30 KB, so the two legs agree for bulk traffic and the
# bytes leg catches many-small-segment fan-in.
DCTCP_K_PKTS = 20
DCTCP_K_BYTES = 30_000


def _control_time(first_above_time: int, count: int) -> int:
    """next drop time = t + INTERVAL / sqrt(count), in integer ns."""
    # isqrt on count scaled by 2**32 keeps precision without floats.
    return first_above_time + (INTERVAL_NS << 16) // isqrt(count << 32)


class CoDelQueue:
    __slots__ = ("_q", "_bytes", "_dropping", "_count", "_last_count",
                 "_first_above_time", "_drop_next", "dropped_count",
                 "enqueued_count", "enqueued_bytes", "dropped_bytes",
                 "peak_depth", "marked_count")

    def __init__(self):
        self._q: deque = deque()  # (packet, enqueue_time_ns)
        self._bytes = 0
        self._dropping = False
        self._count = 0
        self._last_count = 0
        self._first_above_time = 0
        self._drop_next = 0
        self.dropped_count = 0
        # Fabric-observatory counters (netplane.cpp CoDelN twins; the
        # conservation invariant is enqueued == forwarded + dropped +
        # still-queued, in both packets and bytes).  `enqueued` counts
        # push ATTEMPTS — hard-limit refusals included — so the
        # invariant holds with the refusal on the dropped side.
        self.enqueued_count = 0
        self.enqueued_bytes = 0
        self.dropped_bytes = 0
        self.peak_depth = 0
        # ECN marks: CE rewrites by the DCTCP-K instantaneous
        # threshold law in push() — a marked packet still FORWARDS, so
        # it sits on the delivered side of the conservation invariant
        # (the fabric channel's qmarks series samples this counter).
        self.marked_count = 0

    def __len__(self):
        return len(self._q)

    def peek_entry(self):
        """Head (packet, enqueue_time_ns) pair or None — the fabric
        sampler's head-of-queue sojourn reading."""
        return self._q[0] if self._q else None

    def _drop(self, packet, on_drop) -> None:
        packet.record(pkt.ST_ROUTER_DROPPED)
        self.dropped_count += 1
        self.dropped_bytes += packet.total_size()
        if on_drop is not None:
            on_drop(packet)

    def push(self, packet, now: int, on_drop=None, on_mark=None,
             k_pkts: int = DCTCP_K_PKTS,
             k_bytes: int = DCTCP_K_BYTES) -> bool:
        """Returns False (and drops) only at the hard limit.  An
        ECN-capable (ECT) packet that clears the hard limit but meets
        the DCTCP-K instantaneous threshold is marked CE and enqueued
        normally; `on_mark(cause)` attributes the mark to the MARK_*
        leg that fired (trace/events.py) — cause-only, so the router
        can pass the host's bound counter method directly.  K is a
        parameter (experimental.dctcp_k_pkts/_bytes — the sweep
        subsystem's congestion axis); the module constants stay the
        twinned defaults."""
        self.enqueued_count += 1
        self.enqueued_bytes += packet.total_size()
        if len(self._q) >= HARD_LIMIT:
            self._drop(packet, on_drop)
            return False
        if packet.ecn == pkt.ECN_ECT0:
            cause = -1
            if len(self._q) >= k_pkts:
                cause = MARK_THRESH_PKTS
            elif self._bytes >= k_bytes:
                cause = MARK_THRESH_BYTES
            if cause >= 0:
                packet.ecn = pkt.ECN_CE
                self.marked_count += 1
                if on_mark is not None:
                    on_mark(cause)
        self._q.append((packet, now))
        self._bytes += packet.total_size()
        if len(self._q) > self.peak_depth:
            self.peak_depth = len(self._q)
        packet.record(pkt.ST_ROUTER_ENQUEUED)
        return True

    def _dequeue_raw(self, now: int):
        """Pop one packet; returns (packet, ok_to_stay_in_drop_state)."""
        if not self._q:
            self._first_above_time = 0
            return None, False
        packet, enq_time = self._q.popleft()
        self._bytes -= packet.total_size()
        sojourn = now - enq_time
        if sojourn < TARGET_NS or self._bytes <= pkt.MTU:
            self._first_above_time = 0
            return packet, False
        if self._first_above_time == 0:
            self._first_above_time = now + INTERVAL_NS
            return packet, False
        return packet, now >= self._first_above_time

    def pop(self, now: int, on_drop=None):
        """CoDel dequeue: may drop packets to signal congestion."""
        packet, ok_to_drop = self._dequeue_raw(now)
        if packet is None:
            self._dropping = False
            return None
        if self._dropping:
            if not ok_to_drop:
                self._dropping = False
            else:
                while now >= self._drop_next and self._dropping:
                    self._drop(packet, on_drop)
                    self._count += 1
                    packet, ok_to_drop = self._dequeue_raw(now)
                    if packet is None:
                        self._dropping = False
                        return None
                    if not ok_to_drop:
                        self._dropping = False
                    else:
                        self._drop_next = _control_time(self._drop_next,
                                                        self._count)
        elif ok_to_drop and (now - self._drop_next < INTERVAL_NS or
                             now - self._first_above_time >= INTERVAL_NS):
            self._drop(packet, on_drop)
            packet, _ = self._dequeue_raw(now)
            if packet is None:
                self._dropping = False
                return None
            self._dropping = True
            # Reuse drop frequency from the last dropping interval if we
            # re-entered quickly (RFC 8289 sec. 4.3).
            if now - self._drop_next < INTERVAL_NS:
                self._count = self._count - self._last_count if self._count > 2 else 1
            else:
                self._count = 1
            self._last_count = self._count
            self._drop_next = _control_time(now, self._count)
        return packet

    def peek(self):
        return self._q[0][0] if self._q else None
