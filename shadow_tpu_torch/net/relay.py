"""Bandwidth relays (ref: src/main/network/relay/mod.rs:51-318).

A relay moves packets from a source queue to their destination device at a
limited rate (token bucket). Three instances per host: inet-out (upload),
inet-in (download), loopback (unlimited). When the bucket runs dry the
relay schedules its own wakeup task at the next refill instant and
resumes — the reference's self-rescheduling forwarding loop
(relay/mod.rs:201-273).

The port's copy of `shadow_tpu/net/relay.py`.
"""

from __future__ import annotations

from typing import Optional

from shadow_tpu_torch.core.event import TaskRef
from shadow_tpu_torch.net import packet as pkt
from shadow_tpu_torch.net.token_bucket import TokenBucket

# Relay state machine (relay/mod.rs RelayState)
_IDLE = 0
_PENDING = 1


class Relay:
    __slots__ = ("name", "_bucket", "_state", "_pending_packet",
                 "_pop_fn", "stalls", "forwarded_pkts",
                 "forwarded_bytes")

    def __init__(self, name: str, pop_fn, bucket: Optional[TokenBucket]):
        """`pop_fn(host, now)` pops the next packet from the source device;
        bucket=None means unlimited (loopback)."""
        self.name = name
        self._bucket = bucket
        self._state = _IDLE
        self._pending_packet = None  # popped but not yet conforming
        self._pop_fn = pop_fn
        # Fabric-observatory counters (netplane.cpp RelayN twins):
        # packets parked waiting for a bucket refill (the "refill
        # stall" series FB_REC samples), and packets/bytes actually
        # forwarded — the inet-in relay's forwarded counters are the
        # CoDel queue's "delivered" side of the byte-conservation
        # invariant.
        self.stalls = 0
        self.forwarded_pkts = 0
        self.forwarded_bytes = 0

    def notify(self, host) -> None:
        """Source device has packets; start forwarding unless a wakeup is
        already scheduled (in which case that wakeup will drain us)."""
        if self._state == _PENDING:
            return
        self._forward_until_blocked(host)

    def _wakeup(self, host) -> None:
        # Bound-method TaskRef target: executes as self._wakeup(host).
        self._state = _IDLE
        self._forward_until_blocked(host)

    def _forward_until_blocked(self, host) -> None:
        now = host.now()
        while True:
            packet = self._pending_packet
            self._pending_packet = None
            if packet is None:
                packet = self._pop_fn(host, now)
            if packet is None:
                return
            if self._bucket is not None:
                ok, next_refill = self._bucket.try_remove(
                    packet.total_size(), now)
                if not ok:
                    # Park the packet and self-reschedule at refill time.
                    self.stalls += 1
                    packet.record(pkt.ST_RELAY_CACHED)
                    self._pending_packet = packet
                    self._state = _PENDING
                    assert next_refill > now
                    host.schedule_task_at(
                        next_refill,
                        TaskRef(f"relay-{self.name}", self._wakeup))
                    return
            packet.record(pkt.ST_RELAY_FORWARDED)
            self.forwarded_pkts += 1
            self.forwarded_bytes += packet.total_size()
            dst = host.get_packet_device(packet.dst_ip)
            dst.push(host, packet)
