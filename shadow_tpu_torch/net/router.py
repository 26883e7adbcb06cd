"""Per-host router (ref: src/main/network/router/mod.rs).

Two roles, like the reference:
- *inbound*: packets arriving from the simulated internet are queued in a
  CoDel AQM until the host's download-bandwidth relay forwards them to the
  interface;
- *outbound*: pushing a packet to the router hands it to the cross-host
  propagation backend (the scheduler's `send_packet`), i.e. the router IS
  the host's porthole to the batched TPU path.

The port's copy of `shadow_tpu/net/router.py`.
"""

from __future__ import annotations

from shadow_tpu_torch.net import packet as pkt
from shadow_tpu_torch.net.codel import CoDelQueue


class Router:
    __slots__ = ("_inbound",)

    def __init__(self):
        self._inbound = CoDelQueue()

    # --- inbound side (from the network, toward the host) ---

    def route_incoming_packet(self, host, packet) -> None:
        """Called by the scheduler when a cross-host packet arrives at this
        host (Host::execute packet branch, host.rs:783-786)."""
        if self._inbound.push(packet, host.now(),
                              lambda p: host.trace_drop(p, "rtr-limit"),
                              host.count_mark,
                              k_pkts=host.dctcp_k_pkts,
                              k_bytes=host.dctcp_k_bytes):
            host.notify_router_has_packets()

    def pop_inbound(self, host, now: int):
        return self._inbound.pop(now, lambda p: host.trace_drop(p, "codel"))

    def has_inbound(self) -> bool:
        return len(self._inbound) > 0

    @property
    def inbound_dropped(self) -> int:
        return self._inbound.dropped_count

    # --- outbound side (from the host, toward the network) ---

    def route_outgoing_packet(self, host, packet) -> None:
        packet.record(pkt.ST_SENT_TO_ROUTER)
        host.send_packet(packet)

    # PacketDevice interface: pushing *to* the router means "toward the
    # internet" (mod.rs:16-20).
    push = route_outgoing_packet
