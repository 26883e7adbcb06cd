"""Packets.

Slimmed, SoA-friendly analog of the reference's refcounted packet
(src/main/network/packet.rs:96-460). A packet is a plain slotted object on
the CPU path; the TPU path never sees Python packets — per-round batches
are decomposed into parallel int arrays (src_host, seq, src/dst node,
size) in ops/propagate.py, and only metadata rides to the device (payload
bytes stay host-side; the device computes *scheduling*, not contents).

Identity: (src_host_id, seq) with seq from a per-host monotonic counter —
the RNG key for loss decisions and the determinism tiebreak, assigned at
send time exactly once.

Status breadcrumbs (packet.rs:16-41) are recorded only when tracing is
enabled; they exist for determinism-visible lifecycle debugging.

The port's copy of `shadow_tpu/net/packet.py`.
"""

from __future__ import annotations

from typing import Optional

PROTO_TCP = 6
PROTO_UDP = 17

MTU = 1500  # bytes, fixed like the reference (interface.rs)
IPV4_HEADER_SIZE = 20
UDP_HEADER_SIZE = 8
TCP_HEADER_SIZE = 20

# IP-header ECN codepoints (RFC 3168 sec. 5; netplane.cpp twins).
# Only the two values the stack uses are modeled: a sender stamps
# ECT(0) on ECN-capable data segments, a congested queue rewrites it
# to CE instead of dropping.  Not-ECT is the zero default.
ECN_ECT0 = 2
ECN_CE = 3

# Lifecycle breadcrumbs (subset of packet.rs PacketStatus).
ST_CREATED = "snd_created"
ST_SENT_TO_ROUTER = "snd_to_router"
ST_INET_DROPPED = "inet_dropped"
ST_RELAY_CACHED = "relay_cached"
ST_RELAY_FORWARDED = "relay_forwarded"
ST_ROUTER_ENQUEUED = "rtr_enqueued"
ST_ROUTER_DROPPED = "rtr_dropped"
ST_RCV_INTERFACE = "rcv_interface"
ST_RCV_DELIVERED = "rcv_delivered"


class TcpFlags:
    SYN = 0x02
    ACK = 0x10
    FIN = 0x01
    RST = 0x04
    PSH = 0x08
    URG = 0x20
    # RFC 3168 ECN bits: ECE echoes congestion back to the sender,
    # CWR acknowledges the echo (netplane.cpp F_ECE/F_CWR twins).
    ECE = 0x40
    CWR = 0x80


class TcpHeader:
    __slots__ = ("seq", "ack", "flags", "window", "window_scale", "mss",
                 "sack_blocks", "timestamp", "timestamp_echo")

    def __init__(self, seq=0, ack=0, flags=0, window=0, window_scale=None,
                 mss=None, sack_blocks=(), timestamp=None, timestamp_echo=None):
        self.seq = seq
        self.ack = ack
        self.flags = flags
        self.window = window
        self.window_scale = window_scale  # SYN option
        self.mss = mss                    # SYN option
        self.sack_blocks = sack_blocks
        self.timestamp = timestamp
        self.timestamp_echo = timestamp_echo

    def __repr__(self):
        names = [n for n, bit in (("SYN", TcpFlags.SYN), ("ACK", TcpFlags.ACK),
                                  ("FIN", TcpFlags.FIN), ("RST", TcpFlags.RST),
                                  ("PSH", TcpFlags.PSH)) if self.flags & bit]
        return (f"TcpHeader({'|'.join(names) or '.'} seq={self.seq} "
                f"ack={self.ack} win={self.window})")


_trace_enabled = False


def set_status_tracing(enabled: bool) -> None:
    global _trace_enabled
    _trace_enabled = enabled


class Packet:
    __slots__ = ("src_host_id", "seq", "protocol", "src_ip", "src_port",
                 "dst_ip", "dst_port", "payload", "tcp", "priority",
                 "statuses", "arrival_time", "ecn", "_total_size")

    def __init__(self, src_host_id: int, seq: int, protocol: int,
                 src_ip: int, src_port: int, dst_ip: int, dst_port: int,
                 payload: bytes = b"", tcp: Optional[TcpHeader] = None):
        self.src_host_id = src_host_id
        self.seq = seq
        self.protocol = protocol
        self.src_ip = src_ip
        self.src_port = src_port
        self.dst_ip = dst_ip
        self.dst_port = dst_port
        self.payload = payload
        self.tcp = tcp
        self.priority = 0       # FIFO stamp assigned at interface enqueue
        self.statuses = None
        self.arrival_time = 0   # set by the propagation phase
        # IP ECN codepoint: ECN_ECT0 on ECN-capable data segments
        # (stamped by the sending socket), rewritten to ECN_CE by a
        # congested queue's marking law, 0 (not-ECT) otherwise.
        self.ecn = 0
        # Hot-path cache: headers and payload never change after
        # construction, and total_size() is called several times per
        # packet in the queue/relay path.
        self._total_size = self.header_size() + len(payload)
        if _trace_enabled:
            self.statuses = [ST_CREATED]

    def record(self, status: str) -> None:
        if self.statuses is not None:
            self.statuses.append(status)

    def header_size(self) -> int:
        return IPV4_HEADER_SIZE + (
            TCP_HEADER_SIZE if self.protocol == PROTO_TCP else UDP_HEADER_SIZE)

    def total_size(self) -> int:
        return self._total_size

    def is_empty_control(self) -> bool:
        """Control packets (no payload) are exempt from random loss, like
        the reference's empty-packet exemption (worker.rs:362-365) — pure
        ACK/SYN/FIN loss would make TCP converge needlessly slowly."""
        return len(self.payload) == 0

    def __repr__(self):
        from shadow_tpu_torch.net.graph import format_ip
        p = "tcp" if self.protocol == PROTO_TCP else "udp"
        return (f"Packet[{p} {format_ip(self.src_ip)}:{self.src_port}->"
                f"{format_ip(self.dst_ip)}:{self.dst_port} len={len(self.payload)} "
                f"id=({self.src_host_id},{self.seq})]")
