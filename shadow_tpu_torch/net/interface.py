"""Network interfaces: socket association, send queueing, recv demux.

Ref: src/main/host/network/interface.rs + queuing.rs + namespace.rs.
Each host has `lo` (127.0.0.1) and `eth0` (its public IP). Outbound,
sockets with pending packets wait in a qdisc-ordered queue that the
upload relay drains; inbound, packets demux to the owning socket by
(protocol, local, peer) with wildcard-peer fallback — the same two-level
lookup the reference uses.

The port's copy of `shadow_tpu/net/interface.py`.
"""

from __future__ import annotations

import heapq
from collections import deque

from shadow_tpu_torch.net import packet as pkt

QDISC_FIFO = "fifo"
QDISC_ROUND_ROBIN = "round_robin"


class NetworkInterface:
    __slots__ = ("ip", "name", "qdisc", "_assoc", "_port_use",
                 "_send_ready", "_send_heap",
                 "_queued", "pcap", "packets_sent", "packets_received",
                 "bytes_sent", "bytes_received")

    def __init__(self, ip: int, name: str, qdisc: str = QDISC_FIFO):
        self.ip = ip
        self.name = name
        self.qdisc = qdisc
        # (proto, local_ip, local_port, peer_ip, peer_port) -> socket.
        # Wildcard peer is (0, 0).
        self._assoc: dict = {}
        # (proto, local_port) -> live association count (wildcard AND
        # 4-tuple).  The ephemeral-port picker consults this: a port
        # whose old connection is still tearing down (FIN/TIME_WAIT
        # holds a 4-tuple assoc) must not be handed out again — reuse
        # against the same peer collides the 4-tuple.
        self._port_use: dict = {}
        self._send_ready: deque = deque()  # round-robin order
        self._send_heap: list = []         # fifo order by packet priority
        self._queued: set = set()          # sockets currently queued
        self.pcap = None                   # PcapWriter hook (utils/pcap.py)
        self.packets_sent = 0
        self.packets_received = 0
        self.bytes_sent = 0
        self.bytes_received = 0

    # ------------------------------------------------------------------
    # Associations (namespace.rs: bind-time registration)
    # ------------------------------------------------------------------

    def associate(self, socket, proto: int, local_port: int,
                  peer_ip: int = 0, peer_port: int = 0) -> None:
        key = (proto, self.ip, local_port, peer_ip, peer_port)
        if key in self._assoc:
            import errno
            raise OSError(errno.EADDRINUSE, "address already in use")
        self._assoc[key] = socket
        pk = (proto, local_port)
        self._port_use[pk] = self._port_use.get(pk, 0) + 1

    def disassociate(self, proto: int, local_port: int,
                     peer_ip: int = 0, peer_port: int = 0) -> None:
        key = (proto, self.ip, local_port, peer_ip, peer_port)
        if self._assoc.pop(key, None) is not None:
            pk = (proto, local_port)
            n = self._port_use.get(pk, 0) - 1
            if n <= 0:
                self._port_use.pop(pk, None)
            else:
                self._port_use[pk] = n

    def is_associated(self, proto: int, local_port: int,
                      peer_ip: int = 0, peer_port: int = 0) -> bool:
        return (proto, self.ip, local_port, peer_ip, peer_port) in self._assoc

    def port_in_use(self, proto: int, local_port: int) -> bool:
        """Any live association (wildcard or 4-tuple) on this port."""
        return (proto, local_port) in self._port_use

    def lookup(self, proto: int, local_port: int, peer_ip: int,
               peer_port: int):
        """Connection-specific association first, then wildcard listener."""
        s = self._assoc.get((proto, self.ip, local_port, peer_ip, peer_port))
        if s is None:
            s = self._assoc.get((proto, self.ip, local_port, 0, 0))
        return s

    def associated_sockets(self, proto: int | None = None):
        """Every associated socket, in association-key order (the
        sim-netstat walker re-sorts by connection identity, but a
        deterministic base order keeps dict-insertion history out of
        the stream)."""
        for key in sorted(self._assoc):
            if proto is None or key[0] == proto:
                yield self._assoc[key]

    # ------------------------------------------------------------------
    # Send path (interface.rs:57-119, queuing.rs NetworkQueue)
    # ------------------------------------------------------------------

    def notify_socket_has_packets(self, host, socket) -> None:
        if socket in self._queued:
            return
        if socket.peek_next_packet_priority(self) is None:
            return
        self._queued.add(socket)
        if self.qdisc == QDISC_ROUND_ROBIN:
            self._send_ready.append(socket)
        else:
            heapq.heappush(self._send_heap,
                           (socket.peek_next_packet_priority(self),
                            id(socket), socket))
        # Kick the relay that drains this interface.
        host.notify_interface_has_packets(self)

    def pop_packet(self, host, now: int):
        """Called by the upload/loopback relay to pull the next packet."""
        while True:
            socket = self._next_queued_socket()
            if socket is None:
                return None
            packet = socket.pull_out_packet(host, self)
            # Re-queue the socket if it still has packets.
            if socket.peek_next_packet_priority(self) is not None:
                self._queued.add(socket)
                if self.qdisc == QDISC_ROUND_ROBIN:
                    self._send_ready.append(socket)
                else:
                    heapq.heappush(self._send_heap,
                                   (socket.peek_next_packet_priority(self),
                                    id(socket), socket))
            if packet is not None:
                self.packets_sent += 1
                self.bytes_sent += packet.total_size()
                if self.pcap is not None:
                    self.pcap.write_packet(now, packet)
                host.trace_snd(packet)
                return packet

    def _next_queued_socket(self):
        if self.qdisc == QDISC_ROUND_ROBIN:
            while self._send_ready:
                s = self._send_ready.popleft()
                if s in self._queued:
                    self._queued.discard(s)
                    return s
            return None
        while self._send_heap:
            _, _, s = heapq.heappop(self._send_heap)
            if s in self._queued:
                self._queued.discard(s)
                return s
        return None

    # ------------------------------------------------------------------
    # Receive path
    # ------------------------------------------------------------------

    def push(self, host, packet) -> None:
        """Inbound delivery from a relay (PacketDevice::push)."""
        now = host.now()
        packet.record(pkt.ST_RCV_INTERFACE)
        self.packets_received += 1
        self.bytes_received += packet.total_size()
        if self.pcap is not None:
            self.pcap.write_packet(now, packet)
        socket = self.lookup(packet.protocol, packet.dst_port,
                             packet.src_ip, packet.src_port)
        if socket is None:
            # No receiver: the packet vanishes (a RST/ICMP refinement can
            # hook here later, matching legacy_tcp behavior).
            host.trace_drop(packet, "no-socket")
            return
        if socket.push_in_packet(host, packet):
            packet.record(pkt.ST_RCV_DELIVERED)
            host.trace_rcv(packet)


def check_bind_port(ifaces, proto: int, port: int,
                    reuseaddr: bool) -> None:
    """Shared explicit-port bind check (TCP + UDP sockets): without
    SO_REUSEADDR, Linux refuses a port with ANY live association —
    TIME_WAIT 4-tuples included; with it, only an exact wildcard
    collision blocks (the server-restart pattern).  Twin:
    netplane.cpp generic_bind."""
    import errno
    for iface in ifaces:
        if (iface.port_in_use(proto, port) if not reuseaddr
                else iface.is_associated(proto, port)):
            raise OSError(errno.EADDRINUSE, "address already in use")
