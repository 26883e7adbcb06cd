"""UDP sockets (ref: src/main/host/descriptor/socket/inet/udp.rs).

A UDP socket is a pair of bounded packet queues: the send queue drains
through the interface/relay/token-bucket path; the recv queue fills from
the interface demux. Status bits drive poll/epoll/blocking syscalls.

The port's copy of `shadow_tpu/host/socket_udp.py`.
"""

from __future__ import annotations

import errno
from collections import deque

from shadow_tpu_torch.host.status import (S_ACTIVE, S_READABLE, S_WRITABLE,
                                    S_CLOSED, StatusOwner)
from shadow_tpu_torch.net import packet as pkt
from shadow_tpu_torch.net.graph import LOCALHOST_IP

INADDR_ANY = 0
# No IP fragmentation is modeled (same simplification as the reference's
# UDP socket): a datagram must fit one MTU-sized packet, which also
# guarantees every packet conforms to the token-bucket burst capacity.
UDP_MAX_PAYLOAD = pkt.MTU - pkt.IPV4_HEADER_SIZE - pkt.UDP_HEADER_SIZE

EPHEMERAL_LO = 32_768
EPHEMERAL_HI = 65_536


class UdpSocket(StatusOwner):
    def __init__(self, host, send_buf: int, recv_buf: int):
        super().__init__()
        self.protocol = pkt.PROTO_UDP
        self.local = None       # (ip, port) after bind
        self.peer = None        # (ip, port) after connect
        self._ifaces = []       # interfaces we're associated on
        # Separate send queue per interface: the loopback relay must never
        # drain remote-destined packets (which would bypass the upload
        # token bucket) and vice versa.
        self._send_q: dict[str, deque] = {"lo": deque(), "eth0": deque()}
        self._send_bytes = 0
        self._send_max = send_buf
        self._recv_q: deque = deque()
        self._recv_bytes = 0
        self._recv_max = recv_buf
        self.drops_full_recv = 0
        self._status = S_ACTIVE | S_WRITABLE
        self.nonblocking = False
        self.reuseaddr = False

    # ------------------------------------------------------------------
    # Binding
    # ------------------------------------------------------------------

    def _pick_interfaces(self, host, ip: int):
        if ip == INADDR_ANY:
            return [host.lo, host.eth0]
        if ip == LOCALHOST_IP:
            return [host.lo]
        if ip == host.eth0.ip:
            return [host.eth0]
        raise OSError(errno.EADDRNOTAVAIL, "cannot bind non-local address")

    def bind(self, host, ip: int, port: int) -> None:
        if self.local is not None:
            raise OSError(errno.EINVAL, "already bound")
        ifaces = self._pick_interfaces(host, ip)
        if port == 0:
            port = self._ephemeral_port(host, ifaces)
        else:
            from shadow_tpu_torch.net.interface import check_bind_port
            check_bind_port(ifaces, self.protocol, port, self.reuseaddr)
        for iface in ifaces:
            iface.associate(self, self.protocol, port)
        self._ifaces = ifaces
        self.local = (ip, port)

    def _ephemeral_port(self, host, ifaces) -> int:
        # Random ephemeral ports from the host's deterministic stream
        # (reference: udp.rs uses the host RNG the same way).
        for _ in range(64):
            port = host.rng.randrange(EPHEMERAL_LO, EPHEMERAL_HI)
            if not any(i.port_in_use(self.protocol, port) for i in ifaces):
                return port
        # Dense occupancy: linear probe, still deterministic.
        for port in range(EPHEMERAL_LO, EPHEMERAL_HI):
            if not any(i.port_in_use(self.protocol, port) for i in ifaces):
                return port
        raise OSError(errno.EADDRINUSE, "no free ephemeral ports")

    def connect(self, host, ip: int, port: int) -> None:
        """UDP connect: set the default/filter peer."""
        if self.local is None:
            self.bind(host, INADDR_ANY, 0)
        self.peer = (ip, port)

    # ------------------------------------------------------------------
    # Send path
    # ------------------------------------------------------------------

    def sendto(self, host, data: bytes, dst) -> int:
        if dst is None:
            if self.peer is None:
                raise OSError(errno.EDESTADDRREQ, "no destination")
            dst = self.peer
        if len(data) > UDP_MAX_PAYLOAD:
            raise OSError(errno.EMSGSIZE, "datagram too large")
        if self.local is None:
            self.bind(host, INADDR_ANY, 0)
        size = len(data) + pkt.UDP_HEADER_SIZE + pkt.IPV4_HEADER_SIZE
        if self._send_bytes + size > self._send_max:
            # Clear WRITABLE so a blocked sender only retries after the
            # relay drains something (pull_out_packet re-sets it) —
            # otherwise an already-satisfied condition would re-fire at the
            # same instant and spin the thread forever.
            self.adjust_status(host, 0, S_WRITABLE)
            raise BlockingIOError(errno.EWOULDBLOCK, "send buffer full")
        dst_ip, dst_port = dst
        src_ip = self.local[0]
        if src_ip == INADDR_ANY:
            src_ip = LOCALHOST_IP if dst_ip == LOCALHOST_IP else host.eth0.ip
        seq = host.next_packet_seq()
        p = pkt.Packet(host.id, seq, self.protocol, src_ip, self.local[1],
                       dst_ip, dst_port, payload=bytes(data))
        p.priority = seq
        iface = host.lo if dst_ip == LOCALHOST_IP else host.eth0
        self._send_q[iface.name].append(p)
        self._send_bytes += size
        iface.notify_socket_has_packets(host, self)
        return len(data)

    def peek_next_packet_priority(self, iface):
        q = self._send_q[iface.name]
        return q[0].priority if q else None

    def pull_out_packet(self, host, iface):
        q = self._send_q[iface.name]
        if not q:
            return None
        p = q.popleft()
        self._send_bytes -= p.total_size()
        if not self.has_status(S_CLOSED):
            self.adjust_status(host, S_WRITABLE, 0)
        return p

    # ------------------------------------------------------------------
    # Receive path
    # ------------------------------------------------------------------

    def push_in_packet(self, host, packet) -> bool:
        if self.peer is not None and \
                (packet.src_ip, packet.src_port) != self.peer:
            host.trace_drop(packet, "udp-connected-filter")
            return False
        size = packet.total_size()
        if self._recv_bytes + size > self._recv_max:
            self.drops_full_recv += 1
            host.trace_drop(packet, "rcvbuf-full")
            return False
        self._recv_q.append(packet)
        self._recv_bytes += size
        self.adjust_status(host, S_READABLE, 0)
        return True

    def recvfrom(self, host, bufsize: int, peek: bool = False):
        if not self._recv_q:
            raise BlockingIOError(errno.EWOULDBLOCK, "no data")
        if peek:
            p = self._recv_q[0]
            return p.payload[:bufsize], (p.src_ip, p.src_port)
        p = self._recv_q.popleft()
        self._recv_bytes -= p.total_size()
        if not self._recv_q:
            self.adjust_status(host, 0, S_READABLE)
        return p.payload[:bufsize], (p.src_ip, p.src_port)

    # ------------------------------------------------------------------

    def close(self, host) -> None:
        for iface in self._ifaces:
            if self.local is not None:
                iface.disassociate(self.protocol, self.local[1])
        self._ifaces = []
        self.adjust_status(host, S_CLOSED, S_ACTIVE | S_READABLE | S_WRITABLE)
