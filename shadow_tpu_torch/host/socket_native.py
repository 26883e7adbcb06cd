"""Native-plane socket proxies.

Thin Python faces over sockets that live inside the C++ data-plane
engine (native/netplane.cpp).  Each proxy mirrors the API of its
object-path twin (host/socket_tcp.py TcpSocket / host/socket_udp.py
UdpSocket) toward the syscall layer: same methods, same exceptions,
same `local`/`peer`/`nonblocking` attributes, same StatusOwner
behavior — but every data-plane operation is one C call.

Status bits are pushed FROM the engine via the plane callback (the
engine's adjust_status twin fires on every effective change), so
`self._status` mirrors the engine mask without polling, and listeners
(conditions, epoll) fire at exactly the instants the object path fires
them.

The classes are deliberately named `TcpSocket`/`UdpSocket`: the object
counter keys lifecycle accounting by type name, and sim-stats must not
depend on which plane a scheduler uses.
"""

from __future__ import annotations

import errno

from shadow_tpu_torch.host.status import (S_ACTIVE, S_CLOSED, S_READABLE,
                                    S_WRITABLE, StatusOwner)
from shadow_tpu_torch.net import packet as pkt

_ERR_MSG = {
    errno.EISCONN: "already connected",
    errno.ENOTCONN: "not connected",
    errno.ECONNRESET: "connection reset",
    errno.ETIMEDOUT: "connection timed out",
    errno.ECONNREFUSED: "connection refused",
    errno.EADDRINUSE: "address already in use",
    errno.EADDRNOTAVAIL: "cannot bind non-local address",
    errno.EPIPE: "not established",
    errno.EINVAL: "invalid operation",
    errno.EMSGSIZE: "datagram too large",
    errno.EDESTADDRREQ: "no destination",
    errno.EOPNOTSUPP: "operation not supported",
    errno.EALREADY: "connect in progress",
    errno.EINPROGRESS: "connect started",
}


class _ConnView:
    """getsockopt's window into the autotuned connection buffers."""
    __slots__ = ("send_buf_max", "recv_buf_max")

    def __init__(self, send_buf_max: int, recv_buf_max: int):
        self.send_buf_max = send_buf_max
        self.recv_buf_max = recv_buf_max


def _raise(code: int):
    e = -code if code < 0 else code
    if e in (errno.EAGAIN, errno.EWOULDBLOCK):
        raise BlockingIOError(errno.EWOULDBLOCK, "would block")
    raise OSError(e, _ERR_MSG.get(e, "socket error"))


class _NativeSocket(StatusOwner):
    """Shared proxy behavior: status mirroring + address caching."""

    def __init__(self, host, plane, tok: int, initial_status: int):
        super().__init__()
        self.plane = plane
        self.tok = tok
        self.local = None
        self.peer = None
        self.nonblocking = False
        self._status = initial_status
        host._nsocks[tok] = self

    @property
    def reuseaddr(self) -> bool:
        return getattr(self, "_reuseaddr", False)

    @reuseaddr.setter
    def reuseaddr(self, v: bool) -> None:
        self._reuseaddr = bool(v)
        self.plane.engine.sock_set(self.tok, "reuseaddr", 1 if v else 0)

    # Engine-pushed status change (plane callback CB_STATUS).
    def apply_status(self, host, set_mask: int, clear_mask: int) -> None:
        self.adjust_status(host, set_mask, clear_mask)

    def bytes_available(self) -> int:
        """FIONREAD/SIOCINQ (glibc's resolver sizes its second DNS read
        with this — zero here breaks name resolution)."""
        return self.plane.engine.sock_inq(self.tok)

    def _refresh_addr(self) -> None:
        (hl, lip, lport), (hp_, pip, pport) = self.plane.engine.sock_addr(
            self.tok)
        self.local = (lip, lport) if hl else None
        self.peer = (pip, pport) if hp_ else None


class TcpSocket(_NativeSocket):
    """Native-plane TCP socket proxy (twin: host/socket_tcp.py)."""

    def __init__(self, host, send_buf: int, recv_buf: int,
                 send_autotune: bool = True, recv_autotune: bool = True,
                 _tok: int | None = None):
        plane = host.plane
        if _tok is None:
            _tok = plane.engine.tcp_socket(host.id, send_buf, recv_buf,
                                           send_autotune, recv_autotune)
            status = S_ACTIVE
        else:
            status = plane.engine.sock_status(_tok)  # accept-queue child
        super().__init__(host, plane, _tok, status)
        self.protocol = pkt.PROTO_TCP
        self._nodelay = False
        self.listening = False  # SO_ACCEPTCONN mirror

    @property
    def nodelay(self) -> bool:
        return self._nodelay

    @nodelay.setter
    def nodelay(self, v: bool) -> None:
        self._nodelay = bool(v)
        # Flag-only set (no clock in hand): engine defers the Nagle
        # flush; setsockopt goes through set_nodelay below instead.
        self.plane.engine.tcp_set_nodelay(self.tok, 1 if v else 0, -1)

    def set_nodelay(self, host, v: bool) -> None:
        """setsockopt(TCP_NODELAY): Linux flushes Nagle-held data on
        enable — the engine runs the push_data + flush at now."""
        self._nodelay = bool(v)
        self.plane.engine.tcp_set_nodelay(self.tok, 1 if v else 0,
                                          host.now())

    @property
    def conn(self):
        """Buffer-sizing view for getsockopt parity with the object
        path's conn (autotuned SO_SNDBUF/SO_RCVBUF); None before
        connect/accept, like the twin."""
        bufs = self.plane.engine.tcp_bufs(self.tok)
        if bufs is None:
            return None
        return _ConnView(bufs[0], bufs[1])

    def bind(self, host, ip: int, port: int) -> None:
        r = self.plane.engine.sock_bind(self.tok, ip, port)
        if r < 0:
            _raise(r)
        self.local = (ip, r)

    def listen(self, host, backlog: int = 128) -> None:
        r = self.plane.engine.tcp_listen(self.tok, backlog)
        if r == -errno.EISCONN:
            raise OSError(errno.EISCONN, "already connected")
        if r < 0:
            raise OSError(errno.EINVAL, "listen before bind")
        self.listening = True

    def connect(self, host, ip: int, port: int):
        from shadow_tpu_torch.host.condition import SyscallCondition
        from shadow_tpu_torch.native.plane import R_BLOCK
        if self.nonblocking:
            self.plane.engine.sock_set(self.tok, "nonblocking", 1)
        r = self.plane.engine.tcp_connect(self.tok, ip, port, host.now())
        self._refresh_addr()
        if r == 0:
            return 0
        if r == R_BLOCK:
            return SyscallCondition(file=self, mask=S_WRITABLE | S_CLOSED)
        _raise(r)

    def accept(self, host):
        r = self.plane.engine.tcp_accept(self.tok, host.now())
        if r < 0:
            _raise(r)
        child = host._nsocks[r]
        child._refresh_addr()
        return child

    def sendto(self, host, data: bytes, dst=None) -> int:
        r = self.plane.engine.tcp_sendto(self.tok, bytes(data), host.now())
        if r < 0:
            _raise(r)
        return r

    def recv(self, host, bufsize: int, peek: bool = False) -> bytes:
        r = self.plane.engine.tcp_recv(self.tok, bufsize, peek, host.now())
        if isinstance(r, int):
            _raise(r)
        return r

    def recvfrom(self, host, bufsize: int, peek: bool = False):
        return self.recv(host, bufsize, peek=peek), self.peer

    def shutdown(self, host, how: str = "wr") -> None:
        if "w" in how:
            self.plane.engine.tcp_shutdown(self.tok, host.now())

    def close(self, host) -> None:
        self.plane.engine.sock_close(self.tok, host.now())
        # Drop the registry entry: post-close engine transitions (e.g.
        # TIME_WAIT expiry) find no proxy, which is fine — the app-facing
        # S_CLOSED was already applied during the close call itself.
        host._nsocks.pop(self.tok, None)

    def tcp_info(self):
        """(state, error, srtt, cwnd, rto, rtx_count, sacked_skips,
        eff_mss) — diagnostics parity with the object path's conn."""
        return self.plane.engine.tcp_info(self.tok)


class UdpSocket(_NativeSocket):
    """Native-plane UDP socket proxy (twin: host/socket_udp.py)."""

    def __init__(self, host, send_buf: int, recv_buf: int):
        plane = host.plane
        tok = plane.engine.udp_socket(host.id, send_buf, recv_buf)
        super().__init__(host, plane, tok, S_ACTIVE | S_WRITABLE)
        self.protocol = pkt.PROTO_UDP

    def bind(self, host, ip: int, port: int) -> None:
        r = self.plane.engine.sock_bind(self.tok, ip, port)
        if r < 0:
            _raise(r)
        self.local = (ip, r)

    def connect(self, host, ip: int, port: int) -> None:
        if self.local is None:
            self.bind(host, 0, 0)
        self.peer = (ip, port)
        # Mirror into the engine for the connected-filter on receive.
        self.plane.engine.udp_connect(self.tok, ip, port)

    def sendto(self, host, data: bytes, dst) -> int:
        if dst is None:
            has_dst, dst_ip, dst_port = False, 0, 0
        else:
            has_dst, (dst_ip, dst_port) = True, dst
        r = self.plane.engine.udp_sendto(self.tok, bytes(data), has_dst,
                                         dst_ip, dst_port, host.now())
        if r < 0:
            _raise(r)
        self._refresh_addr()
        return r

    def recvfrom(self, host, bufsize: int, peek: bool = False):
        r = self.plane.engine.udp_recvfrom(self.tok, bufsize, peek)
        if isinstance(r, int):
            _raise(r)
        data, src_ip, src_port = r
        return data, (src_ip, src_port)

    def push_reply(self, host, payload: bytes, src_ip: int,
                   src_port: int) -> None:
        """dns_wire answer path: a crafted datagram straight into the
        receive queue (twin: push_in_packet of a locally-built packet)."""
        self.plane.engine.udp_push_reply(self.tok, payload, src_ip,
                                         src_port, host.now())

    def close(self, host) -> None:
        self.plane.engine.sock_close(self.tok, host.now())
        host._nsocks.pop(self.tok, None)
