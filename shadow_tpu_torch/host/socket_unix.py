"""AF_UNIX sockets, fully emulated (ref: socket/unix.rs, 2,419 LoC,
plus abstract_unix_ns.rs).

Unix sockets must be emulated, not passed native: a native blocking
read would park the real OS thread inside the kernel, stalling the
manager's event pump on wall-clock time — the same reason inet sockets
and pipes are simulated.  Transfers are host-local buffer moves with no
network latency, like the reference.

Namespace: per-host (`host.unix_ns`), holding both filesystem-style
paths and the Linux abstract namespace (leading NUL).  Filesystem bind
does NOT create a real directory entry — file I/O is native in our
split, but socket files only matter to other in-sim sockets, and a
phantom fs entry would leak across hosts.  An app stat()ing its own
socket file is the known divergence.

SCM_RIGHTS fd passing is modeled for both fd spaces: EMULATED fds ride
the message as objects and register into the receiver's table at
recvmsg (cross-process works because fd objects are manager-side);
NATIVE fds are pulled from the sender with pidfd_getfd and delivered
through the receiver's transfer socket (see managed.py _do_fdxfer),
preserving the shared open file description.  Stream ancillary
attaches at the sender's byte watermark and is delivered with the
read that reaches it.
"""

from __future__ import annotations

import errno

from shadow_tpu_torch.host.status import (S_ACTIVE, S_CLOSED, S_READABLE,
                                    S_SOCKET_ALLOWING_CONNECT, S_WRITABLE)
from shadow_tpu_torch.host.status import StatusOwner

BUF_MAX = 212_992  # net.core.wmem_default'ish


class UnixSocket(StatusOwner):
    """One AF_UNIX endpoint: stream or dgram, bindable, connectable.

    Stream data lives in the RECEIVER's `_recv_buf`; dgram in a
    datagram queue with source addresses.
    """

    def __init__(self, host, stream: bool):
        super().__init__()
        self.host = host
        self.stream = stream
        self.nonblocking = False
        self.bound_name: str | None = None   # "@name" for abstract
        self.peer: "UnixSocket | None" = None
        self.listening = False
        self._backlog = 0
        self._pending: list = []             # listener: accepted peers
        self._recv_buf = bytearray()         # stream bytes
        self._dgrams: list = []              # (data, src_name, anc)
        self._dgram_waiters: list = []       # senders parked on our queue
        # SCM_RIGHTS in flight: stream ancillary as (watermark, objs)
        # against the total-bytes counters; dgram ancillary rides the
        # datagram tuple.  take_ancillary() drains what a recvmsg
        # delivery reached.
        self._anc_stream: list = []
        self._rx_total = 0                   # bytes ever buffered
        self._rx_read = 0                    # bytes ever consumed
        self._last_anc: list = []
        self._eof = False
        self._status = S_ACTIVE | (0 if stream else S_WRITABLE)

    # -- address book --------------------------------------------------

    def bind(self, host, name: str) -> None:
        if self.bound_name is not None:
            raise OSError(errno.EINVAL, "already bound")
        ns = host.unix_ns
        if name in ns:
            raise OSError(errno.EADDRINUSE, name)
        ns[name] = self
        self.bound_name = name

    def listen(self, host, backlog: int) -> None:
        if not self.stream:
            raise OSError(errno.EOPNOTSUPP, "dgram listen")
        if self.bound_name is None:
            raise OSError(errno.EINVAL, "listen on unbound socket")
        self.listening = True
        self._backlog = max(1, backlog)
        self.adjust_status(host, S_SOCKET_ALLOWING_CONNECT, 0)

    # -- stream connection setup --------------------------------------

    def connect(self, host, name: str) -> None:
        if self.peer is not None:
            raise OSError(errno.EISCONN, "already connected")
        target = host.unix_ns.get(name)
        if target is None:
            raise OSError(errno.ECONNREFUSED
                          if self.stream else errno.ENOENT, name)
        if self.stream:
            if not target.listening:
                raise OSError(errno.ECONNREFUSED, name)
            if len(target._pending) >= target._backlog:
                # Blocking connect waits for accept-queue room; the
                # caller parks on the LISTENER's allowing-connect bit.
                target.adjust_status(host, 0, S_SOCKET_ALLOWING_CONNECT)
                err = BlockingIOError(errno.EAGAIN, "backlog full")
                err.listener = target
                raise err
            server = UnixSocket(host, stream=True)
            server.bound_name = target.bound_name
            server.peer = self
            self.peer = server
            server.adjust_status(host, S_WRITABLE, 0)
            self.adjust_status(host, S_WRITABLE, 0)
            target._pending.append(server)
            target.adjust_status(host, S_READABLE, 0)
        else:
            # Dgram connect just fixes the default destination.
            self.peer = target

    def accept(self, host) -> "UnixSocket":
        if not self.listening:
            raise OSError(errno.EINVAL, "not listening")
        if not self._pending:
            raise BlockingIOError(errno.EWOULDBLOCK, "no pending")
        child = self._pending.pop(0)
        if not self._pending:
            self.adjust_status(host, 0, S_READABLE)
        # Queue room again: wake blocked connect()ers.
        self.adjust_status(host, S_SOCKET_ALLOWING_CONNECT, 0)
        return child

    # -- data plane ----------------------------------------------------

    def sendto(self, host, data: bytes, dest_name: str | None,
               anc: list | None = None):
        if self.stream:
            peer = self.peer
            if peer is None:
                raise OSError(errno.ENOTCONN, "not connected")
            if peer.has_status(S_CLOSED) or peer._eof:
                raise OSError(errno.EPIPE, "peer closed")
            room = BUF_MAX - len(peer._recv_buf)
            if room <= 0:
                self.adjust_status(host, 0, S_WRITABLE)
                raise BlockingIOError(errno.EWOULDBLOCK, "buffer full")
            take = data[:room]
            if not take:
                # Zero-length stream send transfers nothing — including
                # ancillary fds (Linux queues no skb).
                if anc:
                    from shadow_tpu_torch.host.descriptor import _decref
                    for obj in anc:
                        _decref(obj, host)
                return 0
            if anc:
                # Attach at the current watermark: delivered with the
                # read that reaches this byte position.
                peer._anc_stream.append((peer._rx_total, list(anc)))
            peer._recv_buf += take
            peer._rx_total += len(take)
            peer.adjust_status(host, S_READABLE, 0)
            if len(peer._recv_buf) >= BUF_MAX:
                self.adjust_status(host, 0, S_WRITABLE)
            return len(take)
        # dgram
        if dest_name is not None:
            target = host.unix_ns.get(dest_name)
            if target is None:
                raise OSError(errno.ENOENT, dest_name)
        else:
            target = self.peer
            if target is None:
                raise OSError(errno.ENOTCONN, "no destination")
        if target.has_status(S_CLOSED):
            raise OSError(errno.ECONNREFUSED, "peer closed")
        queued = sum(len(d) for d, _s, _a in target._dgrams)
        if queued + len(data) > BUF_MAX:
            # Park on our own WRITABLE bit; the receiver wakes us when
            # it drains (without this the permanently-set bit would
            # re-fire the blocked syscall forever at the same instant).
            self.adjust_status(host, 0, S_WRITABLE)
            if self not in target._dgram_waiters:
                target._dgram_waiters.append(self)
            raise BlockingIOError(errno.EWOULDBLOCK, "receiver full")
        target._dgrams.append((bytes(data), self.bound_name or "",
                               list(anc) if anc else []))
        target.adjust_status(host, S_READABLE, 0)
        return len(data)

    def recvfrom(self, host, bufsize: int, peek: bool = False):
        if self.stream:
            if not self._recv_buf:
                if self._eof or (self.peer is not None
                                 and self.peer.has_status(S_CLOSED)):
                    return b"", None
                raise BlockingIOError(errno.EWOULDBLOCK, "empty")
            if peek:
                return bytes(self._recv_buf[:bufsize]), None
            limit = bufsize
            ws = self._anc_stream
            if ws:
                # Linux never returns bytes spanning two SCM scopes: a
                # read stops before the first boundary (plain data
                # first), and a read that consumed a boundary stops
                # before the next one.
                first = ws[0][0]
                if self._rx_read < first:
                    limit = min(limit, first - self._rx_read)
                elif len(ws) > 1:
                    limit = min(limit, ws[1][0] - self._rx_read)
            out = bytes(self._recv_buf[:limit])
            del self._recv_buf[:limit]
            self._rx_read += len(out)
            while self._anc_stream and self._anc_stream[0][0] < \
                    self._rx_read:
                self._last_anc.extend(self._anc_stream.pop(0)[1])
            if not self._recv_buf and not self._eof:
                self.adjust_status(host, 0, S_READABLE)
            peer = self.peer
            if peer is not None and not peer.has_status(S_CLOSED):
                peer.adjust_status(host, S_WRITABLE, 0)
            return out, None
        if not self._dgrams:
            raise BlockingIOError(errno.EWOULDBLOCK, "empty")
        if peek:
            data, src, _anc = self._dgrams[0]
            return data[:bufsize], src
        data, src, anc = self._dgrams.pop(0)
        self._last_anc.extend(anc)
        if not self._dgrams:
            self.adjust_status(host, 0, S_READABLE)
        if self._dgram_waiters:
            waiters, self._dgram_waiters = self._dgram_waiters, []
            for w in waiters:
                if not w.has_status(S_CLOSED):
                    w.adjust_status(host, S_WRITABLE, 0)
        return data[:bufsize], src

    def take_ancillary(self) -> list:
        """Objects delivered by the reads since the last call —
        consumed by recvmsg; a plain recv discards them (like Linux
        closing unclaimed SCM_RIGHTS fds)."""
        out, self._last_anc = self._last_anc, []
        return out

    def next_read_has_native_fds(self) -> bool:
        """Would the next read surface NativeFdRef ancillary?  Lets
        recvmmsg stop a batch BEFORE consuming such a message (the
        fd-transfer dance patches one cmsg per syscall, so the message
        must head its own batch).  Stream case: ancillary surfaces only
        when the next read starts at/past its SCM-scope watermark (the
        read limiter stops earlier reads at the boundary)."""
        from shadow_tpu_torch.host.descriptor import NativeFdRef
        if self.stream:
            ws = self._anc_stream
            if not ws or ws[0][0] > self._rx_read:
                return False
            return any(isinstance(o, NativeFdRef) for o in ws[0][1])
        if not self._dgrams:
            return False
        return any(isinstance(o, NativeFdRef) for o in self._dgrams[0][2])

    def bytes_available(self) -> int:
        if self.stream:
            return len(self._recv_buf)
        return len(self._dgrams[0][0]) if self._dgrams else 0

    def shutdown(self, host, how: str = "wr") -> None:
        peer = self.peer
        if how in ("wr", "rdwr") and peer is not None:
            peer._eof = True
            peer.adjust_status(host, S_READABLE, 0)
        if how in ("rd", "rdwr"):
            self._eof = True

    def close(self, host) -> None:
        if self.bound_name is not None and \
                host.unix_ns.get(self.bound_name) is self:
            del host.unix_ns[self.bound_name]
        # Release in-flight SCM_RIGHTS references (Linux closes fds
        # still riding a destroyed socket) — without this a carried
        # pipe end never reaches refcount 0 and its reader never sees
        # EOF.
        from shadow_tpu_torch.host.descriptor import _decref
        pending = list(self._last_anc)
        for _w, objs in self._anc_stream:
            pending.extend(objs)
        for _d, _s, objs in self._dgrams:
            pending.extend(objs)
        self._last_anc = []
        self._anc_stream = []
        for obj in pending:
            _decref(obj, host)
        peer = self.peer
        if self.listening:
            # Wake connect()ers parked on backlog room; their retry
            # sees the dead listener and fails ECONNREFUSED.
            self.adjust_status(host, S_SOCKET_ALLOWING_CONNECT, 0)
        self.adjust_status(host, S_CLOSED,
                           S_ACTIVE | S_READABLE | S_WRITABLE |
                           S_SOCKET_ALLOWING_CONNECT)
        if peer is not None and self.stream:
            peer._eof = True
            # EOF is readable; writers notice EPIPE via the wake.
            peer.adjust_status(host, S_READABLE | S_WRITABLE, 0)
        from shadow_tpu_torch.utils.object_counter import mark_dealloc
        for child in self._pending:
            # Never-accepted connections: tear down BOTH ends so the
            # client sees EOF/EPIPE instead of blocking forever.
            child._eof = True
            child.adjust_status(host, S_CLOSED, S_ACTIVE)
            mark_dealloc(child)
            client = child.peer
            if client is not None:
                client._eof = True
                client.adjust_status(host, S_READABLE | S_WRITABLE, 0)
        self._pending.clear()
        if self._dgram_waiters:
            # Parked senders retry and get ENOENT/ECONNREFUSED.
            waiters, self._dgram_waiters = self._dgram_waiters, []
            for w in waiters:
                w.adjust_status(host, S_WRITABLE, 0)


def unix_socketpair(host, stream: bool):
    """socketpair(AF_UNIX): two mutually-connected unnamed endpoints."""
    a = UnixSocket(host, stream)
    b = UnixSocket(host, stream)
    a.peer = b
    b.peer = a
    a._status |= S_WRITABLE
    b._status |= S_WRITABLE
    return a, b
