"""TCP sockets: the simulated-kernel adapter around the sans-I/O
TcpConnection (ref: src/main/host/descriptor/socket/inet/tcp.rs wrapping
src/lib/tcp — same split: protocol logic in the crate, kernel glue here).

A TcpSocket is either a *listener* (accept queue of handshaking children)
or a *stream* (one TcpConnection). Children are created on inbound SYN,
registered under their specific 4-tuple, and surface through accept()
once established.

The port's copy of `shadow_tpu/host/socket_tcp.py`.
"""

from __future__ import annotations

import errno
from collections import deque

from shadow_tpu_torch.core.event import TaskRef
from shadow_tpu_torch.host.condition import SyscallCondition
from shadow_tpu_torch.host.status import (S_ACTIVE, S_CLOSED, S_READABLE,
                                    S_WRITABLE, StatusOwner)
from shadow_tpu_torch.net import packet as pkt
from shadow_tpu_torch.net.graph import LOCALHOST_IP
from shadow_tpu_torch.tcp import connection as tcpc
from shadow_tpu_torch.trace.events import TEL_REASM_FULL, TEL_RECVWIN_TRUNC

INADDR_ANY = 0
EPHEMERAL_LO = 32_768
EPHEMERAL_HI = 65_536


# Autotuner clamps live in the connection module (single source of
# truth with the SYN-time window-scale ceiling).
WMEM_MAX = tcpc.WMEM_MAX
RMEM_MAX = tcpc.RMEM_MAX


class TcpSocket(StatusOwner):
    def __init__(self, host, send_buf: int, recv_buf: int,
                 send_autotune: bool = True, recv_autotune: bool = True):
        super().__init__()
        self.protocol = pkt.PROTO_TCP
        self.local = None
        self.peer = None
        self.nonblocking = False
        self.nodelay = False          # TCP_NODELAY, propagated to conns
        self.reuseaddr = False        # SO_REUSEADDR, bind-time semantics
        self._send_buf_max = send_buf
        self._recv_buf_max = recv_buf
        # Per-host TCP stack options (`tcp: {cc, ecn}` config block),
        # captured at socket birth so every connection this socket —
        # or its accept children — creates runs the host's stack.
        self._tcp_cc = getattr(host, "tcp_cc", "reno")
        self._tcp_ecn = getattr(host, "tcp_ecn", False)
        # Dynamic buffer sizing (ref tcp.c _tcp_autotune*Buffer):
        # grow-only, clamped to the bandwidth-delay product.
        self.send_autotune = send_autotune
        self.recv_autotune = recv_autotune
        self._at_bytes_copied = 0
        self._at_space = 0
        self._at_last_adjust = 0
        self._ifaces = []
        self._iface = None            # the interface a stream runs on
        self.conn: tcpc.TcpConnection | None = None
        # Listener state.
        self.listening = False
        self._backlog = 0
        self._accept_q: deque = deque()
        self._listener = None         # backref for children
        self._accept_queued = False
        self._delivered = False       # handed to the app via accept()
        # Egress packets ready for the interface, per interface name.
        self._out_packets: dict[str, deque] = {"lo": deque(), "eth0": deque()}
        self._timer_deadline: int | None = None
        self._status = S_ACTIVE

    # ------------------------------------------------------------------
    # Binding / connecting / listening
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
        for _ in range(64):
            port = host.rng.randrange(EPHEMERAL_LO, EPHEMERAL_HI)
            if not any(i.port_in_use(self.protocol, port) for i in ifaces):
                return port
        for port in range(EPHEMERAL_LO, EPHEMERAL_HI):
            if not any(i.port_in_use(self.protocol, port) for i in ifaces):
                return port
        raise OSError(errno.EADDRINUSE, "no free ephemeral ports")

    def listen(self, host, backlog: int = 128) -> None:
        if self.local is None:
            raise OSError(errno.EINVAL, "listen before bind")
        if self.conn is not None:
            raise OSError(errno.EISCONN, "already connected")
        self.listening = True
        self._backlog = max(1, backlog)

    def connect(self, host, ip: int, port: int):
        """Active open. Returns 0 when established, a SyscallCondition
        while the handshake is in flight (caller blocks), raises on
        failure. Re-entered with the same args after unblock (restart
        protocol)."""
        if self.listening:
            raise OSError(errno.EOPNOTSUPP, "listener cannot connect")
        if self.conn is not None:
            if (ip, port) != (self.peer or (None, None)):
                raise OSError(errno.EISCONN, "already connected")
            if self.conn.error:
                code = (errno.ETIMEDOUT if "timed" in self.conn.error
                        else errno.ECONNREFUSED)
                raise OSError(code, self.conn.error)
            if self.conn.state == tcpc.ESTABLISHED:
                return 0
            if self.nonblocking:
                raise OSError(errno.EALREADY, "connect in progress")
            return SyscallCondition(file=self, mask=S_WRITABLE | S_CLOSED)
        if self.local is None:
            dst_local = LOCALHOST_IP if ip == LOCALHOST_IP else host.eth0.ip
            self.bind(host, dst_local, 0)
        self.peer = (ip, port)
        self._iface = host.lo if ip == LOCALHOST_IP else host.eth0
        # Move from wildcard to the specific 4-tuple so multiple
        # connections can share a local port.  Check BEFORE mutating:
        # an exact-4-tuple collision (explicit bind + reconnect to the
        # same peer) must fail cleanly, not leave the socket headless.
        if self._iface.is_associated(self.protocol, self.local[1],
                                     ip, port):
            self.peer = None
            raise OSError(errno.EADDRINUSE, "address already in use")
        for iface in self._ifaces:
            iface.disassociate(self.protocol, self.local[1])
        self._iface.associate(self, self.protocol, self.local[1], ip, port)
        self._ifaces = [self._iface]
        self.conn = tcpc.TcpConnection(
            iss=host.rng.next_u32(), recv_buf_max=self._recv_buf_max,
            send_buf_max=self._send_buf_max,
            congestion=self._tcp_cc, ecn=self._tcp_ecn,
            window_ceiling=(tcpc.RMEM_CEILING if self.recv_autotune
                            else None))
        self.conn.nodelay = self.nodelay
        self.conn.open_active(host.now())
        self._flush(host)
        if self.nonblocking:
            raise OSError(errno.EINPROGRESS, "connect started")
        return SyscallCondition(file=self, mask=S_WRITABLE | S_CLOSED)

    def accept(self, host):
        if not self.listening:
            raise OSError(errno.EINVAL, "not listening")
        if not self._accept_q:
            raise BlockingIOError(errno.EWOULDBLOCK, "no pending connection")
        child = self._accept_q.popleft()
        child._delivered = True  # the app owns it now (fd lifecycle)
        if not self._accept_q:
            self.adjust_status(host, 0, S_READABLE)
        return child

    # ------------------------------------------------------------------
    # Data path (app side)
    # ------------------------------------------------------------------

    def _require_conn(self) -> tcpc.TcpConnection:
        if self.conn is None:
            raise OSError(errno.ENOTCONN, "not connected")
        return self.conn

    def sendto(self, host, data: bytes, dst=None) -> int:
        conn = self._require_conn()
        if conn.error:
            raise OSError(errno.ECONNRESET, conn.error)
        if conn.state not in (tcpc.ESTABLISHED, tcpc.CLOSE_WAIT):
            raise OSError(errno.EPIPE, "not established")
        n = conn.write(data, host.now())
        self._flush(host)
        if n == 0:
            self.adjust_status(host, 0, S_WRITABLE)
            raise BlockingIOError(errno.EWOULDBLOCK, "send buffer full")
        return n

    def recvfrom(self, host, bufsize: int, peek: bool = False):
        return self.recv(host, bufsize, peek=peek), self.peer

    def bytes_available(self) -> int:
        """FIONREAD/SIOCINQ: in-order readable bytes (twin:
        Engine sock_inq in native/netplane.cpp)."""
        return self.conn.readable_bytes() if self.conn is not None else 0

    def recv(self, host, bufsize: int, peek: bool = False) -> bytes:
        conn = self._require_conn()
        if conn.readable_bytes() == 0:
            if conn.at_eof():
                return b""
            if conn.error:
                raise OSError(errno.ECONNRESET, conn.error)
            self.adjust_status(host, 0, S_READABLE)
            raise BlockingIOError(errno.EWOULDBLOCK, "no data")
        if peek:
            return conn.peek(bufsize)
        data = conn.read(bufsize, host.now())
        if self.recv_autotune and data:
            self._autotune_recv(host, conn, len(data))
        self._flush(host)
        if conn.readable_bytes() == 0 and not conn.at_eof():
            self.adjust_status(host, 0, S_READABLE)
        return data

    def shutdown(self, host, how: str = "wr") -> None:
        if self.conn is not None and "w" in how:
            self.conn.close(host.now())
            self._flush(host)

    def close(self, host) -> None:
        if self.listening:
            self.listening = False  # in-flight children abort on completion
            for child in self._accept_q:
                child.close(host)
                from shadow_tpu_torch.utils.object_counter import mark_dealloc
                mark_dealloc(child)
                # Accounting done here; the eventual teardown (once the
                # FIN exchange completes) must not mark a second time.
                child._delivered = True
            self._accept_q.clear()
            self._teardown(host)
            return
        if self.conn is None:
            # Bound but never connected: release the port immediately.
            self._teardown(host)
            return
        if self.conn.state not in (tcpc.CLOSED, tcpc.TIME_WAIT):
            self.conn.close(host.now())
            self._flush(host)
        # The association stays alive until the connection fully closes
        # (TIME_WAIT etc.); _maybe_teardown reaps it from the timer path.
        self._maybe_teardown(host)
        self.adjust_status(host, S_CLOSED, S_ACTIVE)

    def _teardown(self, host) -> None:
        # Fabric-observatory flow lifecycle: teardown is the one event
        # after which the association walk can no longer find this
        # connection, so its FCT record is logged here (netplane.cpp
        # tcp_teardown twin).  Still-associated flows are swept when
        # the artifact is written; dataless flows leave no record.
        if self._ifaces and self.conn is not None \
                and self.local is not None and self.peer is not None:
            from shadow_tpu_torch.trace.fabricstat import flow_row
            row = flow_row(host.id, self.local[1], self.peer[1],
                           self.peer[0], self.conn)
            if row is not None:
                host.fct_log.append(row)
        for iface in self._ifaces:
            if self.local is not None:
                if self.peer is not None:
                    iface.disassociate(self.protocol, self.local[1],
                                       self.peer[0], self.peer[1])
                else:
                    iface.disassociate(self.protocol, self.local[1])
        self._ifaces = []
        self.adjust_status(host, S_CLOSED, S_ACTIVE | S_READABLE | S_WRITABLE)
        if self._listener is not None and not self._delivered \
                and self not in self._listener._accept_q:
            # Pre-accept child dying (listener closed mid-handshake,
            # RST in SYN_RCVD): the app never owned it and never will,
            # so this teardown IS its deallocation.  A child still in
            # the accept queue can yet reach the app via accept() — its
            # lifecycle then ends at the fd table like any other fd.
            from shadow_tpu_torch.utils.object_counter import mark_dealloc
            mark_dealloc(self)

    def _maybe_teardown(self, host) -> None:
        if self.conn is not None and self.conn.state == tcpc.CLOSED \
                and self._ifaces:
            self._teardown(host)

    # ------------------------------------------------------------------
    # Interface protocol (egress)
    # ------------------------------------------------------------------

    def peek_next_packet_priority(self, iface):
        q = self._out_packets[iface.name]
        return q[0].priority if q else None

    def pull_out_packet(self, host, iface):
        q = self._out_packets[iface.name]
        return q.popleft() if q else None

    # ------------------------------------------------------------------
    # Interface protocol (ingress)
    # ------------------------------------------------------------------

    def push_in_packet(self, host, packet) -> bool:
        if self.listening:
            return self._listener_push(host, packet)
        conn = self.conn
        if conn is None:
            host.trace_drop(packet, "tcp-closed")
            return False
        reasm0, trunc0 = conn.reasm_discards, conn.rcvwin_trunc
        conn.on_packet(packet.tcp, packet.payload, host.now(),
                       ecn=packet.ecn)
        # Sim-netstat receiver discards (netplane.cpp tcp_push_in
        # twin): fold the per-packet delta into the host's drop-cause
        # counters — the connection has no host backref.
        host.drop_causes[TEL_REASM_FULL] += conn.reasm_discards - reasm0
        host.drop_causes[TEL_RECVWIN_TRUNC] += \
            conn.rcvwin_trunc - trunc0
        if self.send_autotune and conn.srtt > 0:
            # ACK processing updated cwnd/RTT: grow the send buffer to
            # keep the congestion window fed (tcp.c autotune-on-ack).
            self._autotune_send(host, conn)
        self._flush(host)
        self._update_status(host)
        self._maybe_child_established(host)
        self._maybe_teardown(host)
        return True

    def _listener_push(self, host, packet) -> bool:
        hdr = packet.tcp
        if not (hdr.flags & tcpc.TcpFlags.SYN) or (hdr.flags &
                                                   tcpc.TcpFlags.ACK):
            # Stray segment for a dead connection; traced so every packet
            # reconciles to exactly one RCV or DRP line.
            host.trace_drop(packet, "tcp-stray")
            return False
        if len(self._accept_q) >= self._backlog:
            host.trace_drop(packet, "accept-backlog-full")
            return False
        # Spawn a child socket bound to the specific 4-tuple.
        child = TcpSocket(host, self._send_buf_max, self._recv_buf_max,
                          send_autotune=self.send_autotune,
                          recv_autotune=self.recv_autotune)
        child.local = (packet.dst_ip, packet.dst_port)
        child.peer = (packet.src_ip, packet.src_port)
        child._listener = self
        iface = host.lo if packet.dst_ip == LOCALHOST_IP else host.eth0
        child._iface = iface
        try:
            iface.associate(child, pkt.PROTO_TCP, packet.dst_port,
                            packet.src_ip, packet.src_port)
        except OSError:
            host.trace_drop(packet, "tcp-dup-syn")
            return False  # duplicate SYN for an existing child
        child._ifaces = [iface]
        child.conn = tcpc.TcpConnection(
            iss=host.rng.next_u32(), recv_buf_max=self._recv_buf_max,
            send_buf_max=self._send_buf_max,
            congestion=self._tcp_cc, ecn=self._tcp_ecn,
            window_ceiling=(tcpc.RMEM_CEILING if self.recv_autotune
                            else None))
        child.nodelay = self.nodelay
        child.conn.nodelay = self.nodelay
        child.conn.accept_syn(hdr, host.now())
        child._flush(host)
        return True

    def _maybe_child_established(self, host) -> None:
        if (self._listener is not None and not self._accept_queued
                and self.conn.state == tcpc.ESTABLISHED):
            self._accept_queued = True
            listener = self._listener
            if not listener.listening:
                # Listener closed while our SYN-ACK was in flight: the
                # peer must see a RST, not a half-open black hole.
                self.conn.abort(host.now())
                self._flush(host)
                self._teardown(host)
                return
            listener._accept_q.append(self)
            listener.adjust_status(host, S_READABLE, 0)

    # ------------------------------------------------------------------
    # Egress drain + timers
    # ------------------------------------------------------------------

    @staticmethod
    def _max_mem(host, rtt_ns: int, is_recv: bool) -> int:
        """BDP-derived ceiling, clamped to [X, 10X] of the Linux-default
        sysctl max (tcp.c _tcp_computeMaxRMEM/WMEM)."""
        bw_bits = host.bw_down_bits if is_recv else host.bw_up_bits
        mem = bw_bits * rtt_ns // (8 * 10**9)
        base = RMEM_MAX if is_recv else WMEM_MAX
        return min(max(mem, base), base * 10)

    def _autotune_recv(self, host, conn, bytes_copied: int) -> None:
        """Receiver-side DRS (tcp.c _tcp_autotuneReceiveBuffer): track
        bytes the app drained per sRTT window; advertise space for
        twice that, grow-only, BDP-capped."""
        self._at_bytes_copied += bytes_copied
        space = 2 * self._at_bytes_copied
        if space > self._at_space:
            self._at_space = space
        cur = conn.recv_buf_max
        if self._at_space > cur:
            new = min(self._at_space, self._max_mem(host, conn.srtt, True))
            if new > cur:
                conn.recv_buf_max = new
        now = host.now()
        if self._at_last_adjust == 0:
            self._at_last_adjust = now
        elif conn.srtt > 0 and now - self._at_last_adjust > conn.srtt:
            self._at_last_adjust = now
            self._at_bytes_copied = 0

    def _autotune_send(self, host, conn) -> None:
        """Sender side (tcp.c _tcp_autotuneSendBuffer): room for twice
        the congestion window's worth of the kernel's per-segment
        overhead estimate, grow-only, BDP-capped."""
        demanded = max(1, conn.cwnd // max(conn.eff_mss, 1))
        new = min(2404 * 2 * demanded,
                  self._max_mem(host, conn.srtt, False))
        if new > conn.send_buf_max:
            conn.send_buf_max = new

    def _flush(self, host) -> None:
        conn = self.conn
        if conn is None:
            return
        emitted = False
        iface = self._iface
        while conn.outbox:
            hdr, payload = conn.outbox.popleft()
            seq = host.next_packet_seq()
            p = pkt.Packet(host.id, seq, pkt.PROTO_TCP,
                           self.local[0] if self.local[0] != INADDR_ANY
                           else iface.ip,
                           self.local[1], self.peer[0], self.peer[1],
                           payload=payload, tcp=hdr)
            p.priority = seq
            # ECN-capable transport: data segments carry ECT(0) so a
            # congested queue can mark instead of drop; control
            # segments stay not-ECT (RFC 3168 6.1.1 + the empty-
            # control loss exemption's sibling rule).
            if conn.ecn_active and payload:
                p.ecn = pkt.ECN_ECT0
            self._out_packets[iface.name].append(p)
            emitted = True
        if emitted:
            iface.notify_socket_has_packets(host, self)
        self._arm_timer(host)
        self._update_status(host)

    def _update_status(self, host) -> None:
        conn = self.conn
        if conn is None:
            return
        set_mask = 0
        clear_mask = 0
        if conn.readable_bytes() > 0 or conn.at_eof() or conn.error:
            set_mask |= S_READABLE
        else:
            clear_mask |= S_READABLE
        if conn.state in (tcpc.ESTABLISHED, tcpc.CLOSE_WAIT) \
                and conn.send_space() > 0:
            set_mask |= S_WRITABLE
        elif conn.state not in (tcpc.ESTABLISHED, tcpc.CLOSE_WAIT):
            clear_mask |= S_WRITABLE
        if conn.error or conn.state == tcpc.CLOSED:
            set_mask |= S_CLOSED
        self.adjust_status(host, set_mask, clear_mask & ~set_mask)

    def _arm_timer(self, host) -> None:
        conn = self.conn
        if conn is None:
            return
        deadline = conn.next_timer_expiry()
        if deadline is None or deadline == self._timer_deadline:
            return
        self._timer_deadline = deadline
        host.schedule_task_at(deadline, TaskRef("tcp-timer", self._on_timer))

    def _on_timer(self, host) -> None:
        conn = self.conn
        if conn is None:
            return
        deadline = conn.next_timer_expiry()
        self._timer_deadline = None
        if deadline is not None and host.now() >= deadline:
            conn.on_timer(host.now())
            self._flush(host)
            self._update_status(host)
            self._maybe_teardown(host)
        else:
            self._arm_timer(host)
