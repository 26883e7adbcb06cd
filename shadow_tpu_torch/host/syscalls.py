"""Syscall dispatch of internal apps: the port's copy of
`shadow_tpu/host/syscalls.py`, object-path sockets only (the engine
hosts' Python-side sockets, `host/socket_native.py`, are ROADMAP A7b).

The single seam between applications and the simulated kernel.  Calls
are tuples `(name, *args)`; results are `("done", value)`, `("error",
OSError)`, or `("block", SyscallCondition)`.

Blocking protocol: on "block" the thread parks and, when the condition
fires, re-runs the same call with `restarted=True` so handlers like
nanosleep can tell a wakeup by timeout from the first entry.
"""

from __future__ import annotations

import errno

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.host.condition import SyscallCondition
from shadow_tpu_torch.host.socket_udp import UdpSocket
from shadow_tpu_torch.host.status import S_READABLE, S_WRITABLE
from shadow_tpu_torch.net import graph as netgraph
from shadow_tpu_torch.trace.events import SC_PARKED, SC_SERVICED


def _done(value=None):
    return ("done", value)


def _error(code, msg=""):
    return ("error", OSError(code, msg))


def _block(condition):
    return ("block", condition)


def _to_ip(host, addr) -> int:
    """Accept dotted-quad strings, hostnames, or ints."""
    if isinstance(addr, int):
        return addr
    try:
        return netgraph.parse_ip(addr)
    except ValueError:
        ip = host.dns.ip_for_name(addr)
        if ip is None:
            raise OSError(errno.ENOENT, f"unknown host {addr!r}")
        return ip


class SyscallHandler:
    """One instance per manager; stateless w.r.t. hosts (buffer-size
    defaults come from config, configuration.rs:348-592)."""

    def __init__(self, send_buf: int = 131_072, recv_buf: int = 174_760,
                 send_autotune: bool = True, recv_autotune: bool = True):
        self.send_buf = send_buf
        self.recv_buf = recv_buf
        self.send_autotune = send_autotune
        self.recv_autotune = recv_autotune

    def dispatch(self, host, process, thread, call, restarted: bool):
        name = call[0]
        handler = getattr(self, "sys_" + name, None)
        # Every dispatch is credited one disposition (the ENOSYS path
        # too, so the totals equal the dispatch count).
        if handler is None:
            result = _error(errno.ENOSYS, f"unknown syscall {name!r}")
        else:
            try:
                result = handler(host, process, thread, restarted,
                                 *call[1:])
            except BlockingIOError as e:
                # Raised by socket internals; translated to block/error
                # by the specific handlers: reaching here means
                # nonblocking mode.
                result = _error(e.errno or errno.EWOULDBLOCK, str(e))
            except OSError as e:
                result = _error(
                    e.errno if e.errno is not None else errno.EINVAL,
                    str(e))
        host.sc_disp[SC_PARKED if result[0] == "block"
                     else SC_SERVICED] += 1
        return result

    # ------------------------------------------------------------------
    # Sockets
    # ------------------------------------------------------------------

    def sys_socket(self, host, process, thread, restarted, kind: str,
                   nonblocking: bool = False):
        if host.plane is not None:
            raise NotImplementedError(
                "shadow_tpu_torch does not serve Python-side sockets on "
                "an engine host yet: ROADMAP A7b (host/socket_native.py)")
        if kind in ("udp", "dgram"):
            sock = UdpSocket(host, self.send_buf, self.recv_buf)
        elif kind in ("tcp", "stream"):
            from shadow_tpu_torch.host.socket_tcp import TcpSocket
            sock = TcpSocket(host, self.send_buf, self.recv_buf,
                             send_autotune=self.send_autotune,
                             recv_autotune=self.recv_autotune)
        else:
            return _error(errno.EINVAL, f"bad socket kind {kind!r}")
        sock.nonblocking = bool(nonblocking)
        return _done(process.fds.register(sock))

    def sys_bind(self, host, process, thread, restarted, fd, addr):
        sock = process.fds.get(fd)
        ip, port = addr
        sock.bind(host, _to_ip(host, ip), port)
        return _done(0)

    def sys_getsockname(self, host, process, thread, restarted, fd):
        sock = process.fds.get(fd)
        return _done(sock.local)

    def sys_getpeername(self, host, process, thread, restarted, fd):
        sock = process.fds.get(fd)
        if sock.peer is None:
            return _error(errno.ENOTCONN, "not connected")
        return _done(sock.peer)

    def sys_connect(self, host, process, thread, restarted, fd, addr):
        sock = process.fds.get(fd)
        ip, port = addr
        result = sock.connect(host, _to_ip(host, ip), port)
        if isinstance(result, SyscallCondition):  # TCP handshake in flight
            return _block(result)
        return _done(0)

    def sys_sendto(self, host, process, thread, restarted, fd, data,
                   addr=None):
        sock = process.fds.get(fd)
        if addr is not None:
            addr = (_to_ip(host, addr[0]), addr[1])
        try:
            return _done(sock.sendto(host, data, addr))
        except BlockingIOError:
            if sock.nonblocking:
                return _error(errno.EWOULDBLOCK, "send buffer full")
            return _block(SyscallCondition(file=sock, mask=S_WRITABLE))

    def sys_recvfrom(self, host, process, thread, restarted, fd,
                     bufsize=65536):
        sock = process.fds.get(fd)
        try:
            return _done(sock.recvfrom(host, bufsize))
        except BlockingIOError:
            if sock.nonblocking:
                return _error(errno.EWOULDBLOCK, "no data")
            return _block(SyscallCondition(file=sock, mask=S_READABLE))

    def sys_send(self, host, process, thread, restarted, fd, data):
        return self.sys_sendto(host, process, thread, restarted, fd, data,
                               None)

    def sys_recv(self, host, process, thread, restarted, fd, bufsize=65536):
        result = self.sys_recvfrom(host, process, thread, restarted, fd,
                                   bufsize)
        if result[0] == "done":
            return _done(result[1][0])
        return result

    def sys_listen(self, host, process, thread, restarted, fd, backlog=128):
        sock = process.fds.get(fd)
        sock.listen(host, backlog)
        return _done(0)

    def sys_accept(self, host, process, thread, restarted, fd):
        from shadow_tpu_torch.host.status import S_SOCKET_ALLOWING_CONNECT
        sock = process.fds.get(fd)
        try:
            child = sock.accept(host)
        except BlockingIOError:
            if sock.nonblocking:
                return _error(errno.EWOULDBLOCK, "no pending connection")
            return _block(SyscallCondition(file=sock, mask=S_READABLE))
        return _done((process.fds.register(child), child.peer))

    def sys_close(self, host, process, thread, restarted, fd):
        process.fds.close_fd(host, fd)
        return _done(0)

    def sys_set_nonblocking(self, host, process, thread, restarted, fd,
                            enabled):
        process.fds.get(fd).nonblocking = bool(enabled)
        return _done(0)

    def sys_shutdown(self, host, process, thread, restarted, fd, how="wr"):
        sock = process.fds.get(fd)
        if hasattr(sock, "shutdown"):
            sock.shutdown(host, how)
        return _done(0)

    # ------------------------------------------------------------------
    # Time
    # ------------------------------------------------------------------

    def sys_clock_gettime(self, host, process, thread, restarted):
        return _done(simtime.emulated_from_sim(host.now()))

    def sys_sim_time(self, host, process, thread, restarted):
        return _done(host.now())

    def sys_nanosleep(self, host, process, thread, restarted, duration_ns):
        if restarted:
            cond = thread.last_condition
            if cond is not None and cond.timed_out:
                return _done(0)
        if duration_ns <= 0:
            return _done(0)
        return _block(SyscallCondition(
            timeout_at=host.now() + int(duration_ns)))

    # ------------------------------------------------------------------
    # Misc process-level
    # ------------------------------------------------------------------

    def sys_write(self, host, process, thread, restarted, fd, data):
        if isinstance(data, str):
            data = data.encode()
        if fd == 1:
            process.stdout += data
            return _done(len(data))
        if fd == 2:
            process.stderr += data
            return _done(len(data))
        f = process.fds.get(fd)
        if hasattr(f, "sendto"):
            return self.sys_sendto(host, process, thread, restarted, fd, data)
        return _error(errno.EBADF, "write: unsupported fd")

    def sys_getpid(self, host, process, thread, restarted):
        return _done(process.pid)

    def sys_gethostname(self, host, process, thread, restarted):
        return _done(host.name)

    def sys_getrandom(self, host, process, thread, restarted, n):
        return _done(host.rng.bytes(n))

    def sys_resolve(self, host, process, thread, restarted, name):
        """getaddrinfo-equivalent over the simulated DNS."""
        ip = host.dns.ip_for_name(name)
        if ip is None:
            return _error(errno.ENOENT, f"unknown host {name!r}")
        return _done(ip)

    def sys_spawn_thread(self, host, process, thread, restarted, gen_factory):
        """Internal-app thread creation (clone-lite): gen_factory() returns
        a new app generator run as a sibling thread."""
        t = process.spawn_thread(host, gen_factory())
        from shadow_tpu_torch.core.event import TaskRef
        host.schedule_task_at(host.now(), TaskRef("thread-start", t.resume))
        return _done(t.tid)

    def sys_exit(self, host, process, thread, restarted, code=0):
        return ("exit", int(code))
