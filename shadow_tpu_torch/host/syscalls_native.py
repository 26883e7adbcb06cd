"""Linux x86-64 ABI syscall dispatch for managed (real-binary) processes.

The manager-side half of the reference's ~170-entry dispatch table
(src/main/host/syscall/handler/mod.rs:335-642 + the per-family handlers
in handler/*.rs), re-targeted at our simulated kernel objects.  Calls
arrive as raw (number, 6 registers); results use the same triad the
internal-app handler uses, plus "native":

  ("done", rv) | ("error", OSError) | ("block", condition)
  | ("native",)  — execute in the child through the trampoline
  | ("exit", code)

Fd-space policy (differs from the reference, which virtualizes every
fd): descriptors created by the simulated kernel live at EMU_FD_BASE
and above; anything below routes to the native kernel via DO_NATIVE.
File I/O therefore stays native (real fs inside the child), while
sockets, pipes, eventfds, timerfds, epoll, time and randomness are
simulated.  The base is set low enough that select(2)'s fd_set covers
emulated fds, high enough that native fds (lowest-free allocation)
rarely collide; a collision aborts the process rather than
misbehaving silently.
"""

from __future__ import annotations

import ctypes
import errno
import os as _os
import struct

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.host.condition import MultiSyscallCondition, SyscallCondition
from shadow_tpu_torch.host.epoll import (EPOLL_CTL_ADD, EPOLL_CTL_DEL,
                                   EPOLL_CTL_MOD, EpollFile)
from shadow_tpu_torch.host.files import EventFd, PipeEnd, TimerFd, make_pipe
from shadow_tpu_torch.host.socket_netlink import NetlinkSocket
from shadow_tpu_torch.host.socket_udp import UdpSocket
from shadow_tpu_torch.host.socket_unix import UnixSocket, unix_socketpair
from shadow_tpu_torch.host.status import (S_CLOSED, S_ERROR, S_READABLE,
                                    S_SOCKET_ALLOWING_CONNECT, S_WRITABLE)

EMU_FD_BASE = 400  # leaves room for select() fd_sets (FD_SETSIZE=1024)
# Upper edge of the emulated window: the shim relocates native fds
# that land in [EMU_FD_BASE, EMU_FD_LIMIT) to >= its move floor (which
# is always >= EMU_FD_LIMIT), so numbers past the limit are native
# again.  Emulated registration refuses to grow past the window
# (EMFILE) rather than alias relocated native fds.
EMU_FD_LIMIT = 2048

# pidfd_getfd(2): duplicate a managed process's native fd into the
# manager (allowed: every managed process is the manager's direct
# child, so Yama's descendant rule passes).  Python 3.12 exposes
# pidfd_open but not pidfd_getfd.
_SYS_pidfd_getfd = 438
_libc_syscall = ctypes.CDLL(None, use_errno=True).syscall


def _pidfd_pull(process, fd: int):
    """Duplicate `fd` out of `process` into the manager; returns the
    manager-side fd or None (bad fd / no pidfd support)."""
    pid = getattr(process, "native_pid", None)
    if pid is None:
        return None
    pidfd = getattr(process, "_pidfd", None)
    if pidfd is None:
        try:
            pidfd = _os.pidfd_open(pid)
        except OSError:
            return None
        process._pidfd = pidfd
    r = _libc_syscall(_SYS_pidfd_getfd, pidfd, fd, 0)
    return r if r >= 0 else None

# --- x86-64 syscall numbers (linux-api equivalents we dispatch on) ---
SYS = {
    0: "read", 1: "write", 3: "close", 5: "fstat", 7: "poll",
    8: "lseek", 13: "rt_sigaction",
    14: "rt_sigprocmask", 15: "rt_sigreturn",
    16: "ioctl", 19: "readv", 20: "writev", 22: "pipe", 23: "select",
    24: "sched_yield", 32: "dup", 33: "dup2", 34: "pause", 35: "nanosleep",
    36: "getitimer", 38: "setitimer",
    37: "alarm", 39: "getpid", 41: "socket", 42: "connect", 43: "accept",
    44: "sendto", 45: "recvfrom", 46: "sendmsg", 47: "recvmsg",
    48: "shutdown", 49: "bind", 50: "listen", 51: "getsockname",
    52: "getpeername", 53: "socketpair", 54: "setsockopt",
    55: "getsockopt", 56: "clone", 57: "fork", 58: "vfork", 59: "execve",
    60: "exit", 61: "wait4", 62: "kill", 63: "uname", 72: "fcntl",
    96: "gettimeofday", 98: "getrusage", 99: "sysinfo", 100: "times", 102: "getuid",
    104: "getgid", 107: "geteuid", 108: "getegid", 110: "getppid",
    109: "setpgid", 111: "getpgrp", 112: "setsid", 121: "getpgid",
    124: "getsid", 127: "rt_sigpending", 128: "rt_sigtimedwait",
    130: "rt_sigsuspend", 131: "sigaltstack", 157: "prctl",
    186: "gettid", 200: "tkill", 203: "sched_setaffinity",
    204: "sched_getaffinity", 201: "time", 202: "futex",
    234: "tgkill",
    213: "epoll_create", 218: "set_tid_address", 228: "clock_gettime",
    229: "clock_getres", 230: "clock_nanosleep", 231: "exit_group",
    232: "epoll_wait", 233: "epoll_ctl", 247: "waitid", 257: "openat",
    270: "pselect6", 271: "ppoll", 281: "epoll_pwait", 283: "timerfd_create",
    284: "eventfd", 286: "timerfd_settime", 287: "timerfd_gettime",
    262: "newfstatat", 282: "signalfd", 288: "accept4",
    289: "signalfd4", 290: "eventfd2", 291: "epoll_create1", 292: "dup3",
    299: "recvmmsg", 307: "sendmmsg",
    293: "pipe2", 302: "prlimit64", 317: "seccomp", 318: "getrandom",
    332: "statx", 435: "clone3", 436: "close_range",
    # Custom pseudo-syscalls (ref shadow_syscalls.rs): the shim's
    # preemption handler yields with this number.
    0x53544001: "shadow_yield",
}
_NUM = {name: num for num, name in SYS.items()}


def syscall_name(num: int) -> str:
    return SYS.get(num, f"syscall_{num}")


# --- constants -------------------------------------------------------
AF_UNIX = 1
AF_INET = 2
AF_NETLINK = 16
SOCK_STREAM = 1
SOCK_DGRAM = 2
SOCK_SEQPACKET = 5
SOCK_NONBLOCK = 0o4000
SOCK_CLOEXEC = 0o2000000

MSG_DONTWAIT = 0x40
MSG_PEEK = 0x02

POLLIN = 0x001
POLLPRI = 0x002
POLLOUT = 0x004
POLLERR = 0x008
POLLHUP = 0x010
POLLNVAL = 0x020

O_NONBLOCK = 0o4000
O_CLOEXEC = 0o2000000
O_WRONLY = 0o1
O_RDWR = 0o2
FD_CLOEXEC = 1

F_GETFD = 1
F_SETFD = 2
F_GETFL = 3
F_SETFL = 4
F_DUPFD = 0
F_DUPFD_CLOEXEC = 1030

FIONREAD = 0x541B
FIONBIO = 0x5421

SOL_SOCKET = 1
SO_REUSEADDR = 2
SO_ERROR = 4
SO_SNDBUF = 7
SO_RCVBUF = 8
SO_ACCEPTCONN = 30
SO_DOMAIN = 39
SO_TYPE = 3

TIMER_ABSTIME = 1
CLOCK_REALTIME = 0

SIGSYS = 31

EFD_SEMAPHORE = 1
EFD_NONBLOCK = O_NONBLOCK
TFD_NONBLOCK = O_NONBLOCK

_MAX_IO = 1 << 20  # clamp reads/writes we marshal through the manager

_TIMESPEC = struct.Struct("<qq")
_TIMEVAL = struct.Struct("<qq")
_POLLFD = struct.Struct("<ihh")
_EPOLL_EVENT = struct.Struct("<IQ")  # packed on x86-64
_IOVEC = struct.Struct("<QQ")


def _done(value=0):
    return ("done", int(value))


def _error(code):
    return ("error", OSError(code, ""))


def _native():
    return ("native",)


def _block(condition):
    return ("block", condition)


def _pack_sockaddr_in(ip: int, port: int) -> bytes:
    return struct.pack("<H", AF_INET) + struct.pack(">H", port) + \
        int(ip).to_bytes(4, "big") + b"\0" * 8


def _pack_siginfo(signo: int, si_code: int = 0, si_pid: int = 0,
                  si_status: int = 0) -> bytes:
    """x86-64 siginfo_t (128 bytes): si_signo@0, si_errno@4, si_code@8,
    si_pid@16, si_uid@20, si_status@24 (the CLD_* union arm)."""
    return struct.pack("<iiiiiii", signo, 0, si_code, 0, si_pid, 0,
                       si_status) + b"\0" * 100


def _unix_name(raw: bytes) -> str:
    """sockaddr_un -> namespace key ('@...' = abstract, '' = unnamed);
    `raw` is already trimmed to addrlen, which delimits abstract names."""
    path = raw[2:]
    if not path:
        return ""
    if path[0] == 0:
        return "@" + path[1:].rstrip(b"\0").decode(errors="surrogateescape")
    return path.split(b"\0", 1)[0].decode(errors="surrogateescape")


def _pack_sockaddr_un(name) -> bytes:
    if not name:
        return struct.pack("<H", AF_UNIX)
    if name.startswith("@"):
        return struct.pack("<H", AF_UNIX) + b"\0" + \
            name[1:].encode(errors="surrogateescape")
    return struct.pack("<H", AF_UNIX) + \
        name.encode(errors="surrogateescape") + b"\0"


def _write_addr(process, addr_ptr, len_ptr, sa) -> None:
    """Write a sockaddr clamped to the caller's buffer length (the
    kernel truncates; sockaddr_un is variable-length so an unclamped
    write could clobber plugin memory past a short buffer)."""
    if not addr_ptr or sa is None:
        return
    if len_ptr:
        want = struct.unpack("<I", process.mem.read(len_ptr, 4))[0]
        process.mem.write(addr_ptr, sa[:want])
        process.mem.write(len_ptr, struct.pack("<I", len(sa)))
    else:
        process.mem.write(addr_ptr, sa)


def _pack_peer_addr(peer):
    """Family-aware source-address rendering for recvfrom/recvmsg."""
    if peer is None:
        return None
    if isinstance(peer, str):
        return _pack_sockaddr_un(peer)
    if isinstance(peer, tuple) and peer and peer[0] == "netlink":
        return struct.pack("<HHII", AF_NETLINK, 0, 0, 0)
    if isinstance(peer, tuple) and len(peer) == 2:
        return _pack_sockaddr_in(*peer)
    return None


def _unpack_sockaddr_in(raw: bytes):
    if len(raw) < 8:
        raise OSError(errno.EINVAL, "short sockaddr")
    family = struct.unpack_from("<H", raw, 0)[0]
    if family != AF_INET:
        raise OSError(errno.EAFNOSUPPORT, f"family {family}")
    port = struct.unpack_from(">H", raw, 2)[0]
    ip = int.from_bytes(raw[4:8], "big")
    return ip, port


class NativeSyscallHandler:
    """One per manager (like the internal-app SyscallHandler)."""

    def __init__(self, send_buf: int = 131_072, recv_buf: int = 174_760,
                 send_autotune: bool = True, recv_autotune: bool = True):
        self.send_buf = send_buf
        self.recv_buf = recv_buf
        self.send_autotune = send_autotune
        self.recv_autotune = recv_autotune

    # ------------------------------------------------------------------

    def dispatch(self, host, process, thread, num: int, args,
                 restarted: bool):
        name = SYS.get(num)
        if name is None:
            return _native()
        method = getattr(self, "sys_" + name, None)
        if method is None:
            return _native()
        try:
            return method(host, process, thread, restarted, *args)
        except OSError as e:
            return _error(e.errno if e.errno else errno.EINVAL)

    # -- fd helpers ----------------------------------------------------

    @staticmethod
    def _is_emu(process, fd: int) -> bool:
        if EMU_FD_BASE <= fd < EMU_FD_LIMIT:
            return True
        # Low emulated fds: an emulated object dup2'd onto a native fd
        # number (shells/git redirect emulated pipes onto the child's
        # stdio before exec).
        low = getattr(process, "fds_low", None)
        return low is not None and low.get_opt(fd) is not None

    @staticmethod
    def _emu(process, fd: int):
        if fd < EMU_FD_BASE:
            low = getattr(process, "fds_low", None)
            obj = low.get_opt(fd) if low is not None else None
            if obj is None:
                raise OSError(errno.EBADF, "bad low emulated fd")
            return obj
        return process.fds.get(fd - EMU_FD_BASE)

    @staticmethod
    def _register(process, obj, cloexec: bool = False) -> int:
        fd = process.fds.register(obj, cloexec=cloexec) + EMU_FD_BASE
        if fd >= EMU_FD_LIMIT:
            # Window exhausted: unregister and refuse like a full
            # kernel fd table (aliasing a relocated native fd would
            # corrupt dispatch).
            try:
                process.fds.close_fd(None, fd - EMU_FD_BASE)
            except Exception:
                pass
            raise OSError(errno.EMFILE, "emulated fd window exhausted")
        return fd

    # ------------------------------------------------------------------
    # Sockets
    # ------------------------------------------------------------------

    def sys_socket(self, host, process, thread, restarted, domain, type_,
                   protocol, *_):
        domain &= 0xffffffff
        base_type = type_ & 0xff
        cloexec = bool(type_ & SOCK_CLOEXEC)
        if domain == AF_UNIX and base_type in (SOCK_STREAM, SOCK_DGRAM):
            # Emulated (socket/unix.rs parity): a native blocking unix
            # read would park the OS thread in the kernel and stall the
            # event pump on wall-clock time.  SEQPACKET is refused (a
            # stream emulation would silently lose record boundaries).
            sock = UnixSocket(host, stream=base_type != SOCK_DGRAM)
            sock.nonblocking = bool(type_ & SOCK_NONBLOCK)
            return _done(self._register(process, sock, cloexec=cloexec))
        if domain == AF_UNIX:
            # SEQPACKET etc.: refuse rather than fall through to a
            # native socket (blocking hazard + wrong namespace).
            return _error(errno.ESOCKTNOSUPPORT)
        if domain == AF_NETLINK:
            if protocol != 0:  # only NETLINK_ROUTE is modeled
                return _error(errno.EPROTONOSUPPORT)
            sock = NetlinkSocket(host)
            sock.nonblocking = bool(type_ & SOCK_NONBLOCK)
            return _done(self._register(process, sock, cloexec=cloexec))
        if domain != AF_INET or base_type not in (SOCK_STREAM, SOCK_DGRAM):
            return _native()
        native = host.plane is not None
        if base_type == SOCK_DGRAM:
            if native:
                from shadow_tpu_torch.host.socket_native import \
                    UdpSocket as NativeUdp
                sock = NativeUdp(host, self.send_buf, self.recv_buf)
            else:
                sock = UdpSocket(host, self.send_buf, self.recv_buf)
        elif native:
            from shadow_tpu_torch.host.socket_native import \
                TcpSocket as NativeTcp
            sock = NativeTcp(host, self.send_buf, self.recv_buf,
                             send_autotune=self.send_autotune,
                             recv_autotune=self.recv_autotune)
        else:
            from shadow_tpu_torch.host.socket_tcp import TcpSocket
            sock = TcpSocket(host, self.send_buf, self.recv_buf,
                             send_autotune=self.send_autotune,
                             recv_autotune=self.recv_autotune)
        sock.nonblocking = bool(type_ & SOCK_NONBLOCK)
        return _done(self._register(process, sock,
                                    cloexec=bool(type_ & SOCK_CLOEXEC)))

    def sys_bind(self, host, process, thread, restarted, fd, addr_ptr,
                 addrlen, *_):
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        raw = process.mem.read(addr_ptr, min(addrlen, 128))
        if isinstance(sock, UnixSocket):
            sock.bind(host, _unix_name(raw))
            return _done(0)
        if isinstance(sock, NetlinkSocket):
            nl_pid = struct.unpack_from("<I", raw, 4)[0] \
                if len(raw) >= 8 else 0
            sock.bind(host, nl_pid)
            return _done(0)
        ip, port = _unpack_sockaddr_in(raw)
        sock.bind(host, ip, port)
        return _done(0)

    def sys_connect(self, host, process, thread, restarted, fd, addr_ptr,
                    addrlen, *_):
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        raw = process.mem.read(addr_ptr, min(addrlen, 128))
        if isinstance(sock, UnixSocket):
            try:
                sock.connect(host, _unix_name(raw))  # host-local
            except BlockingIOError as e:
                if sock.nonblocking:
                    return _error(errno.EAGAIN)
                # Blocking connect waits for accept-queue room.
                return _block(SyscallCondition(
                    file=e.listener, mask=S_SOCKET_ALLOWING_CONNECT))
            return _done(0)
        if isinstance(sock, NetlinkSocket):
            return _done(0)
        ip, port = _unpack_sockaddr_in(raw)
        # connect() is restart-safe: re-entry with the same args returns
        # 0 once established / raises the handshake error.
        result = sock.connect(host, ip, port)
        if isinstance(result, SyscallCondition):
            return _block(result)
        return _done(0)

    def sys_listen(self, host, process, thread, restarted, fd, backlog, *_):
        if not self._is_emu(process, fd):
            return _native()
        self._emu(process, fd).listen(host, backlog or 128)
        return _done(0)

    def _accept_common(self, host, process, fd, addr_ptr, len_ptr, flags):
        sock = self._emu(process, fd)
        try:
            child = sock.accept(host)
        except BlockingIOError:
            if sock.nonblocking:
                return _error(errno.EWOULDBLOCK)
            return _block(SyscallCondition(file=sock, mask=S_READABLE))
        child.nonblocking = bool(flags & SOCK_NONBLOCK)
        newfd = self._register(process, child,
                               cloexec=bool(flags & SOCK_CLOEXEC))
        if isinstance(child, UnixSocket):
            peer_name = child.peer.bound_name if child.peer else None
            _write_addr(process, addr_ptr, len_ptr,
                        _pack_sockaddr_un(peer_name or ""))
            return _done(newfd)
        if addr_ptr and child.peer is not None:
            sa = _pack_sockaddr_in(*child.peer)
            if len_ptr:
                want = struct.unpack(
                    "<I", process.mem.read(len_ptr, 4))[0]
                process.mem.write(addr_ptr, sa[:want])
                process.mem.write(len_ptr, struct.pack("<I", len(sa)))
            else:
                process.mem.write(addr_ptr, sa)
        return _done(newfd)

    def sys_accept(self, host, process, thread, restarted, fd, addr_ptr,
                   len_ptr, *_):
        if not self._is_emu(process, fd):
            return _native()
        return self._accept_common(host, process, fd, addr_ptr, len_ptr, 0)

    def sys_accept4(self, host, process, thread, restarted, fd, addr_ptr,
                    len_ptr, flags, *_):
        if not self._is_emu(process, fd):
            return _native()
        return self._accept_common(host, process, fd, addr_ptr, len_ptr,
                                   flags)

    def _sock_send(self, host, process, sock, data: bytes, dst, flags: int):
        """Uniform send: inet (dst = (ip, port)), unix (dst = name str),
        netlink (dst ignored)."""
        if getattr(sock, "protocol", None) == 17:  # UDP, either plane
            # Port-53 interception must also catch the connect()+send()
            # shape libc's resolver uses (dst comes from the socket
            # peer).
            effective_dst = dst if dst is not None \
                else getattr(sock, "peer", None)
            if effective_dst is not None and effective_dst[1] == 53:
                handled = self._try_answer_dns(host, sock, data,
                                               effective_dst)
                if handled is not None:
                    return handled
        try:
            n = sock.sendto(host, data, dst)
        except BlockingIOError:
            if sock.nonblocking or (flags & MSG_DONTWAIT):
                return _error(errno.EWOULDBLOCK)
            return _block(SyscallCondition(file=sock, mask=S_WRITABLE))
        return _done(n)

    def sys_sendto(self, host, process, thread, restarted, fd, buf_ptr,
                   length, flags, addr_ptr, addrlen):
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        data = process.mem.read(buf_ptr, min(length, _MAX_IO))
        if isinstance(sock, (UnixSocket, NetlinkSocket)):
            dest = None
            if addr_ptr and addrlen and isinstance(sock, UnixSocket):
                dest = _unix_name(
                    process.mem.read(addr_ptr, min(addrlen, 128)))
            return self._sock_send(host, process, sock, data, dest,
                                   flags)
        dst = None
        if addr_ptr and addrlen:
            dst = _unpack_sockaddr_in(
                process.mem.read(addr_ptr, min(addrlen, 128)))
        return self._sock_send(host, process, sock, data, dst, flags)

    def sys_recvfrom(self, host, process, thread, restarted, fd, buf_ptr,
                     length, flags, addr_ptr, len_ptr):
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        try:
            data, peer = self._sock_recv(host, sock, min(length, _MAX_IO),
                                         peek=bool(flags & MSG_PEEK))
        except BlockingIOError:
            if sock.nonblocking or (flags & MSG_DONTWAIT):
                return _error(errno.EWOULDBLOCK)
            return _block(SyscallCondition(file=sock, mask=S_READABLE))
        process.mem.write(buf_ptr, data)
        self._discard_ancillary(host, sock)
        _write_addr(process, addr_ptr, len_ptr, _pack_peer_addr(peer))
        return _done(len(data))

    @staticmethod
    def _try_answer_dns(host, sock, data: bytes, dst):
        """Port-53 interception: answer A queries from the sim DNS
        (net/dns_wire.py) by dropping the response straight into the
        socket's receive queue, as if the resolver replied instantly.
        Returns a dispatch result or None to let the datagram travel
        the simulated network normally."""
        from shadow_tpu_torch.net import dns_wire
        from shadow_tpu_torch.net import packet as pkt
        resp = dns_wire.answer_query(
            data, lambda name: host.dns.ip_for_name(name))
        if resp is None:
            return None
        if sock.local is None:
            sock.bind(host, 0, 0)  # INADDR_ANY, ephemeral
        if hasattr(sock, "push_reply"):  # native-plane UDP proxy
            sock.push_reply(host, resp, dst[0], 53)
            return _done(len(data))
        local_ip = sock.local[0] or host.ip  # == eth0.ip
        reply = pkt.Packet(host.id, host.next_packet_seq(), pkt.PROTO_UDP,
                           dst[0], 53, local_ip, sock.local[1],
                           payload=resp)
        sock.push_in_packet(host, reply)
        return _done(len(data))

    @staticmethod
    def _discard_ancillary(host, sock) -> None:
        """A plain recv/read consumed bytes carrying SCM_RIGHTS the
        caller gave no control buffer for: Linux closes those fds."""
        if isinstance(sock, UnixSocket):
            objs = sock.take_ancillary()
            if objs:
                from shadow_tpu_torch.host.descriptor import _decref
                for obj in objs:
                    _decref(obj, host)

    @staticmethod
    def _sock_recv(host, sock, bufsize: int, peek: bool = False):
        """Uniform recv across UDP (datagram+peer) and TCP (stream)."""
        result = sock.recvfrom(host, bufsize, peek=peek)
        if isinstance(result, tuple):
            return result
        return result, getattr(sock, "peer", None)

    def sys_sendmsg(self, host, process, thread, restarted, fd, msg_ptr,
                    flags, *_):
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        name_ptr, namelen, iov_ptr, iovlen = self._read_msghdr(process,
                                                               msg_ptr)
        data = self._gather_iov(process, iov_ptr, iovlen)
        if isinstance(sock, (UnixSocket, NetlinkSocket)):
            control_ptr, controllen = struct.unpack(
                "<QQ", process.mem.read(msg_ptr + 32, 16))
            anc = None
            if controllen and isinstance(sock, UnixSocket):
                anc = self._parse_scm_rights(process, control_ptr,
                                             controllen)
                if anc is None:
                    return _error(errno.EINVAL)
            dest = None
            if name_ptr and namelen and isinstance(sock, UnixSocket):
                dest = _unix_name(
                    process.mem.read(name_ptr, min(namelen, 128)))
            if anc:
                try:
                    n = sock.sendto(host, data, dest, anc=anc)
                except BlockingIOError:
                    from shadow_tpu_torch.host.descriptor import _decref
                    for obj in anc:
                        _decref(obj, host)
                    if sock.nonblocking or (flags & MSG_DONTWAIT):
                        return _error(errno.EWOULDBLOCK)
                    return _block(SyscallCondition(file=sock,
                                                   mask=S_WRITABLE))
                except OSError:
                    # EPIPE/ENOTCONN/...: the in-flight refs must not
                    # outlive the failed send.
                    from shadow_tpu_torch.host.descriptor import _decref
                    for obj in anc:
                        _decref(obj, host)
                    raise
                return _done(n)
            return self._sock_send(host, process, sock, data, dest,
                                   flags)
        dst = None
        if name_ptr and namelen:
            dst = _unpack_sockaddr_in(
                process.mem.read(name_ptr, min(namelen, 128)))
        return self._sock_send(host, process, sock, data, dst, flags)

    def sys_sendmmsg(self, host, process, thread, restarted, fd, vec_ptr,
                     vlen, flags, *_):
        """glibc's resolver sends the A and AAAA queries in one
        sendmmsg (res_send.c) — without this the port-53 interception
        never sees the queries.  mmsghdr = msghdr (56) + msg_len (4) +
        pad (4)."""
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        vlen = min(int(vlen), 64)
        sent = 0
        for i in range(vlen):
            msg_ptr = vec_ptr + i * 64
            name_ptr, namelen, iov_ptr, iovlen = self._read_msghdr(
                process, msg_ptr)
            data = self._gather_iov(process, iov_ptr, iovlen)
            dst = None
            if name_ptr and namelen:
                raw = process.mem.read(name_ptr, min(namelen, 128))
                # Same family split as sys_sendto/sys_sendmsg: a unix
                # dgram destination is a namespace key, not (ip, port).
                if isinstance(sock, UnixSocket):
                    dst = _unix_name(raw)
                else:
                    dst = _unpack_sockaddr_in(raw)
            result = self._sock_send(host, process, sock, data, dst,
                                     flags)
            if result[0] != "done":
                # Error/blocked mid-batch: report what already went out
                # (Linux semantics), else surface the first failure.
                return _done(sent) if sent else result
            process.mem.write(msg_ptr + 56,
                              struct.pack("<I", int(result[1])))
            sent += 1
        return _done(sent)

    def sys_recvmmsg(self, host, process, thread, restarted, fd, vec_ptr,
                     vlen, flags, timeout_ptr, *_):
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        vlen = min(int(vlen), 64)
        got = 0
        for i in range(vlen):
            msg_ptr = vec_ptr + i * 64
            name_ptr, _namelen, iov_ptr, iovlen = self._read_msghdr(
                process, msg_ptr)
            total = sum(l for _p, l in self._iovecs(process, iov_ptr,
                                                    iovlen))
            if got and isinstance(sock, UnixSocket) \
                    and sock.next_read_has_native_fds():
                # A native-fd message must head its own batch (one
                # cmsg transfer dance per syscall): stop here, the
                # next recvmmsg/recvmsg delivers it with the fds
                # intact.  Linux legally returns short batches.
                return _done(got)
            try:
                data, peer = self._sock_recv(host, sock,
                                             min(total, _MAX_IO),
                                             peek=bool(flags & MSG_PEEK))
            except BlockingIOError:
                if got:
                    return _done(got)
                if sock.nonblocking or (flags & MSG_DONTWAIT) \
                        or (restarted and timeout_ptr):
                    # restarted with a timeout armed = the condition
                    # fired; no data now means the timeout won.  With a
                    # NULL timeout a spurious wake just re-blocks.
                    return _error(errno.EWOULDBLOCK)
                timeout_at = None
                if timeout_ptr:
                    sec, nsec = _TIMESPEC.unpack(
                        process.mem.read(timeout_ptr, 16))
                    timeout_at = host.now() + sec * 10**9 + nsec
                return _block(SyscallCondition(file=sock,
                                               mask=S_READABLE,
                                               timeout_at=timeout_at))
            self._scatter_iov(process, iov_ptr, iovlen, data)
            xfer = None
            if isinstance(sock, UnixSocket):
                # recvmmsg is recvmsg in a loop: ancillary delivers per
                # message through the same path.  Native fds are only
                # possible on the batch's FIRST message (the guard
                # above stops before consuming one later).
                objs = sock.take_ancillary()
                if objs:
                    xfer = self._deliver_scm_rights(host, process,
                                                    msg_ptr, objs,
                                                    allow_native=(got
                                                                  == 0))
                else:
                    process.mem.write(msg_ptr + 40,
                                      struct.pack("<Q", 0))
                    process.mem.write(msg_ptr + 48,
                                      struct.pack("<i", 0))
            if name_ptr:
                sa = _pack_peer_addr(peer)
                if sa is not None:
                    process.mem.write(name_ptr, sa[:_namelen])
                    process.mem.write(msg_ptr + 8,
                                      struct.pack("<I", len(sa)))
            process.mem.write(msg_ptr + 56,
                              struct.pack("<I", len(data)))
            got += 1
            if xfer is not None:
                # Close the batch at 1: the transfer dance patches this
                # message's cmsg placeholders after the syscall result.
                return ("done_fdxfer", got) + xfer[1:]
        return _done(got)

    def _parse_scm_rights(self, process, control_ptr, controllen):
        """cmsghdr walk: returns the transferred file objects (each
        incref'd for the in-flight reference), or None on EINVAL.
        Emulated fds resolve to their table objects; NATIVE fds are
        pulled out of the sender with pidfd_getfd and ride the queue
        as NativeFdRef wrappers (ref: socket/unix.rs fd passing)."""
        from shadow_tpu_torch.host.descriptor import NativeFdRef, _incref
        SOL_SOCKET_C, SCM_RIGHTS = 1, 1
        if controllen > 4096:  # > SCM_MAX_FD-worth: refuse, don't clip
            return None
        raw = process.mem.read(control_ptr, controllen)
        objs = []

        def bail():
            from shadow_tpu_torch.utils.object_counter import mark_dealloc
            for o in objs:
                if isinstance(o, NativeFdRef):
                    o.close(None)
                    mark_dealloc(o)
            return None

        off = 0
        while off + 16 <= len(raw):
            clen, level, ctype = struct.unpack_from("<QII", raw, off)
            if clen < 16 or off + clen > len(raw) + 7:
                return bail()
            if level != SOL_SOCKET_C or ctype != SCM_RIGHTS:
                return bail()
            nfds = (min(clen, len(raw) - off) - 16) // 4
            for i in range(nfds):
                (fd,) = struct.unpack_from("<i", raw, off + 16 + 4 * i)
                if self._is_emu(process, fd):
                    try:
                        objs.append(self._emu(process, fd))
                    except OSError:
                        return bail()
                else:
                    mgr_fd = _pidfd_pull(process, fd)
                    if mgr_fd is None:
                        return bail()
                    objs.append(NativeFdRef(mgr_fd))
            off += (clen + 7) & ~7  # CMSG_ALIGN
        for obj in objs:
            _incref(obj)
        return objs

    def _deliver_scm_rights(self, host, process, msg_ptr, objs,
                            allow_native: bool = True):
        """Register the transferred objects as fresh fds in the
        receiver and write one SCM_RIGHTS cmsg; discards (like Linux
        closing unclaimed fds) when no/too-small control buffer, with
        MSG_CTRUNC in msg_flags.

        Emulated objects register into the table directly.  NativeFdRef
        objects cannot: the real fd must materialize inside the
        receiving process, so their cmsg slots get a -1 placeholder and
        the return value is ("fdxfer", pairs, refs, msg_ptr) — the
        ManagedThread then ships the real fds over the process's
        transfer socket and the shim patches the placeholders (pairs =
        [(app_addr_of_slot, mgr_fd)]).  Returns None when no transfer
        is needed."""
        from shadow_tpu_torch.host.descriptor import NativeFdRef, _decref
        MSG_CTRUNC = 0x8
        control_ptr, controllen = struct.unpack(
            "<QQ", process.mem.read(msg_ptr + 32, 16))
        nfit = 0
        if control_ptr and controllen >= 20:
            nfit = min(len(objs), (controllen - 16) // 4)
        # Linux delivers as many fds as fit and truncates the rest.
        truncated = nfit < len(objs)
        for obj in objs[nfit:]:
            _decref(obj, host)
        if nfit == 0:
            process.mem.write(msg_ptr + 48,
                              struct.pack("<i", MSG_CTRUNC))
            process.mem.write(msg_ptr + 40, struct.pack("<Q", 0))
            return None
        # The transfer dance carries at most the shim's XFER_MAX_FDS in
        # one datagram; beyond that, surplus native fds truncate (the
        # kernel's own ceiling is SCM_MAX_FD=253 per message).
        XFER_MAX_FDS = 64
        fds = []     # fd numbers written into the cmsg (compacted)
        emu_fds = [] # the emulated subset, for failure-path rewrite
        pairs = []   # (app address of the int slot, manager-side fd)
        refs = []    # NativeFdRefs to release after the transfer
        for obj in objs[:nfit]:
            if isinstance(obj, NativeFdRef):
                if not allow_native or len(pairs) >= XFER_MAX_FDS:
                    # recvmmsg batch path / over-cap: no transfer
                    # available; drop the fd like a truncation (Linux
                    # shortens the array — never delivers a hole).
                    _decref(obj, host)
                    truncated = True
                    continue
                # Slot index = position in the COMPACTED array.
                pairs.append((control_ptr + 16 + 4 * len(fds),
                              obj.mgr_fd))
                refs.append(obj)
                fds.append(-1)  # patched by the shim after transfer
            else:
                fds.append(self._register(process, obj))
                emu_fds.append(fds[-1])
                _decref(obj, host)  # table registration took its own ref
        if not fds:
            process.mem.write(msg_ptr + 48,
                              struct.pack("<i", MSG_CTRUNC))
            process.mem.write(msg_ptr + 40, struct.pack("<Q", 0))
            return None
        cmsg = struct.pack("<QII", 16 + 4 * len(fds), 1, 1)
        cmsg += b"".join(struct.pack("<i", fd) for fd in fds)
        process.mem.write(control_ptr, cmsg)
        process.mem.write(msg_ptr + 40, struct.pack("<Q", len(cmsg)))
        process.mem.write(msg_ptr + 48, struct.pack(
            "<i", MSG_CTRUNC if truncated else 0))
        if pairs:
            return ("fdxfer", pairs, refs, msg_ptr, control_ptr,
                    emu_fds)
        return None

    def sys_recvmsg(self, host, process, thread, restarted, fd, msg_ptr,
                    flags, *_):
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        name_ptr, _namelen, iov_ptr, iovlen = self._read_msghdr(process,
                                                                msg_ptr)
        total = sum(l for _p, l in self._iovecs(process, iov_ptr, iovlen))
        try:
            data, peer = self._sock_recv(host, sock, min(total, _MAX_IO),
                                         peek=bool(flags & MSG_PEEK))
        except BlockingIOError:
            if sock.nonblocking or (flags & MSG_DONTWAIT):
                return _error(errno.EWOULDBLOCK)
            return _block(SyscallCondition(file=sock, mask=S_READABLE))
        self._scatter_iov(process, iov_ptr, iovlen, data)
        if name_ptr:
            sa = _pack_peer_addr(peer)
            if sa is not None:
                process.mem.write(name_ptr, sa[:_namelen])
                process.mem.write(msg_ptr + 8,
                                  struct.pack("<I", len(sa)))
        if isinstance(sock, UnixSocket):
            objs = sock.take_ancillary()
            if objs:
                xfer = self._deliver_scm_rights(host, process, msg_ptr,
                                                objs)
                if xfer is not None:
                    # Native fds ride the transfer socket: the service
                    # loop runs the shim-side collection dance before
                    # completing the syscall.
                    return ("done_fdxfer", len(data)) + xfer[1:]
            else:
                # Linux rewrites controllen AND msg_flags every return;
                # a reused msghdr must not keep a stale MSG_CTRUNC.
                process.mem.write(msg_ptr + 40, struct.pack("<Q", 0))
                process.mem.write(msg_ptr + 48, struct.pack("<i", 0))
        return _done(len(data))

    @staticmethod
    def _read_msghdr(process, msg_ptr):
        raw = process.mem.read(msg_ptr, 56)
        name_ptr, namelen = struct.unpack_from("<QI", raw, 0)
        iov_ptr, iovlen = struct.unpack_from("<QQ", raw, 16)
        return name_ptr, namelen, iov_ptr, iovlen

    @staticmethod
    def _iovecs(process, iov_ptr, iovlen):
        iovlen = min(iovlen, 64)
        raw = process.mem.read(iov_ptr, 16 * iovlen) if iovlen else b""
        return [_IOVEC.unpack_from(raw, i * 16) for i in range(iovlen)]

    def _gather_iov(self, process, iov_ptr, iovlen) -> bytes:
        out = bytearray()
        for base, length in self._iovecs(process, iov_ptr, iovlen):
            if len(out) >= _MAX_IO:
                break
            out += process.mem.read(base, min(length, _MAX_IO - len(out)))
        return bytes(out)

    def _scatter_iov(self, process, iov_ptr, iovlen, data: bytes) -> int:
        off = 0
        for base, length in self._iovecs(process, iov_ptr, iovlen):
            if off >= len(data):
                break
            chunk = data[off:off + length]
            process.mem.write(base, chunk)
            off += len(chunk)
        return off

    def sys_getsockname(self, host, process, thread, restarted, fd,
                        addr_ptr, len_ptr, *_):
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        if isinstance(sock, UnixSocket):
            sa = _pack_sockaddr_un(sock.bound_name or "")
        elif isinstance(sock, NetlinkSocket):
            sa = struct.pack("<HHII", AF_NETLINK, 0, sock.nl_pid, 0)
        else:
            local = sock.local or (0, 0)
            ip = local[0]
            if ip == 0 and getattr(sock, "peer", None):
                ip = host.ip  # == eth0.ip; avoid the lazy plane build
            sa = _pack_sockaddr_in(ip, local[1])
        _write_addr(process, addr_ptr, len_ptr, sa)
        return _done(0)

    def sys_getpeername(self, host, process, thread, restarted, fd,
                        addr_ptr, len_ptr, *_):
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        if isinstance(sock, NetlinkSocket):
            sa = struct.pack("<HHII", AF_NETLINK, 0, 0, 0)  # the kernel
            _write_addr(process, addr_ptr, len_ptr, sa)
            return _done(0)
        if getattr(sock, "peer", None) is None:
            return _error(errno.ENOTCONN)
        if isinstance(sock, UnixSocket):
            sa = _pack_sockaddr_un(sock.peer.bound_name or "")
        else:
            sa = _pack_sockaddr_in(*sock.peer)
        _write_addr(process, addr_ptr, len_ptr, sa)
        return _done(0)

    def sys_setsockopt(self, host, process, thread, restarted, fd, level,
                       optname, optval, optlen, *_):
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        # TCP_NODELAY (IPPROTO_TCP=6, optname 1) reaches the connection's
        # Nagle switch; SO_REUSEADDR drives bind-time port semantics;
        # other options (buffer sizing hints...) are recorded-but-inert
        # — enough surface for common apps.
        if level == SOL_SOCKET and optname == SO_REUSEADDR and optlen >= 4:
            val = struct.unpack("<i", process.mem.read(optval, 4))[0]
            sock.reuseaddr = bool(val)
            return _done(0)
        if level == 6 and optname == 1 and optlen >= 4:
            val = struct.unpack("<i", process.mem.read(optval, 4))[0]
            if hasattr(sock, "set_nodelay"):  # native-plane proxy
                sock.set_nodelay(host, bool(val))
                return _done(0)
            sock.nodelay = bool(val)
            conn = getattr(sock, "conn", None)
            if conn is not None:
                conn.nodelay = bool(val)
                if conn.nodelay:
                    # Linux flushes Nagle-held data on TCP_NODELAY.
                    conn._push_data(host.now())
                    sock._flush(host)
        return _done(0)

    def sys_getsockopt(self, host, process, thread, restarted, fd, level,
                       optname, optval_ptr, optlen_ptr, *_):
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        value = 0
        if level == SOL_SOCKET:
            if optname == SO_ERROR:
                value = getattr(sock, "so_error", 0) or 0
                sock.so_error = 0
            elif optname == SO_REUSEADDR:
                value = 1 if getattr(sock, "reuseaddr", False) else 0
            elif optname == SO_SNDBUF:
                conn = getattr(sock, "conn", None)
                value = (conn.send_buf_max if conn is not None
                         else self.send_buf)
            elif optname == SO_RCVBUF:
                conn = getattr(sock, "conn", None)
                value = (conn.recv_buf_max if conn is not None
                         else self.recv_buf)
            elif optname == SO_TYPE:
                if isinstance(sock, UnixSocket):
                    value = (SOCK_STREAM if sock.stream else SOCK_DGRAM)
                elif isinstance(sock, NetlinkSocket):
                    value = SOCK_DGRAM
                else:
                    from shadow_tpu_torch.net.packet import PROTO_TCP
                    value = (SOCK_STREAM if sock.protocol == PROTO_TCP
                             else SOCK_DGRAM)
            elif optname == SO_DOMAIN:
                if isinstance(sock, UnixSocket):
                    value = AF_UNIX
                elif isinstance(sock, NetlinkSocket):
                    value = AF_NETLINK
                else:
                    value = AF_INET
            elif optname == SO_ACCEPTCONN:
                value = 1 if getattr(sock, "listening", False) else 0
        process.mem.write(optval_ptr, struct.pack("<i", value))
        if optlen_ptr:
            process.mem.write(optlen_ptr, struct.pack("<I", 4))
        return _done(0)

    def sys_shutdown(self, host, process, thread, restarted, fd, how, *_):
        if not self._is_emu(process, fd):
            return _native()
        sock = self._emu(process, fd)
        how_s = {0: "rd", 1: "wr", 2: "rdwr"}.get(how)
        if how_s is None:
            return _error(errno.EINVAL)
        if hasattr(sock, "shutdown"):
            sock.shutdown(host, how_s)
        return _done(0)

    def sys_socketpair(self, host, process, thread, restarted, domain,
                       type_, protocol, sv_ptr, *_):
        base_type = type_ & 0xff
        if domain != AF_UNIX or base_type not in (SOCK_STREAM, SOCK_DGRAM):
            return _error(errno.EOPNOTSUPP)
        a, b = unix_socketpair(host, stream=base_type != SOCK_DGRAM)
        a.nonblocking = b.nonblocking = bool(type_ & SOCK_NONBLOCK)
        cx = bool(type_ & SOCK_CLOEXEC)
        fd1 = self._register(process, a, cloexec=cx)
        fd2 = self._register(process, b, cloexec=cx)
        process.mem.write(sv_ptr, struct.pack("<ii", fd1, fd2))
        return _done(0)

    # ------------------------------------------------------------------
    # Generic fd I/O
    # ------------------------------------------------------------------

    def _file_read(self, host, process, file, n: int, thread=None):
        if isinstance(file, PipeEnd):
            return file.read_bytes(host, n)
        if isinstance(file, EventFd):
            if n < 8:
                raise OSError(errno.EINVAL, "eventfd read < 8 bytes")
            return struct.pack("<Q", file.read_value(host))
        if isinstance(file, TimerFd):
            if n < 8:
                raise OSError(errno.EINVAL, "timerfd read < 8 bytes")
            return struct.pack("<Q", file.read_expirations(host))
        from shadow_tpu_torch.host.files import SignalFd
        if isinstance(file, SignalFd):
            if n < 128:
                raise OSError(errno.EINVAL, "signalfd read < 128 bytes")
            return file.read_infos(host, process, thread, n // 128)
        data, _peer = self._sock_recv(host, file, n)
        self._discard_ancillary(host, file)
        return data

    def _file_write(self, host, process, file, data: bytes) -> int:
        if isinstance(file, PipeEnd):
            return file.write_bytes(host, data)
        if isinstance(file, EventFd):
            if len(data) < 8:
                raise OSError(errno.EINVAL, "eventfd write < 8 bytes")
            file.write_value(host, struct.unpack("<Q", data[:8])[0])
            return 8
        return file.sendto(host, data, None)

    def sys_read(self, host, process, thread, restarted, fd, buf_ptr,
                 count, *_):
        if not self._is_emu(process, fd):
            return _native()
        file = self._emu(process, fd)
        try:
            data = self._file_read(host, process, file,
                                   min(count, _MAX_IO), thread=thread)
        except BlockingIOError:
            if getattr(file, "nonblocking", False):
                return _error(errno.EWOULDBLOCK)
            return _block(SyscallCondition(file=file, mask=S_READABLE))
        process.mem.write(buf_ptr, data)
        return _done(len(data))

    def sys_write(self, host, process, thread, restarted, fd, buf_ptr,
                  count, *_):
        if not self._is_emu(process, fd):
            return _native()
        file = self._emu(process, fd)
        data = process.mem.read(buf_ptr, min(count, _MAX_IO))
        try:
            return _done(self._file_write(host, process, file, data))
        except BlockingIOError:
            if getattr(file, "nonblocking", False):
                return _error(errno.EWOULDBLOCK)
            return _block(SyscallCondition(file=file, mask=S_WRITABLE))

    def sys_readv(self, host, process, thread, restarted, fd, iov_ptr,
                  iovlen, *_):
        if not self._is_emu(process, fd):
            return _native()
        file = self._emu(process, fd)
        total = sum(l for _b, l in self._iovecs(process, iov_ptr, iovlen))
        try:
            data = self._file_read(host, process, file,
                                   min(total, _MAX_IO), thread=thread)
        except BlockingIOError:
            if getattr(file, "nonblocking", False):
                return _error(errno.EWOULDBLOCK)
            return _block(SyscallCondition(file=file, mask=S_READABLE))
        return _done(self._scatter_iov(process, iov_ptr, iovlen, data))

    def sys_writev(self, host, process, thread, restarted, fd, iov_ptr,
                   iovlen, *_):
        if not self._is_emu(process, fd):
            return _native()
        file = self._emu(process, fd)
        data = self._gather_iov(process, iov_ptr, iovlen)
        try:
            return _done(self._file_write(host, process, file, data))
        except BlockingIOError:
            if getattr(file, "nonblocking", False):
                return _error(errno.EWOULDBLOCK)
            return _block(SyscallCondition(file=file, mask=S_WRITABLE))

    def sys_close(self, host, process, thread, restarted, fd, *_):
        if not self._is_emu(process, fd):
            return _native()
        if fd < EMU_FD_BASE:
            close_kernel_side = self._native_fd_exists(process, fd)
            getattr(process, "fds_low").close_fd(host, fd)
            if close_kernel_side:
                return _native()  # close the shadowed kernel fd too
            # dup2 only registered the shadow; no kernel fd exists at
            # this number — succeed emulated rather than surface the
            # kernel's spurious EBADF.
            return _done(0)
        process.fds.close_fd(host, fd - EMU_FD_BASE)
        return _done(0)

    @staticmethod
    def _emu_stat_mode(f) -> int:
        from shadow_tpu_torch.host.files import EventFd, PipeEnd, TimerFd
        from shadow_tpu_torch.host.epoll import EpollFile
        S_IFIFO, S_IFSOCK = 0o010000, 0o140000
        if isinstance(f, PipeEnd):
            return S_IFIFO | 0o600
        from shadow_tpu_torch.host.files import SignalFd
        if isinstance(f, (EventFd, TimerFd, EpollFile, SignalFd)):
            return 0o600  # anon inodes: no file-type bits (like Linux)
        return S_IFSOCK | 0o777

    @staticmethod
    def _emu_ino(f, host) -> int:
        """Stable per-OBJECT inode: dup'd / SCM-transferred fds naming
        the same open file must compare st_ino-equal.  Allocated from a
        per-HOST counter (hosts are single-threaded, so assignment
        order — and with it every inode value — is deterministic even
        under the thread-pool schedulers)."""
        ino = getattr(f, "_emu_ino", None)
        if ino is None:
            nxt = getattr(host, "_emu_ino_next", 0x1000) + 1
            host._emu_ino_next = nxt
            ino = nxt
            f._emu_ino = ino
        return ino

    def _write_emu_stat(self, host, process, f, fd, stat_ptr) -> None:
        """x86-64 struct stat (144 bytes) for an emulated fd."""
        st = struct.pack(
            "<QQQIIIIQqqq",
            0x53,                 # st_dev
            self._emu_ino(f, host),  # st_ino: stable per open file
            1,                    # st_nlink
            self._emu_stat_mode(f), 1000, 1000, 0,  # mode, uid, gid, pad
            0,                    # st_rdev
            0, 4096, 0)           # size, blksize, blocks
        st += struct.pack("<qqqqqq", 0, 0, 0, 0, 0, 0)  # a/m/ctime
        process.mem.write(stat_ptr, st + b"\0" * (144 - len(st)))

    def sys_fstat(self, host, process, thread, restarted, fd, stat_ptr,
                  *_):
        """Apps fstat sockets/pipes to learn the file type; a native
        fstat on our fd numbers would be EBADF."""
        if not self._is_emu(process, fd):
            return _native()
        self._write_emu_stat(host, process, self._emu(process, fd), fd,
                             stat_ptr)
        return _done(0)

    def sys_newfstatat(self, host, process, thread, restarted, dirfd,
                       path_ptr, stat_ptr, flags, *_):
        """glibc's fstat() is newfstatat(fd, "", buf, AT_EMPTY_PATH)
        on modern kernels — route the emulated-fd shape here, leave
        real path lookups native."""
        dirfd = _sext32(dirfd)
        if not self._is_emu(process, dirfd):
            return _native()
        path = process.mem.read_cstr(path_ptr, 256) if path_ptr else b""
        if path:
            return _error(errno.ENOTDIR)  # emulated fds aren't dirs
        self._write_emu_stat(host, process, self._emu(process, dirfd),
                             dirfd, stat_ptr)
        return _done(0)

    def sys_statx(self, host, process, thread, restarted, dirfd,
                  path_ptr, flags, mask, statx_ptr, *_):
        dirfd = _sext32(dirfd)
        if not self._is_emu(process, dirfd):
            return _native()
        path = process.mem.read_cstr(path_ptr, 256) if path_ptr else b""
        if path:
            return _error(errno.ENOTDIR)
        f = self._emu(process, dirfd)
        STATX_BASIC_STATS = 0x7ff
        # statx layout: mask(4) blksize(4) attributes(8) nlink(4)
        # uid(4) gid(4) mode(2) pad(2) ino(8) size(8) blocks(8)
        # attributes_mask(8); timestamps and dev fields stay zeroed.
        buf = struct.pack(
            "<IIQIIIHHQQQQ",
            STATX_BASIC_STATS, 4096, 0, 1, 1000, 1000,
            self._emu_stat_mode(f), 0, self._emu_ino(f, host), 0, 0, 0)
        process.mem.write(statx_ptr, buf + b"\0" * (256 - len(buf)))
        return _done(0)

    def sys_lseek(self, host, process, thread, restarted, fd, *_):
        if not self._is_emu(process, fd):
            return _native()
        return _error(errno.ESPIPE)  # sockets/pipes are not seekable

    def sys_close_range(self, host, process, thread, restarted, first,
                        last, flags, *_):
        """Close/mark the emulated fds in range, then run the native
        close_range too (DO_NATIVE) for the native portion — the two fd
        spaces are disjoint by construction (EMU_FD_BASE split)."""
        CLOSE_RANGE_UNSHARE = 2
        CLOSE_RANGE_CLOEXEC = 4
        if flags & ~(CLOSE_RANGE_UNSHARE | CLOSE_RANGE_CLOEXEC):
            # Validate BEFORE touching any fd (Linux returns EINVAL
            # with nothing closed).
            return _error(errno.EINVAL)
        if first > last:
            return _error(errno.EINVAL)
        if not (flags & CLOSE_RANGE_UNSHARE):
            # UNSHARE privatizes the caller's table before closing so
            # sibling threads keep their fds; our emulated table is
            # process-shared (CLONE_FILES threads), so the emulated
            # half is left untouched under UNSHARE (the native
            # syscall still unshares the native table).
            for fd in [f + EMU_FD_BASE for f in process.fds.open_fds()]:
                if first <= fd <= last:
                    if flags & CLOSE_RANGE_CLOEXEC:
                        process.fds.set_cloexec(fd - EMU_FD_BASE, True)
                    else:
                        process.fds.close_fd(host, fd - EMU_FD_BASE)
            low = getattr(process, "fds_low", None)
            if low is not None:
                for fd in list(low.open_fds()):
                    if first <= fd <= last:
                        if flags & CLOSE_RANGE_CLOEXEC:
                            low.set_cloexec(fd, True)
                        else:
                            low.close_fd(host, fd)
        return _native()

    def sys_dup(self, host, process, thread, restarted, fd, *_):
        if not self._is_emu(process, fd):
            return _native()
        return _done(self._register(process, self._emu(process, fd)))

    @staticmethod
    def _native_fd_exists(process, fd: int) -> bool:
        pid = getattr(process, "native_pid", None)
        if pid is None:
            return False
        return _os.path.exists(f"/proc/{pid}/fd/{fd}")

    @staticmethod
    def _low_table(process):
        low = getattr(process, "fds_low", None)
        if low is None:
            from shadow_tpu_torch.host.descriptor import DescriptorTable
            low = process.fds_low = DescriptorTable()
        return low

    def sys_dup2(self, host, process, thread, restarted, oldfd, newfd, *_,
                 cloexec: bool = False):
        if not self._is_emu(process, oldfd):
            # A native fd dup2'd over a low EMULATED slot restores the
            # native mapping: drop our shadow entry, let the kernel dup.
            # POSIX: a FAILED dup2 must leave newfd untouched — verify
            # the native oldfd exists before mutating the shadow.
            low = getattr(process, "fds_low", None)
            if low is not None and low.get_opt(newfd) is not None:
                if not self._native_fd_exists(process, oldfd):
                    return _error(errno.EBADF)
                low.close_fd(host, newfd)
            return _native()
        obj = self._emu(process, oldfd)  # validates oldfd (EBADF)
        if oldfd == newfd:
            return _done(newfd)  # Linux dup2(fd, fd) is a no-op
        if not self._is_emu(process, newfd) and newfd >= EMU_FD_BASE:
            return _error(errno.EINVAL)  # into the relocated-native zone
        if newfd < EMU_FD_BASE:
            # Emulated object onto a native fd number (stdio
            # redirection before exec — git/shell pipelines).  The
            # kernel-side fd keeps pointing wherever it did; every
            # emulated syscall on `newfd` now routes to `obj`.
            low = self._low_table(process)
            if low.get_opt(newfd) is not None:
                low.close_fd(host, newfd)
            low.register_at(newfd, obj, cloexec=cloexec)
            return _done(newfd)
        try:
            process.fds.close_fd(host, newfd - EMU_FD_BASE)
        except OSError:
            pass
        process.fds.register_at(newfd - EMU_FD_BASE, obj, cloexec=cloexec)
        return _done(newfd)

    def sys_dup3(self, host, process, thread, restarted, oldfd, newfd,
                 flags, *_):
        if oldfd == newfd:
            return _error(errno.EINVAL)  # dup3 requires distinct fds
        return self.sys_dup2(host, process, thread, restarted, oldfd,
                             newfd, cloexec=bool(flags & O_CLOEXEC))

    def sys_fcntl(self, host, process, thread, restarted, fd, cmd, arg, *_):
        if not self._is_emu(process, fd):
            return _native()
        file = self._emu(process, fd)
        table, slot = ((self._low_table(process), fd)
                       if fd < EMU_FD_BASE
                       else (process.fds, fd - EMU_FD_BASE))
        if cmd == F_GETFL:
            # Include the access mode: fdopen() validates it against
            # the requested stream mode (a write-side pipe reported as
            # O_RDONLY makes fdopen(fd, "w") fail EINVAL — git does
            # exactly this on its remote-helper pipes).
            if isinstance(file, PipeEnd):
                acc = O_WRONLY if file.is_writer else 0  # O_RDONLY
            else:
                acc = O_RDWR  # sockets, eventfds, timerfds, epoll
            return _done(acc | (O_NONBLOCK
                                if getattr(file, "nonblocking", False)
                                else 0))
        if cmd == F_SETFL:
            file.nonblocking = bool(arg & O_NONBLOCK)
            return _done(0)
        if cmd in (F_DUPFD, F_DUPFD_CLOEXEC):
            return _done(self._register(process, file,
                                        cloexec=cmd == F_DUPFD_CLOEXEC))
        if cmd == F_GETFD:
            return _done(FD_CLOEXEC if table.get_cloexec(slot) else 0)
        if cmd == F_SETFD:
            table.set_cloexec(slot, bool(arg & FD_CLOEXEC))
            return _done(0)
        return _error(errno.EINVAL)

    def sys_ioctl(self, host, process, thread, restarted, fd, req, argp, *_):
        if not self._is_emu(process, fd):
            return _native()
        file = self._emu(process, fd)
        if req == FIONBIO:
            val = struct.unpack("<i", process.mem.read(argp, 4))[0]
            file.nonblocking = bool(val)
            return _done(0)
        if req == FIONREAD:
            avail = 0
            if isinstance(file, PipeEnd):
                avail = file.bytes_available()
            elif hasattr(file, "bytes_available"):
                avail = file.bytes_available()
            elif hasattr(file, "_recv_q"):
                # UDP SIOCINQ: size of the NEXT pending datagram (Linux
                # udp.c first_packet_length), not the queue total.
                q = file._recv_q
                avail = len(q[0].payload) if q else 0
            process.mem.write(argp, struct.pack("<i", avail))
            return _done(0)
        return _error(errno.ENOTTY)

    # ------------------------------------------------------------------
    # pipes / eventfd / timerfd / epoll
    # ------------------------------------------------------------------

    def _pipe_common(self, host, process, fds_ptr, flags):
        r, w = make_pipe()
        r.nonblocking = w.nonblocking = bool(flags & O_NONBLOCK)
        cloexec = bool(flags & O_CLOEXEC)
        rfd = self._register(process, r, cloexec=cloexec)
        wfd = self._register(process, w, cloexec=cloexec)
        process.mem.write(fds_ptr, struct.pack("<ii", rfd, wfd))
        return _done(0)

    def sys_pipe(self, host, process, thread, restarted, fds_ptr, *_):
        return self._pipe_common(host, process, fds_ptr, 0)

    def sys_pipe2(self, host, process, thread, restarted, fds_ptr, flags,
                  *_):
        return self._pipe_common(host, process, fds_ptr, flags)

    def _eventfd_common(self, host, process, initval, flags):
        ef = EventFd(initval, semaphore=bool(flags & EFD_SEMAPHORE))
        ef.nonblocking = bool(flags & EFD_NONBLOCK)
        return _done(self._register(process, ef,
                                    cloexec=bool(flags & O_CLOEXEC)))

    def sys_eventfd(self, host, process, thread, restarted, initval, *_):
        return self._eventfd_common(host, process, initval, 0)

    def sys_eventfd2(self, host, process, thread, restarted, initval,
                     flags, *_):
        return self._eventfd_common(host, process, initval, flags)

    def sys_timerfd_create(self, host, process, thread, restarted, clockid,
                           flags, *_):
        tf = TimerFd()
        tf.nonblocking = bool(flags & TFD_NONBLOCK)
        return _done(self._register(process, tf,
                                    cloexec=bool(flags & O_CLOEXEC)))

    def sys_timerfd_settime(self, host, process, thread, restarted, fd,
                            flags, new_ptr, old_ptr, *_):
        if not self._is_emu(process, fd):
            return _native()
        tf = self._emu(process, fd)
        if not isinstance(tf, TimerFd):
            return _error(errno.EINVAL)
        raw = process.mem.read(new_ptr, 32)
        int_s, int_ns, val_s, val_ns = struct.unpack("<qqqq", raw)
        interval = int_s * 10**9 + int_ns
        value = val_s * 10**9 + val_ns
        absolute = bool(flags & TIMER_ABSTIME)
        if absolute and value:
            # timerfd absolute times are CLOCK_REALTIME/MONOTONIC-based;
            # both map onto sim time (REALTIME shifted by the epoch).
            emu = value - simtime.EMUTIME_SIMULATION_START
            value = emu if emu >= 0 else value
        if old_ptr:
            self._write_itimerspec(process, old_ptr, tf, host)
        tf.arm(host, value, interval, absolute=absolute)
        return _done(0)

    def sys_timerfd_gettime(self, host, process, thread, restarted, fd,
                            cur_ptr, *_):
        if not self._is_emu(process, fd):
            return _native()
        tf = self._emu(process, fd)
        if not isinstance(tf, TimerFd):
            return _error(errno.EINVAL)
        self._write_itimerspec(process, cur_ptr, tf, host)
        return _done(0)

    @staticmethod
    def _write_itimerspec(process, ptr, tf: TimerFd, host) -> None:
        next_ns, interval = tf.disarm_remaining()
        remaining = max(next_ns - host.now(), 0) if next_ns else 0
        process.mem.write(ptr, struct.pack(
            "<qqqq", interval // 10**9, interval % 10**9,
            remaining // 10**9, remaining % 10**9))

    def _epoll_create(self, host, process, cloexec: bool = False):
        return _done(self._register(process, EpollFile(), cloexec=cloexec))

    def sys_epoll_create(self, host, process, thread, restarted, size, *_):
        return self._epoll_create(host, process)

    def sys_epoll_create1(self, host, process, thread, restarted, flags,
                          *_):
        return self._epoll_create(host, process,
                                  cloexec=bool(flags & O_CLOEXEC))

    def sys_epoll_ctl(self, host, process, thread, restarted, epfd, op, fd,
                      event_ptr, *_):
        if not self._is_emu(process, epfd):
            return _native()
        ep = self._emu(process, epfd)
        if not isinstance(ep, EpollFile):
            return _error(errno.EINVAL)
        if not self._is_emu(process, fd):
            # Native fds can't feed a simulated epoll; the reference
            # virtualizes all fds so this can't happen there.
            return _error(errno.EPERM)
        target = self._emu(process, fd)
        interest, data = 0, 0
        if event_ptr:
            interest, data = _EPOLL_EVENT.unpack(
                process.mem.read(event_ptr, 12))
        ep.ctl(host, op, fd, target, interest, data)
        return _done(0)

    def _epoll_wait_common(self, host, process, thread, restarted, epfd,
                           events_ptr, maxevents, timeout_ns):
        if not self._is_emu(process, epfd):
            return _native()
        ep = self._emu(process, epfd)
        if not isinstance(ep, EpollFile):
            return _error(errno.EINVAL)
        maxevents = max(1, min(maxevents, 1024))
        ready = ep.collect_ready(host, maxevents)
        if ready:
            out = b"".join(_EPOLL_EVENT.pack(ev, data) for ev, data in ready)
            process.mem.write(events_ptr, out)
            return _done(len(ready))
        if restarted and thread.last_condition is not None and \
                thread.last_condition.timed_out:
            return _done(0)
        if timeout_ns == 0:
            return _done(0)
        timeout_at = None if timeout_ns is None or timeout_ns < 0 \
            else host.now() + timeout_ns
        return _block(MultiSyscallCondition([(ep, S_READABLE)],
                                            timeout_at=timeout_at))

    def sys_epoll_wait(self, host, process, thread, restarted, epfd,
                       events_ptr, maxevents, timeout_ms, *_):
        timeout_ns = None if _sext32(timeout_ms) < 0 \
            else _sext32(timeout_ms) * 10**6
        return self._epoll_wait_common(host, process, thread, restarted,
                                       epfd, events_ptr, maxevents,
                                       timeout_ns)

    def sys_epoll_pwait(self, host, process, thread, restarted, epfd,
                        events_ptr, maxevents, timeout_ms, sigmask, *_):
        return self.sys_epoll_wait(host, process, thread, restarted, epfd,
                                   events_ptr, maxevents, timeout_ms)

    # ------------------------------------------------------------------
    # poll / select
    # ------------------------------------------------------------------

    @staticmethod
    def _poll_events_from_status(status: int, want: int) -> int:
        ev = 0
        if status & S_READABLE:
            ev |= POLLIN
        if status & S_WRITABLE:
            ev |= POLLOUT
        if status & S_CLOSED:
            ev |= POLLHUP | POLLIN
        if status & S_ERROR:
            ev |= POLLERR
        return ev & (want | POLLERR | POLLHUP)

    @staticmethod
    def _status_mask_from_poll(want: int) -> int:
        mask = S_CLOSED | S_ERROR
        if want & (POLLIN | POLLPRI):
            mask |= S_READABLE
        if want & POLLOUT:
            mask |= S_WRITABLE
        return mask

    def _poll_common(self, host, process, thread, restarted, fds_ptr, nfds,
                     timeout_ns):
        nfds = min(nfds, 4096)
        raw = process.mem.read(fds_ptr, _POLLFD.size * nfds)
        entries = [_POLLFD.unpack_from(raw, i * _POLLFD.size)
                   for i in range(nfds)]
        if not any(self._is_emu(process, fd) for fd, _e, _r in entries if fd >= 0):
            return _native()
        ready = 0
        out = bytearray(raw)
        watches = []
        for i, (fd, events, _rev) in enumerate(entries):
            revents = 0
            if fd >= 0:
                if self._is_emu(process, fd):
                    try:
                        file = self._emu(process, fd)
                    except OSError:
                        revents = POLLNVAL
                    else:
                        revents = self._poll_events_from_status(file.status,
                                                                events)
                        watches.append(
                            (file, self._status_mask_from_poll(events)))
                # Native fds in a mixed set: treated as never-ready (the
                # hybrid fd-space limitation; see module docstring).
            struct.pack_into("<h", out, i * _POLLFD.size + 6, revents)
            if revents:
                ready += 1
        if ready or timeout_ns == 0:
            process.mem.write(fds_ptr, bytes(out))
            return _done(ready)
        if restarted and thread.last_condition is not None and \
                thread.last_condition.timed_out:
            process.mem.write(fds_ptr, bytes(out))
            return _done(0)
        timeout_at = None if timeout_ns is None or timeout_ns < 0 \
            else host.now() + timeout_ns
        return _block(MultiSyscallCondition(watches, timeout_at=timeout_at))

    def sys_poll(self, host, process, thread, restarted, fds_ptr, nfds,
                 timeout_ms, *_):
        t = _sext32(timeout_ms)
        timeout_ns = None if t < 0 else t * 10**6
        return self._poll_common(host, process, thread, restarted, fds_ptr,
                                 nfds, timeout_ns)

    def sys_ppoll(self, host, process, thread, restarted, fds_ptr, nfds,
                  ts_ptr, sigmask, *_):
        timeout_ns = None
        if ts_ptr:
            sec, nsec = _TIMESPEC.unpack(process.mem.read(ts_ptr, 16))
            timeout_ns = sec * 10**9 + nsec
        return self._poll_common(host, process, thread, restarted, fds_ptr,
                                 nfds, timeout_ns)

    def _select_common(self, host, process, thread, restarted, nfds,
                       rfds_ptr, wfds_ptr, efds_ptr, timeout_ns):
        nfds = min(nfds, 1024)
        nbytes = (nfds + 7) // 8

        def read_set(ptr):
            if not ptr or nbytes == 0:
                return set()
            raw = process.mem.read(ptr, nbytes)
            return {fd for fd in range(nfds)
                    if raw[fd // 8] & (1 << (fd % 8))}

        rset, wset, eset = (read_set(p) for p in
                            (rfds_ptr, wfds_ptr, efds_ptr))
        all_fds = rset | wset | eset
        if not any(self._is_emu(process, fd) for fd in all_fds):
            return _native()

        r_ready, w_ready, e_ready = set(), set(), set()
        watches = []
        for fd in sorted(all_fds):
            if not self._is_emu(process, fd):
                continue  # hybrid limitation: native fds never ready
            try:
                file = self._emu(process, fd)
            except OSError:
                return _error(errno.EBADF)
            st = file.status
            if fd in rset:
                if st & (S_READABLE | S_CLOSED):
                    r_ready.add(fd)
                watches.append((file, S_READABLE | S_CLOSED))
            if fd in wset:
                if st & (S_WRITABLE | S_CLOSED):
                    w_ready.add(fd)
                watches.append((file, S_WRITABLE | S_CLOSED))
            if fd in eset and st & S_ERROR:
                e_ready.add(fd)

        total = len(r_ready) + len(w_ready) + len(e_ready)
        timed_out = (restarted and thread.last_condition is not None
                     and thread.last_condition.timed_out)
        if total or timeout_ns == 0 or timed_out:
            def write_set(ptr, ready):
                if not ptr:
                    return
                buf = bytearray(nbytes)
                for fd in ready:
                    buf[fd // 8] |= 1 << (fd % 8)
                process.mem.write(ptr, bytes(buf))
            write_set(rfds_ptr, r_ready)
            write_set(wfds_ptr, w_ready)
            write_set(efds_ptr, e_ready)
            return _done(total)
        timeout_at = None if timeout_ns is None \
            else host.now() + timeout_ns
        return _block(MultiSyscallCondition(watches, timeout_at=timeout_at))

    def sys_select(self, host, process, thread, restarted, nfds, rfds,
                   wfds, efds, tv_ptr, *_):
        timeout_ns = None
        if tv_ptr:
            sec, usec = _TIMEVAL.unpack(process.mem.read(tv_ptr, 16))
            timeout_ns = sec * 10**9 + usec * 10**3
        return self._select_common(host, process, thread, restarted, nfds,
                                   rfds, wfds, efds, timeout_ns)

    def sys_pselect6(self, host, process, thread, restarted, nfds, rfds,
                     wfds, efds, ts_ptr, sigmask):
        timeout_ns = None
        if ts_ptr:
            sec, nsec = _TIMESPEC.unpack(process.mem.read(ts_ptr, 16))
            timeout_ns = sec * 10**9 + nsec
        return self._select_common(host, process, thread, restarted, nfds,
                                   rfds, wfds, efds, timeout_ns)

    # ------------------------------------------------------------------
    # Time
    # ------------------------------------------------------------------

    def sys_clock_gettime(self, host, process, thread, restarted, clockid,
                          ts_ptr, *_):
        now = host.now()
        if clockid in (0, 5, 11):  # REALTIME, REALTIME_COARSE, TAI
            now += simtime.EMUTIME_SIMULATION_START
        if ts_ptr:
            process.mem.write(ts_ptr, _TIMESPEC.pack(now // 10**9,
                                                     now % 10**9))
        return _done(0)

    def sys_clock_getres(self, host, process, thread, restarted, clockid,
                         ts_ptr, *_):
        if ts_ptr:
            process.mem.write(ts_ptr, _TIMESPEC.pack(0, 1))
        return _done(0)

    def sys_gettimeofday(self, host, process, thread, restarted, tv_ptr,
                         tz_ptr, *_):
        now = host.now() + simtime.EMUTIME_SIMULATION_START
        if tv_ptr:
            process.mem.write(tv_ptr, _TIMEVAL.pack(now // 10**9,
                                                    (now % 10**9) // 1000))
        if tz_ptr:
            process.mem.write(tz_ptr, struct.pack("<ii", 0, 0))
        return _done(0)

    def sys_time(self, host, process, thread, restarted, tloc_ptr, *_):
        secs = (host.now() + simtime.EMUTIME_SIMULATION_START) // 10**9
        if tloc_ptr:
            process.mem.write(tloc_ptr, struct.pack("<q", secs))
        return _done(secs)

    def sys_nanosleep(self, host, process, thread, restarted, req_ptr,
                      rem_ptr, *_):
        if restarted:
            if rem_ptr:
                process.mem.write(rem_ptr, _TIMESPEC.pack(0, 0))
            return _done(0)
        sec, nsec = _TIMESPEC.unpack(process.mem.read(req_ptr, 16))
        duration = sec * 10**9 + nsec
        if duration <= 0:
            return _done(0)
        return _block(SyscallCondition(timeout_at=host.now() + duration))

    def sys_clock_nanosleep(self, host, process, thread, restarted, clockid,
                            flags, req_ptr, rem_ptr, *_):
        if restarted:
            if rem_ptr and not (flags & TIMER_ABSTIME):
                process.mem.write(rem_ptr, _TIMESPEC.pack(0, 0))
            return _done(0)
        sec, nsec = _TIMESPEC.unpack(process.mem.read(req_ptr, 16))
        when = sec * 10**9 + nsec
        if flags & TIMER_ABSTIME:
            if clockid == CLOCK_REALTIME:
                when -= simtime.EMUTIME_SIMULATION_START
            target = when
        else:
            target = host.now() + when
        if target <= host.now():
            return _done(0)
        return _block(SyscallCondition(timeout_at=target))

    # -- ITIMER_REAL / alarm: SIGALRM at a simulated deadline ---------

    @staticmethod
    def _itimer_remaining_ns(host, process) -> int:
        fire_at = getattr(process, "itimer_fire_at", None)
        if fire_at is None:
            return 0
        return max(0, fire_at - host.now())

    @staticmethod
    def _itimer_schedule(host, process, when: int) -> None:
        """Queue a wakeup at `when` unless an already-queued one covers
        it (re-arming alarm(N) per request must not accumulate one dead
        task per call in the event queue — the hot path)."""
        from shadow_tpu_torch.core.event import TaskRef
        wakes = process.__dict__.setdefault("_itimer_wakes", [])
        if any(w <= when for w in wakes):
            return  # an earlier task will re-check fire_at and re-park
        wakes.append(when)
        host.schedule_task_at(when, TaskRef(
            "itimer",
            lambda h, w=when: NativeSyscallHandler._itimer_fire(
                h, process, w)))

    @staticmethod
    def _itimer_fire(host, process, when: int) -> None:
        from shadow_tpu_torch.host.signals import SIGALRM
        wakes = process.__dict__.setdefault("_itimer_wakes", [])
        try:
            wakes.remove(when)
        except ValueError:
            pass
        if process.exited:
            return
        target = getattr(process, "itimer_fire_at", None)
        if target is None:
            return  # disarmed since this task was queued
        if host.now() < target:
            NativeSyscallHandler._itimer_schedule(host, process, target)
            return  # re-armed to a later deadline; re-park once
        if getattr(process, "itimer_interval", 0):
            process.itimer_fire_at = host.now() + process.itimer_interval
            NativeSyscallHandler._itimer_schedule(host, process,
                                                  process.itimer_fire_at)
        else:
            process.itimer_fire_at = None
        from shadow_tpu_torch.host.signals import SI_KERNEL
        process.raise_signal(host, SIGALRM, si_code=SI_KERNEL)

    @staticmethod
    def _itimer_set(host, process, value_ns: int, interval_ns: int) -> None:
        process.itimer_interval = interval_ns
        if value_ns <= 0:
            process.itimer_fire_at = None
            return
        process.itimer_fire_at = host.now() + value_ns
        NativeSyscallHandler._itimer_schedule(host, process,
                                              process.itimer_fire_at)

    def sys_alarm(self, host, process, thread, restarted, seconds, *_):
        remaining = self._itimer_remaining_ns(host, process)
        self._itimer_set(host, process, int(seconds) * 10**9, 0)
        return _done((remaining + 10**9 - 1) // 10**9)

    _ITIMERVAL = struct.Struct("<qqqq")  # interval sec/usec, value sec/usec

    def sys_setitimer(self, host, process, thread, restarted, which,
                      new_ptr, old_ptr, *_):
        if which > 2 or which < 0:
            return _error(errno.EINVAL)  # Linux: EINVAL for bad `which`
        if which != 0:  # ITIMER_VIRTUAL/PROF need modeled cpu time
            from shadow_tpu_torch.utils.shadow_log import LOG
            LOG.warn_once(f"setitimer-{which}",
                          f"setitimer(which={which}) accepted but not "
                          "modeled (no per-process CPU clock); the timer "
                          "never fires")
            if old_ptr:  # Linux always fills *old_value on success
                process.mem.write(old_ptr, self._ITIMERVAL.pack(0, 0, 0, 0))
            return _done(0)
        if old_ptr:
            rem = self._itimer_remaining_ns(host, process)
            iv = getattr(process, "itimer_interval", 0)
            process.mem.write(old_ptr, self._ITIMERVAL.pack(
                iv // 10**9, (iv % 10**9) // 1000,
                rem // 10**9, (rem % 10**9) // 1000))
        if new_ptr:
            isec, iusec, vsec, vusec = self._ITIMERVAL.unpack(
                process.mem.read(new_ptr, 32))
            self._itimer_set(host, process,
                             vsec * 10**9 + vusec * 1000,
                             isec * 10**9 + iusec * 1000)
        return _done(0)

    def sys_getitimer(self, host, process, thread, restarted, which,
                      curr_ptr, *_):
        if which > 2 or which < 0:
            return _error(errno.EINVAL)
        if which != 0:  # VIRTUAL/PROF: accepted-but-unmodeled => disarmed
            if curr_ptr:
                process.mem.write(curr_ptr, self._ITIMERVAL.pack(0, 0, 0, 0))
            return _done(0)
        if curr_ptr:
            rem = self._itimer_remaining_ns(host, process)
            iv = getattr(process, "itimer_interval", 0)
            process.mem.write(curr_ptr, self._ITIMERVAL.pack(
                iv // 10**9, (iv % 10**9) // 1000,
                rem // 10**9, (rem % 10**9) // 1000))
        return _done(0)

    def sys_pause(self, host, process, thread, restarted, *_):
        # Sleep until an (unsupported) signal: park forever — the
        # process's shutdown_time or sim end tears it down.
        return _block(SyscallCondition(timeout_at=simtime.TIME_NEVER - 1))

    # ------------------------------------------------------------------
    # Identity / misc
    # ------------------------------------------------------------------

    def sys_getpid(self, host, process, thread, restarted, *_):
        return _done(process.pid)

    def sys_gettid(self, host, process, thread, restarted, *_):
        return _done(thread.tid)

    def sys_getppid(self, host, process, thread, restarted, *_):
        return _done(process.parent_pid if process.parent_pid else 1)

    def sys_getsid(self, host, process, thread, restarted, pid=0, *_):
        pid = _sext32(pid)
        if pid < 0:
            return _error(errno.ESRCH)
        target = host.processes.get(pid) if pid else process
        if target is None:
            return _error(errno.ESRCH)
        return _done(target.sid)

    def sys_setsid(self, host, process, thread, restarted, *_):
        """New session (daemonize step 2): fails for a group leader,
        exactly like Linux (ref handler/sched-family)."""
        if process.pgid == process.pid:
            return _error(errno.EPERM)
        process.pgid = process.pid
        process.sid = process.pid
        return _done(process.sid)

    def sys_setpgid(self, host, process, thread, restarted, pid, pgid, *_):
        pid, pgid = _sext32(pid), _sext32(pgid)
        if pid < 0 or pgid < 0:
            return _error(errno.EINVAL)
        target = host.processes.get(pid) if pid else process
        if target is None:
            return _error(errno.ESRCH)
        if target is not process and target.parent_pid != process.pid:
            return _error(errno.ESRCH)  # only self or own children
        if target.sid == target.pid:
            return _error(errno.EPERM)  # session leaders are immovable
        if target.sid != process.sid:
            return _error(errno.EPERM)  # child already in another session
        pgid = pgid or target.pid
        # Joining an existing group requires it to live in our session.
        owner = next((p for p in host.processes.values()
                      if p.pgid == pgid and not p.exited), None)
        if pgid != target.pid and (owner is None
                                   or owner.sid != process.sid):
            return _error(errno.EPERM)
        target.pgid = pgid
        return _done(0)

    def sys_getpgid(self, host, process, thread, restarted, pid=0, *_):
        pid = _sext32(pid)
        if pid < 0:
            return _error(errno.ESRCH)
        target = host.processes.get(pid) if pid else process
        if target is None:
            return _error(errno.ESRCH)
        return _done(target.pgid)

    def sys_getpgrp(self, host, process, thread, restarted, *_):
        return _done(process.pgid)

    def sys_getuid(self, host, process, thread, restarted, *_):
        return _done(1000)

    def sys_geteuid(self, host, process, thread, restarted, *_):
        return _done(1000)

    def sys_getgid(self, host, process, thread, restarted, *_):
        return _done(1000)

    def sys_getegid(self, host, process, thread, restarted, *_):
        return _done(1000)

    def sys_uname(self, host, process, thread, restarted, buf_ptr, *_):
        def field(s: str) -> bytes:
            b = s.encode()[:64]
            return b + b"\0" * (65 - len(b))
        data = (field("Linux") + field(host.name) +
                field("5.15.0-shadowtpu") +
                field("#1 SMP shadow-tpu simulated") + field("x86_64") +
                field("(none)"))
        process.mem.write(buf_ptr, data)
        return _done(0)

    def sys_getrusage(self, host, process, thread, restarted, who,
                      usage_ptr, *_):
        """Deterministic rusage: a native getrusage would leak real
        CPU times and fault counts into the simulation.  User time is
        the modeled CPU the latency model billed; all else is zero
        except a fixed maxrss."""
        RUSAGE_SELF, RUSAGE_CHILDREN, RUSAGE_THREAD = 0, -1, 1
        who = _sext32(who)
        if who == RUSAGE_SELF:
            billed = sum(getattr(t, "cpu_total_ns", 0)
                         for t in process.threads)
        elif who == RUSAGE_THREAD:
            billed = getattr(thread, "cpu_total_ns", 0)
        elif who == RUSAGE_CHILDREN:
            billed = 0  # reaped-children usage is not accumulated
        else:
            return _error(errno.EINVAL)
        utime_us = billed // 1000
        # struct rusage: ru_utime, ru_stime (timevals), then 14 longs.
        buf = struct.pack("<qqqq", utime_us // 10**6, utime_us % 10**6,
                          0, 0)
        buf += struct.pack("<q", 16384)  # ru_maxrss (kB), fixed
        buf += b"\0" * (8 * 13)
        process.mem.write(usage_ptr, buf)
        return _done(0)

    def sys_sysinfo(self, host, process, thread, restarted, info_ptr, *_):
        up = host.now() // 10**9
        gib = 1 << 30
        data = struct.pack("<q3Q", up, 0, 0, 0)          # uptime, loads
        data += struct.pack("<6Q", 16 * gib, 8 * gib, 0, 0, 0, 0)
        data += struct.pack("<HH", 1, 0)                  # procs, pad
        data += struct.pack("<QQI", 0, 0, 1)              # high mem, unit
        data += b"\0" * (112 - len(data))
        process.mem.write(info_ptr, data[:112])
        return _done(0)

    def sys_times(self, host, process, thread, restarted, buf_ptr, *_):
        ticks = host.now() // 10_000_000  # 100 Hz clock ticks
        if buf_ptr:
            process.mem.write(buf_ptr, struct.pack("<4q", ticks, 0, 0, 0))
        return _done(ticks)

    def sys_getrandom(self, host, process, thread, restarted, buf_ptr,
                      count, flags, *_):
        n = min(count, _MAX_IO)
        process.mem.write(buf_ptr, host.rng.bytes(n))
        return _done(n)

    def sys_shadow_yield(self, host, process, thread, restarted,
                         sim_ns, *_):
        """Native preemption (preempt.rs): the managed thread burned a
        native CPU slice without syscalls; bill the configured simulated
        interval so the spin loop makes simulated progress (and the
        thread parks until the event queue catches up)."""
        ns = int(sim_ns) if sim_ns > 0 else host.preempt_sim_ns
        thread.add_cpu_latency(ns)
        if host.cpu is not None:
            host.cpu.add_delay(ns)
        return _done(0)

    def sys_sched_getaffinity(self, host, process, thread, restarted,
                              tid, cpusetsize, mask_ptr, *_):
        """One simulated CPU (ref handler/sched.rs): a native answer
        would leak the real machine's core count, which apps use to
        size thread pools — nondeterministic across machines."""
        tid = _sext32(tid)
        if tid and not any(t.tid == tid for t in process.threads):
            return _error(errno.ESRCH)
        if cpusetsize < 8:
            return _error(errno.EINVAL)
        process.mem.write(mask_ptr, struct.pack("<Q", 1))
        return _done(8)  # bytes written, like the kernel

    def sys_sched_setaffinity(self, host, process, thread, restarted,
                              tid, cpusetsize, mask_ptr, *_):
        tid = _sext32(tid)
        if tid and not any(t.tid == tid for t in process.threads):
            return _error(errno.ESRCH)
        # Otherwise accepted and inert: one simulated CPU.
        return _done(0)

    def sys_sched_yield(self, host, process, thread, restarted, *_):
        # The shim forwards one of these per LOCAL_TIME_FORWARD_EVERY
        # locally-answered time reads; bill the batch so time-polling
        # loops advance the clock (handler/mod.rs:271-321).  Scaled by
        # the configured per-syscall latency (0 = model disabled).
        batch_ns = 25 * host.syscall_latency_ns
        thread.add_cpu_latency(batch_ns)
        if host.cpu is not None and batch_ns:
            host.cpu.add_delay(batch_ns)
        return _done(0)

    # ------------------------------------------------------------------
    # Guard rails
    # ------------------------------------------------------------------

    # -- signals (ref: handler/signal.rs + shim/src/signals.rs; our
    #    delivery machinery lives in host/signals.py + managed.py) ----

    _SIG_BLOCK, _SIG_UNBLOCK, _SIG_SETMASK = 0, 1, 2

    def sys_rt_sigaction(self, host, process, thread, restarted, signum,
                         act_ptr, old_ptr, sigsetsize, *_):
        from shadow_tpu_torch.host import signals as S
        if signum < 1 or signum >= S.NSIG or \
                (act_ptr and signum in (S.SIGKILL, S.SIGSTOP)):
            return _error(errno.EINVAL)
        sigs = process.signals
        old = sigs.action(signum)
        if act_ptr:
            handler, flags, restorer, mask = struct.unpack(
                "<QQQQ", process.mem.read(act_ptr, 32))
            sigs.actions[signum] = S.SigAction(handler, flags, restorer,
                                               mask)
        if old_ptr:
            process.mem.write(old_ptr, struct.pack(
                "<QQQQ", old.handler, old.flags, old.restorer, old.mask))
        # Hardware-fault handlers are ALSO installed natively so a real
        # fault in managed code reaches the app handler — except
        # SIGSEGV, whose native slot belongs to the shim's rdtsc trap:
        # the app's action is published through the IPC header and the
        # shim chains real faults to it.  SIGSYS stays the shim's.
        if act_ptr and signum == S.SIGSEGV:
            block = getattr(process, "ipc_block", None)
            if block is not None:
                act = sigs.action(signum)
                block.set_sigsegv_action(act.handler, act.flags)
            return _done(0)
        if act_ptr and signum in S.FAULT_SIGNALS:
            return _native()
        return _done(0)

    def sys_rt_sigprocmask(self, host, process, thread, restarted, how,
                           set_ptr, old_ptr, sigsetsize, *_):
        from shadow_tpu_torch.host import signals as S
        old = thread.sig_mask
        if old_ptr:
            process.mem.write(old_ptr, struct.pack("<Q", old))
        if set_ptr:
            (m,) = struct.unpack("<Q", process.mem.read(set_ptr, 8))
            if how == self._SIG_BLOCK:
                new = old | m
            elif how == self._SIG_UNBLOCK:
                new = old & ~m
            elif how == self._SIG_SETMASK:
                new = m
            else:
                return _error(errno.EINVAL)
            thread.sig_mask = new & ~(S.bit(S.SIGKILL) | S.bit(S.SIGSTOP))
        # Newly unblocked pending signals are picked up at this response
        # point by the ManagedThread delivery check.
        return _done(0)

    def sys_rt_sigpending(self, host, process, thread, restarted, set_ptr,
                          sigsetsize, *_):
        if set_ptr:
            mask = process.signals.pending_mask(thread) & thread.sig_mask
            process.mem.write(set_ptr, struct.pack("<Q", mask))
        return _done(0)

    def sys_rt_sigsuspend(self, host, process, thread, restarted, mask_ptr,
                          sigsetsize, *_):
        from shadow_tpu_torch.core import simtime
        from shadow_tpu_torch.host import signals as S
        if restarted:  # spurious resume without a signal: keep waiting
            return _block(SyscallCondition(
                timeout_at=simtime.TIME_NEVER - 1))
        (m,) = struct.unpack("<Q", process.mem.read(mask_ptr, 8))
        thread._suspend_restore = thread.sig_mask
        thread.sig_mask = m & ~(S.bit(S.SIGKILL) | S.bit(S.SIGSTOP))
        if process.signals.has_deliverable(thread):
            # Deliverable immediately: the response-point check runs the
            # handler, then this EINTR goes out with the mask restored.
            return _error(errno.EINTR)
        return _block(SyscallCondition(timeout_at=simtime.TIME_NEVER - 1))

    def sys_rt_sigtimedwait(self, host, process, thread, restarted,
                            set_ptr, info_ptr, ts_ptr, sigsetsize, *_):
        from shadow_tpu_torch.host import signals as S
        (want,) = struct.unpack("<Q", process.mem.read(set_ptr, 8))
        if restarted:
            got, thread._sigwait_got = thread._sigwait_got, None
            thread._sigwait_set = 0
            if got is None:
                return _error(errno.EAGAIN)  # timed out
            if info_ptr:
                process.mem.write(info_ptr, _pack_siginfo(
                    got, *thread._sigwait_info))
            return _done(got)
        # Already pending?
        pending = sorted(thread.sig_pending |
                         process.signals.pending_process)
        for s in pending:
            if want & S.bit(s):
                thread.sig_pending.discard(s)
                process.signals.pending_process.discard(s)
                process.refresh_signal_fds(host)
                if info_ptr:
                    process.mem.write(info_ptr, _pack_siginfo(
                        s, *process.signals.take_info(s)))
                return _done(s)
        timeout_at = None
        if ts_ptr:
            sec, nsec = _TIMESPEC.unpack(process.mem.read(ts_ptr, 16))
            if sec == 0 and nsec == 0:
                return _error(errno.EAGAIN)
            timeout_at = host.now() + sec * 10**9 + nsec
        else:
            from shadow_tpu_torch.core import simtime
            timeout_at = simtime.TIME_NEVER - 1
        thread._sigwait_set = want
        from shadow_tpu_torch.host.condition import ManualCondition
        return _block(ManualCondition(timeout_at=timeout_at))

    def sys_signalfd4(self, host, process, thread, restarted, fd,
                      mask_ptr, sizemask, flags, *_):
        """signalfd(2): pending signals as readable records (event-loop
        daemons' signal plumbing).  fd == -1 creates; otherwise the
        mask of an existing signalfd is replaced."""
        from shadow_tpu_torch.host.files import SignalFd
        (mask,) = struct.unpack("<Q", process.mem.read(mask_ptr, 8))
        fd = _sext32(fd)
        if fd != -1:
            if not self._is_emu(process, fd):
                return _error(errno.EINVAL)
            sfd = self._emu(process, fd)
            if not isinstance(sfd, SignalFd):
                return _error(errno.EINVAL)
            sfd.mask = mask
            sfd.refresh(host)
            return _done(fd)
        sfd = SignalFd(process, mask)
        sfd.nonblocking = bool(flags & O_NONBLOCK)
        sfd.refresh(host)  # signals may already be pending
        return _done(self._register(process, sfd,
                                    cloexec=bool(flags & O_CLOEXEC)))

    def sys_signalfd(self, host, process, thread, restarted, fd,
                     mask_ptr, sizemask, *_):
        return self.sys_signalfd4(host, process, thread, restarted, fd,
                                  mask_ptr, sizemask, 0)

    def sys_sigaltstack(self, host, process, thread, restarted, *_):
        return _native()  # only affects native (fault) delivery

    def sys_rt_sigreturn(self, host, process, thread, restarted, *_):
        return _native()  # seccomp always allows it; defensive

    def _signal_targets(self, host, process, pid: int):
        """kill(2) addressing: pid > 0 one process; 0 the caller's
        process group; -1 everything except the caller (Linux excludes
        it from broadcast); -pgid that group.  Zombies are included —
        an unreaped member keeps its group alive for existence probes —
        but raise_signal no-ops on them."""
        if pid > 0:
            t = host.processes.get(pid)
            return [t] if t is not None else []
        if pid == 0:
            return [p for p in host.processes.values()
                    if p.pgid == process.pgid]
        if pid == -1:
            return [p for p in host.processes.values() if p is not process]
        return [p for p in host.processes.values() if p.pgid == -pid]

    def sys_kill(self, host, process, thread, restarted, pid, sig, *_):
        from shadow_tpu_torch.host import signals as S
        pid = _sext32(pid)
        if sig < 0 or sig >= S.NSIG:
            return _error(errno.EINVAL)
        targets = self._signal_targets(host, process, pid)
        if not targets:
            return _error(errno.ESRCH)
        if sig == 0:
            return _done(0)
        for target in targets:
            target.raise_signal(host, sig, si_code=S.SI_USER,
                                si_pid=process.pid)
        return _done(0)

    def sys_tkill(self, host, process, thread, restarted, tid, sig, *_):
        return self.sys_tgkill(host, process, thread, restarted,
                               process.pid, tid, sig)

    def sys_tgkill(self, host, process, thread, restarted, tgid, tid, sig,
                   *_):
        from shadow_tpu_torch.host import signals as S
        if sig < 0 or sig >= S.NSIG:
            return _error(errno.EINVAL)
        from shadow_tpu_torch.host.process import ST_EXITED
        target = host.processes.get(tgid)
        if target is None or not any(
                t.tid == tid and t.state != ST_EXITED
                for t in target.threads):
            return _error(errno.ESRCH)
        if sig == 0:
            return _done(0)
        target.raise_signal(host, sig, target_tid=tid, si_code=S.SI_TKILL,
                            si_pid=process.pid)
        return _done(0)

    def sys_prctl(self, host, process, thread, restarted, option, *rest):
        PR_SET_SECCOMP = 22
        if option == PR_SET_SECCOMP:
            return _error(errno.EPERM)
        return _native()

    def sys_seccomp(self, host, process, thread, restarted, *_):
        return _error(errno.EPERM)  # one filter is enough

    # -- threads (clone/futex; ref handler/clone.rs, futex.rs) ---------

    _CLONE_VM = 0x100
    _CLONE_FILES = 0x400
    _CLONE_VFORK = 0x4000
    _CLONE_SETTLS = 0x80000
    _CLONE_THREAD = 0x10000
    _CLONE_CHILD_CLEARTID = 0x200000

    def sys_clone(self, host, process, thread, restarted, flags, stack,
                  ptid, ctid, tls, *_):
        """Thread-creation clone runs the three-way channel handshake
        (managed.py _do_clone); a clone WITHOUT CLONE_THREAD is a fork
        (glibc fork(), posix_spawn()'s CLONE_VM|CLONE_VFORK clone) and
        routes to the fork protocol — the shim runs a plain
        clone(SIGCHLD|CLONE_PARENT), so posix_spawn's shared-VM
        optimization degrades to copy-on-write (its exec-failure errno
        reporting through shared memory is lost; the exec path itself
        works).  CLONE_SETTLS is required for threads: the shim's
        per-thread channel pointer lives in fs-relative TLS."""
        if not (flags & self._CLONE_THREAD):
            # Shared-state clones that COW fork semantics cannot honor
            # are refused rather than silently diverging: CLONE_FILES
            # (shared fd table) always; CLONE_VM only in its vfork-like
            # exec idiom (posix_spawn), where the sharing is unobserved.
            if flags & self._CLONE_FILES:
                return _error(errno.ENOSYS)
            if (flags & self._CLONE_VM) and not (flags & self._CLONE_VFORK):
                return _error(errno.ENOSYS)
            return ("fork",)
        if (flags & self._CLONE_VM) and (flags & self._CLONE_SETTLS):
            return ("clone", flags, ctid)
        return _error(errno.ENOSYS)

    def sys_clone3(self, host, process, thread, restarted, *_):
        return _error(errno.ENOSYS)  # glibc falls back to clone

    def sys_fork(self, host, process, thread, restarted, *_):
        return ("fork",)

    def sys_vfork(self, host, process, thread, restarted, *_):
        # Emulated as fork: the child gets a COW copy instead of the
        # parent's suspended address space.  Safe for the fork+exec
        # pattern vfork exists for.
        return ("fork",)

    def sys_execve(self, host, process, thread, restarted, path_ptr,
                   argv_ptr, envp_ptr, *_):
        """Read path/argv/envp out of the old image, then let the
        ManagedThread replace the native process (managed.py
        _do_execve; ref process.rs:297 spawn_mthread_for_exec)."""
        path = process.mem.read_cstr(path_ptr, 4096).decode(
            errors="surrogateescape")

        def read_ptr_vec(ptr, limit=8192):
            out = []
            for i in range(limit):
                (p,) = struct.unpack(
                    "<Q", process.mem.read(ptr + 8 * i, 8))
                if p == 0:
                    return out
                out.append(process.mem.read_cstr(p, 1 << 17).decode(
                    errors="surrogateescape"))
            # Vector larger than we model: refuse loudly (Linux E2BIG)
            # rather than exec with a silently clipped argv/environment.
            raise OSError(errno.E2BIG, "argv/envp exceeds limit")

        try:
            argv = read_ptr_vec(argv_ptr) if argv_ptr else []
            envp = read_ptr_vec(envp_ptr) if envp_ptr else []
        except OSError as e:
            return _error(e.errno)
        return ("execve", path, argv, envp)

    def sys_set_tid_address(self, host, process, thread, restarted, addr,
                            *_):
        thread.ctid_addr = addr
        return _done(thread.native_tid or thread.tid)

    def sys_set_robust_list(self, host, process, thread, restarted, *_):
        # Robust-mutex recovery after thread death is out of scope; the
        # kernel-side list walk never happens for emulated futexes anyway.
        return _done(0)

    def sys_get_robust_list(self, host, process, thread, restarted, *_):
        return _error(errno.ENOSYS)

    def sys_rseq(self, host, process, thread, restarted, *_):
        return _error(errno.ENOSYS)  # glibc degrades gracefully

    # futex ops (uapi/linux/futex.h)
    _FUTEX_WAIT = 0
    _FUTEX_WAKE = 1
    _FUTEX_REQUEUE = 3
    _FUTEX_CMP_REQUEUE = 4
    _FUTEX_WAKE_OP = 5
    _FUTEX_WAIT_BITSET = 9
    _FUTEX_WAKE_BITSET = 10
    _FUTEX_PRIVATE = 128
    _FUTEX_CLOCK_REALTIME = 256

    def sys_futex(self, host, process, thread, restarted, addr, op, val,
                  timeout_or_val2, addr2, val3):
        """Emulated futexes (ref: futex_table.rs, futex.c, and the futex
        trigger of syscall_condition.c).  Every waiter parks on the
        simulated timeline; wakes come from sibling threads' emulated
        FUTEX_WAKE — never from the native kernel, whose futex queue the
        managed threads bypass entirely."""
        from shadow_tpu_torch.host.condition import ManualCondition

        cmd = op & ~(self._FUTEX_PRIVATE | self._FUTEX_CLOCK_REALTIME)
        table = process.futex_table

        if cmd in (self._FUTEX_WAIT, self._FUTEX_WAIT_BITSET):
            if restarted:
                waiter, thread.futex_waiter = thread.futex_waiter, None
                if waiter is not None and waiter.woken:
                    return _done(0)
                if (thread.last_condition is not None
                        and thread.last_condition.timed_out):
                    return _error(errno.ETIMEDOUT)
                return _done(0)  # spurious wake: apps must re-check anyway
            val &= 0xFFFFFFFF
            cur = process.mem.try_read(addr, 4)
            if cur is None:
                return _error(errno.EFAULT)
            if int.from_bytes(cur, "little") != val:
                return _error(errno.EAGAIN)
            timeout_at = None
            if timeout_or_val2:
                ts = process.mem.try_read(timeout_or_val2, 16)
                if ts is None:
                    return _error(errno.EFAULT)
                sec, nsec = struct.unpack("<qq", ts)
                t = sec * 1_000_000_000 + nsec
                if cmd == self._FUTEX_WAIT:
                    timeout_at = host.now() + t  # relative
                else:
                    # WAIT_BITSET: absolute, in the flagged clock.
                    if op & self._FUTEX_CLOCK_REALTIME:
                        t -= simtime.EMUTIME_SIMULATION_START
                    timeout_at = max(t, host.now())
            bitset = (val3 & 0xFFFFFFFF) \
                if cmd == self._FUTEX_WAIT_BITSET else 0xFFFFFFFF
            if bitset == 0:
                return _error(errno.EINVAL)
            cond = ManualCondition(timeout_at=timeout_at)
            thread.futex_waiter = table.add_waiter(addr, cond, bitset)
            return ("block", cond)

        if cmd in (self._FUTEX_WAKE, self._FUTEX_WAKE_BITSET):
            bitset = (val3 & 0xFFFFFFFF) \
                if cmd == self._FUTEX_WAKE_BITSET else 0xFFFFFFFF
            if bitset == 0:
                return _error(errno.EINVAL)
            return _done(table.wake(host, addr, _sext32(val), bitset))

        if cmd in (self._FUTEX_REQUEUE, self._FUTEX_CMP_REQUEUE):
            if cmd == self._FUTEX_CMP_REQUEUE:
                cur = process.mem.try_read(addr, 4)
                if cur is None:
                    return _error(errno.EFAULT)
                if int.from_bytes(cur, "little") != (val3 & 0xFFFFFFFF):
                    return _error(errno.EAGAIN)
            woken, moved = table.requeue(host, addr, _sext32(val),
                                         _sext32(timeout_or_val2), addr2)
            if cmd == self._FUTEX_CMP_REQUEUE:
                return _done(woken + moved)
            return _done(woken)

        # PI / WAKE_OP and friends: no in-tree consumer yet.  Binaries
        # using PI mutexes or raw WAKE_OP may hang on the ENOSYS, so
        # surface the gap once, visibly (ADVICE parity note).
        from shadow_tpu_torch.utils.shadow_log import LOG
        LOG.warn_once(
            f"futex-op-{cmd}",
            f"unsupported futex op {cmd} from pid {process.pid} "
            f"({process.name}): returning ENOSYS — PI mutexes / "
            f"FUTEX_WAKE_OP are not emulated",
            sim_ns=host.now(), host=host.name)
        return _error(errno.ENOSYS)

    _WNOHANG = 1

    @staticmethod
    def _wait_matches(host, process, pid: int, child) -> bool:
        """waitpid addressing: -1 any child; > 0 that child; 0 children
        in the CALLER's process group; < -1 children in group |pid|."""
        if pid == -1:
            return True
        if pid > 0:
            return child.pid == pid
        if pid == 0:
            return child.pgid == process.pgid
        return child.pgid == -pid

    def _reap_zombie(self, host, process, pid: int, consume: bool = True):
        """Pop (or, under waitid's WNOWAIT, peek) a matching zombie
        child; returns (child_pid, status) or None."""
        for zpid in process.zombies:
            if not self._wait_matches(host, process, pid,
                                      host.processes[zpid]):
                continue
            if consume:
                process.zombies.remove(zpid)
            child = host.processes[zpid]
            if child.term_signal is not None:
                status = child.term_signal & 0x7f
            else:
                status = (int(child.exit_code or 0) & 0xff) << 8
            return zpid, status
        return None

    def _has_children(self, host, process, pid: int) -> bool:
        """Waitable children: live ones plus unreaped zombies (an
        exited-and-reaped child no longer counts — ECHILD)."""
        for p in host.processes.values():
            if p.parent_pid != process.pid:
                continue
            if not self._wait_matches(host, process, pid, p):
                continue
            if not p.exited or p.pid in process.zombies:
                return True
        return False

    _WUNTRACED = 2
    _WCONTINUED = 8

    def _jobctl_report(self, host, process, pid: int, options: int,
                       consume: bool = True):
        """WUNTRACED/WCONTINUED: one report per stop/continue
        transition (Linux wait semantics; waitid's WNOWAIT peeks
        without clearing); returns (child_pid, status) or None.
        Iteration over host.processes is pid-ordered —
        deterministic."""
        if not (options & (self._WUNTRACED | self._WCONTINUED)):
            return None
        for p in host.processes.values():
            if p.exited or p.parent_pid != process.pid or \
                    not self._wait_matches(host, process, pid, p):
                continue
            if (options & self._WUNTRACED) and p.stopped \
                    and p.stop_report is not None:
                sig = p.stop_report
                if consume:
                    p.stop_report = None
                return p.pid, (sig << 8) | 0x7F
            if (options & self._WCONTINUED) and p.continue_report:
                if consume:
                    p.continue_report = False
                return p.pid, 0xFFFF
        return None

    def sys_wait4(self, host, process, thread, restarted, pid, status_ptr,
                  options, rusage_ptr, *_):
        pid = _sext32(pid)
        reaped = self._reap_zombie(host, process, pid)
        if reaped is None:
            reaped = self._jobctl_report(host, process, pid, options)
        if reaped is not None:
            zpid, status = reaped
            if status_ptr:
                process.mem.write(status_ptr, struct.pack("<i", status))
            if rusage_ptr:
                process.mem.write(rusage_ptr, b"\0" * 144)
            return _done(zpid)
        if not self._has_children(host, process, pid):
            return _error(errno.ECHILD)
        if options & self._WNOHANG:
            return _done(0)
        return self._park_wait(process)

    @staticmethod
    def _park_wait(process):
        """Block until a child exits (child_exited fires the cond)."""
        from shadow_tpu_torch.host.condition import ManualCondition
        cond = ManualCondition()
        process._wait_conds.append(cond)

        def drop():
            if cond in process._wait_conds:
                process._wait_conds.remove(cond)
        cond.on_disarm = drop
        return _block(cond)

    def sys_waitid(self, host, process, thread, restarted, idtype, id_,
                   info_ptr, options, rusage_ptr, *_):
        P_ALL, P_PID = 0, 1
        W_EXITED, W_STOPPED, W_CONTINUED = 4, 2, 8
        W_NOWAIT = 0x01000000
        if not (options & (W_EXITED | W_STOPPED | W_CONTINUED)):
            return _error(errno.EINVAL)  # Linux: must name a state set
        consume = not (options & W_NOWAIT)  # WNOWAIT: peek, stay waitable
        if idtype == P_ALL:
            pid = -1
        elif idtype == P_PID:
            if int(id_) <= 0:
                return _error(errno.EINVAL)
            pid = int(id_)
        else:
            return _error(errno.EINVAL)

        from shadow_tpu_torch.host.signals import (CLD_CONTINUED, CLD_STOPPED,
                                             SIGCHLD, SIGCONT)

        def write_info(zpid, code, st):
            info = struct.pack("<iii", SIGCHLD, 0, code)
            info += b"\0" * 4 + struct.pack("<iii", zpid, 1000, st)
            process.mem.write(info_ptr,
                              info + b"\0" * (128 - len(info)))

        if options & W_EXITED:
            reaped = self._reap_zombie(host, process, pid,
                                       consume=consume)
            if reaped is not None:
                zpid, status = reaped
                if info_ptr:
                    CLD_EXITED, CLD_KILLED = 1, 2
                    if status & 0x7f:
                        code, st = CLD_KILLED, status & 0x7f
                    else:
                        code, st = CLD_EXITED, (status >> 8) & 0xff
                    write_info(zpid, code, st)
                return _done(0)
        jc_opts = (self._WUNTRACED if options & W_STOPPED else 0) \
            | (self._WCONTINUED if options & W_CONTINUED else 0)
        jc = self._jobctl_report(host, process, pid, jc_opts,
                                 consume=consume)
        if jc is not None:
            zpid, status = jc
            if info_ptr:
                if status == 0xFFFF:
                    write_info(zpid, CLD_CONTINUED, SIGCONT)
                else:
                    write_info(zpid, CLD_STOPPED, (status >> 8) & 0xFF)
            return _done(0)
        if not self._has_children(host, process, pid):
            return _error(errno.ECHILD)
        if options & self._WNOHANG:
            if info_ptr:
                process.mem.write(info_ptr, b"\0" * 128)
            return _done(0)
        return self._park_wait(process)

    def sys_exit(self, host, process, thread, restarted, code, *_):
        from shadow_tpu_torch.host.managed import ManagedProcess
        if isinstance(process, ManagedProcess) \
                and process.live_managed_threads() > 1:
            return ("thread_exit", code & 0xff)
        return ("exit", code & 0xff)

    def sys_exit_group(self, host, process, thread, restarted, code, *_):
        return ("exit", code & 0xff)


def _sext32(v: int) -> int:
    """Register values arrive zero-extended; poll timeouts are i32."""
    v &= 0xffffffff
    return v - (1 << 32) if v & (1 << 31) else v
