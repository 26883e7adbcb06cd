"""Non-socket pollable descriptors: pipes, eventfd, timerfd.

Ref: src/main/host/descriptor/{pipe.rs,eventfd.rs,timerfd.rs} plus the
shared-buffer machinery pipes use.  All are StatusOwners so poll/epoll/
blocking conditions watch them uniformly.
"""

from __future__ import annotations

import errno

from shadow_tpu_torch.core.event import TaskRef
from shadow_tpu_torch.host.status import (S_ACTIVE, S_CLOSED, S_READABLE,
                                    S_WRITABLE, StatusOwner)

PIPE_CAPACITY = 65_536  # Linux default pipe buffer


class _PipeBuffer:
    """The shared byte channel between the two pipe ends."""

    __slots__ = ("data", "capacity", "reader", "writer")

    def __init__(self, capacity: int = PIPE_CAPACITY):
        self.data = bytearray()
        self.capacity = capacity
        self.reader = None
        self.writer = None


class PipeEnd(StatusOwner):
    """One end of a unidirectional pipe (pipe.rs)."""

    def __init__(self, buffer: _PipeBuffer, is_writer: bool):
        super().__init__()
        self.buf = buffer
        self.is_writer = is_writer
        self.nonblocking = False
        if is_writer:
            buffer.writer = self
            self._status = S_ACTIVE | S_WRITABLE
        else:
            buffer.reader = self
            self._status = S_ACTIVE

    # -- writer side --------------------------------------------------

    def write_bytes(self, host, data: bytes) -> int:
        if not self.is_writer:
            raise OSError(errno.EBADF, "read end of pipe")
        buf = self.buf
        if buf.reader is None or buf.reader.has_status(S_CLOSED):
            raise OSError(errno.EPIPE, "broken pipe")
        room = buf.capacity - len(buf.data)
        if room <= 0:
            self.adjust_status(host, 0, S_WRITABLE)
            raise BlockingIOError(errno.EWOULDBLOCK, "pipe full")
        take = data[:room]
        buf.data += take
        if buf.reader is not None:
            buf.reader.adjust_status(host, S_READABLE, 0)
        if len(buf.data) >= buf.capacity:
            self.adjust_status(host, 0, S_WRITABLE)
        return len(take)

    # -- reader side --------------------------------------------------

    def read_bytes(self, host, n: int) -> bytes:
        if self.is_writer:
            raise OSError(errno.EBADF, "write end of pipe")
        buf = self.buf
        if not buf.data:
            if buf.writer is None or buf.writer.has_status(S_CLOSED):
                return b""  # EOF
            raise BlockingIOError(errno.EWOULDBLOCK, "pipe empty")
        out = bytes(buf.data[:n])
        del buf.data[:n]
        if not buf.data:
            self.adjust_status(host, 0, S_READABLE)
        if buf.writer is not None:
            buf.writer.adjust_status(host, S_WRITABLE, 0)
        return out

    def bytes_available(self) -> int:
        return len(self.buf.data) if not self.is_writer else 0

    def close(self, host) -> None:
        self.adjust_status(host, S_CLOSED,
                           S_ACTIVE | S_READABLE | S_WRITABLE)
        buf = self.buf
        if self.is_writer:
            buf.writer = None
            if buf.reader is not None:
                # Readers see EOF: readable-with-no-data (read returns 0).
                buf.reader.adjust_status(host, S_READABLE, 0)
        else:
            buf.reader = None
            if buf.writer is not None:
                # Writers get EPIPE; wake them via WRITABLE.
                buf.writer.adjust_status(host, S_WRITABLE, 0)


def make_pipe(capacity: int = PIPE_CAPACITY):
    buf = _PipeBuffer(capacity)
    return PipeEnd(buf, is_writer=False), PipeEnd(buf, is_writer=True)


class EventFd(StatusOwner):
    """eventfd(2): a 64-bit kernel counter (eventfd.rs)."""

    def __init__(self, initval: int = 0, semaphore: bool = False):
        super().__init__()
        self.counter = initval
        self.semaphore = semaphore
        self.nonblocking = False
        self._status = S_ACTIVE | S_WRITABLE | (S_READABLE if initval else 0)

    def read_value(self, host) -> int:
        if self.counter == 0:
            raise BlockingIOError(errno.EWOULDBLOCK, "eventfd zero")
        if self.semaphore:
            value, self.counter = 1, self.counter - 1
        else:
            value, self.counter = self.counter, 0
        if self.counter == 0:
            self.adjust_status(host, 0, S_READABLE)
        self.adjust_status(host, S_WRITABLE, 0)
        return value

    def write_value(self, host, value: int) -> None:
        if value >= (1 << 64) - 1:
            raise OSError(errno.EINVAL, "eventfd overflow value")
        if self.counter + value >= (1 << 64) - 1:
            self.adjust_status(host, 0, S_WRITABLE)
            raise BlockingIOError(errno.EWOULDBLOCK, "eventfd would overflow")
        self.counter += value
        if self.counter:
            self.adjust_status(host, S_READABLE, 0)

    def close(self, host) -> None:
        self.adjust_status(host, S_CLOSED,
                           S_ACTIVE | S_READABLE | S_WRITABLE)


class TimerFd(StatusOwner):
    """timerfd(2): expiration counter driven by the event queue
    (timerfd.rs + host/timer.rs)."""

    def __init__(self):
        super().__init__()
        self.nonblocking = False
        self.expirations = 0
        self._interval_ns = 0
        self._next_expire_ns = None  # absolute sim time, None = disarmed
        self._generation = 0  # revokes stale expiry tasks
        self._status = S_ACTIVE

    def arm(self, host, first_ns: int, interval_ns: int,
            absolute: bool) -> None:
        """first_ns==0 disarms (timerfd_settime semantics)."""
        self._generation += 1
        self.expirations = 0
        self.adjust_status(host, 0, S_READABLE)
        if first_ns == 0:
            self._next_expire_ns = None
            self._interval_ns = 0
            return
        when = first_ns if absolute else host.now() + first_ns
        # An absolute time already in the past fires immediately.
        when = max(when, host.now())
        self._next_expire_ns = when
        self._interval_ns = interval_ns
        self._schedule(host)

    def disarm_remaining(self):
        """(it_value, it_interval) remaining, for timerfd_gettime."""
        return self._next_expire_ns, self._interval_ns

    def _schedule(self, host) -> None:
        gen = self._generation
        when = self._next_expire_ns

        def fire(h):
            if gen != self._generation or self._next_expire_ns != when:
                return
            self.expirations += 1
            if self._interval_ns > 0:
                self._next_expire_ns = when + self._interval_ns
                self._schedule(h)
            else:
                self._next_expire_ns = None
            self.adjust_status(h, S_READABLE, 0)

        host.schedule_task_at(when, TaskRef("timerfd-expire", fire))

    def read_expirations(self, host) -> int:
        if self.expirations == 0:
            raise BlockingIOError(errno.EWOULDBLOCK, "timer not expired")
        n, self.expirations = self.expirations, 0
        self.adjust_status(host, 0, S_READABLE)
        return n

    def close(self, host) -> None:
        self._generation += 1
        self.adjust_status(host, S_CLOSED, S_ACTIVE | S_READABLE)


class SignalFd(StatusOwner):
    """signalfd(2): queued signals read as signalfd_siginfo records.

    Scope model (one approximation, chosen to be safe): each SignalFd
    serves exactly ONE process (fork clones the object into the child,
    diverging from the kernel's shared description only for post-fork
    mask updates).  Readiness tracks the process's SHARED pending queue
    only; a read drains the shared queue plus the reading thread's own
    private queue.  A tgkill-directed blocked signal therefore never
    shows as poll-readable (the kernel shows it readable to that one
    thread) — the conservative miss, preferred over either cross-thread
    signal stealing or a shared status word asserting readability the
    blocked reader cannot drain (a same-instant wake livelock).
    """

    def __init__(self, process, mask: int):
        super().__init__()
        self.process = process
        self.mask = mask
        self.nonblocking = False
        self._status = S_ACTIVE
        process.signal_fds.append(self)

    def clone_for(self, process) -> "SignalFd":
        """fork: the child gets its own view bound to itself."""
        child = SignalFd(process, self.mask)
        child.nonblocking = self.nonblocking
        return child

    def _shared_pending(self):
        from shadow_tpu_torch.host import signals as S
        return sorted(s for s in self.process.signals.pending_process
                      if self.mask & S.bit(s))

    def refresh(self, host) -> None:
        if self._shared_pending():
            self.adjust_status(host, S_READABLE, 0)
        else:
            self.adjust_status(host, 0, S_READABLE)

    def read_infos(self, host, process, thread, max_records: int):
        import struct as _struct
        from shadow_tpu_torch.host import signals as S
        pend = set(self._shared_pending())
        tpend = getattr(thread, "sig_pending", set())
        pend |= {s for s in tpend if self.mask & S.bit(s)}
        matched = sorted(pend)[:max_records]
        if not matched:
            raise BlockingIOError(11, "no signals pending")
        out = bytearray()
        for signo in matched:
            self.process.signals.pending_process.discard(signo)
            tpend.discard(signo)
            code, pid, status = self.process.signals.take_info(signo)
            # signalfd_siginfo: ssi_signo u32@0, ssi_errno i32@4,
            # ssi_code i32@8, ssi_pid u32@12, ssi_uid u32@16,
            # ssi_fd i32@20, ssi_tid u32@24, ssi_band u32@28,
            # ssi_overrun u32@32, ssi_trapno u32@36, ssi_status i32@40.
            out += _struct.pack("<IiiII", signo, 0, code, pid & 0xFFFFFFFF,
                                0) + b"\0" * 20 + \
                _struct.pack("<i", status) + b"\0" * 84
        self.process.refresh_signal_fds(host)
        return bytes(out)

    def close(self, host) -> None:
        if self in self.process.signal_fds:
            self.process.signal_fds.remove(self)
        self.adjust_status(host, S_CLOSED,
                           S_ACTIVE | S_READABLE | S_WRITABLE)
