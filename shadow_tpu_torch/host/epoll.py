"""epoll: the readiness multiplexer (ref: src/main/host/descriptor/
epoll/{mod,entry,key}.rs — the Rust epoll, not the legacy C one).

An EpollFile is itself a StatusOwner (epoll fds are pollable and
nestable): it is READABLE whenever any registered entry has a ready
event.  Entries subscribe to their target's status changes; level- and
edge-triggered modes plus EPOLLONESHOT are modeled the way the
reference's entry state machine does it.
"""

from __future__ import annotations

import errno

from shadow_tpu_torch.host.status import (S_ACTIVE, S_CLOSED, S_ERROR, S_READABLE,
                                    S_WRITABLE, StatusOwner)

EPOLLIN = 0x001
EPOLLPRI = 0x002
EPOLLOUT = 0x004
EPOLLERR = 0x008
EPOLLHUP = 0x010
EPOLLRDHUP = 0x2000
EPOLLONESHOT = 1 << 30
EPOLLET = 1 << 31

EPOLL_CTL_ADD = 1
EPOLL_CTL_DEL = 2
EPOLL_CTL_MOD = 3

# epoll events derived from file status bits.
_WATCH_MASK = S_READABLE | S_WRITABLE | S_CLOSED | S_ERROR


def _events_from_status(status: int, interest: int) -> int:
    ev = 0
    if status & S_READABLE:
        ev |= EPOLLIN
    if status & S_WRITABLE:
        ev |= EPOLLOUT
    if status & S_CLOSED:
        ev |= EPOLLHUP | EPOLLIN
    if status & S_ERROR:
        ev |= EPOLLERR
    # EPOLLERR/EPOLLHUP are always reported; the rest filter by interest.
    return ev & (interest | EPOLLERR | EPOLLHUP)


class _Entry:
    __slots__ = ("file", "interest", "data", "handle", "ready",
                 "oneshot_fired", "edge_armed")

    def __init__(self, file, interest: int, data: int):
        self.file = file
        self.interest = interest
        self.data = data  # u64 epoll_data verbatim
        self.handle = None
        self.ready = 0
        self.oneshot_fired = False
        # Edge-triggered: ready only reported after a fresh transition.
        self.edge_armed = True


class EpollFile(StatusOwner):
    def __init__(self):
        super().__init__()
        self._entries: dict[int, _Entry] = {}  # key: registered (virtual) fd
        self.nonblocking = False
        self._status = S_ACTIVE

    # ------------------------------------------------------------------

    def ctl(self, host, op: int, fd: int, file, interest: int,
            data: int) -> None:
        if op == EPOLL_CTL_ADD:
            if fd in self._entries:
                raise OSError(errno.EEXIST, "fd already registered")
            entry = _Entry(file, interest, data)
            entry.handle = file.add_status_listener(
                _WATCH_MASK, lambda owner, changed, h,
                e=entry: self._on_status(e, h))
            self._entries[fd] = entry
            self._refresh_entry(host, entry)
        elif op == EPOLL_CTL_MOD:
            entry = self._entries.get(fd)
            if entry is None:
                raise OSError(errno.ENOENT, "fd not registered")
            entry.interest = interest
            entry.data = data
            entry.oneshot_fired = False
            entry.edge_armed = True
            self._refresh_entry(host, entry)
        elif op == EPOLL_CTL_DEL:
            entry = self._entries.pop(fd, None)
            if entry is None:
                raise OSError(errno.ENOENT, "fd not registered")
            entry.file.remove_status_listener(entry.handle)
            self._update_own_status(host)
        else:
            raise OSError(errno.EINVAL, f"bad epoll_ctl op {op}")

    def _on_status(self, entry: _Entry, host) -> None:
        entry.edge_armed = True
        self._refresh_entry(host, entry)

    def _refresh_entry(self, host, entry: _Entry) -> None:
        if entry.oneshot_fired:
            entry.ready = 0
        else:
            entry.ready = _events_from_status(entry.file.status,
                                              entry.interest)
            if (entry.interest & EPOLLET) and not entry.edge_armed:
                entry.ready = 0
        self._update_own_status(host)

    def _update_own_status(self, host) -> None:
        any_ready = any(e.ready for e in self._entries.values())
        if any_ready:
            self.adjust_status(host, S_READABLE, 0)
        else:
            self.adjust_status(host, 0, S_READABLE)

    # ------------------------------------------------------------------

    def collect_ready(self, host, max_events: int):
        """-> [(events, data_u64)]; consumes edge/oneshot readiness."""
        out = []
        for entry in list(self._entries.values()):
            if not entry.ready:
                continue
            out.append((entry.ready, entry.data))
            if entry.interest & EPOLLONESHOT:
                entry.oneshot_fired = True
                entry.ready = 0
            if entry.interest & EPOLLET:
                entry.edge_armed = False
                entry.ready = 0
            if len(out) >= max_events:
                break
        self._update_own_status(host)
        return out

    def close(self, host) -> None:
        for entry in self._entries.values():
            entry.file.remove_status_listener(entry.handle)
        self._entries.clear()
        self.adjust_status(host, S_CLOSED, S_ACTIVE | S_READABLE)
