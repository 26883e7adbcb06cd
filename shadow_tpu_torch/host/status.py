"""File status bits and status listeners.

Ref: the C StatusListener (src/main/host/status_listener.c) and the file
state bits used across descriptor/*.rs. Every pollable object (socket,
pipe, eventfd, timerfd, epoll) carries a status bitmask; listeners
(epoll entries, blocked-syscall conditions) subscribe to a mask and fire
when any watched bit *changes*.

The port's copy of `shadow_tpu/host/status.py`.
"""

from __future__ import annotations

# Status bits (descriptor/mod.rs FileState)
S_ACTIVE = 1 << 0      # open and usable
S_READABLE = 1 << 1
S_WRITABLE = 1 << 2
S_CLOSED = 1 << 3
S_ERROR = 1 << 4
S_SOCKET_ALLOWING_CONNECT = 1 << 5  # listener with room in accept queue


class StatusOwner:
    """Mixin holding a status bitmask + listener registry."""

    def __init__(self):
        self._status = 0
        self._listeners: list = []  # (mask, callback) pairs
        from shadow_tpu_torch.utils.object_counter import count_alloc
        count_alloc(type(self).__name__)

    @property
    def status(self) -> int:
        return self._status

    def has_status(self, mask: int) -> bool:
        return bool(self._status & mask)

    def add_status_listener(self, mask: int, callback) -> object:
        """callback(owner, changed_bits, host). Returns a removal handle."""
        handle = [mask, callback, True]
        self._listeners.append(handle)
        return handle

    def remove_status_listener(self, handle) -> None:
        handle[2] = False
        try:
            self._listeners.remove(handle)
        except ValueError:
            pass

    def adjust_status(self, host, set_mask: int, clear_mask: int = 0) -> None:
        old = self._status
        new = (old | set_mask) & ~clear_mask
        if new == old:
            return
        self._status = new
        changed = old ^ new
        # Copy: callbacks may add/remove listeners reentrantly.
        for handle in list(self._listeners):
            mask, callback, alive = handle
            if alive and (changed & mask):
                callback(self, changed, host)
