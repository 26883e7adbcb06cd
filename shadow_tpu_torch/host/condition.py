"""Blocking-syscall conditions.

Ref: src/main/host/syscall/syscall_condition.c:48,421-480 — the primitive
a blocked syscall parks on: a trigger (file-status change) and/or a
timeout; whichever fires first schedules the thread's wakeup task and
disarms the other. Timer events in the heap can't be revoked, so timeout
tasks re-check an armed flag (the reference revokes via its Timer; same
observable behavior).
"""

from __future__ import annotations

from shadow_tpu_torch.core.event import TaskRef


class SyscallCondition:
    __slots__ = ("_file", "_mask", "_timeout_at", "_armed", "_listener_handle",
                 "_wakeup_fn", "timed_out")

    def __init__(self, file=None, mask: int = 0, timeout_at: int | None = None):
        assert file is not None or timeout_at is not None
        self._file = file
        self._mask = mask
        self._timeout_at = timeout_at
        self._armed = False
        self._listener_handle = None
        self._wakeup_fn = None
        self.timed_out = False

    def arm(self, host, wakeup_fn) -> None:
        """wakeup_fn(host) runs (as a scheduled task) when triggered."""
        assert not self._armed
        self._armed = True
        self._wakeup_fn = wakeup_fn
        if self._file is not None:
            # Fire immediately if the status is already satisfied — the
            # caller checked once before blocking, but a status change can
            # race between check and arm in principle; re-checking keeps
            # the contract obvious.
            if self._file.status & self._mask:
                self._fire(host, timed_out=False)
                return
            self._listener_handle = self._file.add_status_listener(
                self._mask, self._on_status)
        if self._armed and self._timeout_at is not None:
            host.schedule_task_at(self._timeout_at,
                                  TaskRef("condition-timeout", self._on_timeout))

    def disarm(self) -> None:
        self._armed = False
        if self._listener_handle is not None and self._file is not None:
            self._file.remove_status_listener(self._listener_handle)
            self._listener_handle = None

    def _on_status(self, owner, changed, host) -> None:
        if self._armed:
            self._fire(host, timed_out=False)

    def _on_timeout(self, host) -> None:
        if self._armed and host.now() >= self._timeout_at:
            self._fire(host, timed_out=True)

    def _fire(self, host, timed_out: bool) -> None:
        self.disarm()
        self.timed_out = timed_out
        # Wake via a fresh task so the unblocked thread runs from the event
        # loop, not from inside whatever triggered the status change.
        host.schedule_task_at(host.now(), TaskRef("syscall-wakeup",
                                                  self._wakeup_fn))


class ManualCondition:
    """A condition fired explicitly by simulator code (plus an optional
    timeout) — the shape futex waits need: there is no file whose status
    changes, just another thread's FUTEX_WAKE (ref: the futex trigger
    arm of syscall_condition.c:48).  Same arm/disarm/timed_out interface
    as SyscallCondition."""

    __slots__ = ("_timeout_at", "_armed", "_wakeup_fn", "timed_out",
                 "on_disarm")

    def __init__(self, timeout_at: int | None = None):
        self._timeout_at = timeout_at
        self._armed = False
        self._wakeup_fn = None
        self.timed_out = False
        self.on_disarm = None  # cleanup hook (e.g. drop the futex waiter)

    def arm(self, host, wakeup_fn) -> None:
        assert not self._armed
        self._armed = True
        self._wakeup_fn = wakeup_fn
        if self._timeout_at is not None:
            host.schedule_task_at(self._timeout_at,
                                  TaskRef("condition-timeout",
                                          self._on_timeout))

    def disarm(self) -> None:
        self._armed = False
        if self.on_disarm is not None:
            hook, self.on_disarm = self.on_disarm, None
            hook()

    def fire(self, host) -> None:
        """External trigger (e.g. FUTEX_WAKE)."""
        if self._armed:
            self._fire(host, timed_out=False)

    def _on_timeout(self, host) -> None:
        if self._armed and host.now() >= self._timeout_at:
            self._fire(host, timed_out=True)

    def _fire(self, host, timed_out: bool) -> None:
        self.disarm()
        self.timed_out = timed_out
        host.schedule_task_at(host.now(), TaskRef("syscall-wakeup",
                                                  self._wakeup_fn))


class MultiSyscallCondition:
    """poll/select/epoll-style condition: wake when ANY of several files
    gains a watched status bit, or on timeout — the many-trigger shape
    the reference builds from one SyscallCondition per status listener
    plus its timeout (syscall_condition.c:421-480); one object here.

    Same arm/disarm/timed_out interface as SyscallCondition so Thread
    and ManagedThread treat both uniformly.
    """

    __slots__ = ("_watches", "_timeout_at", "_armed", "_handles",
                 "_wakeup_fn", "timed_out")

    def __init__(self, watches: list, timeout_at: int | None = None):
        """watches: [(file, mask), ...]; may be empty for a pure sleep."""
        assert watches or timeout_at is not None
        self._watches = watches
        self._timeout_at = timeout_at
        self._armed = False
        self._handles = []
        self._wakeup_fn = None
        self.timed_out = False

    def arm(self, host, wakeup_fn) -> None:
        assert not self._armed
        self._armed = True
        self._wakeup_fn = wakeup_fn
        for file, mask in self._watches:
            if file.status & mask:
                self._fire(host, timed_out=False)
                return
        for file, mask in self._watches:
            self._handles.append(
                (file, file.add_status_listener(mask, self._on_status)))
        if self._armed and self._timeout_at is not None:
            host.schedule_task_at(self._timeout_at,
                                  TaskRef("condition-timeout",
                                          self._on_timeout))

    def disarm(self) -> None:
        self._armed = False
        for file, handle in self._handles:
            file.remove_status_listener(handle)
        self._handles = []

    def _on_status(self, owner, changed, host) -> None:
        if self._armed:
            self._fire(host, timed_out=False)

    def _on_timeout(self, host) -> None:
        if self._armed and host.now() >= self._timeout_at:
            self._fire(host, timed_out=True)

    def _fire(self, host, timed_out: bool) -> None:
        self.disarm()
        self.timed_out = timed_out
        host.schedule_task_at(host.now(), TaskRef("syscall-wakeup",
                                                  self._wakeup_fn))
