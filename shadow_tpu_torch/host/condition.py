"""Blocking-syscall conditions.

Ref: src/main/host/syscall/syscall_condition.c:48,421-480 — the primitive
a blocked syscall parks on: a trigger (file-status change) and/or a
timeout; whichever fires first schedules the thread's wakeup task and
disarms the other. Timer events in the heap can't be revoked, so timeout
tasks re-check an armed flag (the reference revokes via its Timer; same
observable behavior).

The port's copy of `shadow_tpu/host/condition.py`, without the
futex and poll conditions of the managed processes (ROADMAP A7b).
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
