"""Descriptor table (ref: src/main/host/descriptor/descriptor_table.rs).

Maps fds to file objects, allocating the lowest available fd like Linux.
File objects are StatusOwner subclasses with a `close(host)` method.

Open file descriptions are refcounted on the object (`_open_refs`):
dup() aliases within one table and fork() shares across tables both
bump the count, and the underlying object only really closes when the
last fd referring to it goes away — the same lifecycle the reference
gets from its CompatFile refcounts (descriptor/mod.rs).
"""

from __future__ import annotations

import errno


def _incref(file) -> None:
    file._open_refs = getattr(file, "_open_refs", 0) + 1


class NativeFdRef:
    """A manager-held duplicate (pidfd_getfd) of a managed process's
    NATIVE fd, in flight over an emulated unix socket via SCM_RIGHTS.
    Delivery hands the real fd to the receiving process over its
    transfer socket (ref: socket/unix.rs fd passing; our fd-split
    design keeps file fds native, so passing one crosses the real
    kernel).  Carries `_open_refs` like any descriptor object so the
    in-flight queue's incref/decref lifecycle closes the manager's dup
    exactly once."""

    __slots__ = ("mgr_fd", "_open_refs", "_oc_dead")

    def __init__(self, mgr_fd: int):
        self.mgr_fd = mgr_fd
        from shadow_tpu_torch.utils.object_counter import count_alloc
        count_alloc("NativeFdRef")

    def close(self, host) -> None:
        import os
        if self.mgr_fd >= 0:
            try:
                os.close(self.mgr_fd)
            except OSError:
                pass
            self.mgr_fd = -1


def _decref(file, host) -> None:
    refs = getattr(file, "_open_refs", 1) - 1
    file._open_refs = refs
    if refs <= 0 and hasattr(file, "close"):
        file.close(host)
        from shadow_tpu_torch.utils.object_counter import mark_dealloc
        mark_dealloc(file)


class DescriptorTable:
    __slots__ = ("_fds", "_cloexec", "_next_hint")

    def __init__(self):
        self._fds: dict[int, object] = {}
        self._cloexec: set[int] = set()
        self._next_hint = 0

    # fds 0-2 are reserved for stdio (sys_write special-cases 1/2), so
    # registered files never alias them.
    def register(self, file, min_fd: int = 3, cloexec: bool = False) -> int:
        fd = min_fd
        while fd in self._fds:
            fd += 1
        self._fds[fd] = file
        if cloexec:
            self._cloexec.add(fd)
        _incref(file)
        return fd

    def register_at(self, fd: int, file, cloexec: bool = False) -> None:
        assert fd not in self._fds, "register_at over a live fd"
        self._fds[fd] = file
        if cloexec:
            self._cloexec.add(fd)
        _incref(file)

    def get_opt(self, fd: int):
        """Like get() but returns None instead of raising EBADF."""
        return self._fds.get(fd)

    def get(self, fd: int):
        f = self._fds.get(fd)
        if f is None:
            raise OSError(errno.EBADF, "bad file descriptor")
        return f

    def close_fd(self, host, fd: int) -> None:
        f = self._fds.pop(fd, None)
        self._cloexec.discard(fd)
        if f is None:
            raise OSError(errno.EBADF, "bad file descriptor")
        _decref(f, host)

    def set_cloexec(self, fd: int, on: bool) -> None:
        if fd in self._fds:
            (self._cloexec.add if on else self._cloexec.discard)(fd)

    def get_cloexec(self, fd: int) -> bool:
        return fd in self._cloexec

    def close_all(self, host) -> None:
        for fd in sorted(self._fds, reverse=True):
            _decref(self._fds.pop(fd), host)
        self._cloexec.clear()

    def close_cloexec(self, host) -> None:
        """execve: close close-on-exec fds, keep the rest."""
        for fd in sorted(self._cloexec, reverse=True):
            f = self._fds.pop(fd, None)
            if f is not None:
                _decref(f, host)
        self._cloexec.clear()

    def fork_copy(self) -> "DescriptorTable":
        """Child's table after fork: same open file descriptions,
        independently closable fds (process.rs fork path)."""
        child = DescriptorTable()
        child._fds = dict(self._fds)
        child._cloexec = set(self._cloexec)
        for f in child._fds.values():
            _incref(f)
        return child

    def open_fds(self):
        return sorted(self._fds)

    def items(self):
        """(fd, file) pairs — the public iteration surface."""
        return list(self._fds.items())

    def replace(self, fd: int, new_file) -> None:
        """Swap the object behind an fd (fork-time per-process clones
        like SignalFd); ref accounting moves with it."""
        old = self._fds[fd]
        self._fds[fd] = new_file
        _incref(new_file)
        _decref(old, None)

    def __len__(self):
        return len(self._fds)
