"""Descriptor table (ref: src/main/host/descriptor/descriptor_table.rs).

Maps fds to file objects, allocating the lowest available fd like Linux.
File objects are StatusOwner subclasses with a `close(host)` method.

Open file descriptions are refcounted on the object (`_open_refs`):
the underlying object only really closes when the last fd referring to
it goes away — the same lifecycle the reference gets from its
CompatFile refcounts (descriptor/mod.rs).

The port's copy of `shadow_tpu/host/descriptor.py`, without dup, fork
and close-on-exec (the managed processes', ROADMAP A7b).
"""

from __future__ import annotations

import errno


def _incref(file) -> None:
    file._open_refs = getattr(file, "_open_refs", 0) + 1


def _decref(file, host) -> None:
    refs = getattr(file, "_open_refs", 1) - 1
    file._open_refs = refs
    if refs <= 0 and hasattr(file, "close"):
        file.close(host)
        from shadow_tpu_torch.utils.object_counter import mark_dealloc
        mark_dealloc(file)


class DescriptorTable:
    __slots__ = ("_fds",)

    def __init__(self):
        self._fds: dict[int, object] = {}

    def register(self, file, min_fd: int = 3) -> int:
        fd = min_fd
        while fd in self._fds:
            fd += 1
        self._fds[fd] = file
        _incref(file)
        return fd

    def get(self, fd: int):
        f = self._fds.get(fd)
        if f is None:
            raise OSError(errno.EBADF, "bad file descriptor")
        return f

    def close_fd(self, host, fd: int) -> None:
        f = self._fds.pop(fd, None)
        if f is None:
            raise OSError(errno.EBADF, "bad file descriptor")
        _decref(f, host)

    def close_all(self, host) -> None:
        for fd in sorted(self._fds, reverse=True):
            _decref(self._fds.pop(fd), host)

    def __len__(self):
        return len(self._fds)
