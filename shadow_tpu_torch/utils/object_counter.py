"""Object lifecycle accounting: the port's copy of
`shadow_tpu/utils/object_counter.py`.

Every pollable simulated object counts its allocation at construction
and its deallocation when the last reference releases it; the manager
writes the table to sim-stats.json and warns about classes with
alloc != dealloc.  The object path's sockets and descriptors count
here; engine-resident hosts build no such Python object (their sockets
live in the C++ engine).  The counters are lock-protected: host threads
allocate concurrently.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_alloc: dict[str, int] = {}
_dealloc: dict[str, int] = {}


def count_alloc(kind: str) -> None:
    with _lock:
        _alloc[kind] = _alloc.get(kind, 0) + 1


def count_dealloc(kind: str) -> None:
    with _lock:
        _dealloc[kind] = _dealloc.get(kind, 0) + 1


def mark_dealloc(obj) -> None:
    """Count `obj` deallocated exactly once, when its last reference
    releases it."""
    if getattr(obj, "_oc_dead", False):
        return
    obj._oc_dead = True
    count_dealloc(type(obj).__name__)


def snapshot() -> dict:
    return {kind: {"allocated": _alloc.get(kind, 0),
                   "deallocated": _dealloc.get(kind, 0)}
            for kind in sorted(set(_alloc) | set(_dealloc))}


def leaks() -> dict[str, int]:
    return {kind: v["allocated"] - v["deallocated"]
            for kind, v in snapshot().items()
            if v["allocated"] != v["deallocated"]}


def reset() -> None:
    """Fresh accounting for a new simulation (tests run many)."""
    with _lock:
        _alloc.clear()
        _dealloc.clear()
