"""The shared C++ engine (`native/netplane.cpp`): build-on-demand and
path discovery for the port.

The engine is shared source, not JAX-package code: the port builds its
own copy into a gitignored directory of its own
(`shadow_tpu_torch/native/lib/`) with the repository's Makefile, whose
`OUT` is overridable from the command line.  The staleness and
ISA-sidecar rules are the JAX package's: the engine builds with
-march=native, so an artifact from another CPU is rebuilt, never
imported (a mismatch dies by SIGILL, not by an exception).
"""

from __future__ import annotations

import hashlib
import os
import platform

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_PKG_DIR))
SRC_DIR = os.path.join(_REPO_ROOT, "native")
LIB_DIR = os.path.join(_PKG_DIR, "lib")


def stale(target: str, sources: list[str]) -> bool:
    if not os.path.exists(target):
        return True
    t = os.path.getmtime(target)
    return any(os.path.getmtime(s) > t for s in sources
               if os.path.exists(s))


def cpu_fingerprint() -> str:
    """ISA identity for -march=native artifacts."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(line.encode()).hexdigest()[:16]
    except OSError:
        pass
    return platform.machine()


def isa_stale(target: str) -> bool:
    """True when `target` was built on a CPU with other ISA flags (or
    carries no sidecar at all)."""
    try:
        with open(target + ".cpu") as f:
            return f.read().strip() != cpu_fingerprint()
    except OSError:
        return os.path.exists(target)


def mark_isa(target: str) -> None:
    with open(target + ".cpu", "w") as f:
        f.write(cpu_fingerprint())
