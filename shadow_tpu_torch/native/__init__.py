"""The shared native sources (`native/`): build-on-demand and path
discovery for the port.

The sources are shared, not JAX-package code: the port builds its own
copies into a gitignored directory of its own
(`shadow_tpu_torch/native/lib/`) with the repository's Makefile, whose
`OUT` is overridable from the command line:

 - the C++ engine (`native/netplane.cpp`, native/plane.py loads it).
   The staleness and ISA-sidecar rules are the JAX package's: the engine
   builds with -march=native, so an artifact from another CPU is
   rebuilt, never imported (a mismatch dies by SIGILL, not by an
   exception);
 - the shim (`native/shim.c`), LD_PRELOADed into managed processes and
   never loaded into this process (its constructor installs a seccomp
   filter; on a kernel without the rdtsc trap, gVisor's, it is built
   without that trap and its vDSO patch: `ensure_shim_built`), and the
   opt-in crypto no-op
   preload (`native/crypto_noop.c`).
   `ensure_shim_built` / `ensure_crypto_noop_built` build them at first
   use and raise when the build fails.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading

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


SHIM_SO = os.path.join(LIB_DIR, "libshadowtpu_shim.so")
SHIM_GVISOR_SO = os.path.join(LIB_DIR, "libshadowtpu_shim_gvisor.so")
CRYPTO_NOOP_SO = os.path.join(LIB_DIR, "libshadowtpu_crypto_noop.so")
_BUILD_LOCK = threading.Lock()


def ensure_built(so_path: str, target: str, source_names: list[str],
                 built_name: str | None = None,
                 make_args: tuple = ()) -> str:
    """Build the Makefile's `target` into `so_path` when it is missing or
    older than its sources (`source_names` in native/, or absolute
    paths); return the path.  The build runs in a private directory and
    renames into place, so processes building at the same time never
    load a half-written artifact.  Raises RuntimeError with the
    compiler's output when the build fails."""
    sources = [os.path.join(SRC_DIR, f) for f in source_names]
    with _BUILD_LOCK:
        if not stale(so_path, sources):
            return so_path
        os.makedirs(LIB_DIR, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".build-", dir=LIB_DIR)
        try:
            proc = subprocess.run(
                ["make", "-C", SRC_DIR, target, f"OUT={tmp}", *make_args],
                capture_output=True, text=True)
            built = os.path.join(tmp, built_name
                                 or os.path.basename(so_path))
            if proc.returncode != 0 or not os.path.exists(built):
                raise RuntimeError(
                    f"{target} build failed (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(built, so_path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return so_path


def tsc_trap_supported() -> bool:
    """Whether this kernel serves prctl(PR_GET_TSC), and with it the
    shim's rdtsc trap (PR_SET_TSC).  gVisor refuses both."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    val = ctypes.c_int(0)
    return libc.prctl(25, ctypes.byref(val), 0, 0, 0) == 0  # PR_GET_TSC


def ensure_shim_built() -> str:
    """The shim, built from native/.  Where the kernel refuses the rdtsc
    trap (gVisor), the build force-includes shim_gvisor.h, which
    compiles out the rdtsc trap and the vDSO patch (into its own
    library, libshadowtpu_shim_gvisor.so): the shim otherwise dies at
    start there.  The header rides on the compiler's command (`CC`), so
    the Makefile's own CFLAGS stay in force for both builds."""
    sources = ["shim.c", "shim_trampoline.S", "shim_ipc.h", "Makefile"]
    if tsc_trap_supported():
        return ensure_built(SHIM_SO, "shim", sources)
    header = os.path.join(_PKG_DIR, "shim_gvisor.h")
    cc = os.environ.get("CC", "cc")
    return ensure_built(
        SHIM_GVISOR_SO, "shim", sources + [header],
        built_name=os.path.basename(SHIM_SO),
        make_args=(f"CC={cc} -include {header}",))


def shim_build(path: str) -> str:
    """Which build of the shim `path` is: "full", or "gvisor" (no rdtsc
    trap, no vDSO patch: a binary that executes rdtsc itself, or calls
    the vDSO without libc, reads the host's clock)."""
    return "gvisor" if path == SHIM_GVISOR_SO else "full"


def ensure_crypto_noop_built() -> str:
    return ensure_built(CRYPTO_NOOP_SO, "crypto_noop",
                        ["crypto_noop.c", "Makefile"])
