"""Engine loader and per-simulation callback bridge for the port.

The port's counterpart of `shadow_tpu/native/plane.py`.  The engine
(`_netplane`, built from `native/netplane.cpp`) owns every host's inet
data plane, the engine-resident tgen apps and their TCP state; this
module builds and loads the port's own copy of the extension and wires
the engine's callbacks back into the simulation:

 - status changes   -> the socket proxy's mirrored status bits;
 - child born/dead  -> the proxy registry (an accepting tgen server's
                       children are born inside engine calls);
 - RNG draws        -> the host's one deterministic stream.

Both packages' `_netplane` can live in one process (the tests import
both), and the extension has one module name.  The port therefore
loads its artifact by file path and never reads or writes
`sys.modules["_netplane"]`.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import time

from shadow_tpu_torch.native import (LIB_DIR, SRC_DIR, isa_stale,
                                     mark_isa, stale)


class EngineLoader:
    """Build (when stale) and load the engine extension, once."""

    def __init__(self, lib_dir: str = LIB_DIR):
        self.lib_dir = lib_dir
        self.target = os.path.join(
            lib_dir, "_netplane" + sysconfig.get_config_var("EXT_SUFFIX"))
        self.mod = None
        self.error: str | None = None
        self.build_s = 0.0  # wall of the last build (0 when none ran)

    def _build(self) -> bool:
        sources = [os.path.join(SRC_DIR, f)
                   for f in ("netplane.cpp", "Makefile")]
        if not stale(self.target, sources) and not isa_stale(self.target):
            return True
        # Build into a private directory and rename into place: test
        # workers in separate processes may build at the same time, and
        # none of them may load a half-written artifact.
        os.makedirs(self.lib_dir, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".build-", dir=self.lib_dir)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                ["make", "-C", SRC_DIR, "netplane", f"OUT={tmp}",
                 f"PY_INCLUDE={sysconfig.get_paths()['include']}",
                 f"PY_EXT={sysconfig.get_config_var('EXT_SUFFIX')}"],
                capture_output=True, text=True)
            built = os.path.join(tmp, os.path.basename(self.target))
            if proc.returncode != 0 or not os.path.exists(built):
                self.error = (f"netplane build failed (exit "
                              f"{proc.returncode}): {proc.stderr[-2000:]}")
                return False
            mark_isa(built)
            os.replace(built + ".cpu", self.target + ".cpu")
            os.replace(built, self.target)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            self.build_s = time.perf_counter() - t0
        return True

    def load(self):
        """The extension module, or None with `error` set."""
        if self.mod is not None or self.error is not None:
            return self.mod
        if not self._build():
            return None
        # Load by path under the extension's own init name.  Creating a
        # single-phase extension module registers it in sys.modules;
        # put back what was there, so the JAX package's own copy (a
        # plain `import _netplane`) never resolves to this one.
        prev = sys.modules.get("_netplane")
        spec = importlib.util.spec_from_file_location("_netplane",
                                                      self.target)
        try:
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except ImportError as e:
            self.error = f"netplane import failed: {e}"
            return None
        finally:
            if prev is None:
                sys.modules.pop("_netplane", None)
            else:
                sys.modules["_netplane"] = prev
        self.mod = mod
        return mod


_LOADER = EngineLoader()


def load_netplane():
    """The port's engine module (building it if stale), or None."""
    return _LOADER.load()


def load_error() -> str | None:
    return _LOADER.error


def build_seconds() -> float:
    return _LOADER.build_s


class SocketProxy:
    """The Python face of one engine socket that the engine created on
    its own (an accepted child): it mirrors the engine's status bits
    from the CB_STATUS callback, as the reference's proxy does."""

    __slots__ = ("tok", "status")

    def __init__(self, tok: int, status: int):
        self.tok = tok
        self.status = status

    def apply_status(self, set_mask: int, clear_mask: int) -> None:
        self.status = (self.status | set_mask) & ~clear_mask


class NativePlane:
    """Engine + callback bridge for one simulation."""

    def __init__(self, hosts):
        import weakref
        mod = load_netplane()
        if mod is None:
            raise RuntimeError(load_error() or "netplane unavailable")
        self.mod = mod
        self.engine = mod.Engine()
        self._hosts = hosts  # host_id -> Host (list)
        # The engine strong-refs its callbacks; weakref trampolines keep
        # an uncollectable engine -> method -> plane -> engine cycle out.
        wself = weakref.ref(self)

        def on_event(kind, hid, tok, a, b, t):
            p = wself()
            if p is not None:
                p._on_event(kind, hid, tok, a, b, t)

        def rng_u64(hid):
            p = wself()
            return p._rng_u64(hid) if p is not None else 0

        self.engine.set_callbacks(on_event, rng_u64)

    def add_host(self, host, qdisc_rr: bool, mtu: int = 1500) -> None:
        self.engine.add_host(host.id, host.ip, host.bw_up_bits,
                             host.bw_down_bits, qdisc_rr, mtu)
        self.engine.set_host_tcp(
            host.id, 1 if host.tcp_cc == "dctcp" else 0,
            1 if host.tcp_ecn else 0)
        host.plane = self
        # The engine owns the host stream from here on; Python-side
        # draws delegate through rng_next (one shared counter).
        rng = host.rng
        self.engine.set_host_rng(host.id, rng._k0, rng._k1, rng._counter)
        rng.attach_engine(self.engine)

    # -- callbacks (invoked synchronously from inside engine calls) ----

    def _on_event(self, kind: int, hid: int, tok: int, a: int,
                  b: int, t: int) -> None:
        host = self._hosts[hid]
        # The callback carries the engine's current instant; per-host
        # sim time is monotonic.
        if t > host._now:
            host._now = t
        if kind == self.mod.CB_STATUS:
            sock = host.nsocks.get(tok)
            if sock is not None:
                sock.apply_status(a, b)
        elif kind == self.mod.CB_CHILD_BORN:
            # tok = listener, a = child: the proxy exists from birth so
            # status mirroring starts here.
            host.nsocks[a] = SocketProxy(a, self.engine.sock_status(a))
        else:  # CB_CHILD_DEAD: pre-accept teardown
            host.nsocks.pop(tok, None)

    def _rng_u64(self, hid: int) -> int:
        return self._hosts[hid].rng.next_u64()


