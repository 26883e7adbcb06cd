"""Lane-parallel queue-scan laws: plain PyTorch versions and the
hand-written CUDA kernels (`csrc/queues.cu`) behind one wrapper each.

The port's counterpart of `shadow_tpu/ops/pallas_queues.py`: two
elementwise integer laws over the host lane, the token-bucket refill
and conformance scan and the CoDel head classification of a relay
drain.  The TCP device span runs both inside its fused relay kernels
(ops/relay.py, csrc/relay.cu), whose plain versions call the laws
below; the standalone kernels here serve one law per launch.

- `bucket_step_ref` / `codel_head_ref` are the laws in plain PyTorch.
  A wrapper uses them only for tensors that lie on the CPU (the tier-1
  tests); `chip_smoke.py` holds the kernels against them on the card.
- `BucketStep` / `CodelHead` are the wrappers, and `BUCKET_STEP` /
  `CODEL_HEAD` the one instance of each that the span runners share
  (the PHOLD/udp-mesh relays call them in the eager window; the card's
  fused PHOLD window runs the laws inside `stt_phold_window` and the TCP
  relays inside their fused kernels).  For CUDA tensors they launch the
  kernel or raise: there is no fallback.  Each keeps a plain integer
  launch counter, bumped only where it launches its kernel.

The kernels build at first use with nvcc for sm_90a into the gitignored
`shadow_tpu_torch/csrc/build/` and bind through a plain C interface
with ctypes.  Nothing here imports or builds anything at import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time

import torch

# CoDel's control-law interval (netplane codel_pop twin): the
# first_above arm horizon.
CODEL_INTERVAL_NS = 100_000_000
# The engine's refill interval, CoDel target and MTU (netplane.cpp).
REFILL_NS = 1_000_000
CODEL_TARGET_NS = 5_000_000
MTU = 1500

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def bucket_step_ref(refill_ns, bal, nxt, refill, cap, unlimited, size,
                    now):
    """Token-bucket refill + conformance for every host lane (netplane
    token_bucket twin): first touch arms, else a lazy catch-up refill of
    `k` whole intervals, then the conformance check and debit.  Returns
    (bal3, nxt2, ok); the caller owns the masked writeback."""
    first = nxt == 0
    k = torch.clamp(1 + torch.div(now - nxt, refill_ns,
                                  rounding_mode="floor"), min=0)
    do_ref = ~first & (now >= nxt)
    bal2 = torch.where(do_ref, torch.minimum(cap, bal + k * refill), bal)
    nxt2 = torch.where(first, now + refill_ns,
                       torch.where(do_ref, nxt + k * refill_ns, nxt))
    ok = unlimited | (size <= bal2)
    bal3 = torch.where(~unlimited & ok, bal2 - size, bal2)
    return bal3, nxt2, ok


def codel_head_ref(target_ns, mtu, pop, none, now, enq, bytes_after,
                   first_above):
    """CoDel head classification of one relay dequeue per lane (netplane
    codel_pop dequeue_raw twin).  `bytes_after` is the queue byte count
    AFTER the pop.  Returns (quiet, above, arm, cok, fa_new)."""
    sojourn = now - enq
    quiet = pop & ((sojourn < target_ns) | (bytes_after <= mtu))
    above = pop & ~quiet
    arm = above & (first_above == 0)
    cok = above & ~arm & (now >= first_above)
    fa_new = torch.where(
        quiet | none, 0,
        torch.where(arm, now + CODEL_INTERVAL_NS, first_above))
    return quiet, above, arm, cok, fa_new


class KernelLibrary:
    """One compiled kernel library: `source` in csrc/ (with the headers
    there) built once per process with nvcc, or found already built and
    newer than every source, and loaded with ctypes.  `declare(lib)`
    sets the argument and result types of its C functions; `flags` are
    added to nvcc's, and `log` keeps what nvcc printed."""

    def __init__(self, source: str, name: str, declare, error_fn: str,
                 flags: tuple = ()):
        self.source = source
        self.name = name
        self.declare = declare
        self.error_fn = error_fn
        self.flags = tuple(flags)
        self.lib = None
        self.build_s = 0.0
        self.log = ""

    def path(self) -> str:
        return os.path.join(BUILD_DIR, self.name)

    def _stale(self, out: str, src: str) -> bool:
        if not os.path.exists(out):
            return True
        deps = [src] + [os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                        if f.endswith(".cuh")]
        return os.path.getmtime(out) < max(map(os.path.getmtime, deps))

    def build(self) -> ctypes.CDLL:
        if self.lib is not None:
            return self.lib
        src = os.path.join(_CSRC, self.source)
        out = self.path()
        if self._stale(out, src):
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = os.path.join(os.environ.get("CUDA_HOME",
                                               "/usr/local/cuda"),
                                "bin", "nvcc")
            if not os.path.exists(nvcc):
                nvcc = "nvcc"
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, *self.flags, "-o", tmp, src],
                capture_output=True, text=True)
            self.build_s = time.perf_counter() - t0
            self.log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        self.declare(lib)
        getattr(lib, self.error_fn).argtypes = [ctypes.c_int]
        getattr(lib, self.error_fn).restype = ctypes.c_char_p
        self.lib = lib
        return lib

    def check(self, code: int, name: str) -> None:
        if code != 0:
            msg = getattr(self.lib, self.error_fn)(code).decode()
            raise RuntimeError(f"{name} launch failed: {msg} ({code})")


def _declare_queues(lib) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.stt_bucket_step.argtypes = [p, p, p, p, p, p, i64, p, i64, i64,
                                    i64, p, p, p, p]
    lib.stt_codel_head.argtypes = [p, p, p, i64, p, p, p, i64, i64, i64,
                                   i64, p, p, p, p, p, p]
    lib.stt_bucket_step_repeat.argtypes = \
        lib.stt_bucket_step.argtypes[:-1] + [i32, p]
    lib.stt_codel_head_repeat.argtypes = \
        lib.stt_codel_head.argtypes[:-1] + [i32, p]
    for fn in (lib.stt_bucket_step, lib.stt_codel_head,
               lib.stt_bucket_step_repeat, lib.stt_codel_head_repeat):
        fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("queues.cu", "libstt_queues.so", _declare_queues,
                        "stt_error_string")


def _lanes(name: str, t, n: int, dtype, scalar_ok: bool = False):
    """Validate one operand; returns its lane stride (0 for a 0-d
    operand broadcast to every lane, 1 for an (n,) lane vector)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if scalar_ok and t.dim() == 0:
        return 0
    if t.shape != (n,):
        raise ValueError(f"{name}: expected shape ({n},), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return 1


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class BucketStep:
    """Wrapper of the token-bucket kernel (replaces
    pallas_queues.make_bucket_step).  Call signature matches the JAX
    step: (bal, nxt, refill, cap, unlimited, size, now) ->
    (bal3, nxt2, ok); `size` and `now` may be 0-d."""

    def __init__(self, refill_ns: int):
        self.refill_ns = int(refill_ns)
        self.launches = 0

    def __call__(self, bal, nxt, refill, cap, unlimited, size, now):
        if bal.device.type == "cpu":
            return bucket_step_ref(self.refill_ns, bal, nxt, refill, cap,
                                   unlimited, size, now)
        return self.launch(bal, nxt, refill, cap, unlimited, size, now)

    def launch(self, bal, nxt, refill, cap, unlimited, size, now, reps=0):
        """Validate, allocate the outputs and launch on the current
        stream; `reps > 0` launches that many times back to back (the
        timing entry point) and counts no launch."""
        n = bal.shape[0] if bal.dim() == 1 else -1
        i64 = torch.int64
        for name, t in (("bal", bal), ("nxt", nxt), ("refill", refill),
                        ("cap", cap)):
            _lanes(name, t, n, i64)
        _lanes("unlimited", unlimited, n, torch.bool)
        s_size = _lanes("size", size, n, i64, scalar_ok=True)
        s_now = _lanes("now", now, n, i64, scalar_ok=True)
        lib = LIBRARY.build()
        bal3 = torch.empty_like(bal)
        nxt2 = torch.empty_like(nxt)
        ok = torch.empty_like(unlimited)
        args = (bal.data_ptr(), nxt.data_ptr(), refill.data_ptr(),
                cap.data_ptr(), unlimited.data_ptr(), size.data_ptr(),
                s_size, now.data_ptr(), s_now, self.refill_ns, n,
                bal3.data_ptr(), nxt2.data_ptr(), ok.data_ptr())
        stream = _stream_ptr(bal.device)
        if reps:
            code = lib.stt_bucket_step_repeat(*args, reps, stream)
        else:
            code = lib.stt_bucket_step(*args, stream)
            self.launches += 1
        LIBRARY.check(code, "bucket_step")
        return bal3, nxt2, ok


class CodelHead:
    """Wrapper of the CoDel head kernel (replaces
    pallas_queues.make_codel_head).  Call signature matches the JAX
    head: (pop, none, now, enq, bytes_after, first_above) ->
    (quiet, above, arm, cok, fa_new); `now` may be 0-d."""

    def __init__(self, target_ns: int, mtu: int):
        self.target_ns = int(target_ns)
        self.mtu = int(mtu)
        self.launches = 0

    def __call__(self, pop, none, now, enq, bytes_after, first_above):
        if pop.device.type == "cpu":
            return codel_head_ref(self.target_ns, self.mtu, pop, none, now,
                                  enq, bytes_after, first_above)
        return self.launch(pop, none, now, enq, bytes_after, first_above)

    def launch(self, pop, none, now, enq, bytes_after, first_above,
               reps=0):
        """As BucketStep.launch."""
        n = pop.shape[0] if pop.dim() == 1 else -1
        i64 = torch.int64
        _lanes("pop", pop, n, torch.bool)
        _lanes("none", none, n, torch.bool)
        s_now = _lanes("now", now, n, i64, scalar_ok=True)
        for name, t in (("enq", enq), ("bytes_after", bytes_after),
                        ("first_above", first_above)):
            _lanes(name, t, n, i64)
        lib = LIBRARY.build()
        outs = [torch.empty_like(pop) for _ in range(4)]
        fa = torch.empty_like(first_above)
        args = (pop.data_ptr(), none.data_ptr(), now.data_ptr(), s_now,
                enq.data_ptr(), bytes_after.data_ptr(),
                first_above.data_ptr(), self.target_ns, self.mtu,
                CODEL_INTERVAL_NS, n, *(o.data_ptr() for o in outs),
                fa.data_ptr())
        stream = _stream_ptr(pop.device)
        if reps:
            code = lib.stt_codel_head_repeat(*args, reps, stream)
        else:
            code = lib.stt_codel_head(*args, stream)
            self.launches += 1
        LIBRARY.check(code, "codel_head")
        return (*outs, fa)


# The one wrapper of each standalone kernel: chip_smoke.py zeroes their
# launch counters before a main path and reads them after.
BUCKET_STEP = BucketStep(REFILL_NS)
CODEL_HEAD = CodelHead(CODEL_TARGET_NS, MTU)
