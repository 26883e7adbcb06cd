"""Per-round packet propagation: the plain law, the hand-written CUDA
kernel behind its wrapper, the route model and the per-round
propagator of engine-resident hosts.

The port's counterpart of `shadow_tpu/ops/propagate.py`, engine half.
Every round the per-round loop serves, the C++ engine gathers the
packets its hosts sent (`export_round`); a whole round of them, across
all hosts, goes through one law:

    latency  = L[src_node, dst_node]
    bits     = threefry2x32(key, (src_host, pkt_seq))
    lossy    = bits < T[src_node, dst_node]  (not control, after bootstrap)
    deliver  = max(t_send + latency, window_end)
    minima   = min(deliver | keep), min(latency | keep)

and the engine applies the decisions (`scatter_round`).  Both routes
are bit-identical: the engine's C++ twin (`finish_round`, ROUTE_HOST)
and the kernel (ROUTE_DEVICE) use the same integer matrices and the
same threefry bits, so routing is a choice of speed only, made online
by `DeviceRouteModel` (a copy of the reference's, decisions unchanged).

- `propagate_ref` is the law in plain PyTorch.  The wrapper uses it
  only for tensors that lie on the CPU (the tier-1 tests, and a Manager
  run with `device="cpu"`); `chip_smoke.py` holds the kernel against it
  on the card.
- `Propagate` is the wrapper of `csrc/propagate.cu`
  `stt_propagate_round`, and `PROPAGATE` its one instance.  On the card
  it launches the kernel or raises: there is no fallback.  It keeps two
  plain launch counters, bumped only where it launches: `launches` (the
  critical path) and `probe_launches` (the route model's measurement
  probes).
- `RoundStage` is a round's buffer: on the card pinned host memory
  mapped into the card's address space, and the plan of the one C call
  a round makes (`csrc/propagate_plan.h`).
- `TpuPropagator` runs one round: the route model's decision, then the
  engine's twin, or export -> the columns written into the stage's
  buffer -> one call (the kernel reads and writes the buffer in place
  over the bus, or, for a round of at least `COPY_MIN_PACKETS`, through
  one copy each way) -> scatter.  Object-path hosts (`send`) are ROADMAP
  A2b.

The kernel builds at first use with nvcc for sm_90a into the gitignored
`shadow_tpu_torch/csrc/build/` and binds through a plain C interface
with ctypes.  Nothing here imports or builds anything at import time.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import threading
import time
import weakref

import numpy as np
import torch

from shadow_tpu_torch.core.rng import (STREAM_PACKET_LOSS, mix_key,
                                       threefry2x32_torch)
from shadow_tpu_torch.core.simtime import TIME_NEVER
from shadow_tpu_torch.ops.queues import KernelLibrary, _stream_ptr

I64_MAX = (1 << 63) - 1
_MIN_BUCKET = 256
_M32 = 0xFFFFFFFF

# DeviceRouteModel.decide() outcomes.
ROUTE_HOST = 0    # the engine's bit-identical C++ twin serves the round
ROUTE_DEVICE = 1  # the kernel serves it: measured and winning (or forced)
ROUTE_PROBE = 2   # the twin serves it; the kernel is measured off the
#                   critical path (async) to keep the model honest

_RM_OBJECT_PATH = "ROADMAP A2b (object-path hosts)"

# A `tpu_min_device_batch` no round reaches: every per-round round goes to
# the C++ twin (the span loops' timing tools and chip_smoke.py's span
# phases run so, to measure spans alone).
HOST_ONLY = 1 << 40


def _bucket(n: int) -> int:
    """Round-size class of the route model's per-size estimates (the
    kernel itself takes any n)."""
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b


class DeviceRouteModel:
    """Online device-vs-host dispatch routing (the reference's model,
    decisions unchanged).

    Both routes produce bit-identical decisions, so routing is purely a
    performance choice.  EWMA ns/packet for the host route, EWMA
    ns/dispatch per bucket size for the device; when the device is
    losing at a size, re-probe with exponential backoff (a catastrophic
    loss jumps straight to the cap).
    """

    # Initial re-probe cadence at a bucket size routed to the host.
    REPROBE_EVERY = 64
    REPROBE_CAP = 4096
    # Measurement overhead cap: probes may consume at most this fraction
    # of elapsed wall.
    PROBE_BUDGET_FRAC = 0.01

    def __init__(self, min_device_batch: int, kind: str = "single"):
        self.min_device_batch = min_device_batch
        self._t_start_ns = time.perf_counter_ns()
        self.probe_spent_ns = 0.0
        # Dispatch kind for the process-wide floor: floors share only
        # within a kind.
        self.kind = kind
        self.host_ns_per_pkt: float | None = None
        self._dev_ns_by_bucket: dict[int, float] = {}
        self._probe_countdown: dict[int, int] = {}
        self._probe_interval: dict[int, int] = {}
        self._compiled: set[int] = set()
        # Smallest measured device dispatch time at ANY bucket: the
        # round-trip floor is bucket-independent, so one losing probe
        # teaches the model about every size.
        self.dev_floor_ns: float | None = None

    # The floor is a property of the card (per dispatch kind), not of
    # one simulation: shared across model instances, and persisted
    # across processes keyed by the card's name.  Routing never affects
    # traces; a stale persisted floor self-corrects (unmeasured buckets
    # re-probe on the backoff cadence).  The port's tests reset this.
    _shared_floor: dict = {}
    _persist_loaded = False
    _persist_disabled = False

    @staticmethod
    def _persist_path() -> str:
        base = os.environ.get("XDG_CACHE_HOME",
                              os.path.expanduser("~/.cache"))
        return os.path.join(base, "shadow_tpu_torch", "route_floor.json")

    @staticmethod
    def _platform() -> str:
        """The persisted floor's key: the card's name, or "cpu"."""
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(torch.cuda.current_device())
        return "cpu"

    @classmethod
    def _load_persisted(cls) -> None:
        if cls._persist_loaded:
            return
        cls._persist_loaded = True
        try:
            with open(cls._persist_path()) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        plat = data.get(cls._platform())
        if isinstance(plat, dict):
            for kind, ns in plat.items():
                if isinstance(ns, (int, float)) and ns > 0 \
                        and kind not in cls._shared_floor:
                    cls._shared_floor[kind] = float(ns)

    @classmethod
    def _persist(cls) -> None:
        if cls._persist_disabled:
            return  # tests must not clobber the user's real cache
        path = cls._persist_path()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = {}
            # Merge the per-kind minimum with what is already on disk.
            plat = data.get(cls._platform())
            merged = dict(plat) if isinstance(plat, dict) else {}
            for kind, ns in cls._shared_floor.items():
                prev = merged.get(kind)
                if not isinstance(prev, (int, float)) or ns < prev:
                    merged[kind] = ns
            data[cls._platform()] = merged
            tmp = f"{path}.{os.getpid()}.tmp"  # unique per writer
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, path)
        except OSError:
            pass  # read-only home: in-process sharing still works

    @classmethod
    def reset_shared(cls) -> None:
        cls._shared_floor.clear()
        cls._persist_loaded = True   # tests: no disk reads...
        cls._persist_disabled = True  # ...and no disk writes

    def decide(self, n: int, b: int) -> int:
        """Routing choice for a round of n packets at bucket size b.
        Probe order: host first, then device, then compare.
        ROUTE_DEVICE only when the device is measured and winning (or
        forced); a dispatch made to measure comes back as ROUTE_PROBE so
        the caller can take it off the critical path."""
        if self.min_device_batch <= 0:
            return ROUTE_DEVICE  # forced-device mode (parity, audits)
        if n < self.min_device_batch:
            return ROUTE_HOST
        if self.host_ns_per_pkt is None:
            return ROUTE_HOST  # host probe
        dev = self._dev_ns_by_bucket.get(b)
        if dev is None:
            # Unmeasured bucket: probe only when even the cross-bucket
            # dispatch floor could win at this round size.
            floor = self.dev_floor_ns
            if floor is None:
                DeviceRouteModel._load_persisted()
                floor = DeviceRouteModel._shared_floor.get(self.kind)
            if floor is not None and floor > self.host_ns_per_pkt * n:
                dev = floor  # treat as losing; fall into backoff below
            elif self._probe_allowed(floor):
                return ROUTE_PROBE
            else:
                return ROUTE_HOST
        if dev <= self.host_ns_per_pkt * n:
            # Winning: fully reset the backoff (interval and countdown).
            self._probe_interval.pop(b, None)
            self._probe_countdown.pop(b, None)
            return ROUTE_DEVICE
        # Device currently losing at this size: re-probe with backoff.
        interval = self._probe_interval.get(b, self.REPROBE_EVERY)
        left = self._probe_countdown.get(b, interval) - 1
        if left <= 0:
            if not self._probe_allowed(dev):
                # Over budget: stay on the host and ask again a full
                # interval from now (the budget grows with wall).
                self._probe_countdown[b] = interval
                return ROUTE_HOST
            # Ask again next round unless a probe actually starts: the
            # backoff advances in probe_started().
            self._probe_countdown[b] = 1
            return ROUTE_PROBE
        self._probe_countdown[b] = left
        return ROUTE_HOST

    def probe_started(self, b: int, n: int) -> None:
        """A probe for bucket b was submitted: advance the backoff."""
        dev = self._dev_ns_by_bucket.get(b)
        host = self.host_ns_per_pkt
        interval = self._probe_interval.get(b, self.REPROBE_EVERY)
        nxt = (self.REPROBE_CAP
               if dev is not None and host is not None
               and dev > 16 * host * n
               else min(interval * 2, self.REPROBE_CAP))
        self._probe_interval[b] = nxt
        self._probe_countdown[b] = nxt

    def _probe_allowed(self, expected_ns: float | None) -> bool:
        """Cap measurement overhead at PROBE_BUDGET_FRAC of elapsed
        wall; an unknown cost (None) counts as free, so the first probe
        can happen."""
        elapsed = time.perf_counter_ns() - self._t_start_ns
        budget = elapsed * self.PROBE_BUDGET_FRAC
        return self.probe_spent_ns + (expected_ns or 0.0) <= budget

    def device_measured_winning(self, n: int) -> bool:
        """Has the model measured the device beating the host route at
        round size n?  The propagator's span gate."""
        if not n or self.host_ns_per_pkt is None:
            return False
        dev = self._dev_ns_by_bucket.get(_bucket(n))
        return dev is not None and dev <= self.host_ns_per_pkt * n

    def record_device(self, b: int, dt_ns: float, n: int,
                      fresh_compile: bool | None = None) -> None:
        """Record a measured device dispatch.  The first use of a bucket
        is not recorded (in the reference it paid a compile; here it
        pays the first launch's build and allocation); it debits the
        probe budget instead."""
        if fresh_compile is None:
            fresh_compile = b not in self._compiled
        if b not in self._compiled:
            self._compiled.add(b)
        if fresh_compile:
            self.probe_spent_ns += dt_ns
            return
        if self.dev_floor_ns is None or dt_ns < self.dev_floor_ns:
            self.dev_floor_ns = dt_ns
        shared = DeviceRouteModel._shared_floor
        prev = shared.get(self.kind)
        if prev is None or dt_ns < prev:
            shared[self.kind] = dt_ns
            DeviceRouteModel._persist()
        prev = self._dev_ns_by_bucket.get(b)
        host = self.host_ns_per_pkt
        if prev is None or (host is not None and prev > host * n):
            # First real sample, or a re-probe while routed away: trust
            # the fresh measurement so recovery is immediate.
            self._dev_ns_by_bucket[b] = dt_ns
        else:
            self._dev_ns_by_bucket[b] = 0.7 * prev + 0.3 * dt_ns
        # A dispatch that loses to the host route was a measurement,
        # whoever made it: debit the probe budget.
        if host is not None and self._dev_ns_by_bucket[b] > host * n:
            self.probe_spent_ns += dt_ns

    def record_host(self, dt_ns: float, n: int) -> None:
        per_pkt = dt_ns / max(n, 1)
        prev = self.host_ns_per_pkt
        self.host_ns_per_pkt = per_pkt if prev is None \
            else 0.7 * prev + 0.3 * per_pkt


# ---------------------------------------------------------------------
# The law and its kernel
# ---------------------------------------------------------------------

def propagate_ref(lat, thr, k0: int, k1: int, src_node, dst_node,
                  src_host, pkt_seq, t_send, is_ctl, window_end: int,
                  bootstrap_end: int):
    """One round's propagation in plain PyTorch (the reference kernel's
    body, `shadow_tpu/ops/propagate.py:423-440`, on unpadded columns).

    lat, thr: (V, V) int64; src_node, dst_node: (n,) int32 (clamped
    into [0, V) as XLA's gather clamps); src_host, t_send: (n,) int64;
    pkt_seq: (n,) int32 or int64 holding uint32 bits; is_ctl: (n,) bool.
    Returns (deliver int64, keep, reachable, lossy bool, mins) with
    mins = [min_deliver, min_latency] over the kept packets (int64,
    I64_MAX when none is kept)."""
    v = lat.shape[0]
    sn = src_node.long().clamp(0, v - 1)
    dn = dst_node.long().clamp(0, v - 1)
    latency = lat[sn, dn]
    reachable = latency < TIME_NEVER
    bits, _ = threefry2x32_torch(k0, k1, src_host & _M32,
                                 pkt_seq.long() & _M32)
    lossy = (bits < thr[sn, dn]) & ~is_ctl & (t_send >= bootstrap_end)
    deliver = torch.clamp(t_send + latency, min=window_end)
    keep = reachable & ~lossy
    never = torch.full_like(deliver, I64_MAX)
    if deliver.numel():
        mins = torch.stack([torch.where(keep, deliver, never).min(),
                            torch.where(keep, latency, never).min()])
    else:
        mins = torch.full((2,), I64_MAX, dtype=torch.int64,
                          device=deliver.device)
    return deliver, keep, reachable, lossy, mins


def _declare_propagate(lib) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.stt_propagate_round.argtypes = [p, i64, i64]
    lib.stt_propagate_host_alloc.argtypes = [i64, p, p]
    lib.stt_propagate_host_free.argtypes = [p]
    lib.stt_propagate_events_create.argtypes = [p]
    lib.stt_propagate_events_destroy.argtypes = [p]
    for fn in (lib.stt_propagate_round, lib.stt_propagate_host_alloc,
               lib.stt_propagate_host_free, lib.stt_propagate_events_create,
               lib.stt_propagate_events_destroy):
        fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("propagate.cu", "libstt_propagate.so",
                        _declare_propagate, "stt_propagate_error_string")

# csrc/propagate_plan.h: the grid cap (and so the partial minima a plan's
# scratch holds) and the columns of a plan over the caller's tensors.
MAX_BLOCKS = 2112
N_COLS = 11
# Rounds of at least this many packets are copied to the card and back
# around the launch; smaller ones run in place in the mapped round
# buffer.  chip_smoke.py phase 2's sweep of both branches: the copied
# branch's call is the faster one from 131,072 packets on, the zero-copy
# one's up to 65,536 (PERF.md section 6).
COPY_MIN_PACKETS = 131_072
# The longest a round's call waits for the card before it fails.
WAIT_LIMIT_NS = 60 * 10**9
# The propagator's stage times one round in this many (the events cost
# ~8 us of host a round; chip_smoke.py phase 2's sweep).
TIME_EVERY = 16


class Plan(ctypes.Structure):
    """csrc/propagate_plan.h `SttPropagatePlan`, field by field."""
    _fields_ = [("lat", ctypes.c_void_p), ("thr", ctypes.c_void_p),
                ("v", ctypes.c_int64), ("k0", ctypes.c_uint32),
                ("k1", ctypes.c_uint32), ("bootstrap_end", ctypes.c_int64),
                ("time_never", ctypes.c_int64),
                ("buf_host", ctypes.c_void_p),
                ("buf_mapped", ctypes.c_void_p),
                ("buf_dev", ctypes.c_void_p), ("cap", ctypes.c_int64),
                ("copy_min", ctypes.c_int64),
                ("cols", ctypes.c_void_p * N_COLS),
                ("scratch", ctypes.c_void_p), ("stream", ctypes.c_void_p),
                ("events", ctypes.c_void_p * 2), ("wait_ns", ctypes.c_int64),
                ("device", ctypes.c_int32), ("time_every", ctypes.c_int32),
                ("calls", ctypes.c_int64), ("timed", ctypes.c_int64),
                ("kernel_ms", ctypes.c_double), ("copied", ctypes.c_int32),
                ("pad", ctypes.c_int32)]


# (name, dtypes the kernel takes) of the per-packet inputs, in call order.
_LANES = (("src_node", (torch.int32,)), ("dst_node", (torch.int32,)),
          ("src_host", (torch.int64,)), ("pkt_seq", (torch.int32,)),
          ("t_send", (torch.int64,)), ("is_ctl", (torch.bool, torch.uint8)))


def _cuda_operand(name: str, t, dtypes, shape) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected {dtypes}, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {shape}, got "
                         f"{tuple(t.shape)}")


def _law_plan(lat, thr, k0, k1, bootstrap_end: int) -> Plan:
    """A plan holding the law's constants, the matrices validated."""
    v = lat.shape[0] if lat.dim() == 2 else -1
    for name, t in (("lat", lat), ("thr", thr)):
        _cuda_operand(name, t, (torch.int64,), (v, v))
    p = Plan()
    p.lat, p.thr, p.v = lat.data_ptr(), thr.data_ptr(), v
    p.k0, p.k1 = int(k0) & _M32, int(k1) & _M32
    p.bootstrap_end, p.time_never = int(bootstrap_end), TIME_NEVER
    idx = lat.device.index
    p.device = torch.cuda.current_device() if idx is None else idx
    return p


class Propagate:
    """Wrapper of `stt_propagate_round` (replaces the reference's jitted
    `build_propagate_kernel.kernel`).

    - `round(stage, n, window_end)`: the per-round route, one C call over
      a `RoundStage`'s plan (on a CPU stage, the plain law through
      `__call__`).
    - The tensor API, `__call__` and `launch`: (lat, thr, k0, k1,
      src_node, dst_node, src_host, pkt_seq, t_send, is_ctl, window_end,
      bootstrap_end) -> (deliver, keep, reachable, lossy, mins); `out`
      may give the five output tensors to write.  On CUDA tensors it
      launches the same kernel through a plan over them, on the current
      stream, without waiting (so a CUDA graph can capture it).  Its
      launches on one card share one scratch, so they must be ordered on
      one stream at a time."""

    def __init__(self):
        self.launches = 0        # critical-path launches
        self.probe_launches = 0  # route-model probes (worker thread)
        self._scratch = {}       # the tensor API's, by device

    def __call__(self, lat, thr, k0, k1, src_node, dst_node, src_host,
                 pkt_seq, t_send, is_ctl, window_end, bootstrap_end,
                 out=None, probe=False, events=None):
        if src_node.device.type == "cpu":
            res = propagate_ref(lat, thr, k0, k1, src_node, dst_node,
                                src_host, pkt_seq, t_send, is_ctl,
                                window_end, bootstrap_end)
            if out is None:
                return res
            for o, r in zip(out, res):
                o.copy_(r)
            return out
        return self.launch(lat, thr, k0, k1, src_node, dst_node, src_host,
                           pkt_seq, t_send, is_ctl, window_end,
                           bootstrap_end, out=out, probe=probe,
                           events=events)

    def launch(self, lat, thr, k0, k1, src_node, dst_node, src_host,
               pkt_seq, t_send, is_ctl, window_end, bootstrap_end,
               out=None, probe=False, events=None):
        """Validate, build a plan over the tensors and launch on the
        current stream.  `events`, two CUDA events, are recorded just
        before and after the launch."""
        n = src_node.shape[0] if src_node.dim() == 1 else -1
        lanes = (src_node, dst_node, src_host, pkt_seq, t_send, is_ctl)
        for (name, dtypes), t in zip(_LANES, lanes):
            _cuda_operand(name, t, dtypes, (n,))
        plan = _law_plan(lat, thr, k0, k1, bootstrap_end)
        dev = src_node.device
        if out is None:
            out = (torch.empty(n, dtype=torch.int64, device=dev),
                   *(torch.empty(n, dtype=torch.bool, device=dev)
                     for _ in range(3)),
                   torch.empty(2, dtype=torch.int64, device=dev))
        deliver, keep, reachable, lossy, mins = out
        _cuda_operand("deliver", deliver, (torch.int64,), (n,))
        for name, t in (("keep", keep), ("reachable", reachable),
                        ("lossy", lossy)):
            _cuda_operand(name, t, (torch.bool, torch.uint8), (n,))
        _cuda_operand("mins", mins, (torch.int64,), (2,))
        lib = LIBRARY.build()
        plan.cols[:] = [t.data_ptr() for t in (*lanes, *out)]
        key = plan.device
        if key not in self._scratch:
            self._scratch[key] = _scratch(dev)
        plan.scratch = self._scratch[key].data_ptr()
        plan.stream = _stream_ptr(dev)
        if events is not None:
            events[0].record()
        code = lib.stt_propagate_round(ctypes.byref(plan), n,
                                       int(window_end))
        self._count(probe)
        if events is not None:
            events[1].record()
        LIBRARY.check(code, "propagate")
        return out

    def round(self, stage: "RoundStage", n: int, window_end: int,
              probe: bool = False) -> None:
        """Propagate the n-packet round packed in `stage`: on the card one
        call of `stt_propagate_round` over the stage's plan, which returns
        when the results are in the stage's buffer; on the CPU the plain
        law over views of it."""
        if not stage.cuda:
            ins, outs = stage.tensors(n)
            self(stage.lat, stage.thr, *stage.keys, *ins, window_end,
                 stage.bootstrap_end, out=outs)
            return
        code = stage.lib.stt_propagate_round(stage.plan_ptr, n, window_end)
        self._count(probe)
        if code:
            LIBRARY.check(code, "propagate")

    def _count(self, probe: bool) -> None:
        if probe:
            self.probe_launches += 1
        else:
            self.launches += 1


def _scratch(device) -> torch.Tensor:
    """A plan's scratch on the card: the partial minima and the ticket,
    zero."""
    return torch.zeros(2 * MAX_BLOCKS + 1, dtype=torch.int64, device=device)


# The one wrapper of the kernel: chip_smoke.py zeroes its launch
# counters before a main path and reads them after.
PROPAGATE = Propagate()


# ---------------------------------------------------------------------
# The round buffer and its plan
# ---------------------------------------------------------------------

# export_round's byte columns in its order; dst_host only serves the
# sharded exchange (A5) and is not staged.
_EXPORT = ("src_node", "dst_node", "dst_host", "src_host", "pkt_seq",
           "t_send", "is_ctl")
# Bytes per packet and dtype of every staged column.
_WIDTH = {"src_host": 8, "t_send": 8, "src_node": 4, "dst_node": 4,
          "pkt_seq": 4, "is_ctl": 1, "deliver": 8, "keep": 1,
          "reachable": 1, "lossy": 1}
_DTYPE = {"src_host": torch.int64, "t_send": torch.int64,
          "src_node": torch.int32, "dst_node": torch.int32,
          "pkt_seq": torch.int32, "is_ctl": torch.bool,
          "deliver": torch.int64, "keep": torch.bool,
          "reachable": torch.bool, "lossy": torch.bool}
# Staging order of the inputs (8-byte columns first, so every view is
# aligned) and of the outputs; the kernel's argument order.
_INS = ("src_host", "t_send", "src_node", "dst_node", "pkt_seq", "is_ctl")
_OUTS = ("deliver", "keep", "reachable", "lossy")
_CALL_ORDER = ("src_node", "dst_node", "src_host", "pkt_seq", "t_send",
               "is_ctl")
_MIN_CAP = 4096  # packets of a stage's first buffer
_TWO_I64 = struct.Struct("<qq")


def _free_host(lib, owned: dict) -> None:
    if owned["host"]:
        lib.stt_propagate_host_free(owned["host"])
        owned["host"] = None


def _release(lib, owned: dict) -> None:
    """Free a card stage's mapped buffer and events (its finalizer)."""
    _free_host(lib, owned)
    lib.stt_propagate_events_destroy(owned["events"])


class RoundStage:
    """One round's columns and results in one buffer (the layout of
    csrc/propagate_plan.h stt_round_layout):

        [src_host | t_send | src_node | dst_node | pkt_seq | is_ctl]
        [pad to 8 | mins (2 x i64) | deliver | keep | reachable | lossy]

    On the card the buffer is pinned host memory mapped into the card's
    address space, allocated by the kernel's library, and the stage owns
    a plan of `stt_propagate_round` (the matrices, keys and constants,
    the buffer, a buffer on the card for rounds of at least `copy_min`
    packets, its scratch, its own stream, and timing events recorded on
    every `time_every`-th round, none if 0): a round is `pack`, one C
    call (`Propagate.round`) and `results`, the views that scatter_round
    takes.  On the CPU the buffer is a numpy array and the plain law runs
    over views of it.  Grows by doubling; the plan follows."""

    def __init__(self, device, lat, thr, keys, bootstrap_end: int,
                 time_every: int = 0, copy_min: int = COPY_MIN_PACKETS):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.lat, self.thr = lat, thr
        self.keys = keys
        self.bootstrap_end = bootstrap_end
        self.cap = 0
        self.buf = self._mem = None  # numpy uint8 and a memoryview of it
        if not self.cuda:
            return
        self.lib = LIBRARY.build()
        plan = _law_plan(lat, thr, *keys, bootstrap_end)
        self.stream = torch.cuda.Stream(self.device)
        self._scratch = _scratch(self.device)
        self._dev = None
        plan.copy_min = copy_min
        plan.scratch = self._scratch.data_ptr()
        plan.stream = self.stream.cuda_stream
        plan.wait_ns = WAIT_LIMIT_NS
        self._owned = {"host": None, "events": plan.events}
        weakref.finalize(self, _release, self.lib,
                         self._owned).atexit = False
        if time_every:
            LIBRARY.check(self.lib.stt_propagate_events_create(plan.events),
                          "propagate events")
            plan.time_every = time_every
        # The matrices and the scratch's zeros are written on the caller's
        # stream; the stage's own stream reads them.
        torch.cuda.current_stream(self.device).synchronize()
        self.plan = plan
        self.plan_ptr = ctypes.addressof(plan)

    @staticmethod
    def layout(n: int) -> dict:
        """Byte offsets of every column for an n-packet round, of the
        minima, and the end ("total")."""
        off, at = {}, 0
        for name in _INS:
            off[name] = at
            at += _WIDTH[name] * n
        off["mins"] = at = (at + 7) & ~7
        at += 16
        for name in _OUTS:
            off[name] = at
            at += _WIDTH[name] * n
        off["total"] = at
        return off

    def _ensure(self, n: int) -> None:
        if n <= self.cap and self.buf is not None:
            return
        cap = max(n, 2 * self.cap, _MIN_CAP)
        total = self.layout(cap)["total"]
        if not self.cuda:
            self.buf = np.empty(total, np.uint8)
            self._mem = memoryview(self.buf)
            self.cap = cap
            return
        lib, plan = self.lib, self.plan
        self.buf = self._mem = None
        _free_host(lib, self._owned)
        host, mapped = ctypes.c_void_p(), ctypes.c_void_p()
        LIBRARY.check(lib.stt_propagate_host_alloc(
            total, ctypes.byref(host), ctypes.byref(mapped)),
            "propagate round buffer")
        self._owned["host"] = host.value
        self.buf = np.ctypeslib.as_array(
            (ctypes.c_uint8 * total).from_address(host.value))
        self._mem = memoryview(self.buf)
        self._dev = torch.empty(total, dtype=torch.uint8, device=self.device)
        plan.buf_host, plan.buf_mapped = host.value, mapped.value
        plan.buf_dev, plan.cap = self._dev.data_ptr(), cap
        self.cap = cap

    def pack(self, cols, n: int) -> None:
        """Copy export_round's byte columns into the buffer at the
        n-packet layout (a column of another length raises here).  The
        offsets are stt_round_layout's, written out: this and `results`
        run every round."""
        self._ensure(n)
        m = self._mem
        m[16 * n:20 * n] = cols[0]       # src_node
        m[20 * n:24 * n] = cols[1]       # dst_node
        m[0:8 * n] = cols[3]             # src_host
        m[24 * n:28 * n] = cols[4]       # pkt_seq
        m[8 * n:16 * n] = cols[5]        # t_send
        m[28 * n:29 * n] = cols[6]       # is_ctl

    def results(self, n: int):
        """The last round's results as scatter_round takes them: views of
        the buffer, (keep u8, deliver i64, reachable u8, lossy u8), and
        the two minima as ints."""
        m = self._mem
        mins = (29 * n + 7) & ~7
        d = mins + 16
        k = d + 8 * n
        r = k + n
        lo = r + n
        min_d, min_l = _TWO_I64.unpack_from(m, mins)
        return (m[k:r], m[d:k].cast("q"), m[r:lo], m[lo:lo + n]), min_d, min_l

    def tensors(self, n: int):
        """CPU tensors over the buffer: the law's inputs in call order and
        its outputs (deliver, keep, reachable, lossy, mins)."""
        off, buf = self.layout(n), self.buf

        def view(name, at, nbytes):
            return torch.from_numpy(buf[at:at + nbytes]).view(_DTYPE[name])

        ins = tuple(view(c, off[c], _WIDTH[c] * n) for c in _CALL_ORDER)
        outs = tuple(view(c, off[c], _WIDTH[c] * n) for c in _OUTS)
        mins = torch.from_numpy(buf[off["mins"]:off["mins"] + 16]).view(
            torch.int64)
        return ins, (*outs, mins)

    def kernel_ns(self) -> float | None:
        """The mean card time of the timed rounds (their launches'
        events), None before one."""
        p = self.plan
        return p.kernel_ms * 1e6 / p.timed if p.timed else None

    @property
    def copied(self) -> bool:
        """Did the last round go through the buffer on the card?"""
        return bool(self.plan.copied)


# ---------------------------------------------------------------------
# The per-round propagator (engine half)
# ---------------------------------------------------------------------

# The device route's phases, host walls but `kernel`: export_round;
# upload, the columns written into the round buffer; launch, the one call
# of the kernel's library (the copies of a large round, the launch and
# the wait for the results); kernel, the launch's CUDA-event time on the
# card, the mean of the timed rounds (one in TIME_EVERY) for every round
# (on the CPU, the plain law's wall); download, the results' views;
# scatter_round.
_PHASES = ("export", "upload", "launch", "kernel", "download", "scatter")


class TpuPropagator:
    """The per-round propagation phase of engine-resident hosts behind
    `scheduler: tpu` (the reference's TpuPropagator, engine leg).

    Each round: the route model decides; ROUTE_HOST runs the engine's
    C++ twin (`finish_round`), ROUTE_DEVICE exports the round's columns,
    runs `stt_propagate_round` on the card over its `RoundStage` and
    scatters the decisions back; ROUTE_PROBE runs the twin and measures
    the kernel on the exported columns on a worker thread, through a
    stage of its own (its own buffer, plan and CUDA stream).
    `tpu_min_device_batch <= 0` forces every round through the kernel."""

    def __init__(self, latency_ns, loss_thresholds, seed: int,
                 bootstrap_end_ns: int, runahead=None,
                 min_device_batch: int = 2048, device="cuda"):
        self.device = torch.device(device)
        self._keys = mix_key(seed, STREAM_PACKET_LOSS)
        self._lat = torch.as_tensor(np.ascontiguousarray(
            latency_ns, dtype=np.int64), device=self.device)
        self._thr = torch.as_tensor(np.ascontiguousarray(
            loss_thresholds, dtype=np.int64), device=self.device)
        self.bootstrap_end = bootstrap_end_ns
        # A CPU "device" keeps its own floor, apart from the card's.
        self.route = DeviceRouteModel(
            min_device_batch,
            kind="single" if self.device.type == "cuda" else "cpu")
        self.forced = min_device_batch <= 0
        self.runahead = runahead
        self.window_end = 0
        self.engine = None  # the native plane's engine (set by the Manager)
        self.rounds_dispatched = 0
        self.packets_batched = 0
        # How much propagation ran on the card vs the C++ twin.
        self.rounds_device = 0
        self.packets_device = 0
        self.round_sizes: list[int] = []  # packets of every engine round
        # Host walls of the device route's phases, ns (the kernel's is
        # its CUDA-event time on the card), and of the twin's rounds.
        self.phase_ns = dict.fromkeys(_PHASES, 0)
        self.host_route_ns = 0
        self._stage = None  # built at the first device round
        # The async probe: one in flight; its failure is re-raised by
        # the next finish_round (or close).  The route model is shared
        # with the probe's thread: every call to it holds this lock.
        self._route_lock = threading.Lock()
        self._probe_thread = None
        self._probe_pending = False
        self._probe_closed = False
        self._probe_error = None
        self._probe_stage = None
        self.probes_async = 0
        # Last engine-round size: the span gate's typical round.
        self._last_engine_n = 0

    def begin_round(self, window_start: int, window_end: int) -> None:
        self.window_end = window_end

    def send(self, src_host, packet) -> None:
        raise NotImplementedError(
            f"shadow_tpu_torch does not propagate object-path sends yet: "
            f"{_RM_OBJECT_PATH}")

    def _dispatch_chunk(self, lo: int, hi: int):
        raise NotImplementedError(
            f"shadow_tpu_torch does not propagate object-path sends yet: "
            f"{_RM_OBJECT_PATH}")

    def finish_round(self):
        """Propagate the round the engine's hosts sent; returns the
        earliest delivery (None if nothing is in flight) and feeds the
        dynamic runahead with the least latency of a kept packet."""
        self._raise_probe_error()
        n = self.engine.round_size()
        if not n:
            return None
        md, ml = self._engine_round(n)
        self.packets_batched += n
        if self.runahead is not None and ml < I64_MAX:
            self.runahead.update_lowest_used_latency(ml)
        return md if md < I64_MAX else None

    def _engine_round(self, n: int):
        eng = self.engine
        b = _bucket(n)
        self._last_engine_n = n
        self.round_sizes.append(n)
        t0 = time.perf_counter_ns()
        with self._route_lock:
            route = self.route.decide(n, b)
        if route == ROUTE_DEVICE and self._probe_pending:
            # An in-flight probe shares the card: a critical-path
            # dispatch now would queue behind it and both timings would
            # record queueing.  The twin is bit-identical.  (Forced mode
            # never probes, so it never gets here.)
            route = ROUTE_HOST
        if route == ROUTE_DEVICE:
            md, ml, exports = self._engine_device_round(n)
            with self._route_lock:
                self.route.record_device(b, time.perf_counter_ns() - t0, n)
            self.rounds_device += 1
            self.packets_device += n
        else:
            if self.forced:
                raise AssertionError("forced-device mode routed a round "
                                     "to the C++ twin")
            if route == ROUTE_PROBE:
                # export_round builds independent byte copies, so the
                # probe's inputs survive finish_round consuming the
                # round.
                self._submit_probe(eng.export_round(), n, b)
            _nf, md, ml, exports = eng.finish_round(self.window_end)
            dt = time.perf_counter_ns() - t0
            with self._route_lock:
                self.route.record_host(dt, n)
            self.host_route_ns += dt
        self.rounds_dispatched += 1
        if exports is not None:
            self._deliver_exports(exports)
        return md, ml

    def _new_stage(self, time_every: int) -> RoundStage:
        return RoundStage(self.device, self._lat, self._thr, self._keys,
                          self.bootstrap_end, time_every=time_every)

    def _dispatch(self, stage: RoundStage, cols, n: int, window_end: int,
                  probe: bool, walls: dict | None):
        """Pack the columns into the stage's buffer, propagate the round
        (one call on the card, which returns when the results are in the
        buffer) and return their views.  Adds each phase's time to
        `walls` where given (see _PHASES)."""
        t0 = time.perf_counter_ns()
        stage.pack(cols, n)
        t1 = time.perf_counter_ns()
        PROPAGATE.round(stage, n, window_end, probe)
        t2 = time.perf_counter_ns()
        res = stage.results(n)
        t3 = time.perf_counter_ns()
        if walls is not None:
            walls["upload"] += t1 - t0
            walls["launch"] += t2 - t1
            if not stage.cuda:
                walls["kernel"] += t2 - t1
            walls["download"] += t3 - t2
        return res

    def _engine_device_round(self, n: int):
        """The device route over the engine's exported columns; the
        engine applies the decisions.  scatter_round's own minima are
        TIME_NEVER placeholders: the kernel's are the round's."""
        eng = self.engine
        walls = self.phase_ns
        if self._stage is None:
            self._stage = self._new_stage(TIME_EVERY)
        t0 = time.perf_counter_ns()
        cols = eng.export_round()
        walls["export"] += time.perf_counter_ns() - t0
        (keep, deliver, reachable, lossy), md, ml = self._dispatch(
            self._stage, cols, n, self.window_end, False, walls)
        t0 = time.perf_counter_ns()
        _nf, _md, _ml, exports = eng.scatter_round(keep, deliver, reachable,
                                                   lossy)
        walls["scatter"] += time.perf_counter_ns() - t0
        return md, ml, exports

    def _submit_probe(self, cols, n: int, b: int) -> None:
        """Measure a device dispatch off the critical path: the kernel
        runs on a worker thread through the probe's own stage (buffer,
        plan and CUDA stream) on the exported copies (results discarded:
        the twin served the round), and the timing feeds the route
        model."""
        if self._probe_pending or self._probe_closed:
            return  # one in flight: decline; decide() asks again
        self._probe_pending = True
        with self._route_lock:
            self.route.probe_started(b, n)
        if self._probe_stage is None:
            self._probe_stage = self._new_stage(0)
        window_end = self.window_end
        threads = torch.get_num_threads()

        def job():
            try:
                torch.set_num_threads(threads)
                t0 = time.perf_counter_ns()
                self._dispatch(self._probe_stage, cols, n, window_end, True,
                               None)
                with self._route_lock:
                    self.route.record_device(b, time.perf_counter_ns() - t0,
                                             n)
                self.probes_async += 1
            except Exception as e:  # re-raised on the caller's thread
                self._probe_error = e
            finally:
                self._probe_pending = False

        self._probe_thread = threading.Thread(target=job,
                                              name="route-probe",
                                              daemon=True)
        self._probe_thread.start()

    def _raise_probe_error(self) -> None:
        if self._probe_error is not None:
            err, self._probe_error = self._probe_error, None
            raise RuntimeError("the route model's propagate probe "
                               "failed") from err

    def span_gate(self) -> bool:
        """May the Manager serve the next rounds with spans?  False when
        the route model has measured the device winning at the typical
        engine-round size."""
        with self._route_lock:
            return not self.route.device_measured_winning(
                self._last_engine_n)

    def close(self) -> None:
        """Stop accepting probes, wait for one in flight, and re-raise
        its failure."""
        self._probe_closed = True
        if self._probe_thread is not None:
            self._probe_thread.join()
            self._probe_thread = None
        self._raise_probe_error()

    def _deliver_exports(self, exports) -> None:
        raise RuntimeError(f"engine exported packets to an object-path "
                           f"host, which the port never builds "
                           f"({_RM_OBJECT_PATH})")

    def summary(self) -> dict:
        """The dispatch summary's `propagate` block: the route split of
        the per-round rounds (span rounds are not counted here), the
        kernel's launch counts (process-wide, since their last reset),
        and the walls of each phase in ms, totals and per device round."""
        sizes = sorted(self.round_sizes)
        per = max(self.rounds_device, 1)
        phase_ns = dict(self.phase_ns)
        stage = self._stage
        if stage is not None and stage.cuda and stage.kernel_ns():
            # The timed rounds' mean card time, for every device round.
            phase_ns["kernel"] = stage.kernel_ns() * self.rounds_device
        return {
            "forced": self.forced,
            "rounds_dispatched": self.rounds_dispatched,
            "packets_batched": self.packets_batched,
            "rounds_device": self.rounds_device,
            "packets_device": self.packets_device,
            "probes_async": self.probes_async,
            "launches": PROPAGATE.launches,
            "probe_launches": PROPAGATE.probe_launches,
            "host_ns_per_pkt": self.route.host_ns_per_pkt,
            "packets_per_round": ({"min": sizes[0],
                                   "median": sizes[len(sizes) // 2],
                                   "max": sizes[-1]} if sizes else None),
            "walls_ms": {**{p: phase_ns[p] / 1e6 for p in _PHASES},
                         "host_route": self.host_route_ns / 1e6},
            "per_device_round_us": {p: phase_ns[p] / 1e3 / per
                                    for p in _PHASES},
        }
