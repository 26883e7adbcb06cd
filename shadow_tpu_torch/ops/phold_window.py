"""The PHOLD/udp-mesh window kernel (`csrc/phold_window.cu`
`stt_phold_window`, ROADMAP B6) behind its wrapper.

The device-span loop (ops/phold_span.py) steps a round's conservative
window with the fused micro-iteration: pop an event, an app step, two
relay passes, a recv or sleep, over and over until no lane is busy or
due.  Eager, that is dozens of ops and several host syncs per
micro-iteration, and one standalone law-kernel launch per relay pass
(ops/queues.py).  The kernel steps the whole window in one launch, one
thread per host lane, with the relays' token-bucket and CoDel-head laws
(csrc/queue_laws.cuh) run in the lane (csrc/phold_lane.cuh).

- The plain version is the runner's own eager window, `window_plain`
  of the built loop (`PholdSpanRunner._build`); the runner runs it on
  the CPU, with `fused` off, and on the card with the `window_factory`
  `eager_window`; `chip_smoke.py` holds the kernel against it there.
- `PholdWindow` is the wrapper and `PHOLD_WINDOW` its one instance.
  `bind` makes one span build's window step, which launches the kernel
  on a CUDA tensor or raises; it never runs on a CPU tensor.  Its plain
  integer `launches` counter is bumped only where it launches.
- `WindowTable` fills the kernel's operand and parameter tables by the
  names the library returns (`stt_phold_operands`, `stt_phold_params`:
  the order lives in csrc/phold_lane.cuh alone), checks every operand's
  dtype, shape and contiguity by them, owns the window's bitmaps and
  statistics words and reads the counts back.  The tier-1 tests drive
  the same table through a host build of the lane law.

The kernel builds at first use with nvcc for sm_90a (with `-Xptxas=-v`,
whose report of registers and spills `LIBRARY.log` keeps) into the
gitignored `shadow_tpu_torch/csrc/build/` and binds through a plain C
interface with ctypes.  Nothing is imported or built at import time.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from shadow_tpu_torch.ops.queues import (CODEL_INTERVAL_NS, CODEL_TARGET_NS,
                                         MTU, REFILL_NS, KernelLibrary)

# The packet columns in the kernel's order (ops/phold_span.py PK_KEYS).
PK_KEYS = ("srchost", "pseq", "sip", "sport", "dip", "dport")

_DTYPES = {"uint8_t": torch.bool, "uint32_t": torch.int32,
           "int64_t": torch.int64}


def _declare(lib) -> None:
    p = ctypes.c_void_p
    for fn in (lib.stt_phold_operands, lib.stt_phold_params,
               lib.stt_phold_consts, lib.stt_phold_stats):
        fn.argtypes = []
        fn.restype = ctypes.c_char_p
    lib.stt_phold_bitmap_words.argtypes = []
    lib.stt_phold_bitmap_words.restype = ctypes.c_longlong
    lib.stt_phold_window.argtypes = [p, p, p]
    lib.stt_phold_window.restype = ctypes.c_int


LIBRARY = KernelLibrary("phold_window.cu", "libstt_phold_window.so",
                        _declare, "stt_phold_error_string",
                        flags=("-Xptxas=-v",))


@dataclass(frozen=True)
class Operand:
    """One pointer of the kernel's operand table."""

    key: str        # span-state key, or "win.*" (a WindowTable buffer)
    dims: tuple     # shape in the table's names (() for a 0-d tensor)
    dtype: torch.dtype
    written: bool


def parse_operands(text: str) -> list:
    """The operand table `stt_phold_operands()` names ("type|key|dims;"
    per field): a "_*" key is one operand per packet column, a "pk*" key
    one per column after srchost."""
    ops = []
    for entry in filter(None, text.split(";")):
        ctype, key, dims = entry.split("|")
        if key.endswith("_*"):
            keys = [key[:-1] + k for k in PK_KEYS]
        elif key.endswith("pk*"):
            keys = [key[:-3] + k for k in PK_KEYS[1:]]
        else:
            keys = [key]
        base = ctype.replace("const ", "").rstrip("*").strip()
        ops += [Operand(k, tuple(filter(None, dims.split(","))),
                        _DTYPES[base], not ctype.startswith("const"))
                for k in keys]
    return ops


def parse_words(text: str) -> dict:
    """"NAME=value ..." -> {NAME: int}."""
    return {k: int(v) for k, v in
            (w.split("=") for w in text.split())}


def check_consts(lib) -> None:
    """The kernel's copies of the loop's constants against the loop's."""
    from shadow_tpu_torch.ops import phold_span
    bad = {k: (v, getattr(phold_span, k, None))
           for k, v in parse_words(lib.stt_phold_consts().decode()).items()
           if getattr(phold_span, k, None) != v}
    if bad:
        raise RuntimeError(f"phold_window: constants differ from "
                           f"ops/phold_span.py (kernel, loop): {bad}")


class WindowTable:
    """The kernel's operand and parameter tables for one span build,
    filled by the names `lib` returns (the nvcc library, or the tests'
    host build of the same header).  `shape` gives the table's dimension
    names (n, I, T, R, S, C, asys, tel, out, tr) and the build's
    constant parameters; `begin` completes both from the run's state."""

    def __init__(self, lib, shape: dict, params: dict):
        self.lib = lib
        check_consts(lib)
        self.ops = parse_operands(lib.stt_phold_operands().decode())
        self.names = lib.stt_phold_params().decode().split()
        self.layout = parse_words(lib.stt_phold_stats().decode())
        self.words = int(lib.stt_phold_bitmap_words())
        self.dims = dict(shape, passes=self.layout["N_PASSES"],
                         words=self.words, stats=self.layout["ST_N"])
        self.params = dict(params, bitmap_words=self.words,
                           refill_ns=REFILL_NS, target_ns=CODEL_TARGET_NS,
                           mtu=MTU, interval_ns=CODEL_INTERVAL_NS)
        want = set(self.params) | {"n_peer_cols", "psize", "pay",
                                   "window_end"}
        if set(self.names) != want:
            raise RuntimeError(f"phold_window: the kernel's parameters "
                               f"{self.names} are not {sorted(want)}")
        self._table = (ctypes.c_uint64 * len(self.ops))()
        self._words = (ctypes.c_longlong * len(self.names))()
        self._addr = (ctypes.addressof(self._table),
                      ctypes.addressof(self._words))
        self.written = [j for j, o in enumerate(self.ops) if o.written]

    def begin(self, st: dict, pay: int) -> None:
        """A run's start: zeroed bitmaps and statistics on the state's
        device; the peer width and packet size from the run."""
        dev = st["now"].device
        self.bitmap = torch.zeros((self.dims["passes"], self.words),
                                  dtype=torch.int32, device=dev)
        self.stats = torch.zeros(self.layout["ST_N"], dtype=torch.int64,
                                 device=dev)
        self.dims["P"] = st["peers"].shape[1]
        self.params.update(n_peer_cols=self.dims["P"], pay=pay,
                           psize=pay + 28)
        self._checked = False

    def _tensor(self, st, key):
        if key == "win.bitmap":
            return self.bitmap
        if key == "win.stats":
            return self.stats
        return st.get(key)

    def _check(self, o: Operand, t) -> None:
        if t is None:
            if o.key.startswith("tr_") and not self.params["tracing"]:
                return
            raise KeyError(f"phold_window: no operand {o.key!r}")
        if not isinstance(t, torch.Tensor) or t.dtype != o.dtype:
            raise TypeError(f"phold_window {o.key}: expected {o.dtype}, got "
                            f"{getattr(t, 'dtype', type(t))}")
        want = tuple(self.dims[d] for d in o.dims)
        if tuple(t.shape) != want:
            raise ValueError(f"phold_window {o.key}: expected shape {want} "
                             f"({', '.join(o.dims)}), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"phold_window {o.key}: not contiguous")

    def fill(self, st: dict, window_end: int) -> tuple:
        """Both tables for one window; returns their addresses.  The
        first fill of a run checks every operand by its table entry."""
        ts = [self._tensor(st, o.key) for o in self.ops]
        if not self._checked:
            for o, t in zip(self.ops, ts):
                self._check(o, t)
            self._checked = True
        ptrs = [0 if t is None else t.data_ptr() for t in ts]
        written = [ptrs[j] for j in self.written if ptrs[j]]
        if len(set(written)) != len(written):
            raise RuntimeError("phold_window: two written operands share "
                               "storage; the kernel writes in place")
        self._table[:] = ptrs
        self.params["window_end"] = int(window_end)
        self._words[:] = [self.params[k] for k in self.names]
        return self._addr

    def end(self) -> dict:
        """The run's counts, summed over its windows: fires and lanes by
        KS slot, the law calls (bucket, CoDel head) made in the lanes and
        the micro-iterations (each window's largest lane count)."""
        s = self.stats.cpu().numpy()
        lay = self.layout
        return {"fires": s[lay["ST_FIRES"]:lay["ST_LANES"]].copy(),
                "lanes": s[lay["ST_LANES"]:lay["ST_CALLS"]].copy(),
                "calls": s[lay["ST_CALLS"]:lay["ST_ITERS"]].copy(),
                "iters": int(s[lay["ST_ITERS"]])}


class PholdWindow:
    """Wrapper of `stt_phold_window` (replaces the window loop of the
    reference's PholdSpanRunner._build.run, shadow_tpu/ops/
    phold_span.py:1675, with its relays' Pallas make_bucket_step /
    make_codel_head)."""

    def __init__(self, library: KernelLibrary | None = None):
        self.library = LIBRARY if library is None else library
        self.launches = 0

    def bind(self, shape: dict, params: dict) -> "BoundPholdWindow":
        """One span build's window step (`shape`, `params`: as
        WindowTable takes them)."""
        return BoundPholdWindow(self, shape, params)


class BoundPholdWindow:
    """A span build's window step on the card: `begin(st, pay)` at a
    run's start, `step(st, window_end)` once per window (one launch on
    the current stream), `end()` after the run's last sync: the counts
    of WindowTable.end, the windows launched and their launch-to-end
    time (`window_ms`: CUDA events just before each launch call and
    after it, so the launch's host issue is in it; a window's card time
    alone is timed in a CUDA graph by `chip_smoke.py`)."""

    def __init__(self, wrapper: PholdWindow, shape: dict, params: dict):
        self.wrapper = wrapper
        self.shape, self.params = shape, params
        self.table = None

    def begin(self, st: dict, pay: int) -> None:
        dev = st["now"].device
        if dev.type != "cuda":
            raise ValueError(f"phold_window: expected CUDA tensors, got "
                             f"{dev}; the CPU runs the eager window")
        if self.table is None:
            self.table = WindowTable(self.wrapper.library.build(),
                                     self.shape, self.params)
        self.table.begin(st, pay)
        self._events = []

    def launch(self, st: dict, window_end: int) -> None:
        """One launch on the current stream, untimed (a CUDA graph may
        capture it)."""
        table, words = self.table.fill(st, window_end)
        code = self.table.lib.stt_phold_window(
            table, words,
            torch.cuda.current_stream(st["now"].device).cuda_stream)
        self.wrapper.launches += 1
        self.wrapper.library.check(code, "phold_window")

    def __call__(self, st: dict, window_end: int) -> None:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        self.launch(st, window_end)
        e1.record()
        self._events.append((e0, e1))

    def end(self) -> dict:
        out = self.table.end()
        ms = 0.0
        for e0, e1 in self._events:
            e1.synchronize()
            ms += e0.elapsed_time(e1)
        out.update(windows=len(self._events), window_ms=ms)
        return out


def eager_window(shape: dict, params: dict) -> None:
    """The runner's `window_factory` that makes no step: the card then
    runs the eager window, the kernel's plain version."""
    return None


def window_need_bytes(ops: list, before: dict, after: dict) -> dict:
    """A lower bound of the bytes one window must move, from the span
    state `before` it and `after` it (a window that did not abort):

    - idle: every lane ends on the busy/due test, which reads its
      continuation, inbox length and position, the inbox head's time
      where one is pending, the timer heap's valid bytes and each valid
      timer's time (counted on `after`, the state that last test saw);
    - dequeue: each inbox pop and CoDel dequeue reads its slot's time
      (ib_time, cq_enq);
    - copies: each packet copied on (inbox -> CoDel ring, CoDel ring ->
      recv queue: 6 words; send queue -> an outbox record: 5) is read
      once from where it lay;
    - writes: every element of a written operand whose value changed,
      at its size (an unchanged word need not be written).

    Returns the parts and their sum under "total"."""
    H = after["now"].shape[0]
    T = after["th_valid"].shape[1]

    def delta(k) -> int:
        return int((after[k] - before[k]).sum())

    pending = int((after["ib_len"] > after["ib_pos"]).sum())
    valid = int(after["th_valid"].sum())
    parts = {
        "idle": H * (3 * 8 + T) + 8 * (pending + valid),
        "dequeue": 8 * (delta("ib_pos") + delta("cq_pos")),
        "copies": 48 * (delta("cq_len") + delta("rq_len"))
        + 40 * delta("out_n"),
        "writes": sum(int((after[o.key] != before[o.key]).sum())
                      * after[o.key].element_size()
                      for o in ops if o.written and o.key in after)}
    parts["total"] = sum(parts.values())
    return parts


# The one wrapper: chip_smoke.py zeroes its launch counter before a main
# path and reads it after.
PHOLD_WINDOW = PholdWindow()

