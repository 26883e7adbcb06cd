"""The TCP steady-stream window kernel (`csrc/tcp_window.cu`
`stt_tcp_window`, ROADMAP B5a) behind its wrapper.

The TCP device-span loop (ops/tcp_span.py) steps a round's conservative
window with the fused micro-iteration: pop an event, then the timer,
app, relay-2, on-packet, reassembly, ack, push, flush, relay-1 and arm
stages, over and over until no lane is busy or due.  Eager, that is a
host sync per stage guard per micro-iteration, dozens of eager ops per
stage, and one fused relay-kernel launch per relay stage fire
(ops/relay.py).  The kernel steps the whole window in one launch, a
tile of 32 threads per host lane (one runs the lane law, the tile its
row scans), with the relay tails (csrc/queue_laws.cuh relay1_core /
relay2_core: the token-bucket and CoDel-head laws) run in the lane
(csrc/tcp_lane.cuh).  Through this kernel the round end (propagation
and the inbox merge) stays eager after each window: the runner takes it
with the `window_factory` `TCP_WINDOW.bind`; on the main path the span
kernel (ops/tcp_span_kernel.py) runs the windows with the same lane law
and tile, and the round ends, in one launch a span.

- The plain version is the runner's own eager window, `window_plain`
  of the built loop (`TcpSpanRunner._build`); the runner runs it on the
  CPU and on the card with the `window_factory` `eager_window`;
  `chip_smoke.py` holds the kernel against it there.
- `TcpWindow` is the wrapper and `TCP_WINDOW` its one instance.  `bind`
  makes one span build's window step, which launches the kernel on a
  CUDA tensor or raises; it never runs on a CPU tensor.  Its plain
  integer `launches` counter is bumped only where it launches.
- `TcpWindowTable` fills the kernel's operand and parameter tables by
  the names the library returns (`stt_tcp_operands`, `stt_tcp_params`:
  the order lives in csrc/tcp_lane.cuh alone) through the family-free
  `LaneTable` (ops/window_table.py).  The tier-1 tests drive the same
  table through a host build of the lane law.
- `window_need_bytes` counts the bytes one window must move from the
  span states before and after it: the kernel's bound.

The kernel builds at first use with nvcc for sm_90a (with `-Xptxas=-v`,
whose report of registers and spills `LIBRARY.log` keeps) into the
gitignored `shadow_tpu_torch/csrc/build/` and binds through a plain C
interface with ctypes.  Nothing is imported or built at import time.
"""

from __future__ import annotations

import ctypes

import torch

from shadow_tpu_torch.ops import window_table
from shadow_tpu_torch.ops.queues import (CODEL_INTERVAL_NS, CODEL_TARGET_NS,
                                         MTU, REFILL_NS, KernelLibrary)
from shadow_tpu_torch.ops.span_common import I64_MAX
from shadow_tpu_torch.ops.window_table import LaneTable, changed_bytes

# The packet columns in the kernel's order (ops/tcp_span.py PK_KEYS) and
# the trace's (ROUTE_KEYS, then plen).
PK_KEYS = ("srchost", "pseq", "sip", "sport", "dip", "dport", "tseq",
           "tack", "tflags", "twin", "tsv", "tse", "plen", "nsk", "sk0s",
           "sk0e", "sk1s", "sk1e", "sk2s", "sk2e", "ecn")
TR_PK_KEYS = ("srchost", "pseq", "sip", "sport", "dip", "dport", "plen")
PK_WORDS = 8 * len(PK_KEYS)  # bytes of one packet record


def _declare(lib) -> None:
    p = ctypes.c_void_p
    for fn in (lib.stt_tcp_operands, lib.stt_tcp_params,
               lib.stt_tcp_consts, lib.stt_tcp_stats):
        fn.argtypes = []
        fn.restype = ctypes.c_char_p
    lib.stt_tcp_bitmap_words.argtypes = []
    lib.stt_tcp_bitmap_words.restype = ctypes.c_longlong
    lib.stt_tcp_window.argtypes = [p, p, p]
    lib.stt_tcp_window.restype = ctypes.c_int


LIBRARY = KernelLibrary("tcp_window.cu", "libstt_tcp_window.so", _declare,
                        "stt_tcp_error_string", flags=("-Xptxas=-v",))


def parse_operands(text: str) -> list:
    """The operand table `stt_tcp_operands()` names ("type|key|dims;" per
    field): a "_*" key is one operand per packet column, a "_@" key one
    per trace packet column."""
    return window_table.parse_operands(text, TcpWindowTable.EXPAND)


def check_consts(lib) -> None:
    """The kernel's copies of the loop's constants against the loop's."""
    from shadow_tpu_torch.ops import tcp_span
    window_table.check_consts("tcp_window", lib.stt_tcp_consts().decode(),
                              tcp_span)
    if tuple(tcp_span.PK_KEYS) != PK_KEYS:
        raise RuntimeError("tcp_window: packet columns differ from "
                           "ops/tcp_span.py PK_KEYS")


class TcpWindowTable(LaneTable):
    """The kernel's operand and parameter tables for one span build.
    `shape` gives the table's dimension names (n, n+1, cc, cc+1, I, T,
    CQ, RT, RA, OP, asys, tel, mark, out, tr) and `params` the build's
    constant parameters (runner._window_shape)."""

    FAMILY = "tcp_window"
    OPERANDS = "stt_tcp_operands"
    PARAMS = "stt_tcp_params"
    STATS = "stt_tcp_stats"
    BITMAP_WORDS = "stt_tcp_bitmap_words"
    EXPAND = {"*": PK_KEYS, "@": TR_PK_KEYS}
    LAUNCH_WORDS = ("window_end",)
    # The abort words start (and each launch leaves them) at "none".
    STATS_INIT = tuple((k, I64_MAX) for k in (
        "ST_AB_ITER", "ST_AB_TRACE", "ST_AB_OUT", "ST_AB_STRUCT",
        "ST_AB_SITE"))

    def __init__(self, lib, shape: dict, params: dict):
        super().__init__(lib, shape, params)
        # The abort bits' words, by name, after ST_AB_BITS.
        bits = self.layout["ST_AB_BITS"]
        self.layout.update(ST_AB_TRACE=bits, ST_AB_OUT=bits + 1,
                           ST_AB_STRUCT=bits + 2)

    def check_consts(self, lib) -> None:
        check_consts(lib)

    def fixed_params(self) -> dict:
        return {"refill_ns": REFILL_NS, "target_ns": CODEL_TARGET_NS,
                "mtu": MTU, "interval_ns": CODEL_INTERVAL_NS}

    def _check(self, o, t) -> None:
        super()._check(o, t)
        # The lane reads the bool rows eight slots at a time.
        if o.dtype == torch.bool and len(o.dims) == 2 \
                and (t.shape[1] % 8 or t.data_ptr() % 8):
            raise ValueError(f"tcp_window {o.key}: rows of {t.shape[1]} "
                             f"bytes at {t.data_ptr():#x} are not whole "
                             f"8-byte words")


class TcpWindow:
    """Wrapper of `stt_tcp_window` (replaces the window loop of the
    reference's TcpSpanRunner._build.run, shadow_tpu/ops/tcp_span.py:2373,
    with its relays' Pallas make_bucket_step / make_codel_head)."""

    def __init__(self, library: KernelLibrary | None = None):
        self.library = LIBRARY if library is None else library
        self.launches = 0

    def bind(self, shape: dict, params: dict) -> "BoundTcpWindow":
        """One span build's window step (`shape`, `params`: as
        TcpWindowTable takes them)."""
        return BoundTcpWindow(self, shape, params)


class BoundTcpWindow:
    """A span build's window step on the card: `begin(st)` at a run's
    start, `step(st, window_end)` once per window (one launch on the
    current stream: the worker's for a speculative span), `end()` after
    the run's last sync: the counts of LaneTable.end, the windows
    launched and their launch-to-end time (`window_ms`: CUDA events just
    before each launch call and after it, so the launch's host issue is
    in it; a window's card time alone is timed by `chip_smoke.py`)."""

    def __init__(self, wrapper: TcpWindow, shape: dict, params: dict):
        self.wrapper = wrapper
        self.shape, self.params = shape, params
        self.table = None

    def begin(self, st: dict) -> None:
        dev = st["now"].device
        if dev.type != "cuda":
            raise ValueError(f"tcp_window: expected CUDA tensors, got "
                             f"{dev}; the CPU runs the eager window")
        if self.table is None:
            self.table = TcpWindowTable(self.wrapper.library.build(),
                                        self.shape, self.params)
        self.table.begin(st)
        self._events = []

    def launch(self, st: dict, window_end: int) -> None:
        """One launch on the current stream, untimed (a CUDA graph may
        capture it)."""
        table, words = self.table.fill(st, window_end)
        code = self.table.lib.stt_tcp_window(
            table, words,
            torch.cuda.current_stream(st["now"].device).cuda_stream)
        self.wrapper.launches += 1
        self.wrapper.library.check(code, "tcp_window")

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


def _real_rows(ops: list, st: dict) -> dict:
    """`st`'s written operands with the conn-major trash row dropped (the
    eager loop scribbles on it for masked lanes; nothing reads it)."""
    return {o.key: st[o.key][:-1] if o.dims and o.dims[0] == "cc+1"
            else st[o.key] for o in ops if o.written and o.key in st}


def window_read_bytes(before: dict, after: dict) -> dict:
    """The reads one window must make, from the span state `before` it
    and `after` it (a window that did not abort):

    - idle: every lane ends on the busy/due test, which reads its
      continuation, inbox length and position, the inbox head's time
      where one is pending, the timer heap's valid bytes and each valid
      timer's time (counted on `after`, the state that last test saw);
    - dequeue: each inbox pop and CoDel dequeue reads its slot's time
      (ib_time, cq_enq);
    - copies: each packet moved on (inbox -> CoDel ring, CoDel ring ->
      the conn, a conn's egress ring -> the wire) is read once from
      where it lay, all 21 words.

    Returns the parts and their sum under "total"."""
    H = after["now"].shape[0]
    T = after["th_valid"].shape[1]

    def delta(k) -> int:
        a, b = after[k], before[k]
        if a.shape[0] != H:  # conn-major: the trash row left out
            a, b = a[:-1], b[:-1]
        return int((a - b).sum())

    pending = int((after["ib_len"] > after["ib_pos"]).sum())
    valid = int(after["th_valid"].sum())
    moved = delta("ib_pos") + delta("cq_pos") + delta("op_pos")
    parts = {
        "idle": H * (3 * 8 + T) + 8 * (pending + valid),
        "dequeue": 8 * (delta("ib_pos") + delta("cq_pos")),
        "copies": PK_WORDS * moved}
    parts["total"] = sum(parts.values())
    return parts


def window_need_bytes(ops: list, before: dict, after: dict) -> dict:
    """A lower bound of the bytes one window must move, from the span
    state `before` it and `after` it (a window that did not abort): the
    reads of window_read_bytes, and under "writes" every changed element
    of a written operand once (changed_bytes; conn-major trash rows left
    out).

    Returns the parts and their sum under "total"."""
    parts = window_read_bytes(before, after)
    del parts["total"]
    parts["writes"] = changed_bytes(ops, _real_rows(ops, before),
                                    _real_rows(ops, after))
    parts["total"] = sum(parts.values())
    return parts


# The one wrapper: chip_smoke.py zeroes its launch counter before a main
# path and reads it after.
TCP_WINDOW = TcpWindow()
