"""The TCP stream's span kernel (`csrc/tcp_span.cu` `stt_tcp_span`,
ROADMAP B5b) behind its wrapper.

The TCP device-span loop (ops/tcp_span.py `run`) steps `max_rounds`
rounds: a window, then the round end (propagation of the round's outbox,
the drops' counts and trace lines, the merge into the destination
inboxes), then the round's scalars (the next start, the runahead).  The
kernel runs the whole loop in one cooperative launch, with grid barriers
between the phases (csrc/tcp_round_end.cuh holds the round end's laws,
csrc/tcp_lane.cuh the window's, unchanged); the host fills its operand
table once, launches once and reads one block of span words and
statistics at the end.

- The plain version is the runner's own eager loop (the eager window
  `window_plain`, then the eager `round_end`: ops/tcp_span.py
  `propagate` and ops/span_common.py `merge_inbox`); the runner runs it
  on the CPU and on the card when a `window_factory` is set;
  `chip_smoke.py` holds the kernel against it there.
- `TcpSpan` is the wrapper and `TCP_SPAN` its one instance.  `bind`
  makes one span build's span step, which launches the kernel on CUDA
  tensors or raises (a cooperative launch the card refuses raises too);
  it never runs on a CPU tensor.  Its plain integer counters: `launches`
  (bumped only where it launches) and `host_reads` (the span words read
  back, one a launch).
- `TcpSpanTable` is the window kernel's name-driven operand table
  (ops/tcp_window.py `TcpWindowTable`) over both tables, with the span's
  buffers: the per-row arrival counts, each lane's timer-heap least, and
  one block holding the window statistics and the span words, read once.
- `tcp_span_need_bytes` counts what a span must move, for the kernel's
  bound: each window's reads, each round end's packets and moved
  entries (`round_end_need_bytes`), and the span's changed words once
  (`span_state_bytes`).

The kernel builds at first use with nvcc for sm_90a (with `-Xptxas=-v`,
whose report `LIBRARY.log` keeps) into the gitignored
`shadow_tpu_torch/csrc/build/` and binds through a plain C interface with
ctypes.  Nothing is imported or built at import time.
"""

from __future__ import annotations

import ctypes

import torch

from shadow_tpu_torch.ops import window_table
from shadow_tpu_torch.ops.queues import KernelLibrary
from shadow_tpu_torch.ops.tcp_window import (PK_KEYS, TcpWindowTable,
                                             _real_rows, window_read_bytes)
from shadow_tpu_torch.ops.span_common import FAB_COLS
from shadow_tpu_torch.ops.window_table import (SAMPLE_ROWS_MAX, SampleRows,
                                               parse_words)
from shadow_tpu_torch.trace.events import TEL_FIELD_NAMES


def _declare(lib) -> None:
    p = ctypes.c_void_p
    for fn in (lib.stt_tcp_span_operands, lib.stt_tcp_span_params,
               lib.stt_tcp_span_words, lib.stt_tcp_span_consts,
               lib.stt_tcp_span_stats):
        fn.argtypes = []
        fn.restype = ctypes.c_char_p
    lib.stt_tcp_span_bitmap_words.argtypes = []
    lib.stt_tcp_span_bitmap_words.restype = ctypes.c_longlong
    lib.stt_tcp_span_grid.argtypes = [ctypes.c_longlong]
    lib.stt_tcp_span_grid.restype = ctypes.c_int
    lib.stt_tcp_span.argtypes = [p, p, ctypes.c_int, p]
    lib.stt_tcp_span.restype = ctypes.c_int


def _declare_card(lib) -> None:
    _declare(lib)
    lib.stt_tcp_span_launch_shape.argtypes = [ctypes.c_longlong,
                                              ctypes.c_void_p]
    lib.stt_tcp_span_launch_shape.restype = ctypes.c_int
    lib.stt_tcp_span_frame.argtypes = [ctypes.c_void_p]
    lib.stt_tcp_span_frame.restype = None


LIBRARY = KernelLibrary("tcp_span.cu", "libstt_tcp_span.so", _declare_card,
                        "stt_tcp_span_error_string", flags=("-Xptxas=-v",))

# The phase clocks' span words, in the kernel's order: block 0 thread
# 0's clock64() cycles in phases A (windows and row compaction), B
# (propagation and appends) and C (rows settled), each from its start to
# its grid barrier's exit, the part of those inside the barriers, and the
# whole span.
CLOCKS = ("window", "propagate", "settle", "wait", "span")


class TcpSpanTable(SampleRows, TcpWindowTable):
    """The span kernel's operand and parameter tables for one span build
    (TcpWindowTable's over the window's and the round end's names).
    `shape` adds v (the graph's nodes) to the window's dimension names;
    `params` adds the build's round-end words (n_nodes, k0, k1,
    bootstrap_end, time_never, and the channels' intervals tel_iv and
    fab_iv, 0 when off)."""

    FAMILY = "tcp_span"
    OPERANDS = "stt_tcp_span_operands"
    PARAMS = "stt_tcp_span_params"
    STATS = "stt_tcp_span_stats"
    BITMAP_WORDS = "stt_tcp_span_bitmap_words"
    LAUNCH_WORDS = TcpWindowTable.LAUNCH_WORDS + (
        "start", "stop", "limit", "runahead", "max_rounds", "rows")
    SAMPLE_CHANNELS = (("tel", "tel_iv", TEL_FIELD_NAMES, "cc"),
                       ("fab", "fab_iv", FAB_COLS, "n"))
    SAMPLE_EXPAND = {"%": TEL_FIELD_NAMES, "&": FAB_COLS}

    def __init__(self, lib, shape: dict, params: dict):
        super().__init__(lib, shape, params)
        self.span_layout = parse_words(lib.stt_tcp_span_words().decode())
        self.dims["span"] = self.span_layout["SW_N"]

    def check_consts(self, lib) -> None:
        from shadow_tpu_torch.ops import tcp_span
        window_table.check_consts("tcp_span",
                                  lib.stt_tcp_span_consts().decode(),
                                  tcp_span)
        if tuple(tcp_span.PK_KEYS) != PK_KEYS:
            raise RuntimeError("tcp_span: packet columns differ from "
                               "ops/tcp_span.py PK_KEYS")

    def begin(self, st: dict, rows: int = SAMPLE_ROWS_MAX) -> None:
        """A run's start: its buffers on the state's device; the
        statistics (as TcpWindowTable starts them), the span words and
        the channels' `rows` sample rows (zeroed) share one block."""
        super().begin(st)
        dev = st["now"].device
        n_st = self.layout["ST_N"]
        n_sw = n_st + self.dims["span"]
        self.block = torch.zeros(n_sw + self.sample_words(rows),
                                 dtype=torch.int64, device=dev)
        self.block[:n_st] = self.stats
        self.stats = self.block[:n_st]
        self.span_words = self.block[n_st:n_sw]
        self.place_rows(self.block, n_sw, rows)
        n = self.dims["n"]
        self.arrivals = torch.zeros(n, dtype=torch.int64, device=dev)
        self.timer = torch.zeros(n, dtype=torch.int64, device=dev)

    def _tensor(self, st, key):
        if key in self.rows:
            return self.rows[key]
        if key == "span.words":
            return self.span_words
        if key == "span.arrivals":
            return self.arrivals
        if key == "span.timer":
            return self.timer
        return super()._tensor(st, key)

    def read(self) -> dict:
        """The span's results from one read of the block: the eager
        run's scalars (start, runahead, rounds, busy_rounds, packets,
        busy_end), the abort word, the window counts of LaneTable.end
        and the phase clocks (cycles, CLOCKS order)."""
        b = self.block.cpu().numpy()
        n_st, w = self.layout["ST_N"], self.span_layout
        words = b[n_st:]
        out = self.counts(b[:n_st])
        out.update({k: int(words[w[f"SW_{k.upper()}"]]) for k in (
            "start", "runahead", "rounds", "busy_rounds", "packets",
            "busy_end", "abort")})
        out["clocks"] = {k: int(words[w["SW_CLK_WINDOW"] + j])
                         for j, k in enumerate(CLOCKS)}
        out["rows"] = self.read_rows(
            b, n_st + self.dims["span"],
            {"tel": int(words[w["SW_TEL_N"]]),
             "fab": int(words[w["SW_FAB_N"]])})
        return out


class TcpSpan:
    """Wrapper of `stt_tcp_span` (replaces the reference's
    TcpSpanRunner._build.run, shadow_tpu/ops/tcp_span.py:2373, its round
    end `propagate` :2142 among it, with its relays' Pallas
    make_bucket_step / make_codel_head)."""

    def __init__(self, library: KernelLibrary | None = None):
        self.library = LIBRARY if library is None else library
        self.launches = 0
        self.host_reads = 0

    def bind(self, shape: dict, params: dict) -> "BoundTcpSpan":
        """One span build's span step (`shape`, `params`: as
        TcpSpanTable takes them)."""
        return BoundTcpSpan(self, shape, params)


class BoundTcpSpan:
    """A span build's span step on the card: `step(st, start, stop,
    limit, runahead, max_rounds)` runs a whole span (one launch on the
    current stream, then one read of the span's block) and returns
    TcpSpanTable.read's dict with `span_ms`, the launch-to-end time (CUDA
    events just before the launch call and after it, so the launch's
    host issue is in it; `chip_smoke.py` times the card alone)."""

    def __init__(self, wrapper: TcpSpan, shape: dict, params: dict):
        self.wrapper = wrapper
        self.shape, self.params = shape, params
        self.table = None
        self.blocks = 0

    def begin(self, st: dict, rows: int = SAMPLE_ROWS_MAX) -> None:
        dev = st["now"].device
        if dev.type != "cuda":
            raise ValueError(f"tcp_span: expected CUDA tensors, got "
                             f"{dev}; the CPU runs the eager loop")
        if self.table is None:
            lib = self.wrapper.library.build()
            blocks = lib.stt_tcp_span_grid(self.shape["n"])
            if blocks < 0:
                self.wrapper.library.check(-blocks, "tcp_span grid")
            if blocks == 0:
                raise RuntimeError("tcp_span: the card does not take "
                                   "cooperative launches")
            self.table = TcpSpanTable(lib, self.shape, self.params)
            self.blocks = blocks
        self.table.begin(st, rows)

    def launch(self, st: dict, start: int, stop: int, limit: int,
               runahead: int, max_rounds: int) -> None:
        """One launch on the current stream, nothing read back."""
        table, words = self.table.fill(
            st, start=start, stop=stop, limit=limit, runahead=runahead,
            max_rounds=max_rounds)
        code = self.table.lib.stt_tcp_span(
            table, words, self.blocks,
            torch.cuda.current_stream(st["now"].device).cuda_stream)
        self.wrapper.launches += 1
        self.wrapper.library.check(code, "tcp_span")

    def __call__(self, st: dict, start: int, stop: int, limit: int,
                 runahead: int, max_rounds: int) -> dict:
        self.begin(st, min(SAMPLE_ROWS_MAX, max_rounds))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        self.launch(st, start, stop, limit, runahead, max_rounds)
        e1.record()
        out = self.table.read()
        self.wrapper.host_reads += 1
        e1.synchronize()
        out["span_ms"] = e0.elapsed_time(e1)
        return out


def launch_shape(lib, n: int) -> dict:
    """The span kernel's launch on the current card at n lanes: threads
    a lane, lanes a block, blocks, dynamic shared memory a block; and the
    lane frame's conn rows, bytes (a tile's), host words and conn words
    a row."""
    out = (ctypes.c_longlong * 4)()
    code = lib.stt_tcp_span_launch_shape(n, out)
    if code:
        raise RuntimeError(f"tcp_span launch shape: "
                           f"{lib.stt_tcp_span_error_string(code).decode()}")
    frame = (ctypes.c_longlong * 4)()
    lib.stt_tcp_span_frame(frame)
    return dict(zip(("team", "tiles", "blocks", "smem", "frame_conns",
                     "frame_bytes", "frame_host_words", "frame_conn_words"),
                    list(out) + list(frame)))


# An inbox entry's columns, and an outbox packet's: the ones every
# packet's propagation reads (the loss rule reads plen: pure acks are
# never lossy), the ones a lost packet's trace line adds, and the rest,
# which only a kept packet's append reads.
IB_ENTRY = ("time", "src", "seq") + PK_KEYS
OUT_PROPAGATE = ("src", "dst", "pseq", "t", "plen")
OUT_TRACE = ("srchost", "sip", "sport", "dip", "dport")
OUT_APPEND = ("seq",) + tuple(k for k in PK_KEYS
                              if k not in OUT_PROPAGATE)


def round_end_need_bytes(before: dict, after: dict, n_out: int) -> dict:
    """A lower bound of the bytes one round end must move beyond the
    span's changed words (span_state_bytes), from the span state
    `before` it (after the round's window) and `after` it, with `n_out`
    the round's outbox count:

    - outbox: each outbox packet read once: a kept packet's every
      column; a lost one's source, destination, sequence, time and
      length (an unreachable one's source and destination) and, when
      traced, what its trace line adds;
    - arrivals: each kept packet written once, at its final slot (an
      inbox entry's 24 columns);
    - moved: each unconsumed entry whose slot the compaction or the
      merge changed, read and written once;
    - keys: each unconsumed entry that kept its slot in a row that took
      arrivals, its (time, src, seq) read to place them.

    The rows' vacated slots, lengths, drop counters and trace lines are
    state words span_state_bytes charges once a span; the next-event
    minimum reads what the window's last busy/due test read
    (window_read_bytes "idle") or what the settle wrote.  Returns the
    parts and their sum under "total"."""
    from shadow_tpu_torch.ops.tcp_span import TEL_UNREACHABLE

    def width(prefix, keys) -> int:
        return sum(after[prefix + k].element_size() for k in keys)

    O = after["out_src"].shape[0] - 1
    n = min(int(n_out), O)
    lost = int((after["pkts_dropped"] - before["pkts_dropped"]).sum())
    unreach = int((after["drop_causes"][:, TEL_UNREACHABLE]
                   - before["drop_causes"][:, TEL_UNREACHABLE]).sum())
    if "tr_n" in after:
        lost_read = lost * width("out_", OUT_PROPAGATE + OUT_TRACE)
    else:
        lost_read = (unreach * width("out_", ("src", "dst"))
                     + (lost - unreach) * width("out_", OUT_PROPAGATE))
    pos, len0, len1 = before["ib_pos"], before["ib_len"], after["ib_len"]
    rem = len0 - pos
    slot = torch.arange(after["ib_time"].shape[1],
                        device=pos.device)[None, :]
    stay = (slot >= pos[:, None]) & (slot < len0[:, None]) \
        & (slot < len1[:, None])
    for k in ("time", "src", "seq"):
        stay &= before[f"ib_{k}"] == after[f"ib_{k}"]
    entry = width("ib_", IB_ENTRY)
    parts = {
        "outbox": (n - lost) * width("out_", OUT_PROPAGATE + OUT_APPEND)
        + lost_read,
        "arrivals": entry * int((len1 - rem).clamp(min=0).sum()),
        "moved": 2 * entry * (int(rem.sum()) - int(stay.sum())),
        "keys": width("ib_", ("time", "src", "seq"))
        * int((stay & (len1 > rem)[:, None]).sum())}
    parts["total"] = sum(parts.values())
    return parts


def span_state_bytes(ops: list, before: dict, after: dict) -> int:
    """The span's writes that no round end charges: every element of a
    written operand (TcpSpanTable.ops) whose value differs between the
    state `before` the span and `after` it, once, at its size, the
    conn-major trash rows left out (the eager loop scribbles there).
    The outbox is left out (the rounds' scratch, read by each round
    end), and so are the inbox entries below each row's final length
    (each is an arrival or a moved entry, charged by its round end):
    what stays of the inbox are the fills of the vacated slots."""
    b, a = _real_rows(ops, before), _real_rows(ops, after)
    live = torch.arange(after["ib_time"].shape[1],
                        device=after["ib_time"].device)[None, :] \
        < after["ib_len"][:, None]
    entries = {f"ib_{k}" for k in IB_ENTRY}
    total = 0
    for k in a:
        if k.startswith("out_"):
            continue
        diff = a[k] != b[k]
        if k in entries:
            diff &= ~live
        total += int(diff.sum()) * a[k].element_size()
    return total


# The state a window's and a round end's byte counts compare with what
# the state was before them (the rest they read after them).
WINDOW_READ_KEYS = ("ib_pos", "cq_pos", "op_pos")
ROUND_END_KEYS = ("pkts_dropped", "drop_causes", "ib_pos", "ib_len",
                  "ib_time", "ib_src", "ib_seq")


def tcp_span_need_bytes(fn, ops: list, st: dict, start: int, stop: int,
                        limit: int, runahead: int, max_rounds: int) -> dict:
    """The span's bound in bytes, from the eager loop of a built loop
    `fn` stepped on `st` round by round, as its `run` steps it (the
    window by `fn.step` where the build has one, else `window_plain`;
    then `round_end`), and the span kernel's operand table `ops`
    (TcpSpanTable.ops): each window's reads (window_read_bytes), each
    round end's (round_end_need_bytes), and the span's changed words
    once (span_state_bytes), and with a channel on, its sample rows'
    (span_common.sample_need_bytes).  Returns those totals, their sum,
    under "run" what `fn(st, ...)` returns after `st` (start, runahead,
    rounds, busy_rounds, packets, busy_end, iters: `st` is left as the
    plain loop leaves it), and under "loop_s" the host wall of the
    loop's own calls (each round ends in a host sync), the counting
    left out."""
    import time

    from shadow_tpu_torch.ops.span_common import sample_need_bytes
    from shadow_tpu_torch.tools.relay_cases import clone_state
    fn.prepare(st)
    first = clone_state(st)
    if fn.step is not None:
        fn.step.begin(st)
    out = {"window": 0, "round_end": 0}
    rounds = busy_rounds = packets = iters = 0
    busy_end = start
    code = 0
    loop_s = 0.0
    while rounds < max_rounds and start < limit and start < stop \
            and not code:
        window_end = min(start + runahead, stop)
        before = {k: st[k].clone() for k in WINDOW_READ_KEYS}
        t0 = time.perf_counter()
        if fn.step is None:
            iters += fn.window_plain(st, window_end)
        else:
            fn.step(st, window_end)
            torch.cuda.synchronize(st["now"].device)
        loop_s += time.perf_counter() - t0
        out["window"] += window_read_bytes(before, st)["total"]
        mid = {k: st[k].clone() for k in ROUND_END_KEYS}
        t0 = time.perf_counter()
        n_out, min_lat, nxt, code = fn.round_end(st, window_end)
        fn.sample(st, start, window_end)
        start = nxt
        loop_s += time.perf_counter() - t0
        out["round_end"] += round_end_need_bytes(mid, st, n_out)["total"]
        if 0 < min_lat < runahead:
            runahead = min_lat
        rounds += 1
        busy_rounds += int(n_out > 0)
        packets += n_out
        busy_end = window_end
    if fn.step is not None:
        got = fn.step.end()
        for k in ("fires", "lanes", "calls"):
            st[f"ks_{k}"] += got[k]
        iters = got["iters"]
    out["state"] = span_state_bytes(ops, first, st)
    out["sample"] = sample_need_bytes(st, st["c_cwnd"].shape[0] - 1,
                                      st["now"].shape[0])
    out["total"] = (out["window"] + out["round_end"] + out["state"]
                    + out["sample"])
    out["rounds"] = rounds
    out["run"] = (start, runahead, rounds, busy_rounds, packets, busy_end,
                  iters)
    out["loop_s"] = loop_s
    return out


# The one wrapper: chip_smoke.py zeroes its counters before a main path
# and reads them after.
TCP_SPAN = TcpSpan()
