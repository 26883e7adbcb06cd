"""The PHOLD/udp-mesh span kernel (`csrc/phold_span.cu` `stt_phold_span`,
ROADMAP B6) behind its wrapper.

The device-span loop (ops/phold_span.py `run`) steps `max_rounds`
rounds: a window, then the round end (propagation of the round's
outbox, the merge into the destination inboxes), then the round's
scalars (the next start, the runahead).  The kernel runs the whole loop
in one cooperative launch, with grid barriers between the phases
(csrc/phold_round_end.cuh holds the round end's laws, phold_lane.cuh
the window's); the host fills its operand table once, launches once and
reads one block of span words and statistics at the end.

- The plain version is the runner's own eager `run` (the eager window
  `window_plain`, then the eager `propagate` and ops/span_common.py
  `merge_inbox`); the runner runs it on the CPU and on the card when a
  `window_factory` is set (ops/phold_span.py); `chip_smoke.py` holds the
  kernel against it there.
- `PholdSpan` is the wrapper and `PHOLD_SPAN` its one instance.  `bind`
  makes one span build's span step, which launches the kernel on CUDA
  tensors or raises (a cooperative launch the card refuses raises too);
  it never runs on a CPU tensor.  The kernel steps a lane with a team of
  W threads; the step launches the instantiation `pick_team` chooses
  from the lane count (32 or 8 where the teams fit in a warp an SM,
  else 1), or the one `bind(..., team=W)` names.  Its plain integer
  counters: `launches` (bumped only where it launches) and `host_reads`
  (the span words read back, one a launch).
- `SpanTable` is the window kernel's name-driven operand table
  (ops/phold_window.py `WindowTable`) over both tables, with the span's
  buffers: the iteration bitmaps, the per-row arrival counts, and one
  block holding the window statistics and the span words, read once.
- `span_need_bytes` counts what a span must move, for the kernel's
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

from shadow_tpu_torch.ops.phold_window import (PK_KEYS, WindowTable,
                                               parse_words,
                                               window_read_bytes)
from shadow_tpu_torch.ops.queues import KernelLibrary


def _declare(lib) -> None:
    p = ctypes.c_void_p
    for fn in (lib.stt_phold_span_operands, lib.stt_phold_span_params,
               lib.stt_phold_span_words, lib.stt_phold_consts,
               lib.stt_phold_stats):
        fn.argtypes = []
        fn.restype = ctypes.c_char_p
    lib.stt_phold_span_teams.argtypes = []
    lib.stt_phold_span_teams.restype = ctypes.c_char_p
    for fn in (lib.stt_phold_bitmap_words, lib.stt_phold_span_row_max):
        fn.argtypes = []
        fn.restype = ctypes.c_longlong
    lib.stt_phold_span_grid.argtypes = [ctypes.c_longlong, ctypes.c_int, p]
    lib.stt_phold_span_grid.restype = ctypes.c_int
    lib.stt_phold_span.argtypes = [p, p, ctypes.c_int, ctypes.c_int, p]
    lib.stt_phold_span.restype = ctypes.c_int


LIBRARY = KernelLibrary("phold_span.cu", "libstt_phold_span.so", _declare,
                        "stt_phold_span_error_string",
                        flags=("-Xptxas=-v",))

# The phase clocks' span words, in the kernel's order: block 0 thread
# 0's clock64() cycles in phases A (window), B (propagation and appends)
# and C (rows settled), each from its start to its grid barrier's exit,
# the part of those inside the barriers, and the whole span.
CLOCKS = ("window", "propagate", "settle", "wait", "span")


class SpanTable(WindowTable):
    """The span kernel's operand and parameter tables for one span build
    (WindowTable's over the window's and the round end's names).  `shape`
    adds v (the graph's nodes) to the window's dimension names; `params`
    adds the build's round-end words (n_nodes, k0, k1, bootstrap_end,
    time_never)."""

    OPERANDS = "stt_phold_span_operands"
    PARAMS = "stt_phold_span_params"
    LAUNCH_WORDS = WindowTable.LAUNCH_WORDS + (
        "start", "stop", "limit", "runahead", "max_rounds")

    def __init__(self, lib, shape: dict, params: dict):
        super().__init__(lib, shape, params)
        self.span_layout = parse_words(lib.stt_phold_span_words().decode())
        self.dims["span"] = self.span_layout["SW_N"]

    def begin(self, st: dict, pay: int) -> None:
        """A run's start: its buffers zeroed on the state's device; the
        statistics and the span words share one block."""
        super().begin(st, pay)
        dev = st["now"].device
        n_st = self.layout["ST_N"]
        self.block = torch.zeros(n_st + self.dims["span"],
                                 dtype=torch.int64, device=dev)
        self.stats = self.block[:n_st]
        self.span_words = self.block[n_st:]
        self.arrivals = torch.zeros(self.dims["n"], dtype=torch.int64,
                                    device=dev)

    def _tensor(self, st, key):
        if key == "span.words":
            return self.span_words
        if key == "span.arrivals":
            return self.arrivals
        return super()._tensor(st, key)

    def read(self) -> dict:
        """The span's results from one read of the block: the eager
        run's scalars (start, runahead, rounds, busy_rounds, packets,
        busy_end), the abort word, the window counts of WindowTable.end
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
        return out


def pick_team(n: int, grids: dict, sms: int, cap_i: int,
              row_max: int) -> tuple:
    """The team width and grid of a span of n lanes: `grids` maps each
    width the library holds to (blocks its lanes need, blocks the card
    holds at once), `sms` is the card's SMs.  The widest width whose
    teams fit in a warp an SM (n * W <= 32 * sms; a wider team also
    needs cap_i <= row_max, its settle's scratch): there every lane
    gets warps of its own where its law runs alone, on an SM that would
    otherwise idle.  Past that budget a team of one a lane: 32 lanes a
    warp share each instruction of the law, which measured faster than
    any wider team at 8,192 lanes (PERF.md), on at most the
    blocks the card holds at once, the lanes grid-stride.  Returns
    (team, blocks); blocks 0 when the card cannot launch a cooperative
    grid."""
    for team in sorted(grids, reverse=True):
        need, cap = grids[team]
        if team > 1 and cap_i <= row_max and n * team <= 32 * sms \
                and 0 < need <= cap:
            return team, need
    need, cap = grids[1]
    return 1, min(need, cap)


def launch_grids(lib, n: int) -> tuple:
    """(each team width the library holds -> (blocks its n lanes need,
    blocks the card holds at once), the card's SMs), on the current
    device."""
    out = (ctypes.c_longlong * 4)()
    grids = {}
    for team in map(int, lib.stt_phold_span_teams().decode().split()):
        err = lib.stt_phold_span_grid(n, team, out)
        if err:
            raise RuntimeError(
                f"phold_span grid at team {team}: "
                f"{lib.stt_phold_span_error_string(err).decode()}")
        grids[team] = (int(out[0]), int(out[1]))
    return grids, int(out[3])


class PholdSpan:
    """Wrapper of `stt_phold_span` (replaces the reference's
    PholdSpanRunner._build.run, shadow_tpu/ops/phold_span.py:1675, with
    its relays' Pallas make_bucket_step / make_codel_head)."""

    def __init__(self, library: KernelLibrary | None = None):
        self.library = LIBRARY if library is None else library
        self.launches = 0
        self.host_reads = 0

    def bind(self, shape: dict, params: dict,
             team: int | None = None) -> "BoundPholdSpan":
        """One span build's span step (`shape`, `params`: as SpanTable
        takes them) at the team width `pick_team` chooses, or at `team`
        (a width the library holds)."""
        return BoundPholdSpan(self, shape, params, team)


class BoundPholdSpan:
    """A span build's span step on the card: `step(st, pay, start, stop,
    limit, runahead, max_rounds)` runs a whole span (one launch on the
    current stream, then one read of the span's block) and returns
    SpanTable.read's dict with `span_ms`, the launch-to-end time (CUDA
    events just before the launch call and after it, so the launch's
    host issue is in it; `chip_smoke.py` times the card alone)."""

    def __init__(self, wrapper: PholdSpan, shape: dict, params: dict,
                 team: int | None = None):
        self.wrapper = wrapper
        self.shape, self.params = shape, params
        self.table = None
        self.blocks = 0
        self.team = team
        self.grids = {}

    def begin(self, st: dict, pay: int) -> None:
        dev = st["now"].device
        if dev.type != "cuda":
            raise ValueError(f"phold_span: expected CUDA tensors, got "
                             f"{dev}; the CPU runs the eager loop")
        if self.table is None:
            lib = self.wrapper.library.build()
            self.grids, sms = launch_grids(lib, self.shape["n"])
            team, blocks = pick_team(self.shape["n"], self.grids, sms,
                                     self.shape["I"],
                                     lib.stt_phold_span_row_max())
            if self.team is not None:
                if self.team not in self.grids:
                    raise ValueError(f"phold_span: no team width "
                                     f"{self.team} (the library holds "
                                     f"{sorted(self.grids)})")
                team = self.team
                need, cap = self.grids[team]
                blocks = min(need, cap)
            if blocks == 0:
                raise RuntimeError("phold_span: the card does not take "
                                   "cooperative launches")
            self.table = SpanTable(lib, self.shape, self.params)
            self.team, self.blocks = team, blocks
        self.table.begin(st, pay)

    def launch(self, st: dict, start: int, stop: int, limit: int,
               runahead: int, max_rounds: int) -> None:
        """One launch on the current stream, nothing read back."""
        table, words = self.table.fill(
            st, start=start, stop=stop, limit=limit, runahead=runahead,
            max_rounds=max_rounds)
        code = self.table.lib.stt_phold_span(
            table, words, self.team, self.blocks,
            torch.cuda.current_stream(st["now"].device).cuda_stream)
        self.wrapper.launches += 1
        self.wrapper.library.check(code, "phold_span")

    def __call__(self, st: dict, pay: int, start: int, stop: int,
                 limit: int, runahead: int, max_rounds: int) -> dict:
        self.begin(st, pay)
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


# An inbox entry's columns, and an outbox packet's: the ones every
# packet's propagation reads, the ones a lost packet's trace line adds,
# and the rest, which only a kept packet's append reads.
IB_ENTRY = ("time", "src", "seq") + PK_KEYS
OUT_PROPAGATE = ("src", "dst", "pseq", "t")
OUT_TRACE = ("sip", "sport", "dip", "dport")
OUT_APPEND = ("seq",) + OUT_TRACE


def round_end_need_bytes(before: dict, after: dict, n_out: int) -> dict:
    """A lower bound of the bytes one round end must move beyond the
    span's changed words (span_state_bytes), from the span state
    `before` it (after the round's window) and `after` it, with `n_out`
    the round's outbox count:

    - outbox: each outbox packet read once: a kept packet's every
      column; a lost one's source, destination, sequence and time (an
      unreachable one's source and destination) and, when traced, what
      its trace line copies;
    - arrivals: each kept packet written once, at its final slot (an
      inbox entry's columns);
    - moved: each unconsumed entry whose slot the compaction or the
      merge changed, read and written once;
    - keys: each unconsumed entry that kept its slot in a row that took
      arrivals, its (time, src, seq) read to place them.

    The rows' vacated slots, lengths, drop counters and trace lines are
    state words span_state_bytes charges once a span; the next-event
    minimum reads what the window's last busy/due test read
    (window_read_bytes "idle") or what the settle wrote.  Returns the
    parts and their sum under "total"."""
    from shadow_tpu_torch.ops.phold_span import TEL_UNREACHABLE

    def width(prefix, keys) -> int:
        return sum(after[prefix + k].element_size() for k in keys)

    O = after["out_src"].shape[0] - 1
    n = min(int(n_out), O)
    lost = int((after["app_pkts_dropped"]
                - before["app_pkts_dropped"]).sum())
    unreach = int((after["drop_causes"][:, TEL_UNREACHABLE]
                   - before["drop_causes"][:, TEL_UNREACHABLE]).sum())
    trace = width("out_", OUT_TRACE) if "tr_n" in after else 0
    if trace:
        lost_read = lost * (width("out_", OUT_PROPAGATE) + trace)
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
    written operand (SpanTable.ops) whose value differs between the
    state `before` the span and `after` it, once, at its size.  The
    outbox is left out (the rounds' scratch, read by each round end),
    and so are the inbox entries below each row's final length (each is
    an arrival or a moved entry, charged by its round end): what stays
    of the inbox are the fills of the vacated slots."""
    live = torch.arange(after["ib_time"].shape[1],
                        device=after["ib_time"].device)[None, :] \
        < after["ib_len"][:, None]
    entries = {f"ib_{k}" for k in IB_ENTRY}
    total = 0
    for o in ops:
        if not o.written or o.key not in after \
                or o.key.startswith("out_"):
            continue
        diff = after[o.key] != before[o.key]
        if o.key in entries:
            diff &= ~live
        total += int(diff.sum()) * after[o.key].element_size()
    return total


def span_need_bytes(fn, ops: list, st: dict, pay: int, start: int,
                    stop: int, limit: int, runahead: int,
                    max_rounds: int) -> dict:
    """The span's bound in bytes, from the eager loop of a built loop
    `fn` (its `window_plain` and `round_end`, whatever its span step)
    stepped on `st` round by round, and the span kernel's operand table
    `ops` (SpanTable.ops): each window's reads (window_read_bytes), each
    round end's (round_end_need_bytes), and the span's changed words
    once (span_state_bytes).  Returns those three totals, their sum and
    the rounds."""
    from shadow_tpu_torch.tools.relay_cases import clone_state
    fn.prepare(st, pay)
    first = clone_state(st)
    out = {"window": 0, "round_end": 0, "rounds": 0}
    code = 0
    while (out["rounds"] < max_rounds and start < limit and start < stop
           and not code):
        window_end = min(start + runahead, stop)
        before = clone_state(st)
        fn.window_plain(st, window_end)
        out["window"] += window_read_bytes(before, st)["total"]
        mid = clone_state(st)
        n_out, min_lat, start, code = fn.round_end(st, window_end)
        out["round_end"] += round_end_need_bytes(mid, st, n_out)["total"]
        if 0 < min_lat < runahead:
            runahead = min_lat
        out["rounds"] += 1
    out["state"] = span_state_bytes(ops, first, st)
    out["total"] = out["window"] + out["round_end"] + out["state"]
    return out


# The one wrapper: chip_smoke.py zeroes its counters before a main path
# and reads them after.
PHOLD_SPAN = PholdSpan()
