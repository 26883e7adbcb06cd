"""The operand tables of the hand window kernels, family-free: what the
PHOLD/udp-mesh window (ops/phold_window.py) and the TCP window
(ops/tcp_window.py) wrappers share.

A window kernel's lane-law header names its operand and parameter
tables as X-macros, and its library hands back their name strings, its
loop constants, its statistics layout and its bitmap width.  `LaneTable`
fills both tables by those names (so their order lives in the header
alone), checks every operand's dtype, shape and contiguity by its table
entry, owns the window's bitmaps and statistics words and reads the
counts back.  A family's table subclasses it with the library's
function names, the packet-column expansions of its operand string and
its constants' check.  The tier-1 tests drive the same tables through
host builds of the lane laws.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

_DTYPES = {"uint8_t": torch.bool, "uint32_t": torch.int32,
           "int64_t": torch.int64}


@dataclass(frozen=True)
class Operand:
    """One pointer of a window kernel's operand table."""

    key: str        # span-state key, or "win.*" (a LaneTable buffer)
    dims: tuple     # shape in the table's names (() for a 0-d tensor)
    dtype: torch.dtype
    written: bool


def parse_operands(text: str, expand: dict) -> list:
    """The operand table a library's operand string names ("type|key|dims;"
    per field): a key ending in one of `expand`'s suffixes (the first
    that matches) stands for one operand per column `expand[suffix]`
    lists, the suffix replaced by the column's name."""
    ops = []
    for entry in filter(None, text.split(";")):
        ctype, key, dims = entry.split("|")
        keys = [key]
        for suffix, cols in expand.items():
            if key.endswith(suffix):
                keys = [key[:-len(suffix)] + k for k in cols]
                break
        base = ctype.replace("const ", "").rstrip("*").strip()
        ops += [Operand(k, tuple(filter(None, dims.split(","))),
                        _DTYPES[base], not ctype.startswith("const"))
                for k in keys]
    return ops


def parse_words(text: str) -> dict:
    """"NAME=value ..." -> {NAME: int}."""
    return {k: int(v) for k, v in
            (w.split("=") for w in text.split())}


def check_consts(family: str, text: str, module) -> None:
    """A kernel's copies of its loop's constants ("NAME=value ...")
    against the loop module's attributes of the same names."""
    bad = {k: (v, getattr(module, k, None))
           for k, v in parse_words(text).items()
           if getattr(module, k, None) != v}
    if bad:
        raise RuntimeError(f"{family}: constants differ from "
                           f"{module.__name__} (kernel, loop): {bad}")


def changed_bytes(ops: list, before: dict, after: dict) -> int:
    """Every element of a written operand whose value differs between
    `before` and `after`, at its size (an unchanged word need not be
    written)."""
    return sum(int((after[o.key] != before[o.key]).sum())
               * after[o.key].element_size()
               for o in ops if o.written and o.key in after)


class LaneTable:
    """A window kernel's operand and parameter tables for one span build,
    filled by the names `lib` returns (the nvcc library, or the tests'
    host build of the same header).  `shape` gives the table's dimension
    names and `params` the build's constant parameters; `begin` makes a
    run's buffers and `fill` completes the tables for one launch."""

    FAMILY = "window"
    # The library's name functions.
    OPERANDS = PARAMS = STATS = BITMAP_WORDS = ""
    # Operand-key suffixes that stand for one operand per listed column.
    EXPAND: dict = {}
    # The words set per run or launch rather than by the build.
    LAUNCH_WORDS: tuple = ()
    # The statistics words a run starts at other than 0.
    STATS_INIT: tuple = ()

    def __init__(self, lib, shape: dict, params: dict):
        self.lib = lib
        self.check_consts(lib)
        self.ops = parse_operands(getattr(lib, self.OPERANDS)().decode(),
                                  self.expand())
        self.names = getattr(lib, self.PARAMS)().decode().split()
        self.layout = parse_words(getattr(lib, self.STATS)().decode())
        self.words = int(getattr(lib, self.BITMAP_WORDS)())
        self.dims = dict(shape, passes=self.layout["N_PASSES"],
                         words=self.words, stats=self.layout["ST_N"])
        self.params = dict(params, bitmap_words=self.words,
                           **self.fixed_params())
        want = set(self.params) | set(self.LAUNCH_WORDS)
        if set(self.names) != want:
            raise RuntimeError(f"{self.FAMILY}: the kernel's parameters "
                               f"{self.names} are not {sorted(want)}")
        self._table = (ctypes.c_uint64 * len(self.ops))()
        self._words = (ctypes.c_longlong * len(self.names))()
        self._addr = (ctypes.addressof(self._table),
                      ctypes.addressof(self._words))
        self.written = [j for j, o in enumerate(self.ops) if o.written]

    def check_consts(self, lib) -> None:
        raise NotImplementedError

    def expand(self) -> dict:
        """The operand string's column expansions (EXPAND)."""
        return self.EXPAND

    def fixed_params(self) -> dict:
        """Parameters every build of the family passes alike."""
        return {}

    def begin(self, st: dict) -> None:
        """A run's start: its bitmaps and statistics (zero, but for the
        STATS_INIT words) on the state's device."""
        dev = st["now"].device
        self.bitmap = torch.zeros((self.dims["passes"], self.words),
                                  dtype=torch.int32, device=dev)
        self.stats = torch.zeros(self.layout["ST_N"], dtype=torch.int64,
                                 device=dev)
        for name, value in self.STATS_INIT:
            self.stats[self.layout[name]] = value
        self._checked = False

    def _tensor(self, st, key):
        if key == "win.bitmap":
            return self.bitmap
        if key == "win.stats":
            return self.stats
        return st.get(key)

    def optional(self, key: str) -> bool:
        """May the operand `key` be absent (a null pointer)?  The trace's
        when the span is not traced."""
        return key.startswith("tr_") and not self.params["tracing"]

    def _check(self, o: Operand, t) -> None:
        if t is None:
            if self.optional(o.key):
                return
            raise KeyError(f"{self.FAMILY}: no operand {o.key!r}")
        if not isinstance(t, torch.Tensor) or t.dtype != o.dtype:
            raise TypeError(f"{self.FAMILY} {o.key}: expected {o.dtype}, "
                            f"got {getattr(t, 'dtype', type(t))}")
        want = tuple(self.dims[d] for d in o.dims)
        if tuple(t.shape) != want:
            raise ValueError(f"{self.FAMILY} {o.key}: expected shape {want} "
                             f"({', '.join(o.dims)}), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{self.FAMILY} {o.key}: not contiguous")

    def fill(self, st: dict, window_end: int = 0, **words) -> tuple:
        """Both tables for one launch (`words`: the launch's other
        LAUNCH_WORDS); returns their addresses.  The first fill of a run
        checks every operand by its table entry."""
        ts = [self._tensor(st, o.key) for o in self.ops]
        if not self._checked:
            for o, t in zip(self.ops, ts):
                self._check(o, t)
            self._checked = True
        ptrs = [0 if t is None else t.data_ptr() for t in ts]
        written = [ptrs[j] for j in self.written if ptrs[j]]
        if len(set(written)) != len(written):
            raise RuntimeError(f"{self.FAMILY}: two written operands share "
                               f"storage; the kernel writes in place")
        self._table[:] = ptrs
        self.params["window_end"] = int(window_end)
        self.params.update((k, int(v)) for k, v in words.items())
        self._words[:] = [self.params[k] for k in self.names]
        return self._addr

    def end(self) -> dict:
        """The run's counts, summed over its windows: fires and lanes by
        KS slot, the law calls made in the lanes and the
        micro-iterations (each window's largest lane count)."""
        return self.counts(self.stats.cpu().numpy())

    def counts(self, s) -> dict:
        """LaneTable.end's counts from the statistics words `s`."""
        lay = self.layout
        return {"fires": s[lay["ST_FIRES"]:lay["ST_LANES"]].copy(),
                "lanes": s[lay["ST_LANES"]:lay["ST_CALLS"]].copy(),
                "calls": s[lay["ST_CALLS"]:lay["ST_ITERS"]].copy(),
                "iters": int(s[lay["ST_ITERS"]])}


# The sample rows a launch's buffers hold at most (a span that records
# is clamped to this many rounds: ops/span_mesh.py TEL_ROWS / FAB_ROWS).
SAMPLE_ROWS_MAX = 64


class SampleRows:
    """The span kernels' sample-row buffers, a mixin of their operand
    tables: the sim-netstat (`tel`) and fabric (`fab`) rows of one
    launch, laid after the statistics and span words in the one block
    the span's single host read brings back.  A channel's interval
    parameter (`tel_iv` / `fab_iv`) of 0 leaves its operands null."""

    # (prefix, interval parameter, columns, width dimension)
    SAMPLE_CHANNELS: tuple = ()
    # Operand-key suffixes of the rows' column expansions.
    SAMPLE_EXPAND: dict = {}

    def expand(self) -> dict:
        return {**self.EXPAND, **self.SAMPLE_EXPAND}

    def sample_on(self) -> list:
        return [c for c in self.SAMPLE_CHANNELS if self.params.get(c[1])]

    def optional(self, key: str) -> bool:
        if key.startswith("span.") and key[5:9] in ("tel_", "fab_"):
            return not self.params.get(f"{key[5:8]}_iv")
        return super().optional(key)

    def sample_words(self, rows: int) -> int:
        """The rows' words for `rows` rows of every channel that is on."""
        return sum(rows * (1 + len(cols) * self.dims[width])
                   for _p, _iv, cols, width in self.sample_on())

    def place_rows(self, block, at: int, rows: int) -> None:
        """Views of the rows in `block` from word `at`, and the launch's
        `rows` parameter."""
        self.rows = {}
        self.params["rows"] = rows
        self.dims["rows"] = rows
        for prefix, _iv, cols, width in self.sample_on():
            w = self.dims[width]
            self.rows[f"span.{prefix}_t"] = block[at:at + rows]
            at += rows
            for c in cols:
                self.rows[f"span.{prefix}_{c}"] = \
                    block[at:at + rows * w].view(rows, w)
                at += rows * w

    def read_rows(self, b, at: int, counts: dict) -> dict:
        """The rows from the host copy `b` of the block (laid out as
        place_rows laid them), under the eager loop's keys, with each
        channel's count (`counts`: prefix -> rows taken)."""
        out = {}
        rows = self.params["rows"]
        for prefix, _iv, cols, width in self.sample_on():
            n = counts[prefix]
            if n > rows:
                raise RuntimeError(f"{self.FAMILY}: {n} {prefix} sample "
                                   f"rows in a buffer of {rows}")
            w = self.dims[width]
            out[f"{prefix}_n"] = n
            out[f"{prefix}_t"] = b[at:at + rows].copy()
            at += rows
            for c in cols:
                out[f"{prefix}_{c}"] = b[at:at + rows * w].reshape(rows, w)
                at += rows * w
        return out
