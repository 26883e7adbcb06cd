"""The PHOLD/udp-mesh span kernel's team law: csrc/phold_lane.cuh's lane
law with its timer heap's valid bits and keys loaded by a team, and
csrc/phold_round_end.cuh's row compaction and settle done by the team (the
kernel's team of W threads a lane, W in 1, 8, 32 on the card), built for
the host with the system C++ compiler, where a team of W ranks runs
every rank's partial in turn and then the join.

(a) One window and spans of one and four rounds at W = 1, 2, 8 and 32
    against the port's eager loop (the kernel's plain version) on small
    exports: 8-LP PHOLD with loss, the 8-host mesh, the 10-host CoDel
    mesh inside its CoDel stretch, and the 8-LP PHOLD at the ring's
    caps (chip_smoke.py RING_CAPS): every state column, the outbox and
    the trace in canonical order, fires, lanes, micro-iterations, the
    run's scalars and the abort bits.
(b) Every abort case at each W: the outbox cut (AB_OUT), the trace cut,
    a full timer heap, a full CoDel ring and a full inbox row
    (AB_STRUCT): the eager loop's bits and rounds.
(c) The team settle against the insertion sort it replaces (kept here,
    in the shim, as the reference) on seeded random rows at each W:
    lengths 0, 1 and I - 1, equal times, equal sources, arrivals
    earlier and later than the whole remainder.
(d) One span at the kernel's W for these exports (32) against the JAX
    package's PholdSpanRunner from the same export.
(e) The wrapper's choice of W from the lane count (pick_team) at the
    cells' shapes on an H100.

tests/test_torch_phold_span_kernel.py and test_torch_phold_window.py
hold the same laws at W = 1; the kernel itself runs only on the card
(chip_smoke.py holds it at the chosen W and at W = 1 there).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from shadow_tpu_torch.ops import phold_span as ps
from shadow_tpu_torch.ops import phold_span_kernel as pk
from shadow_tpu_torch.ops import phold_window as pw
from shadow_tpu_torch.tools.window_cases import window_mismatch
import test_torch_phold_span_kernel as span_kernel_tests
from test_torch_phold_span_kernel import HostSpan, assert_same_span
from test_torch_phold_window import ABORTS, CASES, capture, fresh

TEAMS = (1, 2, 8, 32)
KERNEL_TEAM = 32  # pick_team's width for a few lanes
RING_CAPS = dict(CAP_I=32, CAP_T=16, CAP_R=64, CAP_S=64, CAP_C=256, CAP_P=16)

SHIM = r"""
#include <cstdint>
#include <cstring>
#include "phold_round_end.cuh"
namespace ph = stt::phold;
extern "C" const char* stt_phold_operands() { return ph::kOperands; }
extern "C" const char* stt_phold_params() { return ph::kParamNames; }
extern "C" const char* stt_phold_span_operands() { return ph::kSpanOperands; }
extern "C" const char* stt_phold_span_params() { return ph::kSpanParamNames; }
extern "C" const char* stt_phold_span_words() { return ph::kSpanWords; }
extern "C" const char* stt_phold_consts() { return ph::kConsts; }
extern "C" const char* stt_phold_stats() { return ph::kStats; }
extern "C" long long stt_phold_bitmap_words() { return ph::kBitmapWords; }
extern "C" const char* stt_phold_span_teams() { return "32 8 1"; }
extern "C" long long stt_phold_span_row_max() { return ph::kRowMax; }
extern "C" int stt_phold_span_grid(long long, int, long long* out) {
  out[0] = out[1] = 1;
  out[2] = 64;
  out[3] = 132;
  return 0;
}
static int g_team = 1;
extern "C" void stt_phold_set_team(int team) { g_team = team; }
extern "C" int stt_phold_window(const void* const* ptrs,
                                const long long* words, void*) {
  ph::Ops o;
  std::memcpy(&o, ptrs, sizeof o);
  ph::Params p;
  std::memcpy(&p, words, sizeof p);
  return ph::window_serial(o, p, g_team);
}
extern "C" int stt_phold_span(const void* const* ptrs, const long long* words,
                              int team, int, void*) {
  ph::SpanOps so;
  std::memcpy(&so, ptrs, sizeof so);
  ph::SpanParams sp;
  std::memcpy(&sp, words, sizeof sp);
  return ph::span_serial(so, sp, team,
                         [](int64_t k, int64_t) -> int64_t { return k; });
}

// One row (cols: time, src, seq, then the six packet columns, each of
// `cap` slots; rem entries, then `arrivals` appended) settled by a team
// of `team` ranks; returns the head time.
extern "C" long long stt_phold_settle(int team, long long** cols,
                                      long long cap, long long rem,
                                      long long arrivals) {
  ph::RoundOps r = {};
  int64_t len = rem, arr = arrivals;
  r.ib_len = &len;
  r.arrivals = &arr;
  r.ib_time = (int64_t*)cols[0];
  r.ib_src = (int64_t*)cols[1];
  r.ib_seq = (int64_t*)cols[2];
  for (int c = 0; c < ph::kPk; c++) r.ib[c] = (int64_t*)cols[3 + c];
  ph::Params p = {};
  p.cap_i = cap;
  static ph::SettleScratch x;
  return ph::settle_team(r, p, 0, team, x);
}

// The reference: the kernel's former settle, an insertion sort of
// [0, len) through the columns in place (every step's keys read again).
extern "C" long long stt_phold_settle_ref(long long** cols, long long cap,
                                          long long rem, long long arrivals) {
  int64_t len = rem + arrivals;
  len = len < cap - 1 ? len : cap - 1;
  len = len > rem ? len : rem;
  int64_t* const t = (int64_t*)cols[0];
  int64_t* const s = (int64_t*)cols[1];
  int64_t* const q = (int64_t*)cols[2];
  for (int64_t k = 1; k < len; k++) {
    const int64_t tk = t[k], sk = s[k], qk = q[k];
    int64_t m = k;
    while (m > 0 && ph::inbox_less(tk, sk, qk, t[m - 1], s[m - 1], q[m - 1]))
      m--;
    if (m == k) continue;
    for (int c = 0; c < 9; c++) {
      int64_t* const col = (int64_t*)cols[c];
      const int64_t v = col[k];
      for (int64_t x = k; x > m; x--) col[x] = col[x - 1];
      col[m] = v;
    }
  }
  return len > 0 ? t[0] : ph::I64_MAX;
}
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def team_lib(tmp_path_factory):
    """phold_round_end.cuh (with phold_lane.cuh) built for the host with
    a settable team, the window's and the span's entry points and the
    row settle alone."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("phold_team_host")
    (d / "shim.cpp").write_text(SHIM)
    csrc = os.path.join(os.path.dirname(ps.__file__), "..", "csrc")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    csrc, "-o", str(d / "libphold_team.so"),
                    str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libphold_team.so"))
    pw._declare(lib)
    pk._declare(lib)
    lib.stt_phold_set_team.argtypes = [ctypes.c_int]
    lib.stt_phold_set_team.restype = None
    lib.stt_phold_settle.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_longlong]
    lib.stt_phold_settle.restype = ctypes.c_longlong
    lib.stt_phold_settle_ref.argtypes = [ctypes.c_void_p,
                                         ctypes.c_longlong,
                                         ctypes.c_longlong,
                                         ctypes.c_longlong]
    lib.stt_phold_settle_ref.restype = ctypes.c_longlong
    return lib


EXPORTS = dict(CASES, ring_caps=(CASES["phold_lossy"][0], 3))


@pytest.fixture(scope="module")
def exports():
    return {name: capture(make(), nth,
                          RING_CAPS if name == "ring_caps" else None)
            for name, (make, nth) in EXPORTS.items()}


def _runner(runner, name):
    if name == "ring_caps":
        for k, v in RING_CAPS.items():
            setattr(runner, k, v)
    return runner


class TeamWindow:
    """The window step through the host build at team `team`."""

    def __init__(self, lib, team, shape, params):
        self.lib, self.team = lib, team
        self.table = pw.WindowTable(lib, shape, params)

    def begin(self, st, pay):
        self.table.begin(st, pay)

    def __call__(self, st, window_end):
        self.lib.stt_phold_set_team(self.team)
        assert self.lib.stt_phold_window(
            *self.table.fill(st, window_end), None) == 0

    def end(self):
        return dict(self.table.end(), windows=1, window_ms=0.0)


def _build(runner, window=None, span=None):
    runner.tracing = True
    runner.window_factory = window
    runner.span_factory = span
    return runner._build()


@pytest.mark.parametrize("case", list(EXPORTS))
def test_torch_phold_team_window_equals_eager(team_lib, exports, case):
    """One window at every W: the law's state, counts and iterations are
    the eager window's."""
    runner, st_np, (start, stop, _limit, runahead) = exports[case]
    runner = _runner(runner, case)
    we = min(start + runahead, stop)
    plain = _build(runner)
    a = fresh(runner, st_np)
    plain.prepare(a, runner._pay)
    it = plain.window_plain(a, we)
    assert it > 0
    for team in TEAMS:
        fn = _build(runner, window=lambda s, p, t=team: TeamWindow(
            team_lib, t, s, p))
        b = fresh(runner, st_np)
        fn.prepare(b, runner._pay)
        fn.step.begin(b, runner._pay)
        fn.step(b, we)
        got = fn.step.end()
        assert window_mismatch(a, b) == [], (team, window_mismatch(a, b))
        assert got["iters"] == it, team
        np.testing.assert_array_equal(got["fires"], a["ks_fires"])
        np.testing.assert_array_equal(got["lanes"], a["ks_lanes"])
        assert int(b["abort_code"]) == int(a["abort_code"]) == 0


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("case", list(EXPORTS))
def test_torch_phold_team_span_equals_eager(team_lib, exports, case,
                                            rounds):
    """Spans of one and four rounds at every W: every state column, the
    outbox and trace, fires, lanes and the run's scalars (rounds,
    packets, micro-iterations ...) are the eager loop's."""
    runner, st_np, (start, stop, limit, runahead) = exports[case]
    runner = _runner(runner, case)
    args = (start, stop, limit, runahead, rounds)
    want = _build(runner)(fresh(runner, st_np), runner._pay, *args)
    want = (want[0], list(want[1:]))
    assert int(want[0]["abort_code"]) == 0 and want[1][2] == rounds
    for team in TEAMS:
        fn = _build(runner, span=lambda s, p, t=team: HostSpan(
            team_lib, s, p, team=t))
        st, *rest = fn(fresh(runner, st_np), runner._pay, *args)
        assert_same_span(want, (st, rest))
        assert st["ks_spans"] == 1 and st["ks_windows"] == rounds


@pytest.mark.parametrize("cause", list(ABORTS))
def test_torch_phold_team_abort_bits_equal_eager(team_lib, cause):
    """Each single-cause overflow at every W: the eager loop's abort bits,
    and only them, in the same round; one window the same."""
    case, attrs, edit, bits = ABORTS[cause]
    make, nth = CASES[case]
    runner, st_np, (start, stop, limit, runahead) = capture(
        make(), nth, caps={k: v for k, v in attrs.items()
                           if k.startswith("CAP_")})
    for k, v in attrs.items():
        setattr(runner, k, v)
    if edit is not None:
        st_np = edit(runner, st_np)
    args = (start, stop, limit, runahead, 4)
    st, *rest = _build(runner)(fresh(runner, st_np), runner._pay, *args)
    want = (int(st["abort_code"]), rest[2])
    assert want[0] == bits
    for team in TEAMS:
        fn = _build(runner, span=lambda s, p, t=team: HostSpan(
            team_lib, s, p, team=t))
        st, *rest = fn(fresh(runner, st_np), runner._pay, *args)
        assert (int(st["abort_code"]), rest[2]) == want, (team, cause)


FILL = 1 << 62  # the inbox's fill of time and seq (I64_MAX)


def _row(rng, cap, rem, arrivals, kind):
    """Nine columns of one inbox row (time, src, seq, then the packet's
    six): a sorted remainder of `rem` entries, then `arrivals` appended
    entries, the rest the fill; `kind` shapes the keys."""
    n = rem + arrivals
    t = rng.integers(0, 50, n)
    s = rng.integers(0, 6, n)
    if kind == "equal_times":
        t[:] = 7
    elif kind == "equal_src":
        s[:] = 3
    elif kind == "arrivals_first":
        t[rem:] = rng.integers(-100, -50, arrivals)
    elif kind == "arrivals_last":
        t[rem:] = rng.integers(100, 150, arrivals)
    q = rng.permutation(10 * n + 1)[:n]
    keys = np.stack([t, s, q])
    keys[:, :rem] = keys[:, :rem][:, np.lexsort(keys[::-1, :rem])]
    cols = np.zeros((9, cap), dtype=np.int64)
    cols[0] = cols[2] = FILL
    cols[:3, :n] = keys
    cols[3:, :n] = rng.integers(0, 1 << 40, (6, n))
    cols[3, :n] = cols[1, :n]  # srchost is the source
    return cols


def _ptrs(cols):
    return (ctypes.c_void_p * 9)(*[c.ctypes.data for c in cols])


@pytest.mark.parametrize("team", TEAMS)
def test_torch_phold_team_settle_equals_insertion_sort(team_lib, team):
    """The team settle (each entry's slot by counting the keys below it,
    the columns moved through the scratch) against the kernel's former
    insertion sort on seeded random rows: every column of the row, the
    head time."""
    rng = np.random.default_rng(1234 + team)
    cap = 64
    shapes = [(0, 0), (1, 0), (0, 1), (1, 1), (0, cap - 1), (cap - 1, 0),
              (cap - 2, 1), (20, 20), (5, 58), (40, 30)]
    kinds = ("random", "equal_times", "equal_src", "arrivals_first",
             "arrivals_last")
    seen = 0
    for rem, arr in shapes:
        for kind in kinds:
            for _ in range(3):
                # An arrival count past the row's last slot: the appends
                # past I - 1 wrote nothing, the settle clamps its length.
                cols = _row(rng, cap, rem, min(arr, cap - 1 - rem), kind)
                want = cols.copy()
                h0 = team_lib.stt_phold_settle_ref(_ptrs(want), cap, rem,
                                                   arr)
                h1 = team_lib.stt_phold_settle(team, _ptrs(cols), cap, rem,
                                               arr)
                assert h0 == h1, (rem, arr, kind)
                np.testing.assert_array_equal(cols, want,
                                              err_msg=f"{rem} {arr} {kind}")
                seen += rem + arr > 1
    assert seen > 100


@pytest.mark.parametrize("which", ["phold", "mesh"])
def test_torch_phold_team_span_equals_jax_runner(team_lib, which,
                                                 monkeypatch):
    """One span of the JAX PholdSpanRunner and of the port through the
    host build at the kernel's W for a few lanes (32), from the same
    export: scalars, columns, stage counters and the canonical trace."""
    monkeypatch.setattr(
        span_kernel_tests, "host_span", lambda lib, seed=0, team=1: (
            lambda s, p: HostSpan(lib, s, p, seed, KERNEL_TEAM)))
    span_kernel_tests.test_torch_phold_span_host_build_equals_jax_runner(
        team_lib, which)


# Each width's (blocks needed, blocks held) on an H100 (132 SMs, 8 blocks
# an SM of 64 threads), for n lanes.
def _h100(n):
    return {w: (-(-n * w // 64), 1056) for w in (32, 8, 1)}


@pytest.mark.parametrize("n, cap_i, want", [
    (10, 64, (32, 5)),          # mesh-codel-10
    (24, 64, (32, 12)),         # mesh-24
    (132, 64, (32, 66)),        # a warp an SM at 32
    (133, 64, (8, 17)),         # past it: 8 fit
    (528, 64, (8, 66)),
    (529, 64, (1, 9)),          # past a warp an SM at 8
    (8192, 64, (1, 128)),       # phold-8k
    (65536, 32, (1, 1024)),     # phold-64k-ring
    (100_000, 32, (1, 1056)),   # more lanes than threads: grid-stride
    (24, 128, (1, 1)),          # an inbox past the settle's scratch
])
def test_torch_phold_team_width_from_lane_count(n, cap_i, want):
    assert pk.pick_team(n, _h100(n), 132, cap_i, 64) == want
