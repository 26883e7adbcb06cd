"""The TCP span kernel (csrc/tcp_span.cu `stt_tcp_span`) built for the
host: its round-end laws (csrc/tcp_round_end.cuh) and window lane law
(csrc/tcp_lane.cuh) compiled with the system C++ compiler, the kernel's
phases run in turn over every lane, packet and row (`span_serial`)
through the kernel's own operand table (ops/tcp_span_kernel.py
TcpSpanTable), held exactly (integer laws, tolerance 0) against the
port's eager loop (its plain version) and against the JAX package.

1. The round end alone against the eager `round_end`, on numpy-seeded
   outboxes over the 16-host stream's export (rows part consumed, a
   4-node graph with unreachable pairs and 2% loss, pure acks, packets
   sent before bootstrap_end): every state column, the trace in
   canonical order and the round's scalars, in order and in shuffled
   orders; a trace near its cap (AB_TRACE) likewise; a row that
   overflows gives the eager bits and site (AB_STRUCT 14).
2. Whole spans of one and of eight rounds, host build vs the eager
   run: every state column, the outbox and trace in canonical order,
   the run's scalars, `ks_fires` and `ks_lanes`; lossless and at 2%
   loss, traced and untraced, and the wide-rows edit.  One span step a
   run, its words read once.  The tile's ranks (32, the kernel's, and
   1) and the outbox's order change nothing.
3. One span through the host build equals the JAX TcpSpanRunner's span
   from the same export (the reference `run` on the CPU, at the
   reference's ring caps of 256).
4. One case per abort cause, the eager loop's bits and site.
5. The operand table covers the loop; the wrapper refuses CPU tensors
   and the CPU runner builds no span step; the span's byte bound counts
   what it must move.
6. The forced 16-host 2%-loss stream with every span stepped by the
   host build: the JAX package's serial run's trace, events and drops.

The kernel itself runs only on the card (chip_smoke.py holds it against
the eager loop there); what is checked here is its phases' code, its
operand table and the words and counts it reports, built from the same
headers.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import Manager as JManager
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu.ops.tcp_span import TcpSpanRunner as JRunner
from shadow_tpu_torch.core.simtime import TIME_NEVER
from shadow_tpu_torch.ops import tcp_span as ts
from shadow_tpu_torch.ops import tcp_span_kernel as tsk
from shadow_tpu_torch.ops import tcp_window as tw
from shadow_tpu_torch.ops.span_mesh import AB_STRUCT, AB_TRACE
from shadow_tpu_torch.ops.tcp_span import (TcpSpanRunner, state_from_numpy,
                                           state_to_numpy)
from shadow_tpu_torch.tools.relay_cases import clone_state
from shadow_tpu_torch.tools.window_cases import (TCP_TR_KEYS, canon,
                                                 tcp_device_state,
                                                 tcp_wide_rows,
                                                 tcp_window_mismatch)
from test_torch_tcp_window import ABORTS, capture, port_manager, stream

SHIM = r"""
#include <cstdint>
#include <cstring>
#include "tcp_round_end.cuh"
namespace tc = stt::tcp;
extern "C" const char* stt_tcp_span_operands() { return tc::kSpanOperands; }
extern "C" const char* stt_tcp_span_params() { return tc::kSpanParamNames; }
extern "C" const char* stt_tcp_span_words() { return tc::kSpanWords; }
extern "C" const char* stt_tcp_span_consts() { return tc::kSpanConsts; }
extern "C" const char* stt_tcp_span_stats() { return tc::kStats; }
extern "C" long long stt_tcp_span_bitmap_words() { return tc::kBitmapWords; }
extern "C" int stt_tcp_span_grid(long long) { return 1; }
extern "C" const char* stt_tcp_span_error_string(int) { return "host"; }

// The tile's ranks (run in turn): the kernel's 32 unless set.
static int g_team = tc::kTeam;
extern "C" void stt_tcp_span_team(int team) { g_team = team; }

// Outbox position k of n: in order for `seed` 0, else a permutation
// drawn from it (a 64-bit LCG driving a Fisher-Yates shuffle), redrawn
// each round.
struct Order {
  int seed;
  int64_t* perm = nullptr;
  int64_t made = -1;
  uint64_t x;
  explicit Order(int s) : seed(s), x((uint64_t)s) {}
  ~Order() { delete[] perm; }
  int64_t operator()(int64_t k, int64_t n) {
    if (seed == 0) return k;
    if (made != n || k == 0) {
      delete[] perm;
      perm = new int64_t[n > 0 ? n : 1];
      for (int64_t j = 0; j < n; j++) perm[j] = j;
      for (int64_t j = n - 1; j > 0; j--) {
        x = x * 6364136223846793005ull + 1442695040888963407ull;
        const int64_t m = (int64_t)((x >> 33) % (uint64_t)(j + 1));
        const int64_t t = perm[j];
        perm[j] = perm[m];
        perm[m] = t;
      }
      made = n;
    }
    return perm[k];
  }
};

extern "C" int stt_tcp_span(const void* const* ptrs, const long long* words,
                            int seed, void*) {
  tc::SpanOps so;
  std::memcpy(&so, ptrs, sizeof so);
  tc::SpanParams sp;
  std::memcpy(&sp, words, sizeof sp);
  Order order(seed);
  return tc::span_serial(so, sp, g_team,
                         [&](int64_t k, int64_t n) { return order(k, n); });
}

// The round end alone after a window the caller ran, as the kernel's
// phases do it in a launch's first round: the fills beyond each row's
// length, each row compacted (its timer-heap least by a scan of the
// row), every outbox packet, the round closed, every row settled; the
// round's words in slot 0.
extern "C" int stt_tcp_round_end(const void* const* ptrs,
                                 const long long* words,
                                 long long window_end, int seed) {
  tc::SpanOps so;
  std::memcpy(&so, ptrs, sizeof so);
  tc::SpanParams sp;
  std::memcpy(&sp, words, sizeof sp);
  const tc::Ops& o = so.w;
  const tc::RoundOps& r = so.r;
  const tc::Params& p = sp.w;
  for (int64_t x = 0; x < p.n * p.cap_i; x++) tc::fill_rows(r, p, x);
  for (int64_t i = 0; i < p.n; i++) {
    int64_t least = tc::I64_MAX;
    for (int64_t k = 0; k < p.cap_t; k++)
      if (o.th_valid[i * p.cap_t + k] && o.th_time[i * p.cap_t + k] < least)
        least = o.th_time[i * p.cap_t + k];
    r.timer[i] = least;
    const int64_t pos = o.ib_pos[i], len = r.ib_len[i];
    for (int rank = 0; rank < g_team; rank++)
      tc::compact_cols(r, p, i, pos, len, rank, g_team);
    tc::compact_done(o, r, i, pos, len);
  }
  r.words[tc::SW_NEXT] = tc::I64_MAX;
  r.words[tc::SW_MIN_LAT] = tc::I64_MAX;
  r.words[tc::SW_OVER] = 0;
  Order order(seed);
  const int64_t n = *o.out_n < p.cap_out ? *o.out_n : p.cap_out;
  for (int64_t k = 0; k < n; k++) {
    const int64_t lat =
        tc::round_packet(o, r, p, sp.r, window_end, order(k, n));
    STT_MIN(&r.words[tc::SW_MIN_LAT], lat);
  }
  tc::close_round(o, r, p, 0);
  tc::SettleScratch* x = new tc::SettleScratch;
  for (int64_t i = 0; i < p.n; i++)
    STT_MIN(&r.words[tc::SW_NEXT], tc::settle_row(r, p, i, g_team, *x));
  delete x;
  return 0;
}
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The eager loop runs thousands of small ops: one intra-op thread
    keeps the test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def span_lib(tmp_path_factory):
    """tcp_round_end.cuh (with tcp_lane.cuh) built for the host with the
    system C++ compiler, with the name functions the kernel's library
    exports."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("tcp_span_host")
    (d / "shim.cpp").write_text(SHIM)
    csrc = os.path.join(os.path.dirname(ts.__file__), "..", "csrc")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    csrc, "-o", str(d / "libtcp_span.so"),
                    str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libtcp_span.so"))
    tsk._declare(lib)
    lib.stt_tcp_span_team.argtypes = [ctypes.c_int]
    lib.stt_tcp_round_end.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_longlong, ctypes.c_int]
    lib.stt_tcp_round_end.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def exports():
    return {"lossless": capture(0.0), "lossy": capture(0.02)}


class HostSpan:
    """The span step of a span build through the host build: the operand
    table filled by the kernel's own names (tsk.TcpSpanTable, as the
    wrapper fills it on the card), the phases run in turn, the block
    read once."""

    def __init__(self, lib, shape, params, seed=0, team=32):
        self.lib = lib
        self.table = tsk.TcpSpanTable(lib, shape, params)
        self.seed, self.team = seed, team
        self.calls = 0

    def __call__(self, st, start, stop, limit, runahead, max_rounds):
        self.table.begin(st)
        table, words = self.table.fill(st, start=start, stop=stop,
                                       limit=limit, runahead=runahead,
                                       max_rounds=max_rounds)
        self.lib.stt_tcp_span_team(self.team)
        assert self.lib.stt_tcp_span(table, words, self.seed, None) == 0
        self.calls += 1
        return dict(self.table.read(), span_ms=0.0)


def host_span(lib, seed=0, team=32):
    return lambda shape, params: HostSpan(lib, shape, params, seed, team)


def build(runner, lib=None, tracing=True, seed=0, team=32):
    """The runner's loop: eager (lib None) or through the host build."""
    runner.tracing = tracing
    runner.window_factory = tw.eager_window if lib is None else None
    runner.span_factory = None if lib is None else host_span(lib, seed,
                                                             team)
    return runner._build()


def both(runner, st_np, args, lib, tracing=True, seed=0, team=32):
    """The same span eager and through the host build: ((eager state,
    scalars), (host state, scalars), the host step)."""
    outs = []
    for which in (None, lib):
        fn = build(runner, which, tracing, seed, team)
        st, *rest = fn(tcp_device_state(runner, st_np), *args)
        outs.append((st, rest))
    runner.span_factory = runner.window_factory = None
    return outs[0], outs[1], fn.span


def assert_same_span(a, b):
    (sa, ra), (sb, rb) = a, b
    assert ra == rb, (ra, rb)
    assert tcp_window_mismatch(sa, sb) == []
    for k in ("ks_fires", "ks_lanes"):
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


# ------------------------------------------------- 1. the round end alone

V = 4  # the test graph's nodes
LOSS_2PCT = int(0.02 * (1 << 32))


def seeded_round(runner, st_np, seed, n_out=600, hot=None, trace_gap=None):
    """The export made a round end's input, from numpy draws: each row
    part consumed (ib_pos), a 4-node graph (host -> node at random,
    latencies 1-9 ms, two unreachable pairs, every edge at 2% loss), and
    `n_out` outbox packets with unique (src, seq): a third pure acks,
    send times on both sides of bootstrap_end, the other columns drawn.
    `hot`: that many more packets to host 5 (its row overflows at
    I - 1).  `trace_gap`: the trace starts that many lines under its cap
    less the outbox (TR - O).  Returns (state, window end)."""
    rng = np.random.default_rng(seed)
    st = tcp_device_state(runner, st_np)
    build(runner).prepare(st)
    H, I = st["ib_time"].shape
    st["ib_pos"] = torch.from_numpy(
        rng.integers(0, st["ib_len"].numpy() + 1)).to(torch.int64)
    lat = rng.integers(1_000_000, 10_000_000, (V, V))
    lat[0, 3] = lat[2, 1] = TIME_NEVER
    st["_lat"] = torch.from_numpy(lat).to(torch.int64)
    st["_thr"] = torch.full((V, V), LOSS_2PCT, dtype=torch.int64)
    st["_node"] = torch.from_numpy(rng.integers(0, V, H)).to(torch.int64)
    now = int(st["now"].max())
    window_end = now + 10_000_000
    src = rng.integers(0, H, n_out)
    dst = (src + rng.integers(1, H, n_out)) % H
    if hot:
        src = np.concatenate([src, np.arange(hot) % H])
        dst = np.concatenate([dst, np.full(hot, 5)])
        src = np.where(src == 5, 6, src)
    n = len(src)
    cols = {"src": src, "dst": dst,
            "seq": (1 << 40) + np.arange(n),
            "t": rng.integers(runner.bootstrap_end - 5_000_000,
                              window_end, n)}
    for k in ts.PK_KEYS:
        cols[k] = rng.integers(0, 1 << 31, n)
    cols["srchost"] = src
    cols["pseq"] = rng.integers(0, 1 << 33, n)
    cols["plen"] = np.where(rng.random(n) < 1 / 3, 0, 1460)
    for k, v in cols.items():
        st[f"out_{k}"][:n] = torch.from_numpy(v).to(torch.int64)
    st["out_n"] = torch.tensor(n, dtype=torch.int64)
    if trace_gap is not None:
        st["tr_n"] = torch.tensor(runner.cap_tr - runner.cap_out
                                  - trace_gap, dtype=torch.int64)
    return st, window_end


def host_round_end(lib, runner, st, window_end, seed=0):
    """The round end through the host build, on `st` in place: (packets,
    least kept latency, next start, abort word), as the eager round end
    returns them."""
    shape, params = runner._span_shape()
    shape["v"] = params["n_nodes"] = V
    table = tsk.TcpSpanTable(lib, shape, params)
    table.begin(st)
    ptrs, words = table.fill(st, start=0, stop=0, limit=0, runahead=0,
                             max_rounds=0)
    lib.stt_tcp_span_team(32)
    assert lib.stt_tcp_round_end(ptrs, words, window_end, seed) == 0
    w, lay = table.span_words, table.span_layout
    return [int(w[lay[k]]) for k in ("SW_OUT_N", "SW_MIN_LAT", "SW_NEXT",
                                     "SW_CODE")]


@pytest.fixture()
def boot(exports):
    """The lossy export's runner with bootstrap_end inside the outbox's
    send times (restored after the test)."""
    runner, st_np, args = exports["lossy"]
    saved = runner.bootstrap_end
    runner.bootstrap_end = int(st_np["now"].max()) + 2_000_000
    yield runner, st_np
    runner.bootstrap_end = saved


@pytest.mark.parametrize("trace_gap", [None, 4], ids=["room", "near_cap"])
def test_torch_tcp_round_end_equals_eager(span_lib, boot, trace_gap):
    """Seeded outboxes through the host build's round end (in order and
    in two shuffled orders) and the eager one: the same state, trace in
    canonical order and scalars.  The cases are live: drops of both
    causes, pure acks and packets before bootstrap_end kept on lossy
    edges, several rows merged, and near the trace cap AB_TRACE."""
    runner, st_np = boot
    for seed in (3, 4):
        a, we = seeded_round(runner, st_np, seed, trace_gap=trace_gap)
        before = clone_state(a)
        want = build(runner).round_end(a, we)
        for order in (0, 1, 77):
            b, _ = seeded_round(runner, st_np, seed, trace_gap=trace_gap)
            got = host_round_end(span_lib, runner, b, we, order)
            assert got == want, (order, got, want)
            assert tcp_window_mismatch(a, b) == []
        dc = (a["drop_causes"] - before["drop_causes"]).sum(0)
        assert dc[ts.TEL_UNREACHABLE] > 0 and dc[ts.TEL_LOSS_EDGE] > 0
        assert want[0] > 500 and want[3] == (0 if trace_gap is None
                                             else AB_TRACE)
        assert int((a["ib_len"] > before["ib_len"]
                    - before["ib_pos"]).sum()) > 8
    # The loss rule's exemptions decided some packets here: a pure ack
    # or a packet sent before bootstrap_end on a lossy draw was kept.
    n = int(before["out_n"])
    src = before["out_src"][:n]
    bits = ts.threefry2x32_torch(
        torch.tensor(runner._k[0]), torch.tensor(runner._k[1]), src,
        before["out_pseq"][:n] & ts.M32)[0]
    drawn = bits < LOSS_2PCT
    assert (drawn & (before["out_plen"][:n] == 0)).any()
    assert (drawn & (before["out_t"][:n] < runner.bootstrap_end)).any()


def test_torch_tcp_round_end_row_overflow_equals_eager(span_lib, boot):
    """A row that fills to I - 1: the eager bits and site (AB_STRUCT,
    14), nothing written past the row."""
    runner, st_np = boot
    I = runner.CAP_I
    a, we = seeded_round(runner, st_np, 5, hot=2 * I)
    want = build(runner).round_end(a, we)
    b, _ = seeded_round(runner, st_np, 5, hot=2 * I)
    got = host_round_end(span_lib, runner, b, we, 9)
    assert want[3] == got[3] == AB_STRUCT
    assert int(a["abort_site"]) == int(b["abort_site"]) == 14
    assert int(b["ib_len"][5]) == I - 1


# ------------------------------------------------- 2. whole spans

@pytest.mark.parametrize("rounds", [1, 8])
@pytest.mark.parametrize("case", ["lossless", "lossy"])
def test_torch_tcp_span_host_build_equals_eager_run(span_lib, exports, case,
                                                    rounds):
    runner, st_np, (start, stop, limit, runahead) = exports[case]
    a, b, step = both(runner, st_np, (start, stop, limit, runahead, rounds),
                      span_lib)
    assert_same_span(a, b)
    (sa, ra), (sb, _rb) = a, b
    assert int(sa["abort_code"]) == 0
    assert ra[2] == rounds and ra[-1] > 0  # rounds, micro-iterations
    # One span step, its words read once, whatever the rounds.
    assert step.calls == 1
    assert sb["ks_spans"] == 1 and sb["ks_windows"] == rounds
    assert int(sb["tr_n"]) > 0


def test_torch_tcp_span_untraced_and_wide_rows_equal_eager(span_lib,
                                                           exports):
    """Untraced, and the wide-rows edit (a 298-entry reassembly row in
    three SACK runs, a 480-entry rtx ring, 3,000 stale heap entries)
    over four rounds: the eager run's state and scalars."""
    runner, st_np, (start, stop, limit, runahead) = exports["lossy"]
    args = (start, stop, limit, runahead, 4)
    assert_same_span(*both(runner, st_np, args, span_lib, tracing=False)[:2])
    a, b, _ = both(runner, tcp_wide_rows(st_np), args, span_lib)
    assert_same_span(a, b)
    assert a[1][2] == 4 and int(a[0]["abort_code"]) == 0


def test_torch_tcp_span_ranks_and_order_change_nothing(span_lib, exports):
    """The round end visiting each round's outbox in shuffled orders (as
    the kernel's atomic appends may), and a tile of one rank: the same
    state as the eager loop's."""
    runner, st_np, (start, stop, limit, runahead) = exports["lossy"]
    args = (start, stop, limit, runahead, 6)
    a, b, _ = both(runner, st_np, args, span_lib)
    assert_same_span(a, b)
    for seed, team in ((1, 32), (77, 32), (0, 1)):
        fn = build(runner, span_lib, seed=seed, team=team)
        st, *rest = fn(tcp_device_state(runner, st_np), *args)
        assert_same_span(a, (st, rest))
    assert a[1][4] > 1  # packets: the rounds' outboxes held several


# ------------------------------------------------- 3. against JAX

def test_torch_tcp_span_host_build_equals_jax_runner(span_lib):
    """One span of the JAX TcpSpanRunner (its jitted `run` on the CPU)
    and of the port through the host build, from the same export of the
    16-host 2%-loss stream to 500 ms at the reference's ring caps: the
    run's scalars, every output column, the per-stage counters and the
    trace in canonical order."""
    jm = JManager(JConfig.from_yaml_text(stream("tpu", 0.02, "force")))
    jcaps = (JRunner.CAP_I, JRunner.CAP_T, JRunner.CAP_CQ, JRunner.CAP_RT,
             JRunner.CAP_RA, JRunner.CAP_OP)

    class Capture:
        ineligible = 0
        last_transient = last_was_cold = False
        got = None

        def try_span(self, start, stop, limit, runahead, dynamic,
                     max_rounds, spec_mr=0):
            d = jm.plane.engine.span_export_tcp(*jcaps)
            self.last_transient = isinstance(d, int)
            if isinstance(d, dict) and self.got is None:
                self.got = (d, start, stop, limit, runahead)
            return None

    class NotPhold:
        ineligible = 1

    cap = Capture()
    jm._dev_span, jm._dev_span_tcp = NotPhold(), cap
    jm.run()
    assert cap.got is not None, "never reached the device-span domain"
    d, start, stop, limit, runahead = cap.got
    jr = jm.make_tcp_span_runner()
    st_np = jr._to_arrays(d)
    n_conns = st_np.pop("_n_conns")
    args = (start, stop, limit, runahead, 8)
    jr.kern = True  # build with the kernel observatory's stage counters
    out = jr._build()(dict(st_np), jr._lat, jr._thr, jr._node,
                      jr._ips_sorted, jr._ips_perm, np.uint32(jr._k[0]),
                      np.uint32(jr._k[1]), np.int64(jr.bootstrap_end),
                      *args)
    jst, *jrest = out
    assert int(jst["abort_code"]) == 0 and int(jrest[2]) > 1

    pr = TcpSpanRunner(jm.plane.engine, jr._lat, jr._thr, jr._node,
                       np.ascontiguousarray([h.ip for h in jm.hosts],
                                            dtype=np.uint32),
                       jm.config.general.seed,
                       jm.config.general.bootstrap_end_time_ns,
                       tracing=True, device="cpu", ring_cap=JRunner.CAP_RT)
    pr._CC = jr._CC
    assert pr._caps() == jr._caps()
    pr.span_factory = host_span(span_lib)
    st = state_from_numpy(dict(st_np, _n_conns=n_conns), "cpu")
    st.pop("_n_conns")
    st.update(pr._statics_on_device())
    pst, *prest = pr._build()(st, *args)
    assert pst["ks_spans"] == 1
    assert tuple(prest[:6]) == tuple(int(v) for v in jrest[:6])
    np.testing.assert_array_equal(pst["ks_fires"],
                                  np.asarray(jst["ks_fires"]))
    np.testing.assert_array_equal(pst["ks_lanes"],
                                  np.asarray(jst["ks_lanes"]))
    p_np = state_to_numpy(pst, keys=[k for k in jst
                                     if k in pst["_np_dtypes"]])
    for k, v in jst.items():
        if k in p_np:
            np.testing.assert_array_equal(np.asarray(v), p_np[k],
                                          err_msg=k)
    jtr = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
           for k, v in jst.items() if k.startswith("tr_")}
    np.testing.assert_array_equal(canon(jtr, "tr_", TCP_TR_KEYS, "tr_n"),
                                  canon(pst, "tr_", TCP_TR_KEYS, "tr_n"))


# ------------------------------------------------- 4. the aborts

@pytest.mark.parametrize("cause", list(ABORTS))
def test_torch_tcp_span_abort_bits_equal_eager(span_lib, exports, cause):
    """Each single-cause abort: the span through the host build ends with
    the eager loop's abort bits and site, in the same round.  The state
    is not compared: a rollback throws an aborted span's state away."""
    case, caps, attrs, edit, bits, site = ABORTS[cause]
    if caps is None:
        runner, st_np, (start, stop, limit, runahead) = exports[case]
    else:
        runner, st_np, (start, stop, limit, runahead) = capture(
            0.02 if case == "lossy" else 0.0, caps)
    saved = {k: getattr(runner, k) for k in attrs}
    try:
        for k, v in attrs.items():
            setattr(runner, k, v)
        if edit is not None:
            st_np = edit(st_np)
        got = []
        for lib in (None, span_lib):
            out = build(runner, lib)(tcp_device_state(runner, st_np), start,
                                     stop, limit, runahead, 3)
            got.append((int(out[0]["abort_code"]),
                        int(out[0]["abort_site"]), out[3]))
    finally:
        for k, v in saved.items():
            setattr(runner, k, v)
        runner.span_factory = runner.window_factory = None
    assert got[0] == got[1] and got[0][:2] == (bits, site), got


# ------------------------------------------------- 5. table, wrapper, bound

def test_torch_tcp_span_operand_table_covers_the_loop(span_lib, exports):
    """Every operand the span table names is a span-state column (or a
    buffer of the table), every written one CARRIED, DERIVED or
    span-local, and every column the eager loop changes over a span is a
    written operand; the loop's constants are the kernel's."""
    runner, st_np, (start, stop, limit, runahead) = exports["lossy"]
    ops = tsk.TcpSpanTable(span_lib, *runner._span_shape()).ops
    written = {o.key for o in ops if o.written}
    span_local = ("out_", "tr_", "abort_")
    for o in ops:
        if o.key.startswith(("win.", "span.")):
            continue
        if o.written and not o.key.startswith(span_local):
            assert o.key in (ts.RESIDENT_CARRIED | ts.RESIDENT_DERIVED), \
                o.key
    fn = build(runner)
    st = tcp_device_state(runner, st_np)
    fn.prepare(st)
    before = clone_state(st)
    fn(st, start, stop, limit, runahead, 4)
    # (The eager loop's scribbles on the conn-major trash row are left
    # out: nothing reads that row.)
    changed = {k for k, v in before.items()
               if isinstance(v, torch.Tensor) and not k.startswith("_")
               and not torch.equal(*((v[:-1], st[k][:-1])
                                     if ts._is_conn_major(k)
                                     else (v, st[k])))}
    assert changed and changed <= written, changed - written
    runner.window_factory = None


def test_torch_tcp_span_wrapper_refuses_cpu_tensors(exports):
    """On the CPU the runner builds no span step (the eager loop runs),
    and the wrapper refuses CPU tensors rather than run anything."""
    runner, st_np, _args = exports["lossless"]
    runner.span_factory = runner.window_factory = None
    fn = runner._build()
    assert fn.span is None and fn.step is None
    with pytest.raises(ValueError, match="CUDA"):
        tsk.TcpSpan().bind(*runner._span_shape()).begin(
            tcp_device_state(runner, st_np))


def test_torch_tcp_span_bound_counts_what_it_moves(span_lib, exports):
    """The span's byte bound from the eager loop and the span kernel's
    operand table: each round end's outbox reads exact (a kept packet's
    25 columns, a traced lost one's 10), the parts summed, each changed
    word charged once (less than per round), and the loop left as the
    eager run leaves it."""
    runner, st_np, (start, stop, limit, runahead) = exports["lossy"]
    ops = tsk.TcpSpanTable(span_lib, *runner._span_shape()).ops
    fn = build(runner)
    st = tcp_device_state(runner, st_np)
    need = tsk.tcp_span_need_bytes(fn, ops, st, start, stop, limit,
                                   runahead, 6)
    assert need["rounds"] == 6 and int(st["abort_code"]) == 0
    assert need["total"] == need["window"] + need["round_end"] \
        + need["state"] > 0
    ref = tcp_device_state(runner, st_np)
    want, *scalars = fn(ref, start, stop, limit, runahead, 6)
    assert tuple(scalars) == need["run"]
    assert tcp_window_mismatch(want, st) == []
    # One round end, part by part.
    st = tcp_device_state(runner, st_np)
    fn.prepare(st)
    we = min(start + runahead, stop)
    fn.window_plain(st, we)
    mid = clone_state(st)
    n_out = int(st["out_n"])
    fn.round_end(st, we)
    part = tsk.round_end_need_bytes(mid, st, n_out)
    lost = int((st["pkts_dropped"] - mid["pkts_dropped"]).sum())
    assert part["outbox"] == 200 * (n_out - lost) + 80 * lost
    assert part["arrivals"] == 192 * int(
        (st["ib_len"] - (mid["ib_len"] - mid["ib_pos"])).sum()) > 0
    assert part["total"] == sum(v for k, v in part.items() if k != "total")
    first = clone_state(st)
    assert tsk.span_state_bytes(ops, first, st) == 0
    runner.window_factory = None


# ------------------------------------------------- 6. the simulation

def test_torch_tcp_span_sim_matches_serial(span_lib):
    """The forced 16-host 2%-loss stream on the CPU with every span
    stepped by the host build: the JAX package's serial run's trace,
    events and drops, no abort, most rounds on the device, one span step
    a dispatch and no eager round end."""
    m_ser, s_ser = jrun(JConfig.from_yaml_text(stream("serial", 0.02)))
    mgr = port_manager(0.02)
    r = mgr._dev_span_tcp = mgr.make_tcp_span_runner()
    r.span_factory = host_span(span_lib)
    s_dev = mgr.run()
    assert s_ser.ok and s_dev.ok
    assert r.spans > 0 and r.aborts == 0, r.abort_kind_counts()
    assert r.rounds * 2 >= s_dev.rounds
    assert r.ks_spans == r.spans and r.spans_all >= r.ks_spans
    assert r.ks_windows == r.rounds and r.eager_round_ends == 0
    assert r.micro_iters > 0 and r.ks_calls[0] > 0
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert s_ser.events == s_dev.events
    assert s_ser.packets_dropped == s_dev.packets_dropped > 0
