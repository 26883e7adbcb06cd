"""The PHOLD/udp-mesh span kernel (csrc/phold_span.cu `stt_phold_span`)
built for the host: its round-end laws (csrc/phold_round_end.cuh) and
window lane law (csrc/phold_lane.cuh) compiled with the system C++
compiler, the kernel's phases run in turn over every lane and packet
(`span_serial`) through the kernel's own operand table
(ops/phold_span_kernel.py SpanTable), held exactly against the port's
eager loop (its plain version) and against the JAX package.

1. Whole spans of one and of six rounds from the same export, host
   build vs the eager run: every state column, the outbox and the trace
   in canonical order, the run's scalars (start, runahead, rounds, busy
   rounds, packets, busy end, micro-iterations), `ks_fires` and
   `ks_lanes`; 8-LP PHOLD with loss, the 8-host mesh and the
   CoDel-active mesh, traced and untraced.  One span step a run: the
   span's words are read once, whatever its rounds.
2. One span through the host build equals the JAX PholdSpanRunner's
   span from the same export (the reference `run` on the CPU).
3. The atomic-order argument: the round end visiting the outbox in a
   shuffled order gives the same state.
4. One case per abort cause (outbox, trace, timer heap, CoDel ring,
   inbox merge), each giving the eager loop's bits and rounds.  An
   aborted span's state is thrown away (every capacity abort re-exports,
   a structural one hands the rounds to the engine), so only the bits
   and the round count are compared.
5. The operand table covers every column the eager loop writes.
6. Forced PHOLD / mesh / CoDel simulations with the runner's span step
   swapped for the host build: traces, histograms, stdout and counters
   equal to the JAX package's serial run.
7. Latencies shorter than the runahead (zero, and half of it): the
   arrivals clamped to the window's end and the runahead's update, as
   the eager loop does them.
8. The wrapper refuses CPU tensors, and the CPU runner builds no span
   step; the span's byte bound counts what it must move, part by part,
   each changed word once.

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
from shadow_tpu.ops.phold_span import PholdSpanRunner as JRunner
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import Manager
from shadow_tpu_torch.ops import phold_span as ps
from shadow_tpu_torch.ops import phold_span_kernel as pk
from shadow_tpu_torch.ops.phold_span import (TR_KEYS, PholdSpanRunner,
                                             state_from_numpy)
from shadow_tpu_torch.tools.relay_cases import clone_state
from shadow_tpu_torch.tools.window_cases import canon, window_mismatch
from test_torch_phold_span import mesh_yaml, phold_yaml
from test_torch_phold_window import (ABORTS, CASES, SIMS, _counters, _hist,
                                     _stdout, capture, exports, fresh)

SHIM = r"""
#include <cstdint>
#include <cstring>
#include "phold_round_end.cuh"
namespace ph = stt::phold;
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
// A team of `team` ranks run in turn; `seed` 0 visits each round's
// outbox in order, else in a permutation drawn from it (a 64-bit LCG
// driving a Fisher-Yates shuffle).
extern "C" int stt_phold_span(const void* const* ptrs, const long long* words,
                              int team, int seed, void*) {
  ph::SpanOps so;
  std::memcpy(&so, ptrs, sizeof so);
  ph::SpanParams sp;
  std::memcpy(&sp, words, sizeof sp);
  int64_t* perm = nullptr;
  int64_t made = -1;
  uint64_t x = (uint64_t)seed;
  const int err = ph::span_serial(so, sp, team, [&](int64_t k,
                                                     int64_t n) -> int64_t {
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
  });
  delete[] perm;
  return err;
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
    """phold_round_end.cuh (with phold_lane.cuh) built for the host with
    the system C++ compiler, with the name functions the kernel's library
    exports."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("phold_span_host")
    (d / "shim.cpp").write_text(SHIM)
    csrc = os.path.join(os.path.dirname(ps.__file__), "..", "csrc")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    csrc, "-o", str(d / "libphold_span.so"),
                    str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libphold_span.so"))
    pk._declare(lib)
    return lib


class HostSpan:
    """The span step of a span build through the host build: the operand
    table filled by the kernel's own names (pk.SpanTable, as the wrapper
    fills it on the card), the phases run in turn, the block read once."""

    def __init__(self, lib, shape, params, seed=0, team=1):
        self.lib = lib
        self.table = pk.SpanTable(lib, shape, params)
        self.seed = seed
        self.team = team
        self.calls = 0

    def __call__(self, st, pay, start, stop, limit, runahead, max_rounds):
        self.table.begin(st, pay)
        table, words = self.table.fill(st, start=start, stop=stop,
                                       limit=limit, runahead=runahead,
                                       max_rounds=max_rounds)
        assert self.lib.stt_phold_span(table, words, self.team, self.seed,
                                       None) == 0
        self.calls += 1
        return dict(self.table.read(), span_ms=0.0)


def host_span(lib, seed=0, team=1):
    return lambda shape, params: HostSpan(lib, shape, params, seed, team)


def build(runner, lib=None, tracing=True, seed=0):
    """The runner's loop: eager (lib None) or through the host build."""
    runner.tracing = tracing
    runner.window_factory = None
    runner.span_factory = None if lib is None else host_span(lib, seed)
    return runner._build()


def both(runner, st_np, args, lib, tracing=True, seed=0):
    """The same span eager and through the host build: ((eager state,
    scalars), (host state, scalars), the host step)."""
    outs = []
    for which in (None, lib):
        fn = build(runner, which, tracing, seed)
        st, *rest = fn(fresh(runner, st_np), runner._pay, *args)
        outs.append((st, rest))
    return outs[0], outs[1], fn.span


def assert_same_span(a, b):
    (sa, ra), (sb, rb) = a, b
    assert ra == rb, (ra, rb)
    assert window_mismatch(sa, sb) == []
    for k in ("ks_fires", "ks_lanes"):
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.parametrize("rounds", [1, 6])
@pytest.mark.parametrize("tracing", [True, False], ids=["traced",
                                                         "untraced"])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_phold_span_host_build_equals_eager_run(span_lib, exports,
                                                      case, tracing,
                                                      rounds):
    runner, st_np, (start, stop, limit, runahead) = exports[case]
    a, b, step = both(runner, st_np, (start, stop, limit, runahead, rounds),
                      span_lib, tracing)
    assert_same_span(a, b)
    (sa, ra), (sb, _rb) = a, b
    assert int(sa["abort_code"]) == 0
    assert ra[2] == rounds and ra[-1] > 0  # rounds, micro-iterations
    # One span step, its words read once, whatever the rounds.
    assert step.calls == 1
    assert sb["ks_spans"] == 1 and sb["ks_windows"] == rounds
    if tracing:
        assert int(sb["tr_n"]) > 0


def test_torch_phold_span_runs_to_the_stop(span_lib, exports):
    """A span that ends at its stop before max_rounds: the same rounds,
    next start and busy end as the eager loop."""
    runner, st_np, (start, stop, limit, runahead) = exports["mesh"]
    stop = start + 3 * runahead + 1
    a, b, _ = both(runner, st_np, (start, stop, limit, runahead, 64),
                   span_lib)
    assert_same_span(a, b)
    assert 1 < a[1][2] < 64 and a[1][0] >= stop


@pytest.mark.parametrize("case", ["phold_lossy", "mesh"])
def test_torch_phold_span_round_end_is_order_free(span_lib, exports, case):
    """The round end visiting each round's outbox in shuffled orders (as
    the kernel's atomic appends may): the same state as in order, and as
    the eager loop.  (The CoDel-active export's stretch sends nothing:
    its senders are done, only the slow downlinks drain.)"""
    runner, st_np, (start, stop, limit, runahead) = exports[case]
    args = (start, stop, limit, runahead, 16)
    a, b, _ = both(runner, st_np, args, span_lib)
    assert_same_span(a, b)
    for seed in (1, 77):
        fn = build(runner, span_lib, seed=seed)
        st, *rest = fn(fresh(runner, st_np), runner._pay, *args)
        assert_same_span(a, (st, rest))
    assert a[1][4] > 1  # packets: the rounds' outboxes held several


@pytest.mark.parametrize("cause", list(ABORTS))
def test_torch_phold_span_abort_bits_equal_eager(span_lib, cause):
    """Each single-cause overflow: the span ends with the eager loop's
    abort bits, and only them, in the same round.  The state is not
    compared: a rollback throws an aborted span's state away."""
    case, attrs, edit, bits = ABORTS[cause]
    make, nth = CASES[case]
    runner, st_np, (start, stop, limit, runahead) = capture(
        make(), nth, caps={k: v for k, v in attrs.items()
                           if k.startswith("CAP_")})
    for k, v in attrs.items():
        setattr(runner, k, v)
    if edit is not None:
        st_np = edit(runner, st_np)
    got = []
    for lib in (None, span_lib):
        fn = build(runner, lib)
        st, *rest = fn(fresh(runner, st_np), runner._pay, start, stop,
                       limit, runahead, 4)
        got.append((int(st["abort_code"]), rest[2]))
    assert got[0] == got[1] and got[0][0] == bits, got


def test_torch_phold_span_operand_table_covers_the_loop(span_lib, exports):
    """Every operand the span table names is a span-state column (or a
    buffer of the table), every written one CARRIED, DERIVED or
    span-local, and every column the eager loop changes over a span is a
    written operand."""
    ops = pk.SpanTable(span_lib, *exports["mesh"][0]._span_shape()).ops
    written = {o.key for o in ops if o.written}
    span_local = ("out_", "tr_", "abort_code")
    for o in ops:
        if o.key.startswith(("win.", "span.")):
            continue
        if o.written and not o.key.startswith(span_local):
            assert o.key in (PholdSpanRunner.RESIDENT_CARRIED
                             | ps.RESIDENT_DERIVED), o.key
    for case in CASES:
        runner, st_np, (start, stop, limit, runahead) = exports[case]
        fn = build(runner)
        st = fresh(runner, st_np)
        fn.prepare(st, runner._pay)
        before = clone_state(st)
        fn(st, runner._pay, start, stop, limit, runahead, 6)
        changed = {k for k, v in before.items()
                   if isinstance(v, torch.Tensor) and not k.startswith("_")
                   and not torch.equal(v, st[k])}
        assert changed and changed <= written, (case, changed - written)


@pytest.mark.parametrize("case", list(SIMS))
def test_torch_phold_span_sim_matches_serial(span_lib, case):
    """Forced device spans on the CPU with every span stepped by the host
    build: the JAX package's serial run's traces, histograms, stdout and
    counters, no abort, most rounds on the device, one span step a
    dispatch."""
    make = SIMS[case]
    m_ser, s_ser = jrun(JConfig.from_yaml_text(make("serial", None)))
    mgr = Manager(ConfigOptions.from_yaml_text(make("tpu", "force")),
                  device="cpu")
    r = mgr._dev_span = mgr.make_dev_span_runner()
    r.span_factory = host_span(span_lib)
    s_dev = mgr.run()
    assert s_ser.ok and s_dev.ok
    assert r.spans > 0 and r.aborts == 0, r.abort_kind_counts()
    assert r.rounds * 2 >= s_dev.rounds
    assert r.ks_spans == r.spans and r.spans_all >= r.ks_spans
    assert r.ks_windows == r.rounds and r.windows_all >= r.ks_windows
    assert r.micro_iters > 0 and r.ks_fires[ps.KS_POP] > 0
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert _hist(m_ser) == _hist(mgr)
    assert _stdout(m_ser) == _stdout(mgr)
    assert _counters(s_ser) == _counters(s_dev)
    if case == "codel_active":
        assert sum(1 for ln in mgr.trace_lines()
                   if ln.endswith("codel")) > 1000


@pytest.mark.parametrize("which", ["phold", "mesh"])
def test_torch_phold_span_host_build_equals_jax_runner(span_lib, which):
    """One span of the JAX PholdSpanRunner (its jitted `run` on the CPU)
    and of the port through the host build, from the same export: the
    run's scalars, every output column, the per-stage counters and the
    trace in canonical order."""
    text = {"phold": phold_yaml("tpu", loss=0.05, spans="force"),
            "mesh": mesh_yaml("tpu", spans="force")}[which]
    jm = JManager(JConfig.from_yaml_text(text))
    jcaps = (JRunner.CAP_I, JRunner.CAP_T, JRunner.CAP_R, JRunner.CAP_S,
             JRunner.CAP_C, JRunner.CAP_P)

    class Capture:
        ineligible = 0
        last_transient = True
        last_was_cold = False
        got = None
        seen = 0

        def try_span(self, start, stop, limit, runahead, dynamic,
                     max_rounds, spec_mr=0):
            d = jm.plane.engine.span_export_phold(*jcaps)
            if isinstance(d, dict):
                self.seen += 1
                if self.seen == 3:
                    self.got = (d, start, stop, limit, runahead)
            return None

    cap = Capture()
    jm._dev_span = cap
    jm.run()
    assert cap.got is not None
    d, start, stop, limit, runahead = cap.got
    jr = jm.make_dev_span_runner()
    st_np = jr._to_arrays(d)
    args = (start, stop, limit, runahead, 8)
    jr.kern = True
    fn = jr._build(st_np["peers"].shape[1])
    (jst, *jrest) = fn(dict(st_np), jr._lat, jr._thr, jr._node,
                       jr._ips_sorted, jr._ips_perm, np.uint32(jr._k[0]),
                       np.uint32(jr._k[1]), np.int64(jr.bootstrap_end),
                       np.int64(jr._pay), *args)
    assert int(jst["abort_code"]) == 0
    pr = PholdSpanRunner(jm.plane.engine, jr._lat, jr._thr, jr._node,
                         np.ascontiguousarray([h.ip for h in jm.hosts],
                                              dtype=np.uint32),
                         jm.config.general.seed,
                         jm.config.general.bootstrap_end_time_ns,
                         tracing=True, device="cpu")
    pr.family, pr._pay = jr.family, jr._pay
    pr.span_factory = host_span(span_lib)
    st = state_from_numpy(st_np, "cpu")
    st.update(pr._statics_on_device())
    pst, *prest = pr._build()(st, jr._pay, *args)
    assert tuple(prest) == tuple(int(v) for v in jrest)
    assert prest[2] > 1  # several rounds, round ends between them
    np.testing.assert_array_equal(pst["ks_fires"],
                                  np.asarray(jst["ks_fires"]))
    np.testing.assert_array_equal(pst["ks_lanes"],
                                  np.asarray(jst["ks_lanes"]))
    p_np = ps.state_to_numpy(pst, keys=[k for k in jst
                                        if k in pst["_np_dtypes"]])
    for k, v in jst.items():
        if k in p_np:
            np.testing.assert_array_equal(np.asarray(v), p_np[k],
                                          err_msg=k)
    jtr = {k[3:]: np.asarray(v).astype(np.int64) for k, v in jst.items()
           if k.startswith("tr_")}
    np.testing.assert_array_equal(canon(
        {f"tr_{k}": torch.from_numpy(v) for k, v in jtr.items()}, "tr_",
        TR_KEYS, "tr_n"), canon(pst, "tr_", TR_KEYS, "tr_n"))


def test_torch_phold_span_wrapper_refuses_cpu_tensors(exports):
    """On the CPU the runner builds no span step (the eager loop runs),
    and the wrapper refuses CPU tensors rather than run anything."""
    runner, st_np, _args = exports["phold_lossy"]
    fn = build(runner)
    assert fn.span is None and fn.step is None
    shape, params = runner._span_shape()
    with pytest.raises(ValueError, match="CUDA"):
        pk.PholdSpan().bind(shape, params).begin(fresh(runner, st_np),
                                                 runner._pay)


@pytest.mark.parametrize("edge", ["zero", "half"])
@pytest.mark.parametrize("case", ["phold_lossy", "mesh"])
def test_torch_phold_span_short_latency_equals_eager(span_lib, exports,
                                                     case, edge):
    """Latencies shorter than the runahead, host build vs the eager
    loop over six rounds: a zero latency (every arrival clamped to its
    window's end, the runahead kept: a zero minimum does not shrink it)
    and half the runahead (arrivals sent early in a window clamped, the
    runahead halved after the first round that keeps a packet)."""
    runner, st_np, (start, stop, limit, runahead) = exports[case]
    lat = 0 if edge == "zero" else runahead // 2
    outs = []
    for which in (None, span_lib):
        fn = build(runner, which)
        st = fresh(runner, st_np)
        st["_lat"] = torch.where(st["_lat"] < ps.TIME_NEVER, lat,
                                 st["_lat"])
        st, *rest = fn(st, runner._pay, start, stop, limit, runahead, 6)
        outs.append((st, rest))
    assert_same_span(*outs)
    (sa, ra), _ = outs
    assert int(sa["abort_code"]) == 0 and ra[2] == 6 and ra[4] > 0
    assert ra[1] == (runahead if edge == "zero" else lat)


def _moves(before: dict, after: dict):
    """Row by row: (entries kept in their slot, entries moved, arrivals,
    kept entries in rows that took arrivals), each unconsumed entry
    found again by its (src, seq)."""
    stay = moved = arrivals = keyed = 0
    for h in range(after["ib_time"].shape[0]):
        pos, n0 = int(before["ib_pos"][h]), int(before["ib_len"][h])
        n1 = int(after["ib_len"][h])
        new = {(int(after["ib_src"][h, k]), int(after["ib_seq"][h, k])): k
               for k in range(n1)}
        row_stay = sum(new[(int(before["ib_src"][h, k]),
                            int(before["ib_seq"][h, k]))] == k
                       for k in range(pos, n0))
        stay += row_stay
        moved += n0 - pos - row_stay
        arrivals += n1 - (n0 - pos)
        keyed += row_stay if n1 > n0 - pos else 0
    return stay, moved, arrivals, keyed


@pytest.mark.parametrize("case", ["phold_lossy", "mesh"])
def test_torch_phold_round_end_bound_counts_what_it_moves(exports, case):
    """The round end's byte bound on the first rounds that send, part by
    part: every outbox packet read once (a kept one's nine columns, a
    lost one's four and its trace line's four), every arrival written
    once, every unconsumed entry that changed slot read and written
    once, the keys of those that kept their slot in a row with
    arrivals; nothing for rows left as they were."""
    runner, st_np, (start, stop, _limit, runahead) = exports[case]
    fn = build(runner)
    st = fresh(runner, st_np)
    fn.prepare(st, runner._pay)
    seen = 0
    for _ in range(16):
        we = min(start + runahead, stop)
        fn.window_plain(st, we)
        mid = clone_state(st)
        n_out = int(st["out_n"])
        start = fn.round_end(st, we)[2]
        if not n_out:
            continue
        need = pk.round_end_need_bytes(mid, st, n_out)
        lost = int((st["app_pkts_dropped"]
                    - mid["app_pkts_dropped"]).sum())
        _stay, moved, arrivals, keyed = _moves(mid, st)
        assert arrivals == n_out - lost > 0
        assert need == {"outbox": 72 * (n_out - lost) + 64 * lost,
                        "arrivals": 72 * arrivals, "moved": 144 * moved,
                        "keys": 24 * keyed,
                        "total": 72 * n_out - 8 * lost + 72 * arrivals
                        + 144 * moved + 24 * keyed}
        seen += 1
        if seen == 3:
            break
    assert seen == 3


def test_torch_phold_span_bound_counts_changed_words_once(span_lib,
                                                          exports):
    """The span's byte bound from the eager loop (no window or span
    step built) and the span kernel's operand table: the rounds' reads
    and round ends summed, and each word the span changes charged once,
    not once per round: the outbox left out and, of the inbox entries,
    only the vacated slots' fills (the rest are the round ends'
    arrivals and moves)."""
    runner, st_np, args = exports["phold_lossy"]
    ops = pk.SpanTable(span_lib, *runner._span_shape()).ops
    fn = build(runner)
    assert fn.span is None and fn.step is None
    st = fresh(runner, st_np)
    need = pk.span_need_bytes(fn, ops, st, runner._pay, *args, 6)
    assert need["rounds"] == 6 and int(st["abort_code"]) == 0
    assert need["total"] == need["window"] + need["round_end"] \
        + need["state"]
    # The same span round by round: each round's changed words summed.
    st = fresh(runner, st_np)
    fn.prepare(st, runner._pay)
    first = clone_state(st)
    start, stop, limit, runahead = args
    per_round = 0
    for _ in range(6):
        we = min(start + runahead, stop)
        before = clone_state(st)
        fn.window_plain(st, we)
        n_out, min_lat, start, _code = fn.round_end(st, we)
        if 0 < min_lat < runahead:
            runahead = min_lat
        per_round += pk.span_state_bytes(ops, before, st)
    assert need["state"] == pk.span_state_bytes(ops, first, st)
    assert need["state"] < per_round
    live = torch.arange(st["ib_time"].shape[1])[None, :] \
        < st["ib_len"][:, None]
    want = 0
    for o in ops:
        if not o.written or o.key not in st or o.key.startswith("out_"):
            continue
        diff = (st[o.key] != first[o.key]).numpy()
        if o.key.startswith("ib_") and diff.ndim == 2:
            diff = diff & ~live.numpy()
        want += int(diff.sum()) * st[o.key].element_size()
    assert need["state"] == want > 0
