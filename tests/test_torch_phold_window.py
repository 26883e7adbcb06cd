"""The PHOLD/udp-mesh window kernel's lane law (csrc/phold_lane.cuh, the
law `stt_phold_window` runs in each thread) built for the host with the
system C++ compiler and run over every lane in turn, held exactly
against the port's eager window (its plain version) and, through the
port's Manager, against the JAX package's serial path.

1. One window from the same export, law vs eager window: every state
   column, the outbox and the trace in canonical order, `ks_fires`,
   `ks_lanes` and the micro-iterations; 8-LP PHOLD with loss, the
   8-host mesh and the CoDel-active mesh inside its CoDel stretch, with
   tracing on and off; then whole runs of several rounds, round ends
   included.
2. The abort rule: one case per overflow cause (outbox, trace, timer
   heap, CoDel ring, inbox merge), each giving the eager loop's bits.
3. Forced PHOLD / mesh / CoDel simulations with the runner's window step
   swapped for the host-built law: traces, syscall histograms, stdout
   and counters equal to the JAX package's serial run.
4. The window's byte bound (`window_need_bytes`): what a window with
   nothing due and a real window must move.
5. mesh-24's trace at 30 s holds, before 1 s, the trace of a run
   stopped at 1 s (what chip_smoke.py's PREFIX_DIGESTS rests on).
6. (slow) One span of the JAX PholdSpanRunner and of the port with the
   host-built law, traces compared in canonical order.

The kernel itself runs only on the card (chip_smoke.py holds it against
the eager window there); what is checked here is its lane code, its
operand table and the counts it reports, built from the same header.
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
from shadow_tpu_torch.ops import phold_window as pw
from shadow_tpu_torch.ops.phold_span import (TR_KEYS, PholdSpanRunner,
                                             state_from_numpy)
from shadow_tpu_torch.ops.span_mesh import AB_OUT, AB_STRUCT, AB_TRACE
from shadow_tpu_torch.tools.window_cases import (canon, capture_export,
                                                 device_state,
                                                 window_mismatch)
from shadow_tpu_torch.ops.propagate import HOST_ONLY
from shadow_tpu_torch.tools.netgen import mesh_family_yaml
from shadow_tpu_torch.tools.relay_cases import clone_state
from test_torch_phold_span import codel_yaml, mesh_yaml, phold_yaml

SHIM = r"""
#include <cstring>
#include "phold_lane.cuh"
namespace ph = stt::phold;
extern "C" const char* stt_phold_operands() { return ph::kOperands; }
extern "C" const char* stt_phold_params() { return ph::kParamNames; }
extern "C" const char* stt_phold_consts() { return ph::kConsts; }
extern "C" const char* stt_phold_stats() { return ph::kStats; }
extern "C" long long stt_phold_bitmap_words() { return ph::kBitmapWords; }
extern "C" int stt_phold_window(const void* const* ptrs,
                                const long long* words, void*) {
  ph::Ops o;
  std::memcpy(&o, ptrs, sizeof o);
  ph::Params p;
  std::memcpy(&p, words, sizeof p);
  ph::window_serial(o, p);
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
def host_lib(tmp_path_factory):
    """phold_lane.cuh built for the host with the system C++ compiler
    (the one the engine builds with), with the name functions the
    kernel's library exports."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("phold_lane_host")
    (d / "shim.cpp").write_text(SHIM)
    csrc = os.path.join(os.path.dirname(ps.__file__), "..", "csrc")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    csrc, "-o", str(d / "libphold_lane.so"),
                    str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libphold_lane.so"))
    pw._declare(lib)
    return lib


class HostWindow:
    """The window step of a span build through the host build: the
    operand table filled by the kernel's own names (pw.WindowTable, as
    the wrapper fills it on the card), every lane run in turn."""

    def __init__(self, lib, shape, params):
        self.lib = lib
        self.table = pw.WindowTable(lib, shape, params)
        self.calls = 0

    def begin(self, st, pay):
        self.table.begin(st, pay)
        self.calls = 0

    def __call__(self, st, window_end):
        assert self.lib.stt_phold_window(
            *self.table.fill(st, window_end), None) == 0
        self.calls += 1

    def end(self):
        return dict(self.table.end(), windows=self.calls, window_ms=0.0)


def host_factory(lib):
    return lambda shape, params: HostWindow(lib, shape, params)


# ------------------------------------------------------------ the exports

def capture(text: str, nth: int, caps: dict | None = None):
    """The port's Manager on the CPU up to its `nth` in-domain export."""
    return capture_export(Manager(ConfigOptions.from_yaml_text(text),
                                  device="cpu"), nth, caps)


def fresh(runner, st_np):
    return device_state(runner, st_np)


def build(runner, lib=None, tracing=True):
    runner.tracing = tracing
    runner.window_factory = None if lib is None else host_factory(lib)
    return runner._build()


def assert_same_state(a, b):
    """Every tensor column equal, and the outbox and trace up to their
    counts in canonical order."""
    assert window_mismatch(a, b) == []


def one_window(runner, st_np, window_end, lib, tracing=True):
    """One window from the export, eager and through the law: (eager
    state, law state, eager iterations, law counts)."""
    plain = build(runner, None, tracing)
    law = build(runner, lib, tracing)
    a, b = fresh(runner, st_np), fresh(runner, st_np)
    plain.prepare(a, runner._pay)
    it = plain.window_plain(a, window_end)
    law.prepare(b, runner._pay)
    law.step.begin(b, runner._pay)
    law.step(b, window_end)
    got = law.step.end()
    return a, b, it, got


# An export inside each case's device stretch: 8-LP PHOLD with loss, the
# 8-host mesh, and the CoDel-active mesh to 2 s (its CoDel stretch ends
# at 3.9 s), each a few spans in.
CASES = {
    "phold_lossy": (lambda: phold_yaml("tpu", loss=0.05, stop="1s",
                                       spans="force"), 3),
    "mesh": (lambda: mesh_yaml("tpu", spans="force"), 3),
    "codel_active": (lambda: codel_yaml("tpu", spans="force").replace(
        "stop_time: 60s", "stop_time: 2s"), 6),
}


@pytest.fixture(scope="module")
def exports():
    return {name: capture(make(), nth) for name, (make, nth) in
            CASES.items()}


@pytest.mark.parametrize("tracing", [True, False], ids=["traced",
                                                         "untraced"])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_phold_lane_law_one_window_equals_eager(host_lib, exports,
                                                      case, tracing):
    runner, st_np, (start, stop, _limit, runahead) = exports[case]
    a, b, it, got = one_window(runner, st_np, min(start + runahead, stop),
                               host_lib, tracing)
    assert int(a["abort_code"]) == int(b["abort_code"]) == 0
    assert_same_state(a, b)
    assert got["iters"] == it > 0
    np.testing.assert_array_equal(got["fires"], a["ks_fires"])
    np.testing.assert_array_equal(got["lanes"], a["ks_lanes"])
    assert got["windows"] == 1
    # The law calls made in the lanes: one per bucket charge (never
    # fewer than the eager loop's calls, one per pass with a charge) and
    # one per CoDel dequeue, each at most once per relay lane.
    lanes = a["ks_lanes"]
    assert a["ks_calls"][0] <= got["calls"][0] \
        <= lanes[ps.KS_INET_OUT] + lanes[ps.KS_CODEL]
    assert 0 < got["calls"][1] <= lanes[ps.KS_CODEL]


def _codel_substates(st_np):
    """The CoDel-active export with every lane's drain forced into one
    of CoDel's substates (sniff, chain, dropping, none) and relay 2 due;
    lanes 4-7 of every 8 with their rings emptied."""
    d = dict(st_np)
    lane = np.arange(len(d["cont"]))
    k = lane % 4
    empty = (lane // 4) % 2 == 1
    d["cq_len"] = np.where(empty, 0, d["cq_len"]).astype(d["cq_len"].dtype)
    d["codel_bytes"] = np.where(empty, 0, d["codel_bytes"])
    d["cd_sniff"] = (k == 0).astype(d["cd_sniff"].dtype)
    d["cd_chain"] = (k == 1).astype(d["cd_chain"].dtype)
    d["codel_dropping"] = ((k == 1) | (k == 2)).astype(
        d["codel_dropping"].dtype)
    d["codel_count"] = d["codel_count"] + 3 * (k < 3)
    d["r2_pending"] = np.zeros_like(d["r2_pending"])
    d["r2_pk_valid"] = np.zeros_like(d["r2_pk_valid"])
    idle = d["cont"] == ps.C_IDLE
    d["cont"] = np.where(idle, ps.C_R2, d["cont"])
    d["then"] = np.where(idle, ps.C_IDLE, d["then"])
    return d


def test_torch_phold_lane_law_codel_substates_equal_eager(host_lib,
                                                          exports):
    """Every CoDel substate on a drain that finds its ring full or empty:
    the law's window equals the eager one."""
    runner, st_np, (start, stop, _limit, runahead) = exports["codel_active"]
    st_np = _codel_substates(st_np)
    assert (st_np["cq_len"] == 0).any() and (st_np["cq_len"] > 0).any()
    a, b, it, got = one_window(runner, st_np, min(start + runahead, stop),
                               host_lib)
    assert_same_state(a, b)
    assert got["iters"] == it > 0
    np.testing.assert_array_equal(got["fires"], a["ks_fires"])
    np.testing.assert_array_equal(got["lanes"], a["ks_lanes"])


@pytest.mark.parametrize("case", list(CASES))
def test_torch_phold_lane_law_runs_equal_eager(host_lib, exports, case):
    """Whole runs of several rounds (round ends, the eager propagation
    and inbox merge, between the windows): the same output state,
    counters and micro-iterations."""
    runner, st_np, (start, stop, limit, runahead) = exports[case]
    outs = []
    for lib in (None, host_lib):
        fn = build(runner, lib)
        outs.append(fn(fresh(runner, st_np), runner._pay, start, stop,
                       limit, runahead, 6))
    (a, *ra), (b, *rb) = outs
    assert ra == rb and ra[2] > 1, (ra, rb)  # rounds
    assert int(a["abort_code"]) == 0
    assert_same_state(a, b)
    for k in ("ks_fires", "ks_lanes"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert b["ks_windows"] == ra[2]
    if case == "codel_active":
        assert int((b["codel_dropped"] - torch.tensor(
            st_np["codel_dropped"])).sum()) > 0, "no CoDel drop in the run"


# ------------------------------------------------------------ the aborts

def _far(st_np):
    return int(st_np["now"].max()) + (1 << 50)


def _heap_full(runner, st_np):
    """Every lane's timer heap full (the new entries far in the future):
    the first push overflows."""
    d = dict(st_np)
    tv = d["th_valid"].copy()
    d["th_time"] = np.where(tv, d["th_time"], _far(st_np))
    d["th_seq"] = np.where(tv, d["th_seq"], 1 << 40)
    d["th_valid"] = np.ones_like(tv)
    return d


def _codel_full(runner, st_np):
    """Every lane's CoDel ring one short of full (CAP_C 256, under the
    1,000-packet hard limit; the padding is empty packets enqueued at 0,
    with the inet-in relay held pending): the next arrival overflows."""
    d = dict(st_np)
    d["cq_len"] = np.full_like(d["cq_len"], runner.CAP_C - 1)
    d["r2_pending"] = np.ones_like(d["r2_pending"])
    return d


def _inbox_full(runner, st_np):
    """Every lane's inbox padded to I - 1 entries far in the future: the
    round end's merge overflows on the first arrival."""
    d = dict(st_np)
    I = runner.CAP_I
    ln = d["ib_len"].astype(np.int64)
    pad = np.arange(I)[None, :] >= ln[:, None]
    d["ib_time"] = np.where(pad, _far(st_np), d["ib_time"])
    d["ib_len"] = np.full_like(d["ib_len"], I - 1)
    return d


ABORTS = {
    # cause: (case, runner attributes, state edit, expected bits)
    "outbox": ("phold_lossy", {"cap_out": 8 + 2}, None, AB_OUT),
    "trace": ("phold_lossy", {"cap_tr": 8 + 2}, None, AB_TRACE),
    "timer_heap": ("phold_lossy", {}, _heap_full, AB_STRUCT),
    "codel_ring": ("phold_lossy", {"CAP_C": 256}, _codel_full, AB_STRUCT),
    "inbox_merge": ("mesh", {}, _inbox_full, AB_STRUCT),
}


@pytest.mark.parametrize("cause", list(ABORTS))
def test_torch_phold_lane_law_abort_bits_equal_eager(host_lib, cause):
    """Each single-cause overflow: the run through the law ends with the
    eager loop's abort bits, and only them."""
    case, attrs, edit, bits = ABORTS[cause]
    make, nth = CASES[case]
    runner, st_np, (start, stop, limit, runahead) = capture(
        make(), nth, caps={k: v for k, v in attrs.items()
                           if k.startswith("CAP_")})
    for k, v in attrs.items():
        setattr(runner, k, v)
    if edit is not None:
        st_np = edit(runner, st_np)
    codes = []
    for lib in (None, host_lib):
        fn = build(runner, lib)
        out = fn(fresh(runner, st_np), runner._pay, start, stop, limit,
                 runahead, 4)
        codes.append(int(out[0]["abort_code"]))
    assert codes[0] == codes[1] == bits, codes


# ------------------------------------------------- whole simulations

def _hist(m):
    out = {}
    for h in m.hosts:
        h.merge_native_counters()
        for k, v in h.syscall_counts.items():
            out[k] = out.get(k, 0) + v
    return out


def _stdout(m):
    return sorted((p.name, bytes(p.stdout))
                  for h in m.hosts for p in h.processes.values())


def _counters(s):
    return (s.events, s.packets_sent, s.packets_recv, s.packets_dropped,
            s.syscalls)


SIMS = {"phold_lossy": lambda s, sp: phold_yaml(s, loss=0.05, stop="3s",
                                                spans=sp),
        "mesh": lambda s, sp: mesh_yaml(s, spans=sp),
        "codel_active": codel_yaml}


@pytest.mark.parametrize("case", list(SIMS))
def test_torch_phold_lane_law_sim_matches_serial(host_lib, case):
    """Forced device spans on the CPU with every window stepped by the
    host-built lane law: the JAX package's serial run's traces,
    histograms, stdout and counters, no abort, most rounds on the
    device."""
    make = SIMS[case]
    m_ser, s_ser = jrun(JConfig.from_yaml_text(make("serial", None)))
    mgr = Manager(ConfigOptions.from_yaml_text(make("tpu", "force")),
                  device="cpu")
    r = mgr._dev_span = mgr.make_dev_span_runner()
    r.window_factory = host_factory(host_lib)
    s_dev = mgr.run()
    assert s_ser.ok and s_dev.ok
    assert r.spans > 0 and r.aborts == 0, r.abort_kind_counts()
    assert r.rounds * 2 >= s_dev.rounds
    assert r.ks_windows == r.rounds and r.windows_all >= r.ks_windows
    assert r.micro_iters > 0 and r.ks_fires[ps.KS_POP] > 0
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert _hist(m_ser) == _hist(mgr)
    assert _stdout(m_ser) == _stdout(mgr)
    assert _counters(s_ser) == _counters(s_dev)
    if case == "codel_active":
        assert sum(1 for ln in mgr.trace_lines()
                   if ln.endswith("codel")) > 1000


# ------------------------------------------------- the operand table

def test_torch_phold_window_operand_table_covers_the_loop(host_lib):
    """Every operand the kernel's table names is a column of the span
    state (or its own buffer), each written one is CARRIED, DERIVED or
    span-local, and every CARRIED column the window touches is in it."""
    ops = pw.parse_operands(host_lib.stt_phold_operands().decode())
    keys = [o.key for o in ops]
    assert len(keys) == len(set(keys))
    span_local = ("out_", "tr_", "abort_code")
    for o in ops:
        if o.key.startswith("win."):
            continue
        if o.written and not o.key.startswith(span_local):
            assert o.key in (PholdSpanRunner.RESIDENT_CARRIED
                             | ps.RESIDENT_DERIVED), o.key
        if not o.written and not o.key.startswith("_"):
            assert o.key in (PholdSpanRunner.RESIDENT_STATIC
                             | PholdSpanRunner.RESIDENT_CARRIED), o.key
    # The columns only the round end or the codec touch.
    untouched = {"ib_src", "ib_seq", "ib_len", "th_valid"} - set(keys)
    assert untouched == {"ib_src", "ib_seq"}
    pw.check_consts(host_lib)


# ------------------------------------------------- the byte bound

@pytest.mark.parametrize("case", list(CASES))
def test_torch_phold_window_bound_counts_what_the_window_moves(host_lib,
                                                               exports,
                                                               case):
    """A window with nothing due moves only every lane's busy/due test;
    a real window adds its dequeues, copies and changed words, and never
    reaches one read and one write of every operand."""
    runner, st_np, (start, stop, _limit, runahead) = exports[case]
    law = build(runner, host_lib)
    ops = law.step.table.ops
    H, T = len(st_np["now"]), runner.CAP_T
    for window_end, busy in ((start, False),
                             (min(start + runahead, stop), True)):
        st = fresh(runner, st_np)
        law.prepare(st, runner._pay)
        before = clone_state(st)
        law.step.begin(st, runner._pay)
        law.step(st, window_end)
        got = law.step.end()
        need = pw.window_need_bytes(ops, before, st)
        pending = int((st["ib_len"] > st["ib_pos"]).sum())
        assert need["idle"] == H * (24 + T) + 8 * (
            pending + int(st["th_valid"].sum()))
        assert need["total"] == sum(v for k, v in need.items()
                                    if k != "total")
        if not busy:
            assert got["iters"] == 0
            assert need["total"] == need["idle"]
            continue
        assert got["iters"] > 0
        assert min(need["dequeue"], need["copies"], need["writes"]) > 0
        every = sum(st[o.key].numel() * st[o.key].element_size()
                    for o in ops if o.key in st)
        assert need["total"] < 2 * every


def test_torch_mesh24_trace_before_1s_is_the_1s_run():
    """The reference's 24-host paced mesh, C++ only: the lines of the
    30 s run's trace before 1 s are the 1 s run's trace, line for line
    (a run's trace is grouped by host, each host's lines in time
    order)."""
    lines = {}
    for stop in ("1s", "30s"):
        cfg = ConfigOptions.from_yaml_text(mesh_family_yaml(
            24, scheduler="tpu", device_spans="off", stop_time=stop))
        cfg.experimental.tpu_min_device_batch = HOST_ONLY
        mgr = Manager(cfg, device="cpu")
        assert mgr.run().ok
        lines[stop] = mgr.trace_lines()
    before = [ln for ln in lines["30s"]
              if int(ln.split(" ", 1)[0]) < 1_000_000_000]
    assert len(lines["1s"]) > 1000
    assert before == lines["1s"]
    assert len(lines["30s"]) > len(before)


# ------------------------------------------------- one span vs JAX

@pytest.mark.slow
@pytest.mark.parametrize("which", ["phold", "mesh"])
def test_torch_one_span_law_equals_jax_phold_runner(host_lib, which):
    """One span of the JAX PholdSpanRunner and of the port with every
    window stepped by the host-built lane law, from the same exported
    state: every output column, the per-stage fire/lane counters and the
    trace in canonical order.  Slow: the JAX loop's XLA compile takes
    minutes on the CPU backend."""
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
    pr.window_factory = host_factory(host_lib)
    st = state_from_numpy(st_np, "cpu")
    st.update(pr._statics_on_device())
    pst, *prest = pr._build()(st, jr._pay, *args)
    assert tuple(prest) == tuple(int(v) for v in jrest)
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
