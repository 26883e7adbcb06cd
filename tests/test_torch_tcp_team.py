"""The TCP window kernel's tile law: csrc/tcp_lane.cuh's lane law with
its row scans split over a team (the kernel's tile of kTeam threads a
lane), built for the host with the system C++ compiler, where a team of
T ranks runs every rank's partial in turn and then the combine.

(a) One window from the same export, the law at T = 1 and at the
    kernel's T against the port's eager window: every state column,
    the outbox and trace in canonical order, fires, lanes and
    micro-iterations; the 16-host stream's first exports at 0% and 2%
    loss, the copy with faulted hosts, and the wide-rows edit of the
    2%-loss export (tools/window_cases.tcp_wide_rows: a reassembly row
    of 298 entries in shuffled slots giving three SACK runs, an rtx
    ring of 480 entries with SACK marks, a heap with 3,000 stale RTO
    entries), traced and untraced; a whole run of eight rounds; and the
    forced 2%-loss stream end to end at the kernel's T against the JAX
    package's serial run (trace, events, drops).
(b) Every abort case at the kernel's T: the eager loop's bits and site.
(c) The sorted SACK pass (`sack_sorted`) against the fixpoint the lane
    ran before it (the one-thread `sack_blocks`, kept here as the
    reference) on seeded random rows: empty and full rows, equal starts, nested and
    touching intervals, entries behind rcv_nxt, rcv_nxt near the
    sequence wrap; at T = 1, 2, 8 and 32.

tests/test_torch_tcp_window.py holds the same law at T = 1 on its
cases; the kernel itself runs only on the card (chip_smoke.py).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from shadow_tpu_torch.ops import tcp_window as tw
from shadow_tpu_torch.tools.relay_cases import clone_state
from shadow_tpu_torch.tools.window_cases import (tcp_device_state,
                                                 tcp_wide_rows,
                                                 tcp_window_mismatch)
from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import run_simulation as jrun
from test_torch_tcp_window import (ABORTS, CASES, HostWindow, build,
                                   capture, exports,  # noqa: F401
                                   port_manager, stream)

SHIM = r"""
#include <cstring>
#include "tcp_lane.cuh"
namespace tc = stt::tcp;
extern "C" const char* stt_tcp_operands() { return tc::kOperands; }
extern "C" const char* stt_tcp_params() { return tc::kParamNames; }
extern "C" const char* stt_tcp_consts() { return tc::kConsts; }
extern "C" const char* stt_tcp_stats() { return tc::kStats; }
extern "C" long long stt_tcp_bitmap_words() { return tc::kBitmapWords; }
static int g_team = 1;
extern "C" void stt_tcp_set_team(int team) { g_team = team; }
extern "C" int stt_tcp_kernel_team() { return tc::kTeam; }
extern "C" int stt_tcp_window(const void* const* ptrs,
                              const long long* words, void*) {
  tc::Ops o;
  std::memcpy(&o, ptrs, sizeof o);
  tc::Params p;
  std::memcpy(&p, words, sizeof p);
  return tc::window_serial(o, p, g_team);
}
// The sorted pass by a team of `team` ranks over one reassembly row.
extern "C" long long stt_tcp_sack_sorted(int team, const long long* seq,
                                         const long long* plen,
                                         const unsigned char* valid,
                                         long long cap, long long rcvnxt,
                                         long long* sk) {
  static tc::TeamScratch sh;
  const tc::Team t = {team};
  return tc::sack_sorted(t, sh, (const int64_t*)seq, (const int64_t*)plen,
                         valid, cap, rcvnxt, (int64_t*)sk);
}
// The fixpoint the lane ran before the sorted pass (its runs' closed
// intervals grown until no entry starting inside extends them).
extern "C" void stt_tcp_sack_fixpoint(const long long* seq,
                                      const long long* plen,
                                      const unsigned char* valid,
                                      long long cap, long long rcvnxt,
                                      long long* sk) {
  for (int k = 0; k < 7; k++) sk[k] = 0;
  int64_t prev_end = 0;
  for (int r = 0; r < 3; r++) {
    int64_t start = tc::I64_MAX;
    bool found = false;
    for (int64_t k = 0; k < cap; k++) {
      if (!valid[k]) continue;
      const int64_t rel = tc::s_sub(seq[k], rcvnxt);
      if ((r == 0 || rel > prev_end) && (!found || rel < start)) {
        start = rel;
        found = true;
      }
    }
    if (!found) break;
    int64_t end = start;
    for (bool grew = true; grew;) {
      grew = false;
      for (int64_t k = 0; k < cap; k++) {
        if (!valid[k]) continue;
        const int64_t rel = tc::s_sub(seq[k], rcvnxt);
        const int64_t e = rel + plen[k];
        if (rel >= start && rel <= end && e > end) {
          end = e;
          grew = true;
        }
      }
    }
    sk[0] = r + 1;
    sk[1 + 2 * r] = tc::s_add(rcvnxt, start);
    sk[2 + 2 * r] = tc::s_add(rcvnxt, end);
    prev_end = end;
  }
}
"""

TEAMS = {"one": 1, "kernel": None}  # None: the kernel's kTeam


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def team_lib(tmp_path_factory):
    """tcp_lane.cuh built for the host with a settable team size, and
    the SACK passes over one row."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("tcp_team_host")
    (d / "shim.cpp").write_text(SHIM)
    csrc = os.path.join(os.path.dirname(tw.__file__), "..", "csrc")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    csrc, "-o", str(d / "libtcp_team.so"),
                    str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libtcp_team.so"))
    tw._declare(lib)
    lib.stt_tcp_set_team.argtypes = [ctypes.c_int]
    lib.stt_tcp_set_team.restype = None
    lib.stt_tcp_kernel_team.restype = ctypes.c_int
    p = ctypes.c_void_p
    lib.stt_tcp_sack_sorted.argtypes = [ctypes.c_int, p, p, p,
                                        ctypes.c_longlong,
                                        ctypes.c_longlong, p]
    lib.stt_tcp_sack_sorted.restype = ctypes.c_longlong
    lib.stt_tcp_sack_fixpoint.argtypes = [p, p, p, ctypes.c_longlong,
                                          ctypes.c_longlong, p]
    lib.stt_tcp_sack_fixpoint.restype = None
    return lib


def team_of(lib, which: str) -> int:
    team = TEAMS[which] or lib.stt_tcp_kernel_team()
    lib.stt_tcp_set_team(team)
    return team


def team_factory(lib):
    return lambda shape, params: HostWindow(lib, shape, params)


def build_team(runner, lib, tracing=True):
    runner.tracing = tracing
    runner.window_factory = team_factory(lib)
    return runner._build()


def state_of(exports, case):
    """A case's export: CASES (tests/test_torch_tcp_window.py) and
    "wide", the wide-rows edit of the 2%-loss export."""
    if case == "wide":
        runner, st_np, args = exports["lossy"]
        return runner, tcp_wide_rows(st_np), args
    src, edit = CASES[case]
    runner, st_np, args = exports[src]
    return runner, (st_np if edit is None else edit(st_np)), args


EAGER = {}


def eager_window(runner, st_np, window_end, tracing, key):
    """The eager window from the export, once per case and tracing."""
    if key not in EAGER:
        plain = build(runner, None, tracing)
        a = tcp_device_state(runner, st_np)
        plain.prepare(a)
        EAGER[key] = (a, plain.window_plain(a, window_end))
    return EAGER[key]


@pytest.mark.parametrize("which", list(TEAMS))
@pytest.mark.parametrize("tracing", [True, False], ids=["traced",
                                                         "untraced"])
@pytest.mark.parametrize("case", list(CASES) + ["wide"])
def test_torch_tcp_team_one_window_equals_eager(team_lib, exports, case,
                                                tracing, which):
    team = team_of(team_lib, which)
    runner, st_np, (start, stop, _limit, runahead) = state_of(exports, case)
    we = min(start + runahead, stop)
    a, it = eager_window(runner, st_np, we, tracing, (case, tracing))
    law = build_team(runner, team_lib, tracing)
    b = tcp_device_state(runner, st_np)
    law.prepare(b)
    law.step.begin(b)
    law.step(b, we)
    got = law.step.end()
    assert int(a["abort_code"]) == int(b["abort_code"]) == 0, team
    assert tcp_window_mismatch(a, b) == [], team
    assert got["iters"] == it > 0
    np.testing.assert_array_equal(got["fires"], a["ks_fires"])
    np.testing.assert_array_equal(got["lanes"], a["ks_lanes"])


def test_torch_tcp_team_wide_rows_fill_the_rows(exports):
    """The wide-rows edit holds what it says: a reassembly row of 298
    entries in three runs, an rtx ring of 480 with marks, 3,000 stale
    heap entries more, and the eager window runs it without an abort."""
    runner, st_np, (start, stop, _limit, runahead) = state_of(exports,
                                                              "wide")
    lossy = exports["lossy"][1]
    assert st_np["ra_valid"].sum(axis=1).max() == 298
    assert (st_np["rtx_len"] - st_np["rtx_pos"]).max() == 480
    assert st_np["rtx_sacked"].sum() > lossy["rtx_sacked"].sum()
    assert st_np["th_valid"].sum() - lossy["th_valid"].sum() == 3000
    a, it = eager_window(runner, st_np, min(start + runahead, stop), True,
                         ("wide", True))
    assert int(a["abort_code"]) == 0 and it > 0


@pytest.mark.parametrize("cause", list(ABORTS))
def test_torch_tcp_team_abort_bits_equal_eager(team_lib, exports, cause):
    """Each single-cause abort at the kernel's T: the eager loop's bits
    and site, and only them."""
    team_of(team_lib, "kernel")
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
        for fn in (build(runner, None), build_team(runner, team_lib)):
            out = fn(tcp_device_state(runner, st_np), start, stop, limit,
                     runahead, 2)
            got.append((int(out[0]["abort_code"]),
                        int(out[0]["abort_site"])))
    finally:
        for k, v in saved.items():
            setattr(runner, k, v)
    assert got[0] == got[1] == (bits, site), got


def test_torch_tcp_team_run_equals_eager(team_lib, exports):
    """Eight rounds of the 2%-loss stream, round ends included, with the
    law at the kernel's T: the eager loop's state, scalars and counts."""
    team_of(team_lib, "kernel")
    runner, st_np, (start, stop, limit, runahead) = exports["lossy"]
    a, *ra = build(runner, None)(tcp_device_state(runner, st_np), start,
                                 stop, limit, runahead, 8)
    b, *rb = build_team(runner, team_lib)(tcp_device_state(runner, st_np),
                                          start, stop, limit, runahead, 8)
    assert ra == rb and ra[2] == 8
    assert tcp_window_mismatch(a, b) == []
    for k in ("ks_fires", "ks_lanes"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_torch_tcp_team_sim_matches_serial(team_lib):
    """The forced 16-host 2%-loss stream on the CPU with every window
    stepped by the law at the kernel's T: the JAX package's serial run's
    trace, events and drops, no abort, most rounds on the device."""
    team_of(team_lib, "kernel")
    m_ser, s_ser = jrun(JConfig.from_yaml_text(stream("serial", 0.02)))
    mgr = port_manager(0.02)
    r = mgr._dev_span_tcp = mgr.make_tcp_span_runner()
    r.window_factory = team_factory(team_lib)
    s_dev = mgr.run()
    assert s_ser.ok and s_dev.ok
    assert r.spans > 0 and r.aborts == 0, r.abort_kind_counts()
    assert r.rounds * 2 >= s_dev.rounds
    assert r.ks_windows == r.rounds and r.micro_iters > 0
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert s_ser.events == s_dev.events
    assert s_ser.packets_dropped == s_dev.packets_dropped > 0


# ------------------------------------------------- the sorted SACK pass

def _row(rng, cap, n, kind):
    """A reassembly row of n valid entries in random slots; `kind` picks
    how their distances from rcv_nxt fall."""
    seq = rng.integers(0, 1 << 32, cap)
    plen = rng.integers(0, 3000, cap)
    if kind == "grid":  # segments on an MSS grid with holes (the stream)
        rel = 1460 * rng.choice(400, n, replace=False)
        plen[:] = 1460
    elif kind == "equal":  # many equal starts, ragged lengths
        rel = 100 * rng.integers(0, 8, n)
    elif kind == "nested":  # intervals inside and touching others
        rel = rng.integers(0, 20_000, n)
        plen = rng.choice([0, 1, 50, 5000, 20_000], cap)
    else:  # anywhere, some behind rcv_nxt
        rel = rng.integers(-(1 << 20), 1 << 21, n)
    valid = np.zeros(cap, dtype=np.uint8)
    slots = rng.choice(cap, n, replace=False)
    valid[slots] = 1
    rcvnxt = int(rng.choice([rng.integers(0, 1 << 32),
                             (1 << 32) - int(rng.integers(1, 5000))]))
    seq[slots] = (rcvnxt + rel) % (1 << 32)
    return seq, plen, valid, rcvnxt


def test_torch_tcp_team_sorted_sack_equals_fixpoint(team_lib):
    """sack_sorted (the tile's sorted pass) against the fixpoint on 400
    seeded random rows of cap 512 and 64, at T = 1, 2, 8 and 32."""
    rng = np.random.default_rng(2024)
    ptr = ctypes.c_void_p
    runs_seen = set()
    for trial in range(400):
        cap = 512 if trial % 4 else 64
        n = int(rng.choice([0, 1, 2, 3, rng.integers(0, cap + 1), cap]))
        kind = ("grid", "equal", "nested", "any")[trial % 4]
        if kind == "grid":
            n = min(n, 400)
        seq, plen, valid, rcvnxt = _row(rng, cap, n, kind)
        seq = np.ascontiguousarray(seq, dtype=np.int64)
        plen = np.ascontiguousarray(plen, dtype=np.int64)
        want = np.zeros(7, dtype=np.int64)
        team_lib.stt_tcp_sack_fixpoint(ptr(seq.ctypes.data),
                                       ptr(plen.ctypes.data),
                                       ptr(valid.ctypes.data), cap, rcvnxt,
                                       ptr(want.ctypes.data))
        runs_seen.add(int(want[0]))
        for team in (1, 2, 8, 32):
            got = np.zeros(7, dtype=np.int64)
            staged = team_lib.stt_tcp_sack_sorted(
                team, ptr(seq.ctypes.data), ptr(plen.ctypes.data),
                ptr(valid.ctypes.data), cap, rcvnxt, ptr(got.ctypes.data))
            assert staged == n
            np.testing.assert_array_equal(
                got, want, err_msg=f"trial {trial} ({kind}, n {n}) T {team}")
    assert runs_seen == {0, 1, 2, 3}


def test_torch_tcp_team_wrapper_state_is_unchanged_by_team(team_lib,
                                                           exports):
    """The same window at T = 1, 3 (a team that does not divide the rows)
    and the kernel's T gives the same state: the split changes no
    result."""
    runner, st_np, (start, stop, _limit, runahead) = state_of(exports,
                                                              "wide")
    we = min(start + runahead, stop)
    outs = []
    for team in (1, 3, team_lib.stt_tcp_kernel_team()):
        team_lib.stt_tcp_set_team(team)
        law = build_team(runner, team_lib)
        b = tcp_device_state(runner, st_np)
        law.prepare(b)
        law.step.begin(b)
        law.step(b, we)
        outs.append((clone_state(b), law.step.end()))
    for b, got in outs[1:]:
        assert tcp_window_mismatch(outs[0][0], b) == []
        assert got["iters"] == outs[0][1]["iters"]
