"""The TCP lane frame (csrc/tcp_lane.cuh): each lane's host words and the
conn words of its first kFrameConns conn rows gathered into its tile's
shared memory when the tile takes the lane, the lane law reading and
writing them there, and every changed word written back on each way
out of the lane's window.  The span kernel's phases and the window
kernel's lanes built for the host with the system C++ compiler run the
frame exactly as the card does; held exactly (integer laws, tolerance
0) against the port's eager loop, its plain version.

1. Whole spans of one and of four rounds through the span kernel's host
   build equal the eager loop on every state column, the outbox and
   trace in canonical order, the run's scalars, `ks_fires` and
   `ks_lanes`: the 16-host stream's first exports at 0% and 2% loss,
   and the over-cap edit of the 2%-loss one
   (tools/window_cases.tcp_over_cap: a tgen server with kFrameConns + 1
   conn rows, its busiest conn past the frame's cap, so the law reaches
   that conn in device memory through the same accessor).
2. The poison build (-DSTT_TCP_FRAME_POISON; tier-1's host build only,
   never the card's library) overwrites every gathered device word right
   after the gather.  The same spans still equal the eager loop, so the
   law reads no gathered word from device memory; a lane's gather alone
   shows the words it overwrites (host, conn, read-only ones too) and
   the conn row past the cap left alone.
3. A lane that aborts (its timer heap full): one window through the
   window kernel's host build gives the eager loop's bits and site, and
   the aborting lane and the lanes after it (the host build runs lanes
   in turn: those before it see no abort yet and run on) hold the eager
   window's state, written back on the abort's way out.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from shadow_tpu_torch.ops import tcp_span as ts
from shadow_tpu_torch.ops import tcp_span_kernel as tsk
from shadow_tpu_torch.ops import tcp_window as tw
from shadow_tpu_torch.ops.span_mesh import AB_STRUCT
from shadow_tpu_torch.tools.window_cases import (tcp_device_state,
                                                 tcp_over_cap)
from test_torch_tcp_span_kernel import SHIM as SPAN_SHIM
from test_torch_tcp_span_kernel import assert_same_span
from test_torch_tcp_span_kernel import build as span_build
from test_torch_tcp_window import (_heap_full, build, exports,  # noqa: F401
                                   one_window)

SHIM = SPAN_SHIM + r"""
// The window kernel's entry points over the same header (the eager
// loop's window step through the host build).
extern "C" const char* stt_tcp_operands() { return tc::kOperands; }
extern "C" const char* stt_tcp_params() { return tc::kParamNames; }
extern "C" const char* stt_tcp_consts() { return tc::kConsts; }
extern "C" const char* stt_tcp_stats() { return tc::kStats; }
extern "C" long long stt_tcp_bitmap_words() { return tc::kBitmapWords; }
extern "C" int stt_tcp_window(const void* const* ptrs,
                              const long long* words, void*) {
  tc::Ops o;
  std::memcpy(&o, ptrs, sizeof o);
  tc::Params p;
  std::memcpy(&p, words, sizeof p);
  return tc::window_serial(o, p, tc::kTeam);
}
extern "C" long long stt_tcp_frame_conns() { return tc::kFrameConns; }
extern "C" int stt_tcp_frame_poisoned() {
#ifdef STT_TCP_FRAME_POISON
  return 1;
#else
  return 0;
#endif
}
// Lane `lane`'s gather alone (no law, no write-back) over the window
// table: the conn rows its frame holds into `rows`; returns how many.
extern "C" long long stt_tcp_frame_gather(const void* const* ptrs,
                                          long long lane, long long* rows) {
  tc::Ops o;
  std::memcpy(&o, ptrs, sizeof o);
  static tc::TeamScratch sh;
  const tc::Team t = {tc::kTeam};
  tc::frame_gather(t, o, lane, sh.fr);
  for (int64_t s = 0; s < sh.fr.n; s++) rows[s] = sh.fr.row[s];
  return sh.fr.n;
}
"""

POISON = 0x7EADBEEF0BADF00D  # tcp_lane.cuh kPoison


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The eager loop runs thousands of small ops: one intra-op thread
    keeps the test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The host build, plain and poisoned, compiled side by side."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("tcp_frame_host")
    (d / "shim.cpp").write_text(SHIM)
    csrc = os.path.join(os.path.dirname(ts.__file__), "..", "csrc")
    builds = {"plain": (), "poison": ("-DSTT_TCP_FRAME_POISON",)}
    procs = {name: subprocess.Popen(
        [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", *flags, "-I", csrc,
         "-o", str(d / f"lib_{name}.so"), str(d / "shim.cpp")])
        for name, flags in builds.items()}
    out = {}
    for name, proc in procs.items():
        assert proc.wait() == 0, name
        lib = ctypes.CDLL(str(d / f"lib_{name}.so"))
        tsk._declare(lib)
        tw._declare(lib)
        lib.stt_tcp_span_team.argtypes = [ctypes.c_int]
        lib.stt_tcp_frame_conns.restype = ctypes.c_longlong
        lib.stt_tcp_frame_gather.argtypes = [ctypes.c_void_p,
                                             ctypes.c_longlong,
                                             ctypes.c_void_p]
        lib.stt_tcp_frame_gather.restype = ctypes.c_longlong
        assert lib.stt_tcp_frame_poisoned() == (name == "poison")
        out[name] = lib
    return out


@pytest.fixture(scope="module")
def frame_conns(libs):
    return int(libs["plain"].stt_tcp_frame_conns())


@pytest.fixture(scope="module")
def cases(exports, frame_conns):  # noqa: F811
    """The exports the spans run from: (runner, numpy state, span args)."""
    lossy = exports["lossy"]
    return {"lossless": exports["lossless"], "lossy": lossy,
            "over_cap": (lossy[0], tcp_over_cap(lossy[1], frame_conns + 1),
                         lossy[2])}


EAGER = {}


def span(lib, cases, case, rounds):
    """A span of `rounds` from `case`: (state, scalars, span step)
    through the host build `lib`, or the eager loop's (None; run once a
    module)."""
    if lib is None and (case, rounds) in EAGER:
        return EAGER[case, rounds]
    runner, st_np, args = cases[case]
    fn = span_build(runner, lib)
    try:
        st, *rest = fn(tcp_device_state(runner, st_np), *args, rounds)
    finally:
        runner.span_factory = runner.window_factory = None
    if lib is None:
        EAGER[case, rounds] = (st, rest, fn.span)
    return st, rest, fn.span


def over_cap_conn(st_np, frame_conns):
    """The over-cap edit's server host and the conn past its frame."""
    host = st_np["c_host"]
    rows = np.bincount(host[host >= 0])
    h = int(np.flatnonzero(rows == frame_conns + 1)[0])
    return h, int(np.flatnonzero(host == h)[-1])


# ------------------------------------------------- 1-2. whole spans

@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("case", ["lossless", "lossy", "over_cap"])
@pytest.mark.parametrize("which", ["plain", "poison"])
def test_torch_tcp_frame_span_equals_eager(libs, cases, which, case,
                                           rounds):
    """A span of one or four rounds through the host build (plain, or
    with every gathered device word poisoned) equals the eager loop."""
    want = span(None, cases, case, rounds)
    st, rest, step = span(libs[which], cases, case, rounds)
    assert_same_span(want[:2], (st, rest))
    assert int(st["abort_code"]) == 0 and rest[2] == rounds
    assert step.calls == 1 and st["ks_spans"] == 1
    assert not any(bool((v == POISON).any()) for v in st.values()
                   if isinstance(v, torch.Tensor) and v.dtype == torch.int64)


def test_torch_tcp_frame_over_cap_conn_is_reached(cases, frame_conns):
    """The over-cap edit: the server serves kFrameConns + 1 conn rows, the
    last of them (past the frame) its busiest conn, which the span's law
    reads and writes (in device memory), as it does the framed ones."""
    runner, st_np, _args = cases["over_cap"]
    h, last = over_cap_conn(st_np, frame_conns)
    before = tcp_device_state(runner, st_np)
    after = span(None, cases, "over_cap", 4)[0]
    conn_cols = [k for k in after if k.startswith("c_")
                 and isinstance(after[k], torch.Tensor)
                 and after[k].dim() == 1]
    moved = [k for k in conn_cols if after[k][last] != before[k][last]]
    assert {"c_snduna", "c_segsrecv"} <= set(moved), moved
    framed = np.flatnonzero(st_np["c_host"] == h)[:frame_conns]
    assert any(bool((after[k][framed] != before[k][framed]).any())
               for k in conn_cols)


def test_torch_tcp_frame_poison_overwrites_what_it_gathers(libs, cases,
                                                           frame_conns):
    """One lane's gather in the poison build: its host words and each
    framed conn row's words (read-only ones too) are the poison in
    device memory; the conn row past the frame's cap and the other lanes'
    rows are not."""
    runner, st_np, (start, stop, _limit, runahead) = cases["over_cap"]
    h, last = over_cap_conn(st_np, frame_conns)
    st = tcp_device_state(runner, st_np)
    fn = build(runner, libs["poison"])
    fn.prepare(st)
    fn.step.begin(st)
    ptrs, _words = fn.step.table.fill(st, min(start + runahead, stop))
    rows = (ctypes.c_longlong * frame_conns)()
    n = libs["poison"].stt_tcp_frame_gather(ptrs, h, rows)
    framed = list(rows[:n])
    assert n == frame_conns and last not in framed
    assert framed == np.flatnonzero(st_np["c_host"] == h)[:n].tolist()
    other = 0 if h else 1
    for k in ("pkts_sent", "codel_bytes", "r1_bal", "ar_tseq", "h_fault",
              "eth_ip"):
        assert int(st[k][h]) == POISON and int(st[k][other]) != POISON, k
    assert (st["drop_causes"][h] == POISON).all()
    assert (st["app_sys"][h] == POISON).all()
    for k in ("c_snduna", "c_rcvnxt", "c_role", "c_cc", "rtx_pos",
              "op_len", "op_pos"):
        assert (st[k][framed] == POISON).all(), k
        assert int(st[k][last]) != POISON, k
    # The rows stay in device memory: never gathered.
    assert not (st["th_time"] == POISON).any()
    assert not (st["rtx_seq"] == POISON).any()
    runner.window_factory = None


# ------------------------------------------------- 3. an aborting lane

def _lanes_from(st, h):
    """Lane h's and every later lane's part of a span state: host-major
    rows h and after, the conn rows of those hosts."""
    H = st["now"].shape[0]
    conns = st["c_host"] >= h
    out = {}
    for k, v in st.items():
        if not isinstance(v, torch.Tensor) or k.startswith(("out_", "tr_")):
            continue
        if ts._is_conn_major(k):
            out[k] = v[conns]
        elif v.dim() >= 1 and v.shape[0] == H and not k.startswith("_"):
            out[k] = v[h:]
    return out


@pytest.mark.parametrize("which", ["plain", "poison"])
def test_torch_tcp_frame_aborting_lane_writes_back_eager_state(libs, cases,
                                                               frame_conns,
                                                               which):
    """The over-cap server's timer heap full: its first push overflows
    (AB_STRUCT, site 1) mid-window.  One window through the window
    kernel's host build gives the eager bits and site, and the server's
    lane and every later lane hold the eager window's state."""
    runner, st_np, (start, stop, _limit, runahead) = cases["over_cap"]
    h, _last = over_cap_conn(st_np, frame_conns)
    full = _heap_full(st_np)
    d = dict(st_np)
    for k in ("th_time", "th_seq", "th_valid"):
        d[k] = st_np[k].copy()
        d[k][h] = full[k][h]
    a, b, _it, _got = one_window(runner, d, min(start + runahead, stop),
                               libs[which])
    runner.window_factory = None
    assert int(a["abort_code"]) == int(b["abort_code"]) == AB_STRUCT
    assert int(a["abort_site"]) == int(b["abort_site"]) == 1
    want, have = _lanes_from(a, h), _lanes_from(b, h)
    bad = [k for k in want if not torch.equal(want[k], have[k])]
    assert bad == []
    before = tcp_device_state(runner, d)
    assert int(b["events_run"][h]) > int(before["events_run"][h])
