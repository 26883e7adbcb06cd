"""The TCP window kernel's lane law (csrc/tcp_lane.cuh, the law
`stt_tcp_window` runs in each thread) built for the host with the system
C++ compiler and run over every lane in turn, held exactly against the
port's eager window (its plain version) and, through the port's
Manager, against the JAX package's serial path.

(a) One window from the same export, law vs eager window: every state
    column (conn-major ones without their trash row), the outbox and
    the trace in canonical order, `ks_fires`, `ks_lanes` and the
    micro-iterations; the 16-host stream lossless and at 2% loss, with
    tracing on and off, and a copy with down and link-down hosts
    (`h_fault`); then whole runs of several rounds, round ends
    included.  Across the cases every stage of the fused schedule
    fires.
(b) The abort rule: one case per cause (outbox, trace, timer heap,
    CoDel ring, bad conn, bad destination), each giving the eager
    loop's bits and site.
(c) The outbox and trace appends in shuffled orders: the round end and
    the canonical trace give the same state.
(d) A forced 16-host 2%-loss stream with the runner's window step
    swapped for the host-built law: the JAX package's serial run's
    trace, events and drops.
(e) The window's byte bound (`window_need_bytes`) on a window with
    nothing due and on a real one.

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
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import Manager
from shadow_tpu_torch.ops import tcp_span as ts
from shadow_tpu_torch.ops import tcp_window as tw
from shadow_tpu_torch.ops.span_mesh import AB_OUT, AB_STRUCT, AB_TRACE
from shadow_tpu_torch.tools.netgen import tcp_stream_yaml
from shadow_tpu_torch.tools.relay_cases import clone_state
from shadow_tpu_torch.tools.window_cases import (TCP_OUT_KEYS, TCP_TR_KEYS,
                                                 canon, capture_tcp_export,
                                                 tcp_device_state,
                                                 tcp_window_mismatch)

SHIM = r"""
#include <cstring>
#include "tcp_lane.cuh"
namespace tc = stt::tcp;
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
  tc::window_serial(o, p);
  return 0;
}
"""

STOP = "500ms"


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
    """tcp_lane.cuh built for the host with the system C++ compiler (the
    one the engine builds with), with the name functions the kernel's
    library exports."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("tcp_lane_host")
    (d / "shim.cpp").write_text(SHIM)
    csrc = os.path.join(os.path.dirname(ts.__file__), "..", "csrc")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    csrc, "-o", str(d / "libtcp_lane.so"),
                    str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libtcp_lane.so"))
    tw._declare(lib)
    return lib


class HostWindow:
    """The window step of a span build through the host build: the
    operand table filled by the kernel's own names (tw.TcpWindowTable,
    as the wrapper fills it on the card), every lane run in turn."""

    def __init__(self, lib, shape, params):
        self.lib = lib
        self.table = tw.TcpWindowTable(lib, shape, params)
        self.calls = 0

    def begin(self, st):
        self.table.begin(st)
        self.calls = 0

    def __call__(self, st, window_end):
        assert self.lib.stt_tcp_window(
            *self.table.fill(st, window_end), None) == 0
        self.calls += 1

    def end(self):
        return dict(self.table.end(), windows=self.calls, window_ms=0.0)


def host_factory(lib):
    return lambda shape, params: HostWindow(lib, shape, params)


def stream(scheduler, loss, spans=None, stop=STOP):
    return tcp_stream_yaml(16, nbytes=50_000_000, loss=loss, stop_time=stop,
                           seed=11, scheduler=scheduler,
                           device_spans=spans)


def port_manager(loss):
    """The port's Manager of the forced stream on the CPU, its engine
    running each round's hosts inline (`general.parallelism: 1`): the
    engine's worker pool (native/netplane.cpp run_hosts_mt) can miscount
    its workers when it grows mid-run, and the window law is the same at
    any engine thread count."""
    cfg = ConfigOptions.from_yaml_text(stream("tpu", loss, "force"))
    cfg.general.parallelism = 1
    return Manager(cfg, device="cpu")


# ------------------------------------------------------------ the exports

def capture(loss, caps=None):
    """The port's Manager on the CPU up to its first in-domain TCP
    export (the fleet mid-bulk, 270 ms in)."""
    return capture_tcp_export(port_manager(loss), 1, caps)


@pytest.fixture(scope="module")
def exports():
    return {"lossless": capture(0.0), "lossy": capture(0.02)}


def build(runner, lib=None, tracing=True):
    runner.tracing = tracing
    runner.window_factory = tw.eager_window if lib is None \
        else host_factory(lib)
    return runner._build()


def one_window(runner, st_np, window_end, lib, tracing=True):
    """One window from the export, eager and through the law: (eager
    state, law state, eager iterations, law counts)."""
    plain = build(runner, None, tracing)
    law = build(runner, lib, tracing)
    a = tcp_device_state(runner, st_np)
    b = tcp_device_state(runner, st_np)
    plain.prepare(a)
    it = plain.window_plain(a, window_end)
    law.prepare(b)
    law.step.begin(b)
    law.step(b, window_end)
    return a, b, it, law.step.end()


def _faults(st_np):
    """The export with a host down (bit 0: a tgen server, its arrivals
    dying at their instant, its timers discarded) and NIC links down
    (bit 1: the other server, whose sends die at egress, and a client,
    whose arrivals die)."""
    d = dict(st_np)
    fault = np.zeros_like(d["h_fault"])
    fault[[1, 3]] = 1
    fault[[0, 14]] = 2
    d["h_fault"] = fault
    return d


CASES = {"lossless": ("lossless", None), "lossy": ("lossy", None),
         "faults": ("lossless", _faults)}


def case_state(exports, case):
    src, edit = CASES[case]
    runner, st_np, args = exports[src]
    return runner, (st_np if edit is None else edit(st_np)), args


# Every stage of the fused schedule (the exchange is the round end's).
STAGES = [k for k in range(ts.KS_N) if k != ts.KS_EXCHANGE]
FIRED = {}


@pytest.mark.parametrize("tracing", [True, False], ids=["traced",
                                                         "untraced"])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_tcp_lane_law_one_window_equals_eager(host_lib, exports,
                                                    case, tracing):
    runner, st_np, (start, stop, _limit, runahead) = case_state(exports,
                                                                case)
    a, b, it, got = one_window(runner, st_np, min(start + runahead, stop),
                               host_lib, tracing)
    assert int(a["abort_code"]) == int(b["abort_code"]) == 0
    assert tcp_window_mismatch(a, b) == []
    assert got["iters"] == it > 0
    np.testing.assert_array_equal(got["fires"], a["ks_fires"])
    np.testing.assert_array_equal(got["lanes"], a["ks_lanes"])
    assert got["windows"] == 1
    # The law calls made in the lanes: a bucket charge per relay pass
    # with a packet, a CoDel head per relay-2 dequeue.
    lanes = a["ks_lanes"]
    assert 0 < got["calls"][0] <= lanes[ts.KS_INET_OUT] + lanes[ts.KS_CODEL]
    assert 0 < got["calls"][1] <= lanes[ts.KS_CODEL]
    FIRED[(case, tracing)] = {k for k in STAGES if a["ks_fires"][k]}
    if case == "faults":
        dc = a["drop_causes"] - torch.tensor(st_np["drop_causes"])
        assert int(dc[:, ts.TEL_HOST_DOWN].sum()) > 0
        assert int(dc[:, ts.TEL_LINK_DOWN].sum()) > 0


def test_torch_tcp_lane_law_cases_fire_every_stage(host_lib, exports):
    """The lossless window alone fires every stage of the schedule, the
    reassembly drain included; the lossy one every stage but the drain
    and the ack decision (every client holds a hole there, so no segment
    arrives in order)."""
    for case in ("lossless", "lossy"):
        if (case, True) not in FIRED:
            runner, st_np, (start, stop, _l, ra) = case_state(exports, case)
            a, *_ = one_window(runner, st_np, min(start + ra, stop),
                               host_lib)
            FIRED[(case, True)] = {k for k in STAGES if a["ks_fires"][k]}
    assert FIRED[("lossless", True)] == set(STAGES)
    assert FIRED[("lossy", True)] == set(STAGES) - {ts.KS_REASM, ts.KS_ACK}


@pytest.mark.parametrize("case", ["lossless", "lossy"])
def test_torch_tcp_lane_law_runs_equal_eager(host_lib, exports, case):
    """Whole runs of several rounds (round ends, the eager propagation
    and inbox merge, between the windows): the same output state,
    scalars, counters and micro-iterations."""
    runner, st_np, (start, stop, limit, runahead) = exports[case]
    outs = [build(runner, lib)(tcp_device_state(runner, st_np), start,
                               stop, limit, runahead, 8)
            for lib in (None, host_lib)]
    (a, *ra), (b, *rb) = outs
    assert ra == rb and ra[2] == 8, (ra, rb)  # rounds
    assert int(a["abort_code"]) == 0
    assert tcp_window_mismatch(a, b) == []
    for k in ("ks_fires", "ks_lanes"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert b["ks_windows"] == 8 and a["ks_windows"] == 0
    assert b["ks_calls"][0] > 0 and not a["ks_calls"].any()


# ------------------------------------------------------------ the aborts

def _far(st_np):
    return int(st_np["now"].max()) + (1 << 50)


def _heap_full(st_np):
    """Every lane's timer heap full (the new entries far in the future):
    the first push overflows (site 1)."""
    d = dict(st_np)
    tv = d["th_valid"]
    d["th_time"] = np.where(tv, d["th_time"], _far(st_np))
    d["th_seq"] = np.where(tv, d["th_seq"], 1 << 40)
    d["th_valid"] = np.ones_like(tv)
    return d


def _codel_full(st_np):
    """Every lane's CoDel ring (64 slots, under the 1,000-packet hard
    limit) one short of full, the inet-in relay held pending: the next
    arrival overflows (site 11)."""
    d = dict(st_np)
    d["cq_len"] = (d["cq_pos"] + 63).astype(d["cq_len"].dtype)
    d["r2_pending"] = np.ones_like(d["r2_pending"])
    return d


def _bad_conn(st_np):
    """Every conn's local port off by one: no delivered segment finds its
    conn (site 6)."""
    d = dict(st_np)
    d["c_lport"] = d["c_lport"] + 1
    return d


def _bad_dst(st_np):
    """Every queued egress segment addressed to an IP no host has: the
    first send finds no destination (site 4)."""
    d = dict(st_np)
    d["op_dip"] = np.full_like(d["op_dip"], 7)
    return d


ABORTS = {
    # cause: (case, runner caps, runner attributes, state edit, bits, site)
    "outbox": ("lossless", None, {"cap_out": 16 + 2}, None, AB_OUT, 0),
    "trace": ("lossless", None, {"cap_tr": 16 + 2}, None, AB_TRACE, 0),
    "timer_heap": ("lossless", None, {}, _heap_full, AB_STRUCT, 1),
    "codel_ring": ("lossy", {"CAP_CQ": 64}, {}, _codel_full, AB_STRUCT,
                   11),
    "bad_conn": ("lossless", None, {}, _bad_conn, AB_STRUCT, 6),
    "bad_dst": ("lossless", None, {}, _bad_dst, AB_STRUCT, 4),
}


@pytest.mark.parametrize("cause", list(ABORTS))
def test_torch_tcp_lane_law_abort_bits_equal_eager(host_lib, exports,
                                                   cause):
    """Each single-cause abort: the run through the law ends with the
    eager loop's abort bits and site, and only them."""
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
        for lib in (None, host_lib):
            out = build(runner, lib)(tcp_device_state(runner, st_np), start,
                                     stop, limit, runahead, 2)
            got.append((int(out[0]["abort_code"]),
                        int(out[0]["abort_site"])))
    finally:
        for k, v in saved.items():
            setattr(runner, k, v)
    assert got[0] == got[1] == (bits, site), got


# ------------------------------------------------------ the append order

def test_torch_tcp_append_order_is_erased_by_the_round_end(host_lib,
                                                           exports):
    """The lanes' outbox and trace appends in two shuffled orders (the
    kernel's slots follow its warps' claims, not the eager rank): after
    the eager round end the state, and the trace in canonical order, are
    the same, and equal the eager window's."""
    runner, st_np, (start, stop, _limit, runahead) = exports["lossy"]
    we = min(start + runahead, stop)
    a, b, _it, _got = one_window(runner, st_np, we, host_lib)
    fn = build(runner, host_lib)
    ends = []
    for seed in (None, 1, 2):
        c = clone_state(b)
        if seed is not None:
            rng = np.random.default_rng(seed)
            for prefix, keys in (("out_", TCP_OUT_KEYS),
                                 ("tr_", TCP_TR_KEYS)):
                n = int(c[f"{prefix}n"])
                perm = torch.from_numpy(rng.permutation(n))
                assert n > 2
                for k in keys:
                    c[f"{prefix}{k}"][:n] = c[f"{prefix}{k}"][:n][perm]
        ends.append((c, fn.round_end(c, we)))
    a_end = build(runner, None).round_end(a, we)
    for c, scalars in ends:
        assert scalars == a_end
        assert tcp_window_mismatch(a, c) == []
        np.testing.assert_array_equal(canon(c, "tr_", TCP_TR_KEYS, "tr_n"),
                                      canon(a, "tr_", TCP_TR_KEYS, "tr_n"))


# ------------------------------------------------- the whole simulation

def test_torch_tcp_lane_law_sim_matches_serial(host_lib):
    """The forced 16-host 2%-loss stream on the CPU with every window
    stepped by the host-built lane law: the JAX package's serial run's
    trace, events and drops, no abort, most rounds on the device."""
    m_ser, s_ser = jrun(JConfig.from_yaml_text(stream("serial", 0.02)))
    mgr = port_manager(0.02)
    r = mgr._dev_span_tcp = mgr.make_tcp_span_runner()
    r.window_factory = host_factory(host_lib)
    s_dev = mgr.run()
    assert s_ser.ok and s_dev.ok
    assert r.spans > 0 and r.aborts == 0, r.abort_kind_counts()
    assert r.rounds * 2 >= s_dev.rounds
    assert r.ks_windows == r.rounds and r.windows_all >= r.ks_windows
    assert r.micro_iters > 0 and r.ks_calls[0] > 0
    assert not r.ks_wall_s.any()  # no eager stage ran
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert s_ser.events == s_dev.events
    assert s_ser.packets_dropped == s_dev.packets_dropped > 0


# ------------------------------------------------- the operand table

def test_torch_tcp_window_operand_table_covers_the_loop(host_lib):
    """Every operand the kernel's table names is a column of the span
    state (or its own buffer), each written one is CARRIED, DERIVED or
    span-local, every read-only one STATIC, CARRIED or a span index, and
    the loop's constants are the kernel's."""
    ops = tw.parse_operands(host_lib.stt_tcp_operands().decode())
    keys = [o.key for o in ops]
    assert len(keys) == len(set(keys))
    span_local = ("out_", "tr_", "abort_")
    for o in ops:
        if o.key.startswith("win."):
            continue
        if o.written and not o.key.startswith(span_local):
            assert o.key in (ts.RESIDENT_CARRIED | ts.RESIDENT_DERIVED), \
                o.key
        if not o.written and not o.key.startswith("_"):
            assert o.key in (ts.RESIDENT_STATIC | ts.RESIDENT_CARRIED), \
                o.key
    assert {f"ar_{k}" for k in ts.PK_KEYS} <= set(keys)
    tw.check_consts(host_lib)


def test_torch_tcp_window_wrapper_refuses_cpu_tensors(exports):
    """On the CPU the runner steps the eager window; the kernel's wrapper
    never runs there (no silent fallback)."""
    runner, st_np, _args = exports["lossless"]
    runner.window_factory = None
    assert runner._build().step is None
    step = tw.TCP_WINDOW.bind(*runner._window_shape())
    with pytest.raises(ValueError, match="CUDA"):
        step.begin(tcp_device_state(runner, st_np))


# ------------------------------------------------- the byte bound

def test_torch_tcp_window_bound_counts_what_the_window_moves(host_lib,
                                                             exports):
    """A window with nothing due moves only every lane's busy/due test; a
    real window adds its dequeues, copies and changed words, and never
    reaches one read and one write of every operand."""
    runner, st_np, (start, stop, _limit, runahead) = exports["lossy"]
    law = build(runner, host_lib)
    H, T = len(st_np["now"]), runner.CAP_T
    for window_end, busy in ((start, False),
                             (min(start + runahead, stop), True)):
        st = tcp_device_state(runner, st_np)
        law.prepare(st)
        before = clone_state(st)
        law.step.begin(st)
        law.step(st, window_end)
        got = law.step.end()
        ops = law.step.table.ops
        need = tw.window_need_bytes(ops, before, st)
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
        moved = sum(int((st[k][:H] - before[k][:H]).sum()) if k != "op_pos"
                    else int((st[k][:-1] - before[k][:-1]).sum())
                    for k in ("ib_pos", "cq_pos", "op_pos"))
        assert need["copies"] == 8 * len(ts.PK_KEYS) * moved
        every = sum(st[o.key].numel() * st[o.key].element_size()
                    for o in ops if o.key in st)
        assert need["total"] < 2 * every
