"""Span residency and the speculative overlap (ops/span_mesh.py) in the
port, against the JAX package.

1. A resident input equals a fresh engine export, column by column,
   after one clean span at an unchanged epoch: PHOLD, the udp-mesh and
   the 16-host TCP stream.
2. Residency engages across the router's adaptive-K spans, and the
   whole run stays byte-identical to the reference's serial path;
   a stale carry (any engine mutation since the import) is refused.
3. The overlapped pipeline: span_overlap on vs off vs the reference's
   serial run, byte-identical, with windows dispatched and landed; a
   forced rollback while windows are in flight; the landing law of
   `_take_inflight` (param drift refuses, epoch drift refuses as stale,
   observer reads do not); `auto` follows the Manager's device.
4. No stage writes a STATIC column: they are shared read-only by every
   dispatch and by the speculative window's clone.

Shapes are the reference gates' (tests/test_phold_span.py,
tests/test_overlap.py, tests/test_tcp_span.py), on the CPU.
"""

import numpy as np
import pytest
import torch

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import Manager, span_overlap_on
from shadow_tpu_torch.ops import phold_span, tcp_span
from shadow_tpu_torch.ops.span_mesh import SpecWindow
from shadow_tpu_torch.tools.netgen import mesh_family_yaml, tcp_stream_yaml

# Columns with dead entries: the rings (their packed import layout
# re-bases each at its head) and each relay's held packet (read only
# while valid).  Their live entries are compared through the engine.
LIVE_ONLY = ("rq_", "sq_", "cq_", "ib_", "th_", "op_", "rtx_", "ra_",
             "r1_pk_", "r2_pk_")
# Wait seqs are park order per host: the engine's import maps them into
# its global counter keeping each host's order, so they compare by order.
ORDER_ONLY = {"m_waitseq", "s_waitseq", "c_awaitseq", "park_ctr"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The eager loop runs thousands of small ops: one intra-op thread
    keeps the test workers from oversubscribing the cores (the engine
    runs its own threads beside them)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def phold_yaml(scheduler, n_hosts=8, n_init=3, mean="20000000", stop="1s",
               spans=None, overlap=None):
    """tests/test_overlap.py phold_cfg as YAML (full-mesh peers)."""
    names = [f"lp{i:03d}" for i in range(n_hosts)]
    blocks = []
    for i, name in enumerate(names):
        args = " ".join(["7000", str(i), str(n_init), mean]
                        + [p for p in names if p != name])
        blocks.append(
            f"  {name}:\n    network_node_id: 0\n    processes:\n"
            f'      - {{ path: phold, args: "{args}", start_time: 100ms, '
            f"expected_final_state: running }}")
    exp = f"  scheduler: {scheduler}\n"
    if spans:
        exp += f"  tpu_device_spans: {spans}\n"
    if overlap:
        exp += f"  span_overlap: {overlap}\n"
    return (f"general: {{ stop_time: {stop}, seed: 13 }}\n"
            f"network:\n  graph:\n    type: gml\n    inline: |\n"
            f'      graph [ node [ id 0 host_bandwidth_down "1 Gbit" '
            f'host_bandwidth_up "1 Gbit" ] edge [ source 0 target 0 '
            f'latency "5 ms" ] ]\n'
            f"experimental:\n{exp}hosts:\n" + "\n".join(blocks) + "\n")


def mesh_yaml(scheduler, spans=None, overlap=None):
    """tests/test_phold_span.py mesh_cfg(n=8)."""
    text = mesh_family_yaml(8, seed=29, scheduler=scheduler,
                            device_spans=spans)
    if overlap:
        text = text.replace("experimental:\n",
                            f"experimental:\n  span_overlap: {overlap}\n")
    return text


def tcp_yaml(scheduler, spans=None, overlap=None):
    """The 16-host lossy stream of tests/test_torch_tcp_span.py; the
    router's first window is 4 rounds, so the device stretch takes
    several adaptive-K spans."""
    text = tcp_stream_yaml(16, nbytes=50_000_000, loss=0.02,
                           stop_time="500ms", seed=11, scheduler=scheduler,
                           device_spans=spans)
    if spans:
        extra = "  dev_span_k_init: 4\n"
        if overlap:
            extra += f"  span_overlap: {overlap}\n"
        text = text.replace("experimental:\n", "experimental:\n" + extra)
    return text


FAMILIES = {"phold": (lambda *a, **k: phold_yaml(*a, n_hosts=6, n_init=2,
                                                 **k), "_dev_span"),
            "mesh": (mesh_yaml, "_dev_span"),
            "tcp": (tcp_yaml, "_dev_span_tcp")}


def _hist(m):
    out = {}
    for h in m.hosts:
        h.merge_native_counters()
        for k, v in h.syscall_counts.items():
            out[k] = out.get(k, 0) + v
    return out


def _counters(s):
    return (s.events, s.packets_sent, s.packets_recv,
            s.packets_dropped, s.syscalls)


def _port(text, runner_attr, guard=True, **runner_kw):
    """The port's Manager on the CPU with its span runner built up front,
    `runner_kw` set on it, and (with `guard`) every dispatch checked to
    leave each STATIC column, and the routing tensors, unwritten."""
    mgr = Manager(ConfigOptions.from_yaml_text(text), device="cpu")
    make = (mgr.make_dev_span_runner if runner_attr == "_dev_span"
            else mgr.make_tcp_span_runner)
    r = make()
    for k, v in runner_kw.items():
        setattr(r, k, v)
    setattr(mgr, runner_attr, r)
    if runner_attr == "_dev_span_tcp":
        mgr._dev_span = mgr.make_dev_span_runner()
        mgr._dev_span.ineligible = 1  # the TCP family directly
    if guard:
        _guard_statics(r)
    return mgr, r


def _guard_statics(r):
    """Wrap the runner's dispatch: after every span, each STATIC column
    and routing tensor is the very tensor the span was given, never
    written in place (its version counter unchanged)."""
    call = r._timed_call
    r.guarded = []

    def guarded(fn, st, *args):
        keys = [k for k in st if k in r.RESIDENT_STATIC
                or k in ("_lat", "_thr", "_node", "_ips_sorted",
                         "_ips_perm")]
        before = {k: (st[k], st[k]._version) for k in keys}
        out = call(fn, st, *args)
        st_out = out[0][0]
        bad = [k for k, (t, v) in before.items()
               if st_out[k] is not t or t._version != v]
        r.guarded.append((len(keys), bad))
        return out

    r._timed_call = guarded


def _park_order(st, is_tcp):
    """Each host's park order: which of the PHOLD host's two parked apps
    parked first, or the TCP host's parked connections in park order;
    and that the park counter is past every wait seq of its host."""
    if is_tcp:
        parked = np.flatnonzero(st["c_await"] != 0)
        host = st["c_host"][parked]
        seq = st["c_awaitseq"][parked]
        order = parked[np.lexsort((parked, seq, host))]
        assert (st["park_ctr"][host] > seq).all()
        return order.tolist()
    m, s = st["m_waitseq"], st["s_waitseq"]
    assert (st["park_ctr"] > np.maximum(m, s)).all()
    both = (st["m_waitmask"] != 0) & (st["s_waitmask"] != 0)
    return (np.flatnonzero(both).tolist(), (m <= s)[both].tolist())


class _Stop(Exception):
    """Ends a run once its check is done."""


# ------------------------------------------- 1. resident == fresh export

@pytest.mark.parametrize("family", list(FAMILIES))
def test_torch_resident_input_equals_fresh_export(family):
    """After one clean span, at the epoch its import left: the resident
    input rebuilt from the span's output on the card equals a fresh
    engine export — every column outside the rings exactly (STATIC and
    DERIVED ones included, trash rows aside), and the rings' live
    entries through the engine (importing the resident input and
    exporting again gives the export's bytes)."""
    make, attr = FAMILIES[family]
    mgr, r = _port(make("tpu", spans="force"), attr, guard=False)
    eng = mgr.plane.engine
    is_tcp = attr == "_dev_span_tcp"
    export = eng.span_export_tcp if is_tcp else eng.span_export_phold
    imp = eng.span_import_tcp if is_tcp else eng.span_import_phold
    to_np = tcp_span.state_to_numpy if is_tcp \
        else phold_span.state_to_numpy
    try_span = r.try_span
    seen = {}

    def checked(*a, **k):
        res = try_span(*a, **k)
        if res is None or res[0] == 0:
            return res
        assert r._res_st is not None
        assert r._res_token == eng.state_epoch()
        resident = r._resident_input(r._res_st)
        for k in r.RESIDENT_STATIC:
            assert resident[k] is r._static_cols[k]
        d0 = export(*r._caps())
        fresh = r.export_state()
        assert isinstance(fresh, dict)
        keys = list(fresh["_np_dtypes"])
        assert set(keys) <= set(resident)
        a, b = to_np(resident, keys), to_np(fresh, keys)
        flat = [k for k in keys
                if not k.startswith(LIVE_ONLY) and k not in ORDER_ONLY]
        for k in flat:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert _park_order(a, is_tcp) == _park_order(b, is_tcp)
        if is_tcp:
            a["_n_conns"] = r._n_conns
        imp(r._from_arrays(a), *r._caps(), None)
        d1 = export(*r._caps())
        assert set(d0) == set(d1)
        for k in set(d0) - ORDER_ONLY:
            assert d0[k] == d1[k], k
        seen.update(flat=len(flat), ring=len(keys) - len(flat),
                    keys=set(keys))
        raise _Stop

    r.try_span = checked
    with pytest.raises(_Stop):
        mgr.run()
    assert seen["flat"] > 20 and seen["ring"] > 10, seen
    # The three classes partition the codec's columns.  TCP: the codec's
    # connection count, a plain integer, is DERIVED, and so are the CoDel
    # drop-chain registers the port's loop sets itself at span entry.
    mod = tcp_span if is_tcp else phold_span
    static, derived, carried = (mod.RESIDENT_STATIC, mod.RESIDENT_DERIVED,
                                mod.RESIDENT_CARRIED)
    assert not (static & derived or static & carried or derived & carried)
    extra = {"_n_conns", "cd_chain", "cd_sniff"} if is_tcp else set()
    assert static | derived | carried == seen["keys"] | extra


# ------------------------------------------------- 2. residency engages

@pytest.fixture(scope="module")
def engaged():
    """Per family: the reference's serial run and the port's forced
    device spans with the overlap off (the CPU default) and on, every
    dispatch guarded (no STATIC column written)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for family, (make, attr) in FAMILIES.items():
            ref = jrun(JConfig.from_yaml_text(make("serial")))
            runs = {}
            for ov in ("off", "on"):
                mgr, r = _port(make("tpu", spans="force", overlap=ov),
                               attr)
                runs[ov] = (mgr, mgr.run(), r)
            out[family] = (ref, runs)
    finally:
        torch.set_num_threads(prev)
    return out


@pytest.mark.parametrize("family", ["phold", "tcp"])
def test_torch_residency_engages_and_matches_serial(engaged, family):
    """Adaptive-K spans reuse the previous span's output on the card
    (resident hits, one export), and the run is byte-identical to the
    reference's serial run: traces, syscall histograms, counters."""
    (m_ser, s_ser), runs = engaged[family]
    mgr, s_dev, r = runs["off"]
    assert s_ser.ok and s_dev.ok
    assert r.spans >= 2 and r.aborts == 0, (r.spans, r.abort_kind_counts())
    assert r.resident_hits >= r.spans - 1 - r.stale_drops > 0, \
        (r.resident_hits, r.spans, r.stale_drops)
    assert r.overlap_windows == 0
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert _hist(m_ser) == _hist(mgr)
    assert _counters(s_ser) == _counters(s_dev)
    d = mgr.dispatch_summary()[f"device_span_{family}"]
    assert d["resident_hits"] == r.resident_hits
    assert d["stale_drops"] == r.stale_drops
    assert d["overlap"]["windows"] == 0


def test_torch_residency_stale_carry_refused():
    """After ANY engine mutation since the import, the resident carry is
    refused (stale_drops) and a fresh export taken, never reused."""
    mgr, r = _port(phold_yaml("tpu", n_hosts=6, n_init=2, spans="force"),
                   "_dev_span", guard=False)
    s = mgr.run()
    assert s.ok and r.spans > 0 and r.resident_hits > 0
    assert r._res_st is not None
    eng = mgr.plane.engine
    e0 = eng.state_epoch()
    eng.set_tracing(0, True)
    assert eng.state_epoch() != e0
    assert eng.state_epoch() != r._res_token
    stale0, hits0 = r.stale_drops, r.resident_hits
    end = s.end_time_ns
    res = r.try_span(end, end, end, 1, False)
    assert res is not None and res[0] == 0
    assert r.stale_drops == stale0 + 1
    assert r.resident_hits == hits0


# -------------------------------------------------- 3. the overlap

@pytest.mark.parametrize("family", list(FAMILIES))
def test_torch_overlap_on_off_match_serial(engaged, family):
    """span_overlap on vs off vs the reference's serial run: traces,
    histograms and counters identical, with windows dispatched and
    landed on the on run and none on the off run; every launch of a
    window counted, its stage counters credited only on landing."""
    (m_ser, s_ser), runs = engaged[family]
    (m_off, s_off, r_off), (m_on, s_on, r_on) = runs["off"], runs["on"]
    assert s_on.ok and s_off.ok and r_on.aborts == 0
    assert r_on.overlap_windows > 0 and r_on.overlap_hits > 0, \
        r_on.overlap_summary()
    assert r_off.overlap_windows == 0
    assert m_ser.trace_lines() == m_on.trace_lines() == m_off.trace_lines()
    assert _hist(m_ser) == _hist(m_on) == _hist(m_off)
    assert _counters(s_ser) == _counters(s_on) == _counters(s_off)
    # committed work is the same either way; landed windows count as
    # resident dispatches
    assert (r_on.spans, r_on.rounds, r_on.micro_iters) == \
        (r_off.spans, r_off.rounds, r_off.micro_iters)
    np.testing.assert_array_equal(r_on.ks_fires, r_off.ks_fires)
    np.testing.assert_array_equal(r_on.ks_lanes, r_off.ks_lanes)
    assert r_on.overlap_refusals == 0
    np.testing.assert_array_equal(r_on.fires_all, r_on.ks_fires)
    assert r_on.resident_hits >= r_on.overlap_hits
    assert r_on._inflight is None
    fam = "tcp" if family == "tcp" else "phold"
    ov = m_on.dispatch_summary()[f"device_span_{fam}"]
    assert ov["overlap"] == r_on.overlap_summary()
    assert ov["overlap"]["windows"] == r_on.overlap_windows
    assert 0.0 <= ov["overlap"]["host_idle_frac"] <= 1.0
    assert 0.0 <= ov["overlap"]["device_idle_frac"] <= 1.0
    assert r_on.clone_bytes > 0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_torch_no_stage_writes_a_static_column(engaged, family):
    """Every dispatch of both runs (committed, aborted and speculative)
    left each STATIC column and routing tensor as it was given."""
    _ref, runs = engaged[family]
    for ov, (_m, _s, r) in runs.items():
        assert r.guarded, ov
        for n_keys, bad in r.guarded:
            assert n_keys == len(r.RESIDENT_STATIC) + 5
            assert not bad, (ov, bad)


def test_torch_overlap_forced_rollback():
    """Rollback mid-pipeline: an under-sized trace buffer aborts spans
    while windows are in flight; the grow/retry path re-exports, and the
    run stays byte-identical to the serial one."""
    kw = dict(n_hosts=8, n_init=12, mean="500000", stop="300ms")
    m_ser, s_ser = jrun(JConfig.from_yaml_text(phold_yaml("serial", **kw)))
    mgr, r = _port(phold_yaml("tpu", spans="force", overlap="on", **kw),
                   "_dev_span", cap_tr=4096)
    s = mgr.run()
    assert s.ok and r.spans > 0
    assert r.rollback_wall_ns > 0 and r.rolled_back_rounds > 0, \
        "the trace buffer never forced a rollback"
    assert r.cap_tr > 4096
    assert r.overlap_windows > 0 and r.overlap_hits > 0, \
        r.overlap_summary()
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert _hist(m_ser) == _hist(mgr)
    assert _counters(s_ser) == _counters(s)
    for _n, bad in r.guarded:
        assert not bad, bad


def test_torch_refused_window_leaves_the_carry():
    """Every window refused (its max rounds one more than the next
    dispatch asks for): each refused window ran on a clone, so the
    resident carry the next dispatch falls back on is untouched and the
    run stays byte-identical to the serial one; the refused windows'
    launches count in `fires_all`, their stage counters nowhere."""
    kw = dict(n_hosts=6, n_init=2)
    m_ser, s_ser = jrun(JConfig.from_yaml_text(phold_yaml("serial", **kw)))
    mgr, r = _port(phold_yaml("tpu", spans="force", overlap="on", **kw),
                   "_dev_span")
    try_span = r.try_span

    def skewed(start, stop, limit, runahead, dynamic, max_rounds=None,
               spec_mr=0):
        return try_span(start, stop, limit, runahead, dynamic, max_rounds,
                        spec_mr + 1 if spec_mr else 0)

    r.try_span = skewed
    s = mgr.run()
    assert s.ok and r.aborts == 0
    assert r.overlap_refusals >= 1 and r.overlap_stale == 0, \
        r.overlap_summary()
    assert r.resident_hits >= r.spans - 1
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert _hist(m_ser) == _hist(mgr)
    assert _counters(s_ser) == _counters(s)
    assert (r.fires_all > r.ks_fires).any()
    assert (r.fires_all >= r.ks_fires).all()


def test_torch_take_inflight_refusals():
    """The landing law: a window lands only when its params match AND
    the engine epoch is the one stamped at commit.  Param drift
    refuses; epoch drift refuses as stale; a refused window is joined
    and discarded; observer reads of the engine do not refuse."""
    mgr, r = _port(phold_yaml("tpu", spans="force"), "_dev_span",
                   guard=False)
    eng = mgr.plane.engine
    params = (1, 2, 3, 4, False, 8)
    jobs = []

    def seed(epoch):
        job = SpecWindow(lambda: (({"ks_fires": np.ones(phold_span.KS_N,
                                                        np.int64)},), 0,
                                  0.0))
        jobs.append(job)
        rec = r._speculate_record(job, params)
        rec["epoch"] = epoch
        r._inflight = rec
        return rec

    rec = seed(eng.state_epoch())
    assert r._take_inflight(params) is rec
    assert r._inflight is None and r.overlap_hits == 1
    assert r.resident_hits == 1
    # param drift: refused, not stale
    seed(eng.state_epoch())
    assert r._take_inflight((1, 2, 3, 4, False, 16)) is None
    assert r._inflight is None
    assert (r.overlap_refusals, r.overlap_stale) == (1, 0)
    # epoch drift: any engine mutation between commit and landing
    seed(eng.state_epoch())
    eng.set_tracing(0, True)
    assert r._take_inflight(params) is None
    assert (r.overlap_refusals, r.overlap_stale) == (2, 1)
    seed(eng.state_epoch())
    eng.set_dctcp_k(21, 31000)
    assert r._take_inflight(params) is None
    assert r.overlap_stale == 2
    eng.set_dctcp_k(20, 30000)
    # observer reads between commit and landing do not refuse
    rec = seed(eng.state_epoch())
    eng.trace_entries(0)
    eng.pcap_take(0)
    assert r._take_inflight(params) is rec
    # every window was joined, and each one's launches counted
    for job in jobs:
        job._thread.join(timeout=10)
        assert not job._thread.is_alive()
    assert r.fires_all.sum() == len(jobs) * phold_span.KS_N
    assert r.overlap_hits == 2 and r.ks_fires.sum() == 0


def test_torch_span_overlap_follows_the_device():
    """`auto` speculates on the card only; on/off are what they say; the
    config accepts `span_overlap: on` and the Manager resolves it."""
    for dev in ("cpu", torch.device("cpu")):
        assert span_overlap_on("auto", dev) is False
    for dev in ("cuda", torch.device("cuda"), "cuda:0"):
        assert span_overlap_on("auto", dev) is True
    for dev in ("cpu", "cuda"):
        assert span_overlap_on("on", dev) is True
        assert span_overlap_on("off", dev) is False
    for mode, want in (("auto", False), ("on", True), ("off", False)):
        mgr = Manager(ConfigOptions.from_yaml_text(
            phold_yaml("tpu", n_hosts=2, spans="force", overlap=mode)),
            device="cpu")
        assert mgr._span_overlap_on() is want
        assert mgr.make_dev_span_runner().overlap is want
        assert mgr.make_tcp_span_runner().overlap is want
