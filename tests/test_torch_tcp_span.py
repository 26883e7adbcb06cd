"""The TCP device-span slice of the port against the JAX package.

1. Routing inputs and configs: the port's GML routing matrices, YAML
   generator and config refusals against the reference.
2. SoA codec: span_export_tcp -> the port's tensors -> back ->
   span_import_tcp mid-bulk is a no-op, gated by the remaining trace
   (mirrors tests/test_tcp_span.py's round trip with the port's codec).
3. The slice: the 16-host steady stream, lossless and lossy, through
   the reference's serial object path and through the port's Manager on
   the CPU with forced device spans — identical traces, events and
   drops, at least half the rounds stepped by the device loop.
4. (slow) One span of the JAX runner and of the port from the same
   exported state, output dicts and per-stage fire/lane counters
   compared exactly.
"""

import numpy as np
import pytest
import torch

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import Manager as JManager
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu.ops.tcp_span import TcpSpanRunner as JRunner
from shadow_tpu.tools.netgen import tcp_stream_yaml as j_yaml
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import Manager, run_simulation
from shadow_tpu_torch.net.graph import NetworkGraph, routing_arrays
from shadow_tpu_torch.ops.tcp_span import (TcpSpanRunner, state_from_numpy,
                                           state_to_numpy)
from shadow_tpu_torch.tools.netgen import tcp_stream_yaml

CAPS = (TcpSpanRunner.CAP_I, TcpSpanRunner.CAP_T, TcpSpanRunner.CAP_CQ,
        TcpSpanRunner.CAP_RT, TcpSpanRunner.CAP_RA, TcpSpanRunner.CAP_OP)
JCAPS = (JRunner.CAP_I, JRunner.CAP_T, JRunner.CAP_CQ, JRunner.CAP_RT,
         JRunner.CAP_RA, JRunner.CAP_OP)
# Cut from the reference gates' 2 s so the eager CPU loop stays short;
# the handshake prefix ends near 230 ms, so more than half the rounds
# still fall in the device-span domain.
STOP = "500ms"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The eager loop runs thousands of small ops: one intra-op thread
    keeps the test workers from oversubscribing the cores (the engine
    runs its own threads beside them)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _yaml(scheduler, loss, stop=STOP, spans=None, n_hosts=16):
    return tcp_stream_yaml(n_hosts, nbytes=50_000_000, loss=loss,
                           stop_time=stop, seed=11, scheduler=scheduler,
                           device_spans=spans)


# ---------------------------------------------------------------- inputs

@pytest.mark.parametrize("loss", [0.0, 0.02])
@pytest.mark.parametrize("spans", [None, "force"])
def test_torch_netgen_yaml_identical(loss, spans):
    assert tcp_stream_yaml(40, n_servers=5, loss=loss, device_spans=spans,
                           scheduler="tpu") == \
        j_yaml(40, n_servers=5, loss=loss, device_spans=spans,
               scheduler="tpu")


@pytest.mark.parametrize("gml", [
    "three_tier", "mesh", "stream"])
def test_torch_routing_arrays_match_reference(gml):
    from shadow_tpu.tools import netgen
    text = {"three_tier": netgen.three_tier_gml(2, 3, 6),
            "mesh": netgen.full_mesh_gml(5),
            "stream": j_yaml(4).split("inline: |\n")[1].split(
                "\nexperimental")[0]}[gml]
    lat, thr = routing_arrays(NetworkGraph.from_gml(text))
    jcfg = JConfig.from_yaml_text(
        "general: {stop_time: 1s}\nnetwork:\n  graph:\n    type: gml\n"
        "    inline: |\n" + "\n".join("      " + ln for ln in
                                      text.strip().splitlines())
        + "\nhosts:\n  h:\n    network_node_id: 0\n    processes: []\n")
    jm = JManager(jcfg)
    np.testing.assert_array_equal(lat, jm.graph.latency_ns)
    np.testing.assert_array_equal(thr, jm.loss_thresholds)


@pytest.mark.parametrize("patch,needle", [
    ("hosts:\n", "faults: [{at: 1s, kind: host_kill, host: h0}]\nhosts:\n"),
    ("experimental:\n", "experimental:\n  tpu_shards: 2\n"),
    ("experimental:\n", "experimental:\n  syscall_observatory: on\n"),
    ("experimental:\n",
     "experimental:\n  strace_logging_mode: deterministic\n"),
    # containment's quarantine and restart policies
    ("path: tgen-server", "on_failure: quarantine, path: tgen-server"),
    ("path: tgen-server", "on_failure: restart, path: tgen-server"),
    ("hosts:\n", "checkpoint: {at: [1s]}\nhosts:\n"),
])
def test_torch_config_refuses_unported_paths(patch, needle):
    text = _yaml("tpu", 0.0).replace(patch, needle, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ConfigOptions.from_yaml_text(text)


def test_torch_manager_needs_cuda_unless_cpu_is_asked():
    cfg = ConfigOptions.from_yaml_text(_yaml("tpu", 0.0, n_hosts=2))
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        Manager(cfg)
    assert Manager(cfg, device="cpu").device.type == "cpu"


# ------------------------------------------------------------- SoA codec

class _CodecRoundTrip:
    """Device-span stand-in: export -> the port's tensors -> numpy ->
    import, then report failure so the engine's C++ path serves the
    rounds.  Any lossy field diverges the downstream trace."""

    ineligible = 0
    last_transient = False
    last_was_cold = False

    def __init__(self, eng, runner):
        self.eng = eng
        self.runner = runner
        self.trips = 0

    def try_span(self, start, stop, limit, runahead, dynamic, max_rounds,
                 spec_mr=0):
        d = self.eng.span_export_tcp(*CAPS)
        if d is None or isinstance(d, int):
            self.last_transient = isinstance(d, int)
            return None
        st_np = self.runner._to_arrays(d)
        st = state_from_numpy(st_np, "cpu")
        back = state_to_numpy(st)
        assert set(back) == {k for k in st_np if k != "_n_conns"}
        for k, a in back.items():
            assert a.dtype == st_np[k].dtype and a.shape == st_np[k].shape
            np.testing.assert_array_equal(a, st_np[k])
        back["_n_conns"] = st["_n_conns"]
        self.eng.span_import_tcp(self.runner._from_arrays(back), *CAPS,
                                 None)
        self.trips += 1
        self.last_transient = False
        return None


@pytest.mark.parametrize("loss", [0.0, 0.02], ids=["lossless", "lossy"])
def test_torch_soa_codec_roundtrip_byte_identical(loss):
    m_ser, s_ser = jrun(JConfig.from_yaml_text(_yaml("serial", loss,
                                                     stop="1s")))
    mgr = Manager(ConfigOptions.from_yaml_text(
        _yaml("tpu", loss, stop="1s", spans="force")), device="cpu")
    eng = mgr.plane.engine
    stub = _CodecRoundTrip(eng, mgr.make_tcp_span_runner())
    mgr._dev_span_tcp = stub
    run_span = eng.run_span

    def capped(start, stop, limit, runahead, dynamic, max_rounds,
               nthreads):
        return run_span(start, stop, limit, runahead, dynamic,
                        min(max_rounds, 16), nthreads)

    class EngProxy:
        def __getattr__(self, k):
            return capped if k == "run_span" else getattr(eng, k)

    mgr.plane.engine = EngProxy()
    s_dev = mgr.run()
    assert s_ser.ok and s_dev.ok
    assert stub.trips > 0, "round trip never became eligible"
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert (s_ser.events, s_ser.packets_sent, s_ser.packets_dropped) == \
        (s_dev.events, s_dev.packets_sent, s_dev.packets_dropped)


# -------------------------------------------------------------- the slice

@pytest.mark.parametrize("loss", [0.0, 0.02], ids=["lossless", "lossy"])
def test_torch_device_spans_match_serial(loss):
    """The tentpole gate on the CPU: the reference's serial object path
    vs the port's forced device spans — byte-identical traces, equal
    events and drops, at least half the rounds on the device loop."""
    m_ser, s_ser = jrun(JConfig.from_yaml_text(_yaml("serial", loss)))
    mgr, s_dev = run_simulation(ConfigOptions.from_yaml_text(
        _yaml("tpu", loss, spans="force")), device="cpu")
    assert s_ser.ok and s_dev.ok
    r = mgr._dev_span_tcp
    assert r is not None and r.spans > 0, \
        f"device span never ran (aborts={r.aborts}, transient={r.over_caps})"
    assert r.aborts == 0, r.abort_kind_counts()
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert s_ser.events == s_dev.events
    assert s_ser.packets_dropped == s_dev.packets_dropped
    if loss:
        assert s_ser.packets_dropped > 0, "lossy edge never dropped"
    assert r.rounds * 2 >= s_dev.rounds, \
        f"only {r.rounds}/{s_dev.rounds} rounds on device"


# ----------------------------------------------------- one span, exactly

@pytest.mark.slow
def test_torch_one_span_equals_jax_runner():
    """One span of the JAX TcpSpanRunner and of the port from the same
    exported state: every output column equal.  Slow: the JAX loop's
    XLA compile takes minutes on the CPU backend."""
    jm = JManager(JConfig.from_yaml_text(_yaml("tpu", 0.02, stop="600ms",
                                               spans="force")))

    class Capture:
        """Takes the first in-domain export (mid-bulk) and declines, so
        the engine's C++ path runs on untouched."""
        ineligible = 0
        last_transient = last_was_cold = False
        got = None

        def try_span(self, start, stop, limit, runahead, dynamic,
                     max_rounds, spec_mr=0):
            d = jm.plane.engine.span_export_tcp(*JCAPS)
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
    fn = jr._build()
    out = fn(dict(st_np), jr._lat, jr._thr, jr._node, jr._ips_sorted,
             jr._ips_perm, np.uint32(jr._k[0]), np.uint32(jr._k[1]),
             np.int64(jr.bootstrap_end), *args)
    (jst, jstart, jra, jrounds, jbusy, jpk, jbend, _it) = out
    assert int(jst["abort_code"]) == 0 and int(jrounds) > 0

    pr = TcpSpanRunner(jm.plane.engine, jr._lat, jr._thr, jr._node, jm_ips(jm),
                       jm.config.general.seed,
                       jm.config.general.bootstrap_end_time_ns,
                       tracing=True, device="cpu")
    pr._CC = jr._CC
    # the export above used the reference's ring caps
    (pr.CAP_I, pr.CAP_T, pr.CAP_CQ, pr.CAP_RT, pr.CAP_RA,
     pr.CAP_OP) = jr._caps()
    st = state_from_numpy(dict(st_np, _n_conns=n_conns), "cpu")
    st.pop("_n_conns")
    st.update(pr._statics_on_device())
    pst, pstart, pra, prounds, pbusy, ppk, pbend, _pit = \
        pr._build()(st, *args)
    assert (pstart, pra, prounds, pbusy, ppk, pbend) == tuple(
        int(v) for v in (jstart, jra, jrounds, jbusy, jpk, jbend))
    # The per-stage counters: the same fires and lanes per stage.
    np.testing.assert_array_equal(pst["ks_fires"],
                                  np.asarray(jst["ks_fires"]))
    np.testing.assert_array_equal(pst["ks_lanes"],
                                  np.asarray(jst["ks_lanes"]))
    p_np = state_to_numpy(pst, keys=[k for k in jst
                                     if k in pst["_np_dtypes"]])
    n = int(jst["tr_n"])
    assert int(pst["tr_n"]) == n
    for k, v in jst.items():
        if k.startswith("tr_") and k != "tr_n":
            np.testing.assert_array_equal(
                np.asarray(v)[:n].astype(np.int64),
                pst[k][:n].numpy(), err_msg=k)
        elif k in p_np:
            np.testing.assert_array_equal(np.asarray(v), p_np[k],
                                          err_msg=k)


def jm_ips(jm):
    return np.ascontiguousarray([h.ip for h in jm.hosts], dtype=np.uint32)
