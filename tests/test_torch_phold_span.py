"""The PHOLD/udp-mesh device-span slice of the port against the JAX
package, at the reference gates' own shapes (tests/test_phold_span.py:
8 LPs, the 8-host mesh).  Exact everywhere: integer laws, byte traces.

1. Inputs: the port's PHOLD/mesh YAML generators and the engine-app
   spawn tuples of every UDP/PHOLD kind against the reference's.
2. SoA codec: span_export_phold -> the port's tensors -> back ->
   span_import_phold mid-run is a no-op, gated by the remaining trace.
3. The slice: PHOLD and udp-mesh through the reference's serial object
   path and through the port's Manager on the CPU with forced device
   spans: identical traces, syscall histograms, counters and stdout,
   no aborts, at least half the rounds on the device loop.
4. The fused schedule against the unfused reference schedule, and the
   router between the PHOLD and the TCP families.
5. (slow) One span of the JAX runner and of the port from the same
   exported state, output columns and per-stage counters compared.

Stop times: every case runs at the reference gate's own stop time
(no cut: the eager CPU loop skips idle stretches, so the CoDel-active
mesh's 60 s cost only its 3.9 s of traffic).
"""

import numpy as np
import pytest
import torch

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import Manager as JManager
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu.ops.phold_span import PholdSpanRunner as JRunner
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import Manager, run_simulation
from shadow_tpu_torch.ops.phold_span import (KS_CODEL, KS_INET_OUT,
                                             PholdSpanRunner,
                                             state_from_numpy,
                                             state_to_numpy)

CAPS = (PholdSpanRunner.CAP_I, PholdSpanRunner.CAP_T,
        PholdSpanRunner.CAP_R, PholdSpanRunner.CAP_S,
        PholdSpanRunner.CAP_C, PholdSpanRunner.CAP_P)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The eager loop runs thousands of small ops: one intra-op thread
    keeps the test workers from oversubscribing the cores (the engine
    runs its own threads beside them)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def phold_yaml(scheduler, n_hosts=8, n_init=3, mean="20000000",
               bw="1 Gbit", loss=0.0, stop="2s", seed=13, spans=None):
    """tests/test_phold_span.py phold_cfg as YAML (full-mesh peers)."""
    names = [f"lp{i:03d}" for i in range(n_hosts)]
    blocks = []
    for i, name in enumerate(names):
        args = " ".join(["7000", str(i), str(n_init), mean]
                        + [p for p in names if p != name])
        blocks.append(
            f"  {name}:\n    network_node_id: 0\n    processes:\n"
            f'      - {{ path: phold, args: "{args}", start_time: 100ms, '
            f"expected_final_state: running }}")
    loss_s = f" packet_loss {loss}" if loss else ""
    exp = f"  scheduler: {scheduler}\n"
    if spans:
        exp += f"  tpu_device_spans: {spans}\n"
    return (f"general: {{ stop_time: {stop}, seed: {seed} }}\n"
            f"network:\n  graph:\n    type: gml\n    inline: |\n"
            f'      graph [ node [ id 0 host_bandwidth_down "{bw}" '
            f'host_bandwidth_up "{bw}" ] edge [ source 0 target 0 '
            f'latency "5 ms"{loss_s} ] ]\n'
            f"experimental:\n{exp}hosts:\n" + "\n".join(blocks) + "\n")


def mesh_yaml(scheduler, seed=29, spans=None):
    """tests/test_phold_span.py mesh_cfg(n=8)."""
    from shadow_tpu_torch.tools.netgen import mesh_family_yaml
    return mesh_family_yaml(8, seed=seed, scheduler=scheduler,
                            device_spans=spans)


def codel_yaml(scheduler, spans=None):
    """tests/test_phold_span.py's CoDel-active mesh: fast up, slow
    down, sustained overload."""
    n, count, size = 10, 60, 900
    names = [f"m{i:02d}" for i in range(n)]
    blocks = []
    for name in names:
        peers = " ".join(p for p in names if p != name)
        blocks.append(
            f"  {name}:\n    network_node_id: 0\n    processes:\n"
            f'      - {{ path: udp-mesh, args: "9000 {count} {size} '
            f'{peers}", start_time: 100ms, expected_final_state: any }}')
    exp = f"  scheduler: {scheduler}\n  socket_send_buffer: 64 KiB\n"
    if spans:
        exp += f"  tpu_device_spans: {spans}\n"
    return ("general: { stop_time: 60s, seed: 41 }\n"
            "network:\n  graph:\n    type: gml\n    inline: |\n"
            '      graph [ node [ id 0 host_bandwidth_down "400 Kbit" '
            'host_bandwidth_up "10 Mbit" ] edge [ source 0 target 0 '
            'latency "10 ms" ] ]\n'
            f"experimental:\n{exp}hosts:\n" + "\n".join(blocks) + "\n")


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


def _stdout(m):
    return sorted((p.name, bytes(p.stdout))
                  for h in m.hosts for p in h.processes.values())


def _pair(make):
    """(reference serial run, the port's forced-device run on the CPU)."""
    m_ser, s_ser = jrun(JConfig.from_yaml_text(make("serial", None)))
    m_dev, s_dev = run_simulation(ConfigOptions.from_yaml_text(
        make("tpu", "force")), device="cpu")
    assert s_ser.ok and s_dev.ok
    return m_ser, s_ser, m_dev, s_dev


def _assert_device_spans(m_dev, s_dev):
    r = m_dev._dev_span
    assert r is not None and r.spans > 0, "device span never ran"
    assert r.aborts == 0, r.abort_kind_counts()
    assert r.rounds * 2 >= s_dev.rounds, \
        f"only {r.rounds}/{s_dev.rounds} rounds on device"
    # The law kernels' wrappers are called once per non-empty call site
    # pass, never more often than the stages that call them fire.
    assert 0 < r.ks_calls[0] <= r.ks_fires[KS_INET_OUT] \
        + r.ks_fires[KS_CODEL]
    assert 0 < r.ks_calls[1] <= r.ks_fires[KS_CODEL]
    assert m_dev._dev_span_tcp is None
    return r


# ---------------------------------------------------------------- inputs

GEN_CASES = [
    ("phold_yaml", (8,), {}),
    ("phold_yaml", (8192,), dict(n_init=1, mean_delay_ns=50_000_000,
                                 stop_time="0.3s", seed=13,
                                 scheduler="tpu", peers_per_host=64)),
    ("phold_yaml", (12,), dict(device_spans="force", bandwidth="10 Mbit",
                               latency="2 ms", peers_per_host=3)),
    ("mesh_family_yaml", (8,), {}),
    ("mesh_family_yaml", (24,), dict(scheduler="tpu", device_spans="off",
                                     loss=0.0, sbuf="64 KiB")),
    ("udp_mesh_yaml", (10,), {}),
    ("udp_mesh_yaml", (6,), dict(n_nodes=3, floods_per_host=2,
                                 experimental_extra={"runahead": "1 ms"},
                                 pcap_hosts=1, object_hosts=2,
                                 data_directory="d")),
    ("full_mesh_gml", (5,), dict(loss=0.0)),
]


@pytest.mark.parametrize("fn,args,kw", GEN_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(GEN_CASES)])
def test_torch_phold_generators_identical(fn, args, kw):
    from shadow_tpu.tools import netgen as jnetgen
    from shadow_tpu_torch.tools import netgen
    assert getattr(netgen, fn)(*args, **kw) == \
        getattr(jnetgen, fn)(*args, **kw)


@pytest.mark.parametrize("i,k", [(0, None), (5, 3), (9, 20)])
def test_torch_phold_args_identical(i, k):
    from shadow_tpu.tools.netgen import phold_args as jargs
    from shadow_tpu_torch.tools.netgen import phold_args
    names = [f"lp{j:04d}" for j in range(10)]
    assert phold_args(i, names, 2, 1000, k) == jargs(i, names, 2, 1000, k)


APP_CASES = [
    ("udp-flood", ["h1", "9000", "6", "600"]),
    ("udp-flood", ["h2", "9000", "6", "600", "250000"]),
    ("udp-flood", ["nohost", "9000", "6", "600"]),
    ("udp-sink", ["9000"]),
    ("udp-sink", ["9000", "6400"]),
    ("udp-mesh", ["9000", "30", "400", "h1", "h2"]),
    ("udp-mesh", ["9000", "30", "400", "h1", "nohost"]),
    ("udp-mesh", ["9000", "30", "400"]),
    ("udp-echo-server", ["7"]),
    ("udp-pinger", ["h0", "7", "5"]),
    ("udp-pinger", ["h0", "7"]),
    ("phold", ["7000", "1", "3", "20000000", "h0", "h2"]),
    ("phold", ["7000", "1", "3", "20000000"]),
    ("tgen-client", ["h0", "8080", "1000"]),
    ("tgen-server", ["8080"]),
]


@pytest.mark.parametrize("path,args", APP_CASES,
                         ids=[f"{p}-{i}" for i, (p, _a) in
                              enumerate(APP_CASES)])
def test_torch_engine_app_args_match_reference(path, args):
    from shadow_tpu.core.config import ProcessConfig as JProc
    from shadow_tpu.host.engine_app import engine_app_args as jargs
    from shadow_tpu.net.dns import Dns as JDns
    from shadow_tpu_torch.core.config import ProcessConfig
    from shadow_tpu_torch.host.engine_app import engine_app_args
    from shadow_tpu_torch.net.dns import Dns
    dns, jdns = Dns(), JDns()
    for i in range(3):
        dns.register(i, 0x0B000001 + i, f"h{i}")
        jdns.register(i, 0x0B000001 + i, f"h{i}")
    got = engine_app_args(ProcessConfig(path=path, args=args), dns)
    want = jargs(JProc(path=path, args=args), None, jdns)
    assert got == want


# ------------------------------------------------------------- SoA codec

class _CodecRoundTrip:
    """Device-span stand-in: export -> the port's tensors -> numpy ->
    import, then decline (as a transient miss, so the Manager re-probes
    after a short C++ span).  Any lossy field diverges the trace."""

    ineligible = 0
    last_transient = True
    last_was_cold = False

    def __init__(self, eng, runner):
        self.eng = eng
        self.runner = runner
        self.trips = 0

    def try_span(self, start, stop, limit, runahead, dynamic, max_rounds,
                 spec_mr=0):
        d = self.eng.span_export_phold(*CAPS)
        if d is None or isinstance(d, int):
            return None
        st_np = self.runner._to_arrays(d)
        st = state_from_numpy(st_np, "cpu")
        back = state_to_numpy(st)
        assert set(back) == set(st_np)
        for k, a in back.items():
            assert a.dtype == st_np[k].dtype and a.shape == st_np[k].shape
            np.testing.assert_array_equal(a, st_np[k])
        self.eng.span_import_phold(self.runner._from_arrays(back), *CAPS,
                                   None)
        self.trips += 1
        return None


@pytest.mark.parametrize("which", ["phold", "mesh"])
def test_torch_phold_codec_roundtrip_byte_identical(which):
    make = {"phold": lambda s, sp: phold_yaml(s, loss=0.05, stop="1s",
                                              spans=sp),
            "mesh": lambda s, sp: mesh_yaml(s, spans=sp)}[which]
    m_ser, s_ser = jrun(JConfig.from_yaml_text(make("serial", None)))
    mgr = Manager(ConfigOptions.from_yaml_text(make("tpu", "force")),
                  device="cpu")
    stub = _CodecRoundTrip(mgr.plane.engine, mgr.make_dev_span_runner())
    mgr._dev_span = stub
    s_dev = mgr.run()
    assert s_ser.ok and s_dev.ok
    assert stub.trips > 2, "round trip never became eligible"
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert _counters(s_ser) == _counters(s_dev)
    assert _stdout(m_ser) == _stdout(mgr)


# -------------------------------------------------------------- the slice

PHOLD_CASES = {
    "lossless": dict(),
    "lossy": dict(loss=0.05, stop="3s"),
    "token_bucket": dict(n_hosts=6, n_init=8, mean="100000",
                         bw="200 Kbit", stop="1s"),
    "burst_with_loss": dict(n_hosts=10, n_init=12, mean="1000000",
                            bw="10 Mbit", loss=0.01, stop="2s"),
}


@pytest.mark.parametrize("case", list(PHOLD_CASES))
def test_torch_phold_device_spans_match_serial(case):
    """The reference gates' PHOLD cases: serial object path vs the
    port's forced device spans on the CPU."""
    kw = PHOLD_CASES[case]
    m_ser, s_ser, m_dev, s_dev = _pair(
        lambda s, sp: phold_yaml(s, spans=sp, **kw))
    r = _assert_device_spans(m_dev, s_dev)
    assert r.family == 0
    assert m_ser.trace_lines() == m_dev.trace_lines()
    assert _hist(m_ser) == _hist(m_dev)
    assert _counters(s_ser) == _counters(s_dev)
    if "loss" in kw:
        assert s_ser.packets_dropped > 0, "lossy edge never dropped"
    if case == "token_bucket":
        assert s_dev.packets_sent > 2000


MESH_CASES = {"seed29": lambda s, sp: mesh_yaml(s, spans=sp),
              "seed63": lambda s, sp: mesh_yaml(s, seed=63, spans=sp),
              "codel_active": codel_yaml}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_torch_udp_mesh_device_spans_match_serial(case):
    """udp-mesh on the device loop: dual-thread apps, EAGAIN parks, wake
    ordering, loss draws, process exit and ordered stdout lines."""
    m_ser, s_ser, m_dev, s_dev = _pair(MESH_CASES[case])
    r = _assert_device_spans(m_dev, s_dev)
    assert r.family == 1
    assert s_dev.packets_dropped == s_ser.packets_dropped > 0
    assert m_ser.trace_lines() == m_dev.trace_lines()
    assert _hist(m_ser) == _hist(m_dev)
    assert _stdout(m_ser) == _stdout(m_dev)
    assert _counters(s_ser) == _counters(s_dev)
    if case == "codel_active":
        codel = sum(1 for ln in m_ser.trace_lines() if ln.endswith("codel"))
        assert codel > 1000, f"config no longer AQM-active ({codel})"


def test_torch_fused_vs_unfused_differential():
    """The fused schedule against the one-micro-op-per-iteration
    reference schedule: identical traces, histograms and counters,
    with fewer loop iterations on the fused side."""
    text = phold_yaml("tpu", n_hosts=6, n_init=2, stop="1s", spans="force")

    def run_with(fused):
        m = Manager(ConfigOptions.from_yaml_text(text), device="cpu")
        m._dev_span = m.make_dev_span_runner()
        m._dev_span.fused = fused
        return m, m.run()

    m_f, s_f = run_with(True)
    m_u, s_u = run_with(False)
    for m in (m_f, m_u):
        assert m._dev_span.spans > 0 and m._dev_span.aborts == 0
    assert m_f._dev_span.micro_iters < m_u._dev_span.micro_iters
    assert m_f.trace_lines() == m_u.trace_lines()
    assert _hist(m_f) == _hist(m_u)
    assert _counters(s_f) == _counters(s_u)


def test_torch_router_tcp_stream_goes_to_tcp_runner():
    """On a TCP stream the PHOLD export refuses structurally (one probe
    per run) and the TCP runner serves the spans."""
    from shadow_tpu_torch.tools.netgen import tcp_stream_yaml
    mgr, s = run_simulation(ConfigOptions.from_yaml_text(tcp_stream_yaml(
        16, loss=0.0, stop_time="500ms", seed=11, scheduler="tpu",
        device_spans="force")), device="cpu")
    assert s.ok
    ph, tcp = mgr._dev_span, mgr._dev_span_tcp
    assert ph.ineligible == 1 and ph.spans == 0 and ph.export_bytes == 0
    assert tcp is not None and tcp.spans > 0


def test_torch_router_phold_never_reaches_tcp_runner():
    mgr, s = run_simulation(ConfigOptions.from_yaml_text(
        phold_yaml("tpu", n_hosts=4, stop="500ms", spans="force")),
        device="cpu")
    assert s.ok and mgr._dev_span.spans > 0
    assert mgr._dev_span_tcp is None or mgr._dev_span_tcp.spans == 0


def test_torch_router_neither_family_runs_on_cpp_spans():
    """udp-flood/sink fits no device-span family: both runners report
    ineligible and the sim completes on the C++ path, trace-identical
    to the reference's serial run."""
    text = (
        "general: { stop_time: 2s, seed: 5 }\n"
        "network:\n  graph:\n    type: gml\n    inline: |\n"
        '      graph [ node [ id 0 host_bandwidth_down "1 Gbit" '
        'host_bandwidth_up "1 Gbit" ] edge [ source 0 target 0 '
        'latency "5 ms" ] ]\n'
        "experimental:\n  scheduler: {sched}\n{spans}hosts:\n"
        "  sink:\n    network_node_id: 0\n    processes:\n"
        '      - { path: udp-sink, args: ["9000", "6400"], '
        "expected_final_state: any }\n"
        "  src:\n    network_node_id: 0\n    processes:\n"
        '      - { path: udp-flood, args: [sink, "9000", "100", "64"], '
        "start_time: 100ms, expected_final_state: any }\n")
    m_ser, s_ser = jrun(JConfig.from_yaml_text(
        text.replace("{sched}", "serial").replace("{spans}", "")))
    mgr, s = run_simulation(ConfigOptions.from_yaml_text(
        text.replace("{sched}", "tpu").replace(
            "{spans}", "  tpu_device_spans: force\n")), device="cpu")
    assert s.ok
    assert mgr._dev_span.ineligible and mgr._dev_span.spans == 0
    assert mgr._dev_span_tcp.ineligible and mgr._dev_span_tcp.spans == 0
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert _counters(s_ser) == _counters(s)


# ----------------------------------------------------- one span, exactly

@pytest.mark.slow
@pytest.mark.parametrize("which", ["phold", "mesh"])
def test_torch_one_span_equals_jax_phold_runner(which):
    """One span of the JAX PholdSpanRunner and of the port from the same
    exported state: every output column and the per-stage fire/lane
    counters equal.  Slow: the JAX loop's XLA compile takes minutes on
    the CPU backend."""
    text = {"phold": phold_yaml("tpu", loss=0.05, spans="force"),
            "mesh": mesh_yaml("tpu", spans="force")}[which]
    jm = JManager(JConfig.from_yaml_text(text))
    jcaps = (JRunner.CAP_I, JRunner.CAP_T, JRunner.CAP_R, JRunner.CAP_S,
             JRunner.CAP_C, JRunner.CAP_P)
    assert jcaps == CAPS

    class Capture:
        """Takes the third in-domain export (mid-run) and declines as a
        transient miss, so the engine's C++ path runs on untouched."""
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
    assert cap.got is not None, "never reached the device-span domain"
    d, start, stop, limit, runahead = cap.got
    jr = jm.make_dev_span_runner()
    st_np = jr._to_arrays(d)
    P = st_np["peers"].shape[1]
    args = (start, stop, limit, runahead, 8)
    jr.kern = True  # build with the kernel observatory's stage counters
    fn = jr._build(P)
    out = fn(dict(st_np), jr._lat, jr._thr, jr._node, jr._ips_sorted,
             jr._ips_perm, np.uint32(jr._k[0]), np.uint32(jr._k[1]),
             np.int64(jr.bootstrap_end), np.int64(jr._pay), *args)
    (jst, jstart, jra, jrounds, jbusy, jpk, jbend, jit) = out
    assert int(jst["abort_code"]) == 0 and int(jrounds) > 0

    pr = PholdSpanRunner(jm.plane.engine, jr._lat, jr._thr, jr._node,
                         np.ascontiguousarray([h.ip for h in jm.hosts],
                                              dtype=np.uint32),
                         jm.config.general.seed,
                         jm.config.general.bootstrap_end_time_ns,
                         tracing=True, device="cpu")
    pr.family, pr._pay = jr.family, jr._pay
    st = state_from_numpy(st_np, "cpu")
    st.update(pr._statics_on_device())
    pst, pstart, pra, prounds, pbusy, ppk, pbend, pit = \
        pr._build()(st, jr._pay, *args)
    assert (pstart, pra, prounds, pbusy, ppk, pbend, pit) == tuple(
        int(v) for v in (jstart, jra, jrounds, jbusy, jpk, jbend, jit))
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
                np.asarray(v)[:n].astype(np.int64), pst[k][:n].numpy(),
                err_msg=k)
        elif k in p_np:
            np.testing.assert_array_equal(np.asarray(v), p_np[k],
                                          err_msg=k)
