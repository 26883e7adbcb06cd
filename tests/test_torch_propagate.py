"""The per-round propagation slice of the port against the JAX package.

1. The plain law (`propagate_ref`) against the reference's jitted
   kernel (`build_propagate_kernel`) on numpy-seeded columns: the 3-tier
   graph's matrices (V = 3) and random V = 16 matrices with unreachable
   pairs and zero and full thresholds, n = 0, 1 and ragged sizes,
   control lanes, `bootstrap_end` on both sides.  Integer law: exact
   equality on every valid lane and for both minima.
2. The kernel's lane code (csrc/propagate_law.cuh, plain C++ apart from
   its qualifiers) built for the host with the system C++ compiler and
   held against `propagate_ref`, its threefry against the reference's
   `threefry2x32_np`, on the same lanes.  `stt_propagate` itself is
   held against `propagate_ref` on the card by chip_smoke.py.
3. The port's `DeviceRouteModel` against the reference's on scripted
   decide / record / probe sequences with a stubbed clock: identical
   decisions and backoff state.
4. The reference gate config (tests/test_parity_tpu.py MULTI_NODE)
   through the port on the CPU, forced (`tpu_min_device_batch: 0`) and
   auto, for seeds 1, 11, 99 and the bootstrap variant: trace lines
   equal to the reference's serial run and its forced device run.
5. A 200-host shape of the reference bench's 10k config: forced,
   host-only and auto traces identical; the three bench generators
   pinned against bench.py's dicts.
6. No fallback: a CPU tensor never reaches the kernel, a failed probe is
   re-raised, and an entry point without `device="cpu"` raises here.
"""

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu.core.rng import threefry2x32_np
from shadow_tpu.ops import propagate as jprop
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import run_simulation
from shadow_tpu_torch.core.simtime import TIME_NEVER
from shadow_tpu_torch.net.graph import routing_arrays
from shadow_tpu_torch.ops import propagate as prop
from shadow_tpu_torch.tools import netgen
from test_parity_tpu import MULTI_NODE

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread_fresh_floor():
    """One intra-op thread (the engine runs its own threads beside it),
    and the port's process-wide route floor reset per test, as the
    reference's conftest resets its own."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    prop.DeviceRouteModel.reset_shared()
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------
# 1-2. The law
# ---------------------------------------------------------------------

def _matrices(v: int, seed: int = 3):
    """V = 3: the reference bench's 3-tier graph; else random latencies
    with unreachable (TIME_NEVER) pairs and thresholds that include 0
    (never lost) and 2**32 (always lost)."""
    if v == 3:
        cfg = ConfigOptions.from_yaml_text(netgen.tier10k_yaml(
            stop_s=1, n_hosts=20))
        return routing_arrays(cfg.network.graph)
    rng = np.random.default_rng(seed)
    lat = rng.integers(1, 80_000_000, (v, v), dtype=np.int64)
    lat[rng.random((v, v)) < 0.15] = TIME_NEVER
    thr = rng.integers(0, 1 << 32, (v, v), dtype=np.int64)
    thr[rng.random((v, v)) < 0.2] = 0
    thr[rng.random((v, v)) < 0.1] = 1 << 32
    return lat, thr


def _columns(n: int, v: int, seed: int):
    """One round's columns as export_round gives them: source hosts past
    2**32 (the key truncates them), every pkt_seq bit pattern, ~20%
    control packets, send times spread around 5 s."""
    rng = np.random.default_rng(seed)
    return dict(
        src_node=rng.integers(0, v, n).astype(np.int32),
        dst_node=rng.integers(0, v, n).astype(np.int32),
        src_host=rng.integers(0, 1 << 34, n, dtype=np.int64),
        pkt_seq=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32),
        t_send=rng.integers(0, 10_000_000_000, n, dtype=np.int64),
        is_ctl=rng.random(n) < 0.2)


def _port(lat, thr, k0, k1, c, window_end, bootstrap_end):
    c = dict(c, pkt_seq=c["pkt_seq"].view(np.int32))  # the u32 bits
    t = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in c.items()}
    return prop.PROPAGATE(
        torch.from_numpy(lat), torch.from_numpy(thr), k0, k1,
        t["src_node"], t["dst_node"], t["src_host"], t["pkt_seq"],
        t["t_send"], t["is_ctl"], window_end, bootstrap_end)


KEYS = (0x9E3779B9, 0x7F4A7C15)


@pytest.mark.parametrize("v", [3, 16])
@pytest.mark.parametrize("n", [0, 1, 257, 1000, 3001])
@pytest.mark.parametrize("bootstrap", ["before", "inside"])
def test_torch_propagate_ref_equals_jax_kernel(v, n, bootstrap):
    lat, thr = _matrices(v)
    c = _columns(n, v, seed=n + v)
    window_end = 5_000_000_000
    bootstrap_end = 0 if bootstrap == "before" else 5_000_000_000
    kernel = jprop.build_propagate_kernel(lat, thr, *KEYS)
    b = jprop._bucket(n)

    def pad(a):
        out = np.zeros(b, dtype=a.dtype)
        out[:n] = a
        return out

    valid = np.arange(b) < n
    want = kernel(pad(c["src_node"]), pad(c["dst_node"]),
                  pad(c["src_host"]), pad(c["pkt_seq"]), pad(c["t_send"]),
                  pad(c["is_ctl"]), valid, jnp.int64(window_end),
                  jnp.int64(bootstrap_end))
    got = _port(lat, thr, *KEYS, c, window_end, bootstrap_end)
    for name, g, w in zip(("deliver", "keep", "reachable", "lossy"), got,
                          want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:n],
                                      err_msg=name)
    assert got[4].tolist() == [int(want[4]), int(want[5])]
    if n >= 1000:
        # The cases are live: kept, lost and unreachable lanes all occur.
        keep, reach, lossy = (t.numpy() for t in got[1:4])
        assert keep.any() and lossy.any()
        assert (~reach).any() == (v == 16)


HOST_SHIM = r"""
#include <cstdint>
#include "propagate_law.cuh"

extern "C" void host_threefry(uint32_t k0, uint32_t k1, const uint32_t* c0,
                              const uint32_t* c1, int64_t n, uint32_t* x0,
                              uint32_t* x1) {
  for (int64_t i = 0; i < n; i++) {
    const stt::Threefry2x32 t = stt::threefry2x32(k0, k1, c0[i], c1[i]);
    x0[i] = t.x0;
    x1[i] = t.x1;
  }
}

// propagate.cu's lane loop, serially: clamp, gather, law, minima.
extern "C" void host_propagate(
    const int64_t* lat, const int64_t* thr, int64_t v, uint32_t k0,
    uint32_t k1, const int32_t* sn, const int32_t* dn, const int64_t* sh,
    const uint32_t* ps, const int64_t* ts, const uint8_t* ctl, int64_t n,
    int64_t window_end, int64_t bootstrap_end, int64_t time_never,
    int64_t* deliver, uint8_t* keep, uint8_t* reach, uint8_t* lossy,
    int64_t* mins) {
  mins[0] = mins[1] = INT64_MAX;
  for (int64_t i = 0; i < n; i++) {
    int64_t s = sn[i], d = dn[i];
    s = s < 0 ? 0 : (s >= v ? v - 1 : s);
    d = d < 0 ? 0 : (d >= v ? v - 1 : d);
    const stt::PropagateOut o = stt::propagate_lane(
        lat[s * v + d], thr[s * v + d], k0, k1, sh[i], ps[i], ts[i],
        ctl[i] != 0, window_end, bootstrap_end, time_never);
    deliver[i] = o.deliver;
    keep[i] = o.keep;
    reach[i] = o.reachable;
    lossy[i] = o.lossy;
    if (o.keep) {
      if (o.deliver < mins[0]) mins[0] = o.deliver;
      if (lat[s * v + d] < mins[1]) mins[1] = lat[s * v + d];
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_law(tmp_path_factory):
    """propagate_law.cuh built for the host with the system C++ compiler
    (the one the engine builds with)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("propagate_host")
    (d / "shim.cpp").write_text(HOST_SHIM)
    csrc = os.path.join(os.path.dirname(prop.__file__), "..", "csrc")
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    csrc, "-o", str(d / "libpropagate_host.so"),
                    str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libpropagate_host.so"))
    p, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
    lib.host_threefry.argtypes = [u32, u32, p, p, i64, p, p]
    lib.host_propagate.argtypes = [p, p, i64, u32, u32, p, p, p, p, p, p,
                                   i64, i64, i64, i64, p, p, p, p, p]
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


@pytest.mark.parametrize("v,n", [(3, 1), (3, 4099), (16, 2500)])
def test_torch_propagate_law_host_build_equals_plain(host_law, v, n):
    lat, thr = _matrices(v)
    c = {k: np.ascontiguousarray(a) for k, a in _columns(n, v, 7).items()}
    window_end, bootstrap_end = 5_000_000_000, 2_500_000_000
    # threefry: the header's against the reference's numpy form.
    c0 = (c["src_host"] & 0xFFFFFFFF).astype(np.uint32)
    x0, x1 = np.empty(n, np.uint32), np.empty(n, np.uint32)
    host_law.host_threefry(*KEYS, _ptr(c0), _ptr(c["pkt_seq"]), n, _ptr(x0),
                           _ptr(x1))
    w0, w1 = threefry2x32_np(np.uint32(KEYS[0]), np.uint32(KEYS[1]), c0,
                             c["pkt_seq"])
    np.testing.assert_array_equal(x0, w0)
    np.testing.assert_array_equal(x1, w1)
    # The lane law and the minima against the plain law.
    deliver = np.empty(n, np.int64)
    flags = [np.empty(n, np.uint8) for _ in range(3)]
    mins = np.empty(2, np.int64)
    ctl = c["is_ctl"].astype(np.uint8)
    host_law.host_propagate(
        _ptr(lat), _ptr(thr), v, *KEYS, _ptr(c["src_node"]),
        _ptr(c["dst_node"]), _ptr(c["src_host"]), _ptr(c["pkt_seq"]),
        _ptr(c["t_send"]), _ptr(ctl), n, window_end, bootstrap_end,
        TIME_NEVER, _ptr(deliver), *(_ptr(f) for f in flags), _ptr(mins))
    want = _port(lat, thr, *KEYS, c, window_end, bootstrap_end)
    np.testing.assert_array_equal(deliver, want[0].numpy())
    for f, w in zip(flags, want[1:4]):
        np.testing.assert_array_equal(f.astype(bool), w.numpy())
    assert mins.tolist() == want[4].tolist()


def test_torch_propagate_wrapper_never_launches_on_cpu_tensors():
    """The kernel takes CUDA tensors only; a CPU tensor handed to the
    launch raises instead of running anything, and the call path gives
    CPU tensors the plain law without counting a launch."""
    lat, thr = _matrices(3)
    c = _columns(10, 3, 1)
    c["pkt_seq"] = c["pkt_seq"].view(np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(c[k])) for k in
         ("src_node", "dst_node", "src_host", "pkt_seq", "t_send",
          "is_ctl")]
    with pytest.raises(ValueError, match="CUDA tensor"):
        prop.PROPAGATE.launch(torch.from_numpy(lat), torch.from_numpy(thr),
                              *KEYS, *t, 0, 0)
    n0 = (prop.PROPAGATE.launches, prop.PROPAGATE.probe_launches)
    _port(lat, thr, *KEYS, c, 0, 0)
    assert (prop.PROPAGATE.launches, prop.PROPAGATE.probe_launches) == n0


# ---------------------------------------------------------------------
# 3. The route law
# ---------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.ns = 10**9

    def __call__(self):
        return self.ns


def _route_state(m) -> tuple:
    return (m.host_ns_per_pkt, dict(m._dev_ns_by_bucket),
            dict(m._probe_countdown), dict(m._probe_interval),
            set(m._compiled), m.dev_floor_ns, m.probe_spent_ns)


@pytest.mark.parametrize("min_batch", [0, 100, 2048])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_torch_route_model_equals_reference(monkeypatch, min_batch, seed):
    """The same script through both models, op by op: decisions,
    measured-winning answers, backoff state and the shared floor."""
    clock = _Clock()
    monkeypatch.setattr("time.perf_counter_ns", clock)
    jprop.DeviceRouteModel.reset_shared()
    ref = jprop.DeviceRouteModel(min_batch)
    port = prop.DeviceRouteModel(min_batch)
    rng = np.random.default_rng(seed)
    decisions = []
    for _ in range(1500):
        clock.ns += int(rng.integers(0, 5_000_000))
        n = int(rng.choice([1, 50, 300, 2048, 5000, 70_000]))
        b = prop._bucket(n)
        assert b == jprop._bucket(n)
        op = rng.random()
        if op < 0.5:
            # The propagator's use: decide, then record what it ran.
            got, want = port.decide(n, b), ref.decide(n, b)
            assert got == want
            decisions.append(got)
            dt = float(rng.integers(1_000, 20_000_000))
            if got == prop.ROUTE_DEVICE:
                port.record_device(b, dt, n)
                ref.record_device(b, dt, n)
            else:
                if got == prop.ROUTE_PROBE and rng.random() < 0.8:
                    port.probe_started(b, n)
                    ref.probe_started(b, n)
                    pdt = float(rng.integers(1_000, 50_000_000))
                    port.record_device(b, pdt, n)
                    ref.record_device(b, pdt, n)
                port.record_host(dt / 4, n)
                ref.record_host(dt / 4, n)
        elif op < 0.7:
            dt = float(rng.integers(1_000, 50_000_000))
            port.record_device(b, dt, n)
            ref.record_device(b, dt, n)
        elif op < 0.8:
            port.probe_started(b, n)
            ref.probe_started(b, n)
        elif op < 0.9:
            dt = float(rng.integers(100, 2_000_000))
            port.record_host(dt, n)
            ref.record_host(dt, n)
        else:
            assert port.device_measured_winning(n) \
                == ref.device_measured_winning(n)
        assert _route_state(port) == _route_state(ref)
        assert prop.DeviceRouteModel._shared_floor \
            == jprop.DeviceRouteModel._shared_floor
    if min_batch:
        # The host route and at least one route to the device come up.
        assert prop.ROUTE_HOST in decisions and len(set(decisions)) >= 2
    else:
        assert set(decisions) == {prop.ROUTE_DEVICE}


# ---------------------------------------------------------------------
# 4. The reference gate config through the port
# ---------------------------------------------------------------------

def _multi(seed: int, bootstrap: bool) -> str:
    text = MULTI_NODE.format(scheduler="{scheduler}", seed=seed)
    if bootstrap:
        text = text.replace(
            f"general: {{ stop_time: 20s, seed: {seed} }}",
            f"general: {{ stop_time: 20s, seed: {seed}, "
            f"bootstrap_end_time: 15s }}")
        assert "bootstrap_end_time" in text
    return text


def _jax_lines(text: str, scheduler: str, min_batch=None):
    cfg = JConfig.from_yaml_text(text.replace("{scheduler}", scheduler))
    if min_batch is not None:
        cfg.experimental.tpu_min_device_batch = min_batch
    m, s = jrun(cfg)
    assert s.ok
    return m.trace_lines()


def _port_run(text: str, min_batch: int):
    cfg = ConfigOptions.from_yaml_text(text.replace("{scheduler}", "tpu"))
    cfg.experimental.tpu_min_device_batch = min_batch
    m, s = run_simulation(cfg, device="cpu")
    assert s.ok
    return m, s


@pytest.mark.parametrize("seed,bootstrap", [(1, False), (11, False),
                                            (99, False), (5, True)])
def test_torch_multi_node_forced_and_auto_equal_reference(seed, bootstrap):
    text = _multi(seed, bootstrap)
    serial = _jax_lines(text, "serial")
    assert len(serial) > 100
    assert _jax_lines(text, "tpu", min_batch=0) == serial
    assert any("inet-loss" in ln for ln in serial) != bootstrap
    m, s = _port_run(text, 0)
    p = m.propagator
    assert m.trace_lines() == serial
    # Forced: every round with packets went through the kernel's law,
    # none through the C++ twin, and no span ran.
    assert p.rounds_device == p.rounds_dispatched > 0
    assert p.route.host_ns_per_pkt is None
    assert s.span_rounds == 0
    assert p.packets_batched == p.packets_device == s.packets_sent
    m, s = _port_run(text, 2048)
    assert m.trace_lines() == serial
    assert m.propagator.rounds_device == 0 and s.span_rounds > 0


def test_torch_probe_runs_and_failure_is_reraised(monkeypatch):
    """With every round big enough to probe, the route model's probes
    run on the worker thread and the traces stay the reference's; a
    probe whose dispatch fails makes the run raise, not go quiet."""
    text = _multi(11, False)
    serial = _jax_lines(text, "serial")
    m, _s = _port_run(text, 1)
    p = m.propagator
    assert m.trace_lines() == serial
    assert p.probes_async >= 1

    def boom(*a, **k):
        raise RuntimeError("launch refused")

    monkeypatch.setattr(prop.Propagate, "__call__", boom)
    with pytest.raises(RuntimeError, match="probe failed"):
        _port_run(text, 1)


def test_torch_entry_point_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = ConfigOptions.from_yaml_text(
        _multi(11, False).replace("{scheduler}", "tpu"))
    cfg.experimental.tpu_min_device_batch = 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_simulation(cfg)


# ---------------------------------------------------------------------
# 5. The 3-tier shape and the bench generators
# ---------------------------------------------------------------------

def test_torch_tier_shape_forced_host_only_auto_identical():
    """bench.py config_10k's graph, apps and stagger at 200 hosts (10
    relays, 190 clients), to 2 s: the twin alone, forced and auto give
    one trace; in the forced run every round's packets went through the
    law."""
    runs = {}
    for name, mdb in (("host-only", 1 << 40), ("forced", 0),
                      ("auto", 2048)):
        cfg = ConfigOptions.from_yaml_text(netgen.tier10k_yaml(
            stop_s=2, n_hosts=200,
            experimental_extra={"tpu_min_device_batch": mdb}))
        m, s = run_simulation(cfg, device="cpu")
        lines = m.trace_lines()
        runs[name] = (hashlib.sha256("\n".join(lines).encode()).hexdigest(),
                      (s.packets_sent, s.packets_recv, s.packets_dropped,
                       s.busy_end_ns), m, s, len(lines))
    assert runs["host-only"][4] > 10_000
    for name in ("forced", "auto"):
        assert runs[name][:2] == runs["host-only"][:2], name
    _, _, m, s, _ = runs["forced"]
    p = m.propagator
    assert p.rounds_device == p.rounds_dispatched > 0
    assert s.span_rounds == 0 and p.route.host_ns_per_pkt is None
    assert runs["host-only"][2].propagator.rounds_device == 0


def _bench_dict(fn_name: str, monkeypatch):
    """bench.py's config dict (bench.py imports only the stdlib at module
    level; its ConfigOptions.from_dict call is caught)."""
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(_ROOT, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    monkeypatch.setattr(JConfig, "from_dict",
                        classmethod(lambda cls, d, base_dir=".": d))
    return getattr(bench, fn_name)("tpu")


@pytest.mark.parametrize("fn_name,gen", [
    ("config_10k", netgen.tier10k_yaml), ("config3", netgen.tier1k_yaml),
    ("mesh_config", netgen.mesh100_yaml)])
def test_torch_bench_generators_pinned(monkeypatch, fn_name, gen):
    import yaml
    want = _bench_dict(fn_name, monkeypatch)
    got = yaml.load(gen("tpu"), Loader=getattr(yaml, "CSafeLoader",
                                               yaml.SafeLoader))
    assert got == want
