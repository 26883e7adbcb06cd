"""The per-round route of `stt_propagate_round` on the CPU: its plan, its
round buffer and its minima, against the JAX package.

1. The minima's combine (csrc/propagate_law.cuh `combine_minima`, what
   the kernel's last block folds), built for the host with the system
   C++ compiler, against `torch.min` over random per-block partials:
   blocks with no kept packet, an all-lossy round, one block, the
   kernel's largest grid, one rank and a block's worth of ranks.
2. The plan (csrc/propagate_plan.h `SttPropagatePlan`) from the same
   host build: its sizeof and every field's offsetof equal the
   `ctypes.Structure` mirror, and its grid cap and column count equal
   the wrapper's.
3. The round buffer's layout: the header's `stt_round_layout` equals
   `RoundStage.layout`, and every column lies aligned to its width,
   without overlap, at each capacity a stage grows through and at the
   copy threshold's n - 1, n and n + 1.
4. The zero-packet round through a stage.
5. A stage's rounds on numpy-seeded columns, packed as export_round
   gives them, against the reference's jitted `build_propagate_kernel`
   (shadow_tpu/ops/propagate.py:391) run on the CPU, one stage reused
   across growing and shrinking rounds.  Integer law: exact equality.
6. `TpuPropagator` through its stages at the 200-host shape of the
   reference bench's 10k config: forced, and auto with every round large
   enough to probe (the probe through a stage of its own), give the
   host-only twin's trace.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shadow_tpu.ops import propagate as jprop
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import run_simulation
from shadow_tpu_torch.core.simtime import TIME_NEVER
from shadow_tpu_torch.net.graph import routing_arrays
from shadow_tpu_torch.ops import propagate as prop
from shadow_tpu_torch.tools import netgen

I64_MAX = (1 << 63) - 1
KEYS = (0x9E3779B9, 0x7F4A7C15)


@pytest.fixture(autouse=True)
def _one_thread_fresh_floor():
    """One intra-op thread beside the engine's, and the route floor
    reset per test (no reads or writes of the user's cache)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    prop.DeviceRouteModel.reset_shared()
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------
# 1-3. The host build of the law's combine and of the plan header
# ---------------------------------------------------------------------

# The plan's fields in declaration order (the ctypes mirror's names).
PLAN_FIELDS = [name for name, _ in prop.Plan._fields_]
LAYOUT_FIELDS = ("src_host", "t_send", "src_node", "dst_node", "pkt_seq",
                 "is_ctl", "mins", "deliver", "keep", "reachable", "lossy",
                 "total")

HOST_SHIM = r"""
#include <cstddef>
#include <cstdint>
#include "propagate_law.cuh"
#include "propagate_plan.h"

// What one kernel grid settles: `ranks` threads of the last block each
// fold their stride of the partials, then the block folds the ranks'.
extern "C" void host_combine(const int64_t* part, int64_t blocks,
                             int64_t ranks, int64_t* mins) {
  int64_t min_d = INT64_MAX, min_l = INT64_MAX;
  for (int64_t r = 0; r < ranks; r++) {
    int64_t d = INT64_MAX, l = INT64_MAX;
    stt::combine_minima(part, blocks, r, ranks, d, l);
    stt::fold_minima(min_d, min_l, d, l);
  }
  mins[0] = min_d;
  mins[1] = min_l;
}

extern "C" void host_layout(int64_t n, int64_t* out) {
  const SttRoundLayout o = stt_round_layout(n);
  const int64_t v[] = {o.src_host, o.t_send, o.src_node, o.dst_node,
                       o.pkt_seq, o.is_ctl, o.mins, o.deliver, o.keep,
                       o.reachable, o.lossy, o.total};
  for (int i = 0; i < 12; i++) out[i] = v[i];
}

#define OFF(f) offsetof(SttPropagatePlan, f)
extern "C" void host_plan(int64_t* out) {
  const int64_t v[] = {
      OFF(lat), OFF(thr), OFF(v), OFF(k0), OFF(k1), OFF(bootstrap_end),
      OFF(time_never), OFF(buf_host), OFF(buf_mapped), OFF(buf_dev),
      OFF(cap), OFF(copy_min), OFF(cols), OFF(scratch), OFF(stream),
      OFF(events), OFF(wait_ns), OFF(device), OFF(time_every), OFF(calls),
      OFF(timed), OFF(kernel_ms), OFF(copied), OFF(pad),
      sizeof(SttPropagatePlan), STT_PROPAGATE_MAX_BLOCKS, STT_NCOLS};
  for (int i = 0; i < 27; i++) out[i] = v[i];
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """propagate_law.cuh and propagate_plan.h built for the host with the
    system C++ compiler (the one the engine builds with)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("propagate_round_host")
    (d / "shim.cpp").write_text(HOST_SHIM)
    csrc = os.path.join(os.path.dirname(prop.__file__), "..", "csrc")
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    csrc, "-o", str(d / "libround_host.so"),
                    str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libround_host.so"))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.host_combine.argtypes = [p, i64, i64, p]
    lib.host_layout.argtypes = [i64, p]
    lib.host_plan.argtypes = [p]
    return lib


def _partials(blocks: int, seed: int, empty: float):
    """Per-block partial minima as the kernel's blocks write them: a
    block whose packets were all lost or unreachable (fraction `empty`)
    holds INT64_MAX in both words."""
    rng = np.random.default_rng(seed)
    part = np.empty((blocks, 2), np.int64)
    part[:, 0] = rng.integers(0, 10_000_000_000, blocks, dtype=np.int64)
    part[:, 1] = rng.integers(1, 80_000_000, blocks, dtype=np.int64)
    part[rng.random(blocks) < empty] = I64_MAX
    return part


@pytest.mark.parametrize("blocks,ranks,empty", [
    (1, 1, 0.0), (1, 256, 0.0), (2, 256, 0.5), (7, 3, 0.3),
    (300, 256, 0.9), (prop.MAX_BLOCKS, 256, 0.2),
    (prop.MAX_BLOCKS, 1, 0.99), (64, 256, 1.0), (1, 256, 1.0)])
def test_torch_combine_minima_equals_torch_min(host_lib, blocks, ranks,
                                               empty):
    part = _partials(blocks, seed=blocks * 7 + ranks, empty=empty)
    got = np.empty(2, np.int64)
    host_lib.host_combine(part.ctypes.data, blocks, ranks, got.ctypes.data)
    want = torch.from_numpy(part).min(dim=0).values
    assert got.tolist() == want.tolist()
    if empty == 1.0:
        # An all-lossy round (no block kept a packet) keeps INT64_MAX,
        # which the propagator reads as "nothing in flight".
        assert got.tolist() == [I64_MAX, I64_MAX]


def test_torch_plan_header_equals_ctypes_mirror(host_lib):
    got = np.empty(27, np.int64)
    host_lib.host_plan(got.ctypes.data)
    assert len(PLAN_FIELDS) == 24
    offsets = got[:24].tolist()
    assert offsets == [getattr(prop.Plan, f).offset for f in PLAN_FIELDS]
    assert int(got[24]) == ctypes.sizeof(prop.Plan)
    assert int(got[25]) == prop.MAX_BLOCKS
    assert int(got[26]) == prop.N_COLS
    assert prop.Plan.cols.size == prop.N_COLS * ctypes.sizeof(
        ctypes.c_void_p)


def _copy_edges():
    c = prop.COPY_MIN_PACKETS
    return [c - 1, c, c + 1]


# The capacities a stage grows through up to the largest round chip_smoke
# runs (1,048,576 packets): its first buffer, doubled.
CAPS = [prop._MIN_CAP << k for k in range(9)]


def test_torch_stage_grows_by_doubling():
    """A stage grown one buffer's worth past each capacity in turn takes
    CAPS, each buffer the layout's size at its capacity."""
    stage = prop.RoundStage("cpu", None, None, KEYS, 0)
    caps = []
    for n in (1, *range(prop._MIN_CAP + 1, CAPS[-1] + 1, prop._MIN_CAP)):
        stage._ensure(n)
        if not caps or caps[-1] != stage.cap:
            caps.append(stage.cap)
            assert stage.buf.nbytes == stage.layout(stage.cap)["total"]
    assert caps == CAPS


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 7, 150, 1_000, 1_000_003,
                               *_copy_edges(), *CAPS])
def test_torch_round_layout_aligned(host_lib, n):
    want = prop.RoundStage.layout(n)
    got = np.empty(12, np.int64)
    host_lib.host_layout(n, got.ctypes.data)
    assert dict(zip(LAYOUT_FIELDS, got.tolist())) == want
    spans = sorted((want[c], want[c] + w * n, w)
                   for c, w in prop._WIDTH.items())
    spans.append((want["mins"], want["mins"] + 16, 8))
    spans.sort()
    for (lo, hi, w), (lo2, _, _) in zip(spans, spans[1:] + [(
            want["total"], 0, 0)]):
        assert lo % w == 0, (lo, w)
        assert hi <= lo2
    # The inputs are one copy in, the minima and outputs one copy out.
    assert max(want[c] + prop._WIDTH[c] * n for c in prop._INS) \
        <= want["mins"] < want["deliver"]
    assert want["lossy"] + n == want["total"]


# ---------------------------------------------------------------------
# 4-5. A stage's rounds against the reference's jitted kernel
# ---------------------------------------------------------------------

def _matrices(v: int, seed: int = 3):
    """V = 3: the reference bench's 3-tier graph; else random latencies
    with unreachable pairs and thresholds that include 0 and 2**32."""
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


def _export(n: int, v: int, seed: int):
    """One round's columns as export_round gives them: bytes of src_node,
    dst_node, dst_host (i32), src_host (i64), pkt_seq (u32), t_send (i64)
    and is_ctl (u8); and the same columns as numpy arrays."""
    rng = np.random.default_rng(seed)
    c = dict(
        src_node=rng.integers(0, v, n).astype(np.int32),
        dst_node=rng.integers(0, v, n).astype(np.int32),
        dst_host=rng.integers(0, 1000, n).astype(np.int32),
        src_host=rng.integers(0, 1 << 34, n, dtype=np.int64),
        pkt_seq=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32),
        t_send=rng.integers(0, 10_000_000_000, n, dtype=np.int64),
        is_ctl=(rng.random(n) < 0.2).astype(np.uint8))
    return tuple(c[k].tobytes() for k in prop._EXPORT), c


def _stage(v: int):
    lat, thr = _matrices(v)
    return prop.RoundStage("cpu", torch.from_numpy(lat),
                           torch.from_numpy(thr), KEYS, 0), lat, thr


def test_torch_zero_packet_round():
    stage, _lat, _thr = _stage(3)
    n0 = (prop.PROPAGATE.launches, prop.PROPAGATE.probe_launches)
    stage.pack(_export(0, 3, 1)[0], 0)
    stage.buf[:] = 0xAB  # the round must write its minima
    prop.PROPAGATE.round(stage, 0, 5_000_000_000)
    views, md, ml = stage.results(0)
    assert (md, ml) == (I64_MAX, I64_MAX)
    assert [len(v) for v in views] == [0, 0, 0, 0]
    # The plain law on the CPU is no launch.
    assert (prop.PROPAGATE.launches, prop.PROPAGATE.probe_launches) == n0


def test_torch_stage_refuses_a_short_column():
    stage, _lat, _thr = _stage(3)
    cols, _c = _export(100, 3, 2)
    short = (*cols[:3], cols[3][:-8], *cols[4:])
    with pytest.raises(ValueError):
        stage.pack(short, 100)


@pytest.mark.parametrize("v", [3, 16])
@pytest.mark.parametrize("bootstrap", ["before", "inside"])
def test_torch_stage_round_equals_jax_kernel(v, bootstrap):
    stage, lat, thr = _stage(v)
    window_end = 5_000_000_000
    bootstrap_end = 0 if bootstrap == "before" else 5_000_000_000
    stage.bootstrap_end = bootstrap_end
    kernel = jprop.build_propagate_kernel(lat, thr, *KEYS)
    # Growing past the first buffer, then a smaller round in it.
    for n in (1, 257, 5_000, 3_001):
        cols, c = _export(n, v, seed=n + v)
        stage.pack(cols, n)
        stage.buf[stage.layout(n)["mins"]:] = 0xAB  # stale results
        prop.PROPAGATE.round(stage, n, window_end)
        views, md, ml = stage.results(n)
        # scatter_round's buffers: u8 flags and i64 deliveries.
        assert [v.format for v in views] == ["B", "q", "B", "B"]
        keep, deliver, reach, lossy = (np.asarray(v) for v in views)
        b = jprop._bucket(n)

        def pad(a):
            out = np.zeros(b, dtype=a.dtype)
            out[:n] = a
            return out

        want = kernel(pad(c["src_node"]), pad(c["dst_node"]),
                      pad(c["src_host"]), pad(c["pkt_seq"]),
                      pad(c["t_send"]), pad(c["is_ctl"].astype(bool)),
                      np.arange(b) < n, jnp.int64(window_end),
                      jnp.int64(bootstrap_end))
        np.testing.assert_array_equal(deliver, np.asarray(want[0])[:n])
        for name, g, w in (("keep", keep, want[1]),
                           ("reachable", reach, want[2]),
                           ("lossy", lossy, want[3])):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g.astype(bool),
                                          np.asarray(w)[:n], err_msg=name)
        assert (md, ml) == (int(want[4]), int(want[5]))
        if n >= 3_000:
            # The cases are live: kept, lost and unreachable lanes occur.
            assert keep.any() and lossy.any()
            assert (reach == 0).any() == (v == 16)
    assert stage.cap == 2 * prop._MIN_CAP


# ---------------------------------------------------------------------
# 6. The propagator through its stages
# ---------------------------------------------------------------------

def _tier_run(min_batch: int):
    # Each run measures the CPU's floor afresh (a forced run's would keep
    # the auto run from probing).
    prop.DeviceRouteModel.reset_shared()
    cfg = ConfigOptions.from_yaml_text(netgen.tier10k_yaml(
        stop_s=2, n_hosts=200,
        experimental_extra={"tpu_min_device_batch": min_batch}))
    m, s = run_simulation(cfg, device="cpu")
    lines = m.trace_lines()
    digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()
    return digest, (s.packets_sent, s.packets_recv, s.packets_dropped,
                    s.busy_end_ns), m, s


# The auto run's measurements, fixed: the C++ twin at 1 ns a packet and
# every device dispatch at 1 s, so the stage loses at every round size
# whatever the machine's load.  The first probe of a run is allowed
# whatever the clock (an unmeasured cost counts as free, and nothing is
# spent yet); no measurement can route a round to the stage.
FIXED_HOST_NS_PER_PKT = 1
FIXED_DEVICE_NS = 1_000_000_000


def _fixed_measurements(monkeypatch):
    record_host = prop.DeviceRouteModel.record_host
    record_device = prop.DeviceRouteModel.record_device

    def host(self, dt_ns, n):
        record_host(self, FIXED_HOST_NS_PER_PKT * max(n, 1), n)

    def device(self, b, dt_ns, n, fresh_compile=None):
        record_device(self, b, FIXED_DEVICE_NS, n, fresh_compile)

    monkeypatch.setattr(prop.DeviceRouteModel, "record_host", host)
    monkeypatch.setattr(prop.DeviceRouteModel, "record_device", device)


def test_torch_tier_shape_through_the_stages(monkeypatch):
    """bench.py config_10k's graph and apps at 200 hosts to 2 s: the
    twin alone, forced (every round packed into the propagator's stage,
    the law run over it and the decisions scattered from its views) and
    auto at a minimum batch of 1 (the route model probes through the
    probe's own stage) give one trace.  The auto run's route is
    deterministic: its measurements are fixed (_fixed_measurements), so
    it probes and never routes a round to the stage."""
    host = _tier_run(prop.HOST_ONLY)
    forced = _tier_run(0)
    _fixed_measurements(monkeypatch)
    auto = _tier_run(1)
    assert forced[:2] == host[:2]
    assert auto[:2] == host[:2]
    p, s = forced[2].propagator, forced[3]
    assert p.rounds_device == p.rounds_dispatched > 0 and not s.span_rounds
    assert p._stage is not None and p._probe_stage is None
    assert p._stage.cap >= max(p.round_sizes)
    walls = p.summary()["per_device_round_us"]
    assert all(walls[k] > 0 for k in prop._PHASES), walls
    pa = auto[2].propagator
    assert pa.rounds_device == 0 and pa.probes_async >= 1
    assert pa._stage is None and pa._probe_stage is not None
    assert host[2].propagator._stage is None
