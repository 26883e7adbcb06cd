"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--stop-time 1.25s]

Six phases; any failed check raises, so the script exits non-zero:

1. Identify the card (name, and name + power limit from nvidia-smi).
2. Build the engine and the three kernel libraries from this checkout
   (in parallel), hold each kernel against its plain PyTorch version on
   the card and time both:
   - the standalone law kernels (stt_bucket_step, stt_codel_head) on
     adversarial integer inputs at H = 10,000, a ragged H = 10,001, a
     scalar `now`, and the PHOLD paths' shapes (scalar `size`):
     H = 8,192 and H = 65,536, where they are timed (the kernels line
     takes the 65,536-lane row);
   - the fused relay kernels (stt_relay1_law, stt_relay2_law) at
     H = 10,000 with the span's ring widths, on lanes built to reach
     every branch (tools/relay_cases.py) at mask densities of 0.1%, 10%
     and 100%: every state word, every flag, the packet handed back on
     the lanes that carried one and the refill instant on the throttled
     lanes, exactly equal; card time with every launch on a fresh copy
     of the checked state, and the bound from the bytes each lane's
     branch needs;
   - the per-round propagation kernel (stt_propagate) at n = 1, 1,000,
     65,536, 1,048,576 and a ragged 1,000,003 packets, with the 3-tier
     graph's matrices (V = 3) and random V = 64 ones (unreachable pairs,
     zero and full loss thresholds, control lanes, send times on both
     sides of bootstrap_end): every output exactly equal; card time in a
     CUDA graph (back to back on the card, the minima's fill included),
     host time per wrapper call, the plain version, and the bound from
     the bytes per packet and the matrices.
   - the PHOLD/udp-mesh window kernel (stt_phold_window) on exported
     span states of phold-8k, mesh-codel-10 (inside its CoDel stretch)
     and phold-64k-ring: one window, then four rounds with their round
     ends, through the kernel and through its plain version (the
     runner's eager window) on copies of the same state: every state
     column, the outbox and trace in canonical order, the stage fires
     and lanes, the micro-iterations and the abort bits exactly equal;
     the outbox cut to H + 2 slots gives AB_OUT both ways; card time per
     launch (ten launches back to back in a CUDA graph, each on its own
     fresh copy of the export), host time per wrapper call, the plain
     window's time, the bound from the bytes the window must move (its
     lanes' last busy/due test, the slots it dequeues and copies, the
     words it changes), and nvcc's register and spill report.
3. Run the main path: the 10,000-host tgen TCP bulk stream through the
   port's Manager on the card, once with the C++ engine serving every
   round (`tpu_device_spans: off`) and once with forced device spans,
   and require identical traces, device spans, each relay kernel
   launched once per fire of its stage by the device run and the
   standalone law kernels never (their laws run inside the relay
   kernels); print the per-stage
   fire/lane counters and the wall of the router's one PHOLD probe.
   Then the same stream at 16 hosts, where at least half the rounds
   must run on the card, with the router's first window at 4 rounds
   so that the device stretch takes several spans.
4. Run the PHOLD/udp-mesh family the same way, spans off and forced
   (every window one stt_phold_window launch): phold-8k (the reference
   ladder's 8,192-LP rung), mesh-24 (the reference's 24-host paced
   udp-mesh, to the reference's own 30 s) and mesh-codel-10 (the
   reference's CoDel-active mesh, 60 s); phold-8k also forced through
   the plain window.  Requires one trace per cell, the one it had
   before the window kernel (DIGESTS; for mesh-24 also the lines
   before 1 s, the earlier cut's trace: PREFIX_DIGESTS), spans with no
   abort, >= 50% of rounds on the card, family 1 and drops for the
   meshes (all 3,350 CoDel drops for mesh-codel-10); through the
   kernel, one launch per window stepped in every dispatch and none of
   the standalone law kernels; through the plain window, each law
   kernel launched once per call the runner made, never more often
   than the stages that call it fire, and no window kernel; the TCP
   relay kernels never.  Prints the per-stage counters,
   micro-iterations, the loop's wall, the windows' launch-to-end time,
   the span codec's bytes and walls and the peak device memory.
5. Run phold-64k-ring (the reference ladder's 65,536-LP ring-caps rung,
   to 1.0 s so that the device stretch takes three spans) three times:
   spans off, forced with `span_overlap: off` (residency alone, through
   the plain window) and forced with `span_overlap: auto` (on, on the
   card, through the window kernel).  Requires the cell's trace in all
   three runs, no abort, >= 50% of rounds on the card, resident hits on
   every span after the first (less stale drops, each named by the
   engine call that moved the epoch), the residency run's export bytes
   under 1.5x one span's export, speculative windows dispatched and
   landed with auto and none with off, and phase 4's launch gates for
   each (never a kernel in the C++ run).  Prints the loop as phase 4
   does, the codec's bytes and walls, the clone's bytes and time, the
   overlap block and the peak device memory.  Then `python -m
   shadow_tpu_torch` on a 512-LP PHOLD ring with `span_overlap: on`
   must exit 0 with a speculative window landed.
6. Per-round device propagation.  tier10k (bench.py config_10k: 10,000
   hosts on the 3-tier graph, seed 7, 10 s, nothing cut) three times:
   host-only (the C++ twin serves every per-round round), auto (the
   route model with async probes) and forced (`tpu_min_device_batch:
   0`, no span, every round through stt_propagate); then mesh-100
   (bench.py mesh_config) host-only and forced.  Requires one trace
   sha256 and equal counters across each cell's runs, forced launches
   = device rounds = dispatched rounds with no span and no host
   measurement, auto launches + probe launches = device rounds +
   probes, none in host-only runs, and inet-loss drops at mesh-100.
   Prints the route split, packets per round and the per-phase walls
   per dispatch (export, upload, launch, kernel, download, scatter);
   the kernels line's stt_propagate row is timed at the forced run's
   median round.

The device runs of phases 3-4 run with `span_overlap: auto` (on, on the
card) and print their residency and overlap counters too.  It prints a
`kernels` JSON line before the last line, and as the last
line `{"ok": true, "device": {...}}`.  It imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H_MAIN = 10_000
CONNS_MAIN = 32_768  # the 10,000-host stream's conn capacity CC
BANDWIDTH = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
# Bytes each lane's operands take (each read once, each output written
# once); a 0-d operand costs nothing per lane.
BYTES_PER_LANE = {"bucket_step": 66, "codel_head": 46}
H_PHOLD = 8_192  # the phold-8k cell's lanes
H_RING = 65_536  # the phold-64k-ring cell's lanes: the law kernels' main path
# The reference rung's ring caps (bench.py phold_rung): the defaults carry
# a 2,048-deep CoDel ring per host, pure waste at PHOLD rates.
RING_CAPS = dict(CAP_I=32, CAP_T=16, CAP_R=64, CAP_S=64, CAP_C=256,
                 CAP_P=16)
REPLACES = {"bucket_step": "shadow_tpu/ops/pallas_queues.py:80",
            "codel_head": "shadow_tpu/ops/pallas_queues.py:119",
            "relay1_law": "shadow_tpu/ops/pallas_queues.py:80",
            "relay2_law": "shadow_tpu/ops/pallas_queues.py:119",
            "propagate": "shadow_tpu/ops/propagate.py:391",
            "phold_window": "shadow_tpu/ops/phold_span.py:1675"}
SOURCE = {"bucket_step": "shadow_tpu_torch/csrc/queues.cu",
          "codel_head": "shadow_tpu_torch/csrc/queues.cu",
          "relay1_law": "shadow_tpu_torch/csrc/relay.cu",
          "relay2_law": "shadow_tpu_torch/csrc/relay.cu",
          "propagate": "shadow_tpu_torch/csrc/propagate.cu",
          "phold_window": "shadow_tpu_torch/csrc/phold_window.cu"}
# Each PHOLD-family cell's trace sha256 (its first 16 hex digits) as the
# C++-only run and the device runs gave it before the window kernel: a
# device run through the kernel must give the same trace.  mesh-24 runs
# to the reference's 30 s; the lines of its trace before 1 s are the
# trace of a run stopped at 1 s (tests/test_torch_phold_window.py), the
# cut the earlier digest was taken at (PREFIX_DIGESTS: cut ns, digest).
DIGESTS = {"phold-8k": "193df0b724ca82af", "mesh-24": "418a93e5434d900a",
           "mesh-codel-10": "465140a4129e63e7",
           "phold-64k-ring": "8a7e37bc1464a71e"}
PREFIX_DIGESTS = {"mesh-24": (1_000_000_000, "7e888cfb90af5447")}
MESH_CODEL_DROPS = 3350  # every CoDel drop of mesh-codel-10's 60 s
DENSITIES = (0.001, 0.1, 1.0)
# stt_propagate: bytes per packet (in: src_node, dst_node i32, src_host,
# t_send i64, pkt_seq u32, is_ctl u8; out: deliver i64, three flags) and
# integer operations per packet (threefry2x32's 20 rounds of add, rotate,
# xor and 5 key injections, 77; the gathers' index arithmetic, clamps,
# compares, the clamp to window_end and the two minima, ~15).
PROPAGATE_IN_B, PROPAGATE_OUT_B, PROPAGATE_OPS = 29, 11, 92
# The card's rate for them: the only published H100 rate outside the
# tensor cores (float32, 67 TFLOP/s, H100 SXM data sheet),
# an upper bound of its int32 rate, so the operations bound is low.
OPS_RATE = 67e12
# Cycles the card sleeps before a timed CUDA graph's start event (about
# 2 ms at the H100's 1.98 GHz boost clock): the host records the event
# and launches the graph meanwhile.
SLEEP_CYCLES = 4_000_000
PROPAGATE_N = (1, 1_000, 65_536, 1_048_576, 1_000_003)


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false "
                         "(no CUDA card); nothing was run")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[card] {name}", flush=True)
    print(smi, flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    return name


def build_all():
    """The engine (make) and the kernel libraries (one nvcc per source),
    started together."""
    from shadow_tpu_torch.native import plane
    from shadow_tpu_torch.ops import phold_window, propagate, queues, relay
    errs = []
    walls = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # reported and re-raised below
            errs.append((name, e))
        walls[name] = time.perf_counter() - t0

    def engine():
        if plane.load_netplane() is None:
            raise RuntimeError(plane.load_error())

    threads = [threading.Thread(target=run, args=a)
               for a in (("engine", engine),
                         ("queues.cu", queues.LIBRARY.build),
                         ("relay.cu", relay.LIBRARY.build),
                         ("propagate.cu", propagate.LIBRARY.build),
                         ("phold_window.cu", phold_window.LIBRARY.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise RuntimeError(f"build failed: {errs}")
    print(f"[build] engine {walls['engine']:.1f}s (make "
          f"{plane.build_seconds():.1f}s), queues.cu "
          f"{walls['queues.cu']:.1f}s (nvcc {queues.LIBRARY.build_s:.1f}s), "
          f"relay.cu {walls['relay.cu']:.1f}s (nvcc "
          f"{relay.LIBRARY.build_s:.1f}s), propagate.cu "
          f"{walls['propagate.cu']:.1f}s (nvcc "
          f"{propagate.LIBRARY.build_s:.1f}s), phold_window.cu "
          f"{walls['phold_window.cu']:.1f}s (nvcc "
          f"{phold_window.LIBRARY.build_s:.1f}s)", flush=True)
    # nvcc -Xptxas=-v: the window kernel's registers, stack and spills.
    for ln in phold_window.LIBRARY.log.splitlines():
        if ln.strip():
            print(f"[build] phold_window.cu: {ln.strip()}", flush=True)


def adversarial(H: int, seed: int = 7):
    """The adversarial lanes of the reference's differential test:
    first-touch buckets, lapsed multi-interval refills, now < nxt,
    exact-balance debits, unlimited lanes; CoDel lanes straddling the
    target and the MTU standing-queue escape."""
    from shadow_tpu_torch.ops.tcp_span import (CODEL_TARGET_NS, MTU,
                                               REFILL_NS)
    rng = np.random.default_rng(seed)
    i64 = np.int64
    now = i64(3_000_000_000) + rng.integers(0, 10**9, H, dtype=i64)
    bal = rng.integers(0, 10_000, H, dtype=i64)
    nxt = np.where(rng.random(H) < 0.25, i64(0),
                   now + rng.integers(-5 * REFILL_NS, 5 * REFILL_NS, H,
                                      dtype=i64))
    refill = rng.integers(1, 4_000, H, dtype=i64)
    cap = rng.integers(1, 20_000, H, dtype=i64)
    unlimited = rng.random(H) < 0.3
    size = rng.integers(0, 3_000, H, dtype=i64)
    size[:4] = bal[:4]
    pop = rng.random(H) < 0.7
    none = ~pop & (rng.random(H) < 0.5)
    enq = now - rng.integers(0, 3 * CODEL_TARGET_NS, H, dtype=i64)
    bytes_after = rng.integers(0, 4 * MTU, H, dtype=i64)
    bytes_after[:4] = MTU
    first_above = np.where(rng.random(H) < 0.4, i64(0),
                           now + rng.integers(-10**8, 10**8, H, dtype=i64))
    t = {k: torch.tensor(v, device="cuda") for k, v in dict(
        now=now, bal=bal, nxt=nxt, refill=refill, cap=cap,
        unlimited=unlimited, size=size, pop=pop, none=none, enq=enq,
        bytes_after=bytes_after, first_above=first_above).items()}
    return t


def events_ms(fn, reps: int, warm: bool = True) -> float:
    """CUDA-event time of fn() (which issues `reps` units), per unit,
    after one untimed call unless `warm` is false."""
    if warm:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int = 100) -> float:
    """Device time per call of fn(), captured `reps` times in one CUDA
    graph and replayed, so the host's per-op issue cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return events_ms(g.replay, reps)


def check_kernels() -> dict:
    from shadow_tpu_torch.ops import queues
    bs, ch = queues.BUCKET_STEP, queues.CODEL_HEAD
    stats = {}

    def calls(t, scalar_now, scalar_size=False):
        now = t["now"][0] if scalar_now else t["now"]
        size = t["size"][0] if scalar_size else t["size"]
        b_args = (t["bal"], t["nxt"], t["refill"], t["cap"],
                  t["unlimited"], size, now)
        c_args = (t["pop"], t["none"], now, t["enq"], t["bytes_after"],
                  t["first_above"])
        return {
            "bucket_step": (lambda: bs(*b_args),
                            lambda: queues.bucket_step_ref(bs.refill_ns,
                                                           *b_args)),
            "codel_head": (lambda: ch(*c_args),
                           lambda: queues.codel_head_ref(
                               ch.target_ns, ch.mtu, *c_args)),
        }

    def launch(name, reps, scalar_size):
        # `reps` back-to-back kernel launches from C (timing only;
        # counted nowhere).
        if name == "bucket_step":
            bs.launch(t["bal"], t["nxt"], t["refill"], t["cap"],
                      t["unlimited"],
                      t["size"][0] if scalar_size else t["size"],
                      t["now"], reps=reps)
        else:
            ch.launch(t["pop"], t["none"], t["now"], t["enq"],
                      t["bytes_after"], t["first_above"], reps=reps)

    # The TCP stream's width, ragged, and the PHOLD paths' shapes (a 0-d
    # packet size, as PholdSpanRunner calls), the only ones timed.
    for H, scalar_size in ((H_MAIN, False), (H_MAIN + 1, False),
                           (H_PHOLD, True), (H_RING, True)):
        t = adversarial(H)
        for scalar_now in (False, True):
            for name, (kern, plain) in calls(t, scalar_now,
                                             scalar_size).items():
                got = kern()
                want = plain()
                torch.cuda.synchronize()
                err = 0
                for g, w in zip(got, want):
                    if g.dtype != w.dtype or g.shape != w.shape:
                        raise AssertionError(
                            f"{name} H={H}: {g.dtype}{tuple(g.shape)} vs "
                            f"{w.dtype}{tuple(w.shape)}")
                    err = max(err, int((g.to(torch.int64)
                                        - w.to(torch.int64)).abs().max()))
                if err != 0:
                    raise AssertionError(f"{name} H={H} scalar_now="
                                         f"{scalar_now}: max |err| {err}")
                if H in (H_PHOLD, H_RING) and not scalar_now:
                    reps = 1000
                    ms = events_ms(lambda: launch(name, reps, scalar_size),
                                   reps)
                    gms = graph_ms(lambda: launch(name, 1, scalar_size),
                                   200)
                    call_ms = events_ms(
                        lambda: [kern() for _ in range(reps)], reps)
                    pms = graph_ms(plain)
                    per_lane = BYTES_PER_LANE[name] - (
                        8 if scalar_size and name == "bucket_step" else 0)
                    bound = per_lane * H / BANDWIDTH * 1e3
                    stats[(name, H)] = {
                        "ms": ms, "graph_ms": gms, "plain_ms": pms,
                        "call_ms": call_ms, "bound_ms": bound,
                        "max_abs_err": err, "H": H}
                print(f"[kernel] {name} H={H} scalar_now={scalar_now} "
                      f"scalar_size={scalar_size}: exact (max |err| {err})",
                      flush=True)
    for (name, _H), s in stats.items():
        print(f"[kernel] {name} H={s['H']}: {s['ms'] * 1e3:.3f} us per "
              f"launch on the card (back-to-back launches), "
              f"{s['graph_ms'] * 1e3:.3f} us in a CUDA graph, "
              f"{s['call_ms'] * 1e3:.2f} us host per wrapper call; "
              f"plain PyTorch {s['plain_ms'] * 1e3:.3f} us (CUDA graph); "
              f"bound {s['bound_ms'] * 1e3:.3f} us by bytes", flush=True)
    return stats


def fresh_ms(fn, st0: dict, n: int) -> float:
    """Device time per call of fn(st) over `n` calls, each on its own
    fresh copy of st0's lane state (the read-only rings shared), captured
    in one CUDA graph so the host's issue cost drops out.  The copies are
    restored from st0 before each replay, so every timed call sees the
    inputs the exactness check and the bound used."""
    H = st0["now"].shape[0]
    lane = [k for k, v in st0.items()
            if v.dim() == 1 and v.shape[0] == H or k == "drop_causes"]
    copies = [dict(st0, **{k: st0[k].clone() for k in lane})
              for _ in range(n + 1)]
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn(copies[n])  # warm-up
    cur.wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in copies[:n]:
            fn(c)
    best = float("inf")
    for _ in range(3):
        for c in copies[:n]:
            for k in lane:
                c[k].copy_(st0[k])
        torch.cuda.synchronize()
        best = min(best, events_ms(g.replay, n, warm=False))
    del g, copies
    return best


def check_relay_kernels() -> dict:
    """Both fused relay kernels against their plain versions at
    H = 10,000 with the span's ring widths and the 10,000-host stream's
    conn capacity, at each mask density: exact equality, then card time
    per launch and the plain version's device time (each call on a fresh
    copy of the checked state, in a CUDA graph), host time per wrapper
    call, the plain version's eager wall per call, and the bound from
    the bytes these inputs need (tools/relay_cases.relay_need_bytes)."""
    from shadow_tpu_torch.ops.tcp_span import (RELAY1_LAW, RELAY2_LAW,
                                               TcpSpanRunner)
    from shadow_tpu_torch.tools.relay_cases import (clone_state,
                                                    relay_case_state,
                                                    relay_mismatch,
                                                    relay_need_bytes)
    cq, op = TcpSpanRunner.CAP_CQ, TcpSpanRunner.CAP_OP
    stats = {}
    for density in DENSITIES:
        st0, m1, pop, sel, m2, _cases = relay_case_state(
            H_MAIN, seed=11, density=density, cq_cap=cq, op_cap=op,
            conns=CONNS_MAIN, device="cuda")
        for law, mask, lane, ring in ((RELAY1_LAW, m1, (pop, sel), op),
                                      (RELAY2_LAW, m2, (), cq)):
            bound = law.bind(H_MAIN, ring, CONNS_MAIN)

            def plain(st):
                return law.ref(st, mask, *lane, ring=ring, conns=CONNS_MAIN)

            st_k, st_p = clone_state(st0), clone_state(st0)
            got = bound(st_k, mask, *lane)
            want = plain(st_p)
            torch.cuda.synchronize()
            err, bad = relay_mismatch(law, got, want, st_k, st_p)
            if bad:
                raise AssertionError(f"{law.name} density {density}: "
                                     f"{bad[:8]} (max |err| {err})")
            nbytes = relay_need_bytes(law, st0, st_p, mask, lane, want)
            ms = fresh_ms(lambda st: bound(st, mask, *lane), st0, 1000)
            pms = fresh_ms(plain, st0, 20)
            reps = 1000
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                bound(st_k, mask, *lane)
            host_ms = (time.perf_counter() - t0) / reps * 1e3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                plain(st_p)
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t0) / 20 * 1e3
            n = int(mask.sum())
            stats[(law.name, density)] = {
                "ms": ms, "call_ms": host_ms, "plain_ms": pms,
                "plain_eager_ms": eager_ms,
                "bound_ms": nbytes / BANDWIDTH * 1e3, "bytes": nbytes,
                "lanes": n, "max_abs_err": err}
            print(f"[relay] {law.name} H={H_MAIN} density {density:g} "
                  f"({n} lanes): exact; {ms * 1e3:.3f} us per launch on "
                  f"the card (CUDA graph, fresh state each launch), "
                  f"{host_ms * 1e3:.2f} us host per wrapper call; plain "
                  f"{pms * 1e3:.3f} us (CUDA graph), {eager_ms * 1e3:.1f} "
                  f"us per eager call; bound {nbytes / BANDWIDTH * 1e6:.3f}"
                  f" us ({nbytes} B, {(nbytes - 5 * H_MAIN) / n:.0f} B per "
                  f"mask lane)", flush=True)
            del st_k, st_p, got, want
        del st0
        torch.cuda.empty_cache()
    return stats


def propagate_inputs(n: int, v: int, seed: int):
    """Seeded columns of one round on the card (as export_round gives
    them) and the (V, V) matrices: V = 3 the 3-tier graph's; V = 64
    random, with unreachable (TIME_NEVER) pairs and zero and full loss
    thresholds.  ~20% control packets, source hosts past 2**32, every
    pkt_seq bit pattern, send times on both sides of bootstrap_end."""
    from shadow_tpu_torch.core.simtime import TIME_NEVER
    from shadow_tpu_torch.net.graph import NetworkGraph, routing_arrays
    from shadow_tpu_torch.tools.netgen import THREE_TIER_GML
    rng = np.random.default_rng(seed)
    if v == 3:
        lat, thr = routing_arrays(NetworkGraph.from_gml(THREE_TIER_GML))
    else:
        lat = rng.integers(1, 80_000_000, (v, v), dtype=np.int64)
        lat[rng.random((v, v)) < 0.15] = TIME_NEVER
        thr = rng.integers(0, 1 << 32, (v, v), dtype=np.int64)
        thr[rng.random((v, v)) < 0.2] = 0
        thr[rng.random((v, v)) < 0.1] = 1 << 32
    cols = (rng.integers(0, v, n).astype(np.int32),
            rng.integers(0, v, n).astype(np.int32),
            rng.integers(0, 1 << 34, n, dtype=np.int64),
            rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
                np.uint32).view(np.int32),
            rng.integers(0, 10_000_000_000, n, dtype=np.int64),
            rng.random(n) < 0.2)
    mats = tuple(torch.tensor(m, device="cuda") for m in (lat, thr))
    return mats, tuple(torch.tensor(c, device="cuda") for c in cols)


def propagate_bound_ms(n: int, v: int):
    """The least time of one stt_propagate call: every input read once
    (the columns and both matrices), every output written once (the
    columns and the two minima), over the memory rate; the integer
    operations over the card's rate.  Returns (ms, "bytes"|"operations")."""
    nbytes = (PROPAGATE_IN_B + PROPAGATE_OUT_B) * n + 2 * 8 * v * v + 16
    by_bytes = nbytes / BANDWIDTH * 1e3
    by_ops = PROPAGATE_OPS * n / OPS_RATE * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def time_propagate(n: int, v: int = 3, seed: int = 5) -> dict:
    """stt_propagate against propagate_ref on the card at one shape:
    every output exactly equal; card time in a CUDA graph (200 launches
    back to back on the card, each with the minima's fill), host time per
    wrapper call, the plain version in a CUDA graph, and the bound."""
    from shadow_tpu_torch.ops.propagate import PROPAGATE, propagate_ref
    mats, cols = propagate_inputs(n, v, seed)
    we, be = 5_000_000_000, 5_000_000_000
    args = (*mats, 0x9E3779B9, 0x7F4A7C15, *cols, we, be)
    got = PROPAGATE(*args)
    want = propagate_ref(*args)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    bad = [name for name, g, w in zip(
        ("deliver", "keep", "reachable", "lossy", "mins"), got, want)
        if g.dtype != w.dtype or not torch.equal(g, w)]
    if bad:
        raise AssertionError(f"propagate n={n} V={v}: {bad} differ "
                             f"(max |err| {err})")
    keep = got[1]
    ms = graph_ms(lambda: PROPAGATE.launch(*args, out=got), 200)
    pms = graph_ms(lambda: propagate_ref(*args), 20)
    reps = 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        PROPAGATE.launch(*args, out=got)
    call_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    bound, by = propagate_bound_ms(n, v)
    row = {"ms": ms, "graph_ms": ms, "plain_ms": pms, "call_ms": call_ms,
           "bound_ms": bound, "bound_by": by, "max_abs_err": err, "n": n,
           "V": v}
    print(f"[propagate] n={n} V={v}: exact ({int(keep.sum())} kept, "
          f"{int((~got[2]).sum())} unreachable, {int(got[3].sum())} lost, "
          f"mins {got[4].tolist()}); {ms * 1e3:.3f} us per launch on the "
          f"card (CUDA graph, back to back, with the minima's fill), "
          f"{call_ms * 1e3:.2f} us host per wrapper "
          f"call; plain PyTorch {pms * 1e3:.3f} us (CUDA graph); bound "
          f"{bound * 1e3:.3f} us by {by}", flush=True)
    return row


def check_propagate() -> dict:
    """Phase 2's stt_propagate leg: exact and timed at every shape
    with both matrices (the 3-tier graph's, staged in shared memory, and
    a random V = 64, read through the read-only cache)."""
    stats = {}
    for v in (3, 64):
        for n in PROPAGATE_N:
            stats[(n, v)] = time_propagate(n, v, seed=n % 9973 + v)
        torch.cuda.empty_cache()
    return stats


def ring_config(spans: str, overlap: str):
    """phold-64k-ring (bench.py phold_rung's 64k rung: 65,536 LPs, ring
    peers 16; 1 Gbit, 5 ms, LPs start at 100 ms) to 1.0 s instead of the
    rung's 0.15 s, every per-round round on the C++ twin.  The YAML is
    generated and parsed once."""
    from shadow_tpu_torch.ops.propagate import HOST_ONLY
    from shadow_tpu_torch.tools.netgen import phold_yaml
    if not hasattr(ring_config, "base"):
        t0 = time.perf_counter()
        text = phold_yaml(H_RING, n_init=1, mean_delay_ns=20_000_000,
                          stop_time="1.0s", seed=13, scheduler="tpu",
                          peers_per_host=16)
        ring_config.base = parse_yaml(text)
        print(f"[phold-64k-ring] {H_RING} LPs, stop_time 1.0s, caps "
              f"{RING_CAPS}; YAML {len(text) / 2**20:.1f} MiB parsed in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return config_with(ring_config.base, tpu_device_spans=spans,
                       span_overlap=overlap, tpu_min_device_batch=HOST_ONLY)


def window_cells() -> dict:
    """Phase 2's window exports: name -> (config, which in-domain export,
    runner caps).  mesh-codel-10's sixth export lies inside its CoDel
    stretch (its traffic ends at 3.9 s)."""
    cells = phold_cells()
    return {"phold-8k": (cells["phold-8k"][0]("force"), 2, None),
            "mesh-codel-10": (cells["mesh-codel-10"][0]("force"), 6, None),
            "phold-64k-ring": (ring_config("force", "off"), 2, RING_CAPS)}


def window_graph_ms(fn, base: dict, pay: int, window_end: int,
                    n: int) -> list:
    """Card time per window of the built loop `fn`'s kernel step, once
    per replay of three: `n` launches back to back in one CUDA graph,
    each on its own copy of `base` (the written operands cloned, the
    rest shared), restored before each replay.  The card sleeps while
    the host records the start event and launches the graph, so neither
    the host's issue nor the graph's launch is in the time."""
    from shadow_tpu_torch.tools.relay_cases import clone_state
    ref = clone_state(base)
    fn.prepare(ref, pay)
    fn.step.begin(ref, pay)
    written = [o.key for o in fn.step.table.ops
               if o.written and o.key in ref]
    copies = [dict(ref, **{k: ref[k].clone() for k in written})
              for _ in range(n)]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in copies:
            fn.step.launch(c, window_end)
    out = []
    for _ in range(3):
        for c in copies:
            for k in written:
                c[k].copy_(ref[k])
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        g.replay()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / n)
    del g, copies
    return out


def check_phold_window() -> dict:
    """Phase 2's stt_phold_window leg.  For each cell's export on the
    card: one window through the kernel and through its plain version
    (the runner's eager window) on copies of the same state, then four
    rounds of each, round ends included; every state column, the outbox
    and the trace in canonical order, ks_fires, ks_lanes, the
    micro-iterations and the abort bits exactly equal.  phold-8k also
    runs with the outbox cut to H + 2 slots: both abort with AB_OUT
    alone.  Card time per launch (window_graph_ms), host time per
    wrapper call, the plain window's time, and the bound from the bytes
    one window must move (ops/phold_window.py window_need_bytes)."""
    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.ops import phold_window as pw
    from shadow_tpu_torch.ops.span_mesh import AB_OUT
    from shadow_tpu_torch.tools.relay_cases import clone_state
    from shadow_tpu_torch.tools.window_cases import (capture_export,
                                                     device_state,
                                                     window_mismatch)
    stats = {}
    for name, (cfg, nth, caps) in window_cells().items():
        tag = f"[window {name}]"
        t0 = time.perf_counter()
        runner, st_np, (start, stop, limit, runahead) = capture_export(
            Manager(cfg, device="cuda"), nth, caps)
        pay, H = runner._pay, runner._H
        base = device_state(runner, st_np)
        del st_np
        we = min(start + runahead, stop)

        def build(kernel: bool):
            runner.window_factory = None if kernel else pw.eager_window
            return runner._build()

        plain, kern = build(False), build(True)
        print(f"{tag} export {nth} at {start / 1e9:.4f}s ({H} lanes, "
              f"window {runahead / 1e6:.3f} ms) in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        # One window each way.
        a = clone_state(base)
        plain.prepare(a, pay)
        it = plain.window_plain(a, we)
        b = clone_state(base)
        kern.prepare(b, pay)
        before = clone_state(b)
        kern.step.begin(b, pay)
        kern.step(b, we)
        got = kern.step.end()
        torch.cuda.synchronize()
        bad = window_mismatch(a, b) + [
            what for what, x, y in (
                ("iterations", it, got["iters"]),
                ("ks_fires", a["ks_fires"], got["fires"]),
                ("ks_lanes", a["ks_lanes"], got["lanes"]),
                ("abort", int(a["abort_code"]), int(b["abort_code"])))
            if not np.array_equal(x, y)]
        if bad or it == 0:
            raise AssertionError(f"{tag} one window: {bad} differ "
                                 f"({it} iterations)")
        n_out, n_tr = int(b["out_n"]), int(b["tr_n"])
        lanes = got["lanes"]
        need = pw.window_need_bytes(kern.step.table.ops, before, b)
        del a, b, before
        # Four rounds each way, the round ends between the windows.
        outs = []
        for fn in (plain, kern):
            outs.append(fn(clone_state(base), pay, start, stop, limit,
                           runahead, 4))
        (ra, *rest_a), (rb, *rest_b) = outs
        bad = window_mismatch(ra, rb) + [
            k for k in ("ks_fires", "ks_lanes")
            if not np.array_equal(ra[k], rb[k])]
        if bad or rest_a != rest_b or rest_a[2] < 2 \
                or int(ra["abort_code"]) or rb["ks_windows"] != rest_a[2]:
            raise AssertionError(f"{tag} four rounds: {bad} differ, "
                                 f"{rest_a} vs {rest_b}, windows "
                                 f"{rb['ks_windows']}")
        codel = int((rb["codel_dropped"] - base["codel_dropped"]).sum())
        if name == "mesh-codel-10" and codel == 0:
            raise AssertionError(f"{tag} no CoDel drop in four rounds")
        del outs, ra, rb
        if name == "phold-8k":
            # One forced overflow: the outbox cut to H + 2 slots.
            cap = runner.cap_out
            runner.cap_out = H + 2
            codes = [int(fn(clone_state(base), pay, start, stop, limit,
                            runahead, 4)[0]["abort_code"])
                     for fn in (build(False), build(True))]
            runner.cap_out = cap
            if codes != [AB_OUT, AB_OUT]:
                raise AssertionError(f"{tag} outbox overflow: abort bits "
                                     f"{codes} (plain, kernel)")
            print(f"{tag} outbox cut to H + 2: both abort with bits "
                  f"{codes[0]}", flush=True)
        ms = window_graph_ms(kern, base, pay, we, 10)
        call, ms_call = [], []
        for _ in range(5):
            c = clone_state(base)
            kern.prepare(c, pay)
            kern.step.begin(c, pay)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            kern.step(c, we)
            call.append(time.perf_counter() - t1)
            ms_call.append(kern.step.end()["window_ms"])
            del c
        pms = []
        for _ in range(2):
            c = clone_state(base)
            plain.prepare(c, pay)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            plain.window_plain(c, we)
            e1.record()
            e1.synchronize()
            pms.append(e0.elapsed_time(e1))
            del c
        nbytes = need["total"]
        row = {"ms": float(np.median(ms)), "graph_ms": float(np.median(ms)),
               "ms_min": min(ms), "ms_max": max(ms),
               "call_ms": float(np.median(call)) * 1e3,
               "plain_ms": float(np.median(pms)),
               "bound_ms": nbytes / BANDWIDTH * 1e3, "bytes": nbytes,
               "max_abs_err": 0, "iters": it, "H": H, "lanes": lanes}
        stats[name] = row
        print(f"{tag} exact: one window ({it} micro-iterations; fires "
              f"{got['fires'].tolist()}, lanes {lanes.tolist()}, law "
              f"calls {got['calls'].tolist()}; outbox {n_out}, trace "
              f"{n_tr}) and four rounds ({rest_a[2]} windows, "
              f"{rest_a[-1]} micro-iterations, {codel} CoDel drops); "
              f"{row['ms'] * 1e3:.3f} us per launch on the card (CUDA "
              f"graph of 10, fresh state each; median of 3 replays, "
              f"{row['ms_min'] * 1e3:.3f}-{row['ms_max'] * 1e3:.3f}), "
              f"{row['call_ms'] * 1e3:.1f} us host per wrapper call "
              f"(launch to end {np.median(ms_call) * 1e3:.1f} us); plain "
              f"window {row['plain_ms']:.3f} ms; bound "
              f"{row['bound_ms'] * 1e3:.3f} us by bytes ({nbytes} B: "
              + ", ".join(f"{k} {v}" for k, v in need.items()
                          if k != "total") + ")",
              flush=True)
        del base, plain, kern, runner
        gc.collect()
        torch.cuda.empty_cache()
    return stats


def log_spans(mgr) -> None:
    """Print one line per device-span attempt (progress for a long run)."""
    runner = mgr._dev_span_tcp = mgr.make_tcp_span_runner()
    try_span = runner.try_span

    def logged(start, *a, **k):
        t0 = time.perf_counter()
        res = try_span(start, *a, **k)
        print(f"[span] start {start / 1e9:.4f}s -> "
              f"{'none' if res is None else res[:3]} in "
              f"{time.perf_counter() - t0:.1f}s (micro-iterations "
              f"{runner.micro_iters}, aborts {runner.aborts}, transient "
              f"{runner.over_caps})", flush=True)
        return res
    runner.try_span = logged


def stream_pair(n_hosts: int, stop_time: str, min_share: float,
                k_init: int | None = None):
    """The tgen TCP bulk stream (tools/span_loop_bench.stream_config)
    through the port's Manager on the card, once with the C++ engine
    serving every round and once with forced device spans (the router's
    first window `k_init` rounds where given).  Requires identical
    traces, packets and events, a device span, at least `min_share` of
    the rounds on the card, a resident hit on every span after the
    first (less stale drops), each relay kernel launched once per fire
    of its stage and the standalone law kernels never.  Returns the
    device run's kernel launch counts and lanes per fire of each relay
    stage."""
    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.ops import tcp_span
    from shadow_tpu_torch.tools.span_loop_bench import (run_stream,
                                                        stream_config)

    tag = f"[stream {n_hosts}]"
    print(f"{tag} {n_hosts} hosts ({max(1, n_hosts // 8)} tgen servers), "
          f"stop_time {stop_time}", flush=True)
    runs = {}
    for spans in ("off", "force"):
        cfg = stream_config(n_hosts, stop_time, spans)
        if k_init is not None:
            cfg.experimental.dev_span_k_init = k_init
        mgr = Manager(cfg, device="cuda")
        if spans == "force":
            log_spans(mgr)
        wrappers = kernel_wrappers()
        # Counts cover this run only: zeroed just before it.
        for w in wrappers.values():
            w.launches = 0
        # Earlier runs' span state (held in reference cycles) freed first.
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        run = run_stream(mgr)
        run["launches"] = {name: w.launches for name, w in wrappers.items()}
        run["phold"] = mgr._dev_span
        runs[spans] = run
        summary, r, wall = run["summary"], run["runner"], run["wall"]
        dev_rounds = r.rounds if r is not None else 0
        print(f"{tag} spans={spans}: rounds {summary.rounds} (device "
              f"{dev_rounds}), events {summary.events}, packets "
              f"{summary.packets_sent} sent / {summary.packets_dropped} "
              f"dropped, trace lines {run['lines']} sha256 "
              f"{run['digest'][:16]}, wall {wall:.1f}s, "
              f"{summary.end_time_ns / 1e9 / wall:.4f} sim-s/wall-s, peak "
              f"device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        if r is not None:
            per = r.device_ms / max(r.micro_iters, 1)
            print(f"{tag} spans={spans}: device spans {r.spans}, "
                  f"micro-iterations {r.micro_iters} ({per:.2f} ms each "
                  f"in the loop), aborts {r.aborts} "
                  f"{r.abort_kind_counts()}, transient {r.over_caps}, "
                  f"loop time {r.device_ms / 1e3:.1f}s (CUDA events), "
                  f"export {r.export_bytes / 2**30:.2f} GiB / import "
                  f"{r.import_bytes / 2**30:.2f} GiB, launches "
                  f"{run['launches']}", flush=True)
            print_residency(tag, r)
            print_stages(tag, r)
        if not summary.ok:
            raise AssertionError(f"plugin errors: "
                                 f"{summary.plugin_errors[:3]}")
    off, dev = runs["off"], runs["force"]
    so, sd = off["summary"], dev["summary"]
    r = dev["runner"]
    if off["digest"] != dev["digest"]:
        raise AssertionError(f"{tag} trace sha256 differs between the C++ "
                             f"run and the device-span run")
    if (so.packets_sent, so.packets_dropped, so.events) != \
            (sd.packets_sent, sd.packets_dropped, sd.events):
        raise AssertionError(f"{tag} packets/events differ between runs")
    if r is None or r.spans == 0 or r.rounds == 0:
        raise AssertionError(f"{tag} no device span ran")
    if r.rounds < min_share * sd.rounds:
        raise AssertionError(f"{tag} only {r.rounds}/{sd.rounds} rounds "
                             f"on the device (< {min_share:.0%})")
    if r.resident_hits < r.spans - 1 - r.stale_drops:
        raise AssertionError(f"{tag} {r.resident_hits} resident hits over "
                             f"{r.spans} spans ({r.stale_drops} stale)")
    launches = dev["launches"]
    # One launch per fire of the relay stage, over every dispatch
    # (aborted spans and refused speculative windows launched too).
    for name, code in (("relay1_law", tcp_span.KS_INET_OUT),
                       ("relay2_law", tcp_span.KS_CODEL)):
        fires, fires_all = int(r.ks_fires[code]), int(r.fires_all[code])
        if fires <= 0 or launches[name] != fires_all:
            raise AssertionError(f"{tag} {name} launched {launches[name]} "
                                 f"times for {fires_all} fires of its "
                                 f"stage ({fires} committed)")
    # The laws run inside the relay kernels: the span loop launches no
    # standalone law kernel (nor the PHOLD window kernel).
    for name in ("bucket_step", "codel_head", "phold_window"):
        if launches[name] != 0:
            raise AssertionError(f"{tag} the span loop launched {name} "
                                 f"{launches[name]} times")
    # The router tries the PHOLD family first: one structural refusal
    # per run, then the TCP family serves every span.
    ph = dev["phold"]
    if ph is None or ph.ineligible != 1 or ph.spans != 0:
        raise AssertionError(f"{tag} the PHOLD probe did not refuse once")
    print(f"{tag} PHOLD probe: refused structurally once in "
          f"{ph.export_wall_ns / 1e6:.3f} ms", flush=True)
    print(f"{tag} PASS: identical traces, {r.rounds}/{sd.rounds} rounds "
          f"on the card, one relay launch per relay fire", flush=True)
    lanes = {code: r.ks_lanes[code] / max(r.ks_fires[code], 1)
             for code in (tcp_span.KS_INET_OUT, tcp_span.KS_CODEL)}
    return launches, lanes


def print_residency(tag, r) -> None:
    """The runner's residency and speculative-overlap counters."""
    print(f"{tag} residency: resident hits {r.resident_hits}, stale drops "
          f"{r.stale_drops}; clones {r.clone_bytes / 2**30:.3f} GiB in "
          f"{r.clone_ms:.3f} ms; overlap {json.dumps(r.overlap_summary())}",
          flush=True)


def print_stages(tag, r) -> None:
    """The runner's per-stage counters over its committed spans: fires,
    lanes, lanes per fire, and host wall from each guard's sync to the
    end of the stage's issue (so the kernels' device time hides in the
    next sync).  Through the PHOLD window kernel the stages have no
    host wall of their own: the windows' launch-to-end time stands for
    them."""
    from shadow_tpu_torch.ops.tcp_span import KS_NAMES
    windows = getattr(r, "ks_windows", 0)
    if not r.ks_wall_s.sum() and not windows:
        return
    print(f"{tag} stages over {r.micro_iters} micro-iterations "
          f"(name: fires, lanes, lanes/fire, host s, ms/fire):", flush=True)
    for code, name in enumerate(KS_NAMES):
        f, n, w = int(r.ks_fires[code]), int(r.ks_lanes[code]), \
            float(r.ks_wall_s[code])
        if f:
            print(f"{tag}   {name}: {f}, {n}, {n / f:.1f}, {w:.3f}, "
                  f"{w / f * 1e3:.3f}", flush=True)
    if windows:
        print(f"{tag} window kernel launch-to-end {r.ks_window_ms / 1e3:.3f}s"
              f" over {windows} windows of {r.device_ms / 1e3:.3f}s loop",
              flush=True)
    else:
        print(f"{tag} stage host wall total {r.ks_wall_s.sum():.3f}s of "
              f"{r.device_ms / 1e3:.3f}s loop", flush=True)


def parse_yaml(text: str) -> dict:
    """A generated config parsed once (with PyYAML's C loader where it
    has one); each run builds its ConfigOptions from a copy."""
    import yaml
    return yaml.load(text, Loader=getattr(yaml, "CSafeLoader",
                                          yaml.SafeLoader))


def config_with(base: dict, **experimental):
    import copy

    from shadow_tpu_torch.core.config import ConfigOptions
    d = copy.deepcopy(base)
    d["experimental"].update(experimental)
    return ConfigOptions.from_dict(d)


def phold_cells() -> dict:
    """Phase 4's cells: name -> (config for a `tpu_device_spans` value,
    least device-round share, what the CoDel gate requires).  Every
    per-round round runs on the C++ twin (HOST_ONLY), so the spans
    alone are measured, as before the per-round kernel."""
    from shadow_tpu_torch.core.config import ConfigOptions
    from shadow_tpu_torch.ops.propagate import HOST_ONLY
    from shadow_tpu_torch.tools.netgen import mesh_family_yaml, phold_yaml

    # the reference ladder's 8k rung (bench.py phold_rung)
    phold_8k_base = parse_yaml(phold_yaml(
        H_PHOLD, n_init=1, mean_delay_ns=50_000_000, stop_time="0.3s",
        seed=13, scheduler="tpu", peers_per_host=64))

    def phold_8k(spans):
        return config_with(phold_8k_base, tpu_device_spans=spans,
                           tpu_min_device_batch=HOST_ONLY)

    def mesh_24(spans):
        # the reference's bench[mesh-dev] shape (mesh_cfg(n=24)) at its
        # own 30 s, nothing cut
        cfg = ConfigOptions.from_yaml_text(mesh_family_yaml(
            24, scheduler="tpu", device_spans=spans, stop_time="30s"))
        cfg.experimental.tpu_min_device_batch = HOST_ONLY
        return cfg

    def mesh_codel_10(spans):
        # tests/test_phold_span.py's CoDel-active mesh: fast up, slow
        # down, sustained overload
        names = [f"m{i:02d}" for i in range(10)]
        hosts = {}
        for name in names:
            peers = " ".join(p for p in names if p != name)
            hosts[name] = {"network_node_id": 0, "processes": [{
                "path": "udp-mesh", "args": f"9000 60 900 {peers}",
                "start_time": "100ms", "expected_final_state": "any"}]}
        return ConfigOptions.from_dict({
            "general": {"stop_time": "60s", "seed": 41},
            "network": {"graph": {"type": "gml", "inline": (
                'graph [ node [ id 0 host_bandwidth_down "400 Kbit" '
                'host_bandwidth_up "10 Mbit" ] edge [ source 0 target 0 '
                'latency "10 ms" ] ]')}},
            "experimental": {"scheduler": "tpu",
                             "socket_send_buffer": "64 KiB",
                             "tpu_device_spans": spans,
                             "tpu_min_device_batch": HOST_ONLY},
            "hosts": hosts})

    return {"phold-8k": (phold_8k, 0.5, None),
            "mesh-24": (mesh_24, 0.5, None),
            "mesh-codel-10": (mesh_codel_10, 0.5, "drops")}


def check_window_launches(tag: str, r, launches: dict, kernel: bool):
    """A forced PHOLD-family run's launch gates.  Through the window
    kernel: one stt_phold_window launch per window stepped in every
    dispatch (aborted and refused ones too), one per round in the
    committed spans, and no standalone law kernel.  Through the plain
    window: each law kernel launched exactly once per call the runner
    made, and no window kernel.  Never a TCP relay kernel."""
    for kname in ("relay1_law", "relay2_law"):
        if launches[kname]:
            raise AssertionError(f"{tag} the PHOLD loop launched {kname} "
                                 f"{launches[kname]} times")
    if kernel:
        n = launches["phold_window"]
        if n <= 0 or n != r.windows_all or r.ks_windows != r.rounds:
            raise AssertionError(f"{tag} phold_window launched {n} times "
                                 f"for {r.windows_all} windows "
                                 f"({r.ks_windows} committed, {r.rounds} "
                                 f"rounds)")
        for kname in ("bucket_step", "codel_head"):
            if launches[kname]:
                raise AssertionError(f"{tag} {kname} launched "
                                     f"{launches[kname]} times beside the "
                                     f"window kernel")
        return
    if launches["phold_window"]:
        raise AssertionError(f"{tag} the plain window launched "
                             f"phold_window {launches['phold_window']} "
                             f"times")
    from shadow_tpu_torch.ops import phold_span as ps
    fires = r.ks_fires
    for i, (kname, most) in enumerate((
            ("bucket_step", fires[ps.KS_INET_OUT] + fires[ps.KS_CODEL]),
            ("codel_head", fires[ps.KS_CODEL]))):
        n = launches[kname]
        if n <= 0 or n != r.calls_all[i] or r.ks_calls[i] > most \
                or (r.rolled_back_rounds == 0 and r.overlap_refusals == 0
                    and n != r.ks_calls[i]):
            raise AssertionError(
                f"{tag} {kname} launched {n} times for {r.calls_all[i]} "
                f"calls ({r.ks_calls[i]} committed), stage fires {most}")


def print_run(tag, r) -> None:
    """A forced PHOLD-family run's loop: dispatches, micro-iterations,
    the loop's wall (CUDA events around each dispatch) and, through the
    window kernel, the windows' launch-to-end time (CUDA events just
    before each launch call and after it: card time plus the launch's
    host issue) and the rest (round ends and the span's set-up), the
    codec's bytes and walls, law calls."""
    per = r.device_ms / max(r.micro_iters, 1)
    kern = ""
    if r.ks_windows:
        kern = (f"; window kernel {r.ks_windows} launches, "
                f"{r.ks_window_ms / 1e3:.3f}s launch to end "
                f"({r.ks_window_ms / r.ks_windows * 1e3:.1f} us each), "
                f"round ends and set-up "
                f"{(r.device_ms - r.ks_window_ms) / 1e3:.3f}s")
    print(f"{tag} device spans {r.spans}, micro-iterations "
          f"{r.micro_iters} ({r.micro_iters / max(r.rounds, 1):.2f} per "
          f"round, {per:.3f} ms each in the loop), loop "
          f"{r.device_ms / 1e3:.3f}s (CUDA events) of span wall "
          f"{r.device_wall_ns / 1e9:.3f}s{kern}, aborts {r.aborts} "
          f"{r.abort_kind_counts()}, over caps {r.over_caps}; export "
          f"{r.export_bytes / 2**20:.1f} MiB in "
          f"{r.export_wall_ns / 1e9:.3f}s, import "
          f"{r.import_bytes / 2**20:.1f} MiB in "
          f"{r.import_wall_ns / 1e9:.3f}s (engine call + codec); law "
          f"calls {r.calls_all.tolist()} (committed "
          f"{r.ks_calls.tolist()}), windows {r.windows_all}", flush=True)


def phold_pair(name: str, make, min_share: float, codel,
               plain_run: bool = False) -> dict:
    """One PHOLD/udp-mesh cell through the port's Manager on the card:
    spans off, forced (every window one stt_phold_window launch) and,
    with `plain_run`, forced through the plain window (the law kernels
    launched per relay pass).  Requires one trace in every run, equal to
    the cell's digest from before the window kernel (DIGESTS), equal
    counters, device spans with no abort, `min_share` of the rounds on
    the card, family 1 with drops for the meshes (every CoDel drop where
    `codel`), no kernel in the C++ run and each forced run's launch gates
    (check_window_launches).  Returns each run's launches of every
    kernel, by path."""
    import hashlib

    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.ops.phold_window import eager_window

    tag = f"[{name}]"
    wrappers = kernel_wrappers()
    runs = {}
    for run_name in ("off", "force") + (("plain",) if plain_run else ()):
        spans = "off" if run_name == "off" else "force"
        t0 = time.perf_counter()
        mgr = Manager(make(spans), device="cuda")
        if run_name == "plain":
            mgr._dev_span = mgr.make_dev_span_runner()
            mgr._dev_span.window_factory = eager_window
        build_s = time.perf_counter() - t0
        # Counts cover this run only: zeroed just before it.
        for w in wrappers.values():
            w.launches = 0
        # Earlier runs' span state (held in reference cycles) freed first.
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = mgr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        lines = mgr.trace_lines()
        digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()
        r = mgr._dev_span
        codel_drops = sum(1 for ln in lines if ln.endswith("codel"))
        cut, want = PREFIX_DIGESTS.get(name, (0, ""))
        prefix = hashlib.sha256("\n".join(
            ln for ln in lines if int(ln.split(" ", 1)[0]) < cut
        ).encode()).hexdigest()
        runs[run_name] = dict(summary=summary, r=r, launches=launches,
                              digest=digest, prefix=prefix,
                              codel=codel_drops,
                              tcp=mgr._dev_span_tcp, wall=wall)
        print(f"{tag} {run_name}: {len(mgr.hosts)} hosts, rounds "
              f"{summary.rounds} (device {r.rounds if r else 0}), events "
              f"{summary.events}, packets {summary.packets_sent} sent / "
              f"{summary.packets_dropped} dropped ({codel_drops} by "
              f"CoDel), trace lines {len(lines)} sha256 {digest[:16]}, "
              f"Manager build {build_s:.1f}s, run wall {wall:.2f}s, "
              f"{summary.end_time_ns / 1e9 / wall:.4f} sim-s/wall-s, peak "
              f"device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              f"launches {launches}", flush=True)
        if r is not None and r.spans:
            print_run(f"{tag} {run_name}:", r)
            print_residency(tag, r)
            print_stages(tag, r)
        if not summary.ok:
            raise AssertionError(f"{tag} plugin errors: "
                                 f"{summary.plugin_errors[:3]}")
    off = runs["off"]
    so = off["summary"]
    if not off["digest"].startswith(DIGESTS[name]):
        raise AssertionError(f"{tag} the C++ run's trace is not "
                             f"{DIGESTS[name]}...")
    if name in PREFIX_DIGESTS and not off["prefix"].startswith(
            PREFIX_DIGESTS[name][1]):
        raise AssertionError(f"{tag} the C++ run's trace before "
                             f"{PREFIX_DIGESTS[name][0] / 1e9:g}s is not "
                             f"{PREFIX_DIGESTS[name][1]}...")
    if any(off["launches"].values()):
        raise AssertionError(f"{tag} the C++ run launched {off['launches']}")
    for run_name, run in runs.items():
        if run_name == "off":
            continue
        sd, r = run["summary"], run["r"]
        rtag = f"{tag} {run_name}:"
        if run["digest"] != off["digest"]:
            raise AssertionError(f"{rtag} trace sha256 differs from the C++ "
                                 f"run's")
        counters = [(s.events, s.packets_sent, s.packets_recv,
                     s.packets_dropped, s.syscalls) for s in (so, sd)]
        if counters[0] != counters[1]:
            raise AssertionError(f"{rtag} counters differ: {counters}")
        if r is None or r.spans == 0 or r.aborts:
            raise AssertionError(f"{rtag} device spans {r and r.spans}, "
                                 f"aborts {r and r.aborts}")
        if run["tcp"] is not None and run["tcp"].spans:
            raise AssertionError(f"{rtag} the TCP runner served a span")
        if r.rounds < min_share * sd.rounds:
            raise AssertionError(f"{rtag} only {r.rounds}/{sd.rounds} "
                                 f"rounds on the device "
                                 f"(< {min_share:.0%})")
        if r.resident_hits < r.spans - 1 - r.stale_drops:
            raise AssertionError(f"{rtag} {r.resident_hits} resident hits "
                                 f"over {r.spans} spans ({r.stale_drops} "
                                 f"stale)")
        if name.startswith("mesh") and (r.family != 1
                                        or sd.packets_dropped == 0):
            raise AssertionError(f"{rtag} family {r.family}, drops "
                                 f"{sd.packets_dropped}")
        if codel and run["codel"] != MESH_CODEL_DROPS:
            raise AssertionError(f"{rtag} {run['codel']} CoDel drops, not "
                                 f"{MESH_CODEL_DROPS}")
        check_window_launches(rtag, r, run["launches"],
                              kernel=run_name == "force")
    print(f"{tag} PASS: one trace ({off['digest'][:16]}"
          + (f"; before {PREFIX_DIGESTS[name][0] / 1e9:g}s "
             f"{off['prefix'][:16]}" if name in PREFIX_DIGESTS else "")
          + f") in "
          f"{len(runs)} runs, {runs['force']['r'].rounds}/"
          f"{runs['force']['summary'].rounds} rounds on the card, one "
          f"window-kernel launch per window "
          f"({runs['force']['launches']['phold_window']}); walls "
          + ", ".join(f"{k} {v['wall']:.2f}s" for k, v in runs.items()),
          flush=True)
    return {name if k == "force" else f"{name}/{k}": v["launches"]
            for k, v in runs.items() if k != "off"}


class EpochWatch:
    """Engine proxy that notes each call moving the engine's state_epoch
    since the last span import: what a stale resident carry is named
    by."""

    def __init__(self, eng):
        self._eng = eng
        self.moved = []

    def __getattr__(self, name):
        fn = getattr(self._eng, name)
        if not callable(fn) or name == "state_epoch":
            return fn

        def call(*a, **k):
            e0 = self._eng.state_epoch()
            out = fn(*a, **k)
            if name.startswith("span_import"):
                self.moved = []
            elif self._eng.state_epoch() != e0:
                self.moved.append(name)
            return out
        return call


def ring_runs() -> dict:
    """Phase 5: phold-64k-ring (ring_config) three times: spans off,
    forced with `span_overlap: off` (residency alone, through the plain
    window: the law kernels launched per relay pass) and forced with
    `auto` (the overlap, every window one stt_phold_window launch).
    Returns each run's launches of every kernel, by path."""
    import hashlib

    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.ops.phold_window import eager_window

    tag = "[phold-64k-ring]"
    wrappers = kernel_wrappers()
    runs = {}
    for name, spans, overlap in (("off", "off", "off"),
                                 ("residency", "force", "off"),
                                 ("overlap", "force", "auto")):
        t0 = time.perf_counter()
        mgr = Manager(ring_config(spans, overlap), device="cuda")
        watch = mgr.plane.engine = EpochWatch(mgr.plane.engine)
        r = None
        exports, stale_by = [], []
        if spans == "force":
            r = mgr._dev_span = mgr.make_dev_span_runner()
            for k, v in RING_CAPS.items():
                setattr(r, k, v)
            if name != "overlap":
                r.window_factory = eager_window
            export_state, try_span = r.export_state, r.try_span

            def counted_export(r=r, export_state=export_state,
                               exports=exports):
                b0 = r.export_bytes
                st = export_state()
                exports.append(r.export_bytes - b0)
                return st

            def named_try(*a, r=r, try_span=try_span, stale_by=stale_by,
                          **k):
                moved, stale0 = list(watch.moved), r.stale_drops
                res = try_span(*a, **k)
                if r.stale_drops > stale0:
                    stale_by.append(moved or ["(not seen)"])
                return res
            r.export_state, r.try_span = counted_export, named_try
        build_s = time.perf_counter() - t0
        # Counts cover this run only: zeroed just before it.
        for w in wrappers.values():
            w.launches = 0
        # Earlier runs' span state (held in reference cycles) freed first.
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = mgr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        lines = mgr.trace_lines()
        digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[name] = dict(summary=summary, r=r, launches=launches,
                          digest=digest, exports=exports,
                          stale_by=stale_by, wall=wall)
        print(f"{tag} {name}: spans={spans} span_overlap={overlap} "
              f"(resolved {mgr._span_overlap_on()}): rounds "
              f"{summary.rounds} (device {r.rounds if r else 0}), events "
              f"{summary.events}, packets {summary.packets_sent} sent, "
              f"trace lines {len(lines)} sha256 {digest[:16]}, Manager "
              f"build {build_s:.1f}s, run wall {wall:.2f}s, "
              f"{summary.end_time_ns / 1e9 / wall:.4f} sim-s/wall-s, peak "
              f"device memory {peak:.3f} GiB, launches {launches}",
              flush=True)
        if r is not None:
            print_run(f"{tag} {name}:", r)
            print(f"{tag} {name}: exports {len(exports)} (per export "
                  f"{[round(b / 2**20, 1) for b in exports]} MiB); stale "
                  f"drops named by {stale_by}", flush=True)
            print_residency(f"{tag} {name}:", r)
            print_stages(f"{tag} {name}:", r)
        if not summary.ok:
            raise AssertionError(f"{tag} plugin errors: "
                                 f"{summary.plugin_errors[:3]}")
    off = runs["off"]
    so = off["summary"]
    if any(off["launches"].values()):
        raise AssertionError(f"{tag} the C++ run launched {off['launches']}")
    if not off["digest"].startswith(DIGESTS["phold-64k-ring"]):
        raise AssertionError(f"{tag} the C++ run's trace is not "
                             f"{DIGESTS['phold-64k-ring']}...")
    for name in ("residency", "overlap"):
        run = runs[name]
        sd, r = run["summary"], run["r"]
        if run["digest"] != off["digest"]:
            raise AssertionError(f"{tag} {name}: trace sha256 differs from "
                                 f"the C++ run's")
        counters = [(s.events, s.packets_sent, s.packets_recv,
                     s.packets_dropped, s.syscalls) for s in (so, sd)]
        if counters[0] != counters[1]:
            raise AssertionError(f"{tag} {name}: counters differ: "
                                 f"{counters}")
        if r.spans == 0 or r.aborts:
            raise AssertionError(f"{tag} {name}: device spans {r.spans}, "
                                 f"aborts {r.aborts}")
        if r.rounds < 0.5 * sd.rounds:
            raise AssertionError(f"{tag} {name}: only {r.rounds}/"
                                 f"{sd.rounds} rounds on the device")
        if r.resident_hits < r.spans - 1 - r.stale_drops:
            raise AssertionError(f"{tag} {name}: {r.resident_hits} resident "
                                 f"hits over {r.spans} spans, "
                                 f"{r.stale_drops} stale drops")
        if not run["exports"] \
                or r.export_bytes >= 1.5 * max(run["exports"]):
            raise AssertionError(f"{tag} {name}: exports {run['exports']}")
        check_window_launches(f"{tag} {name}:", r, run["launches"],
                              kernel=name == "overlap")
    ro, rr = runs["overlap"]["r"], runs["residency"]["r"]
    if ro.overlap_windows < 1 or ro.overlap_hits < 1:
        raise AssertionError(f"{tag} overlap: {ro.overlap_summary()}")
    if rr.overlap_windows:
        raise AssertionError(f"{tag} residency: {rr.overlap_windows} "
                             f"speculative windows with span_overlap off")
    print(f"{tag} PASS: identical traces in all three runs, "
          f"{rr.rounds}/{runs['residency']['summary'].rounds} rounds on "
          f"the card, resident hits {rr.resident_hits} / "
          f"{ro.resident_hits} over {rr.spans} / {ro.spans} spans, overlap "
          f"windows {ro.overlap_windows} (hits {ro.overlap_hits}); run "
          f"walls off {off['wall']:.2f}s, residency "
          f"{runs['residency']['wall']:.2f}s, overlap "
          f"{runs['overlap']['wall']:.2f}s", flush=True)
    return {f"phold-64k-ring/{name}": run["launches"]
            for name, run in runs.items()}


def cli_overlap() -> None:
    """`python -m shadow_tpu_torch` on the card with `span_overlap: on`:
    a 512-LP PHOLD ring (the rung's generator) with forced device spans
    must exit 0 with a speculative window landed."""
    import os
    import tempfile

    from shadow_tpu_torch.tools.netgen import phold_yaml
    text = phold_yaml(512, n_init=1, mean_delay_ns=20_000_000,
                      stop_time="0.3s", seed=13, scheduler="tpu",
                      device_spans="force", peers_per_host=16).replace(
        "experimental:\n", "experimental:\n  span_overlap: on\n")
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "phold-512.yaml")
        with open(path, "w") as f:
            f.write(text)
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "shadow_tpu_torch", path],
                           cwd=root, capture_output=True, text=True,
                           timeout=600)
    tag = "[cli]"
    line = [ln for ln in p.stderr.splitlines()
            if ln.startswith("[shadow-tpu-torch] dispatch: ")]
    if p.returncode != 0 or not line:
        raise AssertionError(f"{tag} exit {p.returncode}: "
                             f"{p.stderr[-2000:]}")
    d = json.loads(line[-1].split(": ", 1)[1])
    ov = d["device_span_phold"]["overlap"]
    print(f"{tag} python -m shadow_tpu_torch (512 LPs, span_overlap: on) "
          f"in {time.perf_counter() - t0:.1f}s: {json.dumps(d)}",
          flush=True)
    if not d["span_overlap_on"] or ov["windows"] < 1 or ov["hits"] < 1:
        raise AssertionError(f"{tag} no speculative window landed: {d}")


def trace_digest(mgr) -> tuple[str, int, int]:
    """sha256 of the trace lines (joined by newlines), their count and
    the inet-loss drops among them."""
    import hashlib
    h = hashlib.sha256()
    n = losses = 0
    for ln in mgr.trace_lines():
        h.update(ln.encode() if not n else b"\n" + ln.encode())
        n += 1
        losses += "inet-loss" in ln
    return h.hexdigest(), n, losses


def propagate_run(tag: str, name: str, cfg) -> dict:
    """One run of a per-round propagation cell through the port's
    Manager on the card, every kernel's launch counters zeroed just
    before it.  Prints the run, the route split in bench.py's words, the
    packets per round and each device-route phase's wall per dispatch."""
    from shadow_tpu_torch.core.manager import Manager
    t0 = time.perf_counter()
    mgr = Manager(cfg, device="cuda")
    build_s = time.perf_counter() - t0
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    wrappers["propagate"].probe_launches = 0
    gc.collect()
    t0 = time.perf_counter()
    summary = mgr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    probe_launches = wrappers["propagate"].probe_launches
    digest, nlines, losses = trace_digest(mgr)
    block = mgr.dispatch_summary()["propagate"]
    dev_span_rounds = sum(r.rounds for r in (mgr._dev_span,
                                             mgr._dev_span_tcp) if r)
    rd, tot_r = block["rounds_device"], block["rounds_dispatched"]
    pd, tot_p = block["packets_device"], block["packets_batched"]
    print(f"{tag} {name}: tpu_min_device_batch "
          f"{cfg.experimental.tpu_min_device_batch}: {len(mgr.hosts)} "
          f"hosts, rounds {summary.rounds} (span rounds "
          f"{summary.span_rounds}, of which device {dev_span_rounds}), "
          f"events {summary.events}, packets {summary.packets_sent} sent / "
          f"{summary.packets_recv} received / {summary.packets_dropped} "
          f"dropped ({losses} inet-loss), busy_end {summary.busy_end_ns}, "
          f"trace lines {nlines} sha256 {digest[:16]}, Manager build "
          f"{build_s:.1f}s, run wall {wall:.2f}s, "
          f"{summary.end_time_ns / 1e9 / wall:.4f} sim-s/wall-s", flush=True)
    print(f"{tag} {name}: dispatch split: {rd}/{tot_r} rounds on device, "
          f"{pd}/{tot_p} packets on device "
          f"({100.0 * pd / tot_p if tot_p else 0.0:.1f}%); probes "
          f"{block['probes_async']}; stt_propagate launches {launches['propagate']} "
          f"(probes {probe_launches}); packets per round "
          f"{block['packets_per_round']}; host route "
          f"{block['walls_ms']['host_route']:.1f} ms; device route per "
          f"dispatch (us): "
          f"{ {k: round(v, 2) for k, v in block['per_device_round_us'].items()} }",
          flush=True)
    if not summary.ok:
        raise AssertionError(f"{tag} {name}: plugin errors "
                             f"{summary.plugin_errors[:3]}")
    return dict(summary=summary, digest=digest, losses=losses, block=block,
                launches=launches, probe_launches=probe_launches,
                dev_span_rounds=dev_span_rounds, wall=wall,
                host_ns_per_pkt=mgr.propagator.route.host_ns_per_pkt)


def kernel_wrappers() -> dict:
    from shadow_tpu_torch.ops import queues, tcp_span
    from shadow_tpu_torch.ops.phold_window import PHOLD_WINDOW
    from shadow_tpu_torch.ops.propagate import PROPAGATE
    return {"bucket_step": queues.BUCKET_STEP,
            "codel_head": queues.CODEL_HEAD,
            "relay1_law": tcp_span.RELAY1_LAW,
            "relay2_law": tcp_span.RELAY2_LAW,
            "propagate": PROPAGATE,
            "phold_window": PHOLD_WINDOW}


def check_forced(tag: str, run: dict) -> None:
    """Every round's propagation went through stt_propagate: launches =
    device rounds = dispatched rounds, no probe, no host measurement, no
    span of either kind, no other kernel."""
    b, n = run["block"], run["launches"]["propagate"]
    if not (b["rounds_device"] == b["rounds_dispatched"] == n > 0) \
            or run["probe_launches"] or b["probes_async"] \
            or run["host_ns_per_pkt"] is not None \
            or run["summary"].span_rounds \
            or any(v for k, v in run["launches"].items()
                   if k != "propagate"):
        raise AssertionError(f"{tag} forced: {b}, launches "
                             f"{run['launches']} (probes "
                             f"{run['probe_launches']}), span rounds "
                             f"{run['summary'].span_rounds}")


def same_results(tag: str, runs: dict) -> None:
    names = list(runs)
    first = runs[names[0]]
    for name in names[1:]:
        a, b = first["summary"], runs[name]["summary"]
        if runs[name]["digest"] != first["digest"]:
            raise AssertionError(f"{tag} trace sha256 differs between "
                                 f"{names[0]} and {name}")
        ca = (a.packets_sent, a.packets_recv, a.packets_dropped,
              a.busy_end_ns, a.events)
        cb = (b.packets_sent, b.packets_recv, b.packets_dropped,
              b.busy_end_ns, b.events)
        if ca != cb:
            raise AssertionError(f"{tag} {names[0]} vs {name}: {ca} != {cb}")


def tier10k_runs() -> dict:
    """Phase 6, tier10k: bench.py config_10k (BASELINE config 4, the
    reference's headline: 10,000 hosts, the 3-tier graph, seed 7) run
    host-only (every per-round round on the C++ twin), auto (the route
    model with async probes) and forced (every round through
    stt_propagate, no span)."""
    from shadow_tpu_torch.ops.propagate import HOST_ONLY
    from shadow_tpu_torch.tools.netgen import SIM_SECONDS_10K, tier10k_yaml
    tag = "[tier10k]"
    t0 = time.perf_counter()
    text = tier10k_yaml("tpu")
    base = parse_yaml(text)
    print(f"{tag} 10,000 hosts (500 relays, 9,500 clients x 3 x 25,000 B), "
          f"stop_time {SIM_SECONDS_10K}s; YAML {len(text) / 2**20:.1f} MiB parsed "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)
    runs = {name: propagate_run(tag, name, config_with(
                base, tpu_min_device_batch=mdb))
            for name, mdb in (("host-only", HOST_ONLY), ("auto", 2048),
                              ("forced", 0))}
    same_results(tag, runs)
    check_forced(tag, runs["forced"])
    auto, host = runs["auto"], runs["host-only"]
    b = auto["block"]
    if auto["launches"]["propagate"] != b["rounds_device"] \
            or auto["probe_launches"] != b["probes_async"]:
        raise AssertionError(f"{tag} auto: launches "
                             f"{auto['launches']['propagate']} + probes "
                             f"{auto['probe_launches']} vs rounds_device "
                             f"{b['rounds_device']} + probes_async "
                             f"{b['probes_async']}")
    if host["launches"]["propagate"] or host["probe_launches"] \
            or host["block"]["rounds_device"]:
        raise AssertionError(f"{tag} host-only: {host['block']}")
    print(f"{tag} PASS: one trace in all three runs; forced "
          f"{runs['forced']['block']['rounds_device']} rounds, each one "
          f"stt_propagate launch; auto {b['rounds_device']} device rounds "
          f"+ {b['probes_async']} probes = "
          f"{auto['launches']['propagate'] + auto['probe_launches']} "
          f"launches; walls host-only {host['wall']:.2f}s, auto "
          f"{auto['wall']:.2f}s, forced {runs['forced']['wall']:.2f}s",
          flush=True)
    return runs


def mesh100_runs() -> dict:
    """Phase 6, mesh-100: bench.py mesh_config (BASELINE config 2: 100
    hosts, udp-mesh 30 x 200 B to each of 99 peers, 10 ms, 1% loss,
    seed 3, 30 s), host-only and forced."""
    from shadow_tpu_torch.ops.propagate import HOST_ONLY
    from shadow_tpu_torch.tools.netgen import mesh100_yaml
    tag = "[mesh-100]"
    base = parse_yaml(mesh100_yaml("tpu"))
    runs = {name: propagate_run(tag, name, config_with(
                base, tpu_min_device_batch=mdb))
            for name, mdb in (("host-only", HOST_ONLY), ("forced", 0))}
    same_results(tag, runs)
    check_forced(tag, runs["forced"])
    if runs["forced"]["losses"] == 0:
        raise AssertionError(f"{tag} no inet-loss drop")
    print(f"{tag} PASS: identical traces, "
          f"{runs['forced']['losses']} inet-loss drops, forced "
          f"{runs['forced']['block']['rounds_device']} rounds each one "
          f"stt_propagate launch", flush=True)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stop-time", default="1.25s",
                    help="simulated time of the 10,000-host TCP stream")
    args = ap.parse_args(argv)
    kind = card()
    build_all()
    law_stats = check_kernels()
    stats = {name: law_stats[(name, H_RING)]
             for name in ("bucket_step", "codel_head")}
    relay_stats = check_relay_kernels()
    check_propagate()
    window_stats = check_phold_window()
    by_path: dict = {}
    # The main path of the relay kernels: the 10,000-host stream.  Its
    # fleet enters the TCP device-span domain only at 1.23 s simulated
    # (every client's GET acked, every rtx/reassembly ring under half its
    # cap), and the eager loop takes minutes per simulated 10 ms at this
    # width, so the run ends a few rounds into the device stretch: the
    # device share here is small by construction (PERF.md).
    print(f"[main] stop_time {args.stop_time}: cut from 1s upward to "
          f"reach the device-span domain (entered at 1.23 s) and kept "
          f"short for the time limit", flush=True)
    by_path["tcp-stream-10k"], occupancy = stream_pair(
        H_MAIN, args.stop_time, min_share=0.0)
    # The device share at a width the eager loop finishes in time; the
    # router's first window is 4 rounds, so the device stretch takes
    # several spans and TCP residency and the overlap show on the card.
    stream_pair(16, "500ms", min_share=0.5, k_init=4)
    # The main path of the standalone law kernels: the PHOLD/udp-mesh
    # family, phold-8k first.
    for name, (make, share, codel) in phold_cells().items():
        by_path.update(phold_pair(name, make, share, codel,
                                  plain_run=name == "phold-8k"))
    # The law kernels' main path: phold-64k-ring with residency and the
    # speculative overlap; then the overlap through the CLI.
    by_path.update(ring_runs())
    cli_overlap()
    # Phase 6: per-round device propagation.  The main path of
    # stt_propagate: tier10k forced, every round through the kernel.
    for cell, runs in (("tier10k", tier10k_runs()),
                       ("mesh-100", mesh100_runs())):
        for name, run in runs.items():
            by_path[f"{cell}/{name}"] = dict(
                run["launches"], propagate_probes=run["probe_launches"])
            if cell == "tier10k" and name == "forced":
                per_round = run["block"]["packets_per_round"]
    # The kernel's row: timed at the main path's median round.
    print(f"[main] propagate: the forced tier10k run's packets per round "
          f"{per_round}; the kernels line's row is timed at the median",
          flush=True)
    stats["propagate"] = time_propagate(per_round["median"])
    # The relay kernels' row: the mask density nearest the main path's
    # mean lanes per fire of the relay stage.
    from shadow_tpu_torch.ops.tcp_span import KS_CODEL, KS_INET_OUT
    for name, code in (("relay1_law", KS_INET_OUT),
                       ("relay2_law", KS_CODEL)):
        occ = occupancy[code]
        dens = min(DENSITIES, key=lambda d: abs(np.log(d * H_MAIN)
                                                 - np.log(max(occ, 1))))
        row = relay_stats[(name, dens)]
        per_lane = (row["bytes"] - 5 * H_MAIN) / row["lanes"]
        main_bound = (5 * H_MAIN + occ * per_lane) / BANDWIDTH * 1e3
        print(f"[main] {name}: {occ:.1f} lanes per launch on the main "
              f"path; bound there {main_bound * 1e3:.3f} us at the branch "
              f"cases' {per_lane:.0f} B per mask lane (density {dens:g}, "
              f"the kernels line's row)", flush=True)
        stats[name] = dict(row, max_abs_err=max(
            relay_stats[(name, d)]["max_abs_err"] for d in DENSITIES))
    # The window kernel's row: timed on the phold-64k-ring export.
    stats["phold_window"] = window_stats["phold-64k-ring"]
    # `launches`: the count on each kernel's main path (tcp-stream-10k
    # for the relay kernels; phold-64k-ring with residency alone, through
    # the plain window, for the law kernels; phold-64k-ring with the
    # overlap for the window kernel); `launches_by_path`: every path's
    # count, each zeroed just before its run.
    main_path = {"bucket_step": "phold-64k-ring/residency",
                 "codel_head": "phold-64k-ring/residency",
                 "relay1_law": "tcp-stream-10k",
                 "relay2_law": "tcp-stream-10k",
                 "propagate": "tier10k/forced",
                 "phold_window": "phold-64k-ring/overlap"}
    # library_ms: no single PyTorch call computes any of these laws.
    kernels = [{"name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name],
                "launches": by_path[main_path[name]][name],
                "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s.get("bound_by", "bytes"), "library_ms": None,
                "graph_ms": s.get("graph_ms"), "call_ms": s["call_ms"],
                "main_path": main_path[name],
                "launches_by_path": {p: n[name]
                                     for p, n in by_path.items()}}
               for name, s in stats.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
