"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--stop-time 1s]

Three phases; any failed check raises, so the script exits non-zero:

1. Identify the card (name, and name + power limit from nvidia-smi).
2. Build the engine and the two kernel libraries from this checkout
   (in parallel), hold each kernel against its plain PyTorch version on
   the card and time both:
   - the standalone law kernels (stt_bucket_step, stt_codel_head) on
     adversarial integer inputs at H = 10,000, a ragged H = 10,001 and
     a scalar `now`;
   - the fused relay kernels (stt_relay1_law, stt_relay2_law) at
     H = 10,000 with the span's ring widths, on lanes built to reach
     every branch (tools/relay_cases.py) at mask densities of 0.1%, 10%
     and 100%: every state word, every flag, the packet handed back on
     the lanes that carried one and the refill instant on the throttled
     lanes, exactly equal; card time with every launch on a fresh copy
     of the checked state, and the bound from the bytes each lane's
     branch needs.
3. Run the main path: the 10,000-host tgen TCP bulk stream through the
   port's Manager on the card, once with the C++ engine serving every
   round (`tpu_device_spans: off`) and once with forced device spans,
   and require identical traces, device spans, each relay kernel
   launched once per fire of its stage by the device run and the
   standalone law kernels never (their laws run inside the relay
   kernels); print the per-stage
   fire/lane counters.  Then the same stream at 16 hosts, where at
   least half the rounds must run on the card.

It prints a `kernels` JSON line before the last line, and as the last
line `{"ok": true, "device": {...}}`.  It imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
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
BYTES_PER_LANE = {"bucket_step": 66, "codel_head": 46}
REPLACES = {"bucket_step": "shadow_tpu/ops/pallas_queues.py:80",
            "codel_head": "shadow_tpu/ops/pallas_queues.py:119",
            "relay1_law": "shadow_tpu/ops/pallas_queues.py:80",
            "relay2_law": "shadow_tpu/ops/pallas_queues.py:119"}
SOURCE = {"bucket_step": "shadow_tpu_torch/csrc/queues.cu",
          "codel_head": "shadow_tpu_torch/csrc/queues.cu",
          "relay1_law": "shadow_tpu_torch/csrc/relay.cu",
          "relay2_law": "shadow_tpu_torch/csrc/relay.cu"}
DENSITIES = (0.001, 0.1, 1.0)


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
    from shadow_tpu_torch.ops import queues, relay
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
                         ("relay.cu", relay.LIBRARY.build))]
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
          f"{relay.LIBRARY.build_s:.1f}s)", flush=True)


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
    from shadow_tpu_torch.ops.tcp_span import BUCKET_STEP, CODEL_HEAD
    bs, ch = BUCKET_STEP, CODEL_HEAD
    stats = {}

    def calls(t, scalar_now):
        now = t["now"][0] if scalar_now else t["now"]
        b_args = (t["bal"], t["nxt"], t["refill"], t["cap"],
                  t["unlimited"], t["size"], now)
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

    def launch(name, reps):
        # `reps` back-to-back kernel launches from C (timing only;
        # counted nowhere).
        if name == "bucket_step":
            bs.launch(t["bal"], t["nxt"], t["refill"], t["cap"],
                      t["unlimited"], t["size"], t["now"], reps=reps)
        else:
            ch.launch(t["pop"], t["none"], t["now"], t["enq"],
                      t["bytes_after"], t["first_above"], reps=reps)

    for H in (H_MAIN, H_MAIN + 1):
        t = adversarial(H)
        for scalar_now in (False, True):
            for name, (kern, plain) in calls(t, scalar_now).items():
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
                if H == H_MAIN and not scalar_now:
                    reps = 1000
                    ms = events_ms(lambda: launch(name, reps), reps)
                    gms = graph_ms(lambda: launch(name, 1), 200)
                    call_ms = events_ms(
                        lambda: [kern() for _ in range(reps)], reps)
                    pms = graph_ms(plain)
                    bound = BYTES_PER_LANE[name] * H / BANDWIDTH * 1e3
                    stats[name] = {"ms": ms, "graph_ms": gms,
                                   "plain_ms": pms, "call_ms": call_ms,
                                   "bound_ms": bound, "max_abs_err": err}
                print(f"[kernel] {name} H={H} scalar_now={scalar_now}: "
                      f"exact (max |err| {err})", flush=True)
    for name, s in stats.items():
        print(f"[kernel] {name} H={H_MAIN}: {s['ms'] * 1e3:.3f} us per "
              f"launch on the card (back-to-back launches), "
              f"{s['graph_ms'] * 1e3:.3f} us in a CUDA graph, "
              f"{s['call_ms'] * 1e3:.2f} us per wrapper call from Python; "
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


def stream_pair(n_hosts: int, stop_time: str, min_share: float):
    """The tgen TCP bulk stream (tools/span_loop_bench.stream_config)
    through the port's Manager on the card, once with the C++ engine
    serving every round and once with forced device spans.  Requires
    identical traces, packets and events, a device span, at least
    `min_share` of the rounds on the card, each relay kernel launched
    once per fire of its stage and the standalone law kernels never.
    Returns the device run's kernel launch counts and its runner."""
    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.ops import tcp_span
    from shadow_tpu_torch.tools.span_loop_bench import (run_stream,
                                                        stream_config)

    tag = f"[stream {n_hosts}]"
    print(f"{tag} {n_hosts} hosts ({max(1, n_hosts // 8)} tgen servers), "
          f"stop_time {stop_time}", flush=True)
    runs = {}
    for spans in ("off", "force"):
        mgr = Manager(stream_config(n_hosts, stop_time, spans),
                      device="cuda")
        if spans == "force":
            log_spans(mgr)
        wrappers = {"bucket_step": tcp_span.BUCKET_STEP,
                    "codel_head": tcp_span.CODEL_HEAD,
                    "relay1_law": tcp_span.RELAY1_LAW,
                    "relay2_law": tcp_span.RELAY2_LAW}
        # Counts cover this run only: zeroed just before it.
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        run = run_stream(mgr)
        run["launches"] = {name: w.launches for name, w in wrappers.items()}
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
    launches = dev["launches"]
    # One launch per fire of the relay stage: the fire counters cover
    # committed spans, so an aborted span's launches only add.
    for name, code in (("relay1_law", tcp_span.KS_INET_OUT),
                       ("relay2_law", tcp_span.KS_CODEL)):
        fires = int(r.ks_fires[code])
        if fires <= 0 or launches[name] < fires \
                or (r.aborts == 0 and launches[name] != fires):
            raise AssertionError(f"{tag} {name} launched {launches[name]} "
                                 f"times for {fires} fires of its stage "
                                 f"({r.aborts} aborted spans)")
    # The laws run inside the relay kernels: the span loop launches no
    # standalone law kernel.
    for name in ("bucket_step", "codel_head"):
        if launches[name] != 0:
            raise AssertionError(f"{tag} the span loop launched {name} "
                                 f"{launches[name]} times")
    print(f"{tag} PASS: identical traces, {r.rounds}/{sd.rounds} rounds "
          f"on the card, one relay launch per relay fire", flush=True)
    return launches, r


def print_stages(tag, r) -> None:
    """The runner's per-stage counters over its committed spans: fires,
    lanes, lanes per fire, and host wall from each guard's sync to the
    end of the stage's issue (so the kernels' device time hides in the
    next sync)."""
    from shadow_tpu_torch.ops.tcp_span import KS_NAMES
    print(f"{tag} stages over {r.micro_iters} micro-iterations "
          f"(name: fires, lanes, lanes/fire, host s, ms/fire):", flush=True)
    for code, name in enumerate(KS_NAMES):
        f, n, w = int(r.ks_fires[code]), int(r.ks_lanes[code]), \
            float(r.ks_wall_s[code])
        if f:
            print(f"{tag}   {name}: {f}, {n}, {n / f:.1f}, {w:.3f}, "
                  f"{w / f * 1e3:.3f}", flush=True)
    print(f"{tag} stage host wall total {r.ks_wall_s.sum():.3f}s of "
          f"{r.device_ms / 1e3:.3f}s loop", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stop-time", default="1.25s",
                    help="simulated time of the 10,000-host runs")
    args = ap.parse_args(argv)
    kind = card()
    build_all()
    stats = check_kernels()
    relay_stats = check_relay_kernels()
    # The main path: the 10,000-host stream.  Its fleet enters the TCP
    # device-span domain only at 1.23 s simulated (every client's GET
    # acked, every rtx/reassembly ring under half its cap), and the
    # eager loop takes minutes per simulated 10 ms at this width, so
    # the run ends a few rounds into the device stretch: the device
    # share here is small by construction (PERF.md).
    print(f"[main] stop_time {args.stop_time}: cut from 1s upward to "
          f"reach the device-span domain (entered at 1.23 s) and kept "
          f"short for the time limit", flush=True)
    launches, runner = stream_pair(H_MAIN, args.stop_time, min_share=0.0)
    # The device share at a width the eager loop finishes in time.
    stream_pair(16, "500ms", min_share=0.5)
    # The relay kernels' row: the mask density nearest the main path's
    # mean lanes per fire of the relay stage.
    from shadow_tpu_torch.ops.tcp_span import KS_CODEL, KS_INET_OUT
    for name, code in (("relay1_law", KS_INET_OUT),
                       ("relay2_law", KS_CODEL)):
        occ = runner.ks_lanes[code] / max(runner.ks_fires[code], 1)
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
    kernels = [{"name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": "bytes", "library_ms": None,
                "graph_ms": s.get("graph_ms"), "call_ms": s["call_ms"]}
               for name, s in stats.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
