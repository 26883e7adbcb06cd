"""Time the per-round device route of one tree of the port on a card.

    PYTHONPATH=<tree> python3 shadow_tpu_torch/tools/propagate_ab.py \
        --label parent [--sizes 150,1000] [--reps 2000] [--tier10k] \
        [--mesh100]

It runs against whichever `shadow_tpu_torch` the path gives and uses
only what every tree since per-round propagation was ported has, so two
trees (a `git archive` of one under the gitignored `_checkout/`) are
compared in one call by running it once per tree in turns (parent,
change, change, parent).  One JSON line per measurement, with the card's
name and power limit:

1. `dispatch`: at each of `--sizes` packets, a forced `TpuPropagator`
   on the card over a stand-in engine whose `export_round` gives the
   same seeded columns every round and whose `scatter_round` takes the
   result views and returns; `_engine_device_round` `--reps` times after
   a warm-up; microseconds per round of each device-route phase
   (`per_device_round_us`: export, upload, launch, kernel, download,
   scatter) and of the whole call, and the kernel's launches.
2. `tier10k` (with `--tier10k`): bench.py config_10k (10,000 hosts, 10
   s) host-only and forced through the Manager: run wall, the trace's
   sha256, rounds, launches and `per_device_round_us`.
3. `mesh-100` (with `--mesh100`): bench.py mesh_config (100 hosts, one
   297,000-packet round) forced, the same.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

import numpy as np


def card() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("propagate_ab: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return {"card": torch.cuda.get_device_name(0), "smi": smi}


class StandInEngine:
    """export_round's seven byte columns of one seeded n-packet round on
    the 3-tier graph (V = 3), the same every round; scatter_round takes
    the decisions and returns finish_round's shape."""

    def __init__(self, n: int, seed: int = 5):
        rng = np.random.default_rng(seed)
        self.n = n
        self.cols = (
            rng.integers(0, 3, n).astype(np.int32).tobytes(),
            rng.integers(0, 3, n).astype(np.int32).tobytes(),
            rng.integers(0, 10_000, n).astype(np.int32).tobytes(),
            rng.integers(0, 10_000, n, dtype=np.int64).tobytes(),
            rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
                np.uint32).tobytes(),
            rng.integers(0, 10_000_000_000, n, dtype=np.int64).tobytes(),
            (rng.random(n) < 0.2).astype(np.uint8).tobytes())

    def export_round(self):
        return self.cols

    def scatter_round(self, keep, deliver, reachable, lossy):
        if len(keep) != self.n or len(memoryview(deliver)) != self.n:
            raise AssertionError("scatter_round got a short column")
        return self.n, 0, 0, None


def dispatch(n: int, reps: int) -> dict:
    """`reps` device rounds of n packets through a forced propagator."""
    from shadow_tpu_torch.net.graph import NetworkGraph, routing_arrays
    from shadow_tpu_torch.ops.propagate import PROPAGATE, TpuPropagator
    from shadow_tpu_torch.tools.netgen import THREE_TIER_GML
    lat, thr = routing_arrays(NetworkGraph.from_gml(THREE_TIER_GML))
    p = TpuPropagator(lat, thr, 7, 0, min_device_batch=0, device="cuda")
    p.engine = StandInEngine(n)
    p.window_end = 5_000_000_000
    for _ in range(20):
        p._engine_device_round(n)
    p.phase_ns = dict.fromkeys(p.phase_ns, 0)
    launches = PROPAGATE.launches
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        p._engine_device_round(n)
    wall = time.perf_counter_ns() - t0
    p.rounds_device = reps  # the summary's rounds (the loop bypasses it)
    return {"n": n, "reps": reps, "round_us": wall / reps / 1e3,
            "per_round_us": p.summary()["per_device_round_us"],
            "launches": PROPAGATE.launches - launches}


def cell_run(cell: str, name: str, min_batch: int) -> dict:
    """One run of `cell` (netgen's copy of a bench.py config) through the
    Manager on the card."""
    import torch
    from shadow_tpu_torch.core.config import ConfigOptions
    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.ops.propagate import PROPAGATE
    from shadow_tpu_torch.tools import netgen
    make = {"tier10k": netgen.tier10k_yaml,
            "mesh-100": netgen.mesh100_yaml}[cell]
    cfg = ConfigOptions.from_yaml_text(make("tpu"))
    cfg.experimental.tpu_min_device_batch = min_batch
    mgr = Manager(cfg, device="cuda")
    PROPAGATE.launches = PROPAGATE.probe_launches = 0
    t0 = time.perf_counter()
    s = mgr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    block = mgr.dispatch_summary()["propagate"]
    lines = mgr.trace_lines()
    return {"run": name, "wall_s": wall, "rounds": s.rounds,
            "span_rounds": s.span_rounds,
            "sha256": hashlib.sha256(
                "\n".join(lines).encode()).hexdigest()[:16],
            "rounds_device": block["rounds_device"],
            "rounds_dispatched": block["rounds_dispatched"],
            "launches": PROPAGATE.launches,
            "packets_per_round": block["packets_per_round"],
            "per_device_round_us": block["per_device_round_us"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--sizes", default="150,1000")
    ap.add_argument("--reps", type=int, default=2000)
    ap.add_argument("--tier10k", action="store_true")
    ap.add_argument("--mesh100", action="store_true")
    args = ap.parse_args(argv)
    head = dict(card(), label=args.label)
    for n in (int(x) for x in args.sizes.split(",")):
        print(json.dumps(dict(head, kind="dispatch",
                              **dispatch(n, args.reps))), flush=True)
    if args.tier10k:
        from shadow_tpu_torch.ops.propagate import HOST_ONLY
        for name, mdb in (("host-only", HOST_ONLY), ("forced", 0)):
            print(json.dumps(dict(head, kind="tier10k",
                                  **cell_run("tier10k", name, mdb))),
                  flush=True)
    if args.mesh100:
        print(json.dumps(dict(head, kind="mesh-100",
                              **cell_run("mesh-100", "forced", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
