"""Span residency with the speculative overlap off and on, in turns, in
one process on one card.

    python3 -m shadow_tpu_torch.tools.overlap_ab --cell phold-64k-ring \
        [--pairs 2]

Runs the cell with forced device spans once to warm the process up (the
first run pays the allocator's growth; its line says `"warmup": true`),
then with `span_overlap` off, on, on, off, ... (`--pairs` of each), and
prints one JSON line per run: the
card and its power limit, the run's wall, rounds on the card,
micro-iterations and the loop's CUDA-event time per micro-iteration,
the codec's walls, the clone's time, the overlap block and the trace's
sha256 (which must be the same in every run).  The cells are
`chip_smoke.py` phase 5's phold-64k-ring (65,536 LPs, the reference
rung's ring caps, 1.0 s) and phase 4's mesh-24 (24 hosts, here to 1 s).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

# The reference rung's ring caps (bench.py phold_rung), as chip_smoke.py
# sets them on the PHOLD runner.
RING_CAPS = dict(CAP_I=32, CAP_T=16, CAP_R=64, CAP_S=64, CAP_C=256,
                 CAP_P=16)


def cell_text(cell: str) -> str:
    from shadow_tpu_torch.tools.netgen import mesh_family_yaml, phold_yaml
    if cell == "phold-64k-ring":
        return phold_yaml(65_536, n_init=1, mean_delay_ns=20_000_000,
                          stop_time="1.0s", seed=13, scheduler="tpu",
                          device_spans="force", peers_per_host=16)
    return mesh_family_yaml(24, scheduler="tpu", device_spans="force",
                            stop_time="1s")


def run_once(cell: str, base: dict, overlap: str) -> dict:
    import copy

    import torch

    from shadow_tpu_torch.core.config import ConfigOptions
    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.ops.propagate import HOST_ONLY
    d = copy.deepcopy(base)
    d["experimental"]["span_overlap"] = overlap
    # Every per-round round on the C++ twin: spans alone are compared.
    d["experimental"]["tpu_min_device_batch"] = HOST_ONLY
    mgr = Manager(ConfigOptions.from_dict(d), device="cuda")
    r = mgr._dev_span = mgr.make_dev_span_runner()
    if cell == "phold-64k-ring":
        for k, v in RING_CAPS.items():
            setattr(r, k, v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = mgr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = mgr.trace_lines()
    return {"cell": cell, "span_overlap": overlap, "ok": summary.ok,
            "wall_s": wall, "rounds": summary.rounds,
            "device_rounds": r.rounds, "spans": r.spans,
            "aborts": r.aborts, "resident_hits": r.resident_hits,
            "micro_iters": r.micro_iters, "loop_s": r.device_ms / 1e3,
            "ms_per_micro_iter": r.device_ms / max(r.micro_iters, 1),
            "export_s": r.export_wall_ns / 1e9,
            "import_s": r.import_wall_ns / 1e9,
            "clone_ms": r.clone_ms, "clone_gib": r.clone_bytes / 2**30,
            "overlap": r.overlap_summary(),
            "trace_sha256": hashlib.sha256(
                "\n".join(lines).encode()).hexdigest()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", choices=["phold-64k-ring", "mesh-24"],
                    default="phold-64k-ring")
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    import yaml
    if not torch.cuda.is_available():
        raise SystemExit("overlap_ab: no CUDA card; nothing was run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    base = yaml.load(cell_text(args.cell),
                     Loader=getattr(yaml, "CSafeLoader", yaml.SafeLoader))
    order = ["off"]
    for i in range(args.pairs):
        order += ["off", "on"] if i % 2 == 0 else ["on", "off"]
    digests = set()
    for i, overlap in enumerate(order):
        res = run_once(args.cell, base, overlap)
        res["card"] = smi
        res["warmup"] = i == 0
        digests.add(res["trace_sha256"])
        print(json.dumps(res), flush=True)
    if len(digests) != 1:
        raise SystemExit(f"overlap_ab: traces differ between runs "
                         f"({sorted(digests)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
