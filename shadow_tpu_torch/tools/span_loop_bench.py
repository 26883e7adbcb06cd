"""The tgen TCP bulk stream of `chip_smoke.py`, and a timer of its TCP
device-span loop on the card.

    python3 -m shadow_tpu_torch.tools.span_loop_bench --hosts 16 \
        --stop-time 500ms [--repeat 1]

`stream_config` is the stream (`tools/netgen.tcp_stream_yaml`: 1 tgen
server per 8 hosts, 50 MB per client, 0.5% loss, 10 ms, 50 Mbit, seed
11, `scheduler: tpu`) and `run_stream` runs it through the port's
Manager; `chip_smoke.py` runs both with spans off and forced.  As a
script this runs the stream with forced device spans and prints one JSON
line per run: the card, rounds on the device, micro-iterations, the
loop's CUDA-event time and ms per micro-iteration, the whole run's wall,
a sha256 of the trace and the runner's per-stage fires/lanes/host wall.
To compare two trees on one card, run it by path with PYTHONPATH
pointing at each tree's root in turn, in one call.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time


def stream_config(n_hosts: int, stop_time: str, device_spans: str):
    """The bulk stream at `n_hosts` hosts, `stop_time` simulated, with
    `tpu_device_spans` set to `device_spans` ("off" or "force")."""
    from shadow_tpu_torch.core.config import ConfigOptions
    from shadow_tpu_torch.tools.netgen import tcp_stream_yaml
    return ConfigOptions.from_yaml_text(tcp_stream_yaml(
        n_hosts, n_servers=max(1, n_hosts // 8), nbytes=50_000_000,
        loss=0.005, latency="10 ms", bw_down="50 Mbit", bw_up="50 Mbit",
        stop_time=stop_time, seed=11, scheduler="tpu",
        device_spans=device_spans))


def run_stream(mgr) -> dict:
    """Run a Manager of the stream on the card: its summary, wall (after
    the card drains), trace line count and sha256, and span runner."""
    import torch
    t0 = time.perf_counter()
    summary = mgr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = mgr.trace_lines()
    return {"summary": summary, "wall": wall, "lines": len(lines),
            "digest": hashlib.sha256("\n".join(lines).encode()).hexdigest(),
            "runner": mgr._dev_span_tcp}


def run_once(n_hosts: int, stop_time: str) -> dict:
    from shadow_tpu_torch.core.manager import Manager
    res = run_stream(Manager(stream_config(n_hosts, stop_time, "force"),
                             device="cuda"))
    r, summary = res["runner"], res["summary"]
    return {"hosts": n_hosts, "stop_time": stop_time, "ok": summary.ok,
            "rounds": summary.rounds, "device_rounds": r.rounds,
            "micro_iters": r.micro_iters, "loop_s": r.device_ms / 1e3,
            "ms_per_micro_iter": r.device_ms / max(r.micro_iters, 1),
            "span_wall_s": r.device_wall_ns / 1e9, "wall_s": res["wall"],
            "trace_sha256": res["digest"],
            "ks_fires": r.ks_fires.tolist(), "ks_lanes": r.ks_lanes.tolist(),
            "ks_wall_s": r.ks_wall_s.tolist()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hosts", type=int, default=16)
    ap.add_argument("--stop-time", default="500ms")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("span_loop_bench: no CUDA card; nothing was run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for _ in range(args.repeat):
        res = run_once(args.hosts, args.stop_time)
        res["card"] = smi
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
