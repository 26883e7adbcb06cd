"""CLI: `python -m shadow_tpu_torch [options] config.yaml`.

Load the YAML, apply the overrides, run the simulation on the card (or
on the CPU with `--device cpu`), print the summary, and exit nonzero if
any process ended in an unexpected state.  Writing a data directory is
not ported yet (ROADMAP A4).
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shadow-tpu-torch",
        description="shadow-tpu on PyTorch/CUDA (engine-resident slice)")
    p.add_argument("config", help="YAML simulation config")
    p.add_argument("--seed", type=int, help="override general.seed")
    p.add_argument("--stop-time", help="override general.stop_time")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the device spans run (default: cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import yaml

    from shadow_tpu_torch.core.config import ConfigOptions
    from shadow_tpu_torch.core.manager import run_simulation
    from shadow_tpu_torch.utils import units

    try:
        config = ConfigOptions.from_file(args.config)
    except (OSError, ValueError, yaml.YAMLError) as e:
        print(f"[shadow-tpu-torch] bad config {args.config!r}: {e}",
              file=sys.stderr)
        return 1
    if args.seed is not None:
        config.general.seed = args.seed
    if args.stop_time is not None:
        config.general.stop_time_ns = units.parse_time_ns(args.stop_time)
    manager, summary = run_simulation(config, device=args.device)
    if summary.plugin_errors:
        for err in summary.plugin_errors:
            print(f"[shadow-tpu-torch] plugin error: {err}",
                  file=sys.stderr)
        return 1
    dev_rounds = sum(r.rounds for r in (manager._dev_span,
                                        manager._dev_span_tcp) if r)
    print(f"[shadow-tpu-torch] done: simulated "
          f"{summary.end_time_ns / 1e9:.3f}s in {summary.rounds} rounds "
          f"({dev_rounds} in device spans, "
          f"{manager.propagator.rounds_device} propagated on the device "
          f"one by one); "
          f"{summary.packets_sent} packets, {summary.events} events",
          file=sys.stderr)
    print(f"[shadow-tpu-torch] dispatch: "
          f"{json.dumps(manager.dispatch_summary())}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
