"""CLI: `python -m shadow_tpu_torch [options] config.yaml`.

The port's counterpart of `python -m shadow_tpu`: load the YAML, apply
the overrides, run the simulation (under `scheduler: tpu` on the card,
or on the CPU with `--device cpu`; the engine `thread_per_core`
baseline and the object path's `serial`, `thread_per_host` and
pure-Python `thread_per_core` always on the CPU), write the data
directory, print the
summary, and exit nonzero if any process ended in an unexpected state
or the config needs a path the port has not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shadow-tpu-torch",
        description="shadow-tpu on PyTorch/CUDA")
    p.add_argument("config", nargs="?", help="YAML simulation config")
    p.add_argument("--seed", type=int, help="override general.seed")
    p.add_argument("--stop-time", help="override general.stop_time")
    p.add_argument("--parallelism", type=int,
                   help="override general.parallelism")
    p.add_argument("--data-directory", help="override data directory")
    p.add_argument("--scheduler",
                   choices=["serial", "thread_per_core", "thread_per_host",
                            "tpu"],
                   help="override experimental.scheduler")
    p.add_argument("--progress", action="store_true",
                   help="print heartbeat progress to stderr")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the tpu scheduler's device work runs "
                        "(default: cuda)")
    p.add_argument("--show-build-info", action="store_true")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.show_build_info:
        import shadow_tpu_torch
        print(f"shadow-tpu-torch {shadow_tpu_torch.__version__}")
        return 0
    if args.config is None:
        parser.print_usage(sys.stderr)
        print("shadow-tpu-torch: error: the config argument is required",
              file=sys.stderr)
        return 2
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
    except NotImplementedError as e:
        print(f"[shadow-tpu-torch] {e}", file=sys.stderr)
        return 1
    if args.seed is not None:
        config.general.seed = args.seed
    if args.stop_time is not None:
        config.general.stop_time_ns = units.parse_time_ns(args.stop_time)
    if args.parallelism is not None:
        config.general.parallelism = args.parallelism
    if args.data_directory is not None:
        config.general.data_directory = args.data_directory
    if args.scheduler is not None:
        config.experimental.scheduler = args.scheduler
    if args.progress:
        config.general.progress = True
    try:
        manager, summary = run_simulation(config, device=args.device,
                                          write_data=True)
    except NotImplementedError as e:
        print(f"[shadow-tpu-torch] {e}", file=sys.stderr)
        return 1
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
          f"{getattr(manager.propagator, 'rounds_device', 0)} propagated "
          f"on the device one by one); "
          f"{summary.packets_sent} packets, {summary.events} events",
          file=sys.stderr)
    print(f"[shadow-tpu-torch] dispatch: "
          f"{json.dumps(manager.dispatch_summary())}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
