"""Time the TCP window and span kernels of one tree of the port on a
card, through that tree's own chip_smoke.py phase-2 legs.

    python3 shadow_tpu_torch/tools/tcp_span_ab.py <tree> [--10k]

It imports `chip_smoke` and `shadow_tpu_torch` from <tree> (a checkout:
this one, or a `git archive` of another commit under the gitignored
`_checkout/`), builds that tree's engine and kernels there, and runs
`check_tcp_window` and `check_tcp_span` on the 16-host stream's first
in-domain exports at 0% and 2% loss and on the wide-rows edit of the
2%-loss one (the window kernel profiled on the 2%-loss export); with
`--10k` also on the 10,000-host stream's first in-domain export of the
run to 1.31 s (chip_smoke.py phase 3's export, captured anew: its C++
prefix takes ~100 s), the window kernel profiled there too.  Each check
holds the kernels exactly against their plain versions and prints
their card times and launch shapes, so two trees are compared in one
call by running this once per tree in turns (parent, change, change,
parent).  It uses only what every tree since the TCP span kernel has
(chip_smoke.py's `check_tcp_window` and `check_tcp_span`).
"""

from __future__ import annotations

import gc
import os
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tree = os.path.abspath(argv[0])
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as c
    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.tools.span_loop_bench import stream_config
    from shadow_tpu_torch.tools.window_cases import (capture_tcp_export,
                                                     tcp_device_state,
                                                     tcp_wide_rows)
    print(f"[tcp ab] tree {tree}", flush=True)
    c.card()
    c.build_all()
    for name, loss in (("stream-16", 0.0), ("stream-16-lossy", 0.02)):
        runner, st_np, args = c.tcp_export(loss)
        legs = [(name, st_np)]
        if loss:
            legs.append(("stream-16-wide", tcp_wide_rows(st_np)))
        for leg, st in legs:
            c.check_tcp_window(leg, runner, tcp_device_state(runner, st),
                               args, profile=leg == "stream-16-lossy")
            c.check_tcp_span(leg, runner, tcp_device_state(runner, st),
                             args)
        del runner, st_np, legs
        gc.collect()
        torch.cuda.empty_cache()
    if "--10k" in argv:
        runner, st_np, args = capture_tcp_export(
            Manager(stream_config(10_000, "1.31s", "force"), device="cuda"),
            1)
        base = tcp_device_state(runner, st_np)
        del st_np
        gc.collect()
        c.check_tcp_window("stream-10k", runner, base, args, graph=False,
                           profile=True)
        gc.collect()
        torch.cuda.empty_cache()
        c.check_tcp_span("stream-10k", runner, base, args, plain4="kernel",
                         reps=3)
    print(f"[tcp ab] done {tree}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
