"""Time the PHOLD span kernel of one tree of the port on a card.

    python3 shadow_tpu_torch/tools/phold_span_ab.py <tree> [--cells=
        phold-8k,mesh-24,mesh-codel-10,phold-64k-ring] [--teams=1,8]
        [--profile]

It imports `chip_smoke` and `shadow_tpu_torch` from <tree> (a checkout:
this one, or a `git archive` of another commit under the gitignored
`_checkout/`), builds that tree's engine and span kernel there, and on
each cell's phase-2 export (chip_smoke.py `window_cells`; mesh-24's
second in-domain export where the tree's list lacks it) holds the span
kernel exactly against the plain loop over spans of one and four rounds,
then prints one JSON line: card time per one- and four-round span and
per round (`span_card_ms`: single launches on fresh copies, the card
asleep while the host issues each), host issue, launch to end, phase
clocks, the team width, blocks and nvcc's registers, stack and spills;
where the tree's wrapper takes a team width, the four-round span at
each width of `--teams` too (a team of one by default), each held
exactly.  With `--profile`, where the tree has
tools/phold_span_profile.py, the slowest lane's profile of the same
four-round span.  Two trees are compared in one call by running this
once per tree in turns (parent, change, change, parent); it uses only
what every tree since the PHOLD span kernel has.
"""

from __future__ import annotations

import gc
import json
import os
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tree = os.path.abspath(argv[0])
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as c
    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.native import plane
    from shadow_tpu_torch.ops import phold_span_kernel as pks
    from shadow_tpu_torch.tools.relay_cases import clone_state
    from shadow_tpu_torch.tools.window_cases import (capture_export,
                                                     device_state,
                                                     window_mismatch)
    want = ["phold-8k", "mesh-24", "mesh-codel-10", "phold-64k-ring"]
    teams = [1]
    for a in argv[1:]:
        if a.startswith("--cells="):
            want = a.split("=", 1)[1].split(",")
        if a.startswith("--teams="):
            teams = [int(t) for t in a.split("=", 1)[1].split(",")]
    profile = None
    if "--profile" in argv and os.path.exists(os.path.join(
            tree, "shadow_tpu_torch", "tools", "phold_span_profile.py")):
        from shadow_tpu_torch.tools import phold_span_profile as profile
    print(f"[phold ab] tree {tree}", flush=True)
    c.card()
    if plane.load_netplane() is None:
        raise RuntimeError(plane.load_error())
    pks.LIBRARY.build()
    props = {k: v for k, v in c.ptxas_props(pks.LIBRARY.log).items()
             if "phold_span_kernel" in k and v}
    print(f"[phold ab] nvcc: {json.dumps(props)}", flush=True)
    cells = c.window_cells()
    if "mesh-24" not in cells:
        cells["mesh-24"] = (c.phold_cells()["mesh-24"][0]("force"), 2, None)
    for name in want:
        cfg, nth, caps = cells[name]
        tag = f"[phold ab {name}]"
        runner, st_np, (start, stop, limit, runahead) = capture_export(
            Manager(cfg, device="cuda"), nth, caps)
        pay = runner._pay
        base = device_state(runner, st_np)
        del st_np

        def build(span_factory=None, window_factory=None):
            runner.window_factory = window_factory
            runner.span_factory = span_factory
            try:
                return runner._build()
            finally:
                runner.window_factory = runner.span_factory = None

        from shadow_tpu_torch.ops import phold_window as pw
        plain, span = build(window_factory=pw.eager_window), build()
        args = {mr: (start, stop, limit, runahead, mr) for mr in (1, 4)}
        for mr in (1, 4):
            ra, *rest_a = plain(clone_state(base), pay, *args[mr])
            rb, *rest_b = span(clone_state(base), pay, *args[mr])
            bad = window_mismatch(ra, rb) + [
                k for k in ("ks_fires", "ks_lanes")
                if not np.array_equal(ra[k], rb[k])]
            if bad or rest_a != rest_b or int(rb["abort_code"]):
                raise AssertionError(f"{tag} {mr} rounds: {bad} differ, "
                                     f"{rest_a} vs {rest_b}")
            del ra, rb
        iters = rest_a[-1]
        card1, _ = c.span_card_ms(span, base, args[1], 5, pay)
        card, issue = c.span_card_ms(span, base, args[4], 5, pay)
        cc = clone_state(base)
        span.prepare(cc, pay)
        got = span.span(cc, pay, *args[4])
        del cc
        row = {"name": name, "lanes": runner._H, "tree": tree,
               "team": getattr(span.span, "team", 1),
               "blocks": span.span.blocks,
               "us_4_rounds": float(np.median(card)) * 1e3,
               "us_4_rounds_all": [x * 1e3 for x in card],
               "us_per_round": float(np.median(card)) * 1e3 / 4,
               "us_1_round": float(np.median(card1)) * 1e3,
               "issue_us": float(np.median(issue)) * 1e3,
               "launch_to_end_us": got["span_ms"] * 1e3,
               "clocks": got["clocks"], "iterations_4_rounds": iters}
        ra, *rest_a = plain(clone_state(base), pay, *args[4])
        for team in teams:
            try:
                one = build(span_factory=lambda s, p, t=team:
                            pks.PHOLD_SPAN.bind(s, p, team=t))
            except TypeError:  # a tree whose wrapper takes no team width
                break
            rb, *rest_b = one(clone_state(base), pay, *args[4])
            if window_mismatch(ra, rb) or rest_a != rest_b:
                raise AssertionError(f"{tag} team {team}: "
                                     f"{window_mismatch(ra, rb)}")
            del rb
            card_t, _ = c.span_card_ms(one, base, args[4], 5, pay)
            row[f"us_4_rounds_team{team}"] = float(np.median(card_t)) * 1e3
            del one
        del ra
        print(f"{tag} exact over 1 and 4 rounds; " + json.dumps(row),
              flush=True)
        if profile is not None:
            prof, layout, pgot = profile.profile_span(runner, base,
                                                      args[4])
            profile.report(f"{tag} profile", prof, layout, pgot)
        del runner, base, plain, span
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[phold ab] done {tree}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
