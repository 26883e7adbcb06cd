"""Where a PHOLD span's card time goes, lane by lane: the profiling build
of `stt_phold_span` (csrc/phold_span.cu built with -DSTT_PHOLD_PROFILE
into its own library; the main kernel carries no timers).

Each lane of the profiling build adds, over a span's windows, clock64()
cycles by stage pass and by the busy/due test before each pop, and by
helper (the timer heap's minimum and push, the abort word's read, the
outbox and trace claims) with the helpers' calls, its iterations and
windows; the span kernel adds each lane's row compaction and row settle
cycles (phold_lane.cuh STT_PHOLD_PROFILE_WORDS).  The span's phase
clocks (window, propagation, settle, barrier wait) come from its span
words, as in the main kernel.  `profile_span` runs one span through the
profiling build on a copy of an export and checks that it equals the
main kernel's span; `report` prints the slowest lane and the sums over
every lane.

As a script it captures chip_smoke.py's phase-2 PHOLD exports
(`window_cells`: phold-8k, mesh-24, mesh-codel-10, phold-64k-ring) on
the card and prints each one's profile of a four-round span, one JSON
line per export (appended to `--out`).  It checks and times nothing
else: chip_smoke.py phase 2 does.  Run it from the repo root:

    python -m shadow_tpu_torch.tools.phold_span_profile [--out FILE]
        [--cells phold-8k,mesh-24]
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import sys

import numpy as np
import torch

from shadow_tpu_torch.ops import phold_span_kernel as pks
from shadow_tpu_torch.ops.queues import KernelLibrary
from shadow_tpu_torch.ops.window_table import parse_words

PASS_NAMES = ("pop", "tim", "m_step", "s_step", "r1a", "r2a", "r1b",
              "r2b", "arm", "test")
HELPER_NAMES = ("th_min", "th_push", "abort_read", "claim")


def _declare(lib) -> None:
    pks._declare(lib)
    lib.stt_phold_span_profile_buffer.argtypes = [ctypes.c_void_p]
    lib.stt_phold_span_profile_buffer.restype = None
    lib.stt_phold_profile_words.argtypes = []
    lib.stt_phold_profile_words.restype = ctypes.c_char_p
    lib.stt_phold_span_profiling.argtypes = []
    lib.stt_phold_span_profiling.restype = ctypes.c_int


PROFILE_LIBRARY = KernelLibrary(
    "phold_span.cu", "libstt_phold_span_profile.so", _declare,
    "stt_phold_span_error_string",
    flags=("-Xptxas=-v", "-DSTT_PHOLD_PROFILE"))
# The profiling build's own wrapper: its launches are not the main
# kernel's.
PROFILE = pks.PholdSpan(PROFILE_LIBRARY)


def profile_span(runner, base: dict, args: tuple,
                 against: dict | None = None) -> tuple:
    """One span (`args`: start, stop, limit, runahead, max_rounds)
    through the profiling build on a copy of `base`: (profile rows as
    numpy, their word layout, the span's read: scalars, counts, phase
    clocks).  With `against` (the main kernel's state after the same
    span), the profiled span must equal it."""
    from shadow_tpu_torch.tools.relay_cases import clone_state
    from shadow_tpu_torch.tools.window_cases import window_mismatch
    lib = PROFILE_LIBRARY.build()
    if not lib.stt_phold_span_profiling():
        raise RuntimeError("phold_span_profile: the library was built "
                           "without STT_PHOLD_PROFILE")
    layout = parse_words(lib.stt_phold_profile_words().decode())
    runner.window_factory = None
    runner.span_factory = PROFILE.bind
    try:
        fn = runner._build()
    finally:
        runner.span_factory = None
    pay = runner._pay
    st = clone_state(base)
    fn.prepare(st, pay)
    prof = torch.zeros((runner._H, layout["PF_N"]), dtype=torch.int64,
                       device=st["now"].device)
    lib.stt_phold_span_profile_buffer(prof.data_ptr())
    try:
        got = fn.span(st, pay, *args)
    finally:
        lib.stt_phold_span_profile_buffer(None)
    if against is not None and window_mismatch(against, st):
        raise AssertionError(f"the profiled span differs from the main "
                             f"kernel's: {window_mismatch(against, st)}")
    got["team"] = getattr(fn.span, "team", 1)
    got["blocks"] = fn.span.blocks
    return prof.cpu().numpy(), layout, got


def _row(r, lay) -> dict:
    return {"cycles": int(r[lay["PF_CYCLES"]]),
            "iters": int(r[lay["PF_ITERS"]]),
            "windows": int(r[lay["PF_WINDOWS"]]),
            "cycles_per_iter": int(r[lay["PF_CYCLES"]])
            / max(int(r[lay["PF_ITERS"]]), 1),
            "pass": {n: int(r[lay["PF_PASS"] + k])
                     for k, n in enumerate(PASS_NAMES)},
            "helper": {n: int(r[lay["PF_HELPER"] + k])
                       for k, n in enumerate(HELPER_NAMES)},
            "calls": {n: int(r[lay["PF_CALLS"] + k])
                      for k, n in enumerate(HELPER_NAMES)},
            "compact": int(r[lay["PF_COMPACT"]]),
            "settle": int(r[lay["PF_SETTLE"]])}


def _fmt(d: dict) -> str:
    return ", ".join(f"{k} {v:,}" for k, v in d.items() if v)


def report(tag: str, prof: np.ndarray, layout: dict, got: dict) -> dict:
    """Print the slowest lane (by its window cycles), the sums over every
    lane and the phase clocks; return them as a dict."""
    lay = layout
    i = int(np.argmax(prof[:, lay["PF_CYCLES"]]))
    slow = dict(_row(prof[i], lay), lane=i, sm=int(prof[i, lay["PF_SM"]]))
    every = _row(prof.sum(axis=0), lay)
    clk = got["clocks"]
    for what, r in (("slowest lane", slow), ("every lane", every)):
        print(f"{tag} {what}{'' if what != 'slowest lane' else ' ' + str(i)}"
              f": window {r['cycles']:,} cycles over {r['windows']} windows"
              f", {r['iters']} iterations ({r['cycles_per_iter']:,.0f} a "
              f"micro-iteration); passes: {_fmt(r['pass'])}; helpers "
              f"(cycles): {_fmt(r['helper'])}; calls: {_fmt(r['calls'])}; "
              f"row compaction {r['compact']:,}, row settle "
              f"{r['settle']:,} cycles", flush=True)
    print(f"{tag} team {got['team']}, {got['blocks']} blocks; phase clocks "
          f"(block 0 thread 0, cycles) {clk}; rounds {got['rounds']}",
          flush=True)
    return {"slowest": slow, "every": every, "clocks": clk,
            "team": got["team"], "blocks": got["blocks"],
            "rounds": got["rounds"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="append each export's JSON line here")
    ap.add_argument("--cells", default="", help="comma-separated cells "
                    "of chip_smoke.window_cells (default: all)")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("phold_span_profile: no CUDA card")
    import subprocess

    import chip_smoke as c
    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.native import plane
    from shadow_tpu_torch.tools.window_cases import (capture_export,
                                                     device_state)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if plane.load_netplane() is None:
        raise RuntimeError(plane.load_error())
    PROFILE_LIBRARY.build()
    for ln in PROFILE_LIBRARY.log.splitlines():
        if ln.strip():
            print(f"[build] phold_span.cu profiling: {ln.strip()}",
                  flush=True)
    want = [w for w in args.cells.split(",") if w]
    for name, (cfg, nth, caps) in c.window_cells().items():
        if want and name not in want:
            continue
        tag = f"[phold profile {name}]"
        runner, st_np, (start, stop, limit, runahead) = capture_export(
            Manager(cfg, device="cuda"), nth, caps)
        base = device_state(runner, st_np)
        del st_np
        prof, layout, got = profile_span(
            runner, base, (start, stop, limit, runahead, args.rounds))
        out = {"name": name, "lanes": runner._H, "max_rounds": args.rounds,
               **report(tag, prof, layout, got)}
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del runner, base, prof
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
