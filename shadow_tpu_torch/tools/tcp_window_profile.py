"""Where a TCP window's card time goes, lane by lane: the profiling build
of `stt_tcp_window` (csrc/tcp_window.cu built with -DSTT_TCP_PROFILE
into its own library; the main kernel carries no timers).

Each lane of the profiling build accumulates clock64() cycles by stage
pass (and the idle test before each pop), and by row-scan helper (the
timer heap's minimum, the first free slot, the reassembly lookup, the
SACK runs, the rtx ring walks, the qdisc pick, the holes test, the
binary searches), the helpers' calls and the entries its scans visited,
the law's word accesses by class (host words, conn words, the conn words
still in device memory, row words), with its start and end on the
card's global timer.  Before the lane frame every host and conn word
the law touched was a device-memory trip; with it, only the conn words
past the frame's cap are (`trips`: before and now, rows included).
`profile_window` runs one window through it on a copy of a span state
and checks that the profiled window equals the main kernel's; `report`
prints the slowest lanes (cycles a micro-iteration among them) and the
sums by lane class (a lane with several conn rows serves them: a tgen
server).

As a script it captures the 16-host stream's first in-domain export at
2% loss, its wide-rows edit and, with `--hosts 10000`, the 10,000-host
stream's (the C++ engine runs to 1.23 s first, ~70 s), and prints each
one's profile.  chip_smoke.py phase 2 holds the kernel against the eager
window and times it; this script only profiles.  One JSON line per
export goes to stdout and, with `--out FILE`, is appended to FILE.

    python -m shadow_tpu_torch.tools.tcp_window_profile [--hosts 10000]
        [--out profile.jsonl]
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import sys

import numpy as np
import torch

from shadow_tpu_torch.ops import tcp_window as tw
from shadow_tpu_torch.ops.queues import KernelLibrary
from shadow_tpu_torch.ops.window_table import parse_words

PASS_NAMES = ("pop", "tmr", "app", "r2", "tcpin", "drain_a", "drain_b",
              "ack", "push", "flush", "r1a", "r1b", "arm", "test")
HELPER_NAMES = ("th_min", "first_free", "ra_find", "sack_blocks", "rtx",
                "qdisc", "holes", "search")
# The tile's scans by op (csrc/tcp_lane.cuh ScanOp order).
SCAN_NAMES = ("done", "th_min", "th_free", "ra_free", "ra_find", "ra_any",
              "sack", "acked", "unsacked", "sack_mark", "renege", "qdisc",
              "gather", "writeback")
VISIT_NAMES = ("heap", "reassembly", "rtx")
# The law's word accesses by class (csrc/tcp_lane.cuh W_*): host words
# and conn words (in the lane frame, but for conn rows past its cap),
# the conn words still in device memory, and the row words the law
# moves itself (outside the tile's scans).
WORD_NAMES = ("host", "conn", "conn_device", "row")


def _declare(lib) -> None:
    tw._declare(lib)
    lib.stt_tcp_profile_buffer.argtypes = [ctypes.c_void_p]
    lib.stt_tcp_profile_buffer.restype = None
    lib.stt_tcp_profile_words.argtypes = []
    lib.stt_tcp_profile_words.restype = ctypes.c_char_p
    lib.stt_tcp_profiling.argtypes = []
    lib.stt_tcp_profiling.restype = ctypes.c_int
    lib.stt_tcp_serve_profile.argtypes = [ctypes.c_void_p]
    lib.stt_tcp_serve_profile.restype = ctypes.c_int


PROFILE_LIBRARY = KernelLibrary(
    "tcp_window.cu", "libstt_tcp_window_profile.so", _declare,
    "stt_tcp_error_string", flags=("-Xptxas=-v", "-DSTT_TCP_PROFILE"))
# The profiling build's own wrapper: its launches are not the main
# kernel's.
PROFILE = tw.TcpWindow(PROFILE_LIBRARY)


def build(runner, factory):
    """The runner's span loop with the window step `factory` makes."""
    runner.window_factory = factory
    return runner._build()


def profile_window(runner, base: dict, window_end: int,
                   against: dict | None = None) -> tuple:
    """One window through the profiling build on a copy of `base`:
    (profile rows as numpy, their word layout, the window's counts, the
    span's host -> conn-rows offsets).
    With `against` (the main kernel's state after the same window), the
    profiled window must equal it."""
    from shadow_tpu_torch.tools.relay_cases import clone_state
    from shadow_tpu_torch.tools.window_cases import tcp_window_mismatch
    lib = PROFILE_LIBRARY.build()
    if not lib.stt_tcp_profiling():
        raise RuntimeError("tcp_window_profile: the library was built "
                           "without STT_TCP_PROFILE")
    layout = parse_words(lib.stt_tcp_profile_words().decode())
    fn = build(runner, PROFILE.bind)
    st = clone_state(base)
    fn.prepare(st)
    prof = torch.zeros((runner._H, layout["PF_N"]), dtype=torch.int64,
                       device=st["now"].device)
    scans = (ctypes.c_ulonglong * 64)()
    lib.stt_tcp_serve_profile(scans)  # cleared before the window
    lib.stt_tcp_profile_buffer(prof.data_ptr())
    try:
        fn.step.begin(st)
        fn.step(st, window_end)
        got = fn.step.end()
    finally:
        lib.stt_tcp_profile_buffer(None)
    lib.stt_tcp_serve_profile(scans)
    got["scans"] = {name: {"calls": scans[4 * k],
                           "entry": scans[4 * k + 1],
                           "scan": scans[4 * k + 2],
                           "exit": scans[4 * k + 3]}
                    for k, name in enumerate(SCAN_NAMES) if scans[4 * k]}
    if against is not None and tcp_window_mismatch(against, st):
        raise AssertionError(f"the profiled window differs from the main "
                             f"kernel's: {tcp_window_mismatch(against, st)}")
    runner.window_factory = None
    return prof.cpu().numpy(), layout, got, st["_conn_off"].cpu().numpy()


def _row(prof_row, layout) -> dict:
    lay = layout
    words = {n: int(prof_row[lay["PF_WORDS"] + k])
             for k, n in enumerate(WORD_NAMES)}
    iters = int(prof_row[lay["PF_ITERS"]])
    return {"cycles": int(prof_row[lay["PF_CYCLES"]]),
            "iters": iters,
            "cycles_per_iter": int(prof_row[lay["PF_CYCLES"]])
            / max(iters, 1),
            "words": words,
            "trips": {"before": words["host"] + words["conn"]
                      + words["row"],
                      "now": words["conn_device"] + words["row"]},
            "pass": {n: int(prof_row[lay["PF_PASS"] + k])
                     for k, n in enumerate(PASS_NAMES)},
            "helper": {n: int(prof_row[lay["PF_HELPER"] + k])
                       for k, n in enumerate(HELPER_NAMES)},
            "calls": {n: int(prof_row[lay["PF_CALLS"] + k])
                      for k, n in enumerate(HELPER_NAMES)},
            "visited": {n: int(prof_row[lay["PF_VISIT"] + k])
                        for k, n in enumerate(VISIT_NAMES)}}


def _fmt(d: dict) -> str:
    return ", ".join(f"{k} {v:,}" for k, v in d.items() if v)


def report(tag: str, prof: np.ndarray, layout: dict, conn_off,
           top: int = 5) -> dict:
    """Print the `top` slowest lanes (by their cycles) and the sums over
    every lane by class, servers (several conn rows) and clients; return
    them as a dict."""
    lay = layout
    rows = np.diff(np.asarray(conn_off))
    cyc = prof[:, lay["PF_CYCLES"]]
    t0 = int(prof[:, lay["PF_START_NS"]].min())
    order = np.argsort(-cyc, kind="stable")[:top]
    out = {"slowest": [], "classes": {}}
    for i in order:
        r = _row(prof[i], lay)
        start = (int(prof[i, lay["PF_START_NS"]]) - t0) / 1e3
        end = (int(prof[i, lay["PF_END_NS"]]) - t0) / 1e3
        r.update(host=int(i), conn_rows=int(rows[i]), start_us=start,
                 end_us=end, sm=int(prof[i, lay["PF_SM"]]))
        out["slowest"].append(r)
        print(f"{tag} slow lane host {i} ({rows[i]} conn rows, SM "
              f"{r['sm']}): {r['iters']} iterations, {r['cycles']:,} "
              f"cycles ({r['cycles_per_iter']:,.0f} cycles, "
              f"{(end - start) / max(r['iters'], 1):.2f} us an "
              f"iteration; on the card from +{start:.1f} to +{end:.1f} "
              f"us); law word accesses: {_fmt(r['words'])}; device-memory "
              f"trips of the law before the frame {r['trips']['before']:,}"
              f", now {r['trips']['now']:,}; passes: {_fmt(r['pass'])}; "
              f"helpers (cycles): "
              f"{_fmt(r['helper'])}; helper calls: {_fmt(r['calls'])}; "
              f"entries visited: {_fmt(r['visited'])}", flush=True)
    for name, mask in (("servers", rows > 1), ("clients", rows <= 1)):
        if not mask.any():
            continue
        r = _row(prof[mask].sum(axis=0), lay)
        r.update(lanes=int(mask.sum()),
                 max_cycles=int(cyc[mask].max()),
                 max_iters=int(prof[mask, lay["PF_ITERS"]].max()))
        out["classes"][name] = r
        print(f"{tag} {name}: {r['lanes']} lanes, {r['cycles']:,} cycles "
              f"in all (slowest {r['max_cycles']:,}, at most "
              f"{r['max_iters']} iterations); law word accesses: "
              f"{_fmt(r['words'])}; passes: {_fmt(r['pass'])}; "
              f"helpers (cycles): {_fmt(r['helper'])}; helper calls: "
              f"{_fmt(r['calls'])}; entries visited: {_fmt(r['visited'])}",
              flush=True)
    ends = prof[:, lay["PF_END_NS"]] - t0
    out["window_us"] = float(ends.max()) / 1e3
    print(f"{tag} last lane done at +{out['window_us']:.1f} us; the slowest "
          f"lane started at +{out['slowest'][0]['start_us']:.1f} us",
          flush=True)
    return out


def report_scans(tag: str, scans: dict) -> dict:
    """Print the tile's scans of a profiled window by op: calls and rank
    0's mean cycles waiting for the tile at entry, scanning, and waiting
    at the exit."""
    print(f"{tag} the tile's scans (calls; rank 0's mean cycles waiting at "
          f"entry / scanning / waiting at exit): " + "; ".join(
              f"{k} {v['calls']:,} ({v['entry'] / v['calls']:.0f} / "
              f"{v['scan'] / v['calls']:.0f} / {v['exit'] / v['calls']:.0f})"
              for k, v in scans.items()), flush=True)
    return scans


def capture(n_hosts: int, loss: float) -> tuple:
    """The stream's first in-domain export on the card, (runner, numpy
    state, span arguments): 16 hosts as the tier-1 tests run it (seed
    11, 500 ms), or the 10,000-host stream of chip_smoke.py's main path
    (tools/span_loop_bench.stream_config, to 1.25 s)."""
    from shadow_tpu_torch.core.config import ConfigOptions
    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.tools.netgen import tcp_stream_yaml
    from shadow_tpu_torch.tools.span_loop_bench import stream_config
    from shadow_tpu_torch.tools.window_cases import capture_tcp_export
    if n_hosts == 16:
        cfg = ConfigOptions.from_yaml_text(tcp_stream_yaml(
            16, nbytes=50_000_000, loss=loss, stop_time="500ms", seed=11,
            scheduler="tpu", device_spans="force"))
    else:
        cfg = stream_config(n_hosts, "1.25s", "force")
    return capture_tcp_export(Manager(cfg, device="cuda"), 1)


FRAME_KEYS = ("frame_conns", "frame_bytes", "frame_host_words",
              "frame_conn_words")


def launch_shape(lib, n: int) -> dict:
    """Threads a tile, tiles a block, blocks a launch and dynamic shared
    memory a block of the library's kernel at n lanes, on the current
    device, and the lane frame's shape (conn rows, bytes a tile, host
    words, conn words a row)."""
    out = (ctypes.c_longlong * 4)()
    lib.stt_tcp_launch_shape.argtypes = [ctypes.c_longlong,
                                         ctypes.c_void_p]
    lib.stt_tcp_launch_shape.restype = ctypes.c_int
    err = lib.stt_tcp_launch_shape(n, out)
    if err:
        raise RuntimeError(f"stt_tcp_launch_shape: "
                           f"{lib.stt_tcp_error_string(err).decode()}")
    shape = dict(zip(("team", "tiles", "blocks", "smem"), out))
    frame = (ctypes.c_longlong * 4)()
    lib.stt_tcp_frame.argtypes = [ctypes.c_void_p]
    lib.stt_tcp_frame.restype = None
    lib.stt_tcp_frame(frame)
    return dict(shape, **dict(zip(FRAME_KEYS, frame)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hosts", type=int, default=16, choices=(16, 10_000),
                    help="16: the 16-host 2%%-loss export and its "
                         "wide-rows edit; 10000: those and the "
                         "10,000-host export")
    ap.add_argument("--out", help="append each export's JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tcp_window_profile: no CUDA card")
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from shadow_tpu_torch.native import plane
    from shadow_tpu_torch.tools.window_cases import (tcp_device_state,
                                                     tcp_wide_rows)
    if plane.load_netplane() is None:
        raise RuntimeError(plane.load_error())
    legs = [("stream-16-lossy", 16, 0.02)]
    if args.hosts == 10_000:
        legs.append(("stream-10k", 10_000, 0.005))
    for name, hosts, loss in legs:
        runner, st_np, (start, stop, _limit, runahead) = capture(hosts, loss)
        exports = [(name, tcp_device_state(runner, st_np))]
        if name == "stream-16-lossy":
            exports.append(("stream-16-wide", tcp_device_state(
                runner, tcp_wide_rows(st_np))))
        del st_np
        for ename, st in exports:
            tag = f"[tcp profile {ename}]"
            prof, layout, got, conn_off = profile_window(
                runner, st, min(start + runahead, stop))
            out = {"name": ename, "lanes": runner._H,
                   "launch": launch_shape(PROFILE_LIBRARY.build(),
                                          runner._H),
                   **report(tag, prof, layout, conn_off),
                   "scans": report_scans(tag, got["scans"])}
            line = json.dumps(out)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        del runner, exports
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
