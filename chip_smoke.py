"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--stop-time 1.31s]

Ten phases; any failed check raises, so the script exits non-zero:

1. Identify the card (name, and name + power limit from nvidia-smi).
2. Build the engine and the kernel libraries from this checkout (in
   parallel, one nvcc per source), hold each kernel against its plain
   PyTorch version on the card and time both:
   - the standalone law kernels (stt_bucket_step, stt_codel_head) on
     adversarial integer inputs at H = 10,000, a ragged H = 10,001, a
     scalar `now`, and the PHOLD paths' shapes (scalar `size`):
     H = 8,192 and H = 65,536, where they are timed (the kernels line
     takes the 65,536-lane row);
   - the fused relay kernels (stt_relay1_law, stt_relay2_law) at
     H = 10,000 with the span's ring widths, on lanes built to reach
     every branch (tools/relay_cases.py) at mask densities of 0.1%, 10%
     and 100%: every state word, every flag, the packet handed back on
     the lanes that carried one and the refill instant on the throttled
     lanes, exactly equal; card time with every launch on a fresh copy
     of the checked state, and the bound from the bytes each lane's
     branch needs;
   - the per-round propagation kernel (stt_propagate_round) at n = 1,
     1,000, 65,536, 1,048,576 and a ragged 1,000,003 packets, with the
     3-tier graph's matrices (V = 3) and random V = 64 ones (unreachable
     pairs, zero and full loss thresholds, control lanes, send times on
     both sides of bootstrap_end), through the tensor API and through
     the per-round route's round stage on both branches (run in place in
     the mapped buffer, and copied to the card and back): every output
     and both minima exactly equal; card time in a CUDA graph (back to
     back on the card), host time per tensor-API call, the plain
     version, the bound from the bytes per packet and the matrices, and
     the route's dispatch per round (pack, the one call, the views; the
     kernel's events).  Then the sweep of both branches at
     PROPAGATE_SWEEP_N packets, which COPY_MIN_PACKETS is set from, and
     the default stage's choice either side of it.
   - the PHOLD/udp-mesh window kernel (stt_phold_window) and span
     kernel (stt_phold_span) on exported span states of phold-8k,
     mesh-24 (in its paced stream), mesh-codel-10 (inside its CoDel
     stretch) and phold-64k-ring: one window, then four rounds with the
     eager round ends, through the window kernel, and whole spans of one
     and of four rounds through the span kernel, at the team width its
     wrapper picks from the lane count and at a team of one, each
     against its plain version (the runner's eager
     loop) on copies of the same state: every state column, the outbox
     and trace in canonical order, the stage fires and lanes, the
     micro-iterations, the run's scalars and the abort bits exactly
     equal; the outbox cut to H + 2 slots gives AB_OUT on every path
     (phold-8k and the ring); the window kernel's card time per launch
     (ten launches back to back in a CUDA graph, each on its own fresh
     copy of the export), host time per wrapper call, the plain window's
     time and the bound from the bytes the window must move (its lanes'
     last busy/due test, the slots it dequeues and copies, the words it
     changes); the span kernel's card time per one- and four-round span
     and per round (single launches on fresh copies, the card asleep
     while the host issues each), its host issue per launch, the plain loop's
     four rounds, the bound from the bytes the four-round span must
     move (each window's reads, each round end's packets and moved
     entries, each changed word once), and its phase clocks; nvcc's
     register and spill
     report of both;
   - the TCP window kernel (stt_tcp_window: a tile of 32 threads a
     host lane, the lane's host and conn words in the tile's lane frame
     in shared memory) on the 16-host stream's first in-domain exports
     at 0% and 2% loss, the wide-rows edit of the 2%-loss one
     (tools/window_cases.tcp_wide_rows: a 298-entry reassembly row in
     three SACK runs, a 480-entry rtx ring with marks, 3,000 stale
     timer-heap entries), its over-cap edit
     (tools/window_cases.tcp_over_cap: a tgen server with one conn row
     more than the lane frame holds, its busiest conn past the frame)
     and, after phase 3's run captured it, the 10,000-host stream's: one window against its plain version (the
     runner's eager window) on copies of the same state, every state
     column (conn-major ones without their trash row), the outbox and
     trace in canonical order, the stage fires and lanes, the
     micro-iterations and the abort bits and site exactly equal, with
     the timer heap's minimum kept between pops and without it; card
     time per window (ten launches in a CUDA graph on fresh copies; the
     10,000-host state, too large for ten copies, by three single
     launches on a restored copy, the card asleep while the host issues
     each), with and without the kept heap minimum, host time per
     wrapper call, the plain window's time, the bound from the bytes
     the window must move (ops/tcp_window.py window_need_bytes), the
     launch's shape (threads a lane, lanes a block, blocks, shared
     memory a block, the lane frame's bytes a tile) and nvcc's
     registers, stack and spills by function; on the 2%-loss and
     10,000-host exports the profiling build's window (equal to the
     kernel's) and its five slowest lanes, cycles by stage pass and by
     row scan, cycles a micro-iteration, and the law's word accesses by
     class with its device-memory trips before the frame and now
     (tools/tcp_window_profile.py); nvcc's register and spill report of
     both builds;
   - the TCP span kernel (stt_tcp_span: every round's windows with the
     window kernel's lane law and tile, the propagation, drops, inbox
     merge and round scalars, one cooperative launch a span) on the same
     exports (the 10,000-host one after phase 3's run): spans of one and
     of four rounds against its plain version (the runner's eager loop:
     the eager window, then the eager round end; at 10,000 hosts the
     four-round span's windows by stt_tcp_window, an eager window taking
     ~18 s there), every state column, the outbox and trace in canonical
     order, the stage fires and lanes, the run's scalars and the abort
     bits exactly equal; card time per one- and four-round span (single
     launches on fresh copies, the card asleep while the host issues
     each: a cooperative launch is not captured in a CUDA graph), its
     host issue, launch to end, the plain loop's time, the bound from
     the bytes the span must move (ops/tcp_span_kernel.py
     tcp_span_need_bytes), its phase clocks and launch shape (the lane
     frame's bytes a tile among it), nvcc's registers, stack and spills
     by function (the kernel, its window phase, its row settle, the
     tile's scans); the over-cap edit too.
3. Run the main path: the 10,000-host tgen TCP bulk stream through the
   port's Manager on the card with forced device spans, every span one
   stt_tcp_span launch, to 1.31 s (the fleet enters the span domain at
   1.23 s, so a span of 8 rounds), and require the trace, packets and
   events that the C++ engine serving every round (`tpu_device_spans:
   off`) gives (recorded in STREAM_10K for 1.25 s and 1.31 s; run
   again for another stop time), device spans, one span-kernel launch
   and one read of its words per dispatch, every committed round inside
   it, no eager round end and no window, relay, law or PHOLD kernel (the
   relay laws run in the lanes); print the per-stage fire/lane counters
   and the wall of the router's one PHOLD probe.  The run's first
   in-domain export, cloned before its launch, feeds phase 2's
   10,000-host TCP legs.  Then the same stream at 16 hosts to 500 ms,
   spans off and forced (the C++ run in the same call), where at least
   half the rounds must run on the card, with the router's first window
   at 4 rounds so that the device stretch takes several spans: through
   the span kernel, then through the window kernel and the eager round
   ends (`tcp_window.TCP_WINDOW.bind`: one window-kernel launch per
   window stepped, no span kernel); then to EAGER_STOP (330 ms) off and
   forced through the eager window (`tcp_window.eager_window`), the
   path that still launches the relay kernels: each once per fire of
   its stage, and no window or span kernel.
4. Run the PHOLD/udp-mesh family the same way, spans off and forced
   (every span one stt_phold_span launch): phold-8k (the reference
   ladder's 8,192-LP rung), mesh-24 (the reference's 24-host paced
   udp-mesh, to the reference's own 30 s) and mesh-codel-10 (the
   reference's CoDel-active mesh, 60 s); phold-8k also forced through
   the window kernel (one stt_phold_window launch a round, the eager
   round ends) and through the plain window.  Requires one trace per
   cell, the one it had before the PHOLD kernels (DIGESTS; for mesh-24
   also the lines before 1 s, the earlier cut's trace: PREFIX_DIGESTS),
   spans with no abort, >= 50% of rounds on the card, family 1 and
   drops for the meshes (all 3,350 CoDel drops for mesh-codel-10);
   through the span kernel, one launch per dispatch (aborted and
   refused ones too), one read of the span's words per launch, every
   committed round stepped inside the kernel and no window or law
   kernel; through the window kernel, one launch per window stepped in
   every dispatch and no span or law kernel; through the plain window,
   each law kernel launched once per call the runner made, never more
   often than the stages that call it fire, and no PHOLD kernel; the
   TCP relay kernels never.  Prints the per-stage counters,
   micro-iterations, the loop's wall, the spans' (or windows')
   launch-to-end time, the span codec's bytes and walls and the peak
   device memory.
5. Run phold-64k-ring (the reference ladder's 65,536-LP ring-caps rung,
   to 1.0 s so that the device stretch takes three spans) three times:
   spans off, forced with `span_overlap: off` (residency alone, through
   the plain window) and forced with `span_overlap: auto` (on, on the
   card, through the span kernel: the speculative spans launch on the
   worker's stream).  Requires the cell's trace in all
   three runs, no abort, >= 50% of rounds on the card, resident hits on
   every span after the first (less stale drops, each named by the
   engine call that moved the epoch), the residency run's export bytes
   under 1.5x one span's export, speculative windows dispatched and
   landed with auto and none with off, and phase 4's launch gates for
   each (never a kernel in the C++ run).  Prints the loop as phase 4
   does, the codec's bytes and walls, the clone's bytes and time, the
   overlap block and the peak device memory.  Then `python -m
   shadow_tpu_torch` on a 512-LP PHOLD ring with `span_overlap: on`
   must exit 0 with a speculative window landed.
6. Per-round device propagation.  tier10k (bench.py config_10k: 10,000
   hosts on the 3-tier graph, seed 7, 10 s, nothing cut) three times:
   host-only (the C++ twin serves every per-round round), auto (the
   route model with async probes) and forced (`tpu_min_device_batch:
   0`, no span, every round through stt_propagate); then mesh-100
   (bench.py mesh_config) host-only and forced.  Requires one trace
   sha256 and equal counters across each cell's runs, forced launches
   = device rounds = dispatched rounds with no span and no host
   measurement, auto launches + probe launches = device rounds +
   probes, none in host-only runs, and inet-loss drops at mesh-100.
   Prints the route split, packets per round and the per-phase walls
   per dispatch (export, upload, launch, kernel, download, scatter) of
   each run, and their upload + launch + kernel + download; the kernels
   line's stt_propagate row is timed at the forced run's median round.
7. The data directory and the two schedulers.  `python -m
   shadow_tpu_torch --data-directory` in a child process on tier-1k
   (bench.py config3, every round forced through stt_propagate_round),
   phold-8k (spans
   forced, stt_phold_span) and tcp-stream-16 (to 500 ms, stt_tcp_span),
   each under `--scheduler tpu` on the card and under `--scheduler
   thread_per_core` (`native_dataplane: on`: the engine baseline, no
   device), from one YAML.  Requires each pair's directories
   byte-identical under tests/test_determinism.py's `collect` rules,
   the tpu run's eligibility audit showing the card's work (device-span
   rounds = the runners' rounds > 0, or every round forced) with its
   kernel launched, every thread_per_core round `per-round:scheduler`,
   and `metrics.sim.fabric.violations` 0.  phold-8k again with
   `--progress`: heartbeats with the reference's two tornettools lines,
   and the same directory.  The seven runs go at once.  Prints each
   run's process wall and sim-s/wall-s beside the card's name and power
   limit.
8. The sim-time channels: tcp-stream-16 (to 500 ms), mesh-codel-10
   (its CoDel stretch: queue samples with drops) and phold-8k, each with
   the flight recorder, sim-netstat, the fabric and kernel observatories
   on, three times: spans off (the C++ engine's rings), forced through
   the span kernels, and forced through the plain loops (the eager round
   end and its eager sample, each window by its family's window kernel,
   itself held exact in phase 2), every run sampling every round.
   Requires one trace in the three runs (the cell's DIGESTS where it has
   one), `flight-sim.bin`, `telemetry-sim.bin`, `fabric-sim.bin` and
   `kernel-sim.bin` byte-identical between the kernel and the plain
   runs, the connection and queue samples also equal to the engine's,
   an empty kernel file off the card, one kernel record per committed
   span whose trips sum to the runner's micro-iterations, and through
   the span kernels one launch and one read per dispatch, with no span
   moved to the eager loop or the engine.  Phase 2 also holds each span
   kernel with the channels on (every round sampled) against the plain
   loop on the 10,000-host TCP export and the phold-64k-ring export over
   spans of one and four rounds, the sample rows included, and times it
   with the channels off and on in the same call.
9. Object-path hosts.  object-1k (bench.py config3: 1,000 hosts on the
   3-tier graph, 100 tgen-servers, 900 clients x 5 x 50,000 B, seed 7,
   30 s, nothing cut) with every host on the object path
   (`native_dataplane: off`: Python hosts, sockets and TCP, their sends
   in the propagator's outbox) three times: tpu forced
   (`tpu_min_device_batch: 0`, every outbox chunk through
   stt_propagate_round), tpu auto (the route model and its probes) and
   serial (the CPU twin, in a child process through the CLI, no device).
   Requires one trace sha256 and equal counters in the three runs,
   forced launches = object-path device rounds = dispatched rounds with
   no host-route round, no probe and no other kernel, auto launches +
   probe launches = device rounds + probes, and no device work in the
   serial run.  mixed-pcap-10k (bench.py mixed_pcap_rung: config_10k to
   3 s beside 4 pcap'd object-path clients, per-host `native_dataplane:
   false`) under tpu on the card and under the engine thread_per_core
   (`native_dataplane: on`, in a child process through the CLI):
   equal packet counts, spans over at least half of the tpu run's
   rounds, one trace sha256 and the 8 pcap files byte-identical.  Prints
   the route split, the packets per chunk and the dispatch per device
   chunk (pack, call, views, scatter, the kernel's events); the kernels
   line's stt_propagate_round row carries the forced run's launches and
   the kernel timed at its median chunk (`object_path`).
10. The reports.  dctcp-incast-8 (the reference's forced-device DCTCP
   shape: `incast_yaml(8, nbytes=2_000_000, stop_time="2s", seed=17)`
   with `tcp: {cc: dctcp, ecn: on}`, every channel on) four times: the
   serial object path, tpu with spans off (the C++ engine), forced
   through stt_tcp_span and forced through the plain loop (each window
   by stt_tcp_window, the eager round ends).  Requires one trace in the
   four runs, `fabric_conservation()` and `fabric_summary()` equal in
   all four with marks and no violation, at least half the forced runs'
   rounds on the card, through the span kernel one launch and one read
   per dispatch, through the plain loop one window-kernel launch a
   window.  Then the whole data directory (`write_data_dir`) of the
   kernel and the plain run of tcp-stream-16 and mesh-codel-10 (phase
   8's cells but phold-8k: REPORT_PATHS) and of dctcp-incast-8, and
   over each the reports in-process (tools/trace.py summarize with
   its Chrome export, net, fabric, fct, kern, explain): every
   conservation verdict True (fct's where the cell moves TCP payload),
   the Chrome export's round slices and a counter track for each
   channel with rows, and the net, fabric and fct reports' text
   identical for the kernel and the plain directory.  Meanwhile `python
   -m shadow_tpu_torch.tools.trace --smoke` runs in a child process on
   the card and must exit 0 having launched stt_phold_span.

Each phase prints its own seconds on a line of its own.  To fit the
time limit, work that only waits for child processes runs beside other
phases: phase 5's CLI child beside its ring runs, and phase 7 (its
seven CLI children, on a thread) beside phases 8, 10 and 9, in that
order; phase 7's line comes last and gives its own wall.  The device runs of phases 3-4 run with `span_overlap: auto` (on, on the
card) and print their residency and overlap counters too.  It prints a
`kernels` JSON line before the last line, and as the last
line `{"ok": true, "device": {...}}`.  It imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H_MAIN = 10_000
CONNS_MAIN = 32_768  # the 10,000-host stream's conn capacity CC
BANDWIDTH = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
# Bytes each lane's operands take (each read once, each output written
# once); a 0-d operand costs nothing per lane.
BYTES_PER_LANE = {"bucket_step": 66, "codel_head": 46}
H_PHOLD = 8_192  # the phold-8k cell's lanes
H_RING = 65_536  # the phold-64k-ring cell's lanes: the law kernels' main path
# The reference rung's ring caps (bench.py phold_rung): the defaults carry
# a 2,048-deep CoDel ring per host, pure waste at PHOLD rates.
RING_CAPS = dict(CAP_I=32, CAP_T=16, CAP_R=64, CAP_S=64, CAP_C=256,
                 CAP_P=16)
REPLACES = {"bucket_step": "shadow_tpu/ops/pallas_queues.py:80",
            "codel_head": "shadow_tpu/ops/pallas_queues.py:119",
            "relay1_law": "shadow_tpu/ops/pallas_queues.py:80",
            "relay2_law": "shadow_tpu/ops/pallas_queues.py:119",
            "propagate": "shadow_tpu/ops/propagate.py:391",
            "phold_window": "shadow_tpu/ops/phold_span.py:1675",
            "phold_span": "shadow_tpu/ops/phold_span.py:1675",
            "tcp_window": "shadow_tpu/ops/tcp_span.py:2373",
            "tcp_span": "shadow_tpu/ops/tcp_span.py:2142"}
SOURCE = {"bucket_step": "shadow_tpu_torch/csrc/queues.cu",
          "codel_head": "shadow_tpu_torch/csrc/queues.cu",
          "relay1_law": "shadow_tpu_torch/csrc/relay.cu",
          "relay2_law": "shadow_tpu_torch/csrc/relay.cu",
          "propagate": "shadow_tpu_torch/csrc/propagate.cu",
          "phold_window": "shadow_tpu_torch/csrc/phold_window.cu",
          "phold_span": "shadow_tpu_torch/csrc/phold_span.cu",
          "tcp_window": "shadow_tpu_torch/csrc/tcp_window.cu",
          "tcp_span": "shadow_tpu_torch/csrc/tcp_span.cu"}
# Each PHOLD-family cell's trace sha256 (its first 16 hex digits) as the
# C++-only run and the device runs gave it before the window kernel: a
# device run through the kernel must give the same trace.  mesh-24 runs
# to the reference's 30 s; the lines of its trace before 1 s are the
# trace of a run stopped at 1 s (tests/test_torch_phold_window.py), the
# cut the earlier digest was taken at (PREFIX_DIGESTS: cut ns, digest).
DIGESTS = {"phold-8k": "193df0b724ca82af", "mesh-24": "418a93e5434d900a",
           "mesh-codel-10": "465140a4129e63e7",
           "phold-64k-ring": "8a7e37bc1464a71e"}
PREFIX_DIGESTS = {"mesh-24": (1_000_000_000, "7e888cfb90af5447")}
# The 10,000-host stream's C++-only run (stream_results) by stop time,
# as every earlier run of this script on the card gave it (PERF.md): its
# ~100 s are not spent again on each run.
STREAM_10K = {"1.25s": {"digest": "c235e5ef74032058", "lines": 21447834,
                        "packets_sent": 10771536, "packets_dropped": 32988,
                        "events": 19194042},
              "1.31s": {"digest": "b36f54b95ec66fa3", "lines": 22709713,
                        "packets_sent": 11402091, "packets_dropped": 34870,
                        "events": 20539955}}
MESH_CODEL_DROPS = 3350  # every CoDel drop of mesh-codel-10's 60 s
DENSITIES = (0.001, 0.1, 1.0)
# stt_propagate: bytes per packet (in: src_node, dst_node i32, src_host,
# t_send i64, pkt_seq u32, is_ctl u8; out: deliver i64, three flags) and
# integer operations per packet (threefry2x32's 20 rounds of add, rotate,
# xor and 5 key injections, 77; the gathers' index arithmetic, clamps,
# compares, the clamp to window_end and the two minima, ~15).
PROPAGATE_IN_B, PROPAGATE_OUT_B, PROPAGATE_OPS = 29, 11, 92
# The card's rate for them: the only published H100 rate outside the
# tensor cores (float32, 67 TFLOP/s, H100 SXM data sheet),
# an upper bound of its int32 rate, so the operations bound is low.
OPS_RATE = 67e12
# Cycles the card sleeps before a timed CUDA graph's start event (about
# 2 ms at the H100's 1.98 GHz boost clock): the host records the event
# and launches the graph meanwhile.
SLEEP_CYCLES = 4_000_000
PROPAGATE_N = (1, 1_000, 65_536, 1_048_576, 1_000_003)
# The per-round route's sweep of its two branches (the tier10k median
# round, the PROPAGATE_N sizes and the powers of 4 between), and the
# copy_min that forces each branch.
PROPAGATE_SWEEP_N = (1, 150, 1_000, 4_096, 16_384, 65_536, 131_072,
                     262_144, 524_288, 1_048_576)
PROPAGATE_BRANCHES = {"zero-copy": 1 << 62, "copied": 0}
PROPAGATE_KEYS = (0x9E3779B9, 0x7F4A7C15)
PROPAGATE_WE = PROPAGATE_BOOT = 5_000_000_000
# The 16-host stream's run through the eager window, the path that still
# launches the relay kernels: the fleet enters the TCP domain near 270 ms,
# so 330 ms gives half a dozen device rounds at a few seconds each (cut
# from 400 ms for the script's time limit).
EAGER_STOP = "330ms"


CARD_LINE = ""  # nvidia-smi's name and power limit, set by card()


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false "
                         "(no CUDA card); nothing was run")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    global CARD_LINE
    CARD_LINE = smi
    print(f"[card] {name}", flush=True)
    print(smi, flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    return name


def build_all():
    """The engine (make) and the kernel libraries (one nvcc per source),
    started together."""
    from shadow_tpu_torch.native import plane
    from shadow_tpu_torch.ops import (phold_span_kernel, phold_window,
                                      propagate, queues, relay,
                                      tcp_span_kernel, tcp_window)
    from shadow_tpu_torch.tools.tcp_window_profile import PROFILE_LIBRARY
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
                         ("relay.cu", relay.LIBRARY.build),
                         ("propagate.cu", propagate.LIBRARY.build),
                         ("phold_window.cu", phold_window.LIBRARY.build),
                         ("phold_span.cu", phold_span_kernel.LIBRARY.build),
                         ("tcp_window.cu", tcp_window.LIBRARY.build),
                         ("tcp_span.cu", tcp_span_kernel.LIBRARY.build),
                         ("tcp_window.cu profiling",
                          PROFILE_LIBRARY.build))]
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
          f"{relay.LIBRARY.build_s:.1f}s), propagate.cu "
          f"{walls['propagate.cu']:.1f}s (nvcc "
          f"{propagate.LIBRARY.build_s:.1f}s), phold_window.cu "
          f"{walls['phold_window.cu']:.1f}s (nvcc "
          f"{phold_window.LIBRARY.build_s:.1f}s), phold_span.cu "
          f"{walls['phold_span.cu']:.1f}s (nvcc "
          f"{phold_span_kernel.LIBRARY.build_s:.1f}s), tcp_window.cu "
          f"{walls['tcp_window.cu']:.1f}s (nvcc "
          f"{tcp_window.LIBRARY.build_s:.1f}s; its profiling build "
          f"{PROFILE_LIBRARY.build_s:.1f}s), tcp_span.cu "
          f"{walls['tcp_span.cu']:.1f}s (nvcc "
          f"{tcp_span_kernel.LIBRARY.build_s:.1f}s)", flush=True)
    # nvcc -Xptxas=-v: the window and span kernels' registers, stack and
    # spills.
    for src, lib in (("phold_window.cu", phold_window.LIBRARY),
                     ("phold_span.cu", phold_span_kernel.LIBRARY),
                     ("tcp_window.cu", tcp_window.LIBRARY),
                     ("tcp_window.cu profiling", PROFILE_LIBRARY),
                     ("tcp_span.cu", tcp_span_kernel.LIBRARY)):
        for ln in lib.log.splitlines():
            if ln.strip():
                print(f"[build] {src}: {ln.strip()}", flush=True)
    print(f"[build] stt_phold_span by team width: "
          f"{json.dumps(phold_span_props())}", flush=True)


def phold_span_props() -> dict:
    """nvcc's registers, stack and spills of each team width's
    instantiation of stt_phold_span (phold_span_kernel<W>)."""
    from shadow_tpu_torch.ops import phold_span_kernel
    parts = {w: f"phold_span_kernelILi{w}E" for w in (1, 8, 32)}
    props = kernel_props(phold_span_kernel.LIBRARY, tuple(parts.values()))
    return {w: props.get(part) for w, part in parts.items()}


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
    bs, ch = queues.BUCKET_STEP, queues.CODEL_HEAD
    stats = {}

    def calls(t, scalar_now, scalar_size=False):
        now = t["now"][0] if scalar_now else t["now"]
        size = t["size"][0] if scalar_size else t["size"]
        b_args = (t["bal"], t["nxt"], t["refill"], t["cap"],
                  t["unlimited"], size, now)
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

    def launch(name, reps, scalar_size):
        # `reps` back-to-back kernel launches from C (timing only;
        # counted nowhere).
        if name == "bucket_step":
            bs.launch(t["bal"], t["nxt"], t["refill"], t["cap"],
                      t["unlimited"],
                      t["size"][0] if scalar_size else t["size"],
                      t["now"], reps=reps)
        else:
            ch.launch(t["pop"], t["none"], t["now"], t["enq"],
                      t["bytes_after"], t["first_above"], reps=reps)

    # The TCP stream's width, ragged, and the PHOLD paths' shapes (a 0-d
    # packet size, as PholdSpanRunner calls), the only ones timed.
    for H, scalar_size in ((H_MAIN, False), (H_MAIN + 1, False),
                           (H_PHOLD, True), (H_RING, True)):
        t = adversarial(H)
        for scalar_now in (False, True):
            for name, (kern, plain) in calls(t, scalar_now,
                                             scalar_size).items():
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
                if H in (H_PHOLD, H_RING) and not scalar_now:
                    reps = 1000
                    ms = events_ms(lambda: launch(name, reps, scalar_size),
                                   reps)
                    gms = graph_ms(lambda: launch(name, 1, scalar_size),
                                   200)
                    call_ms = events_ms(
                        lambda: [kern() for _ in range(reps)], reps)
                    pms = graph_ms(plain)
                    per_lane = BYTES_PER_LANE[name] - (
                        8 if scalar_size and name == "bucket_step" else 0)
                    bound = per_lane * H / BANDWIDTH * 1e3
                    stats[(name, H)] = {
                        "ms": ms, "graph_ms": gms, "plain_ms": pms,
                        "call_ms": call_ms, "bound_ms": bound,
                        "max_abs_err": err, "H": H}
                print(f"[kernel] {name} H={H} scalar_now={scalar_now} "
                      f"scalar_size={scalar_size}: exact (max |err| {err})",
                      flush=True)
    for (name, _H), s in stats.items():
        print(f"[kernel] {name} H={s['H']}: {s['ms'] * 1e3:.3f} us per "
              f"launch on the card (back-to-back launches), "
              f"{s['graph_ms'] * 1e3:.3f} us in a CUDA graph, "
              f"{s['call_ms'] * 1e3:.2f} us host per wrapper call; "
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


def propagate_inputs(n: int, v: int, seed: int):
    """Seeded columns of one round on the card (as export_round gives
    them) and the (V, V) matrices: V = 3 the 3-tier graph's; V = 64
    random, with unreachable (TIME_NEVER) pairs and zero and full loss
    thresholds.  ~20% control packets, source hosts past 2**32, every
    pkt_seq bit pattern, send times on both sides of bootstrap_end."""
    from shadow_tpu_torch.core.simtime import TIME_NEVER
    from shadow_tpu_torch.net.graph import NetworkGraph, routing_arrays
    from shadow_tpu_torch.tools.netgen import THREE_TIER_GML
    rng = np.random.default_rng(seed)
    if v == 3:
        lat, thr = routing_arrays(NetworkGraph.from_gml(THREE_TIER_GML))
    else:
        lat = rng.integers(1, 80_000_000, (v, v), dtype=np.int64)
        lat[rng.random((v, v)) < 0.15] = TIME_NEVER
        thr = rng.integers(0, 1 << 32, (v, v), dtype=np.int64)
        thr[rng.random((v, v)) < 0.2] = 0
        thr[rng.random((v, v)) < 0.1] = 1 << 32
    cols = (rng.integers(0, v, n).astype(np.int32),
            rng.integers(0, v, n).astype(np.int32),
            rng.integers(0, 1 << 34, n, dtype=np.int64),
            rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
                np.uint32).view(np.int32),
            rng.integers(0, 10_000_000_000, n, dtype=np.int64),
            rng.random(n) < 0.2)
    mats = tuple(torch.tensor(m, device="cuda") for m in (lat, thr))
    return mats, tuple(torch.tensor(c, device="cuda") for c in cols)


def propagate_bound_ms(n: int, v: int):
    """The least time of one stt_propagate call: every input read once
    (the columns and both matrices), every output written once (the
    columns and the two minima), over the memory rate; the integer
    operations over the card's rate.  Returns (ms, "bytes"|"operations")."""
    nbytes = (PROPAGATE_IN_B + PROPAGATE_OUT_B) * n + 2 * 8 * v * v + 16
    by_bytes = nbytes / BANDWIDTH * 1e3
    by_ops = PROPAGATE_OPS * n / OPS_RATE * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def export_bytes(cols) -> tuple:
    """export_round's seven byte columns of propagate_inputs' columns
    (dst_host, which the law does not read, zero)."""
    sn, dn, sh, ps, ts, ctl = (c.cpu().numpy() for c in cols)
    return (sn.tobytes(), dn.tobytes(), np.zeros_like(sn).tobytes(),
            sh.tobytes(), ps.tobytes(), ts.tobytes(),
            ctl.astype(np.uint8).tobytes())


def stage_round(stage, export, n: int, window_end: int):
    """One round of the per-round route: pack, one call, the views."""
    from shadow_tpu_torch.ops.propagate import PROPAGATE
    stage.pack(export, n)
    PROPAGATE.round(stage, n, window_end)
    return stage.results(n)


def round_stage(mats, copy_min=None, time_every: int = 1):
    """A stage over the matrices, every round timed unless `time_every`
    says otherwise; `copy_min` forces a branch (PROPAGATE_BRANCHES)."""
    from shadow_tpu_torch.ops.propagate import COPY_MIN_PACKETS, RoundStage
    return RoundStage("cuda", *mats, PROPAGATE_KEYS, PROPAGATE_BOOT,
                      time_every=time_every,
                      copy_min=(COPY_MIN_PACKETS if copy_min is None
                                else copy_min))


def check_stage(n: int, v: int, mats, export, want) -> None:
    """The per-round route on both branches, exactly against the plain
    version's outputs `want` (deliver, keep, reachable, lossy, mins)."""
    from shadow_tpu_torch.ops.propagate import PROPAGATE
    want = [w.cpu().numpy() for w in want]
    for branch, copy_min in PROPAGATE_BRANCHES.items():
        stage = round_stage(mats, copy_min)
        stage.pack(export, n)
        stage.buf[stage.layout(n)["mins"]:] = 0xAB  # must be overwritten
        PROPAGATE.round(stage, n, PROPAGATE_WE)
        (keep, deliver, reach, lossy), md, ml = stage.results(n)
        bad = [name for name, g, w in (
            ("deliver", deliver, want[0]), ("keep", keep, want[1]),
            ("reachable", reach, want[2]), ("lossy", lossy, want[3]))
            if not np.array_equal(np.asarray(g).astype(w.dtype), w)]
        if [md, ml] != want[4].tolist():
            bad.append(f"mins {[md, ml]} != {want[4].tolist()}")
        if stage.copied != (branch == "copied"):
            bad.append(f"copied {stage.copied}")
        if bad:
            raise AssertionError(f"propagate round n={n} V={v} {branch}: "
                                 f"{bad} differ")
        del stage


def dispatch_times(stages: dict, export, n: int, reps: int) -> dict:
    """Host wall per round of the per-round route (pack, the one call,
    the views) and its parts on each stage of `stages`, the stages taking
    turns round by round after a warm-up: medians over `reps` rounds,
    microseconds; and the kernel's mean card time over the stage's timed
    rounds (its events; 0 on an untimed stage)."""
    from shadow_tpu_torch.ops.propagate import PROPAGATE
    for st in stages.values():
        for _ in range(5):
            stage_round(st, export, n, PROPAGATE_WE)
    pc = time.perf_counter_ns
    samples = {b: [] for b in stages}
    timed0 = {b: (st.plan.timed, st.plan.kernel_ms)
              for b, st in stages.items()}
    for _ in range(reps):
        for b, stage in stages.items():
            t0 = pc()
            stage.pack(export, n)
            t1 = pc()
            PROPAGATE.round(stage, n, PROPAGATE_WE)
            t2 = pc()
            stage.results(n)
            t3 = pc()
            samples[b].append((t3 - t0, t1 - t0, t2 - t1, t3 - t2))
    out = {}
    for b, rows in samples.items():
        med = np.median(np.array(rows, dtype=np.float64), axis=0) / 1e3
        plan, (k0, ms0) = stages[b].plan, timed0[b]
        out[b] = {"round_us": med[0], "pack_us": med[1], "call_us": med[2],
                  "views_us": med[3],
                  "kernel_us": ((plan.kernel_ms - ms0) * 1e3
                                / (plan.timed - k0) if plan.timed > k0
                                else 0.0),
                  "copied": stages[b].copied, "reps": reps}
    return out


def time_propagate(n: int, v: int = 3, seed: int = 5) -> dict:
    """stt_propagate_round against propagate_ref on the card at one
    shape, through the tensor API and through the per-round route on
    both branches (zero-copy and copied): every output exactly equal.
    Card time in a CUDA graph (200 tensor-API launches back to back on
    the card), host time per tensor-API call, the plain version in a
    CUDA graph, the bound, and the per-round route's dispatch at this
    size on the branch the size chooses."""
    from shadow_tpu_torch.ops.propagate import PROPAGATE, propagate_ref
    mats, cols = propagate_inputs(n, v, seed)
    we, be = PROPAGATE_WE, PROPAGATE_BOOT
    args = (*mats, *PROPAGATE_KEYS, *cols, we, be)
    got = PROPAGATE(*args)
    want = propagate_ref(*args)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    bad = [name for name, g, w in zip(
        ("deliver", "keep", "reachable", "lossy", "mins"), got, want)
        if g.dtype != w.dtype or not torch.equal(g, w)]
    if bad:
        raise AssertionError(f"propagate n={n} V={v}: {bad} differ "
                             f"(max |err| {err})")
    export = export_bytes(cols)
    check_stage(n, v, mats, export, want)
    keep = got[1]
    ms = graph_ms(lambda: PROPAGATE.launch(*args, out=got), 200)
    pms = graph_ms(lambda: propagate_ref(*args), 20)
    reps = 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        PROPAGATE.launch(*args, out=got)
    call_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    bound, by = propagate_bound_ms(n, v)
    d = dispatch_times({"default": round_stage(mats)}, export, n,
                       sweep_reps(n))["default"]
    row = {"ms": ms, "graph_ms": ms, "plain_ms": pms, "call_ms": call_ms,
           "bound_ms": bound, "bound_by": by, "max_abs_err": err, "n": n,
           "V": v, "dispatch": d}
    print(f"[propagate] n={n} V={v}: exact, tensor API and the per-round "
          f"route zero-copy and copied ({int(keep.sum())} kept, "
          f"{int((~got[2]).sum())} unreachable, {int(got[3].sum())} lost, "
          f"mins {got[4].tolist()}); {ms * 1e3:.3f} us per launch on the "
          f"card (CUDA graph, back to back), {call_ms * 1e3:.2f} us host "
          f"per tensor-API call; plain PyTorch {pms * 1e3:.3f} us (CUDA "
          f"graph); bound {bound * 1e3:.3f} us by {by}; per-round route "
          f"({'copied' if d['copied'] else 'zero-copy'}) "
          f"{d['round_us']:.2f} us a round (pack {d['pack_us']:.2f}, call "
          f"{d['call_us']:.2f}, views {d['views_us']:.2f}; kernel "
          f"{d['kernel_us']:.3f} us by its events)", flush=True)
    return row


def sweep_reps(n: int) -> int:
    return max(9, min(2000, 4_000_000 // (n + 2_000)))


def propagate_sweep() -> dict:
    """The per-round route's dispatch at PROPAGATE_SWEEP_N packets on
    each branch (and, at the sizes the main path sends, an untimed
    zero-copy stage: what the timing events cost), the stages taking
    turns round by round (V = 3), and the least swept size from which on
    the copied branch's median round is faster: what COPY_MIN_PACKETS is
    set from.  Then the default stage's choice either side of
    COPY_MIN_PACKETS."""
    from shadow_tpu_torch.ops.propagate import COPY_MIN_PACKETS
    mats, _ = propagate_inputs(1, 3, 1)
    stages = {b: round_stage(mats, c) for b, c in PROPAGATE_BRANCHES.items()}
    untimed = round_stage(mats, PROPAGATE_BRANCHES["zero-copy"], 0)
    rows = {}
    for n in PROPAGATE_SWEEP_N:
        _, cols = propagate_inputs(n, 3, n % 9973)
        legs = dict(stages)
        if n <= 1_000:
            legs["zero-copy untimed"] = untimed
        rows[n] = dispatch_times(legs, export_bytes(cols), n, sweep_reps(n))
        print(f"[propagate] sweep n={n} (medians of {sweep_reps(n)}): "
              + "; ".join(
                  f"{b} {r['round_us']:.2f} us a round (pack "
                  f"{r['pack_us']:.2f}, call {r['call_us']:.2f}, kernel "
                  f"{r['kernel_us']:.3f})" for b, r in rows[n].items()),
              flush=True)
    faster = [n for n in PROPAGATE_SWEEP_N
              if all(rows[m]["copied"]["round_us"]
                     < rows[m]["zero-copy"]["round_us"]
                     for m in PROPAGATE_SWEEP_N if m >= n)]
    print(f"[propagate] sweep: the copied branch is faster from "
          f"{faster[0] if faster else 'no swept size'} on; "
          f"COPY_MIN_PACKETS = {COPY_MIN_PACKETS}", flush=True)
    stage = round_stage(mats)
    for n in (COPY_MIN_PACKETS - 1, COPY_MIN_PACKETS):
        _, cols = propagate_inputs(n, 3, 3)
        stage_round(stage, export_bytes(cols), n, PROPAGATE_WE)
        if stage.copied != (n >= COPY_MIN_PACKETS):
            raise AssertionError(f"propagate: a {n}-packet round copied "
                                 f"{stage.copied}")
    del stages, stage, untimed
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def check_propagate() -> dict:
    """Phase 2's stt_propagate_round leg: exact and timed at every shape
    with both matrices (the 3-tier graph's, staged in shared memory, and
    a random V = 64, read through the read-only cache), then the sweep
    of the per-round route's two branches."""
    stats = {}
    for v in (3, 64):
        for n in PROPAGATE_N:
            stats[(n, v)] = time_propagate(n, v, seed=n % 9973 + v)
        gc.collect()
        torch.cuda.empty_cache()
    stats["sweep"] = propagate_sweep()
    return stats


def ring_config(spans: str, overlap: str):
    """phold-64k-ring (bench.py phold_rung's 64k rung: 65,536 LPs, ring
    peers 16; 1 Gbit, 5 ms, LPs start at 100 ms) to 1.0 s instead of the
    rung's 0.15 s, every per-round round on the C++ twin.  The YAML is
    generated and parsed once."""
    from shadow_tpu_torch.ops.propagate import HOST_ONLY
    from shadow_tpu_torch.tools.netgen import phold_yaml
    if not hasattr(ring_config, "base"):
        t0 = time.perf_counter()
        text = phold_yaml(H_RING, n_init=1, mean_delay_ns=20_000_000,
                          stop_time="1.0s", seed=13, scheduler="tpu",
                          peers_per_host=16)
        ring_config.base = parse_yaml(text)
        print(f"[phold-64k-ring] {H_RING} LPs, stop_time 1.0s, caps "
              f"{RING_CAPS}; YAML {len(text) / 2**20:.1f} MiB parsed in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return config_with(ring_config.base, tpu_device_spans=spans,
                       span_overlap=overlap, tpu_min_device_batch=HOST_ONLY)


def window_cells() -> dict:
    """Phase 2's window exports: name -> (config, which in-domain export,
    runner caps).  mesh-codel-10's sixth export lies inside its CoDel
    stretch (its traffic ends at 3.9 s); mesh-24's second lies in its
    paced stream, the one cell whose run is mostly the span kernel."""
    cells = phold_cells()
    return {"phold-8k": (cells["phold-8k"][0]("force"), 2, None),
            "mesh-24": (cells["mesh-24"][0]("force"), 2, None),
            "mesh-codel-10": (cells["mesh-codel-10"][0]("force"), 6, None),
            "phold-64k-ring": (ring_config("force", "off"), 2, RING_CAPS)}


def window_graph_ms(fn, base: dict, pay: int, window_end: int,
                    n: int) -> list:
    """Card time per window of the built loop `fn`'s kernel step, once
    per replay of three: `n` launches back to back in one CUDA graph,
    each on its own copy of `base` (the written operands cloned, the
    rest shared), restored before each replay.  The card sleeps while
    the host records the start event and launches the graph, so neither
    the host's issue nor the graph's launch is in the time."""
    from shadow_tpu_torch.tools.relay_cases import clone_state
    ref = clone_state(base)
    fn.prepare(ref, pay)
    fn.step.begin(ref, pay)
    written = [o.key for o in fn.step.table.ops
               if o.written and o.key in ref]
    copies = [dict(ref, **{k: ref[k].clone() for k in written})
              for _ in range(n)]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in copies:
            fn.step.launch(c, window_end)
    out = []
    for _ in range(3):
        for c in copies:
            for k in written:
                c[k].copy_(ref[k])
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        g.replay()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / n)
    del g, copies
    return out


def span_card_ms(fn, base: dict, args: tuple, n: int, *pay) -> tuple:
    """Card time and host issue of the built loop `fn`'s span step (the
    PHOLD runner's takes its payload `pay`), one launch at a time on a
    fresh copy of `base` (the written operands cloned, the rest shared):
    the card sleeps while the host records the start event and issues
    the launch, so the event pair holds the kernel alone (a cooperative
    launch is not captured in a CUDA graph here), and the host clock
    around the launch call holds its issue alone.  Returns (card ms,
    host issue ms) per launch, each over `n` launches."""
    from shadow_tpu_torch.tools.relay_cases import clone_state
    ref = clone_state(base)
    fn.prepare(ref, *pay)
    fn.span.begin(ref, *pay)
    written = [o.key for o in fn.span.table.ops
               if o.written and o.key in ref]
    card_ms, issue_ms = [], []
    for _ in range(n):
        c = dict(ref, **{k: ref[k].clone() for k in written})
        fn.span.begin(c, *pay)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        t0 = time.perf_counter()
        fn.span.launch(c, *args)
        issue_ms.append((time.perf_counter() - t0) * 1e3)
        e1.record()
        e1.synchronize()
        card_ms.append(e0.elapsed_time(e1))
        del c
    del ref
    return card_ms, issue_ms


def check_phold_window() -> tuple:
    """Phase 2's PHOLD legs: stt_phold_window and stt_phold_span.  For
    each cell's export on the card, copies of the same state through the
    kernels and through their plain version (the runner's eager loop:
    the eager window, then the eager round end):

    - the window kernel: one window, then four rounds with the eager
      round ends between the windows;
    - the span kernel: whole spans of one and of four rounds, at the
      team width its wrapper picks from the lane count and at a team of
      one;

    every state column, the outbox and the trace in canonical order,
    ks_fires, ks_lanes, the micro-iterations, the run's scalars (start,
    runahead, rounds, busy rounds, packets, busy end) and the abort bits
    exactly equal.  With the outbox cut to H + 2 slots (phold-8k and
    phold-64k-ring) the plain loop and both kernels (the span kernel at
    both widths) abort with AB_OUT alone.  Times: the window kernel per
    launch (window_graph_ms) and per wrapper call, the plain window, the
    bound from the bytes one
    window must move (ops/phold_window.py window_need_bytes); the span
    kernel per four-round span and per round (span_card_ms), its host
    issue per launch, the plain loop's four rounds, the bound from the
    bytes the four rounds must move (ops/phold_span_kernel.py
    span_need_bytes, from the plain loop and the span kernel's operand
    table: each window's reads, each round end's packets and moved
    entries, the span's changed words once), and the span's phase
    clocks, each also at a team of one.  Returns (window rows, span
    rows) by cell."""
    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.ops import phold_span_kernel as pks
    from shadow_tpu_torch.ops import phold_window as pw
    from shadow_tpu_torch.ops.span_mesh import AB_OUT
    from shadow_tpu_torch.tools.relay_cases import clone_state
    from shadow_tpu_torch.tools.window_cases import (capture_export,
                                                     device_state,
                                                     window_mismatch)
    stats, span_stats = {}, {}
    for name, (cfg, nth, caps) in window_cells().items():
        tag = f"[window {name}]"
        t0 = time.perf_counter()
        runner, st_np, (start, stop, limit, runahead) = capture_export(
            Manager(cfg, device="cuda"), nth, caps)
        pay, H = runner._pay, runner._H
        base = device_state(runner, st_np)
        del st_np
        we = min(start + runahead, stop)

        def build(path: str):
            # "plain": the eager loop; "window": the window kernel and
            # the eager round ends; "span": the span kernel at the team
            # width its wrapper picks; "span1": at a team of one.
            runner.window_factory = {"plain": pw.eager_window,
                                     "window": pw.PHOLD_WINDOW.bind,
                                     "span": None, "span1": None}[path]
            runner.span_factory = None if path != "span1" else (
                lambda shape, params: pks.PHOLD_SPAN.bind(shape, params,
                                                          team=1))
            try:
                return runner._build()
            finally:
                runner.span_factory = None

        plain, kern, span, span1 = (build("plain"), build("window"),
                                    build("span"), build("span1"))
        assert span.span is not None and kern.step is not None
        print(f"{tag} export {nth} at {start / 1e9:.4f}s ({H} lanes, "
              f"window {runahead / 1e6:.3f} ms) in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        # One window each way.
        a = clone_state(base)
        plain.prepare(a, pay)
        it = plain.window_plain(a, we)
        b = clone_state(base)
        kern.prepare(b, pay)
        before = clone_state(b)
        kern.step.begin(b, pay)
        kern.step(b, we)
        got = kern.step.end()
        torch.cuda.synchronize()
        bad = window_mismatch(a, b) + [
            what for what, x, y in (
                ("iterations", it, got["iters"]),
                ("ks_fires", a["ks_fires"], got["fires"]),
                ("ks_lanes", a["ks_lanes"], got["lanes"]),
                ("abort", int(a["abort_code"]), int(b["abort_code"])))
            if not np.array_equal(x, y)]
        if bad or it == 0:
            raise AssertionError(f"{tag} one window: {bad} differ "
                                 f"({it} iterations)")
        n_out, n_tr = int(b["out_n"]), int(b["tr_n"])
        lanes = got["lanes"]
        need = pw.window_need_bytes(kern.step.table.ops, before, b)
        del a, b, before
        # Spans of one and four rounds: the plain loop, then the window
        # kernel (four rounds) and the span kernel against it.
        args = {mr: (start, stop, limit, runahead, mr) for mr in (1, 4)}
        want = {mr: plain(clone_state(base), pay, *args[mr])
                for mr in (1, 4)}
        runs = [("window kernel", 4, kern(clone_state(base), pay,
                                          *args[4]))]
        runs += [(f"span kernel ({what})", mr, fn(clone_state(base), pay,
                                                  *args[mr]))
                 for what, fn in (("picked team", span), ("team 1", span1))
                 for mr in (1, 4)]
        for what, mr, (rb, *rest_b) in runs:
            ra, *rest_a = want[mr]
            bad = window_mismatch(ra, rb) + [
                k for k in ("ks_fires", "ks_lanes")
                if not np.array_equal(ra[k], rb[k])]
            if bad or rest_a != rest_b or rest_a[2] != mr \
                    or int(ra["abort_code"]) or int(rb["abort_code"]) \
                    or rb["ks_windows"] != mr:
                raise AssertionError(f"{tag} {what}, {mr} rounds: {bad} "
                                     f"differ, {rest_a} vs {rest_b}, "
                                     f"windows {rb['ks_windows']}")
        ra, *rest_a = want[4]
        codel = int((ra["codel_dropped"] - base["codel_dropped"]).sum())
        if name == "mesh-codel-10" and codel == 0:
            raise AssertionError(f"{tag} no CoDel drop in four rounds")
        span_rounds = rest_a[2]
        del want, runs, ra
        if name in ("phold-8k", "phold-64k-ring"):
            # One forced overflow: the outbox cut to H + 2 slots.
            cap = runner.cap_out
            runner.cap_out = H + 2
            paths = ("plain", "window", "span", "span1")
            codes = [int(build(path)(clone_state(base), pay,
                                     *args[4])[0]["abort_code"])
                     for path in paths]
            runner.cap_out = cap
            if codes != [AB_OUT] * len(paths):
                raise AssertionError(f"{tag} outbox overflow: abort bits "
                                     f"{codes} ({', '.join(paths)})")
            print(f"{tag} outbox cut to H + 2: plain, window and span "
                  f"kernel (picked team and team 1) all abort with bits "
                  f"{codes[0]}", flush=True)
            plain, kern, span, span1 = (build("plain"), build("window"),
                                        build("span"), build("span1"))
        ms = window_graph_ms(kern, base, pay, we, 10)
        call, ms_call = [], []
        for _ in range(5):
            c = clone_state(base)
            kern.prepare(c, pay)
            kern.step.begin(c, pay)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            kern.step(c, we)
            call.append(time.perf_counter() - t1)
            ms_call.append(kern.step.end()["window_ms"])
            del c
        pms, span_pms = [], []
        for _ in range(2):
            for fn, out in ((lambda c: plain.window_plain(c, we), pms),
                            (lambda c: plain(c, pay, *args[4]), span_pms)):
                c = clone_state(base)
                plain.prepare(c, pay)
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn(c)
                e1.record()
                e1.synchronize()
                out.append(e0.elapsed_time(e1))
                del c
        nbytes = need["total"]
        row = {"ms": float(np.median(ms)), "graph_ms": float(np.median(ms)),
               "ms_min": min(ms), "ms_max": max(ms),
               "call_ms": float(np.median(call)) * 1e3,
               "plain_ms": float(np.median(pms)),
               "bound_ms": nbytes / BANDWIDTH * 1e3, "bytes": nbytes,
               "max_abs_err": 0, "iters": it, "H": H, "lanes": lanes}
        stats[name] = row
        print(f"{tag} window kernel exact: one window ({it} "
              f"micro-iterations; fires {got['fires'].tolist()}, lanes "
              f"{lanes.tolist()}, law calls {got['calls'].tolist()}; "
              f"outbox {n_out}, trace {n_tr}) and four rounds ("
              f"{rest_a[-1]} micro-iterations, {codel} CoDel drops); "
              f"{row['ms'] * 1e3:.3f} us per launch on the card (CUDA "
              f"graph of 10, fresh state each; median of 3 replays, "
              f"{row['ms_min'] * 1e3:.3f}-{row['ms_max'] * 1e3:.3f}), "
              f"{row['call_ms'] * 1e3:.1f} us host per wrapper call "
              f"(launch to end {np.median(ms_call) * 1e3:.1f} us); plain "
              f"window {row['plain_ms']:.3f} ms; bound "
              f"{row['bound_ms'] * 1e3:.3f} us by bytes ({nbytes} B: "
              + ", ".join(f"{k} {v}" for k, v in need.items()
                          if k != "total") + ")",
              flush=True)
        # The span kernel's times (one and four rounds), bound and phase
        # clocks (four rounds), at the picked team and at a team of one.
        card1, _ = span_card_ms(span, base, args[1], 5, pay)
        card, issue = span_card_ms(span, base, args[4], 5, pay)
        card_w1, _ = span_card_ms(span1, base, args[4], 5, pay)
        got = {}
        for what, fn in (("picked", span), ("one", span1)):
            c = clone_state(base)
            fn.prepare(c, pay)
            got[what] = fn.span(c, pay, *args[4])
            del c
        clk_w1 = got["one"]["clocks"]
        got = got["picked"]
        sneed = pks.span_need_bytes(plain, span.span.table.ops,
                                    clone_state(base), pay, *args[4])
        clk = got["clocks"]
        srow = {"ms": float(np.median(card)), "ms_min": min(card),
                "ms_max": max(card), "rounds": span_rounds,
                "ms_per_round": float(np.median(card)) / span_rounds,
                "ms_1_round": float(np.median(card1)),
                "call_ms": float(np.median(issue)),
                "launch_to_end_ms": got["span_ms"],
                "plain_ms": float(np.median(span_pms)),
                "bound_ms": sneed["total"] / BANDWIDTH * 1e3,
                "bytes": sneed["total"], "bound_parts": sneed,
                "max_abs_err": 0, "H": H, "clocks": clk,
                "blocks": span.span.blocks, "team": span.span.team,
                "grids": span.span.grids,
                "ms_team1": float(np.median(card_w1)),
                "clocks_team1": clk_w1}
        if name == "phold-64k-ring":
            # Phase 8's kernel leg on the ring export: the channels on.
            srow["channels"] = check_channel_spans(
                f"[channels {name}]", runner, base,
                (start, stop, limit, runahead), (pay,), pw.eager_window)
        span_stats[name] = srow
        share = {k: clk[k] / max(clk["span"], 1)
                 for k in ("window", "propagate", "settle", "wait")}
        print(f"{tag} span kernel exact: spans of 1 and 4 rounds "
              f"({rest_a[-1]} micro-iterations in 4); "
              f"{srow['ms'] * 1e3:.3f} us per 4-round span on the card "
              f"({srow['ms_per_round'] * 1e3:.3f} us a round; median of "
              f"5 launches on fresh copies, {srow['ms_min'] * 1e3:.3f}-"
              f"{srow['ms_max'] * 1e3:.3f}; a 1-round span "
              f"{srow['ms_1_round'] * 1e3:.3f} us), host issue "
              f"{srow['call_ms'] * 1e3:.1f} us per launch, launch to end "
              f"{got['span_ms'] * 1e3:.1f} us; team {srow['team']} "
              f"({srow['blocks']} blocks of 64 threads; blocks needed and "
              f"held by team width {srow['grids']}); at a team of one "
              f"{srow['ms_team1'] * 1e3:.3f} us per 4-round span, phase "
              f"clocks {clk_w1}; plain loop {srow['plain_ms']:.3f} ms; "
              f"bound "
              f"{srow['bound_ms'] * 1e3:.3f} us by bytes "
              f"({sneed['total']} B: window reads {sneed['window']}, "
              f"round ends {sneed['round_end']}, changed words "
              f"{sneed['state']}); phase clocks (cycles: each phase "
              f"to its barrier's exit, wait the part inside the barriers) "
              f"{clk}, shares of the span "
              + ", ".join(f"{k} {v:.3f}" for k, v in share.items()),
              flush=True)
        del base, plain, kern, span, runner
        gc.collect()
        torch.cuda.empty_cache()
    return stats, span_stats


def log_spans(mgr, window_factory=None, capture: dict | None = None):
    """Print one line per device-span attempt (progress for a long run),
    on the Manager's TCP runner (with `window_factory`, its window step).
    With `capture`, the first in-domain export is cloned into it before
    the span runs: `capture["st"]` (the runner's device state),
    `capture["args"]` (start, stop, limit, runahead) and
    `capture["runner"]`."""
    from shadow_tpu_torch.tools.relay_cases import clone_state
    runner = mgr._dev_span_tcp = mgr.make_tcp_span_runner()
    runner.window_factory = window_factory
    try_span = runner.try_span
    export_state = runner.export_state
    current = {}

    def logged(start, *a, **k):
        current["args"] = (int(start), int(a[0]), int(a[1]), int(a[2]))
        t0 = time.perf_counter()
        res = try_span(start, *a, **k)
        print(f"[span] start {start / 1e9:.4f}s -> "
              f"{'none' if res is None else res[:3]} in "
              f"{time.perf_counter() - t0:.1f}s (micro-iterations "
              f"{runner.micro_iters}, aborts {runner.aborts}, transient "
              f"{runner.over_caps})", flush=True)
        return res

    def exported():
        st = export_state()
        if capture is not None and "st" not in capture \
                and isinstance(st, dict):
            capture.update(st=clone_state(st), args=current["args"],
                           runner=runner)
        return st
    runner.try_span = logged
    runner.export_state = exported


def stream_pair(n_hosts: int, stop_time: str, min_share: float,
                k_init: int | None = None, reference: dict | None = None,
                path: str = "kernel", capture: dict | None = None):
    """The tgen TCP bulk stream (tools/span_loop_bench.stream_config)
    through the port's Manager on the card, once with the C++ engine
    serving every round and once with forced device spans (the router's
    first window `k_init` rounds where given); with a `reference` (the
    C++ run's trace digest, lines, packets and events, as
    stream_results gives them, recorded from earlier runs) the C++ run
    is not repeated.  The forced run's spans go through `path`:
    "kernel" (the main path: one stt_tcp_span launch a span), "window"
    (the eager loop with one stt_tcp_window launch a window and the
    eager round ends) or "eager" (the eager loop with the eager window:
    the relay kernels).  Requires identical results, a device span, at
    least `min_share` of the rounds on the card, a resident hit on every
    span after the first (less stale drops), and the path's launch
    gates: through the span kernel, one stt_tcp_span launch and one read
    of its words per dispatch (aborted and refused ones too), every
    committed round stepped inside it, no eager round end and no window,
    relay or law kernel; through the window kernel, one stt_tcp_window
    launch per window stepped in every dispatch, one per round of the
    committed spans and no span, relay or law kernel; through the eager
    window, each relay kernel launched once per fire of its stage and no
    window, span or law kernel; never a PHOLD kernel.  With `capture`,
    the forced run's first in-domain export is cloned into it
    (log_spans).  Returns the forced run's kernel launch counts and lanes
    per fire of each relay stage."""
    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.ops import tcp_span
    from shadow_tpu_torch.ops.tcp_window import TCP_WINDOW, eager_window
    from shadow_tpu_torch.tools.span_loop_bench import (run_stream,
                                                        stream_config)

    tag = f"[stream {n_hosts}{'' if path == 'kernel' else ' ' + path}]"
    factory = {"kernel": None, "window": TCP_WINDOW.bind,
               "eager": eager_window}[path]
    print(f"{tag} {n_hosts} hosts ({max(1, n_hosts // 8)} tgen servers), "
          f"stop_time {stop_time}, forced spans through "
          + {"kernel": "stt_tcp_span",
             "window": "stt_tcp_window and the eager round ends",
             "eager": "the eager window and round ends"}[path],
          flush=True)
    runs = {}
    for spans in ("off", "force")[reference is not None:]:
        cfg = stream_config(n_hosts, stop_time, spans)
        if k_init is not None:
            cfg.experimental.dev_span_k_init = k_init
        mgr = Manager(cfg, device="cuda")
        if spans == "force":
            log_spans(mgr, factory, capture)
        wrappers = kernel_wrappers()
        # Counts cover this run only: zeroed just before it.
        zero_counts(wrappers)
        # Earlier runs' span state (held in reference cycles) freed first.
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        run = run_stream(mgr)
        run["launches"] = {name: w.launches for name, w in wrappers.items()}
        run["host_reads"] = wrappers["tcp_span"].host_reads
        run["phold"] = mgr._dev_span
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
                  f"export {r.export_bytes / 2**30:.2f} GiB in "
                  f"{r.export_wall_ns / 1e9:.1f}s / import "
                  f"{r.import_bytes / 2**30:.2f} GiB in "
                  f"{r.import_wall_ns / 1e9:.1f}s, law calls in the lanes "
                  f"{r.ks_calls.tolist()}, launches {run['launches']}, "
                  f"span launches {r.spans_all} (launch to end "
                  f"{r.ks_span_ms:.3f} ms over {r.ks_spans} committed), "
                  f"eager round ends {r.eager_round_ends}", flush=True)
            print_residency(tag, r)
            print_stages(tag, r)
        if not summary.ok:
            raise AssertionError(f"plugin errors: "
                                 f"{summary.plugin_errors[:3]}")
    dev = runs["force"]
    sd, r = dev["summary"], dev["runner"]
    if reference is None:
        reference = stream_results(runs["off"])
        if any(runs["off"]["launches"].values()):
            raise AssertionError(f"{tag} the C++ run launched "
                                 f"{runs['off']['launches']}")
    else:
        print(f"{tag} the C++ engine's results, recorded: {reference}",
              flush=True)
    if stream_results(dev) != reference:
        raise AssertionError(f"{tag} the device-span run's results "
                             f"{stream_results(dev)} differ from the C++ "
                             f"engine's {reference}")
    if r is None or r.spans == 0 or r.rounds == 0:
        raise AssertionError(f"{tag} no device span ran")
    if r.rounds < min_share * sd.rounds:
        raise AssertionError(f"{tag} only {r.rounds}/{sd.rounds} rounds "
                             f"on the device (< {min_share:.0%})")
    if r.resident_hits < r.spans - 1 - r.stale_drops:
        raise AssertionError(f"{tag} {r.resident_hits} resident hits over "
                             f"{r.spans} spans ({r.stale_drops} stale)")
    launches = dev["launches"]
    if path == "kernel":
        # One span-kernel launch and one read of its words per dispatch
        # (aborted spans and refused speculative windows launched too),
        # every committed round inside it, no eager round end.
        n = launches["tcp_span"]
        if n <= 0 or n != r.spans_all or dev["host_reads"] != n \
                or r.ks_spans != r.spans or r.ks_windows != r.rounds \
                or r.eager_round_ends:
            raise AssertionError(f"{tag} tcp_span launched {n} times "
                                 f"({dev['host_reads']} host reads) for "
                                 f"{r.spans_all} dispatches ({r.ks_spans} "
                                 f"committed of {r.spans} spans; "
                                 f"{r.ks_windows} rounds inside of "
                                 f"{r.rounds}); eager round ends "
                                 f"{r.eager_round_ends}")
        never = ("tcp_window", "relay1_law", "relay2_law")
    elif path == "window":
        # One window-kernel launch per window stepped, over every
        # dispatch (aborted spans and refused speculative windows
        # launched too), one per round of the committed spans.
        n = launches["tcp_window"]
        if n <= 0 or n != r.windows_all or r.ks_windows != r.rounds:
            raise AssertionError(f"{tag} tcp_window launched {n} times "
                                 f"for {r.windows_all} windows "
                                 f"({r.ks_windows} committed, {r.rounds} "
                                 f"rounds)")
        never = ("tcp_span", "relay1_law", "relay2_law")
    else:
        # One launch per fire of the relay stage, over every dispatch.
        for name, code in (("relay1_law", tcp_span.KS_INET_OUT),
                           ("relay2_law", tcp_span.KS_CODEL)):
            fires, fires_all = int(r.ks_fires[code]), \
                int(r.fires_all[code])
            if fires <= 0 or launches[name] != fires_all:
                raise AssertionError(f"{tag} {name} launched "
                                     f"{launches[name]} times for "
                                     f"{fires_all} fires of its stage "
                                     f"({fires} committed)")
        never = ("tcp_window", "tcp_span")
    # The relay laws run inside the lanes or the relay kernels: the span
    # loop launches no standalone law kernel (nor a PHOLD kernel).
    for name in never + ("bucket_step", "codel_head", "phold_window",
                         "phold_span", "propagate"):
        if launches[name] != 0:
            raise AssertionError(f"{tag} the span loop launched {name} "
                                 f"{launches[name]} times")
    # The router tries the PHOLD family first: one structural refusal
    # per run, then the TCP family serves every span.
    ph = dev["phold"]
    if ph is None or ph.ineligible != 1 or ph.spans != 0:
        raise AssertionError(f"{tag} the PHOLD probe did not refuse once")
    print(f"{tag} PHOLD probe: refused structurally once in "
          f"{ph.export_wall_ns / 1e6:.3f} ms", flush=True)
    print(f"{tag} PASS: identical traces, {r.rounds}/{sd.rounds} rounds "
          f"on the card, "
          + {"kernel": f"one stt_tcp_span launch per dispatch "
                       f"({launches['tcp_span']}), no eager round end, no "
                       f"window or relay kernel",
             "window": f"one stt_tcp_window launch per window "
                       f"({launches['tcp_window']}), no relay kernel",
             "eager": f"one relay launch per relay fire "
                      f"({launches['relay1_law']} / "
                      f"{launches['relay2_law']})"}[path], flush=True)
    lanes = {code: r.ks_lanes[code] / max(r.ks_fires[code], 1)
             for code in (tcp_span.KS_INET_OUT, tcp_span.KS_CODEL)}
    return launches, lanes


def ptxas_props(log: str) -> dict:
    """nvcc -Xptxas=-v's report by function (mangled name): registers
    and shared bytes (entry functions), stack frame, spill stores and
    spill loads."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Function properties for|Compiling entry "
                      r"function) '?([\w$]+)", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            if m:
                cur["static_smem"] = int(m.group(1))
    return out


def kernel_props(lib, parts: tuple) -> dict:
    """ptxas_props of the functions of `lib` whose names hold one of
    `parts`, by part."""
    props = ptxas_props(lib.log)
    return {part: v for part in parts for k, v in props.items()
            if part in k and v}


def frame_text(shape: dict) -> str:
    """The lane frame's shape as a launch_shape gives it."""
    return (f"lane frame {shape['frame_bytes']} B a tile "
            f"({shape['frame_host_words']} host words and "
            f"{shape['frame_conn_words']} words a conn row for up to "
            f"{shape['frame_conns']} conn rows)")


def tcp_export(loss: float) -> tuple:
    """The 16-host stream's (tools/netgen.tcp_stream_yaml: 50 MB per
    client, seed 11, the tier-1 tests' stream) first in-domain export on
    the card, at `loss`: (runner, numpy state, span arguments)."""
    from shadow_tpu_torch.tools.tcp_window_profile import capture
    return capture(16, loss)


def tcp_window_ms(fn, base: dict, window_end: int, n: int,
                  graph: bool) -> list:
    """Card time per window of the built loop `fn`'s kernel step, on
    copies of `base` (the written operands cloned, the rest shared),
    restored before each timing.  With `graph`, `n` launches back to
    back in one CUDA graph, each on its own copy, once per replay of
    three; else `n` single launches on one copy (a state too large for
    ten copies).  The card sleeps while the host records the start event
    and issues the work, so neither the host's issue nor the graph's
    launch is in the time."""
    from shadow_tpu_torch.tools.relay_cases import clone_state
    ref = clone_state(base)
    fn.prepare(ref)
    fn.step.begin(ref)
    written = [o.key for o in fn.step.table.ops
               if o.written and o.key in ref]
    copies = [dict(ref, **{k: ref[k].clone() for k in written})
              for _ in range(n if graph else 1)]
    out = []
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for c in copies:
                fn.step.launch(c, window_end)
    for _ in range(3 if graph else n):
        for c in copies:
            for k in written:
                c[k].copy_(ref[k])
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        if graph:
            g.replay()
        else:
            fn.step.launch(copies[0], window_end)
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / (n if graph else 1))
    if graph:
        del g
    del copies, ref
    return out


def check_tcp_window(name: str, runner, base: dict, args: tuple,
                     graph: bool = True, profile: bool = False) -> dict:
    """Phase 2's TCP leg on one export: stt_tcp_window against its plain
    version (the runner's eager window) on copies of the same state:
    every state column (conn-major ones without their trash row), the
    outbox and the trace in canonical order, ks_fires, ks_lanes, the
    micro-iterations and the abort bits and site exactly equal, with the
    timer heap's minimum kept between pops and without it.  With
    `profile`, the profiling build's window (equal to the kernel's) and
    its slowest lanes (tools/tcp_window_profile.py).  Times:
    the plain window (CUDA events), the kernel's card time per window
    with the timer heap's minimum kept between pops and without it
    (tcp_window_ms: ten launches in a CUDA graph, or with `graph` off
    three single launches), host time per wrapper call, and the bound
    from the bytes the window must move (ops/tcp_window.py
    window_need_bytes).  Returns the kernels line's row."""
    from shadow_tpu_torch.ops import tcp_window as tw
    from shadow_tpu_torch.tools import tcp_window_profile
    from shadow_tpu_torch.tools.relay_cases import clone_state
    from shadow_tpu_torch.tools.window_cases import tcp_window_mismatch
    tag = f"[tcp window {name}]"
    start, stop, _limit, runahead = args
    we = min(start + runahead, stop)

    def build(factory):
        runner.window_factory = factory
        return runner._build()

    plain, kern = build(tw.eager_window), build(tw.TCP_WINDOW.bind)
    assert plain.step is None and kern.step is not None
    print(f"{tag} export at {start / 1e9:.4f}s ({runner._H} lanes, "
          f"{runner._n_conns} conns, window {runahead / 1e6:.3f} ms)",
          flush=True)
    a = clone_state(base)
    plain.prepare(a)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    it = plain.window_plain(a, we)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    b = clone_state(base)
    kern.prepare(b)
    before = clone_state(b)
    kern.step.begin(b)
    kern.step(b, we)
    got = kern.step.end()
    torch.cuda.synchronize()
    bad = tcp_window_mismatch(a, b) + [
        what for what, x, y in (
            ("iterations", it, got["iters"]),
            ("ks_fires", a["ks_fires"], got["fires"]),
            ("ks_lanes", a["ks_lanes"], got["lanes"]),
            ("abort", int(a["abort_code"]), int(b["abort_code"])),
            ("abort site", int(a["abort_site"]), int(b["abort_site"])))
        if not np.array_equal(x, y)]
    if bad or it == 0 or int(b["abort_code"]):
        raise AssertionError(f"{tag} one window: {bad} differ ({it} "
                             f"iterations, abort {int(b['abort_code'])})")
    need = tw.window_need_bytes(kern.step.table.ops, before, b)
    n_out, n_tr = int(b["out_n"]), int(b["tr_n"])
    del a, before
    # The lane without the timer heap's kept minimum: the same window.
    kern.step.table.params["th_cache"] = 0
    c = clone_state(base)
    kern.prepare(c)
    kern.step.begin(c)
    kern.step(c, we)
    kern.step.end()
    if tcp_window_mismatch(b, c):
        raise AssertionError(f"{tag} the lane without the kept heap "
                             f"minimum differs: "
                             f"{tcp_window_mismatch(b, c)}")
    kern.step.table.params["th_cache"] = 1
    del c
    slowest = None
    if profile:
        prof, layout, pgot, conn_off = tcp_window_profile.profile_window(
            runner, base, we, against=b)
        slowest = tcp_window_profile.report(tag, prof, layout,
                                            conn_off)["slowest"][0]
        tcp_window_profile.report_scans(tag, pgot["scans"])
        del prof
    del b
    gc.collect()
    torch.cuda.empty_cache()
    reps = 10 if graph else 3
    ms = {}
    for cache in (1, 0):
        kern.step.table.params["th_cache"] = cache
        ms[cache] = tcp_window_ms(kern, base, we, reps, graph)
    kern.step.table.params["th_cache"] = 1
    call, ms_call = [], []
    for _ in range(5 if graph else 2):
        c = clone_state(base)
        kern.prepare(c)
        kern.step.begin(c)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kern.step(c, we)
        call.append(time.perf_counter() - t1)
        ms_call.append(kern.step.end()["window_ms"])
        del c
    nbytes = need["total"]
    shape = tcp_window_profile.launch_shape(kern.step.table.lib, runner._H)
    props = kernel_props(tw.LIBRARY, ("tcp_window_kernel", "team_serve"))
    row = {"ms": float(np.median(ms[1])), "ms_min": min(ms[1]),
           "ms_max": max(ms[1]), "ms_uncached": float(np.median(ms[0])),
           "call_ms": float(np.median(call)) * 1e3,
           "launch_to_end_ms": float(np.median(ms_call)),
           "plain_ms": plain_ms, "bound_ms": nbytes / BANDWIDTH * 1e3,
           "bytes": nbytes, "bound_parts": need, "max_abs_err": 0,
           "iters": it, "H": runner._H, "lanes": got["lanes"].tolist(),
           "fires": got["fires"].tolist(), "calls": got["calls"].tolist(),
           "launch": shape, "ptxas": props, "slowest_lane": slowest}
    how = ("CUDA graph of 10, fresh state each; median of 3 replays" if graph
           else "single launches on a restored copy; median of 3")
    print(f"{tag} stt_tcp_window exact against the eager window: {it} "
          f"micro-iterations; fires {row['fires']}, lanes {row['lanes']}, "
          f"law calls in the lanes {row['calls']}; outbox {n_out}, trace "
          f"{n_tr}; {row['ms'] * 1e3:.3f} us per window on the card ({how},"
          f" {row['ms_min'] * 1e3:.3f}-{row['ms_max'] * 1e3:.3f}); without "
          f"the kept heap minimum {row['ms_uncached'] * 1e3:.3f} us; "
          f"{row['call_ms'] * 1e3:.1f} us host per wrapper call (launch to "
          f"end {row['launch_to_end_ms'] * 1e3:.1f} us); plain window "
          f"{plain_ms:.3f} ms; bound {row['bound_ms'] * 1e3:.3f} us by bytes "
          f"({nbytes} B: "
          + ", ".join(f"{k} {v}" for k, v in need.items() if k != "total")
          + f"); launch: {shape['team']} threads a lane, {shape['tiles']} "
          f"lanes a block, {shape['blocks']} blocks, {shape['smem']} B "
          f"shared a block; {frame_text(shape)}; ptxas {props}",
          flush=True)
    runner.window_factory = None
    return row


def check_tcp_span(name: str, runner, base: dict, args: tuple,
                   plain4: str = "eager", reps: int = 5) -> dict:
    """Phase 2's TCP span leg on one export: stt_tcp_span against its
    plain version (the runner's eager loop: a window, then the eager
    round end) on copies of the same state, spans of one and of four
    rounds: every state column (conn-major ones without their trash
    row), the outbox and the trace in canonical order, ks_fires,
    ks_lanes, the run's scalars (start, runahead, rounds, busy rounds,
    packets, busy end, micro-iterations) and the abort bits and site
    exactly equal.  The plain loop's windows are the eager window's,
    except for the four-round span with `plain4` "kernel", whose windows
    are stt_tcp_window's (itself held exact against the eager window on
    the same export by check_tcp_window; at 10,000 hosts an eager window
    takes ~18 s).  Times: the span kernel per one- and four-round span
    and per round (single launches on fresh copies, the card asleep while
    the host issues each: a cooperative launch is not captured in a CUDA
    graph), its host issue per launch, its launch to end, the plain
    loop's time (host wall of its calls), the bound from the bytes the
    span must move (ops/tcp_span_kernel.py tcp_span_need_bytes: each
    window's reads, each round end's packets and moved entries, the
    span's changed words once), the phase clocks and the launch's shape.
    Returns the kernels line's row: the one-round span's card time,
    plain loop and bound (the plain loop there is the eager window's on
    every export), and the four-round span's beside them."""
    from shadow_tpu_torch.ops import tcp_span_kernel as tsk
    from shadow_tpu_torch.ops import tcp_window as tw
    from shadow_tpu_torch.tools.relay_cases import clone_state
    from shadow_tpu_torch.tools.window_cases import tcp_window_mismatch
    tag = f"[tcp span {name}]"
    start, stop, limit, runahead = args

    def build(factory):
        runner.window_factory = factory
        return runner._build()

    span = build(None)
    assert span.span is not None and span.step is None
    rows = {}
    for mr in (1, 4):
        plain = build(tw.TCP_WINDOW.bind if mr == 4 and plain4 == "kernel"
                      else tw.eager_window)
        assert plain.span is None
        b = clone_state(base)
        got = span(b, *args, mr)
        a = clone_state(base)
        need = tsk.tcp_span_need_bytes(plain, span.span.table.ops, a,
                                       *args, mr)
        bad = tcp_window_mismatch(a, b) + [
            k for k in ("ks_fires", "ks_lanes")
            if not np.array_equal(a[k], b[k])]
        if bad or tuple(got[1:]) != need["run"] or need["rounds"] != mr \
                or int(a["abort_code"]) or int(b["abort_code"]) \
                or b["ks_windows"] != mr or b["ks_spans"] != 1:
            raise AssertionError(f"{tag} {mr} rounds: {bad} differ, "
                                 f"scalars {need['run']} (plain) vs "
                                 f"{tuple(got[1:])}, abort "
                                 f"{int(a['abort_code'])} / "
                                 f"{int(b['abort_code'])}")
        rows[mr] = dict(need, trace=int(b["tr_n"]),
                        dropped=int((b["pkts_dropped"]
                                     - base["pkts_dropped"]).sum()),
                        plain_window=("stt_tcp_window" if mr == 4
                                      and plain4 == "kernel"
                                      else "eager"))
        del a, b, got
        gc.collect()
        torch.cuda.empty_cache()
    print(f"{tag} export at {start / 1e9:.4f}s ({runner._H} lanes, "
          f"{runner._n_conns} conns, window {runahead / 1e6:.3f} ms): "
          f"stt_tcp_span exact against the plain loop over 1 and 4 rounds "
          f"(4 rounds: {rows[4]['run'][4]} packets, {rows[4]['dropped']} "
          f"drops, trace {rows[4]['trace']}, {rows[4]['run'][6]} "
          f"micro-iterations; plain windows {rows[4]['plain_window']})",
          flush=True)
    card1, _ = span_card_ms(span, base, args + (1,), reps)
    card, issue = span_card_ms(span, base, args + (4,), reps)
    c = clone_state(base)
    span.prepare(c)
    got = span.span(c, *args, 4)
    del c
    shape = tsk.launch_shape(span.span.table.lib, runner._H)
    props = kernel_props(tsk.LIBRARY, ("tcp_span_kernel", "tile_windows",
                                       "tile_settle", "team_serve"))
    need = rows[4]
    clk = got["clocks"]
    row = {"ms": float(np.median(card1)),
           "plain_ms": rows[1]["loop_s"] * 1e3,
           "bound_ms": rows[1]["total"] / BANDWIDTH * 1e3,
           "bytes": rows[1]["total"],
           "ms_4_rounds": float(np.median(card)), "ms_min": min(card),
           "ms_max": max(card), "rounds": 4,
           "ms_per_round": float(np.median(card)) / 4,
           "call_ms": float(np.median(issue)),
           "launch_to_end_ms": got["span_ms"],
           "plain_4_rounds_ms": need["loop_s"] * 1e3,
           "plain_4_rounds_window": need["plain_window"],
           "bound_4_rounds_ms": need["total"] / BANDWIDTH * 1e3,
           "bytes_4_rounds": need["total"],
           "bound_parts": {k: need[k] for k in ("window", "round_end",
                                                 "state")},
           "max_abs_err": 0, "H": runner._H, "clocks": clk,
           "launch": shape, "ptxas": props}
    share = {k: clk[k] / max(clk["span"], 1)
             for k in ("window", "propagate", "settle", "wait")}
    print(f"{tag} {row['ms_4_rounds'] * 1e3:.3f} us per 4-round span on "
          f"the card ({row['ms_per_round'] * 1e3:.3f} us a round; median of "
          f"{reps} launches on fresh copies, {row['ms_min'] * 1e3:.3f}-"
          f"{row['ms_max'] * 1e3:.3f}; a 1-round span "
          f"{row['ms'] * 1e3:.3f} us), host issue "
          f"{row['call_ms'] * 1e3:.1f} us per launch, launch to end "
          f"{got['span_ms'] * 1e3:.1f} us; plain loop "
          f"{row['plain_4_rounds_ms']:.3f} ms over 4 rounds (windows "
          f"{row['plain_4_rounds_window']}), {row['plain_ms']:.3f} ms over "
          f"1 (eager); bound {row['bound_4_rounds_ms'] * 1e3:.3f} us by "
          f"bytes over 4 rounds ({need['total']} B: window reads "
          f"{need['window']}, round ends {need['round_end']}, changed words "
          f"{need['state']}), {row['bound_ms'] * 1e3:.3f} us over 1; "
          f"launch: "
          f"{shape['team']} threads a lane, {shape['tiles']} lanes a "
          f"block, {shape['blocks']} blocks, {shape['smem']} B shared a "
          f"block; {frame_text(shape)}; ptxas {props}; phase clocks "
          f"(cycles: each phase to its barrier's exit,"
          f" wait the part inside the barriers) {clk}, shares of the span "
          + ", ".join(f"{k} {v:.3f}" for k, v in share.items()),
          flush=True)
    runner.window_factory = None
    return row


def stream_results(run: dict) -> dict:
    """What a stream run must agree on: its trace's digest (16 hex
    digits) and lines, its packets and its events."""
    s = run["summary"]
    return {"digest": run["digest"][:16], "lines": run["lines"],
            "packets_sent": s.packets_sent,
            "packets_dropped": s.packets_dropped, "events": s.events}


def print_residency(tag, r) -> None:
    """The runner's residency and speculative-overlap counters."""
    print(f"{tag} residency: resident hits {r.resident_hits}, stale drops "
          f"{r.stale_drops}; clones {r.clone_bytes / 2**30:.3f} GiB in "
          f"{r.clone_ms:.3f} ms; overlap {json.dumps(r.overlap_summary())}",
          flush=True)


def print_stages(tag, r) -> None:
    """The runner's per-stage counters over its committed spans: fires,
    lanes, lanes per fire, and host wall from each guard's sync to the
    end of the stage's issue (so the kernels' device time hides in the
    next sync).  Through the PHOLD kernels the stages have no host wall
    of their own: the windows' or the spans' launch-to-end time stands
    for them."""
    from shadow_tpu_torch.ops.tcp_span import KS_NAMES
    windows = getattr(r, "ks_windows", 0)
    spans = getattr(r, "ks_spans", 0)
    if not r.ks_wall_s.sum() and not windows:
        return
    print(f"{tag} stages over {r.micro_iters} micro-iterations "
          f"(name: fires, lanes, lanes/fire, host s, ms/fire):", flush=True)
    for code, name in enumerate(KS_NAMES):
        f, n, w = int(r.ks_fires[code]), int(r.ks_lanes[code]), \
            float(r.ks_wall_s[code])
        if f:
            print(f"{tag}   {name}: {f}, {n}, {n / f:.1f}, {w:.3f}, "
                  f"{w / f * 1e3:.3f}", flush=True)
    if spans:
        print(f"{tag} span kernel launch-to-end {r.ks_span_ms / 1e3:.3f}s"
              f" over {spans} spans ({windows} rounds) of "
              f"{r.device_ms / 1e3:.3f}s loop", flush=True)
    elif windows:
        print(f"{tag} window kernel launch-to-end {r.ks_window_ms / 1e3:.3f}s"
              f" over {windows} windows of {r.device_ms / 1e3:.3f}s loop",
              flush=True)
    else:
        print(f"{tag} stage host wall total {r.ks_wall_s.sum():.3f}s of "
              f"{r.device_ms / 1e3:.3f}s loop", flush=True)


def parse_yaml(text: str) -> dict:
    """A generated config parsed once (with PyYAML's C loader where it
    has one); each run builds its ConfigOptions from a copy."""
    import yaml
    return yaml.load(text, Loader=getattr(yaml, "CSafeLoader",
                                          yaml.SafeLoader))


def config_with(base: dict, **experimental):
    import copy

    from shadow_tpu_torch.core.config import ConfigOptions
    d = copy.deepcopy(base)
    d["experimental"].update(experimental)
    return ConfigOptions.from_dict(d)


def phold_cells() -> dict:
    """Phase 4's cells: name -> (config for a `tpu_device_spans` value,
    least device-round share, what the CoDel gate requires).  Every
    per-round round runs on the C++ twin (HOST_ONLY), so the spans
    alone are measured, as before the per-round kernel."""
    from shadow_tpu_torch.core.config import ConfigOptions
    from shadow_tpu_torch.ops.propagate import HOST_ONLY
    from shadow_tpu_torch.tools.netgen import mesh_family_yaml, phold_yaml

    # the reference ladder's 8k rung (bench.py phold_rung)
    phold_8k_base = parse_yaml(phold_yaml(
        H_PHOLD, n_init=1, mean_delay_ns=50_000_000, stop_time="0.3s",
        seed=13, scheduler="tpu", peers_per_host=64))

    def phold_8k(spans):
        return config_with(phold_8k_base, tpu_device_spans=spans,
                           tpu_min_device_batch=HOST_ONLY)

    def mesh_24(spans):
        # the reference's bench[mesh-dev] shape (mesh_cfg(n=24)) at its
        # own 30 s, nothing cut
        cfg = ConfigOptions.from_yaml_text(mesh_family_yaml(
            24, scheduler="tpu", device_spans=spans, stop_time="30s"))
        cfg.experimental.tpu_min_device_batch = HOST_ONLY
        return cfg

    def mesh_codel_10(spans):
        # tests/test_phold_span.py's CoDel-active mesh: fast up, slow
        # down, sustained overload
        names = [f"m{i:02d}" for i in range(10)]
        hosts = {}
        for name in names:
            peers = " ".join(p for p in names if p != name)
            hosts[name] = {"network_node_id": 0, "processes": [{
                "path": "udp-mesh", "args": f"9000 60 900 {peers}",
                "start_time": "100ms", "expected_final_state": "any"}]}
        return ConfigOptions.from_dict({
            "general": {"stop_time": "60s", "seed": 41},
            "network": {"graph": {"type": "gml", "inline": (
                'graph [ node [ id 0 host_bandwidth_down "400 Kbit" '
                'host_bandwidth_up "10 Mbit" ] edge [ source 0 target 0 '
                'latency "10 ms" ] ]')}},
            "experimental": {"scheduler": "tpu",
                             "socket_send_buffer": "64 KiB",
                             "tpu_device_spans": spans,
                             "tpu_min_device_batch": HOST_ONLY},
            "hosts": hosts})

    return {"phold-8k": (phold_8k, 0.5, None),
            "mesh-24": (mesh_24, 0.5, None),
            "mesh-codel-10": (mesh_codel_10, 0.5, "drops")}


def check_window_launches(tag: str, r, launches: dict, path: str,
                          host_reads: int = 0):
    """A forced PHOLD-family run's launch gates, by the run's path.
    "span" (the main path): one stt_phold_span launch per dispatch
    (aborted and refused ones too), each span's words read once, the
    committed spans' rounds all stepped inside the kernel, and no window
    or standalone law kernel.  "window": one stt_phold_window launch per
    window stepped in every dispatch, one per round in the committed
    spans, and no span or law kernel.  "plain" (the eager window): each
    law kernel launched exactly once per call the runner made, and no
    window or span kernel.  Never a TCP kernel."""
    for kname in ("relay1_law", "relay2_law", "tcp_window"):
        if launches[kname]:
            raise AssertionError(f"{tag} the PHOLD loop launched {kname} "
                                 f"{launches[kname]} times")
    others = {"span": ("phold_window", "bucket_step", "codel_head"),
              "window": ("phold_span", "bucket_step", "codel_head"),
              "plain": ("phold_span", "phold_window")}[path]
    for kname in others:
        if launches[kname]:
            raise AssertionError(f"{tag} {kname} launched "
                                 f"{launches[kname]} times on the {path} "
                                 f"path")
    if path == "span":
        n = launches["phold_span"]
        if n <= 0 or n != r.spans_all or host_reads != n \
                or r.ks_spans != r.spans or r.ks_windows != r.rounds:
            raise AssertionError(
                f"{tag} phold_span launched {n} times ({host_reads} host "
                f"reads) for {r.spans_all} dispatches ({r.ks_spans} "
                f"committed of {r.spans} spans; {r.ks_windows} rounds "
                f"inside of {r.rounds})")
        return
    if path == "window":
        n = launches["phold_window"]
        if n <= 0 or n != r.windows_all or r.ks_windows != r.rounds:
            raise AssertionError(f"{tag} phold_window launched {n} times "
                                 f"for {r.windows_all} windows "
                                 f"({r.ks_windows} committed, {r.rounds} "
                                 f"rounds)")
        return
    from shadow_tpu_torch.ops import phold_span as ps
    fires = r.ks_fires
    for i, (kname, most) in enumerate((
            ("bucket_step", fires[ps.KS_INET_OUT] + fires[ps.KS_CODEL]),
            ("codel_head", fires[ps.KS_CODEL]))):
        n = launches[kname]
        if n <= 0 or n != r.calls_all[i] or r.ks_calls[i] > most \
                or (r.rolled_back_rounds == 0 and r.overlap_refusals == 0
                    and n != r.ks_calls[i]):
            raise AssertionError(
                f"{tag} {kname} launched {n} times for {r.calls_all[i]} "
                f"calls ({r.ks_calls[i]} committed), stage fires {most}")


def print_run(tag, r) -> None:
    """A forced PHOLD-family run's loop: dispatches, micro-iterations,
    the loop's wall (CUDA events around each dispatch) and, through the
    span kernel, the spans' launch-to-end time (CUDA events just before
    each launch call and after it: card time plus the launch's host
    issue) and the rest (the span's set-up and its one read); through
    the window kernel, the windows' launch-to-end time and the rest
    (round ends and the span's set-up); the codec's bytes and walls, law
    calls."""
    per = r.device_ms / max(r.micro_iters, 1)
    kern = ""
    if r.ks_spans:
        kern = (f"; span kernel {r.ks_spans} launches ({r.spans_all} over "
                f"every dispatch) stepping {r.ks_windows} rounds, "
                f"{r.ks_span_ms / 1e3:.3f}s launch to end "
                f"({r.ks_span_ms / r.ks_spans * 1e3:.1f} us a span, "
                f"{r.ks_span_ms / max(r.ks_windows, 1) * 1e3:.1f} us a "
                f"round), set-up and read "
                f"{(r.device_ms - r.ks_span_ms) / 1e3:.3f}s")
    elif r.ks_windows:
        kern = (f"; window kernel {r.ks_windows} launches, "
                f"{r.ks_window_ms / 1e3:.3f}s launch to end "
                f"({r.ks_window_ms / r.ks_windows * 1e3:.1f} us each), "
                f"round ends and set-up "
                f"{(r.device_ms - r.ks_window_ms) / 1e3:.3f}s")
    print(f"{tag} device spans {r.spans}, micro-iterations "
          f"{r.micro_iters} ({r.micro_iters / max(r.rounds, 1):.2f} per "
          f"round, {per:.3f} ms each in the loop), loop "
          f"{r.device_ms / 1e3:.3f}s (CUDA events) of span wall "
          f"{r.device_wall_ns / 1e9:.3f}s{kern}, aborts {r.aborts} "
          f"{r.abort_kind_counts()}, over caps {r.over_caps}; export "
          f"{r.export_bytes / 2**20:.1f} MiB in "
          f"{r.export_wall_ns / 1e9:.3f}s, import "
          f"{r.import_bytes / 2**20:.1f} MiB in "
          f"{r.import_wall_ns / 1e9:.3f}s (engine call + codec); law "
          f"calls {r.calls_all.tolist()} (committed "
          f"{r.ks_calls.tolist()}), windows {r.windows_all}", flush=True)


def phold_pair(name: str, make, min_share: float, codel,
               side_runs: bool = False) -> dict:
    """One PHOLD/udp-mesh cell through the port's Manager on the card:
    spans off, forced (every span one stt_phold_span launch) and, with
    `side_runs`, forced through the window kernel ("window": one
    stt_phold_window launch a round, eager round ends) and through the
    plain window ("plain": the law kernels launched per relay pass).  Requires one trace in every run, equal to
    the cell's digest from before the window kernel (DIGESTS), equal
    counters, device spans with no abort, `min_share` of the rounds on
    the card, family 1 with drops for the meshes (every CoDel drop where
    `codel`), no kernel in the C++ run and each forced run's launch gates
    (check_window_launches).  Returns each run's launches of every
    kernel, by path."""
    import hashlib

    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.ops.phold_window import PHOLD_WINDOW, eager_window

    tag = f"[{name}]"
    wrappers = kernel_wrappers()
    runs = {}
    factories = {"window": PHOLD_WINDOW.bind, "plain": eager_window}
    for run_name in ("off", "force") + (("window", "plain") if side_runs
                                        else ()):
        spans = "off" if run_name == "off" else "force"
        t0 = time.perf_counter()
        mgr = Manager(make(spans), device="cuda")
        if run_name in factories:
            mgr._dev_span = mgr.make_dev_span_runner()
            mgr._dev_span.window_factory = factories[run_name]
        build_s = time.perf_counter() - t0
        # Counts cover this run only: zeroed just before it.
        zero_counts(wrappers)
        # Earlier runs' span state (held in reference cycles) freed first.
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = mgr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        host_reads = wrappers["phold_span"].host_reads
        lines = mgr.trace_lines()
        digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()
        r = mgr._dev_span
        codel_drops = sum(1 for ln in lines if ln.endswith("codel"))
        cut, want = PREFIX_DIGESTS.get(name, (0, ""))
        prefix = hashlib.sha256("\n".join(
            ln for ln in lines if int(ln.split(" ", 1)[0]) < cut
        ).encode()).hexdigest()
        runs[run_name] = dict(summary=summary, r=r, launches=launches,
                              host_reads=host_reads, digest=digest,
                              prefix=prefix, codel=codel_drops,
                              tcp=mgr._dev_span_tcp, wall=wall)
        print(f"{tag} {run_name}: {len(mgr.hosts)} hosts, rounds "
              f"{summary.rounds} (device {r.rounds if r else 0}), events "
              f"{summary.events}, packets {summary.packets_sent} sent / "
              f"{summary.packets_dropped} dropped ({codel_drops} by "
              f"CoDel), trace lines {len(lines)} sha256 {digest[:16]}, "
              f"Manager build {build_s:.1f}s, run wall {wall:.2f}s, "
              f"{summary.end_time_ns / 1e9 / wall:.4f} sim-s/wall-s, peak "
              f"device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              f"launches {launches}", flush=True)
        if r is not None and r.spans:
            print_run(f"{tag} {run_name}:", r)
            print_residency(tag, r)
            print_stages(tag, r)
        if not summary.ok:
            raise AssertionError(f"{tag} plugin errors: "
                                 f"{summary.plugin_errors[:3]}")
    off = runs["off"]
    so = off["summary"]
    if not off["digest"].startswith(DIGESTS[name]):
        raise AssertionError(f"{tag} the C++ run's trace is not "
                             f"{DIGESTS[name]}...")
    if name in PREFIX_DIGESTS and not off["prefix"].startswith(
            PREFIX_DIGESTS[name][1]):
        raise AssertionError(f"{tag} the C++ run's trace before "
                             f"{PREFIX_DIGESTS[name][0] / 1e9:g}s is not "
                             f"{PREFIX_DIGESTS[name][1]}...")
    if any(off["launches"].values()):
        raise AssertionError(f"{tag} the C++ run launched {off['launches']}")
    for run_name, run in runs.items():
        if run_name == "off":
            continue
        sd, r = run["summary"], run["r"]
        rtag = f"{tag} {run_name}:"
        if run["digest"] != off["digest"]:
            raise AssertionError(f"{rtag} trace sha256 differs from the C++ "
                                 f"run's")
        counters = [(s.events, s.packets_sent, s.packets_recv,
                     s.packets_dropped, s.syscalls) for s in (so, sd)]
        if counters[0] != counters[1]:
            raise AssertionError(f"{rtag} counters differ: {counters}")
        if r is None or r.spans == 0 or r.aborts:
            raise AssertionError(f"{rtag} device spans {r and r.spans}, "
                                 f"aborts {r and r.aborts}")
        if run["tcp"] is not None and run["tcp"].spans:
            raise AssertionError(f"{rtag} the TCP runner served a span")
        if r.rounds < min_share * sd.rounds:
            raise AssertionError(f"{rtag} only {r.rounds}/{sd.rounds} "
                                 f"rounds on the device "
                                 f"(< {min_share:.0%})")
        if r.resident_hits < r.spans - 1 - r.stale_drops:
            raise AssertionError(f"{rtag} {r.resident_hits} resident hits "
                                 f"over {r.spans} spans ({r.stale_drops} "
                                 f"stale)")
        if name.startswith("mesh") and (r.family != 1
                                        or sd.packets_dropped == 0):
            raise AssertionError(f"{rtag} family {r.family}, drops "
                                 f"{sd.packets_dropped}")
        if codel and run["codel"] != MESH_CODEL_DROPS:
            raise AssertionError(f"{rtag} {run['codel']} CoDel drops, not "
                                 f"{MESH_CODEL_DROPS}")
        check_window_launches(rtag, r, run["launches"],
                              "span" if run_name == "force" else run_name,
                              run["host_reads"])
    print(f"{tag} PASS: one trace ({off['digest'][:16]}"
          + (f"; before {PREFIX_DIGESTS[name][0] / 1e9:g}s "
             f"{off['prefix'][:16]}" if name in PREFIX_DIGESTS else "")
          + f") in "
          f"{len(runs)} runs, {runs['force']['r'].rounds}/"
          f"{runs['force']['summary'].rounds} rounds on the card, one "
          f"span-kernel launch per dispatch "
          f"({runs['force']['launches']['phold_span']}); walls "
          + ", ".join(f"{k} {v['wall']:.2f}s" for k, v in runs.items()),
          flush=True)
    return {name if k == "force" else f"{name}/{k}": v["launches"]
            for k, v in runs.items() if k != "off"}


class EpochWatch:
    """Engine proxy that notes each call moving the engine's state_epoch
    since the last span import: what a stale resident carry is named
    by."""

    def __init__(self, eng):
        self._eng = eng
        self.moved = []

    def __getattr__(self, name):
        fn = getattr(self._eng, name)
        if not callable(fn) or name == "state_epoch":
            return fn

        def call(*a, **k):
            e0 = self._eng.state_epoch()
            out = fn(*a, **k)
            if name.startswith("span_import"):
                self.moved = []
            elif self._eng.state_epoch() != e0:
                self.moved.append(name)
            return out
        return call


def ring_runs() -> dict:
    """Phase 5: phold-64k-ring (ring_config) three times: spans off,
    forced with `span_overlap: off` (residency alone, through the plain
    window: the law kernels launched per relay pass) and forced with
    `auto` (the overlap, every span one stt_phold_span launch, the
    speculative ones on the worker's stream).  Returns each run's
    launches of every kernel, by path."""
    import hashlib

    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.ops.phold_window import eager_window

    tag = "[phold-64k-ring]"
    wrappers = kernel_wrappers()
    runs = {}
    for name, spans, overlap in (("off", "off", "off"),
                                 ("residency", "force", "off"),
                                 ("overlap", "force", "auto")):
        t0 = time.perf_counter()
        mgr = Manager(ring_config(spans, overlap), device="cuda")
        watch = mgr.plane.engine = EpochWatch(mgr.plane.engine)
        r = None
        exports, stale_by = [], []
        if spans == "force":
            r = mgr._dev_span = mgr.make_dev_span_runner()
            for k, v in RING_CAPS.items():
                setattr(r, k, v)
            if name != "overlap":
                r.window_factory = eager_window
            export_state, try_span = r.export_state, r.try_span

            def counted_export(r=r, export_state=export_state,
                               exports=exports):
                b0 = r.export_bytes
                st = export_state()
                exports.append(r.export_bytes - b0)
                return st

            def named_try(*a, r=r, try_span=try_span, stale_by=stale_by,
                          **k):
                moved, stale0 = list(watch.moved), r.stale_drops
                res = try_span(*a, **k)
                if r.stale_drops > stale0:
                    stale_by.append(moved or ["(not seen)"])
                return res
            r.export_state, r.try_span = counted_export, named_try
        build_s = time.perf_counter() - t0
        # Counts cover this run only: zeroed just before it.
        zero_counts(wrappers)
        # Earlier runs' span state (held in reference cycles) freed first.
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = mgr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        host_reads = wrappers["phold_span"].host_reads
        lines = mgr.trace_lines()
        digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[name] = dict(summary=summary, r=r, launches=launches,
                          host_reads=host_reads, digest=digest,
                          exports=exports, stale_by=stale_by, wall=wall)
        print(f"{tag} {name}: spans={spans} span_overlap={overlap} "
              f"(resolved {mgr._span_overlap_on()}): rounds "
              f"{summary.rounds} (device {r.rounds if r else 0}), events "
              f"{summary.events}, packets {summary.packets_sent} sent, "
              f"trace lines {len(lines)} sha256 {digest[:16]}, Manager "
              f"build {build_s:.1f}s, run wall {wall:.2f}s, "
              f"{summary.end_time_ns / 1e9 / wall:.4f} sim-s/wall-s, peak "
              f"device memory {peak:.3f} GiB, launches {launches}",
              flush=True)
        if r is not None:
            print_run(f"{tag} {name}:", r)
            print(f"{tag} {name}: exports {len(exports)} (per export "
                  f"{[round(b / 2**20, 1) for b in exports]} MiB); stale "
                  f"drops named by {stale_by}", flush=True)
            print_residency(f"{tag} {name}:", r)
            print_stages(f"{tag} {name}:", r)
        if not summary.ok:
            raise AssertionError(f"{tag} plugin errors: "
                                 f"{summary.plugin_errors[:3]}")
    off = runs["off"]
    so = off["summary"]
    if any(off["launches"].values()):
        raise AssertionError(f"{tag} the C++ run launched {off['launches']}")
    if not off["digest"].startswith(DIGESTS["phold-64k-ring"]):
        raise AssertionError(f"{tag} the C++ run's trace is not "
                             f"{DIGESTS['phold-64k-ring']}...")
    for name in ("residency", "overlap"):
        run = runs[name]
        sd, r = run["summary"], run["r"]
        if run["digest"] != off["digest"]:
            raise AssertionError(f"{tag} {name}: trace sha256 differs from "
                                 f"the C++ run's")
        counters = [(s.events, s.packets_sent, s.packets_recv,
                     s.packets_dropped, s.syscalls) for s in (so, sd)]
        if counters[0] != counters[1]:
            raise AssertionError(f"{tag} {name}: counters differ: "
                                 f"{counters}")
        if r.spans == 0 or r.aborts:
            raise AssertionError(f"{tag} {name}: device spans {r.spans}, "
                                 f"aborts {r.aborts}")
        if r.rounds < 0.5 * sd.rounds:
            raise AssertionError(f"{tag} {name}: only {r.rounds}/"
                                 f"{sd.rounds} rounds on the device")
        if r.resident_hits < r.spans - 1 - r.stale_drops:
            raise AssertionError(f"{tag} {name}: {r.resident_hits} resident "
                                 f"hits over {r.spans} spans, "
                                 f"{r.stale_drops} stale drops")
        if not run["exports"] \
                or r.export_bytes >= 1.5 * max(run["exports"]):
            raise AssertionError(f"{tag} {name}: exports {run['exports']}")
        check_window_launches(f"{tag} {name}:", r, run["launches"],
                              "span" if name == "overlap" else "plain",
                              run["host_reads"])
    ro, rr = runs["overlap"]["r"], runs["residency"]["r"]
    if ro.overlap_windows < 1 or ro.overlap_hits < 1:
        raise AssertionError(f"{tag} overlap: {ro.overlap_summary()}")
    if rr.overlap_windows:
        raise AssertionError(f"{tag} residency: {rr.overlap_windows} "
                             f"speculative windows with span_overlap off")
    print(f"{tag} PASS: identical traces in all three runs, "
          f"{rr.rounds}/{runs['residency']['summary'].rounds} rounds on "
          f"the card, resident hits {rr.resident_hits} / "
          f"{ro.resident_hits} over {rr.spans} / {ro.spans} spans, overlap "
          f"windows {ro.overlap_windows} (hits {ro.overlap_hits}); run "
          f"walls off {off['wall']:.2f}s, residency "
          f"{runs['residency']['wall']:.2f}s, overlap "
          f"{runs['overlap']['wall']:.2f}s", flush=True)
    return {f"phold-64k-ring/{name}": run["launches"]
            for name, run in runs.items()}


def start_cli_overlap():
    """`python -m shadow_tpu_torch` on the card with `span_overlap: on`,
    started in a child process (phase 5's ring runs go on meanwhile): a
    512-LP PHOLD ring (the rung's generator) with forced device spans.
    finish_cli_overlap requires it to exit 0 with a speculative window
    landed."""
    import os
    import tempfile

    from shadow_tpu_torch.tools.netgen import phold_yaml
    text = phold_yaml(512, n_init=1, mean_delay_ns=20_000_000,
                      stop_time="0.3s", seed=13, scheduler="tpu",
                      device_spans="force", peers_per_host=16).replace(
        "experimental:\n", "experimental:\n  span_overlap: on\n")
    root = os.path.dirname(os.path.abspath(__file__))
    d = tempfile.mkdtemp()
    path = os.path.join(d, "phold-512.yaml")
    with open(path, "w") as f:
        f.write(text)
    err = open(os.path.join(d, "stderr"), "w+")
    proc = subprocess.Popen([sys.executable, "-m", "shadow_tpu_torch", path,
                             "--data-directory", os.path.join(d, "data")],
                            cwd=root, stdout=subprocess.DEVNULL, stderr=err)
    return proc, err, d, time.perf_counter()


def finish_cli_overlap(child, kill: bool = False) -> None:
    """Wait for start_cli_overlap's child (kill it first when `kill`)
    and check it."""
    import shutil
    proc, err, d, t0 = child
    try:
        if kill:
            proc.kill()
        proc.wait(timeout=600)
        err.seek(0)
        stderr = err.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
        shutil.rmtree(d, ignore_errors=True)
    if kill:
        return
    tag = "[cli]"
    line = [ln for ln in stderr.splitlines()
            if ln.startswith("[shadow-tpu-torch] dispatch: ")]
    if proc.returncode != 0 or not line:
        raise AssertionError(f"{tag} exit {proc.returncode}: "
                             f"{stderr[-2000:]}")
    d = json.loads(line[-1].split(": ", 1)[1])
    ov = d["device_span_phold"]["overlap"]
    print(f"{tag} python -m shadow_tpu_torch (512 LPs, span_overlap: on) "
          f"in {time.perf_counter() - t0:.1f}s (beside phase 5's ring "
          f"runs): {json.dumps(d)}", flush=True)
    if not d["span_overlap_on"] or ov["windows"] < 1 or ov["hits"] < 1:
        raise AssertionError(f"{tag} no speculative window landed: {d}")


def trace_digest(mgr) -> tuple[str, int, int]:
    """sha256 of the trace lines (joined by newlines), their count and
    the inet-loss drops among them."""
    import hashlib
    h = hashlib.sha256()
    n = losses = 0
    for ln in mgr.trace_lines():
        h.update(ln.encode() if not n else b"\n" + ln.encode())
        n += 1
        losses += "inet-loss" in ln
    return h.hexdigest(), n, losses


def propagate_run(tag: str, name: str, cfg) -> dict:
    """One run of a per-round propagation cell through the port's
    Manager on the card, every kernel's launch counters zeroed just
    before it.  Prints the run, the route split in bench.py's words, the
    packets per round and each device-route phase's wall per dispatch."""
    from shadow_tpu_torch.core.manager import Manager
    t0 = time.perf_counter()
    mgr = Manager(cfg, device="cuda")
    build_s = time.perf_counter() - t0
    wrappers = kernel_wrappers()
    zero_counts(wrappers)
    wrappers["propagate"].probe_launches = 0
    gc.collect()
    t0 = time.perf_counter()
    summary = mgr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    probe_launches = wrappers["propagate"].probe_launches
    digest, nlines, losses = trace_digest(mgr)
    block = mgr.dispatch_summary()["propagate"]
    dev_span_rounds = sum(r.rounds for r in (mgr._dev_span,
                                             mgr._dev_span_tcp) if r)
    rd, tot_r = block["rounds_device"], block["rounds_dispatched"]
    pd, tot_p = block["packets_device"], block["packets_batched"]
    print(f"{tag} {name}: tpu_min_device_batch "
          f"{cfg.experimental.tpu_min_device_batch}: {len(mgr.hosts)} "
          f"hosts, rounds {summary.rounds} (span rounds "
          f"{summary.span_rounds}, of which device {dev_span_rounds}), "
          f"events {summary.events}, packets {summary.packets_sent} sent / "
          f"{summary.packets_recv} received / {summary.packets_dropped} "
          f"dropped ({losses} inet-loss), busy_end {summary.busy_end_ns}, "
          f"trace lines {nlines} sha256 {digest[:16]}, Manager build "
          f"{build_s:.1f}s, run wall {wall:.2f}s, "
          f"{summary.end_time_ns / 1e9 / wall:.4f} sim-s/wall-s", flush=True)
    print(f"{tag} {name}: dispatch split: {rd}/{tot_r} rounds on device, "
          f"{pd}/{tot_p} packets on device "
          f"({100.0 * pd / tot_p if tot_p else 0.0:.1f}%); probes "
          f"{block['probes_async']}; stt_propagate launches {launches['propagate']} "
          f"(probes {probe_launches}); packets per round "
          f"{block['packets_per_round']}; host route "
          f"{block['walls_ms']['host_route']:.1f} ms; device route per "
          f"dispatch (us): "
          f"{ {k: round(v, 2) for k, v in block['per_device_round_us'].items()} }",
          flush=True)
    if not summary.ok:
        raise AssertionError(f"{tag} {name}: plugin errors "
                             f"{summary.plugin_errors[:3]}")
    return dict(summary=summary, digest=digest, losses=losses, block=block,
                launches=launches, probe_launches=probe_launches,
                dev_span_rounds=dev_span_rounds, wall=wall,
                host_ns_per_pkt=mgr.propagator.route.host_ns_per_pkt)


# Set when the main thread fails, so a background phase's children are
# killed (cli_runs) and the script ends.
STOP = threading.Event()


class Background:
    """One phase on a thread beside the main thread's phases (it starts
    child processes and waits for them): `result()` joins it and returns
    its value or raises its exception."""

    def __init__(self, fn, *args):
        self._out: dict = {}
        self.t0 = time.perf_counter()

        def run():
            try:
                self._out["value"] = fn(*args)
            except BaseException as e:  # re-raised by result()
                self._out["error"] = e
            self._out["wall"] = time.perf_counter() - self.t0

        self._thread = threading.Thread(target=run)
        self._thread.start()

    def join(self) -> None:
        self._thread.join()

    def result(self):
        self.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]

    @property
    def wall(self) -> float:
        return self._out["wall"]


def kernel_wrappers() -> dict:
    from shadow_tpu_torch.ops import queues, tcp_span
    from shadow_tpu_torch.ops.phold_span_kernel import PHOLD_SPAN
    from shadow_tpu_torch.ops.phold_window import PHOLD_WINDOW
    from shadow_tpu_torch.ops.propagate import PROPAGATE
    from shadow_tpu_torch.ops.tcp_span_kernel import TCP_SPAN
    from shadow_tpu_torch.ops.tcp_window import TCP_WINDOW
    return {"bucket_step": queues.BUCKET_STEP,
            "codel_head": queues.CODEL_HEAD,
            "relay1_law": tcp_span.RELAY1_LAW,
            "relay2_law": tcp_span.RELAY2_LAW,
            "propagate": PROPAGATE,
            "phold_window": PHOLD_WINDOW,
            "phold_span": PHOLD_SPAN,
            "tcp_window": TCP_WINDOW,
            "tcp_span": TCP_SPAN}


def zero_counts(wrappers: dict) -> None:
    """Every wrapper's launch count, and the span kernels' host reads, to
    0 (just before a run)."""
    for w in wrappers.values():
        w.launches = 0
    for name in ("phold_span", "tcp_span"):
        wrappers[name].host_reads = 0


def check_forced(tag: str, run: dict) -> None:
    """Every round's propagation went through stt_propagate: launches =
    device rounds = dispatched rounds, no probe, no host measurement, no
    span of either kind, no other kernel."""
    b, n = run["block"], run["launches"]["propagate"]
    if not (b["rounds_device"] == b["rounds_dispatched"] == n > 0) \
            or run["probe_launches"] or b["probes_async"] \
            or run["host_ns_per_pkt"] is not None \
            or run["summary"].span_rounds \
            or any(v for k, v in run["launches"].items()
                   if k != "propagate"):
        raise AssertionError(f"{tag} forced: {b}, launches "
                             f"{run['launches']} (probes "
                             f"{run['probe_launches']}), span rounds "
                             f"{run['summary'].span_rounds}")


def same_results(tag: str, runs: dict) -> None:
    names = list(runs)
    first = runs[names[0]]
    for name in names[1:]:
        a, b = first["summary"], runs[name]["summary"]
        if runs[name]["digest"] != first["digest"]:
            raise AssertionError(f"{tag} trace sha256 differs between "
                                 f"{names[0]} and {name}")
        ca = (a.packets_sent, a.packets_recv, a.packets_dropped,
              a.busy_end_ns, a.events)
        cb = (b.packets_sent, b.packets_recv, b.packets_dropped,
              b.busy_end_ns, b.events)
        if ca != cb:
            raise AssertionError(f"{tag} {names[0]} vs {name}: {ca} != {cb}")


def tier10k_runs() -> dict:
    """Phase 6, tier10k: bench.py config_10k (BASELINE config 4, the
    reference's headline: 10,000 hosts, the 3-tier graph, seed 7) run
    host-only (every per-round round on the C++ twin), auto (the route
    model with async probes) and forced (every round through
    stt_propagate, no span)."""
    from shadow_tpu_torch.ops.propagate import HOST_ONLY
    from shadow_tpu_torch.tools.netgen import SIM_SECONDS_10K, tier10k_yaml
    tag = "[tier10k]"
    t0 = time.perf_counter()
    text = tier10k_yaml("tpu")
    base = parse_yaml(text)
    print(f"{tag} 10,000 hosts (500 relays, 9,500 clients x 3 x 25,000 B), "
          f"stop_time {SIM_SECONDS_10K}s; YAML {len(text) / 2**20:.1f} MiB parsed "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)
    runs = {name: propagate_run(tag, name, config_with(
                base, tpu_min_device_batch=mdb))
            for name, mdb in (("host-only", HOST_ONLY), ("auto", 2048),
                              ("forced", 0))}
    same_results(tag, runs)
    check_forced(tag, runs["forced"])
    auto, host = runs["auto"], runs["host-only"]
    b = auto["block"]
    if auto["launches"]["propagate"] != b["rounds_device"] \
            or auto["probe_launches"] != b["probes_async"]:
        raise AssertionError(f"{tag} auto: launches "
                             f"{auto['launches']['propagate']} + probes "
                             f"{auto['probe_launches']} vs rounds_device "
                             f"{b['rounds_device']} + probes_async "
                             f"{b['probes_async']}")
    if host["launches"]["propagate"] or host["probe_launches"] \
            or host["block"]["rounds_device"]:
        raise AssertionError(f"{tag} host-only: {host['block']}")
    for name, run in runs.items():
        us = run["block"]["per_device_round_us"]
        mid = sum(us[k] for k in ("upload", "launch", "kernel", "download"))
        print(f"{tag} {name}: device route per device round (us): "
              f"{json.dumps(us)}; upload + launch + kernel + download "
              f"{mid:.2f}", flush=True)
    print(f"{tag} PASS: one trace in all three runs; forced "
          f"{runs['forced']['block']['rounds_device']} rounds, each one "
          f"stt_propagate launch; auto {b['rounds_device']} device rounds "
          f"+ {b['probes_async']} probes = "
          f"{auto['launches']['propagate'] + auto['probe_launches']} "
          f"launches; walls host-only {host['wall']:.2f}s, auto "
          f"{auto['wall']:.2f}s, forced {runs['forced']['wall']:.2f}s",
          flush=True)
    return runs


def mesh100_runs() -> dict:
    """Phase 6, mesh-100: bench.py mesh_config (BASELINE config 2: 100
    hosts, udp-mesh 30 x 200 B to each of 99 peers, 10 ms, 1% loss,
    seed 3, 30 s), host-only and forced."""
    from shadow_tpu_torch.ops.propagate import HOST_ONLY
    from shadow_tpu_torch.tools.netgen import mesh100_yaml
    tag = "[mesh-100]"
    base = parse_yaml(mesh100_yaml("tpu"))
    runs = {name: propagate_run(tag, name, config_with(
                base, tpu_min_device_batch=mdb))
            for name, mdb in (("host-only", HOST_ONLY), ("forced", 0))}
    same_results(tag, runs)
    check_forced(tag, runs["forced"])
    if runs["forced"]["losses"] == 0:
        raise AssertionError(f"{tag} no inet-loss drop")
    print(f"{tag} PASS: identical traces, "
          f"{runs['forced']['losses']} inet-loss drops, forced "
          f"{runs['forced']['block']['rounds_device']} rounds each one "
          f"stt_propagate launch", flush=True)
    return runs


# Phase 7's cells: name -> (generated YAML, the general and experimental
# keys set on it).  Both schedulers read one file (`--scheduler`
# chooses), so the directories may differ only in the lines the
# determinism gate normalizes.
def data_dir_cells() -> dict:
    from shadow_tpu_torch.ops.propagate import HOST_ONLY
    from shadow_tpu_torch.tools.netgen import (phold_yaml, tcp_stream_yaml,
                                               tier1k_yaml)
    plane = {"native_dataplane": "on"}
    return {
        # bench.py config3 (1,000 hosts on phase 6's 3-tier graph), every
        # round through stt_propagate_round: tier10k's path at a tenth of
        # its files, which set a CLI run's wall there (PERF.md)
        "tier-1k": (tier1k_yaml("tpu"), {},
                    dict(plane, tpu_min_device_batch=0)),
        # phase 4's phold-8k, spans forced through stt_phold_span; a
        # heartbeat every 50 ms of its 0.3 s for the --progress run
        "phold-8k": (phold_yaml(H_PHOLD, n_init=1, mean_delay_ns=50_000_000,
                                stop_time="0.3s", seed=13, scheduler="tpu",
                                peers_per_host=64),
                     {"heartbeat_interval": "50 ms"},
                     dict(plane, tpu_device_spans="force",
                          tpu_min_device_batch=HOST_ONLY)),
        # phase 3's tcp-stream-16 to 500 ms through stt_tcp_span
        "tcp-stream-16": (tcp_stream_yaml(
            16, n_servers=2, nbytes=50_000_000, loss=0.005,
            latency="10 ms", bw_down="50 Mbit", bw_up="50 Mbit",
            stop_time="500ms", seed=11, scheduler="tpu"), {},
            dict(plane, tpu_device_spans="force",
                 tpu_min_device_batch=HOST_ONLY, dev_span_k_init=4)),
    }


def gate_files(dirpath: str, progress: bool = False) -> dict:
    """A data directory's files under tests/test_determinism.py's
    `collect` rules: sim-stats.json without `metrics.wall`, and
    processed-config.yaml's data_directory, scheduler and parallelism
    lines normalized (with `progress`, its progress line too: the one
    value `--progress` sets)."""
    import os
    out = {}
    for root, _dirs, files in os.walk(dirpath):
        for fn in files:
            path = os.path.join(root, fn)
            with open(path, "rb") as f:
                data = f.read()
            if fn == "sim-stats.json":
                stats = json.loads(data)
                stats.get("metrics", {}).pop("wall", None)
                data = json.dumps(stats, indent=2, sort_keys=True).encode()
            if fn == "processed-config.yaml":
                keys = ["data_directory", "scheduler", "parallelism"]
                for key in keys + (["progress"] if progress else []):
                    data = re.sub(key.encode() + rb": .*",
                                  key.encode() + b": <normalized>", data)
            out[os.path.relpath(path, dirpath)] = data
    return out


def cli_runs(tag: str, runs: dict) -> dict:
    """`python -m shadow_tpu_torch` child processes started together,
    one a run (name -> (config, data directory, scheduler,
    --progress)); each returns its wall (its own start to exit), stderr
    and sim-stats."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for name, (cfg_path, data, scheduler, progress) in runs.items():
        cmd = [sys.executable, "-m", "shadow_tpu_torch", cfg_path,
               "--scheduler", scheduler, "--data-directory", data]
        if progress:
            cmd.append("--progress")
        err = open(data + ".stderr", "w+")
        procs[name] = (subprocess.Popen(cmd, cwd=root,
                                        stdout=subprocess.DEVNULL,
                                        stderr=err), err,
                       time.perf_counter())
    walls = {}
    deadline = time.perf_counter() + 600
    try:
        while len(walls) < len(procs):
            for name, (p, _err, t0) in procs.items():
                if name not in walls and p.poll() is not None:
                    walls[name] = time.perf_counter() - t0
            if time.perf_counter() > deadline:
                raise AssertionError(f"{tag}: runs past 600 s: "
                                     f"{sorted(set(procs) - set(walls))}")
            if STOP.is_set():
                raise AssertionError(f"{tag}: stopped (the main thread "
                                     f"failed)")
            time.sleep(0.05)
    finally:
        for p, err, _t0 in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    out = {}
    for name, (p, _err, _t0) in procs.items():
        _cfg, data, scheduler, progress = runs[name]
        with open(data + ".stderr") as f:
            stderr = f.read()
        if p.returncode != 0:
            raise AssertionError(f"{tag} {name}: exit {p.returncode}: "
                                 f"{stderr[-3000:]}")
        with open(os.path.join(data, "sim-stats.json")) as f:
            stats = json.load(f)
        sim_s = stats["end_time_ns"] / 1e9
        print(f"{tag} {name}{' --progress' if progress else ''}: "
              f"{stats['rounds']} rounds, {stats['packets_sent']} packets, "
              f"process wall {walls[name]:.2f}s, "
              f"{sim_s / walls[name]:.4f} sim-s/wall-s (start to exit, "
              f"{len(runs)} processes at once); eligibility "
              f"{json.dumps(stats['metrics']['wall']['eligibility'])}",
              flush=True)
        out[name] = {"wall": walls[name], "stderr": stderr,
                     "stats": stats}
    return out


def data_dir_runs(card_line: str) -> dict:
    """Phase 7, the data directory and the two schedulers: each cell
    through `python -m shadow_tpu_torch --data-directory` under
    `--scheduler tpu` on the card and under `--scheduler thread_per_core`
    (the engine baseline, no device), then phold-8k again with
    `--progress`.  Requires each pair's directories byte-identical under
    the determinism gate's rules, the tpu run's audit showing the card's
    work (device-span rounds = the runners' rounds > 0, or every round
    forced through stt_propagate_round with launches), its kernel
    launched, and fabric violations 0 in every run; the progress run
    prints heartbeats with the reference's tornettools lines and writes
    the same directory (its progress line normalized).  All seven runs
    go at once (each wall is its own run's, on a shared host)."""
    import os
    import tempfile

    import yaml
    tag = "[data-dir]"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # Every run at once: the baselines touch no card, the tpu runs
        # share it, and the host has the cores and memory, so the phase
        # costs its slowest run (each wall is its own, on a shared host).
        want = {}
        cells = data_dir_cells()
        for name, (text, general, exp) in cells.items():
            d = parse_yaml(text)
            d["general"].update(general)
            d["experimental"].update(exp)
            cfg_path = os.path.join(tmp, f"{name}.yaml")
            with open(cfg_path, "w") as f:
                yaml.dump(d, f, Dumper=getattr(yaml, "CSafeDumper",
                                               yaml.SafeDumper),
                          sort_keys=False)
            for sched in ("tpu", "thread_per_core"):
                want[f"{name}/{sched}"] = (
                    cfg_path, os.path.join(tmp, f"{name}-{sched}"), sched,
                    False)
            if name == "phold-8k":
                want[f"{name}/progress"] = (
                    cfg_path, os.path.join(tmp, f"{name}-progress"), "tpu",
                    True)
        every = cli_runs(tag, want)
        for name in cells:
            runs = {k.split("/")[1]: r for k, r in every.items()
                    if k.split("/")[0] == name}
            files = {k: gate_files(os.path.join(tmp, f"{name}-{k}"),
                                   progress=name == "phold-8k")
                     for k in runs}
            for k in runs:
                if k == "tpu":
                    continue
                if files[k].keys() != files["tpu"].keys():
                    raise AssertionError(f"{tag} {name}: {k} file set "
                                         f"differs from tpu's")
                bad = [rel for rel in files[k]
                       if files[k][rel] != files["tpu"][rel]]
                if bad:
                    raise AssertionError(f"{tag} {name}: {k} differs "
                                         f"from tpu in {bad[:5]}")
            for k, r in runs.items():
                fab = r["stats"]["metrics"]["sim"]["fabric"]
                if fab["violations"]:
                    raise AssertionError(f"{tag} {name} {k}: fabric "
                                         f"{fab}")
            stats = runs["tpu"]["stats"]
            wall = stats["metrics"]["wall"]
            el, disp = wall["eligibility"], wall["dispatch"]
            if name == "tier-1k":
                launches = disp["propagate"]["launches"]
                ok = el.get("per-round:forced-device") == \
                    stats["rounds"] and launches > 0
            else:
                family = ("device_span_tcp" if name.startswith("tcp")
                          else "device_span_phold")
                launches = disp[family]["span_launches"]
                runner_rounds = sum(disp[f]["rounds"] for f in
                                    ("device_span_phold", "device_span_tcp")
                                    if f in disp)
                ok = el.get("device-span", 0) == runner_rounds > 0 \
                    and launches > 0
            if not ok or sum(el.values()) != stats["rounds"]:
                raise AssertionError(f"{tag} {name} tpu: eligibility {el}, "
                                     f"rounds {stats['rounds']}, launches "
                                     f"{launches}")
            base = runs["thread_per_core"]["stats"]
            if base["metrics"]["wall"]["eligibility"] != \
                    {"per-round:scheduler": base["rounds"]}:
                raise AssertionError(f"{tag} {name} thread_per_core: "
                                     f"{base['metrics']['wall']}")
            if name == "phold-8k":
                err = runs["progress"]["stderr"].splitlines()
                beats = [ln for ln in err
                         if ln.startswith("[shadow-tpu-torch] heartbeat: ")]
                rusage = [ln for ln in err if ln.startswith(
                    "Process resource usage at simtime ")]
                meminfo = [ln for ln in err if ln.startswith(
                    "System memory usage in bytes at simtime ")]
                if not beats or len(rusage) != len(beats) \
                        or len(meminfo) != len(beats):
                    raise AssertionError(f"{tag} {name} --progress: "
                                         f"{err[-10:]}")
                print(f"{tag} {name} --progress: {len(beats)} heartbeats, "
                      f"e.g. {beats[-1]!r}", flush=True)
            out[name] = {k: r["wall"] for k, r in runs.items()}
            print(f"{tag} {name} PASS: tpu and thread_per_core directories "
                  f"identical ({len(files['tpu'])} files), kernel launches "
                  f"{launches}, fabric violations 0; process walls "
                  f"{ {k: round(v, 2) for k, v in out[name].items()} } "
                  f"on {card_line}", flush=True)
    return out


CHANNELS_ON = {"flight_recorder": "on", "sim_netstat": "on",
               "sim_fabricstat": "on", "kernel_observatory": "on"}
CHANNEL_FILES = ("flight-sim.bin", "telemetry-sim.bin", "fabric-sim.bin",
                 "kernel-sim.bin")


def check_channel_spans(tag: str, runner, base: dict, args: tuple,
                        pay: tuple = (), plain_factory=None,
                        reps: int = 3) -> dict:
    """Phase 8's kernel leg on one export (a TCP runner's or a PHOLD
    runner's state on the card): the span kernel with the channels on
    (sim-netstat on a TCP runner, the fabric observatory on both, every
    round sampled: the most rows a span takes) against the plain loop
    (windows by `plain_factory`, then the eager round end and sample)
    over spans of one and four rounds: every state column, the sample
    rows and the run's scalars exactly equal.  Then the span kernel's
    card time per one- and four-round span with the channels off and on,
    in turns in this call (span_card_ms), and the bytes the sample rows
    add to the span's bound.  Returns {"off": {1: ms, 4: ms}, "on": {...},
    "sample_bytes": {1: B, 4: B}}."""
    from shadow_tpu_torch.ops.span_common import sample_need_bytes
    from shadow_tpu_torch.tools.relay_cases import clone_state
    from shadow_tpu_torch.tools.window_cases import (tcp_window_mismatch,
                                                     window_mismatch)
    from shadow_tpu_torch.trace.fabricstat import FabricChannel
    from shadow_tpu_torch.trace.netstat import NetstatChannel
    tcp = hasattr(runner, "_tel_ident")
    mismatch = tcp_window_mismatch if tcp else window_mismatch
    saved = (runner.netstat, runner.fabric, runner.window_factory)
    fns = {}
    for on in (False, True):
        runner.netstat = NetstatChannel(1) if on and tcp else None
        runner.fabric = FabricChannel(1) if on else None
        runner.window_factory = None
        fns[on] = runner._build()
        assert fns[on].span is not None
    runner.window_factory = plain_factory
    plain = runner._build()
    assert plain.span is None
    prefixes = ("tel", "fab") if tcp else ("fab",)
    for mr in (1, 4):
        a, b = clone_state(base), clone_state(base)
        want = plain(a, *pay, *args, mr)
        got = fns[True](b, *pay, *args, mr)
        bad = mismatch(a, b) + [k for k in ("ks_fires", "ks_lanes")
                                if not np.array_equal(a[k], b[k])]
        rows = {p: b[f"{p}_n"] for p in prefixes}
        if bad or tuple(want[1:]) != tuple(got[1:]) \
                or any(n != want[3] for n in rows.values()):
            raise AssertionError(f"{tag} channels on, {mr} rounds: {bad} "
                                 f"differ, scalars {want[1:]} vs {got[1:]}, "
                                 f"rows {rows}")
        del a, b
    n_conns = base["c_cwnd"].shape[0] - 1 if tcp else 0
    out = {"sample_bytes": {
        mr: sample_need_bytes(dict.fromkeys(
            (f"{p}_n" for p in prefixes), mr), n_conns, runner._H)
        for mr in (1, 4)}}
    for on in (False, True):
        out["on" if on else "off"] = {}
    for _turn in range(2):
        for on in (False, True):
            for mr in (1, 4):
                card, _ = span_card_ms(fns[on], base, args + (mr,), reps,
                                       *pay)
                out["on" if on else "off"].setdefault(mr, []).extend(card)
    for k in ("off", "on"):
        out[k] = {mr: float(np.median(v)) for mr, v in out[k].items()}
    runner.netstat, runner.fabric, runner.window_factory = saved
    print(f"{tag} channels on (every round sampled: "
          f"{'sim-netstat and ' if tcp else ''}fabric rows): exact against "
          f"the plain loop over 1 and 4 rounds, the rows included; card "
          f"time per span, channels off / on (median of {2 * reps} single "
          f"launches in turns, fresh copies): 1 round "
          f"{out['off'][1] * 1e3:.3f} / {out['on'][1] * 1e3:.3f} us, 4 "
          f"rounds {out['off'][4] * 1e3:.3f} / {out['on'][4] * 1e3:.3f} "
          f"us; the rows add {out['sample_bytes'][1]} / "
          f"{out['sample_bytes'][4]} B to the bound", flush=True)
    return out


def channel_cells() -> dict:
    """Phase 8's cells: name -> config for a `tpu_device_spans` value,
    every channel on and every round sampled."""
    from shadow_tpu_torch.tools.span_loop_bench import stream_config
    cells = phold_cells()

    def on(make):
        def cfg(spans):
            c = make(spans)
            for k, v in CHANNELS_ON.items():
                setattr(c.experimental, k, v)
            return c
        return cfg

    def stream(spans):
        c = stream_config(16, "500ms", spans)
        c.experimental.dev_span_k_init = 4
        return c

    return {"tcp-stream-16": on(stream),
            "mesh-codel-10": on(cells["mesh-codel-10"][0]),
            "phold-8k": on(cells["phold-8k"][0])}


def channel_files(mgr, d: str) -> dict:
    """The run's four channel files, written by the channels' own
    writers into `d` and read back."""
    import os
    os.makedirs(d, exist_ok=True)
    mgr.flight.write(d)
    mgr.netstat.write(d)
    mgr.fabric.write(d, mgr.collect_fct_rows())
    mgr.kern.write(d)
    out = {}
    for f in CHANNEL_FILES:
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


def plain_loops(mgr) -> None:
    """Both span runners of `mgr` on their plain loops: the eager loop,
    each window by the family's window kernel."""
    from shadow_tpu_torch.ops.phold_window import PHOLD_WINDOW
    from shadow_tpu_torch.ops.tcp_window import TCP_WINDOW
    for attr, make_runner, factory in (
            ("_dev_span", mgr.make_dev_span_runner, PHOLD_WINDOW.bind),
            ("_dev_span_tcp", mgr.make_tcp_span_runner, TCP_WINDOW.bind)):
        r = make_runner()
        r.window_factory = factory
        setattr(mgr, attr, r)


def channel_runs(keep: dict | None = None) -> dict:
    """Phase 8: each channel cell spans off, through the span kernels
    ("kernel") and through the plain loops ("plain": the eager loop, its
    windows by the family's window kernel).  Returns each device run's
    kernel launches by path; `keep` gets each cell's kernel and plain
    run ({"kernel": (manager, summary), "plain": ...}) for phase 10."""
    import hashlib
    import tempfile

    from shadow_tpu_torch.core.manager import Manager
    from shadow_tpu_torch.trace.events import (FAM_PHOLD, FAM_TCP,
                                               KS_REC_BYTES)
    from shadow_tpu_torch.trace.kernstat import family_trips
    wrappers = kernel_wrappers()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, make in channel_cells().items():
            tag = f"[channels {name}]"
            runs = {}
            for path in ("off", "kernel", "plain"):
                mgr = Manager(make("off" if path == "off" else "force"),
                              device="cuda")
                if path == "plain":
                    plain_loops(mgr)
                zero_counts(wrappers)
                gc.collect()
                t0 = time.perf_counter()
                summary = mgr.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if not summary.ok:
                    raise AssertionError(f"{tag} {path}: plugin errors "
                                         f"{summary.plugin_errors[:3]}")
                lines = mgr.trace_lines()
                digest = hashlib.sha256(
                    "\n".join(lines).encode()).hexdigest()
                r = mgr._dev_span_tcp if name.startswith("tcp") \
                    else mgr._dev_span
                runs[path] = dict(
                    digest=digest, r=r, wall=wall, summary=summary,
                    mgr=mgr if path != "off" else None,
                    launches={k: w.launches for k, w in wrappers.items()},
                    host_reads={k: wrappers[k].host_reads
                                for k in ("tcp_span", "phold_span")},
                    files=channel_files(mgr, f"{tmp}/{name}-{path}"))
                print(f"{tag} {path}: rounds {summary.rounds} (device "
                      f"{r.rounds if r else 0} in {r.spans if r else 0} "
                      f"spans), trace sha256 {digest[:16]}, wall "
                      f"{wall:.2f}s, files "
                      + ", ".join(f"{f} {len(b)} B" for f, b in
                                  runs[path]["files"].items())
                      + f", launches {runs[path]['launches']}", flush=True)
            off, kern, plain = runs["off"], runs["kernel"], runs["plain"]
            if len({off["digest"], kern["digest"], plain["digest"]}) != 1 \
                    or (name in DIGESTS
                        and not off["digest"].startswith(DIGESTS[name])):
                raise AssertionError(f"{tag} traces differ: "
                                     f"{[x['digest'][:16] for x in runs.values()]}")
            bad = [f for f in CHANNEL_FILES
                   if kern["files"][f] != plain["files"][f]]
            bad += [f"{f} (engine)" for f in ("telemetry-sim.bin",
                                              "fabric-sim.bin")
                    if off["files"][f] != kern["files"][f]]
            if off["files"]["kernel-sim.bin"] or any(
                    off["launches"].values()):
                bad.append("the C++ run's kernel records or launches")
            tcp = name.startswith("tcp")
            fam, kname = ((FAM_TCP, "tcp_span") if tcp
                          else (FAM_PHOLD, "phold_span"))
            r = kern["r"]
            n = kern["launches"][kname]
            trips = family_trips(kern["files"]["kernel-sim.bin"])
            recs = len(kern["files"]["kernel-sim.bin"]) // KS_REC_BYTES
            if r is None or r.spans == 0 or n != r.spans_all \
                    or kern["host_reads"][kname] != n \
                    or r.ks_spans != r.spans or r.ks_windows != r.rounds \
                    or recs != r.spans or trips.get(fam) != r.micro_iters \
                    or getattr(r, "eager_round_ends", 0):
                bad.append(f"{kname} launches {n} for "
                           f"{r and r.spans_all} dispatches, reads "
                           f"{kern['host_reads'][kname]}, {recs} records "
                           f"for {r and r.spans} spans, trips {trips} vs "
                           f"{r and r.micro_iters}")
            if not kern["files"]["fabric-sim.bin"][24:] or (
                    tcp and not kern["files"]["telemetry-sim.bin"]):
                bad.append("no sample rows")
            if bad:
                raise AssertionError(f"{tag} {bad}")
            out[f"{name}/channels"] = kern["launches"]
            paths = REPORT_PATHS.get(name, ("kernel", "plain"))
            if keep is not None and paths:
                keep[name] = {p: (runs[p]["mgr"], runs[p]["summary"])
                              for p in paths}
            print(f"{tag} PASS: one trace ({off['digest'][:16]}) in the "
                  f"three runs; the four channel files identical through "
                  f"{kname} and the plain loop, the samples equal to the "
                  f"engine's; {n} {kname} launches ({r.rounds} rounds "
                  f"inside, one read each), {recs} kernel records, trips "
                  f"= micro-iterations {r.micro_iters}; walls "
                  + ", ".join(f"{k} {v['wall']:.2f}s"
                              for k, v in runs.items()), flush=True)
    return out


# Phase 9's cells.  object-1k: bench.py config3 with every host on the
# object path; mixed-pcap-10k: bench.py mixed_pcap_rung (config_10k to
# 3 s beside 4 pcap'd object-path clients).
MIXED_PCAP_CLIENTS = 4
MIXED_STOP_S = 3


def start_cli(cfg, data: str, scheduler: str):
    """`python -m shadow_tpu_torch` on `cfg` (a ConfigOptions' YAML dict)
    into `data`, started in a child process; finish_cli waits for it."""
    import os

    import yaml
    root = os.path.dirname(os.path.abspath(__file__))
    path = data + ".yaml"
    with open(path, "w") as f:
        yaml.dump(cfg, f, Dumper=getattr(yaml, "CSafeDumper",
                                         yaml.SafeDumper), sort_keys=False)
    err = open(data + ".stderr", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch", path, "--scheduler",
         scheduler, "--data-directory", data], cwd=root,
        stdout=subprocess.DEVNULL, stderr=err)
    return proc, err, time.perf_counter(), data


def finish_cli(tag: str, child, timeout_s: float = 600) -> dict:
    """Wait for a start_cli child (killed past `timeout_s`): its wall,
    sim-stats.json and its trace's sha256 (the lines joined by newlines,
    as trace_digest takes them)."""
    import hashlib
    import os
    proc, err, t0, data = child
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"{tag}: the CLI run passed {timeout_s} s")
    finally:
        err.close()
    wall = time.perf_counter() - t0
    with open(data + ".stderr") as f:
        stderr = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: exit {proc.returncode}: "
                             f"{stderr[-3000:]}")
    with open(os.path.join(data, "sim-stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(data, "packet-trace.txt"), "rb") as f:
        text = f.read()
    lines = text.count(b"\n")
    digest = hashlib.sha256(text[:-1] if text else text).hexdigest()
    return {"wall": wall, "stats": stats, "digest": digest, "lines": lines,
            "data": data}


def print_object_dispatch(tag: str, name: str, block: dict) -> dict:
    """The object path's dispatch per device chunk, in the per-round
    route's words: pack (the outbox's columns built and written into
    the round buffer), call (the one C call: launch and wait), views
    (the results read), scatter (the kept packets delivered in outbox
    order), and the kernel's own events."""
    us = block["per_device_round_us"]
    d = {"pack_us": us["export"] + us["upload"], "call_us": us["launch"],
         "views_us": us["download"], "scatter_us": us["scatter"],
         "kernel_us": us["kernel"]}
    print(f"{tag} {name}: outbox chunks {block['object_chunks']} "
          f"({block['object_rounds_device']} on the card), packets per "
          f"chunk {block['packets_per_chunk']}; per device chunk (us): "
          f"{json.dumps({k: round(v, 2) for k, v in d.items()})}",
          flush=True)
    return d


def object_runs() -> dict:
    """Phase 9.  object-1k (bench.py config3: 1,000 hosts on the 3-tier
    graph, 100 tgen-servers, 900 clients x 5 x 50,000 B, seed 7, 30 s)
    with every host on the object path (`native_dataplane: off`): tpu
    forced (`tpu_min_device_batch: 0`, every outbox chunk through
    stt_propagate_round), tpu auto (the route model and its probes) and
    serial (the CPU twin, in a child process, no device).  mixed-pcap-10k
    (bench.py mixed_pcap_rung: config_10k to 3 s with 4 pcap'd clients on
    the object path, per-host `native_dataplane: false`) under tpu on the
    card and under the engine thread_per_core (`native_dataplane: on`,
    in a child process).  Requires, for object-1k, one trace sha256 and
    equal counters across the three runs, forced launches = object-path
    device rounds = dispatched rounds with no host-route round and no
    other kernel, auto launches + probe launches = device rounds +
    probes, and no device work in the serial run; for mixed-pcap-10k,
    equal packet counts, device or C++ spans over at least half of the
    tpu run's rounds, one trace sha256 and the 8 pcap files
    byte-identical."""
    import os
    import tempfile

    from shadow_tpu_torch.tools.netgen import (pcap_clients, tier1k_yaml,
                                               tier10k_yaml)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        obj = parse_yaml(tier1k_yaml("tpu"))
        obj["experimental"]["native_dataplane"] = "off"
        mixed = parse_yaml(tier10k_yaml(
            "tpu", stop_s=MIXED_STOP_S,
            extra_hosts=pcap_clients(MIXED_PCAP_CLIENTS)))
        base_mixed = dict(mixed, experimental=dict(
            mixed["experimental"], native_dataplane="on"))
        # The two CPU runs go in child processes beside this one's card
        # runs (each wall is its own, on a shared host).
        children = {
            "object-1k/serial": start_cli(obj, os.path.join(
                tmp, "object-serial"), "serial"),
            "mixed-pcap-10k/thread_per_core": start_cli(
                base_mixed, os.path.join(tmp, "mixed-tpc"),
                "thread_per_core")}
        tag = "[object-1k]"
        runs = {name: propagate_run(tag, name, config_with(
                    obj, tpu_min_device_batch=mdb))
                for name, mdb in (("forced", 0), ("auto", 2048))}
        serial = finish_cli(tag, children.pop("object-1k/serial"))
        check_forced(tag, runs["forced"])
        same_results(tag, runs)
        f = runs["forced"]
        fb = f["block"]
        if not (fb["object_rounds_device"] == fb["rounds_device"]
                == fb["object_chunks"] == fb["rounds_dispatched"]
                == f["launches"]["propagate"] > 0):
            raise AssertionError(f"{tag} forced: object-path device rounds "
                                 f"{fb['object_rounds_device']}, chunks "
                                 f"{fb['object_chunks']}, {fb}")
        auto = runs["auto"]
        ab = auto["block"]
        if auto["launches"]["propagate"] + auto["probe_launches"] \
                != ab["rounds_device"] + ab["probes_async"] \
                or any(v for k, v in auto["launches"].items()
                       if k != "propagate"):
            raise AssertionError(f"{tag} auto: launches {auto['launches']} "
                                 f"+ probes {auto['probe_launches']} vs "
                                 f"{ab}")
        s = f["summary"]
        st = serial["stats"]
        disp = st["metrics"]["wall"]["dispatch"]
        if serial["digest"] != f["digest"] or (
                st["packets_sent"], st["packets_recv"],
                st["packets_dropped"], st["events"]) != (
                s.packets_sent, s.packets_recv, s.packets_dropped,
                s.events) or "propagate" in disp or disp["rounds_device"]:
            raise AssertionError(f"{tag} serial: sha256 "
                                 f"{serial['digest'][:16]} vs "
                                 f"{f['digest'][:16]}, {st['packets_sent']} "
                                 f"packets vs {s.packets_sent}, {disp}")
        print(f"{tag} serial (child process, no device): trace sha256 "
              f"{serial['digest'][:16]}, {serial['lines']} lines, "
              f"{st['packets_sent']} packets, {st['events']} events, "
              f"process wall {serial['wall']:.2f}s", flush=True)
        for name, run in runs.items():
            run["dispatch"] = print_object_dispatch(tag, name, run["block"])
        print(f"{tag} PASS: one trace in the three runs; forced "
              f"{fb['rounds_device']} object-path device rounds, each one "
              f"stt_propagate_round launch, no host-route round; auto "
              f"{ab['rounds_device']} device rounds + {ab['probes_async']} "
              f"probes = {auto['launches']['propagate']} + "
              f"{auto['probe_launches']} launches; walls forced "
              f"{f['wall']:.2f}s, auto {auto['wall']:.2f}s, serial "
              f"{serial['wall']:.2f}s (process)", flush=True)
        out["object-1k"] = runs
        # mixed-pcap-10k under tpu on the card, its pcaps beside the
        # baseline's.
        tag = "[mixed-pcap-10k]"
        cfg = config_with(mixed)
        cfg.general.data_directory = os.path.join(tmp, "mixed-tpu")
        run = propagate_run(tag, "tpu", cfg)
        base = finish_cli(tag, children.pop(
            "mixed-pcap-10k/thread_per_core"))
        s = run["summary"]
        st = base["stats"]
        cov = s.span_rounds / max(s.rounds, 1)
        if (st["packets_sent"], st["packets_recv"],
                st["packets_dropped"]) != (s.packets_sent, s.packets_recv,
                                           s.packets_dropped):
            raise AssertionError(f"{tag} packets {s.packets_sent} / "
                                 f"{s.packets_recv} / {s.packets_dropped} "
                                 f"vs the baseline's {st['packets_sent']} / "
                                 f"{st['packets_recv']} / "
                                 f"{st['packets_dropped']}")
        if run["digest"] != base["digest"]:
            raise AssertionError(f"{tag} trace sha256 "
                                 f"{run['digest'][:16]} vs the baseline's "
                                 f"{base['digest'][:16]}")
        if cov < 0.5:
            raise AssertionError(f"{tag} span coverage {s.span_rounds}/"
                                 f"{s.rounds} < 50%")
        pcaps = []
        for i in range(MIXED_PCAP_CLIENTS):
            for iface in ("lo", "eth0"):
                rel = os.path.join("hosts", f"pcap{i:02d}", f"{iface}.pcap")
                with open(os.path.join(tmp, "mixed-tpu", rel), "rb") as f1, \
                        open(os.path.join(base["data"], rel), "rb") as f2:
                    a, b = f1.read(), f2.read()
                if a != b:
                    raise AssertionError(f"{tag} {rel} differs "
                                         f"({len(a)} vs {len(b)} bytes)")
                pcaps.append((rel, len(a)))
        if not all(n > 24 for rel, n in pcaps if rel.endswith("eth0.pcap")):
            raise AssertionError(f"{tag} an eth0 capture is empty: {pcaps}")
        print(f"{tag} PASS: {s.packets_sent} packets in both runs, trace "
              f"sha256 {run['digest'][:16]} in both, span coverage "
              f"{s.span_rounds}/{s.rounds} rounds ({100 * cov:.1f}%), the "
              f"8 pcaps byte-identical ({json.dumps(dict(pcaps))}); walls "
              f"tpu {run['wall']:.2f}s, thread_per_core {base['wall']:.2f}s "
              f"(process, the data directory's files included)", flush=True)
        out["mixed-pcap-10k"] = run
    return out


# Phase 10's DCTCP cell: the reference's forced-device DCTCP shape
# (tests/test_dctcp.py test_dctcp_forced_device_differential), what a
# datacenter user runs DCTCP for: an 8 -> 1 incast on a 20 Mbit sink.
DCTCP_INCAST = dict(nbytes=2_000_000, stop_time="2s", seed=17,
                    tcp={"cc": "dctcp", "ecn": "on"})
TRACE_SMOKE_TIMEOUT_S = 600
# The runs phase 10 writes and reports a data directory of, by phase-8
# cell (default: the kernel and the plain run).  None of phold-8k's: on
# the card's host each of its directories took ~33 s to write (the
# pure-Python YAML dump of an 11 MB processed config) and ~15 s to
# report, which the script's time limit has no room for; phase 8 holds
# its channel files equal between the two runs.
REPORT_PATHS = {"phold-8k": ()}


def dctcp_config(path: str):
    """dctcp-incast-8 for one of phase 10's routes, every channel on."""
    from shadow_tpu_torch.core.config import ConfigOptions
    from shadow_tpu_torch.tools.netgen import incast_yaml
    sched = "serial" if path == "serial" else "tpu"
    spans = {"serial": None, "off": "off"}.get(path, "force")
    c = ConfigOptions.from_yaml_text(incast_yaml(
        8, scheduler=sched, device_spans=spans, **DCTCP_INCAST))
    for k, v in CHANNELS_ON.items():
        setattr(c.experimental, k, v)
    return c


def dctcp_runs(wrappers: dict) -> dict:
    """Phase 10's dctcp-incast-8 on four routes: the serial object path,
    tpu spans off (the C++ engine), forced through stt_tcp_span
    ("kernel") and forced through the plain loop ("plain").  Returns
    path -> the run (its manager, summary, launches)."""
    from shadow_tpu_torch.core.manager import Manager
    tag = "[reports dctcp-incast-8]"
    runs = {}
    for path in ("serial", "off", "kernel", "plain"):
        cfg = dctcp_config(path)
        mgr = Manager(cfg, device="cuda")
        if path == "plain":
            plain_loops(mgr)
        zero_counts(wrappers)
        gc.collect()
        t0 = time.perf_counter()
        summary = mgr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not summary.ok:
            raise AssertionError(f"{tag} {path}: plugin errors "
                                 f"{summary.plugin_errors[:3]}")
        digest, lines, _ = trace_digest(mgr)
        r = mgr._dev_span_tcp
        runs[path] = dict(
            mgr=mgr, summary=summary, wall=wall, digest=digest, r=r,
            launches={k: w.launches for k, w in wrappers.items()},
            host_reads=wrappers["tcp_span"].host_reads,
            cons=mgr.fabric_conservation(),
            fabric=mgr.fabric_summary(cfg.general.stop_time_ns))
        print(f"{tag} {path}: wall {wall:.2f}s, rounds {summary.rounds} "
              f"(device {r.rounds if r else 0} in {r.spans if r else 0} "
              f"spans, {r.aborts if r else 0} aborts), trace "
              f"{digest[:16]} ({lines} lines), packets "
              f"{summary.packets_sent}, marks {runs[path]['cons']['marks']}"
              f", fabric {json.dumps(runs[path]['fabric'])}, launches "
              f"{runs[path]['launches']}", flush=True)
    bad = []
    if len({x["digest"] for x in runs.values()}) != 1:
        bad.append(f"traces {[x['digest'][:16] for x in runs.values()]}")
    cons = runs["serial"]["cons"]
    if any(x["cons"] != cons for x in runs.values()) \
            or cons["marked_pkts"] <= 0 or cons["violations"]:
        bad.append(f"conservation {[x['cons'] for x in runs.values()]}")
    if any(x["fabric"] != runs["kernel"]["fabric"] for x in runs.values()):
        bad.append(f"fabric_summary {[x['fabric'] for x in runs.values()]}")
    for path in ("serial", "off"):
        r = runs[path]["r"]
        if any(runs[path]["launches"].values()) or (r and r.rounds):
            bad.append(f"{path}: device work {runs[path]['launches']}")
    k, pl = runs["kernel"], runs["plain"]
    r, n = k["r"], k["launches"]["tcp_span"]
    if r is None or r.spans == 0 or n != r.spans_all \
            or k["host_reads"] != n or r.ks_spans != r.spans \
            or r.ks_windows != r.rounds or r.eager_round_ends \
            or k["launches"]["tcp_window"]:
        bad.append(f"kernel: {n} stt_tcp_span launches for "
                   f"{r and r.spans_all} dispatches, {k['host_reads']} "
                   f"reads, {k['launches']}")
    rp = pl["r"]
    if rp is None or pl["launches"]["tcp_span"] \
            or pl["launches"]["tcp_window"] != rp.windows_all \
            or rp.windows_all < rp.rounds or rp.rounds == 0:
        bad.append(f"plain: {pl['launches']} for "
                   f"{rp and rp.windows_all} windows")
    for path in ("kernel", "plain"):
        x = runs[path]
        if x["r"] is None or x["r"].rounds * 2 < x["summary"].rounds:
            bad.append(f"{path}: only {x['r'] and x['r'].rounds} of "
                       f"{x['summary'].rounds} rounds on the card")
    if bad:
        raise AssertionError(f"{tag} {bad}")
    print(f"{tag} PASS: one trace ({k['digest'][:16]}) in the four runs; "
          f"{cons['marked_pkts']} packets marked ({cons['marks']}), no "
          f"violation, fabric_summary equal in all four; {n} stt_tcp_span "
          f"launches = dispatches = reads ({r.rounds} of "
          f"{k['summary'].rounds} rounds on the card), "
          f"{pl['launches']['tcp_window']} stt_tcp_window launches "
          f"through the plain loop; walls "
          + ", ".join(f"{p} {x['wall']:.2f}s" for p, x in runs.items()),
          flush=True)
    return runs


def check_report_dir(tag: str, d: str, tcp: bool) -> dict:
    """The reports over one data directory, in-process: every verdict
    True (fct's only where TCP payload moved), the Chrome export's round
    slices and each channel's counter track where it has rows.  Returns
    the reports' text by name."""
    import io
    import os

    from shadow_tpu_torch.tools import trace as trace_cli
    from shadow_tpu_torch.trace.chrome import (PID_FABRIC, PID_KERN,
                                               PID_NETSTAT, PID_SIM)
    from shadow_tpu_torch.trace.events import split_fabric
    chrome_out = os.path.join(d, "chrome-trace.json")
    text, verdicts = {}, {}
    t0 = time.perf_counter()
    for name in ("summarize", "net_report", "fabric_report", "fct_report",
                 "kern_report", "explain_report"):
        buf = io.StringIO()
        kw = {"chrome_out": chrome_out} if name == "summarize" else {}
        verdicts[name] = getattr(trace_cli, name)(d, out=buf, **kw)
        text[name] = buf.getvalue()
    wall = time.perf_counter() - t0
    with open(chrome_out) as f:
        ev = json.load(f)["traceEvents"]
    _stats, _sim, _wall, tel, _sc, fab = trace_cli._load(d)
    fb = split_fabric(fab)[0] if fab else b""
    ks = trace_cli._kern_bytes(d)
    counts = {"X": sum(e["ph"] == "X" and e["pid"] == PID_SIM for e in ev)}
    for key, pid in (("netstat", PID_NETSTAT), ("fabric", PID_FABRIC),
                     ("kern", PID_KERN)):
        counts[key] = sum(e["ph"] == "C" and e["pid"] == pid for e in ev)
    bad = [n for n, ok in verdicts.items()
           if not ok and (n != "fct_report" or tcp)]
    for key, data in (("netstat", tel), ("fabric", fb), ("kern", ks)):
        if bool(counts[key]) != bool(data):
            bad.append(f"chrome {key} track {counts[key]} for "
                       f"{len(data)} B")
    if not counts["X"]:
        bad.append("chrome: no round slices")
    if bad:
        raise AssertionError(f"{tag} {d}: {bad}\n"
                             + "".join(text.values())[-3000:])
    print(f"{tag} reports {wall:.2f}s: verdicts "
          f"{json.dumps(verdicts)}; chrome {len(ev)} events, "
          f"{json.dumps(counts)}", flush=True)
    return text


def report_runs(channel_mgrs: dict) -> dict:
    """Phase 10.  The port's own trace smoke starts first, in a child
    process on the card; then dctcp-incast-8 on its four routes; then
    the data directory of each run in `channel_mgrs` (phase 8's kernel
    and plain runs, REPORT_PATHS) and of dctcp-incast-8's kernel and
    plain runs, the reports over each, and the net, fabric and fct
    reports' text equal between a cell's two.  Returns each
    dctcp-incast-8 run's kernel launches by path."""
    import os
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    log = tempfile.TemporaryFile("w+")
    smoke = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.tools.trace", "--smoke"],
        cwd=root, stdout=log, stderr=subprocess.STDOUT)
    t_smoke = time.perf_counter()
    smoke_end: list = []
    waiter = threading.Thread(target=lambda: (
        smoke.wait(), smoke_end.append(time.perf_counter())))
    waiter.start()
    wrappers = kernel_wrappers()
    try:
        runs = dctcp_runs(wrappers)
        cells = dict(channel_mgrs)
        cells["dctcp-incast-8"] = {p: (runs[p]["mgr"], runs[p]["summary"])
                                   for p in ("kernel", "plain")}
        with tempfile.TemporaryDirectory() as tmp:
            for name, pair in cells.items():
                tag = f"[reports {name}]"
                tcp = name.startswith(("tcp", "dctcp"))
                texts = {}
                for path, (mgr, summary) in pair.items():
                    d = os.path.join(tmp, f"{name}-{path}")
                    mgr.config.general.data_directory = d
                    t0 = time.perf_counter()
                    mgr.write_data_dir(summary)
                    print(f"{tag} {path}: data directory written in "
                          f"{time.perf_counter() - t0:.2f}s", flush=True)
                    texts[path] = check_report_dir(f"{tag} {path}", d, tcp)
                differ = [n for n in ("net_report", "fabric_report",
                                      "fct_report")
                          if texts["kernel"][n] != texts["plain"][n]]
                if differ:
                    raise AssertionError(f"{tag} the kernel and plain "
                                         f"directories' {differ} differ")
                print(f"{tag} PASS: every verdict True; net, fabric and fct "
                      f"reports identical for the kernel and the plain "
                      f"directory", flush=True)
        waiter.join(timeout=max(
            TRACE_SMOKE_TIMEOUT_S - (time.perf_counter() - t_smoke), 1))
    finally:
        if smoke.poll() is None:
            smoke.kill()
        waiter.join()
    wall = smoke_end[0] - t_smoke
    log.seek(0)
    out = log.read()
    log.close()
    m = re.search(r"span kernel launches (\{.*\})", out)
    launches = json.loads(m.group(1)) if m else {}
    if smoke.returncode != 0 or launches.get("stt_phold_span", 0) <= 0:
        raise AssertionError(f"[reports trace-smoke] exit "
                             f"{smoke.returncode}, launches {launches}: "
                             f"{out[-3000:]}")
    print(f"[reports trace-smoke] PASS: `python -m "
          f"shadow_tpu_torch.tools.trace --smoke` exit 0, its wall "
          f"{wall:.1f}s beside the phase's other work, span kernel launches "
          f"{json.dumps(launches)}; its lines: "
          + " | ".join(ln for ln in out.splitlines()
                       if ln.startswith("trace smoke:")), flush=True)
    return {f"dctcp-incast-8/{p}": x["launches"] for p, x in runs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stop-time", default="1.31s",
                    help="simulated time of the 10,000-host TCP stream")
    args = ap.parse_args(argv)
    clock = {"t": time.perf_counter()}

    def phase_done(what: str) -> None:
        now = time.perf_counter()
        print(f"[phase] {what}: {now - clock['t']:.1f} s", flush=True)
        clock["t"] = now

    kind = card()
    phase_done("1 (the card)")
    build_all()
    law_stats = check_kernels()
    stats = {name: law_stats[(name, H_RING)]
             for name in ("bucket_step", "codel_head")}
    relay_stats = check_relay_kernels()
    check_propagate()
    window_stats, span_stats = check_phold_window()
    # The TCP window and span kernels on the 16-host stream's exports and
    # the wide-rows edit of the lossy one (the 10,000-host one follows
    # phase 3's run, which captures it).
    from shadow_tpu_torch.ops.tcp_window import LIBRARY as TCP_WINDOW_LIB
    from shadow_tpu_torch.tools.tcp_window_profile import launch_shape
    from shadow_tpu_torch.tools.window_cases import (tcp_device_state,
                                                     tcp_over_cap,
                                                     tcp_wide_rows)
    frame_conns = launch_shape(TCP_WINDOW_LIB.build(), 16)["frame_conns"]
    tcp_stats, tcp_span_stats = {}, {}
    for name, loss in (("stream-16", 0.0), ("stream-16-lossy", 0.02)):
        runner, st_np, span_args = tcp_export(loss)
        legs = [(name, st_np)]
        if loss:
            # The wide-rows edit, and the over-cap edit: a tgen server
            # with one conn row more than the lane frame holds, its
            # busiest conn past the frame (in device memory).
            legs.append(("stream-16-wide", tcp_wide_rows(st_np)))
            legs.append(("stream-16-over-cap",
                         tcp_over_cap(st_np, frame_conns + 1)))
        for leg, st in legs:
            tcp_stats[leg] = check_tcp_window(
                leg, runner, tcp_device_state(runner, st), span_args,
                profile=leg == "stream-16-lossy")
            tcp_span_stats[leg] = check_tcp_span(
                leg, runner, tcp_device_state(runner, st), span_args)
        del runner, st_np, legs
        gc.collect()
        torch.cuda.empty_cache()
    phase_done("2 (builds; the law, relay, propagate, PHOLD and 16-host "
               "TCP kernels against their plain versions)")
    by_path: dict = {}
    # The main path: the 10,000-host stream through the span kernel.  Its
    # fleet enters the TCP device-span domain only at 1.23 s simulated
    # (every client's GET acked, every rtx/reassembly ring under half its
    # cap), and the C++ prefix takes most of the run, so the run ends a
    # span of 8 rounds into the device stretch: the device share here is
    # small by construction (PERF.md).
    print(f"[main] stop_time {args.stop_time}: cut from 1s upward to "
          f"reach the device-span domain (entered at 1.23 s; a span of "
          f"8 rounds to 1.31 s) and kept short for the time limit",
          flush=True)
    capture: dict = {}
    by_path["tcp-stream-10k"], occupancy = stream_pair(
        H_MAIN, args.stop_time, min_share=0.0,
        reference=STREAM_10K.get(args.stop_time), capture=capture)
    # Phase 2's TCP leg on the run's first in-domain export, captured
    # before its launch (the C++ prefix is not run twice).
    if "st" not in capture:
        raise AssertionError("[main] the 10,000-host run made no export")
    runner = capture.pop("runner")
    runner._res_st = None  # the run's resident carry
    gc.collect()
    torch.cuda.empty_cache()
    base = capture.pop("st")
    tcp_stats["stream-10k"] = check_tcp_window(
        "stream-10k", runner, base, capture["args"], graph=False,
        profile=True)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("3 (tcp-stream-10k, the C++ prefix to the domain and "
               "one span)")
    tcp_span_stats["stream-10k"] = check_tcp_span(
        "stream-10k", runner, base, capture["args"], plain4="kernel",
        reps=3)
    # Phase 8's kernel leg on the same export: the channels on.
    from shadow_tpu_torch.ops.tcp_window import TCP_WINDOW
    tcp_span_stats["stream-10k"]["channels"] = check_channel_spans(
        "[channels stream-10k]", runner, base, capture["args"],
        plain_factory=TCP_WINDOW.bind)
    del runner, base
    gc.collect()
    torch.cuda.empty_cache()
    # The device share at a width the eager loop finishes in time; the
    # router's first window is 4 rounds, so the device stretch takes
    # several spans and TCP residency and the overlap show on the card.
    by_path["tcp-stream-16"], _ = stream_pair(16, "500ms", min_share=0.5,
                                              k_init=4)
    # The window kernel's path: the same stream through stt_tcp_window and
    # the eager round ends.
    by_path["tcp-stream-16/window"], _ = stream_pair(
        16, "500ms", min_share=0.5, k_init=4, path="window")
    # The relay kernels' path: the same stream through the eager window,
    # to EAGER_STOP.
    by_path["tcp-stream-16/eager-window"], _ = stream_pair(
        16, EAGER_STOP, min_share=0.0, k_init=4, path="eager")
    phase_done("2 (the 10,000-host export's TCP window and span legs, "
               "the channels' leg) and 3 (tcp-stream-16 on three paths)")
    # The main path of the standalone law kernels: the PHOLD/udp-mesh
    # family, phold-8k first.
    for name, (make, share, codel) in phold_cells().items():
        by_path.update(phold_pair(name, make, share, codel,
                                  side_runs=name == "phold-8k"))
    phase_done("4 (phold-8k, mesh-24, mesh-codel-10)")
    # The law kernels' main path: phold-64k-ring with residency and the
    # speculative overlap; then the overlap through the CLI.
    overlap_child = start_cli_overlap()
    try:
        by_path.update(ring_runs())
    except BaseException:
        finish_cli_overlap(overlap_child, kill=True)
        raise
    finish_cli_overlap(overlap_child)
    phase_done("5 (phold-64k-ring, the CLI's overlap beside it)")
    # Phase 6: per-round device propagation.  The main path of
    # stt_propagate: tier10k forced, every round through the kernel.
    for cell, runs in (("tier10k", tier10k_runs()),
                       ("mesh-100", mesh100_runs())):
        for name, run in runs.items():
            by_path[f"{cell}/{name}"] = dict(
                run["launches"], propagate_probes=run["probe_launches"])
            if cell == "tier10k" and name == "forced":
                per_round = run["block"]["packets_per_round"]
    phase_done("6 (tier10k, mesh-100)")
    # Phase 7: the data directory and the two schedulers, through the
    # CLI in child processes (their launches are not this process's).
    # This process only waits for them, so phases 8, 10 and 9 run
    # meanwhile, on a thread beside it.
    phase7 = Background(data_dir_runs, CARD_LINE)
    try:
        # Phase 8: the sim-time channels through the span kernels and
        # the plain loops.
        channel_mgrs: dict = {}
        by_path.update(channel_runs(channel_mgrs))
        phase_done("8 (the channels: tcp-stream-16, mesh-codel-10, "
                   "phold-8k; beside phase 7)")
        # Phase 10: the reports over card-written data directories, with
        # dctcp-incast-8 through both TCP paths, and the trace smoke.
        by_path.update(report_runs(channel_mgrs))
        del channel_mgrs
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("10 (the reports: dctcp-incast-8 on four routes, the "
                   "reports over six data directories, the trace smoke; "
                   "beside phase 7)")
        # Phase 9: object-path hosts, their sends through
        # stt_propagate_round.
        obj = object_runs()
        for name, run in obj["object-1k"].items():
            by_path[f"object-1k/{name}"] = dict(
                run["launches"], propagate_probes=run["probe_launches"])
        by_path["mixed-pcap-10k/tpu"] = dict(
            obj["mixed-pcap-10k"]["launches"],
            propagate_probes=obj["mixed-pcap-10k"]["probe_launches"])
        obj_chunk = obj["object-1k"]["forced"]["block"]["packets_per_chunk"]
        phase_done("9 (object-1k, mixed-pcap-10k; beside phase 7's "
                   "last runs)")
    except BaseException:
        STOP.set()
        phase7.join()
        raise
    phase7.result()
    phase_done(f"7 (the CLI's data directories, seven runs at once; "
               f"{phase7.wall:.1f} s from its start, beside phases 8, 10 "
               f"and 9), the wait for it")
    # The kernel's row: timed at the main path's median round.
    print(f"[main] propagate: the forced tier10k run's packets per round "
          f"{per_round}; the kernels line's row is timed at the median",
          flush=True)
    stats["propagate"] = time_propagate(per_round["median"])
    # The object path's rounds: object-1k forced's chunks, at their median.
    print(f"[main] propagate: object-1k forced's packets per chunk "
          f"{obj_chunk}; timed at the median", flush=True)
    stats["propagate"]["object_path"] = dict(
        time_propagate(obj_chunk["median"]),
        launches=by_path["object-1k/forced"]["propagate"],
        dispatch_per_chunk_us=obj["object-1k"]["forced"]["dispatch"],
        packets_per_chunk=obj_chunk)
    # The relay kernels' row: the mask density nearest the main path's
    # mean lanes per fire of the relay stage.
    from shadow_tpu_torch.ops.tcp_span import KS_CODEL, KS_INET_OUT
    for name, code in (("relay1_law", KS_INET_OUT),
                       ("relay2_law", KS_CODEL)):
        occ = occupancy[code]
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
    # The PHOLD kernels' rows: timed on the phold-64k-ring export (the
    # span kernel's over four rounds).
    stats["phold_window"] = window_stats["phold-64k-ring"]
    stats["phold_span"] = span_stats["phold-64k-ring"]
    # The TCP kernels' rows: the 10,000-host export (the span kernel's
    # over one round, its plain loop there the eager window's; four
    # rounds beside).
    stats["tcp_window"] = tcp_stats["stream-10k"]
    stats["tcp_span"] = tcp_span_stats["stream-10k"]
    # `launches`: the count on each kernel's main path (tcp-stream-10k
    # for the TCP span kernel; the 16-host stream through the window
    # kernel for it, off the main path since the span kernel; the 16-host
    # stream through the eager window for the relay kernels, 0 on
    # tcp-stream-10k since the window kernel; phold-64k-ring with
    # residency alone, through
    # the plain window, for the law kernels; phold-64k-ring with the
    # overlap for the span kernel; phold-8k through the window kernel
    # for it, off the main path since the span kernel); `launches_by_path`:
    # every path's count, each zeroed just before its run.
    main_path = {"bucket_step": "phold-64k-ring/residency",
                 "codel_head": "phold-64k-ring/residency",
                 "relay1_law": "tcp-stream-16/eager-window",
                 "relay2_law": "tcp-stream-16/eager-window",
                 "propagate": "tier10k/forced",
                 "phold_window": "phold-8k/window",
                 "phold_span": "phold-64k-ring/overlap",
                 "tcp_window": "tcp-stream-16/window",
                 "tcp_span": "tcp-stream-10k"}
    # library_ms: no single PyTorch call computes any of these laws.
    kernels = [{"name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name],
                "launches": by_path[main_path[name]][name],
                "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s.get("bound_by", "bytes"), "library_ms": None,
                "graph_ms": s.get("graph_ms"), "call_ms": s["call_ms"],
                "ms_per_round": s.get("ms_per_round"),
                "ms_4_rounds": s.get("ms_4_rounds"),
                "ms_uncached": s.get("ms_uncached"),
                "phase_clocks": s.get("clocks"),
                "team": s.get("team"), "ms_team1": s.get("ms_team1"),
                "launch_shape": s.get("launch"),
                "round_dispatch": s.get("dispatch"),
                "channels": s.get("channels"),
                "object_path": s.get("object_path"),
                "main_path": main_path[name],
                "launches_by_path": {p: n[name]
                                     for p, n in by_path.items()}}
               for name, s in stats.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
