"""Terminal status bar / progress printer: the port's copy of
`shadow_tpu/utils/status_bar.py`.

A redrawing one-line bar on a TTY, a plain line printer otherwise,
showing % complete, simulated vs real time, and sim-seconds per
wall-second.
"""

from __future__ import annotations

import sys
import time


class StatusPrinter:
    """Plain line printer (non-TTY / logging-friendly)."""

    def __init__(self, stop_time_ns: int, out=None):
        self.stop = max(stop_time_ns, 1)
        self.out = out if out is not None else sys.stderr
        self.wall_start = time.perf_counter()

    def update(self, sim_now_ns: int) -> None:
        wall = time.perf_counter() - self.wall_start
        pct = 100.0 * sim_now_ns / self.stop
        rate = (sim_now_ns / 1e9) / wall if wall > 0 else 0.0
        print(f"[shadow-tpu-torch] {pct:5.1f}% — simulated "
              f"{sim_now_ns / 1e9:.3f}s in {wall:.1f}s real ({rate:.2f} "
              f"sim-sec/wall-sec)", file=self.out, flush=True)

    def finish(self, sim_now_ns: int) -> None:
        self.update(sim_now_ns)


class StatusBar(StatusPrinter):
    """Redrawing single-line bar for interactive terminals."""

    WIDTH = 30

    def update(self, sim_now_ns: int) -> None:
        wall = time.perf_counter() - self.wall_start
        frac = min(sim_now_ns / self.stop, 1.0)
        filled = int(frac * self.WIDTH)
        bar = "=" * filled + ">" + " " * (self.WIDTH - filled)
        rate = (sim_now_ns / 1e9) / wall if wall > 0 else 0.0
        self.out.write(f"\r[{bar[:self.WIDTH]}] {frac * 100:5.1f}% "
                       f"{sim_now_ns / 1e9:8.3f}s sim  "
                       f"{rate:6.2f} sim-s/s ")
        self.out.flush()

    def finish(self, sim_now_ns: int) -> None:
        self.update(sim_now_ns)
        self.out.write("\n")
        self.out.flush()


def make_status(stop_time_ns: int, out=None):
    """Bar on a TTY, line printer otherwise."""
    stream = out if out is not None else sys.stderr
    if hasattr(stream, "isatty") and stream.isatty():
        return StatusBar(stop_time_ns, stream)
    return StatusPrinter(stop_time_ns, stream)
