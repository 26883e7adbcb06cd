"""The flight recorder (a sim-time channel and a wall-time channel) and
the machinery every interval-sampled fixed-record channel shares.

The port's copy of `shadow_tpu/trace/recorder.py`.  The two channels
never mix: `SimChannel` is stamped with simulated nanoseconds and round
indices only, so `flight-sim.bin` is byte-identical across runs whenever
the recorded decisions are (pinned device-span routing, the engine
baseline); `WallChannel` holds per-phase wall aggregates and a bounded
event list, and feeds `flight-wall.json` only, never a sim byte.  No sim
channel reads a wall clock.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from shadow_tpu_torch.trace.events import FR_ROUND, REC, REC_DTYPE


class SimChannel:
    """Deterministic event stream (simulated time only).  Records append
    pre-packed, so the in-memory form is the artifact; a capacity cap
    drops (and counts) the tail at a point set by the event sequence
    alone."""

    def __init__(self, cap: int = 1 << 22):
        self._chunks: list[bytes] = []
        self._cap = cap
        self.records = 0
        self.dropped = 0

    def event(self, t: int, kind: int, a: int, b: int, c: int) -> None:
        if self.records >= self._cap:
            self.dropped += 1
            return
        self._chunks.append(REC.pack(int(t), kind, int(a), int(b),
                                     int(c)))
        self.records += 1

    def extend_engine(self, buf: bytes, engine_dropped: int,
                      reason: int) -> None:
        """Append a drained engine flight ring (the engine's fixed
        records), stamping the manager's eligibility reason onto its
        per-round records."""
        if not buf:
            self.dropped += int(engine_dropped)
            return
        arr = np.frombuffer(bytearray(buf), dtype=REC_DTYPE)
        arr["a"][arr["kind"] == FR_ROUND] = reason
        n = len(arr)
        if self.records + n > self._cap:
            keep = max(self._cap - self.records, 0)
            self.dropped += n - keep
            arr = arr[:keep]
            n = keep
        if n:
            self._chunks.append(arr.tobytes())
            self.records += n
        self.dropped += int(engine_dropped)

    def to_bytes(self) -> bytes:
        return b"".join(self._chunks)


def grid_sampled(start: int, window_end: int, interval_ns: int) -> bool:
    """The stateless grid-crossing rule of every interval-sampled
    channel: a round [start, window_end) samples iff it crosses a grid
    boundary.  The engine (tel_sample_round / fab_sample_round), the
    span loops and the span kernels apply the same rule, so the sampled
    rounds do not depend on the path that ran them."""
    iv = interval_ns if interval_ns > 0 else 1
    return start // iv != window_end // iv


class FixedRecordChannel:
    """A fixed-record sim-time channel: records append pre-packed, and a
    capacity cap drops (and counts) the tail deterministically.
    Subclasses set REC_SIZE and FILE."""

    REC_SIZE = 1
    FILE = ""

    def __init__(self, interval_ns: int = 0, cap: int = 1 << 22):
        self.interval_ns = int(interval_ns)
        self._chunks: list[bytes] = []
        self._cap = cap
        self.records = 0
        self.dropped = 0

    def sampled(self, start: int, window_end: int) -> bool:
        return grid_sampled(start, window_end, self.interval_ns)

    def extend(self, buf: bytes, producer_dropped: int = 0) -> None:
        """Append pre-packed records (an engine ring's drain or a device
        span's rows)."""
        n = len(buf) // self.REC_SIZE
        if self.records + n > self._cap:
            keep = max(self._cap - self.records, 0)
            self.dropped += n - keep
            buf = buf[:keep * self.REC_SIZE]
            n = keep
        if n:
            self._chunks.append(bytes(buf))
            self.records += n
        self.dropped += int(producer_dropped)

    def to_bytes(self) -> bytes:
        return b"".join(self._chunks)

    def write(self, data_dir: str) -> None:
        with open(os.path.join(data_dir, self.FILE), "wb") as f:
            f.write(self.to_bytes())


class WallChannel:
    """Wall-clock phase profiling: per-phase totals and a bounded
    (t0, duration, name) event list."""

    def __init__(self, max_events: int = 200_000):
        self.phases: dict[str, list] = {}  # name -> [total_ns, count]
        self.events: list = []             # (t0_rel_ns, dur_ns, name)
        self.dropped_events = 0
        self._max_events = max_events
        self._epoch = time.perf_counter_ns()

    def now(self) -> int:
        return time.perf_counter_ns()

    def add(self, name: str, dur_ns: int, t0_ns: int | None = None) -> None:
        slot = self.phases.get(name)
        if slot is None:
            slot = self.phases[name] = [0, 0]
        slot[0] += int(dur_ns)
        slot[1] += 1
        if t0_ns is not None:
            if len(self.events) < self._max_events:
                self.events.append((int(t0_ns) - self._epoch,
                                    int(dur_ns), name))
            else:
                self.dropped_events += 1

    def totals(self) -> dict:
        """name -> total seconds (rounded), for one-line summaries."""
        return {name: round(ns / 1e9, 3)
                for name, (ns, _cnt) in sorted(self.phases.items())}

    def as_dict(self) -> dict:
        return {
            "phases": {name: {"ns": ns, "count": cnt}
                       for name, (ns, cnt) in sorted(self.phases.items())},
            "events": [list(e) for e in self.events],
            "dropped_events": self.dropped_events,
        }


class FlightRecorder:
    """The two channels and the artifact writer; `sim=False` (the
    `wall` mode) records the wall phases only."""

    SIM_FILE = "flight-sim.bin"
    WALL_FILE = "flight-wall.json"

    def __init__(self, sim: bool = True, sim_cap: int = 1 << 22):
        self.sim = SimChannel(sim_cap) if sim else None
        self.wall = WallChannel()

    def write(self, data_dir: str) -> None:
        if self.sim is not None:
            with open(os.path.join(data_dir, self.SIM_FILE), "wb") as f:
                f.write(self.sim.to_bytes())
        with open(os.path.join(data_dir, self.WALL_FILE), "w") as f:
            json.dump(self.wall.as_dict(), f, indent=1)
