"""Host CPU model (ref: src/main/host/cpu.rs:8-90).

Accounts time the host's modeled CPU has spent executing; when the
accumulated backlog exceeds a threshold, events are pushed back until
the CPU catches up (Host.execute push-back, ref host.rs:760-777) — so
per-host compute cost shapes the event timeline.

Deterministic by construction, unlike the reference: the reference
feeds this from native wall-clock execution timers (perf_timers
feature, off by default, and sim_config.rs:246 hardcodes the threshold
to None), while we feed it from the *modeled* syscall-latency
accounting (Host.syscall_latency_ns), so two runs see identical
delays.  Off by default, enabled by `experimental.host_cpu_threshold`.

All arithmetic is integer nanoseconds; `add_delay` takes native-CPU
nanoseconds and scales by the native:simulated frequency ratio with the
reference's midpoint rounding to `precision`.

The port's copy of `shadow_tpu/host/cpu.py`.
"""

from __future__ import annotations


class Cpu:
    __slots__ = ("simulated_freq", "native_freq", "threshold",
                 "precision", "_now", "_time_cpu_available")

    def __init__(self, simulated_freq: int = 1, native_freq: int = 1,
                 threshold: int | None = None,
                 precision: int | None = None):
        """threshold None => never delays; precision None => no
        rounding (both matching cpu.rs semantics)."""
        assert precision is None or precision > 0
        self.simulated_freq = simulated_freq
        self.native_freq = native_freq
        self.threshold = threshold
        self.precision = precision
        self._now = 0
        self._time_cpu_available = 0

    def update_time(self, now: int) -> None:
        self._now = now

    def add_delay(self, native_ns: int) -> None:
        cycles = native_ns * self.native_freq
        adjusted = cycles // self.simulated_freq
        if self.precision is not None:
            remainder = adjusted % self.precision
            adjusted -= remainder
            if remainder >= self.precision // 2:
                adjusted += self.precision  # round up at midpoint
        # Anchor at now: an idle CPU earns no catch-up credit (work
        # starts when the event runs).  The reference accumulates from
        # simulation start, which lets arbitrarily long idle spans
        # absorb arbitrarily large backlogs — meaningless for our
        # deterministic event-cost feed.
        if self._time_cpu_available < self._now:
            self._time_cpu_available = self._now
        self._time_cpu_available += adjusted

    def delay(self) -> int:
        """Simulated ns until this CPU can run the next event (0 when
        idle, below threshold, or the model is disabled)."""
        if self.threshold is None:
            return 0
        built_up = self._time_cpu_available - self._now
        if built_up > self.threshold:
            return built_up
        return 0
