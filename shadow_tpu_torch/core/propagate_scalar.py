"""Scalar (CPU) cross-host packet propagation: the engine leg of the
reference's `ScalarPropagator` (`shadow_tpu/core/propagate_scalar.py`).

The engine `thread_per_core` scheduler (`native_dataplane: on`) runs
every host on the C++ engine, whose sends batch engine-side; at the
round's end the engine's bit-identical C++ propagation twin (the same
loss and latency integer math and counter-based RNG as the device
kernel) delivers them into the engine inboxes.  Nothing here touches
torch or a card: this is the CPU baseline.
"""

from __future__ import annotations

from shadow_tpu_torch.core.simtime import TIME_NEVER


class ScalarPropagator:
    def __init__(self, runahead=None):
        self.window_end = 0
        self.runahead = runahead  # dynamic-runahead feedback
        self.engine = None  # the native plane's engine (set by the Manager)

    def begin_round(self, window_start: int, window_end: int) -> None:
        self.window_end = window_end

    def finish_round(self):
        """Propagate the round's engine-batched sends through the C++
        twin; returns the least in-flight delivery time (None when
        nothing is in flight)."""
        eng = self.engine
        if not eng.round_size():
            return None
        _nf, md, ml, exports = eng.finish_round(self.window_end)
        if exports is not None:
            raise RuntimeError(
                "the engine exported packets to an object-path host, "
                "which the port never builds (ROADMAP A2b)")
        if self.runahead is not None and ml < TIME_NEVER:
            self.runahead.update_lowest_used_latency(ml)
        return md if md < TIME_NEVER else None

    def send(self, src_host, packet) -> None:
        raise NotImplementedError(
            "shadow_tpu_torch does not serve object-path sends yet: "
            "ROADMAP A2b (object-path hosts and the propagator's object "
            "leg)")

    def close(self) -> None:
        """Nothing runs in the background."""
