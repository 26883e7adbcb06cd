"""Device-eligibility audit: one reason code per conservative round.

The port's copy of `shadow_tpu/trace/audit.py`.  The round loop
(core/manager.py) calls `add(code, rounds)` at every accounting point
(device span commit, C++ span commit, each per-round iteration) with
exactly one EL_* code, so the counts always sum to the simulation's
total round count.
"""

from __future__ import annotations

from shadow_tpu_torch.trace.events import (EL_DEVICE_SHARDED, EL_DEVICE_SPAN,
                                           EL_ENGINE_EXCHANGE,
                                           EL_ENGINE_SPAN,
                                           EL_ENGINE_UNSHARDED, EL_N,
                                           EL_NAMES, EL_SVC_QUIESCENT)


class EligibilityAudit:
    def __init__(self):
        self.counts = [0] * EL_N

    def add(self, code: int, n: int = 1) -> None:
        self.counts[code] += n

    def total(self) -> int:
        return sum(self.counts)

    def as_dict(self) -> dict:
        """reason-name -> round count (nonzero codes only)."""
        return {EL_NAMES[i]: c for i, c in enumerate(self.counts) if c}

    def device_rounds(self) -> int:
        return (self.counts[EL_DEVICE_SPAN]
                + self.counts[EL_DEVICE_SHARDED])

    def span_rounds(self) -> int:
        return (self.device_rounds()
                + sum(self.counts[EL_ENGINE_SPAN:EL_ENGINE_SPAN + 8])
                + self.counts[EL_ENGINE_EXCHANGE]
                + self.counts[EL_ENGINE_UNSHARDED]
                + self.counts[EL_SVC_QUIESCENT])


def render_report(counts: dict, total_rounds: int) -> str:
    """The attribution table.  `counts` is reason-name -> rounds (the
    `metrics.wall.eligibility` block of sim-stats.json, or
    `EligibilityAudit.as_dict()`)."""
    lines = ["device-eligibility audit (one reason per round):"]
    accounted = 0
    width = max([len(k) for k in counts] + [12])
    for name, n in sorted(counts.items(), key=lambda kv: -kv[1]):
        pct = 100.0 * n / total_rounds if total_rounds else 0.0
        lines.append(f"  {name:<{width}}  {n:>10}  {pct:5.1f}%")
        accounted += n
    if total_rounds and accounted == total_rounds:
        lines.append(f"  {'total':<{width}}  {accounted:>10}  100.0%  "
                     f"(all rounds accounted)")
    else:
        lines.append(f"  total {accounted} != rounds {total_rounds} — "
                     f"ACCOUNTING GAP")
    return "\n".join(lines)
