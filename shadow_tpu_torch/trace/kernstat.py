"""The kernel observatory's channel (`kernel-sim.bin`), the port's copy
of `shadow_tpu/trace/kernstat.py`'s KernChannel.

One KS_REC per committed device span: the span's stage fires and
active-lane sums (the runners' `ks_fires` / `ks_lanes`, from the span
kernels' statistics words on the card or the plain loops' counters).
Aborted spans roll back and record nothing, so per family the records'
trips sum to the runner's `micro_iters`.  A run with no device span
writes an empty file.
"""

from __future__ import annotations

from shadow_tpu_torch.trace.events import KS_REC, KS_REC_BYTES, iter_ks_records
from shadow_tpu_torch.trace.recorder import FixedRecordChannel


class KernChannel(FixedRecordChannel):
    """The per-span stage-counter stream."""

    FILE = "kernel-sim.bin"
    REC_SIZE = KS_REC_BYTES

    def record_span(self, t: int, family: int, hosts: int, rounds: int,
                    trips: int, fires, lanes) -> None:
        if self.records >= self._cap:
            self.dropped += 1
            return
        self._chunks.append(KS_REC.pack(
            int(t), int(family), int(hosts), int(rounds), int(trips),
            *(int(x) for x in fires), *(int(x) for x in lanes)))
        self.records += 1


def family_trips(ks_bytes: bytes) -> dict:
    """{family: summed trips} over a KS_REC stream: the conservation
    law's left side."""
    out: dict = {}
    for _t, family, _h, _r, trips, _f, _l in iter_ks_records(ks_bytes):
        out[family] = out.get(family, 0) + trips
    return out
