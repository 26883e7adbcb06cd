"""The kernel observatory's channel (`kernel-sim.bin`), the port's copy
of `shadow_tpu/trace/kernstat.py`'s KernChannel.

One KS_REC per committed device span: the span's stage fires and
active-lane sums (the runners' `ks_fires` / `ks_lanes`, from the span
kernels' statistics words on the card or the plain loops' counters).
Aborted spans roll back and record nothing, so per family the records'
trips sum to the runner's `micro_iters`.  A run with no device span
writes an empty file.

The report helpers below (`tools/trace.py kern`, the Chrome export and
`trace explain` share them) are copies of the reference's: occupancy is
lanes / (hosts x trips), and the share model gives each stage the part
of the family's measured device wall that its active-lane sum is of all
stages'.
"""

from __future__ import annotations

import sys

from shadow_tpu_torch.trace.events import (FAM_NAMES, FAM_PHOLD, FAM_TCP,
                                           KS_EXCHANGE, KS_N, KS_NAMES,
                                           KS_REC, KS_REC_BYTES,
                                           iter_ks_records)
from shadow_tpu_torch.trace.recorder import FixedRecordChannel

# The most passes a micro-op stage takes in one micro-iteration (the
# relay/reassembly double pass): the fires bound the conservation check
# holds each record to.
STAGE_MAX_PASSES = 2

# Occupancy (permille) under which a stage reads as mostly masked-out
# lanes: `trace kern`, the `trace explain` hint and the tests share it.
LOW_OCCUPANCY_PERMILLE = 50

# Span family -> the runner key of the dispatch block
# (`device_span_<key>` in metrics.wall.dispatch).
DISPATCH_KEYS = {FAM_PHOLD: "phold", FAM_TCP: "tcp"}


def family_label(family: int) -> str:
    return FAM_NAMES[family] if 0 <= family < len(FAM_NAMES) \
        else str(family)


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


def family_totals(ks_bytes: bytes) -> dict:
    """The record stream summed per family: {family: {"spans", "rounds",
    "trips", "hosts", "fires"[KS_N], "lanes"[KS_N]}}; `hosts` is the
    kernel's lane width."""
    out: dict = {}
    for _t, family, hosts, rounds, trips, fires, lanes in \
            iter_ks_records(ks_bytes):
        ent = out.setdefault(family, {
            "spans": 0, "rounds": 0, "trips": 0, "hosts": hosts,
            "fires": [0] * KS_N, "lanes": [0] * KS_N})
        ent["spans"] += 1
        ent["rounds"] += rounds
        ent["trips"] += trips
        ent["hosts"] = max(ent["hosts"], hosts)
        for i in range(KS_N):
            ent["fires"][i] += fires[i]
            ent["lanes"][i] += lanes[i]
    return out


def occupancy_permille(ent: dict, stage: int) -> int:
    """A stage's lane occupancy in permille: active-lane iterations over
    the lane slots (hosts x trips) the span loop offered, in integers.
    -1 for the exchange stage, a per-round hop whose lanes count packets
    staged (every renderer skips negatives)."""
    if stage == KS_EXCHANGE:
        return -1
    slots = ent["hosts"] * ent["trips"]
    if slots <= 0:
        return 0
    return (ent["lanes"][stage] * 1000) // slots


def low_occupancy_stages(ent: dict) -> list:
    """[(stage name, occupancy permille)] for every micro-op stage that
    fired but used under LOW_OCCUPANCY_PERMILLE of its lane slots."""
    out = []
    for i in range(KS_N):
        occ = occupancy_permille(ent, i)
        if ent["fires"][i] > 0 and 0 <= occ < LOW_OCCUPANCY_PERMILLE:
            out.append((KS_NAMES[i], occ))
    return out


def attribution(ent: dict, dispatch_wall_s: float) -> dict:
    """Per-stage cost attribution for one family: {stage: {"fires",
    "lanes", "occupancy_permille", "share_permille",
    "us_per_host_round"}}.  The measured device wall is shared out in
    proportion to each stage's active-lane sum, so the stages'
    `us_per_host_round` sum to the family's device slope."""
    total_lanes = sum(ent["lanes"]) or 1
    hr = ent["hosts"] * ent["rounds"]
    slope_us = (dispatch_wall_s * 1e6 / hr) if hr > 0 else 0.0
    out: dict = {}
    for i in range(KS_N):
        if ent["fires"][i] == 0 and ent["lanes"][i] == 0:
            continue
        out[KS_NAMES[i]] = {
            "fires": ent["fires"][i],
            "lanes": ent["lanes"][i],
            "occupancy_permille": occupancy_permille(ent, i),
            "share_permille": ent["lanes"][i] * 1000 // total_lanes,
            "us_per_host_round": round(
                slope_us * ent["lanes"][i] / total_lanes, 4),
        }
    return out


def family_warm_wall_s(dispatch: dict, family: int) -> float:
    """A family's warm device dispatch wall from the dispatch block: its
    dispatch wall less the fn cache's build wall (each built fn's first
    dispatch)."""
    key = DISPATCH_KEYS.get(family)
    if key is None:
        return 0.0
    block = dispatch.get(f"device_span_{key}") or {}
    wall = float(block.get("dispatch_wall_s", 0.0))
    build = float((dispatch.get("fn_cache") or {}).get(
        key, {}).get("build_wall_s", 0.0))
    return max(wall - build, 0.0)


def check_conservation(ks_bytes: bytes, dispatch: dict,
                       channel_dropped: int = 0) -> tuple[bool, list]:
    """The channel's law against the dispatch block: per family the
    committed trips sum exactly to the runner's `micro_iters`, and each
    record's stage fires stay inside the pass bound.  Returns (ok,
    [problem lines]); a capped channel (dropped records) may undercount
    and is held only to never overcounting."""
    problems: list = []
    fam_key = {f: f"device_span_{k}" for f, k in DISPATCH_KEYS.items()}
    for t, family, hosts, rounds, trips, fires, lanes in \
            iter_ks_records(ks_bytes):
        for i in range(KS_N):
            bound = rounds if i == KS_EXCHANGE \
                else STAGE_MAX_PASSES * trips
            if fires[i] > bound:
                problems.append(
                    f"span@{t}: stage {KS_NAMES[i]} fires {fires[i]} "
                    f"> bound {bound}")
            if lanes[i] > fires[i] * max(hosts, 1) \
                    and i != KS_EXCHANGE:
                problems.append(
                    f"span@{t}: stage {KS_NAMES[i]} lanes {lanes[i]} "
                    f"exceed fires x hosts")
    for family, ent in sorted(family_totals(ks_bytes).items()):
        key = fam_key.get(family)
        block = dispatch.get(key) if key else None
        if block is None:
            problems.append(
                f"family {family_label(family)}: no {key} dispatch "
                f"block to reconcile against")
            continue
        micro = int(block.get("micro_iters", 0))
        if channel_dropped == 0 and ent["trips"] != micro:
            problems.append(
                f"family {family_label(family)}: committed trips "
                f"{ent['trips']} != dispatch micro_iters {micro}")
        if channel_dropped and ent["trips"] > micro:
            problems.append(
                f"family {family_label(family)}: committed trips "
                f"{ent['trips']} exceed dispatch micro_iters {micro} "
                f"(capped channel may undercount, never overcount)")
    return (not problems, problems)


def render_table(ks_bytes: bytes, dispatch: dict, out=None) -> None:
    """The per-stage table `trace kern` prints: fires, lanes, occupancy
    and each stage's share of its family's measured device slope."""
    if out is None:
        out = sys.stdout
    for family, ent in sorted(family_totals(ks_bytes).items()):
        wall_s = family_warm_wall_s(dispatch, family)
        hr = ent["hosts"] * ent["rounds"]
        slope = wall_s * 1e6 / hr if hr else 0.0
        print(f"family {family_label(family)}: {ent['spans']} spans, "
              f"{ent['rounds']} rounds, {ent['trips']} micro-iters, "
              f"{ent['hosts']} lanes/stage"
              + (f", warm slope {slope:.2f} us/host/round"
                 if slope else ""), file=out)
        print(f"  {'stage':<12} {'fires':>10} {'lanes':>12} "
              f"{'occ %':>7} {'share %':>8} {'us/host/rnd':>12}",
              file=out)
        att = attribution(ent, wall_s)
        for sname in KS_NAMES:
            row = att.get(sname)
            if row is None:
                continue
            occ = row["occupancy_permille"]
            occ_s = f"{occ / 10:>7.1f}" if occ >= 0 else f"{'—':>7}"
            print(f"  {sname:<12} {row['fires']:>10} "
                  f"{row['lanes']:>12} {occ_s} "
                  f"{row['share_permille'] / 10:>8.1f} "
                  f"{row['us_per_host_round']:>12.4f}", file=out)
