"""The fabric observatory's channel (`fabric-sim.bin`), the port's copy
of `shadow_tpu/trace/fabricstat.py`'s writer half.

Two record families in one artifact behind FAB_HDR: per-queue samples
(FB_REC) at sampled round boundaries, each ACTIVE host (any FB_ACT_*
bit set) in ascending host id, and per-flow lifecycle records (FCT_REC)
swept once when the artifact is written and sorted by their full field
tuple.  The engine's ring samples C++ spans and per-round rounds; both
device-span families sample on the card and emit their rows after the
import (`emit_device_rows`).  Every host of the port is an engine host,
so the object-path walker does nothing.  No wall clock is read here.
"""

from __future__ import annotations

import os

import numpy as np

from shadow_tpu_torch.trace.events import (FAB_HDR, FAB_MAGIC, FAB_VERSION,
                                           FB_DTYPE, FB_FIELD_NAMES,
                                           FB_REC, FB_REC_BYTES,
                                           FCT_F_COMPLETE, FCT_F_RECEIVER,
                                           FCT_REC)
from shadow_tpu_torch.trace.recorder import FixedRecordChannel

# tcp/connection.py's MSS: fct_table's segment estimate.
MSS = 1460


class FabricChannel(FixedRecordChannel):
    """The per-queue sample stream; the flow records are swept at write
    time (`write` takes them)."""

    FILE = "fabric-sim.bin"
    REC_SIZE = FB_REC_BYTES

    def record(self, fields: tuple) -> None:
        """One FB_REC field tuple."""
        if self.records >= self._cap:
            self.dropped += 1
            return
        self._chunks.append(FB_REC.pack(*fields))
        self.records += 1

    def sample_object_hosts(self, hosts, t: int) -> None:
        """Sample the object-path hosts' queues.  Every host of the port
        is an engine host, which the engine's ring samples, until
        ROADMAP A2b brings object-path hosts."""
        del hosts, t

    def write(self, data_dir: str, flow_rows: list) -> None:
        """The framed artifact: header, queue samples, then the flow
        records sorted by their full field tuple."""
        fb = self.to_bytes()
        rows = sorted(flow_rows)
        fct = b"".join(FCT_REC.pack(*r) for r in rows)
        hdr = FAB_HDR.pack(FAB_MAGIC, FAB_VERSION,
                           len(fb) // FB_REC_BYTES, len(rows))
        with open(os.path.join(data_dir, self.FILE), "wb") as f:
            f.write(hdr + fb + fct)


def emit_device_rows(channel, rows: dict, n_hosts: int) -> None:
    """Pack a device span's sampled queue rows into FB_RECs on `channel`:
    per sampled round, the active hosts (flags != 0) in ascending id.
    `rows` holds numpy arrays: `fab_n`, `fab_t` (rows,), `fab_flags` and
    `fab_<field>` (rows, hosts) for FB_FIELD_NAMES."""
    if channel is None:
        return
    fn = int(rows.get("fab_n", 0))
    if fn == 0:
        return
    flags = np.asarray(rows["fab_flags"][:fn]).reshape(-1)
    sel = flags != 0
    count = int(sel.sum())
    if count == 0:
        return
    arr = np.zeros(count, dtype=np.dtype(FB_DTYPE))
    arr["t"] = np.repeat(np.asarray(rows["fab_t"][:fn], dtype=np.int64),
                         n_hosts)[sel]
    arr["host"] = np.tile(np.arange(n_hosts, dtype=np.int32), fn)[sel]
    arr["flags"] = flags[sel]
    for name in FB_FIELD_NAMES:
        arr[name] = np.asarray(rows[f"fab_{name}"][:fn],
                               dtype=np.int64).reshape(-1)[sel]
    channel.extend(arr.tobytes())


def percentile(sorted_vals: list, permille: int) -> int:
    """Nearest-rank percentile over a sorted list, in integers."""
    n = len(sorted_vals)
    if not n:
        return 0
    idx = max((permille * n + 999) // 1000 - 1, 0)
    return sorted_vals[min(idx, n - 1)]


def receiver_rows(fct_rows) -> list:
    """The receiver endpoint of every flow (both endpoints leave a
    record), or every row when no receiver records exist."""
    rows = [r for r in fct_rows if r[0] >= 0]
    recv = [r for r in rows if r[6] & FCT_F_RECEIVER]
    return recv if recv else rows


def fct_table(fct_rows) -> dict:
    """Flow-completion-time percentiles per flow class (the smaller of
    the two ports), over the receiver endpoints: {class_port: {"flows",
    "complete", "bytes", "marks", "mark_permille", "p50_ns", "p99_ns",
    "p999_ns"}}."""
    by_class: dict = {}
    for (t0, t1, _host, lport, rport, _rip, flags, bin_, bout,
         _rtx, marks) in receiver_rows(fct_rows):
        ent = by_class.setdefault(min(lport, rport), {
            "durs": [], "complete": 0, "bytes": 0, "marks": 0, "segs": 0})
        ent["durs"].append(t1 - t0)
        if flags & FCT_F_COMPLETE:
            ent["complete"] += 1
        ent["bytes"] += max(bin_, bout)
        ent["marks"] += marks
        ent["segs"] += max((max(bin_, bout) + MSS - 1) // MSS, 1)
    out: dict = {}
    for cls, ent in sorted(by_class.items()):
        durs = sorted(ent["durs"])
        out[cls] = {
            "flows": len(durs),
            "complete": ent["complete"],
            "bytes": ent["bytes"],
            "marks": ent["marks"],
            "mark_permille": (ent["marks"] * 1000) // ent["segs"],
            "p50_ns": percentile(durs, 500),
            "p99_ns": percentile(durs, 990),
            "p999_ns": percentile(durs, 999),
        }
    return out
