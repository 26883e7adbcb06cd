"""The fabric observatory's channel (`fabric-sim.bin`), the port's copy
of `shadow_tpu/trace/fabricstat.py`: the writer and the report helpers.

Two record families in one artifact behind FAB_HDR: per-queue samples
(FB_REC) at sampled round boundaries, each ACTIVE host (any FB_ACT_*
bit set) in ascending host id, and per-flow lifecycle records (FCT_REC)
swept once when the artifact is written and sorted by their full field
tuple.  The engine's ring samples C++ spans and per-round rounds; both
device-span families sample on the card and emit their rows after the
import (`emit_device_rows`).  Object-path hosts are sampled here at the
per-round boundary after the engine's block (`host_queue_sample`), and
their flows swept from their sockets (`object_host_flow_rows`).  No
wall clock is read here.  `group_by_host`, `top_by_peak_depth`,
`percentile`, `receiver_rows` and `fct_table` are the readers the
reports, the Chrome export and `Manager.fabric_summary` share.
"""

from __future__ import annotations

import os

import numpy as np

from shadow_tpu_torch.trace.events import (FAB_HDR, FAB_MAGIC, FAB_VERSION,
                                           FB_ACT_CODEL, FB_ACT_LINK,
                                           FB_ACT_TB_IN, FB_ACT_TB_OUT,
                                           FB_DTYPE, FB_FIELD_NAMES,
                                           FB_REC, FB_REC_BYTES,
                                           FCT_F_COMPLETE, FCT_F_RECEIVER,
                                           FCT_REC, iter_fb_records)
from shadow_tpu_torch.trace.recorder import FixedRecordChannel

# tcp/connection.py's MSS: fct_table's segment estimate.
MSS = 1460
# tcp/connection.py's CLOSED (a completed flow).
_CLOSED = 0
# net/relay.py's pending state.
_RELAY_PENDING = 1


def host_queue_sample(host, t: int) -> tuple | None:
    """One object-path host's FB_REC field tuple at sim time `t`, or
    None when no FB_ACT_* bit is set."""
    codel = host.router._inbound
    r1 = host.relay_inet_out
    r2 = host.relay_inet_in
    eth = host.eth0
    flags = 0
    depth = len(codel)
    if depth > 0:
        flags |= FB_ACT_CODEL
    if r1._state == _RELAY_PENDING:
        flags |= FB_ACT_TB_OUT
    if r2._state == _RELAY_PENDING:
        flags |= FB_ACT_TB_IN
    if eth.packets_sent + eth.packets_received > 0:
        flags |= FB_ACT_LINK
    if not flags:
        return None
    head = codel.peek_entry()
    sojourn = (t - head[1]) if head is not None else 0
    return (t, host.id, flags, depth, codel._bytes, sojourn,
            codel.enqueued_count, codel.dropped_count,
            codel.marked_count,
            r1._bucket.peek_balance(t) if r1._bucket is not None else -1,
            r1.stalls,
            r2._bucket.peek_balance(t) if r2._bucket is not None else -1,
            r2.stalls,
            eth.packets_sent, eth.bytes_sent,
            eth.packets_received, eth.bytes_received)


def host_fabric_counters(host) -> tuple:
    """One object-path host's fabric counters, field for field the
    engine's `fabric_counters(hid)`: (enq_pkts, enq_bytes, fwd_pkts,
    fwd_bytes, drop_pkts, drop_bytes, marked, qdepth, qbytes,
    peak_depth, r1_stalls, r2_stalls, psent, bsent, precv, brecv,
    parked_pkts, parked_bytes)."""
    codel = host.router._inbound
    eth = host.eth0
    r2 = host.relay_inet_in
    parked = r2._pending_packet
    return (codel.enqueued_count, codel.enqueued_bytes,
            r2.forwarded_pkts, r2.forwarded_bytes,
            codel.dropped_count, codel.dropped_bytes,
            codel.marked_count, len(codel), codel._bytes,
            codel.peak_depth, host.relay_inet_out.stalls,
            r2.stalls, eth.packets_sent,
            eth.bytes_sent, eth.packets_received, eth.bytes_received,
            1 if parked is not None else 0,
            parked.total_size() if parked is not None else 0)


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
        """Sample every active object-path host's queues, in ascending
        host id.  Engine hosts are skipped: the engine's ring samples
        theirs."""
        for h in hosts:
            if h.plane is not None or not h.net_built():
                continue
            fields = host_queue_sample(h, t)
            if fields is not None:
                self.record(fields)

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


def flow_row(host_id: int, lport: int, rport: int, rip: int,
             conn) -> tuple | None:
    """One endpoint's FCT_REC field tuple from a (live or torn-down)
    object-path connection, or None when the flow never carried
    payload (the engine's fct_row twin)."""
    if conn.fct_first < 0:
        return None
    flags = 0
    if conn.state == _CLOSED:
        flags |= FCT_F_COMPLETE
    if conn.fct_bytes_in > conn.fct_bytes_out:
        flags |= FCT_F_RECEIVER
    return (conn.fct_first, conn.fct_last, host_id, lport, rport, rip,
            flags, conn.fct_bytes_in, conn.fct_bytes_out,
            conn.retransmit_count, conn.ce_seen)


def object_host_flow_rows(host) -> list:
    """One object-path host's flow rows: its teardown log and every
    still-associated connection with payload history (the twin of the
    engine's fct_flows sweep)."""
    from shadow_tpu_torch.trace.netstat import iter_host_tcp_sockets
    rows = list(host.fct_log)
    for s in iter_host_tcp_sockets(host):
        conn = s.conn
        if conn is None or s.local is None or s.peer is None:
            continue
        row = flow_row(host.id, s.local[1], s.peer[1], s.peer[0], conn)
        if row is not None:
            rows.append(row)
    return rows


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


def group_by_host(fb_bytes: bytes) -> dict:
    """FB records grouped by host id -> [records in time order]."""
    by_host: dict = {}
    for rec in iter_fb_records(fb_bytes):
        by_host.setdefault(rec[1], []).append(rec)
    return by_host


def top_by_peak_depth(by_host: dict, n: int) -> list:
    """Top-n host ids by peak sampled CoDel depth, ties broken by host
    id: the one ranking the fabric report and the Chrome per-link
    counter tracks both render."""
    return sorted(by_host,
                  key=lambda h: (-max(r[3] for r in by_host[h]), h))[:n]


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
