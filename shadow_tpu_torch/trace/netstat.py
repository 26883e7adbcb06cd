"""Sim-netstat: the per-connection TCP telemetry channel
(`telemetry-sim.bin`), the port's copy of `shadow_tpu/trace/netstat.py`.

At every sampled round boundary (trace/recorder.grid_sampled) each live
TCP connection gives one TEL_REC, in (host, local port, peer port, peer
IP) order.  The engine's ring samples its hosts' connections (C++ spans
and per-round rounds), and the TCP device span samples its conns on the
card and emits the rows after its import (ops/tcp_span.py).  The
object-path hosts' connections are sampled here at the per-round
boundary, after the engine's block (in a homogeneous run the stream is
host-sorted either way); they are not sampled inside C++ spans, where
they run no events.  No wall clock is read here.  `iter_records`,
`group_by_conn` and `top_by_retransmits` are the readers
`tools/trace.py` and the Chrome export share.
"""

from __future__ import annotations

from shadow_tpu_torch.trace.events import TEL_REC, TEL_REC_BYTES
from shadow_tpu_torch.trace.recorder import FixedRecordChannel, grid_sampled

# Connection states left out of the samples (tcp/connection.py values: a
# CLOSED conn is dead, a LISTEN conn has no transfer state).
_CLOSED = 0
_LISTEN = 1

sampled = grid_sampled


class NetstatChannel(FixedRecordChannel):
    """The per-connection sample stream."""

    FILE = "telemetry-sim.bin"
    REC_SIZE = TEL_REC_BYTES

    def record(self, t: int, host: int, lport: int, rport: int,
               rip: int, conn) -> None:
        """One object-path connection's sample (tcp/connection.py)."""
        if self.records >= self._cap:
            self.dropped += 1
            return
        self._chunks.append(TEL_REC.pack(
            int(t), host, lport, rport, rip, conn.state,
            conn.cong.cwnd, conn.cong.ssthresh, conn.srtt, conn.rto,
            conn._rto_backoff, conn.send_buf_len, conn.recv_buf_len,
            conn.retransmit_count, conn.sacked_skip_count,
            conn.ce_seen))
        self.records += 1

    def sample_object_hosts(self, hosts, t: int) -> None:
        """Sample every object-path host's live TCP connections, in
        (host, local port, peer port, peer IP) order.  Engine hosts are
        skipped: the engine's ring samples theirs."""
        for h in hosts:
            if h.plane is not None or not h.net_built():
                continue
            rows = []
            for s in iter_host_tcp_sockets(h):
                conn = s.conn
                if conn is None or conn.state in (_CLOSED, _LISTEN):
                    continue
                if s.local is None or s.peer is None:
                    continue
                rows.append((s.local[1], s.peer[1], s.peer[0], conn))
            rows.sort(key=lambda r: r[:3])
            for lport, rport, rip, conn in rows:
                self.record(t, h.id, lport, rport, rip, conn)


def iter_host_tcp_sockets(host):
    """Every TCP socket associated on an object-path host, once each
    (a wildcard bind associates on both lo and eth0): the one walk of a
    host's live sockets, shared by the sampler, the flow records and
    the Manager's stream totals."""
    seen: dict = {}
    for iface in (host.lo, host.eth0):
        for s in iface.associated_sockets():
            if getattr(s, "conn", None) is not None \
                    or getattr(s, "listening", False):
                seen[id(s)] = s
    return seen.values()


def iter_records(buf: bytes):
    """Yield (t, host, lport, rport, rip, state, cwnd, ssthresh, srtt,
    rto, backoff, sndbuf, rcvbuf, rtx, sacks, marks) tuples."""
    for off in range(0, len(buf) - len(buf) % TEL_REC_BYTES,
                     TEL_REC_BYTES):
        yield TEL_REC.unpack_from(buf, off)


def group_by_conn(tel_bytes: bytes) -> dict:
    """Telemetry records grouped by connection:
    (host, lport, rport, rip) -> [records in time order]."""
    by_conn: dict = {}
    for rec in iter_records(tel_bytes):
        by_conn.setdefault(rec[1:5], []).append(rec)
    return by_conn


def top_by_retransmits(by_conn: dict, n: int) -> list:
    """The top-n connection keys by final retransmit count, ties broken
    by connection key: the one ranking the net report and the Chrome
    counter tracks both render."""
    return sorted(by_conn, key=lambda k: (-by_conn[k][-1][13], k))[:n]
