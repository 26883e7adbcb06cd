"""TCP connection state machine (sans-I/O).

Covers: three-way handshake (active + passive), bidirectional data
transfer with flow control (advertised windows), reno congestion control
(slow start, congestion avoidance, fast retransmit/recovery on 3 dupacks,
timeout backoff), Jacobson/Karn RTT estimation with integer-ns RTO,
out-of-order reassembly, graceful close through FIN states, TIME_WAIT,
and RST on unexpected segments.

Also modeled: window scaling (RFC 7323, ref window_scaling.rs)
negotiated via SYN options and applied to both advertised and received
windows; MSS clamping from the peer's SYN option; SACK (RFC 2018:
receiver reports reassembly runs in pure ACKs, sender marks covered
retransmit-queue entries and skips them on fast retransmit / partial
ack / RTO — ref the reference's C tcp.c SACK handling +
tcp_retransmit_tally.cc); delayed ACKs (ack every second in-order
segment or after a 40ms timer, immediate on out-of-order/FIN — Linux
quickack-style, off switch `delayed_ack=False`); Nagle (sub-MSS data
held while unacked data is in flight, off switch `nagle=False` or the
`nodelay` attribute, i.e. TCP_NODELAY); zero-window persist probes
(1-byte probe on exponential backoff while the peer advertises 0); and
a pluggable congestion-control seam with reno as the in-tree algorithm
(ref: tcp_cong.c/tcp_cong_reno.c — the reference likewise ships only
reno behind its ops table).

Timestamps (RFC 7323 TSopt, ref legacy tcp.c:141-142): every segment
carries its send time and echoes the last value received, so RTT
updates on every acked segment (suppressed during RTO backoff — Karn).
Simultaneous open is modeled (states below).  Deliberate
simplifications (documented for parity tracking in docs/PARITY.md):
no urgent data.

All arithmetic is integer (ns for time, mod-2^32 for sequence space) so
scalar and batched stepping agree bit-for-bit.

The port's copy of `shadow_tpu/tcp/connection.py`.
"""

from __future__ import annotations

from collections import deque

from shadow_tpu_torch.net.packet import ECN_CE, TcpFlags, TcpHeader

# States (ref: src/lib/tcp/src/states.rs explicit state types).
CLOSED = 0
LISTEN = 1
SYN_SENT = 2
SYN_RECEIVED = 3
ESTABLISHED = 4
FIN_WAIT_1 = 5
FIN_WAIT_2 = 6
CLOSING = 7
TIME_WAIT = 8
CLOSE_WAIT = 9
LAST_ACK = 10

STATE_NAMES = {
    CLOSED: "closed", LISTEN: "listen", SYN_SENT: "syn-sent",
    SYN_RECEIVED: "syn-received", ESTABLISHED: "established",
    FIN_WAIT_1: "fin-wait-1", FIN_WAIT_2: "fin-wait-2", CLOSING: "closing",
    TIME_WAIT: "time-wait", CLOSE_WAIT: "close-wait", LAST_ACK: "last-ack",
}

MSS = 1460  # MTU 1500 - 40 header bytes
MAX_WINDOW = 65_535
# Linux-default sysctl maxima the buffer autotuner clamps against
# (ref definitions.h CONFIG_TCP_WMEM_MAX / CONFIG_TCP_RMEM_MAX), and
# the derived ceiling (10x) a dynamically-sized connection both grows
# toward and advertises window scale for — single source of truth so
# the scale can always represent the buffer.
WMEM_MAX = 4_194_304
RMEM_MAX = 6_291_456
RMEM_CEILING = 10 * RMEM_MAX


def choose_window_scale(window_ceiling: int) -> int:
    """RFC 7323 shift chosen at SYN time, Linux-style: the smallest
    scale that can advertise the LARGEST window this buffer could ever
    reach (the autotuner's ceiling when dynamic sizing is on) — the
    scale cannot change after the handshake.  Small fixed buffers get
    scale 0 and byte-granular windows."""
    scale = 0
    while window_ceiling > MAX_WINDOW and scale < 14:
        window_ceiling >>= 1
        scale += 1
    return scale
MAX_SACK_BLOCKS = 3             # with timestamps elided, 3 fit on wire

INIT_RTO_NS = 1_000_000_000     # RFC 6298 initial
MIN_RTO_NS = 200_000_000        # Linux-style floor
MAX_RTO_NS = 60_000_000_000
TIME_WAIT_NS = 60_000_000_000   # 2 * MSL with MSL=30s
DUPACK_THRESHOLD = 3
DELACK_NS = 40_000_000          # Linux TCP_DELACK_MIN

# DCTCP (RFC 8257, Linux tcp_dctcp.c shape; netplane.cpp twins).  All
# fixed-point so Python/C++/JAX compute the identical alpha: alpha is
# scaled by 2**DCTCP_SHIFT, the EWMA gain g is 1/2**DCTCP_G_SHIFT
# (Linux dctcp_shift_g default), and the per-window update is
#   alpha = min(MAX, alpha - (alpha >> G_SHIFT)
#               + (ce_bytes << (SHIFT - G_SHIFT)) // max(tot_bytes, 1))
# with the cwnd reduction on a congestion echo
#   cwnd = max(cwnd - ((cwnd * alpha) >> (SHIFT + 1)), 2 * mss).
DCTCP_SHIFT = 10
DCTCP_G_SHIFT = 4
DCTCP_MAX_ALPHA = 1024          # == 1 << DCTCP_SHIFT (alpha == 1.0)
# Congestion-controller ids (per-host `tcp: {cc: ...}` config; the SoA
# kernel's static c_cc column and the engine's TcpConn::cc use these).
CC_RENO = 0
CC_DCTCP = 1

_SEQ_MOD = 1 << 32


class RenoCongestion:
    """NewReno ops behind the pluggable seam (ref: tcp_cong.c ops table
    + tcp_cong_reno.c).  Owns cwnd/ssthresh; the connection reports ack
    and loss events."""

    name = "reno"

    def __init__(self, mss: int = MSS):
        self.mss = mss
        self.cwnd = 10 * mss  # RFC 6928 IW10
        # Infinite until the first loss event (ref tcp_cong_reno.c
        # ca_reno_init_: INT32_MAX; Linux TCP_INFINITE_SSTHRESH) —
        # slow start must not stop at an arbitrary ceiling.
        self.ssthresh = (1 << 31) - 1

    def on_new_ack(self, acked: int) -> None:
        if self.cwnd < self.ssthresh:
            # Slow start with ABC (RFC 3465, L=2*SMSS): delayed acks
            # covering two segments still double cwnd per RTT.
            self.cwnd += min(acked, 2 * self.mss)
        else:
            self.cwnd += max(1, self.mss * self.mss // self.cwnd)  # AIMD

    def on_fast_retransmit(self, flight: int) -> None:
        self.ssthresh = max(flight // 2, 2 * self.mss)
        self.cwnd = self.ssthresh + 3 * self.mss

    def on_recovery_dupack(self) -> None:
        self.cwnd += self.mss  # inflation

    def on_exit_recovery(self) -> None:
        self.cwnd = self.ssthresh

    def on_rto(self, flight: int) -> None:
        self.ssthresh = max(flight // 2, 2 * self.mss)
        self.cwnd = self.mss

    def on_ecn_reduce(self, flight: int) -> None:
        """RFC 3168 6.1.2 congestion response to ECE: same multiplica-
        tive decrease as a fast retransmit, but nothing retransmits."""
        self.ssthresh = max(flight // 2, 2 * self.mss)
        self.cwnd = self.ssthresh


class DctcpCongestion(RenoCongestion):
    """DCTCP (RFC 8257): reno growth, but the ECE response scales the
    cwnd cut by alpha — the EWMA fraction of acked bytes that carried a
    congestion echo — instead of halving.  All state is integer
    fixed-point (alpha scaled by 2**DCTCP_SHIFT) so the engine's
    TcpConn and the device kernel's conn columns compute bit-identical
    values.  The window accounting (win_end in sequence space) lives
    here too; the owning connection feeds it from _on_ack."""

    name = "dctcp"

    def __init__(self, mss: int = MSS):
        super().__init__(mss)
        self.alpha = DCTCP_MAX_ALPHA  # start fully conservative
        self.ce_acked = 0             # echo-marked bytes this window
        self.tot_acked = 0            # all acked bytes this window
        self.win_end = 0              # seq: conn sets to iss at birth

    def on_ecn_reduce(self, flight: int) -> None:
        cut = (self.cwnd * self.alpha) >> (DCTCP_SHIFT + 1)
        self.cwnd = max(self.cwnd - cut, 2 * self.mss)
        self.ssthresh = self.cwnd


CONGESTION_ALGOS = {"reno": RenoCongestion, "dctcp": DctcpCongestion}


def seq_add(a: int, b: int) -> int:
    return (a + b) % _SEQ_MOD


def seq_sub(a: int, b: int) -> int:
    """Signed distance a-b in sequence space."""
    d = (a - b) % _SEQ_MOD
    return d - _SEQ_MOD if d >= _SEQ_MOD // 2 else d


def seq_lt(a: int, b: int) -> bool:
    return seq_sub(a, b) < 0


def seq_leq(a: int, b: int) -> bool:
    return seq_sub(a, b) <= 0


class TcpConnection:
    """One direction-pair of TCP state. Emitted segments accumulate in
    `outbox` as (TcpHeader, payload_bytes); the owner drains it."""

    def __init__(self, iss: int, recv_buf_max: int = 174_760,
                 send_buf_max: int = 131_072, congestion: str = "reno",
                 delayed_ack: bool = True, nagle: bool = True,
                 window_ceiling: int | None = None, ecn: bool = False):
        self.state = CLOSED
        self.iss = iss % _SEQ_MOD
        # SYN-time scale choice covers the largest window the receive
        # buffer can ever grow to (autotuning ceiling when enabled).
        self._wscale_offer = choose_window_scale(
            window_ceiling if window_ceiling is not None else recv_buf_max)

        # Send side.
        self.snd_una = self.iss
        self.snd_nxt = self.iss
        self.snd_wnd = MSS  # until the peer advertises
        self.send_buf: deque = deque()   # byte chunks awaiting segmentation
        self.send_buf_len = 0
        self.send_buf_max = send_buf_max
        self.snd_fin_pending = False     # app closed; FIN after data drains
        self.fin_seq: int | None = None  # seq consumed by our FIN
        # Retransmission queue: list of [seq, payload, is_fin, sent_at,
        # retransmitted, sacked] — ordered by seq.
        self.rtx: list = []

        # Receive side.
        self.irs = 0
        self.rcv_nxt = 0
        self.recv_buf: deque = deque()
        self.recv_buf_len = 0
        self.recv_buf_max = recv_buf_max
        self.reassembly: dict[int, bytes] = {}  # seq -> payload (future)
        self.peer_fin_seq: int | None = None   # set once the FIN is
        self.pending_fin_seq: int | None = None  # ...processed in order

        # Window scaling (RFC 7323; ref window_scaling.rs): we always
        # offer our chosen scale; active only if the peer offers too.
        self.our_wscale = 0    # shift applied to windows we advertise
        self.peer_wscale = 0   # shift applied to windows we receive
        self.eff_mss = MSS     # clamped by the peer's MSS option

        # Delayed ACK (RFC 1122 4.2.3.2) + Nagle (RFC 896).
        self.delayed_ack = delayed_ack
        self.nagle = nagle
        self.nodelay = False           # TCP_NODELAY
        self._delack_deadline: int | None = None
        self._segs_since_ack = 0

        # Zero-window persist probing.
        self._persist_deadline: int | None = None
        self._persist_interval = 0

        # Congestion control behind the pluggable seam (tcp_cong.c).
        self.cong = CONGESTION_ALGOS[congestion]()
        self.dupacks = 0
        self.in_fast_recovery = False
        self.recover = self.iss

        # ECN (RFC 3168; netplane.cpp TcpConn twins).  `ecn_on` is the
        # per-host config wish; `ecn_active` is negotiated at the
        # handshake (ECN-setup SYN carries ECE|CWR, the SYN-ACK
        # answers with ECE).  The receiver latches `ece_latch` on a
        # CE-marked arrival and echoes ECE on every ACK until a CWR
        # arrives; the sender reacts to ECE at most once per window
        # (`ecn_cwr_end`) and announces the cut with CWR on its next
        # fresh data segment (`cwr_pending`).
        self.ecn_on = bool(ecn)
        self.ecn_active = False
        self.ece_latch = False
        self.cwr_pending = False
        self.ecn_cwr_end = self.iss
        if isinstance(self.cong, DctcpCongestion):
            self.cong.win_end = self.iss

        # RTT/RTO (integer ns, RFC 6298 + RFC 7323 timestamps).  Every
        # segment carries its send time; the receiver echoes the last
        # value it saw, so ANY acked segment yields an RTT sample —
        # the reference's legacy-stack behavior (tcp.c:141-142,
        # 2356-2358: per-segment timestampValue/timestampEcho, sampling
        # suppressed while in RTO backoff, Karn via the echo discipline).
        self.srtt = 0
        self.rttvar = 0
        self.rto = INIT_RTO_NS
        self.rto_deadline: int | None = None
        self.time_wait_deadline: int | None = None
        self._ts_recent = 0      # last timestamp value received
        self._rto_backoff = 0    # RTO doublings since last fwd progress

        self.outbox: deque = deque()  # (TcpHeader, payload)
        self.error: str | None = None  # set on RST / fatal
        self.syn_retries = 0

        # Counters for stats/debug.
        self.retransmit_count = 0
        self.segments_sent = 0
        self.segments_received = 0
        self.sacked_skip_count = 0  # retransmissions avoided via SACK
        # Receiver discards (sim-netstat TEL_REASM_FULL /
        # TEL_RECVWIN_TRUNC; netplane.cpp twins): payload the receiver
        # refused — a segment beyond the reassembly window, or in-order
        # bytes past the receive buffer.  The socket layer folds the
        # per-packet delta into the host's drop-cause counters.
        self.reasm_discards = 0
        self.rcvwin_trunc = 0
        # Fabric-observatory flow lifecycle (netplane.cpp TcpConn
        # twins; trace/fabricstat.py packs them into FCT_REC records):
        # first/last simulated ns any payload byte was FIRST-sent or
        # delivered in order on this endpoint, plus the byte counts.
        # Retransmissions touch neither — bytes_out is the flow size.
        self.fct_first = -1
        self.fct_last = -1
        self.fct_bytes_in = 0
        self.fct_bytes_out = 0
        # Per-flow ECN mark-rate telemetry (netplane.cpp TcpConn twin;
        # the `marks` column of both TEL_REC and FCT_REC): cumulative
        # CE-marked arrivals this endpoint OBSERVED — counted exactly
        # where the RFC 3168 receiver latches ECE, so all three
        # execution paths agree byte-for-byte.
        self.ce_seen = 0

    def _fct_touch(self, nbytes: int, now: int, inbound: bool) -> None:
        if self.fct_first < 0:
            self.fct_first = now
        self.fct_last = now
        if inbound:
            self.fct_bytes_in += nbytes
        else:
            self.fct_bytes_out += nbytes

    # Congestion variables live on the algorithm object; these views
    # keep call sites and tests readable.
    @property
    def cwnd(self) -> int:
        return self.cong.cwnd

    @property
    def ssthresh(self) -> int:
        return self.cong.ssthresh

    # ------------------------------------------------------------------
    # App-side API
    # ------------------------------------------------------------------

    def open_active(self, now: int) -> None:
        """connect(): emit SYN (states.rs Init->SynSent). The SYN offers
        our MSS and window-scale options (RFC 7323: the scale only
        activates if the peer's SYN offers one too), and — with ecn_on
        — the RFC 3168 ECN-setup flags ECE|CWR."""
        assert self.state == CLOSED
        self.state = SYN_SENT
        flags = TcpFlags.SYN
        if self.ecn_on:
            flags |= TcpFlags.ECE | TcpFlags.CWR
        self._emit(flags, seq=self.iss, payload=b"", now=now,
                   track=True, mss=MSS, window_scale=self._wscale_offer)
        self.snd_nxt = seq_add(self.iss, 1)

    def open_passive(self) -> None:
        assert self.state == CLOSED
        self.state = LISTEN

    def send_space(self) -> int:
        return self.send_buf_max - self.send_buf_len

    def write(self, data: bytes, now: int) -> int:
        """Append app data; returns bytes accepted (0 = would block)."""
        if self.state not in (ESTABLISHED, CLOSE_WAIT):
            raise ConnectionError(f"write in {STATE_NAMES[self.state]}")
        if self.snd_fin_pending:
            raise ConnectionError("write after close")
        n = min(len(data), self.send_space())
        if n > 0:
            self.send_buf.append(bytes(data[:n]))
            self.send_buf_len += n
            self._push_data(now)
        return n

    def readable_bytes(self) -> int:
        return self.recv_buf_len

    def at_eof(self) -> bool:
        return (self.peer_fin_seq is not None and self.recv_buf_len == 0
                and not self.reassembly)

    def peek(self, n: int) -> bytes:
        """MSG_PEEK: copy up to n readable bytes without consuming
        (header sniffing — wget peeks the HTTP response)."""
        out = bytearray()
        for chunk in self.recv_buf:
            if n <= 0:
                break
            take = chunk[:n]
            out += take
            n -= len(take)
        return bytes(out)

    def read(self, n: int, now: int) -> bytes:
        window_before = self._recv_window()
        out = bytearray()
        while n > 0 and self.recv_buf:
            chunk = self.recv_buf[0]
            if len(chunk) <= n:
                out += chunk
                n -= len(chunk)
                self.recv_buf.popleft()
            else:
                out += chunk[:n]
                self.recv_buf[0] = chunk[n:]
                n = 0
        if out:
            self.recv_buf_len -= len(out)
            # Window-update ACK only when the window was pinched shut —
            # an ACK per read() would flood the wire with pure acks.
            if window_before < MSS and self._recv_window() >= MSS and \
                    self.state in (ESTABLISHED, FIN_WAIT_1, FIN_WAIT_2):
                self._emit_ack(now)
        return bytes(out)

    def close(self, now: int) -> None:
        """App close: FIN once the send buffer drains
        (states.rs Established->FinWait1 / CloseWait->LastAck)."""
        if self.state in (CLOSED, LISTEN):
            self.state = CLOSED
            return
        if self.state == SYN_SENT:
            self.state = CLOSED
            self.rto_deadline = None
            self.rtx.clear()
            return
        if self.snd_fin_pending or self.fin_seq is not None:
            return
        self.snd_fin_pending = True
        if self.state == ESTABLISHED:
            self.state = FIN_WAIT_1
        elif self.state == CLOSE_WAIT:
            self.state = LAST_ACK
        self._push_data(now)

    def abort(self, now: int) -> None:
        """RST out, state torn down."""
        if self.state not in (CLOSED, LISTEN, TIME_WAIT):
            self._emit(TcpFlags.RST | TcpFlags.ACK, seq=self.snd_nxt,
                       payload=b"", now=now)
        self.state = CLOSED
        self.error = self.error or "aborted"
        self.rto_deadline = None
        self._delack_deadline = None
        self._persist_deadline = None

    # ------------------------------------------------------------------
    # Timers
    # ------------------------------------------------------------------

    def next_timer_expiry(self) -> int | None:
        candidates = [t for t in (self.rto_deadline,
                                  self.time_wait_deadline,
                                  self._delack_deadline,
                                  self._persist_deadline) if t is not None]
        return min(candidates) if candidates else None

    def on_timer(self, now: int) -> None:
        if self.time_wait_deadline is not None \
                and now >= self.time_wait_deadline:
            self.time_wait_deadline = None
            if self.state == TIME_WAIT:
                self.state = CLOSED
        if self._delack_deadline is not None \
                and now >= self._delack_deadline:
            if self.state in (CLOSED, LISTEN):
                self._delack_deadline = None
            else:
                self._emit_ack(now)  # clears the deadline
        if self._persist_deadline is not None \
                and now >= self._persist_deadline:
            self._on_persist(now)
        if self.rto_deadline is not None and now >= self.rto_deadline:
            self._on_rto(now)

    def _on_persist(self, now: int) -> None:
        """Zero-window probe: 1 byte of new data past the window edge.
        Linux-style exponential backoff; the probe is tracked in the rtx
        queue so an opening window acks it normally."""
        self._persist_deadline = None
        if self.snd_wnd > 0 or not self.send_buf or self.rtx:
            return
        chunk = self._take_from_send_buf(1)
        self._emit(self._data_flags(), seq=self.snd_nxt,
                   payload=chunk, now=now, track=True)
        self.snd_nxt = seq_add(self.snd_nxt, 1)
        self._fct_touch(1, now, inbound=False)
        self._persist_interval = min(self._persist_interval * 2
                                     or self.rto, MAX_RTO_NS)
        self._persist_deadline = now + self._persist_interval

    def _on_rto(self, now: int) -> None:
        """Retransmission timeout (RFC 6298 5.4-5.7 + reno reset)."""
        if not self.rtx:
            self.rto_deadline = None
            return
        # Handshake gives up after 6 backoffs (Linux tcp_syn_retries):
        # connecting to a dead/closed port must fail, not hang forever.
        if self.state in (SYN_SENT, SYN_RECEIVED):
            self.syn_retries += 1
            if self.syn_retries > 6:
                self.error = "connection timed out"
                self.state = CLOSED
                self.rto_deadline = None
                self.rtx.clear()
                return
        flight = seq_sub(self.snd_nxt, self.snd_una)
        self.cong.on_rto(flight)
        self.dupacks = 0
        self.in_fast_recovery = False
        # SACK reneging (RFC 2018 8; ref tcp.c clears its scoreboard):
        # after an RTO the receiver may have discarded data it SACKed,
        # so forget every mark and retransmit from the head — a mark
        # kept here could skip a hole the receiver no longer holds,
        # stalling the transfer forever.
        for seg in self.rtx:
            seg[5] = False
        self.rto = min(self.rto * 2, MAX_RTO_NS)
        self._rto_backoff += 1  # suppress RTT sampling until fwd progress
        self._retransmit_one(now)
        self.rto_deadline = now + self.rto

    # ------------------------------------------------------------------
    # Packet ingress
    # ------------------------------------------------------------------

    def on_packet(self, hdr: TcpHeader, payload: bytes, now: int,
                  ecn: int = 0) -> None:
        self.segments_received += 1
        if self.state == CLOSED:
            return
        if hdr.flags & TcpFlags.RST:
            self._on_rst(hdr)
            return
        # RFC 3168 receiver: a CWR ends the echo episode, a CE-marked
        # arrival (re)starts it — in that order, so a segment carrying
        # both leaves the latch set.  `ecn` is the packet's IP-header
        # codepoint (the socket layer threads it through; the queues
        # rewrote ECT(0) to CE when the marking law fired).
        if self.ecn_active:
            if hdr.flags & TcpFlags.CWR:
                self.ece_latch = False
            if ecn == ECN_CE:
                self.ece_latch = True
                self.ce_seen += 1
        # RFC 7323 timestamp processing on EVERY segment (ref
        # tcp.c:2356-2358, plus the TS.Recent update rule the RFC adds:
        # only a segment covering the last ack point may update the
        # value to echo — a late-arriving old duplicate must not wind
        # ts_recent back, or its dup-ack's echo would feed an
        # RTO-stall-sized sample into srtt).  Values are stamped as
        # now+1 so a segment sent at sim time 0 still carries the
        # option (0 = absent).
        if hdr.timestamp and self.state != SYN_SENT:
            # (SYN_SENT records in its handler, after rcv_nxt exists.)
            seg_span = len(payload) \
                + (1 if hdr.flags & TcpFlags.FIN else 0)
            if seg_span == 0:
                seg_span = 1  # pure ACK sits at the ack point
            if seq_leq(hdr.seq, self.rcv_nxt) and \
                    seq_lt(self.rcv_nxt, seq_add(hdr.seq, seg_span)):
                self._ts_recent = hdr.timestamp
        # RTTM rule: sample only from a segment that ACKNOWLEDGES NEW
        # DATA — an echo held across an application-idle gap must not
        # feed an idle-sized sample into srtt.
        if hdr.timestamp_echo and self._rto_backoff == 0 \
                and (hdr.flags & TcpFlags.ACK) \
                and seq_lt(self.snd_una, hdr.ack) \
                and seq_leq(hdr.ack, self.snd_nxt):
            self._update_rtt(now - (hdr.timestamp_echo - 1))
        if self.state == LISTEN:
            # Owner (listener socket) is responsible for spawning child
            # connections; a LISTEN connection itself ignores non-SYN.
            return
        if self.state == SYN_SENT:
            self._on_packet_syn_sent(hdr, now)
            return
        # --- synchronized states ---
        if hdr.flags & TcpFlags.SYN:
            if self.state == SYN_RECEIVED and \
                    (hdr.flags & TcpFlags.ACK) and \
                    hdr.ack == self.snd_nxt:
                # Simultaneous open completing: the peer's SYN-ACK acks
                # our SYN.  Handle inline — _on_ack would scale the
                # window, but SYN segments carry UNSCALED windows
                # (RFC 7323 2.2), same as _on_packet_syn_sent.
                self.snd_una = hdr.ack
                self.snd_wnd = hdr.window
                self._clear_acked()
                self.state = ESTABLISHED
                self._emit_ack(now)
                self._push_data(now)
                return
            if self.state == SYN_RECEIVED and hdr.seq == seq_sub(
                    self.rcv_nxt, 1) % _SEQ_MOD:
                # Re-sent SYN (our SYN-ACK was lost): re-answer it.
                self._emit_synack(now)
                return
            self._emit_ack(now)
            return
        if not (hdr.flags & TcpFlags.ACK):
            return
        self._on_ack(hdr, now, is_pure_ack=not payload
                     and not (hdr.flags & TcpFlags.FIN))
        if payload:
            self._on_data(hdr.seq, payload, now)
        if hdr.flags & TcpFlags.FIN:
            self._on_fin(hdr, payload, now)

    def accept_syn(self, hdr: TcpHeader, now: int) -> None:
        """Passive open: called on a child connection created by a
        listener for an incoming SYN. Negotiates MSS and window scaling
        from the SYN's options (windows in SYN segments are unscaled,
        RFC 7323 2.2)."""
        assert self.state in (CLOSED, LISTEN)
        self.irs = hdr.seq
        self.rcv_nxt = seq_add(hdr.seq, 1)
        if hdr.timestamp:
            self._ts_recent = hdr.timestamp  # SYN's value: echo in SYN-ACK
        self.snd_wnd = hdr.window
        # ECN-setup SYN (RFC 3168 6.1.1): accept iff we want ECN too.
        self.ecn_active = self.ecn_on and (
            hdr.flags & (TcpFlags.ECE | TcpFlags.CWR)
        ) == (TcpFlags.ECE | TcpFlags.CWR)
        self._negotiate_options(hdr)
        self.state = SYN_RECEIVED
        self._emit_synack(now)
        self.snd_nxt = seq_add(self.iss, 1)

    def _negotiate_options(self, hdr: TcpHeader) -> None:
        if hdr.mss is not None:
            self.eff_mss = min(MSS, hdr.mss)
            # Negotiation happens before any data flows: rebuild the
            # congestion state so IW10/ssthresh are sized for the real
            # MSS rather than the 1460-byte default.
            self.cong = type(self.cong)(mss=self.eff_mss)
            if isinstance(self.cong, DctcpCongestion):
                self.cong.win_end = self.iss  # nothing acked yet
        if hdr.window_scale is not None:
            self.our_wscale = self._wscale_offer
            self.peer_wscale = min(hdr.window_scale, 14)

    def _emit_synack(self, now: int) -> None:
        flags = TcpFlags.SYN | TcpFlags.ACK
        if self.ecn_active:
            flags |= TcpFlags.ECE  # ECN-setup SYN-ACK (RFC 3168 6.1.1)
        self._emit(flags, seq=self.iss, payload=b"",
                   now=now, track=(self.snd_nxt == self.iss), mss=MSS,
                   window_scale=(self._wscale_offer if self.our_wscale
                                 else None))

    def _on_packet_syn_sent(self, hdr: TcpHeader, now: int) -> None:
        if (hdr.flags & TcpFlags.ACK) and hdr.ack != self.snd_nxt:
            # RFC 793 SYN-SENT first check: an unacceptable ACK —
            # with OR without SYN (a delayed SYN-ACK from a previous
            # incarnation of a reused 4-tuple) — answers
            # <SEQ=SEG.ACK><CTL=RST>; our state is unchanged so the
            # handshake can still complete on retry.
            self._emit(TcpFlags.RST, seq=hdr.ack, payload=b"", now=now)
            return
        if (hdr.flags & (TcpFlags.SYN | TcpFlags.ACK)) == \
                (TcpFlags.SYN | TcpFlags.ACK):
            self.irs = hdr.seq
            self.rcv_nxt = seq_add(hdr.seq, 1)
            if hdr.timestamp:
                self._ts_recent = hdr.timestamp
            self.snd_una = hdr.ack
            self.snd_wnd = hdr.window
            # ECN-setup SYN-ACK carries ECE without CWR (RFC 3168
            # 6.1.1); anything else leaves the connection not-ECT.
            self.ecn_active = self.ecn_on \
                and bool(hdr.flags & TcpFlags.ECE) \
                and not (hdr.flags & TcpFlags.CWR)
            self._negotiate_options(hdr)
            self._clear_acked()
            self.state = ESTABLISHED
            self._emit_ack(now)
        elif hdr.flags & TcpFlags.SYN:
            # Simultaneous open (RFC 793 fig. 8; ref states.rs models
            # SynSent -> SynReceived): both ends sent SYNs that crossed.
            # Adopt the peer's ISN, answer SYN-ACK, and wait in
            # SYN_RECEIVED for the ack of our own SYN.  Our original
            # SYN stays on the rtx queue: if this SYN-ACK is lost, the
            # bare-SYN retransmit re-triggers the peer's own re-ack.
            self.irs = hdr.seq
            self.rcv_nxt = seq_add(hdr.seq, 1)
            if hdr.timestamp:
                self._ts_recent = hdr.timestamp
            self.snd_wnd = hdr.window
            self._negotiate_options(hdr)
            self.state = SYN_RECEIVED
            self._emit_synack(now)

    def _on_rst(self, hdr: TcpHeader) -> None:
        self.error = "connection reset"
        self.state = CLOSED
        self.rto_deadline = None
        self.time_wait_deadline = None
        self._delack_deadline = None
        self._persist_deadline = None

    def _on_ack(self, hdr: TcpHeader, now: int,
                is_pure_ack: bool = True) -> None:
        ack = hdr.ack
        if seq_lt(self.snd_nxt, ack):
            # Acks something we never sent.
            self._emit_ack(now)
            return
        # Post-handshake windows arrive scaled (RFC 7323 2.2: every
        # segment except the SYN itself).
        wnd = hdr.window << self.peer_wscale
        window_changed = wnd != self.snd_wnd
        self.snd_wnd = wnd
        if wnd > 0 and self._persist_deadline is not None:
            self._persist_deadline = None
            self._persist_interval = 0
        if hdr.sack_blocks:
            self._mark_sacked(hdr.sack_blocks)
        # ECN sender side (RFC 3168 6.1.2 + RFC 8257 3.3), BEFORE the
        # new-ack/dupack dispatch so snd_una still holds the pre-ack
        # value — the C++ TcpConn and the SoA kernel mirror this exact
        # sequence so the arithmetic is bit-identical on every path.
        ecn_reduced = False
        if self.ecn_active:
            ece = bool(hdr.flags & TcpFlags.ECE)
            if isinstance(self.cong, DctcpCongestion) \
                    and seq_lt(self.snd_una, ack):
                c = self.cong
                acked = seq_sub(ack, self.snd_una)
                c.tot_acked += acked
                if ece:
                    c.ce_acked += acked
                if seq_lt(c.win_end, ack):
                    # Window boundary: fold this window's echo fraction
                    # into alpha (fixed-point EWMA, gain 1/2**G_SHIFT).
                    c.alpha = min(
                        DCTCP_MAX_ALPHA,
                        c.alpha - (c.alpha >> DCTCP_G_SHIFT)
                        + (c.ce_acked << (DCTCP_SHIFT - DCTCP_G_SHIFT))
                        // max(c.tot_acked, 1))
                    c.ce_acked = 0
                    c.tot_acked = 0
                    c.win_end = self.snd_nxt
            if ece and not self.in_fast_recovery \
                    and seq_lt(self.ecn_cwr_end, ack):
                # At most one cut per window; announce it with CWR on
                # the next fresh data segment.
                self.cong.on_ecn_reduce(self._flight())
                self.ecn_cwr_end = self.snd_nxt
                self.cwr_pending = True
                ecn_reduced = True
        if seq_lt(self.snd_una, ack):
            self._handle_new_ack(ack, now, ecn_reduced=ecn_reduced)
        elif ack == self.snd_una and self.rtx and is_pure_ack \
                and not window_changed:
            # RFC 5681: only payload-free, window-unchanged acks count as
            # duplicates — a peer streaming its own data repeats our ack
            # number without implying loss.
            self._handle_dupack(now)
        # Handshake completion for passive side.
        if self.state == SYN_RECEIVED and seq_lt(self.iss, ack):
            self.state = ESTABLISHED
        self._advance_close_states(now)
        self._push_data(now)

    def _handle_new_ack(self, ack: int, now: int,
                        ecn_reduced: bool = False) -> None:
        acked = seq_sub(ack, self.snd_una)
        self.snd_una = ack
        self.dupacks = 0
        self._clear_acked()
        self._rto_backoff = 0  # forward progress re-enables sampling
        if self.srtt > 0:
            # Forward progress undoes exponential RTO backoff.  Without
            # this, sustained loss walks rto to the 60s cap and every
            # remaining hole costs a full max-RTO — transfers that
            # should take seconds take hours.
            self.rto = min(max(self.srtt + max(4 * self.rttvar, 1_000_000),
                               MIN_RTO_NS), MAX_RTO_NS)
        if self.in_fast_recovery:
            if seq_lt(self.recover, ack) or ack == self.recover:
                self.in_fast_recovery = False
                self.cong.on_exit_recovery()
            else:
                # Partial ack: retransmit next hole immediately.
                self._retransmit_one(now)
        elif not ecn_reduced:
            # An ack that just triggered the ECN cut must not also
            # grow the window it shrank.
            self.cong.on_new_ack(acked)
        # RTO restart (RFC 6298 5.3).
        self.rto_deadline = (now + self.rto) if self.rtx else None

    def _handle_dupack(self, now: int) -> None:
        self.dupacks += 1
        if self.in_fast_recovery:
            self.cong.on_recovery_dupack()
            self._push_data(now)
        elif self.dupacks == DUPACK_THRESHOLD:
            flight = seq_sub(self.snd_nxt, self.snd_una)
            self.cong.on_fast_retransmit(flight)
            self.in_fast_recovery = True
            self.recover = self.snd_nxt
            self._retransmit_one(now)

    # --- SACK scoreboard (RFC 2018; ref tcp_retransmit_tally.cc) ---

    def _mark_sacked(self, blocks) -> None:
        """Mark rtx entries wholly covered by a reported block. Blocks
        are (start, end) in the peer's receive-sequence space."""
        for seg in self.rtx:
            if seg[5]:
                continue
            seq = seg[0]
            end = seq_add(seq, len(seg[1]) + (1 if seg[2] else 0)
                          + (1 if seg[1] == b"" and not seg[2] else 0))
            for start, stop in blocks:
                if seq_leq(start, seq) and seq_leq(end, stop):
                    seg[5] = True
                    self.sacked_skip_count += 1
                    break

    def _retransmit_one(self, now: int) -> None:
        """Retransmit the first hole: the earliest rtx entry the peer has
        not SACKed (falling back to the head if everything is marked —
        the peer may have renegged)."""
        if not self.rtx:
            return
        seg = next((s for s in self.rtx if not s[5]), self.rtx[0])
        seg[3] = now
        seg[4] = True
        self.retransmit_count += 1
        self._transmit_segment(seg[0], seg[1], seg[2], now)

    def _clear_acked(self) -> None:
        """Drop fully-acked segments from the rtx queue.  (RTT comes
        from timestamp echoes, not from rtx entries.)"""
        while self.rtx:
            seq, payload, is_fin, sent_at, retransmitted, sacked = self.rtx[0]
            # Sequence space consumed: data bytes, or 1 for SYN/FIN.
            end = seq_add(seq, len(payload) + (1 if is_fin else 0)
                          + (1 if payload == b"" and not is_fin else 0))
            if seq_leq(end, self.snd_una):
                self.rtx.pop(0)
            else:
                break

    def _update_rtt(self, sample: int) -> None:
        if sample <= 0:
            sample = 1
        if self.srtt == 0:
            self.srtt = sample
            self.rttvar = sample // 2
        else:
            err = abs(self.srtt - sample)
            self.rttvar = (3 * self.rttvar + err) // 4
            self.srtt = (7 * self.srtt + sample) // 8
        self.rto = self.srtt + max(4 * self.rttvar, 1_000_000)
        self.rto = min(max(self.rto, MIN_RTO_NS), MAX_RTO_NS)

    # ------------------------------------------------------------------
    # Data ingress / reassembly
    # ------------------------------------------------------------------

    def _recv_window(self) -> int:
        """True receive window in bytes, bounded by what the negotiated
        scale can represent on the wire."""
        cap = MAX_WINDOW << self.our_wscale
        return min(cap, max(0, self.recv_buf_max - self.recv_buf_len))

    def _wire_window(self, flags: int) -> int:
        """The 16-bit window field: scaled except in SYN segments."""
        win = self._recv_window()
        if flags & TcpFlags.SYN:
            return min(win, MAX_WINDOW)
        return min(win >> self.our_wscale, MAX_WINDOW)

    def _sack_blocks(self) -> tuple:
        """Contiguous runs held in reassembly, as (start, end) pairs in
        ascending sequence order, capped at MAX_SACK_BLOCKS (RFC 2018).
        Deterministic: derived purely from the reassembly map."""
        if not self.reassembly:
            return ()
        seqs = sorted(self.reassembly, key=lambda s: seq_sub(s, self.rcv_nxt))
        blocks = []
        start = end = None
        for s in seqs:
            e = seq_add(s, len(self.reassembly[s]))
            if start is None:
                start, end = s, e
            elif seq_leq(s, end):
                if seq_lt(end, e):
                    end = e
            else:
                blocks.append((start, end))
                start, end = s, e
        blocks.append((start, end))
        return tuple(blocks[:MAX_SACK_BLOCKS])

    def _ack_data(self, now: int, force: bool = False) -> None:
        """Ack in-order data: immediately every second segment (or when
        anything unusual is pending — holes, a gap just filled, FIN, a
        pinched window), else arm the 40ms delack timer (RFC 1122
        4.2.3.2; off switch delayed_ack=False)."""
        self._segs_since_ack += 1
        if (force or not self.delayed_ack or self._segs_since_ack >= 2
                or self.reassembly or self.peer_fin_seq is not None
                or self._recv_window() < self.eff_mss):
            self._emit_ack(now)
        elif self._delack_deadline is None:
            self._delack_deadline = now + DELACK_NS

    def _on_data(self, seq: int, payload: bytes, now: int) -> None:
        if self.state not in (ESTABLISHED, FIN_WAIT_1, FIN_WAIT_2):
            return
        # Trim anything already received.
        offset = seq_sub(self.rcv_nxt, seq)
        if offset >= len(payload):
            self._emit_ack(now)  # pure duplicate
            return
        if offset > 0:
            payload = payload[offset:]
            seq = self.rcv_nxt
        if seq != self.rcv_nxt:
            # Future segment: stash (bounded by the advertised window).
            if seq_sub(seq, self.rcv_nxt) < self.recv_buf_max:
                self.reassembly.setdefault(seq, payload)
            else:
                self.reasm_discards += 1  # beyond the window: discard
            self._emit_ack(now)  # dupack → sender fast-retransmits
            return
        # In-order: deliver, then drain any contiguous stashed segments.
        had_holes = bool(self.reassembly)
        rcv0 = self.rcv_nxt
        self._deliver(payload)
        while self.rcv_nxt in self.reassembly:
            self._deliver(self.reassembly.pop(self.rcv_nxt))
        # Fabric-observatory flow lifecycle: the rcv_nxt advance IS the
        # in-order delivered byte count (computed before any FIN
        # consumes its sequence slot below).
        delivered = seq_sub(self.rcv_nxt, rcv0)
        if delivered > 0:
            self._fct_touch(delivered, now, inbound=True)
        # An out-of-order FIN becomes processable once the gap fills.
        if self.pending_fin_seq == self.rcv_nxt:
            self._process_fin(now)
        self._ack_data(now, force=had_holes)

    def _deliver(self, payload: bytes) -> None:
        space = self.recv_buf_max - self.recv_buf_len
        take = payload[:space]
        if take:
            self.recv_buf.append(take)
            self.recv_buf_len += len(take)
            self.rcv_nxt = seq_add(self.rcv_nxt, len(take))
        if len(payload) > len(take):
            self.rcvwin_trunc += 1
        # Bytes beyond buffer space are NOT acked; the shrunken advertised
        # window tells the sender to back off and retransmit later.

    def _on_fin(self, hdr: TcpHeader, payload: bytes, now: int) -> None:
        if self.peer_fin_seq is not None:
            # Retransmitted FIN (our ACK was lost, e.g. in TIME_WAIT):
            # just re-ACK.
            self._emit_ack(now)
            return
        fin_seq = seq_add(hdr.seq, len(payload))
        if fin_seq != self.rcv_nxt:
            # FIN beyond data we haven't received: wait for reassembly.
            self.pending_fin_seq = fin_seq
            self._emit_ack(now)
            return
        self._process_fin(now)
        self._emit_ack(now)

    def _process_fin(self, now: int) -> None:
        self.peer_fin_seq = self.rcv_nxt
        self.pending_fin_seq = None
        self.rcv_nxt = seq_add(self.rcv_nxt, 1)
        if self.state == ESTABLISHED:
            self.state = CLOSE_WAIT
        elif self.state == FIN_WAIT_1:
            self.state = CLOSING
        elif self.state == FIN_WAIT_2:
            self._enter_time_wait(now)
        self._advance_close_states(now)

    def _advance_close_states(self, now: int) -> None:
        fin_acked = (self.fin_seq is not None
                     and seq_lt(self.fin_seq, self.snd_una))
        if self.state == FIN_WAIT_1 and fin_acked:
            self.state = FIN_WAIT_2
        elif self.state == CLOSING and fin_acked:
            self._enter_time_wait(now)
        elif self.state == LAST_ACK and fin_acked:
            self.state = CLOSED
            self.rto_deadline = None

    def _enter_time_wait(self, now: int) -> None:
        self.state = TIME_WAIT
        self.rto_deadline = None
        self.time_wait_deadline = now + TIME_WAIT_NS

    # ------------------------------------------------------------------
    # Segment egress
    # ------------------------------------------------------------------

    def _flight(self) -> int:
        return seq_sub(self.snd_nxt, self.snd_una)

    def _push_data(self, now: int) -> None:
        """Segmentize send_buf within min(cwnd, peer window), in
        eff_mss-sized segments. Nagle (RFC 896): hold sub-MSS data while
        anything is unacked, unless nodelay or a FIN is pending."""
        if self.state not in (ESTABLISHED, CLOSE_WAIT, FIN_WAIT_1,
                              CLOSING, LAST_ACK):
            return
        window = min(self.cwnd, self.snd_wnd)
        while self.send_buf and self._flight() < window:
            budget = min(window - self._flight(), self.eff_mss)
            if (self.nagle and not self.nodelay and not self.snd_fin_pending
                    and self.send_buf_len < min(budget, self.eff_mss)
                    and self._flight() > 0):
                break
            chunk = self._take_from_send_buf(budget)
            if not chunk:
                break
            self._emit(self._data_flags(), seq=self.snd_nxt,
                       payload=chunk, now=now, track=True)
            self.snd_nxt = seq_add(self.snd_nxt, len(chunk))
            self._fct_touch(len(chunk), now, inbound=False)
        if self.snd_wnd == 0 and self.send_buf and not self.rtx \
                and self._persist_deadline is None \
                and self.state in (ESTABLISHED, CLOSE_WAIT, FIN_WAIT_1):
            self._persist_interval = self.rto
            self._persist_deadline = now + self._persist_interval
        if self.snd_fin_pending and not self.send_buf \
                and self.fin_seq is None:
            self.fin_seq = self.snd_nxt
            self._emit(TcpFlags.FIN | TcpFlags.ACK, seq=self.snd_nxt,
                       payload=b"", now=now, track=True, is_fin=True)
            self.snd_nxt = seq_add(self.snd_nxt, 1)

    def _take_from_send_buf(self, n: int) -> bytes:
        out = bytearray()
        while n > 0 and self.send_buf:
            chunk = self.send_buf[0]
            if len(chunk) <= n:
                out += chunk
                n -= len(chunk)
                self.send_buf.popleft()
            else:
                out += chunk[:n]
                self.send_buf[0] = chunk[n:]
                n = 0
        self.send_buf_len -= len(out)
        return bytes(out)

    def _data_flags(self) -> int:
        """Flags for a FRESH data segment: ACK|PSH, plus the one-shot
        CWR announcing a pending ECN window cut (RFC 3168 6.1.2 —
        never on retransmissions)."""
        flags = TcpFlags.ACK | TcpFlags.PSH
        if self.ecn_active and self.cwr_pending:
            flags |= TcpFlags.CWR
            self.cwr_pending = False
        return flags

    def _transmit_segment(self, seq: int, payload: bytes, is_fin: bool,
                          now: int) -> None:
        """Retransmission path only — fresh segments go through _emit.
        Karn under timestamps: a retransmitted segment carries a FRESH
        timestamp, so its echo measures the retransmission, never the
        ambiguous original; sampling also pauses during RTO backoff."""
        flags = TcpFlags.ACK
        mss = None
        window_scale = None
        if is_fin:
            flags |= TcpFlags.FIN
        elif payload == b"" and seq == self.iss:
            # Retransmitted SYN / SYN-ACK must carry the same options as
            # the original — window scaling AND the ECN-setup flags —
            # else a lost SYN-ACK leaves the two sides disagreeing.
            flags = TcpFlags.SYN
            mss = MSS
            window_scale = self._wscale_offer
            if self.ecn_on:
                flags |= TcpFlags.ECE | TcpFlags.CWR
            if self.state == SYN_RECEIVED:
                flags = TcpFlags.SYN | TcpFlags.ACK
                if self.ecn_active:
                    flags |= TcpFlags.ECE
                window_scale = (self._wscale_offer if self.our_wscale
                                else None)
        elif payload:
            flags |= TcpFlags.PSH
        if self.ece_latch and not (flags & TcpFlags.SYN):
            flags |= TcpFlags.ECE  # echo until CWR (RFC 3168 6.1.3)
        self.outbox.append((TcpHeader(
            seq=seq, ack=self.rcv_nxt, flags=flags,
            window=self._wire_window(flags), mss=mss,
            window_scale=window_scale,
            sack_blocks=self._sack_blocks(),
            timestamp=now + 1,
            timestamp_echo=self._take_ts_echo()), payload))
        self.segments_sent += 1
        self._note_ack_sent()

    def _take_ts_echo(self) -> int:
        """The echo for an outgoing segment: the last timestamp value
        received, cleared after one use so an outdated echo is never
        resent (ref tcp.c:2433-2434)."""
        ts, self._ts_recent = self._ts_recent, 0
        return ts

    def _emit(self, flags: int, seq: int, payload: bytes, now: int,
              track: bool = False, is_fin: bool = False,
              mss: int | None = None,
              window_scale: int | None = None) -> None:
        if self.ece_latch and not (flags & TcpFlags.SYN):
            flags |= TcpFlags.ECE  # echo until CWR (RFC 3168 6.1.3)
        ack = self.rcv_nxt if (flags & TcpFlags.ACK) else 0
        self.outbox.append((TcpHeader(
            seq=seq, ack=ack, flags=flags, window=self._wire_window(flags),
            mss=mss, window_scale=window_scale,
            timestamp=now + 1,
            timestamp_echo=self._take_ts_echo()), payload))
        self.segments_sent += 1
        if flags & TcpFlags.ACK:
            self._note_ack_sent()
        if track:
            self.rtx.append([seq, payload, is_fin, now, False, False])
            if self.rto_deadline is None:
                self.rto_deadline = now + self.rto

    def _note_ack_sent(self) -> None:
        """Any segment carrying our current rcv_nxt satisfies a pending
        delayed ack (piggybacking)."""
        self._segs_since_ack = 0
        self._delack_deadline = None

    def _emit_ack(self, now: int) -> None:
        flags = TcpFlags.ACK
        if self.ece_latch:
            flags |= TcpFlags.ECE  # echo until CWR (RFC 3168 6.1.3)
        self.outbox.append((TcpHeader(
            seq=self.snd_nxt, ack=self.rcv_nxt, flags=flags,
            window=self._wire_window(TcpFlags.ACK),
            sack_blocks=self._sack_blocks(),
            timestamp=now + 1,
            timestamp_echo=self._take_ts_echo()), b""))
        self.segments_sent += 1
        self._note_ack_sent()
