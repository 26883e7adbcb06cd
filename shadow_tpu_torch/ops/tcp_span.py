"""Device-resident multi-round loop for the tgen steady-stream TCP
family, in PyTorch (the port of `shadow_tpu/ops/tcp_span.py`).

Per-connection TCP control state exports as struct-of-arrays
(netplane.cpp span_export_tcp), steps whole conservative windows on
the card, and imports back transactionally.  The modelled domain is
the fixed-connection bulk-transfer stretch (netgen.tcp_stream_yaml):
every live connection ESTABLISHED, every client mid-receive, every
handler mid-send.  Anything else aborts the span (AB_STRUCT) and the
engine's C++ path re-runs those rounds: fallback, never corruption.

The twin contract is byte-identical packet traces against the
reference's serial object path (tests/test_torch_tcp_span.py).

How the JAX program maps onto eager PyTorch (each point is named again
where it is handled):

- Out-of-bounds indices.  JAX drops out-of-bounds scatter indices
  (`.at[...].set(..., mode="drop")`) and clamps gathers; masked lanes
  write to row H+1 / CC+1 and are dropped.  PyTorch raises on both, so
  the port masks explicitly: every conn-major array carries one trash
  row (index CC) that masked lanes write and nothing reads; host-major
  rows are written back with their own old value on masked lanes
  (each lane owns its row, so no two lanes collide); flat buffers
  (trace, outbox) carry one trash slot at the end.
- Sort and search.  `jnp.argsort` is stable, so `torch.argsort(...,
  stable=True)`; `lax.cummax` is `torch.cummax(...).values`;
  `jnp.searchsorted` is `torch.searchsorted` (side left); the inbox
  lexsort is three stable argsorts.
- 32-bit sequence arithmetic.  Every uint32 column is held as int64 in
  [0, 2**32); `s_add` masks with 0xFFFFFFFF where JAX casts to uint32.
- Floor division.  Torch `//` floors like JAX; the CUDA bucket kernel
  does a real floor division (csrc/queues.cu).
- Guards.  The `lax.cond(mask.any())` guards and the while loops
  become eager Python.  Every stage runs masked, with its writes
  behind `torch.where` (the relay kernels write in place on the
  mask's lanes only), so a stage with no active lane leaves the
  state bit-identical; a stage (and an emit, a timer push or a trace
  append inside one) is skipped when no lane is active.  That costs
  one host sync per guard, which also counts the stage's lanes, and
  skipping saves the launches of the whole stage, which is the larger
  cost on the card as on the CPU.  The loop conditions cost one sync
  per micro-iteration and one per round.
- Speed.  This eager form pays the host per stage and per
  micro-iteration; on the card the whole span is one kernel launch
  instead (below).

The span step.  On the card (`span_factory` and `window_factory` None)
each span is one cooperative launch of the hand kernel `stt_tcp_span`
(ops/tcp_span_kernel.py, csrc/tcp_span.cu): every round's window (a
tile of 32 threads per host lane runs the fused schedule,
csrc/tcp_lane.cuh: one thread the law, the tile its row scans, the relay
tails' bucket and CoDel-head laws inside the lane), propagation, drops,
inbox merge and round scalars between grid barriers, and one read of the
span's words at the end.  The eager loop (`run` with `run.span` None:
a window step, then the eager round end `run.round_end`) is its plain
version: the CPU runs it, and so does the card with a `window_factory`:
`tcp_window.TCP_WINDOW.bind` steps each window with one launch of the
window kernel `stt_tcp_window` (ops/tcp_window.py, csrc/tcp_window.cu),
`tcp_window.eager_window` with the eager window (`run.window_plain`).
There the relay micro-ops launch the fused hand kernels `RELAY1_LAW` and
`RELAY2_LAW` (ops/relay.py, csrc/relay.cu) for their lane-local tails,
which hold the bucket and CoDel-head laws at the sites where the JAX
code calls the Pallas kernels; those kernels write the span state in
place on the stage's lanes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from shadow_tpu_torch.core.rng import (STREAM_PACKET_LOSS, mix_key,
                                       threefry2x32_torch)
from shadow_tpu_torch.core.simtime import TIME_NEVER
# BUCKET_STEP / CODEL_HEAD are re-exported for tests/test_torch_queues.py,
# which imports the wrappers from here (ROADMAP C).
from shadow_tpu_torch.ops.queues import (BUCKET_STEP, CODEL_HEAD,  # noqa: F401
                                         CODEL_TARGET_NS, MTU, REFILL_NS)
from shadow_tpu_torch.ops.relay import RelayConsts, RelayLaw
from shadow_tpu_torch.ops.span_common import (FAB_COLS, I64_MAX,
                                              fabric_values, make_rows,
                                              merge_inbox, put_row)
from shadow_tpu_torch.ops.span_mesh import (AB_OUT, AB_STRUCT, AB_TRACE,
                                            SpanMeshMixin)
from shadow_tpu_torch.ops.tcp_span_kernel import TCP_SPAN
from shadow_tpu_torch.trace.events import FAM_TCP, TEL_DTYPE
from shadow_tpu_torch.trace.recorder import grid_sampled

SEQ_HALF = 1 << 31
SEQ_MOD = 1 << 32
M32 = 0xFFFFFFFF

# Continuations (one per host lane).
C_IDLE = 0
C_R1 = 1       # relay inet-out drain (one packet per micro-op)
C_R2 = 2       # relay inet-in drain
C_TCPIN = 3    # on_packet minus the push_data / reassembly loops
C_DRAIN = 4    # reassembly drain (one chunk per micro-op)
C_ACKDATA = 5  # ack_data decision after in-order delivery
C_PUSH = 6     # push_data (one segment per micro-op)
C_FLUSH = 7    # tcp_flush's notify decision
C_ARM = 8      # tcp_flush's arm-timer + update-status tail
C_APP = 9      # app stepper (client recv / handler send)
C_TMR = 10     # TK_TCP timer fire

# Timer kinds / status bits (netplane.cpp).
TK_RELAY = 0
TK_TCP = 1
TK_APP = 2
S_READABLE = 1 << 1
S_WRITABLE = 1 << 2
ASYS_SEND = 3
ASYS_RECV = 4
ASYS_N = 16

# TCP constants (tcp/connection.py twins).
F_FIN = 0x01
F_SYN = 0x02
F_RST = 0x04
F_PSH = 0x08
F_ACK = 0x10
F_ECE = 0x40
F_CWR = 0x80
MSS = 1460

# ECN / DCTCP (net/packet.py, tcp/connection.py, net/codel.py twins;
# registered fail-closed in analysis pass 1).  The alpha EWMA is
# fixed-point (scaled by 2**DCTCP_SHIFT) so this kernel, the C++
# engine and the Python object path compute bit-identical values.
ECN_ECT0 = 2
ECN_CE = 3
DCTCP_SHIFT = 10
DCTCP_G_SHIFT = 4
DCTCP_MAX_ALPHA = 1024
DCTCP_K_PKTS = 20
DCTCP_K_BYTES = 30_000
CC_DCTCP = 1
MARK_THRESH_PKTS = 0
MARK_THRESH_BYTES = 1
MARK_N = 2
MAX_WINDOW = 65_535
TCP_TOTAL_HDR = 40  # IPv4 20 + TCP 20; options are not size-modelled
MIN_RTO_NS = 200_000_000
MAX_RTO_NS = 60_000_000_000
DELACK_NS = 40_000_000
WMEM_MAX = 4_194_304
RMEM_MAX = 6_291_456

CODEL_HARD_LIMIT = 1000

TR_SND = 0
TR_DRP = 1
TR_RCV = 2
RSN_CODEL = 1
RSN_RTRLIMIT = 2
RSN_LOSS = 6
RSN_UNREACH = 7
RSN_HOSTDOWN = 9
RSN_LINKDOWN = 10

# Sim-netstat drop-cause slots touched by this kernel (netplane.cpp
# TEL_* twins; registered in analysis pass 1).  The per-host
# (H, TEL_N) `drop_causes` column round-trips through the span codec
# so the engine's counters stay authoritative across device spans.
TEL_CODEL = 0
TEL_RTR_LIMIT = 1
TEL_LOSS_EDGE = 2
TEL_UNREACHABLE = 3
TEL_HOST_DOWN = 11
TEL_LINK_DOWN = 12
TEL_REASM_FULL = 13
TEL_RECVWIN_TRUNC = 14
TEL_N = 15

# Fabric-observatory activity mask (netplane.cpp FB_ACT_* twins;
# registered in analysis pass 1): a host's queues are sampled in a
# round iff any bit is set.
FB_ACT_CODEL = 1
FB_ACT_TB_OUT = 2
FB_ACT_TB_IN = 4
FB_ACT_LINK = 8

# Device-kernel observatory stage slots this family occupies
# (netplane.cpp KS_* twins, registered fail-closed in analysis
# pass 1; docs/OBSERVABILITY.md "Device-kernel observatory").
KS_POP = 0
KS_STEP = 1
KS_CODEL = 2
KS_ON_PACKET = 3
KS_REASM = 4
KS_ACK = 5
KS_PUSH = 6
KS_FLUSH = 7
KS_INET_OUT = 8
KS_ARM = 9
KS_TIMERS = 10
KS_EXCHANGE = 11
KS_N = 12
KS_NAMES = ("pop", "step", "codel", "on-packet", "reassembly", "ack",
            "push", "flush", "inet-out", "arm", "timers", "exchange")

# Telemetry sample fields (trace/events.py TEL_REC order after the
# identity header) -> the SoA column each samples.
TEL_FIELDS = (("cwnd", "c_cwnd"), ("ssthresh", "c_ssthresh"),
              ("srtt", "c_srtt"), ("rto", "c_rto"),
              ("backoff", "c_rtobackoff"), ("sndbuf", "c_sblen"),
              ("rcvbuf", "c_rblen"), ("rtx", "c_rtxcount"),
              ("sacks", "c_sackskip"), ("marks", "c_ceseen"))
ST_ESTABLISHED = 4  # every in-domain connection's state

# Packet columns: routing identity + the TCP header + the IP ECN
# codepoint (the queues' marking law rewrites it in flight).
ROUTE_KEYS = ("srchost", "pseq", "sip", "sport", "dip", "dport")
TCP_KEYS = ("tseq", "tack", "tflags", "twin", "tsv", "tse", "plen",
            "nsk", "sk0s", "sk0e", "sk1s", "sk1e", "sk2s", "sk2e",
            "ecn")
PK_KEYS = ROUTE_KEYS + TCP_KEYS
PK_DTYPES = {
    "srchost": np.int32, "pseq": np.int64, "sip": np.uint32,
    "sport": np.int32, "dip": np.uint32, "dport": np.int32,
    "tseq": np.uint32, "tack": np.uint32, "tflags": np.int32,
    "twin": np.int64, "tsv": np.int64, "tse": np.int64,
    "plen": np.int32, "nsk": np.int32,
    "sk0s": np.uint32, "sk0e": np.uint32, "sk1s": np.uint32,
    "sk1e": np.uint32, "sk2s": np.uint32, "sk2e": np.uint32,
    "ecn": np.int32,
}


# Fire/lane stage counters: how many times per micro-iteration the
# fused schedule runs each stage (the relay drains and the reassembly
# drain run twice), so fires <= passes x trips.
KS_PASSES = {KS_POP: 1, KS_TIMERS: 1, KS_STEP: 1, KS_CODEL: 1,
             KS_ON_PACKET: 1, KS_REASM: 2, KS_ACK: 1, KS_PUSH: 1,
             KS_FLUSH: 1, KS_INET_OUT: 2, KS_ARM: 1}

# The hand kernels the relay micro-ops launch: one fused kernel per
# relay pass.  Each keeps a plain launch counter that counts CUDA
# launches only (chip_smoke.py zeroes them before the main path and
# reads them after).
RELAY_CONSTS = RelayConsts(PK_KEYS, TCP_TOTAL_HDR, REFILL_NS,
                           CODEL_TARGET_NS, MTU, TEL_CODEL, TEL_LINK_DOWN)
RELAY1_LAW = RelayLaw(1, RELAY_CONSTS)
RELAY2_LAW = RelayLaw(2, RELAY_CONSTS)
# The standalone law kernels (csrc/queues.cu, ops/queues.py BUCKET_STEP /
# CODEL_HEAD, imported above): this loop runs their laws inside the
# relay kernels and never launches them.

# Residency classes (the reference's tables): every codec column falls
# in exactly one.  STATIC: per-sim constants (connection identity,
# negotiated options, buckets), cached on the card at the export and
# shared read-only by every later dispatch.  DERIVED: device-local
# chain registers every fresh export re-initializes (`_derive`).
# CARRIED: a clean span's output is the next span's input while the
# engine's state_epoch is unchanged (a speculative window runs on a
# clone of these).
RESIDENT_STATIC = frozenset({
    "bw_up", "bw_down", "eth_ip",
    "r1_refill", "r1_cap", "r1_unlimited",
    "r2_refill", "r2_cap", "r2_unlimited",
    "c_host", "c_role", "c_lip", "c_lport", "c_pip", "c_pport",
    "c_iss", "c_irs", "c_wsoff", "c_ourws", "c_peerws", "c_effmss",
    "c_nodelay", "c_congmss", "c_sat", "c_rat", "c_atotal",
    "c_ecnact", "c_cc",
})
RESIDENT_DERIVED = frozenset(
    {"cont", "then", "ret", "cur", "eflag", "parkp", "had_holes",
     "park_ctr", "cd_chain", "cd_sniff", "_n_conns"}
    | {f"ar_{kk}" for kk in PK_KEYS})
RESIDENT_CARRIED = frozenset(
    {
     "app_sys", "c_agot", "c_atcopied", "c_atlast", "c_atspace",
     "c_await", "c_awaitseq", "c_cwnd", "c_delackdl", "c_dupacks",
     "c_fastrec", "c_persistdl", "c_persistiv", "c_queued",
     "c_rblen", "c_rbmax", "c_rcvnxt", "c_recover", "c_rto",
     "c_rtobackoff", "c_rtodl", "c_rttvar", "c_rtxcount",
     "c_sackskip", "c_sblen", "c_sbmax", "c_segsrecv",
     "c_segssent", "c_sndnxt", "c_snduna", "c_sndwnd", "c_srtt",
     "c_ssa", "c_ssthresh", "c_status", "c_tmrdl", "c_tsrecent",
     "c_wakep", "c_fbyte", "c_lbyte", "c_bin", "c_bout",
     "c_ece", "c_cwrp", "c_cwrend", "c_alpha", "c_ceack",
     "c_totack", "c_dwend", "c_ceseen",
     "codel_bytes", "codel_count", "codel_drop_next",
     "codel_dropped", "codel_dropping", "codel_first_above",
     "codel_enq_pkts", "codel_enq_bytes", "codel_drop_bytes",
     "codel_peak", "codel_marked", "drop_causes", "mark_causes",
     "codel_last_count", "cq_enq", "cq_len", "cq_pos",
     "eth_brecv", "eth_bsent", "eth_precv", "eth_psent",
     "event_seq", "events_run", "ib_len", "ib_pos", "ib_seq",
     "ib_src", "ib_time", "now", "op_len", "op_pos", "packet_seq",
     "pkts_dropped", "pkts_recv", "pkts_sent", "r1_bal",
     "r1_next", "r1_pending", "r1_pk_valid", "r1_stalls",
     "r1_fwd_pkts", "r1_fwd_bytes",
     "r2_bal", "r2_next",
     "r2_pending", "r2_pk_valid", "r2_stalls",
     "r2_fwd_pkts", "r2_fwd_bytes",
     "ra_plen", "ra_seq", "ra_valid",
     "rtx_len", "rtx_plen", "rtx_pos", "rtx_rtxed", "rtx_sacked",
     "rtx_sent", "rtx_seq", "th_kind", "th_seq", "th_tgt",
     "th_time", "th_valid", "h_fault"}
    | {f"{p}_{kk}" for p in ('cq', 'ib', 'op', 'r1_pk', 'r2_pk')
       for kk in PK_KEYS})

# Conn-major keys: their first axis is the connection (CC rows plus the
# trash row the port adds).
_CONN_PREFIXES = ("c_", "rtx_", "ra_", "op_")


def _is_conn_major(key: str) -> bool:
    return key.startswith(_CONN_PREFIXES)


def state_from_numpy(d: dict, device) -> dict:
    """The numpy span state that `_to_arrays` builds from
    span_export_tcp -> the port's tensors on `device`.

    Every integer column becomes int64 (uint32 columns keep their
    values in [0, 2**32)), bools stay bool, and every conn-major array
    gains the trash row at index CC (c_host = -1 there, so it never
    matches a host).  The inputs are copied, never shared: the loop
    updates its state in place.  `state_to_numpy` inverts it exactly."""
    st = {}
    dtypes = {}
    for k, a in d.items():
        if not isinstance(a, np.ndarray):
            st[k] = a
            continue
        dtypes[k] = a.dtype
        if _is_conn_major(k):
            pad = np.full((1,) + a.shape[1:], -1 if k == "c_host" else 0,
                          dtype=a.dtype)
            a = np.concatenate([a, pad])
        dt = torch.bool if a.dtype == np.bool_ else torch.int64
        st[k] = torch.tensor(a.astype(np.bool_ if dt == torch.bool
                                      else np.int64), device=device)
    st["_np_dtypes"] = dtypes
    return st


def state_to_numpy(st: dict, keys=None) -> dict:
    """The port's tensors -> numpy with the codec's own dtypes and
    shapes (trash rows dropped).  `keys` limits the conversion."""
    dtypes = st.get("_np_dtypes", {})
    out = {}
    for k in (st if keys is None else keys):
        v = st[k]
        if not isinstance(v, torch.Tensor):
            continue
        a = v.cpu().numpy()
        if _is_conn_major(k) and k in dtypes:
            a = a[:-1]
        if k in dtypes:
            a = a.astype(dtypes[k])
        out[k] = a
    return out


class TcpSpanRunner(SpanMeshMixin):
    """Builds and drives the PyTorch multi-round device loop for the
    tgen steady-stream TCP family.  One instance per Manager."""

    # Ring capacities: export refuses state beyond half of each, and
    # the loop aborts transactionally on overflow.  The rtx and
    # reassembly rings are by default twice the reference's 256 (the
    # constructor's `ring_cap` sets both): at thousands of lossy
    # connections some connection's rtx queue or reassembly holds more
    # than 128 segments at nearly every span boundary (a window of ~130
    # segments behind a hole), so with 256 the export refuses and the
    # device never gets the stream.  At 256 the span records (spans,
    # device rounds, export refusals, aborts) are the reference's.
    CAP_I = 512    # inbox
    CAP_T = 4096   # timer heap
    CAP_CQ = 2048  # CoDel ring (covers the 1000-entry hard limit)
    CAP_RT = 512   # rtx queue
    CAP_RA = 512   # reassembly
    CAP_OP = 256   # socket egress ring
    MAX_ROUNDS = 256
    RESIDENT_STATIC = RESIDENT_STATIC
    RESIDENT_CARRIED = RESIDENT_CARRIED
    # Out of the steady-stream domain for now (handshake, close,
    # over caps): the router re-probes within a few windows.
    OVER_CAPS_TRANSIENT = True
    FAMILY = FAM_TCP

    def __init__(self, engine, latency_ns, thresholds, host_node,
                 host_ips, seed, bootstrap_end, tracing: bool,
                 device=None, ring_cap: int | None = None):
        from shadow_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.engine = engine
        self.tracing = bool(tracing)
        if ring_cap is not None:
            self.CAP_RT = self.CAP_RA = int(ring_cap)
        k0, k1 = mix_key(seed, STREAM_PACKET_LOSS)
        self._k = (int(k0), int(k1))
        self._lat = np.ascontiguousarray(latency_ns, dtype=np.int64)
        self._thr = np.ascontiguousarray(thresholds, dtype=np.int64)
        self._node = np.ascontiguousarray(host_node, dtype=np.int32)
        ips = np.ascontiguousarray(host_ips, dtype=np.uint32)
        order = np.argsort(ips)
        self._ips_sorted = ips[order]
        self._ips_perm = order.astype(np.int32)
        self.bootstrap_end = int(bootstrap_end)
        self._H = len(host_ips)
        self._CC = 0          # conn capacity (set from export)
        self.cap_out = max(4096, 128 * self._H)
        self.cap_tr = max(1 << 18, 1024 * self._H)
        self.spans = 0
        self.rounds = 0
        self.aborts = 0
        self.ineligible = 0
        self.over_caps = 0
        self.micro_iters = 0
        # Per-stage fires, lanes and host wall of committed spans (KS_*
        # slots), beside micro_iters (the trips they are bounded by).
        self.ks_fires = np.zeros(KS_N, np.int64)
        self.ks_lanes = np.zeros(KS_N, np.int64)
        self.ks_wall_s = np.zeros(KS_N)
        # Stage fires of every dispatch (aborted and refused ones too):
        # one relay-kernel launch per fire of a relay stage on the eager
        # window.
        self.fires_all = np.zeros(KS_N, np.int64)
        # The span step.  None: one stt_tcp_span launch a span on the
        # card with no window_factory, else the eager loop.  A hook
        # `span_factory(shape, params)` makes the step instead (the
        # tests' host build of the span).
        self.span_factory = None
        # The eager loop's window step: None the eager window; a hook
        # `window_factory(shape, params)` makes it (TCP_WINDOW.bind: one
        # stt_tcp_window launch a window; the tests' host build of the
        # lane law; tcp_window.eager_window: None, the eager window).
        self.window_factory = None
        # The law calls made in the window kernel's lanes (CALL_* slots:
        # bucket, CoDel head) of committed spans and of every dispatch;
        # windows the kernel stepped and their launch-to-end time (ms,
        # CUDA events) of committed spans, and the windows of every
        # dispatch.
        self.ks_calls = np.zeros(2, np.int64)
        self.calls_all = np.zeros(2, np.int64)
        self.ks_windows = 0
        self.ks_window_ms = 0.0
        self.windows_all = 0
        # Span-kernel launches and their launch-to-end time (ms) of
        # committed spans, and the launches of every dispatch (aborted
        # and refused ones too); the eager round ends run, every dispatch.
        self.ks_spans = 0
        self.ks_span_ms = 0.0
        self.spans_all = 0
        self.eager_round_ends = 0
        self._n_conns = 0     # live connections (set from export)
        self.last_abort_code = 0
        self.last_was_cold = False
        self.compiled = False
        self.dctcp_k = (DCTCP_K_PKTS, DCTCP_K_BYTES)
        self._fn = None
        self._fn_cache: dict = {}
        # Sim-netstat's connection identity in its canonical (host,
        # lport, rport, rip) order, taken at each export: (host, lport,
        # rport, rip, perm, n).
        self._tel_ident = None

    def _caps(self):
        return (self.CAP_I, self.CAP_T, self.CAP_CQ, self.CAP_RT,
                self.CAP_RA, self.CAP_OP)

    # ------------------------------------------------------------------
    # Export bytes <-> numpy state (the reference codec, unchanged)
    # ------------------------------------------------------------------

    def _to_arrays(self, d: dict) -> dict:
        H = self._H
        I, T, CQ, RT, RA, OP = self._caps()

        def f(k, dt, shape=None):
            a = np.frombuffer(d[k], dtype=dt)
            a = a.reshape(shape) if shape is not None else a
            return a.copy()

        n_conns = int(np.frombuffer(d["n_conns"], np.int64)[0])
        CC = 8
        while CC < n_conns:
            CC <<= 1
        self._CC = CC
        st = {"_n_conns": n_conns}

        def pk(prefix, shape):
            for kk in PK_KEYS:
                a = f(f"{prefix}_{kk}", PK_DTYPES[kk], shape)
                if a.dtype == np.int32 and kk in ("tflags", "nsk"):
                    a = a.astype(np.int32)
                st[f"{prefix}_{kk}"] = a

        for k in ("now", "event_seq", "packet_seq", "bw_up", "bw_down",
                  "codel_bytes", "codel_count", "codel_last_count",
                  "codel_first_above", "codel_drop_next",
                  "codel_dropped", "codel_enq_pkts", "codel_enq_bytes",
                  "codel_drop_bytes", "codel_peak", "codel_marked",
                  "pkts_sent",
                  "pkts_recv", "pkts_dropped", "events_run",
                  "eth_psent", "eth_precv", "eth_bsent", "eth_brecv"):
            st[k] = f(k, np.int64)
        st["eth_ip"] = f("eth_ip", np.uint32)
        # Down-host fault mask (docs/ROBUSTNESS.md): bit0 down, bit1
        # link_down, bit2 blackhole.  Constant within a span (faults
        # apply only at round boundaries, which cap span `limit`);
        # CARRIED so resident reuse keeps the engine's live flags.
        st["h_fault"] = f("h_fault", np.uint8).astype(np.int32)
        st["codel_dropping"] = f("codel_dropping", np.uint8).astype(
            np.int32)
        st["cq_len"] = f("cq_len", np.int32)
        pk("cq", (H, CQ))
        st["cq_enq"] = f("cq_enq", np.int64, (H, CQ))
        for r in (1, 2):
            st[f"r{r}_pending"] = f(f"r{r}_pending", np.uint8).astype(
                np.int32)
            st[f"r{r}_unlimited"] = f(f"r{r}_unlimited",
                                      np.uint8).astype(np.int32)
            for k in ("bal", "next", "refill", "cap", "stalls",
                      "fwd_pkts", "fwd_bytes"):
                st[f"r{r}_{k}"] = f(f"r{r}_{k}", np.int64)
            st[f"r{r}_pk_valid"] = f(f"r{r}_pk_valid",
                                     np.uint8).astype(np.int32)
            pk(f"r{r}_pk", None)
        st["ib_len"] = f("ib_len", np.int32)
        st["ib_time"] = f("ib_time", np.int64, (H, I))
        st["ib_src"] = f("ib_src", np.int32, (H, I))
        st["ib_seq"] = f("ib_seq", np.int64, (H, I))
        pk("ib", (H, I))
        st["th_time"] = f("th_time", np.int64, (H, T))
        st["th_seq"] = f("th_seq", np.int64, (H, T))
        st["th_kind"] = f("th_kind", np.uint8, (H, T)).astype(np.int32)
        st["th_tgt"] = f("th_tgt", np.int32, (H, T))
        st["th_valid"] = (np.arange(T)[None, :]
                          < f("th_len", np.int32)[:, None])
        st["app_sys"] = f("app_sys", np.int64, (H, ASYS_N))
        st["drop_causes"] = f("drop_causes", np.int64, (H, TEL_N))
        st["mark_causes"] = f("mark_causes", np.int64, (H, MARK_N))

        # conn-major
        for k, dt in (("c_host", np.int32), ("c_lport", np.int32),
                      ("c_pport", np.int32), ("c_ourws", np.int32),
                      ("c_peerws", np.int32), ("c_effmss", np.int32),
                      ("c_wsoff", np.int32), ("c_ssa", np.int32),
                      ("c_congmss", np.int32), ("c_dupacks", np.int32),
                      ("c_rtobackoff", np.int32), ("c_cc", np.int32)):
            st[k] = f(k, dt)
        for k in ("c_lip", "c_pip", "c_iss", "c_irs", "c_snduna",
                  "c_sndnxt", "c_rcvnxt", "c_recover", "c_status",
                  "c_cwrend", "c_dwend"):
            st[k] = f(k, np.uint32)
        st["c_await"] = f("c_await", np.uint32)
        for k in ("c_role", "c_nodelay", "c_fastrec", "c_queued",
                  "c_sat", "c_rat", "c_wakep", "c_ecnact", "c_ece",
                  "c_cwrp"):
            st[k] = f(k, np.uint8).astype(np.int32)
        for k in ("c_sndwnd", "c_sblen", "c_sbmax", "c_rblen",
                  "c_rbmax", "c_delackdl", "c_persistdl",
                  "c_persistiv", "c_cwnd", "c_ssthresh", "c_srtt",
                  "c_rttvar", "c_rto", "c_rtodl", "c_tsrecent",
                  "c_segssent", "c_segsrecv", "c_rtxcount",
                  "c_sackskip", "c_tmrdl", "c_atcopied", "c_atspace",
                  "c_atlast", "c_awaitseq", "c_agot", "c_atotal",
                  "c_fbyte", "c_lbyte", "c_bin", "c_bout",
                  "c_alpha", "c_ceack", "c_totack", "c_ceseen"):
            st[k] = f(k, np.int64)
        st["rtx_len"] = f("rtx_len", np.int32)
        st["rtx_seq"] = f("rtx_seq", np.uint32, (CC, RT))
        st["rtx_plen"] = f("rtx_plen", np.int32, (CC, RT))
        st["rtx_rtxed"] = f("rtx_rtxed", np.uint8, (CC, RT)).astype(
            np.int32)
        st["rtx_sacked"] = f("rtx_sacked", np.uint8, (CC, RT)).astype(
            np.int32)
        st["rtx_sent"] = f("rtx_sent", np.int64, (CC, RT))
        st["ra_plen"] = f("ra_plen", np.int32, (CC, RA))
        st["ra_seq"] = f("ra_seq", np.uint32, (CC, RA))
        st["ra_valid"] = (np.arange(RA)[None, :]
                          < f("ra_len", np.int32)[:, None])
        st["op_len"] = f("op_len", np.int32)
        pk("op", (CC, OP))

        for k in ("cq_pos", "ib_pos", "rtx_pos", "op_pos"):
            st[k] = np.zeros(H if k in ("cq_pos", "ib_pos") else CC,
                             np.int32)
        for k in ("cont", "then", "ret", "cur"):
            st[k] = np.full(H, C_IDLE if k in ("cont", "then", "ret")
                            else -1, np.int32)
        # per-host chain registers
        st["eflag"] = np.zeros(H, np.int32)     # emitted since flush
        st["parkp"] = np.zeros(H, np.int32)     # sendto EAGAIN pending
        st["had_holes"] = np.zeros(H, np.int32)
        # arrival register (the packet C_TCPIN is processing)
        for kk in PK_KEYS:
            st[f"ar_{kk}"] = np.zeros(H, PK_DTYPES[kk])
        # park-order counter: per-host relative (import remaps)
        park0 = np.zeros(H, np.int64)
        np.maximum.at(park0, st["c_host"][:n_conns],
                      st["c_awaitseq"][:n_conns] + 1)
        st["park_ctr"] = park0
        # padded-slot invariants
        st["ib_time"][np.arange(I)[None, :] >= st["ib_len"][:, None]] \
            = I64_MAX
        # conn lanes beyond n_conns must never match: park their host
        # at an impossible id
        st["c_host"][n_conns:] = -1
        return st

    def _from_arrays(self, st: dict) -> dict:
        """Back to the engine's packed-byte import layout (rings
        re-packed from their head positions)."""
        H = self._H
        I, T, CQ, RT, RA, OP = self._caps()
        CC = self._CC
        out = {}

        def npv(k):
            return np.asarray(st[k])

        def ring(pfx, cap, pos_k, len_k, modulo, rows, extra=()):
            pos = npv(pos_k).astype(np.int64)
            ln = npv(len_k).astype(np.int64)
            ar = np.arange(cap, dtype=np.int64)[None, :]
            idx = (pos[:, None] + ar) % cap if modulo \
                else np.minimum(pos[:, None] + ar, cap - 1)
            for kk in PK_KEYS:
                a = np.take_along_axis(npv(f"{pfx}_{kk}"), idx, axis=1)
                out[f"{pfx}_{kk}"] = np.ascontiguousarray(a).tobytes()
            for kk in extra:
                a = np.take_along_axis(npv(kk), idx, axis=1)
                out[kk] = np.ascontiguousarray(a).tobytes()
            out[len_k] = (ln - pos).astype(np.int32).tobytes()

        ring("cq", CQ, "cq_pos", "cq_len", True, H, extra=("cq_enq",))
        ring("ib", I, "ib_pos", "ib_len", False, H,
             extra=("ib_time", "ib_src", "ib_seq"))
        ring("op", OP, "op_pos", "op_len", True, CC)
        # rtx ring: non-PK columns, same pos/len repack
        pos = npv("rtx_pos").astype(np.int64)
        ln = npv("rtx_len").astype(np.int64)
        ar = np.arange(RT, dtype=np.int64)[None, :]
        idx = (pos[:, None] + ar) % RT
        for kk, dt in (("rtx_seq", np.uint32), ("rtx_plen", np.int32),
                       ("rtx_sent", np.int64)):
            a = np.take_along_axis(npv(kk), idx, axis=1)
            out[kk] = np.ascontiguousarray(a.astype(dt)).tobytes()
        for kk in ("rtx_rtxed", "rtx_sacked"):
            a = np.take_along_axis(npv(kk), idx, axis=1)
            out[kk] = np.ascontiguousarray(a.astype(np.uint8)).tobytes()
        out["rtx_len"] = (ln - pos).astype(np.int32).tobytes()
        # reassembly: compact valid entries
        rv = npv("ra_valid")
        order = np.argsort(~rv, axis=1, kind="stable")
        for kk, dt in (("ra_seq", np.uint32), ("ra_plen", np.int32)):
            a = np.take_along_axis(npv(kk), order, axis=1)
            out[kk] = np.ascontiguousarray(a.astype(dt)).tobytes()
        out["ra_len"] = rv.sum(axis=1).astype(np.int32).tobytes()
        # timer heap: compact valid entries
        tv = npv("th_valid")
        order = np.argsort(~tv, axis=1, kind="stable")
        for k, dt in (("th_time", np.int64), ("th_seq", np.int64),
                      ("th_tgt", np.int32)):
            a = np.take_along_axis(npv(k), order, axis=1)
            out[k] = np.ascontiguousarray(a.astype(dt)).tobytes()
        a = np.take_along_axis(npv("th_kind"), order, axis=1)
        out["th_kind"] = np.ascontiguousarray(
            a.astype(np.uint8)).tobytes()
        out["th_len"] = tv.sum(axis=1).astype(np.int32).tobytes()

        for k in ("now", "event_seq", "packet_seq", "codel_bytes",
                  "codel_count", "codel_last_count",
                  "codel_first_above", "codel_drop_next",
                  "codel_dropped", "codel_enq_pkts", "codel_enq_bytes",
                  "codel_drop_bytes", "codel_peak", "codel_marked",
                  "pkts_sent",
                  "pkts_recv", "pkts_dropped", "events_run",
                  "eth_psent", "eth_precv", "eth_bsent", "eth_brecv"):
            out[k] = npv(k).astype(np.int64).tobytes()
        out["codel_dropping"] = npv("codel_dropping").astype(
            np.uint8).tobytes()
        out["h_fault"] = npv("h_fault").astype(np.uint8).tobytes()
        for r in (1, 2):
            out[f"r{r}_pending"] = npv(f"r{r}_pending").astype(
                np.uint8).tobytes()
            out[f"r{r}_pk_valid"] = npv(f"r{r}_pk_valid").astype(
                np.uint8).tobytes()
            out[f"r{r}_bal"] = npv(f"r{r}_bal").astype(
                np.int64).tobytes()
            out[f"r{r}_next"] = npv(f"r{r}_next").astype(
                np.int64).tobytes()
            out[f"r{r}_stalls"] = npv(f"r{r}_stalls").astype(
                np.int64).tobytes()
            out[f"r{r}_fwd_pkts"] = npv(f"r{r}_fwd_pkts").astype(
                np.int64).tobytes()
            out[f"r{r}_fwd_bytes"] = npv(f"r{r}_fwd_bytes").astype(
                np.int64).tobytes()
            for kk in PK_KEYS:
                out[f"r{r}_pk_{kk}"] = np.ascontiguousarray(
                    npv(f"r{r}_pk_{kk}").astype(
                        PK_DTYPES[kk])).tobytes()
        out["app_sys"] = npv("app_sys").astype(np.int64).tobytes()
        out["drop_causes"] = npv("drop_causes").astype(
            np.int64).tobytes()
        out["mark_causes"] = npv("mark_causes").astype(
            np.int64).tobytes()
        for k, dt in (("c_snduna", np.uint32), ("c_sndnxt", np.uint32),
                      ("c_rcvnxt", np.uint32), ("c_recover", np.uint32),
                      ("c_status", np.uint32), ("c_await", np.uint32),
                      ("c_cwrend", np.uint32), ("c_dwend", np.uint32)):
            out[k] = npv(k).astype(dt).tobytes()
        for k in ("c_sndwnd", "c_sblen", "c_sbmax", "c_rblen",
                  "c_rbmax", "c_delackdl", "c_persistdl",
                  "c_persistiv", "c_cwnd", "c_ssthresh", "c_srtt",
                  "c_rttvar", "c_rto", "c_rtodl", "c_tsrecent",
                  "c_segssent", "c_segsrecv", "c_rtxcount",
                  "c_sackskip", "c_tmrdl", "c_atcopied", "c_atspace",
                  "c_atlast", "c_awaitseq", "c_agot",
                  "c_fbyte", "c_lbyte", "c_bin", "c_bout",
                  "c_alpha", "c_ceack", "c_totack", "c_ceseen"):
            out[k] = npv(k).astype(np.int64).tobytes()
        for k in ("c_ssa", "c_dupacks", "c_rtobackoff"):
            out[k] = npv(k).astype(np.int32).tobytes()
        for k in ("c_fastrec", "c_queued", "c_wakep", "c_ece",
                  "c_cwrp"):
            out[k] = npv(k).astype(np.uint8).tobytes()
        return out

    # ------------------------------------------------------------------
    # The multi-round step, in PyTorch
    # ------------------------------------------------------------------

    def _cached_build(self):
        key = (self._H, self._CC, self._caps(), self.cap_out,
               self.cap_tr, self.tracing, self.dctcp_k, str(self.device),
               self._sample_ivs(), self.window_factory, self.span_factory)
        return self._cache_fn(self._fn_cache, key, self._build)

    def _window_shape(self) -> tuple:
        """The window kernel's table dimensions and build parameters."""
        H, CC = self._H, self._CC
        I, T, CQ, RT, RA, OP = self._caps()
        shape = {"n": H, "n+1": H + 1, "cc": CC, "cc+1": CC + 1, "I": I,
                 "T": T, "CQ": CQ, "RT": RT, "RA": RA, "OP": OP,
                 "asys": ASYS_N, "tel": TEL_N, "mark": MARK_N,
                 "out": self.cap_out + 1, "tr": self.cap_tr + 1}
        params = {"n": H, "conns": CC, "cap_i": I, "cap_t": T,
                  "cap_cq": CQ, "cap_rt": RT, "cap_ra": RA, "cap_op": OP,
                  "cap_out": self.cap_out, "cap_tr": self.cap_tr,
                  "tracing": int(self.tracing), "k_pkts": self.dctcp_k[0],
                  "k_bytes": self.dctcp_k[1], "th_cache": 1}
        return shape, params

    def _window_step(self):
        """The eager loop's window step: the hook's; None runs the eager
        window."""
        if self.window_factory is None:
            return None
        return self.window_factory(*self._window_shape())

    def _span_shape(self) -> tuple:
        """The span kernel's table dimensions and build parameters: the
        window kernel's, with the graph's nodes and the round end's
        words."""
        shape, params = self._window_shape()
        shape["v"] = len(self._lat)
        tel_iv, fab_iv = self._sample_ivs()
        params.update(n_nodes=len(self._lat), k0=self._k[0], k1=self._k[1],
                      bootstrap_end=self.bootstrap_end,
                      time_never=TIME_NEVER, tel_iv=tel_iv, fab_iv=fab_iv)
        return shape, params

    def _span_step(self):
        """A build's span step: the hook's, else the span kernel's on the
        card with no window hook; None runs the eager loop."""
        factory = self.span_factory
        if factory is None:
            if self.device.type != "cuda" or self.window_factory is not None:
                return None
            factory = TCP_SPAN.bind
        return factory(*self._span_shape())

    def _build(self):
        """Return `run(st, start, stop, limit, runahead, max_rounds)`,
        the eager twin of the reference's jitted span loop.  Its parts
        hang on it: `run.prepare(st)` makes a span's local buffers and
        indexes, `run.window_plain(st, window_end)` steps one window
        eagerly (the window kernel's plain version), `run.round_end(st,
        window_end)` the eager round end, `run.span` is the build's span
        step (None: the eager loop) and `run.step` the eager loop's
        window step (None: the eager window).  `run` updates its input
        state in place (the reference's donation semantics), so a retry
        re-exports."""
        H = self._H
        CC = self._CC
        I, T, CQ, RT, RA, OP = self._caps()
        O = self.cap_out
        TR = self.cap_tr
        tracing = self.tracing
        k_pkts, k_bytes = self.dctcp_k
        dev = self.device
        span = self._span_step()
        step = None if span is not None else self._window_step()
        i64 = torch.int64
        hidx = torch.arange(H, dtype=i64, device=dev)
        # Out-of-bounds scatters: conn-major masked lanes write the
        # trash row CC (JAX writes COOB = CC+1 with mode="drop").
        TRASH = CC
        relay1 = RELAY1_LAW.bind(H, OP, CC)
        relay2 = RELAY2_LAW.bind(H, CQ, CC)
        tel_iv, fab_iv = self._sample_ivs()
        where = torch.where

        def full(n, v, dtype=i64):
            return torch.full((n,), v, dtype=dtype, device=dev)

        def shl(a, b):
            if not isinstance(a, torch.Tensor):
                a = torch.full_like(b, a)
            return torch.bitwise_left_shift(a, b)

        def hput(arr, mask, col, val):
            """Masked element write into a host-major (H, W) array: the
            JAX `.at[mrows(mask), col].set(val, mode="drop")`.  Masked
            lanes write back their own old value (each lane owns its
            row, so no two lanes collide)."""
            # Python scalars stay host scalars (a 0-d device tensor made
            # from one would cost a host-to-device copy and a sync).
            arr[hidx, col] = where(mask, val, arr[hidx, col]).to(arr.dtype)

        def s_sub(a, b):
            d = (a - b) & M32
            return d - where(d >= SEQ_HALF, SEQ_MOD, 0)

        def s_add(a, n):
            # JAX casts to uint32; the port masks int64 to 32 bits.
            return (a + n) & M32

        def s_lt(a, b):
            return s_sub(a, b) < 0

        def s_leq(a, b):
            return s_sub(a, b) <= 0

        def mark_abort(st, cond, bit, site=0):
            if isinstance(cond, bool):  # a host-side condition
                if cond:
                    st["abort_code"] = st["abort_code"] | bit
                    st["abort_site"] = where(st["abort_site"] == 0, site,
                                             st["abort_site"])
                return
            hit = cond if cond.dim() == 0 else cond.any()
            st["abort_code"] = st["abort_code"] | where(hit, bit, 0)
            st["abort_site"] = where(hit & (st["abort_site"] == 0), site,
                                     st["abort_site"])

        def draw_seq(st, mask):
            v = st["event_seq"]
            st["event_seq"] = where(mask, v + 1, v)
            return v

        def th_push(st, mask, time, seq, kind, tgt):
            if not active(mask):
                return
            lanes = lanes_of(mask)
            tv = st["th_valid"][lanes]                       # (n, T)
            free = torch.argmin(tv.to(torch.uint8), dim=1)  # first free
            overflow = tv.all(dim=1)
            for key, v in (("th_time", time), ("th_seq", seq),
                           ("th_kind", kind), ("th_tgt", tgt),
                           ("th_valid", True)):
                arr = st[key]
                if isinstance(v, torch.Tensor) and v.dim() == 1:
                    v = v[lanes]
                # an overflowing lane writes nothing (JAX: dropped)
                arr[lanes, free] = where(overflow, arr[lanes, free],
                                         v).to(arr.dtype)
            mark_abort(st, overflow.any(), AB_STRUCT, 1)

        def th_min(st):
            t = where(st["th_valid"], st["th_time"], I64_MAX)
            best_t = t.min(dim=1).values
            s = where(t == best_t[:, None], st["th_seq"], I64_MAX)
            slot = torch.argmin(s, dim=1)
            return (best_t, st["th_kind"][hidx, slot],
                    st["th_tgt"][hidx, slot], slot)

        # -------- conn gather/scatter via the per-host cur register --

        cur_memo = [None, None]  # (cur tensor, its clamp)

        def cur_c(st):
            # JAX gathers clamp out-of-range indices; the port clamps
            # explicitly (memoized: `cur` changes at only two sites).
            cur = st["cur"]
            if cur_memo[0] is not cur:
                cur_memo[0] = cur
                cur_memo[1] = cur.clamp(0, CC - 1)
            return cur_memo[1]

        def lanes_of(mask):
            """Indices of the active lanes (one host sync).  The heavy
            per-lane (H, W) work below runs on these rows only: every
            consumer reads the results on its mask's lanes alone, as
            the reference's masked writes do."""
            return mask.nonzero().squeeze(1)

        def spread(lanes, v, fill=0):
            """(n,) values of the active lanes -> an (H,) lane vector."""
            out = torch.full((H,), fill, dtype=v.dtype, device=dev)
            out[lanes] = v
            return out

        def active(mask) -> bool:
            """Any lane active?  The reference guards each stage with
            `lax.cond(mask.any())`; here the guard is one host sync,
            and a skipped stage saves its hundred-odd launches.  Every
            stage is an identity on a mask with no active lane, so the
            guard changes no state bit."""
            return bool(mask.any())

        def cg(st, key):
            return st[key][cur_c(st)]

        def crows(st, mask):
            return where(mask & (st["cur"] >= 0), st["cur"], TRASH)

        def cput(st, key, rows, v):
            """Conn-major row write (masked lanes carry rows == TRASH)."""
            arr = st[key]
            arr[rows] = v.to(arr.dtype) if isinstance(v, torch.Tensor) \
                else v

        def cinc(st, key, rows):
            """Conn-major `.at[rows].add(1, mode="drop")`."""
            st[key].index_put_((rows,), torch.ones_like(rows),
                               accumulate=True)

        def cset(st, mask, **vals):
            rows = crows(st, mask)
            for key, v in vals.items():
                cput(st, key, rows, v)

        def fct_touch(st, mask, nbytes, inbound):
            now = st["now"]
            fb = cg(st, "c_fbyte")
            key = "c_bin" if inbound else "c_bout"
            cset(st, mask, **{
                "c_fbyte": where(mask & (fb < 0), now, fb),
                "c_lbyte": where(mask, now, cg(st, "c_lbyte")),
                key: cg(st, key) + where(mask, nbytes, 0),
            })

        # -------- trace / outbox appends (flat buffers) --------------

        def seq_append(st, cap_total, mask, cols, count_key, abort_bit):
            if not active(mask):
                return
            n = st[count_key]
            rank = torch.cumsum(mask, 0) - 1
            # Masked lanes and lanes past the capacity land in the trash
            # slot at index cap_total (JAX drops them).
            slot = where(mask & (n + rank < cap_total), n + rank,
                         cap_total)
            for key, v in cols.items():
                st[key][slot] = v
            total = n + mask.sum()
            st[count_key] = total
            mark_abort(st, total > cap_total - H, abort_bit)

        def tr_append(st, mask, time, kind, pk, reason):
            if not tracing:
                return
            seq_append(
                st, TR, mask,
                {"tr_t": time, "tr_kind": kind,
                 "tr_srchost": pk["srchost"], "tr_pseq": pk["pseq"],
                 "tr_sip": pk["sip"], "tr_sport": pk["sport"],
                 "tr_dip": pk["dip"], "tr_dport": pk["dport"],
                 "tr_plen": pk["plen"], "tr_reason": reason,
                 "tr_owner": hidx}, "tr_n", AB_TRACE)

        # -------- TCP helpers (connection.py twins, lane-vectorized) --

        def recv_window(st):
            cap = shl(MAX_WINDOW, cg(st, "c_ourws"))
            space = (cg(st, "c_rbmax") - cg(st, "c_rblen")).clamp(min=0)
            return torch.minimum(cap, space)

        def wire_window(st):
            # non-SYN segments only in-domain: always scaled
            return (recv_window(st) >> cg(st, "c_ourws")).clamp(
                max=MAX_WINDOW)

        def sack_blocks(st, mask):
            """Merged reassembly runs for the masked lanes' cur conns:
            (nsk, s0,e0,s1,e1,s2,e2) — connection.py _sack_blocks.
            Other lanes read zeros (their emissions are dropped)."""
            lanes = lanes_of(mask)
            n = lanes.shape[0]
            cur = cur_c(st)[lanes]
            valid = st["ra_valid"][cur]                     # (n, RA)
            seq = st["ra_seq"][cur]
            plen = st["ra_plen"][cur]
            rcvnxt = st["c_rcvnxt"][cur]
            rel = where(valid, s_sub(seq, rcvnxt[:, None]), I64_MAX)
            order = torch.argsort(rel, dim=1, stable=True)
            rs = rel.gather(1, order)                       # starts
            re = rs + where(valid, plen, 0).gather(1, order)  # ends
            sv = valid.gather(1, order)
            # merged-run boundaries: start beyond the running max end
            prev_end = torch.cat(
                [torch.full((n, 1), -I64_MAX, dtype=i64, device=dev),
                 torch.cummax(re, dim=1).values[:, :-1]], dim=1)
            newrun = sv & (rs > prev_end)
            run_id = torch.cumsum(newrun, dim=1)            # 1-based
            run_end = torch.cummax(where(sv, re, -I64_MAX), dim=1).values
            nsk = run_id.max(dim=1).values.clamp(max=3)
            outs = []
            for r in range(3):
                inr = sv & (run_id == r + 1)
                srel = where(newrun & (run_id == r + 1), rs,
                             I64_MAX).min(dim=1).values
                erel = where(inr, run_end, -I64_MAX).max(dim=1).values
                has = inr.any(dim=1)
                outs += [where(has, s_add(rcvnxt, srel), 0),
                         where(has, s_add(rcvnxt, erel), 0)]
            return tuple(spread(lanes, v) for v in (nsk, *outs))

        def take_ts_echo(st, mask):
            tse = cg(st, "c_tsrecent")
            cset(st, mask, c_tsrecent=where(mask, 0, tse))
            return tse

        def emit(st, mask, tseq, plen, flags, with_sacks, track,
                 fresh=False):
            """One segment from each masked lane's cur conn into its
            egress ring (emission order IS flush order); every in-domain
            emission carries ACK, echoes ECE, and fresh data consumes a
            pending one-shot CWR."""
            if not active(mask):
                return
            now = st["now"]
            win = wire_window(st)
            if with_sacks:
                nsk, s0, e0, s1, e1, s2, e2 = sack_blocks(st, mask)
            else:
                z = torch.zeros(H, dtype=i64, device=dev)
                nsk = s0 = e0 = s1 = e1 = s2 = e2 = z
            tse = take_ts_echo(st, mask)
            fl = flags | where(cg(st, "c_ece") == 1, F_ECE, 0)
            if fresh:
                do_cwr = mask & (plen > 0) & (cg(st, "c_cwrp") == 1) \
                    & (cg(st, "c_ecnact") == 1)
                fl = fl | where(do_cwr, F_CWR, 0)
                cset(st, do_cwr, c_cwrp=0)
            ecn = where((cg(st, "c_ecnact") == 1) & (plen > 0), ECN_ECT0,
                        0)
            pseq = st["packet_seq"]
            st["packet_seq"] = where(mask, pseq + 1, pseq)
            cur = cur_c(st)
            tail = st["op_len"][cur] % OP
            over = mask & (st["op_len"][cur] - st["op_pos"][cur] >= OP - 1)
            mark_abort(st, over.any(), AB_STRUCT, 2)
            rows = crows(st, mask)
            vals = {"srchost": hidx, "pseq": pseq,
                    "sip": cg(st, "c_lip"), "sport": cg(st, "c_lport"),
                    "dip": cg(st, "c_pip"), "dport": cg(st, "c_pport"),
                    "tseq": tseq, "tack": cg(st, "c_rcvnxt"),
                    "tflags": fl, "twin": win, "tsv": now + 1, "tse": tse,
                    "plen": plen, "nsk": nsk,
                    "sk0s": s0, "sk0e": e0, "sk1s": s1, "sk1e": e1,
                    "sk2s": s2, "sk2e": e2, "ecn": ecn}
            for kk in PK_KEYS:
                st[f"op_{kk}"][rows, tail] = vals[kk]
            cinc(st, "op_len", rows)
            cinc(st, "c_segssent", rows)
            # note_ack_sent: segs_since_ack=0, delack cleared
            cput(st, "c_ssa", rows, 0)
            cput(st, "c_delackdl", rows, -1)
            st["eflag"] = where(mask, 1, st["eflag"])
            if track:
                rtail = st["rtx_len"][cur] % RT
                rover = mask & (st["rtx_len"][cur] - st["rtx_pos"][cur]
                                >= RT - 1)
                mark_abort(st, rover.any(), AB_STRUCT, 3)
                st["rtx_seq"][rows, rtail] = tseq
                st["rtx_plen"][rows, rtail] = plen
                st["rtx_rtxed"][rows, rtail] = 0
                st["rtx_sacked"][rows, rtail] = 0
                st["rtx_sent"][rows, rtail] = now
                cinc(st, "rtx_len", rows)
                arm = mask & (cg(st, "c_rtodl") < 0)
                cset(st, arm, c_rtodl=now + cg(st, "c_rto"))

        def emit_ack(st, mask):
            emit(st, mask, cg(st, "c_sndnxt"),
                 torch.zeros(H, dtype=i64, device=dev), F_ACK,
                 with_sacks=True, track=False)

        # -------- relays ---------------------------------------------

        def op_relay1(st, mask):
            """inet-out drain: iface_pop over the host's queued conns
            (min head priority = the engine's per-iface qdisc heap),
            SND trace, token bucket, cross-host outbox."""
            now = st["now"]
            use_pend = mask & (st["r1_pk_valid"] == 1)
            # qdisc selection: min head-pseq among queued conns (the
            # trash row has c_host = -1 and is never eligible)
            head = st["op_pos"] % OP
            cidx = torch.arange(CC + 1, dtype=i64, device=dev)
            nonempty = st["op_len"] > st["op_pos"]
            c_host = st["c_host"]
            eligible = (st["c_queued"] == 1) & nonempty & (c_host >= 0)
            head_prio = st["op_pseq"][cidx, head]
            chost_safe = where(c_host >= 0, c_host, H)
            best = full(H + 1, I64_MAX).scatter_reduce(
                0, chost_safe, where(eligible, head_prio, I64_MAX),
                "amin")[:H]
            pop = mask & ~use_pend & (best < I64_MAX)
            sel_match = eligible & (head_prio
                                    == best[chost_safe.clamp(0, H - 1)])
            sel = full(H + 1, -1).scatter_reduce(
                0, chost_safe, where(sel_match, cidx, -1), "amax")[:H]
            # The lane-local tail in one launch (the packet, eth send
            # counters, bucket, throttle stash, forward and link-down
            # counters), in place; it reads op_pos before the pop below.
            throttled, linkdn, fwd, done, when, pk = relay1(st, mask, pop,
                                                            sel)
            # iface_pop: dequeue + requeue-if-more + SND trace
            sel_safe = sel.clamp(0, CC - 1)
            rows = where(pop, sel, TRASH)
            cinc(st, "op_pos", rows)
            still = st["op_len"][sel_safe] > st["op_pos"][sel_safe]
            cput(st, "c_queued", rows, where(still, 1, 0))
            tr_append(st, pop, now, TR_SND, pk, 0)
            sq = draw_seq(st, throttled)
            th_push(st, throttled, when, sq, TK_RELAY, 1)
            tr_append(st, linkdn, now, TR_DRP, pk, RSN_LINKDOWN)
            # device_push(dev=2): dst must be a remote engine host
            ips_sorted = st["_ips_sorted"]
            dslot = torch.searchsorted(ips_sorted, pk["dip"]).clamp(
                max=H - 1)
            found = ips_sorted[dslot] == pk["dip"]
            dst = st["_ips_perm"][dslot]
            bad = fwd & (~found | (dst == hidx))
            mark_abort(st, bad.any(), AB_STRUCT, 4)
            hit = fwd & found
            sq = draw_seq(st, hit)
            cols = {"out_src": hidx, "out_dst": dst, "out_seq": sq,
                    "out_t": now}
            for kk in PK_KEYS:
                cols[f"out_{kk}"] = pk[kk]
            seq_append(st, O, hit, cols, "out_n", AB_OUT)
            st["cont"] = where(done, st["then"], st["cont"])

        def op_relay2(st, mask):
            """inet-in drain: CoDel pop -> token bucket ->
            iface_receive -> conn match -> hand to C_TCPIN."""
            now = st["now"]
            # The lane-local tail in one launch (CoDel dequeue, head
            # law, control-law ladder, drop counters, bucket, throttle
            # stash, forward and eth counters), in place.
            codel_drop, throttled, fwd, done, when, pk = relay2(st, mask)
            tr_append(st, codel_drop, now, TR_DRP, pk, RSN_CODEL)
            sq = draw_seq(st, throttled)
            th_push(st, throttled, when, sq, TK_RELAY, 2)
            mark_abort(st, (fwd & (pk["dip"] != st["eth_ip"])).any(),
                       AB_STRUCT, 5)
            # conn lookup: (dsthost, src-ip-host, sport) key
            ips_sorted = st["_ips_sorted"]
            sslot = torch.searchsorted(ips_sorted, pk["sip"]).clamp(
                max=H - 1)
            sfound = ips_sorted[sslot] == pk["sip"]
            sidx = st["_ips_perm"][sslot]
            akey = (hidx * H + sidx) * 65536 + pk["sport"]
            kslot = torch.searchsorted(st["_ckeys"], akey).clamp(
                max=CC - 1)
            kfound = sfound & (st["_ckeys"][kslot] == akey)
            conn = st["_ckperm"][kslot]
            good_port = kfound & (st["c_lport"][conn] == pk["dport"])
            mark_abort(st, (fwd & ~good_port).any(), AB_STRUCT, 6)
            hit = fwd & good_port
            # delivered: trace RCV at arrival
            st["pkts_recv"] = where(hit, st["pkts_recv"] + 1,
                                    st["pkts_recv"])
            tr_append(st, hit, now, TR_RCV, pk, 0)
            # hand to the state machine: C_TCPIN on this conn
            st["cur"] = where(hit, conn, st["cur"])
            for kk in PK_KEYS:
                st[f"ar_{kk}"] = where(hit, pk[kk], st[f"ar_{kk}"])
            st["ret"] = where(hit, C_R2, st["ret"])
            st["cont"] = where(hit, C_TCPIN, st["cont"])
            # r2 drains only ever start from an event, so the return is
            # always idle — `then` stays r1's register.
            st["cont"] = where(done, C_IDLE, st["cont"])

        # -------- TCP state machine ----------------------------------

        def update_rtt(st, mask, sample):
            sample = sample.clamp(min=1)
            srtt = cg(st, "c_srtt")
            rttvar = cg(st, "c_rttvar")
            first = srtt == 0
            n_srtt = where(first, sample, (7 * srtt + sample) // 8)
            err = (srtt - sample).abs()
            n_var = where(first, sample // 2, (3 * rttvar + err) // 4)
            rto = n_srtt + (4 * n_var).clamp(min=1_000_000)
            rto = rto.clamp(MIN_RTO_NS, MAX_RTO_NS)
            cset(st, mask, c_srtt=n_srtt, c_rttvar=n_var, c_rto=rto)

        ar_rt = torch.arange(RT, dtype=i64, device=dev)[None, :]

        def rtx_rows(st, lanes):
            """Gathered rtx rings for the given lanes' cur conns: (n, RT)
            views in ring order, the valid mask, and the write-back
            rows (`crow`: the cur conn, or TRASH for cur < 0)."""
            cur = cur_c(st)[lanes]
            pos = st["rtx_pos"][cur][:, None]
            ln = st["rtx_len"][cur][:, None]
            idx = (pos + ar_rt) % RT
            rows = {k: st[k][cur].gather(1, idx)
                    for k in ("rtx_seq", "rtx_plen", "rtx_rtxed",
                              "rtx_sacked", "rtx_sent")}
            rows["valid"] = ar_rt < (ln - pos)
            rows["idx"] = idx
            rows["crow"] = where(st["cur"][lanes] >= 0, cur, TRASH)
            return rows

        def rtx_scatter(st, rows, keys):
            r = rows["crow"][:, None].expand_as(rows["idx"])
            for k in keys:
                st[k][r, rows["idx"]] = rows[k]

        def clear_acked(st, mask):
            """Pop leading fully-acked rtx entries (ring-order run)."""
            if not active(mask):
                return
            lanes = lanes_of(mask)
            rows = rtx_rows(st, lanes)
            end = s_add(rows["rtx_seq"], rows["rtx_plen"])
            una = st["c_snduna"][cur_c(st)[lanes]][:, None]
            covered = rows["valid"] & s_leq(end, una)
            lead = torch.cumprod(covered.to(i64), dim=1)
            pops = lead.sum(dim=1)
            # pos/len grow monotonically (mod applied at access)
            new_pos = st["rtx_pos"][cur_c(st)[lanes]] + pops
            cput(st, "rtx_pos", rows["crow"], new_pos)

        def retransmit_one(st, mask):
            """First non-SACKed rtx entry (head fallback), re-stamped and
            re-emitted with the current scoreboard attached."""
            if not active(mask):
                return
            now = st["now"]
            lanes = lanes_of(mask)
            rows = rtx_rows(st, lanes)
            cand = rows["valid"] & (rows["rtx_sacked"] == 0)
            first = where(cand.any(dim=1),
                          torch.argmax(cand.to(torch.uint8), dim=1), 0)
            has_l = rows["valid"].any(dim=1)
            sel = first[:, None]
            seq = rows["rtx_seq"].gather(1, sel)[:, 0]
            plen = rows["rtx_plen"].gather(1, sel)[:, 0]
            slot = rows["idx"].gather(1, sel)[:, 0]
            r = where(has_l, rows["crow"], TRASH)
            st["rtx_sent"][r, slot] = now[lanes]
            st["rtx_rtxed"][r, slot] = 1
            cinc(st, "c_rtxcount", r)
            emit(st, spread(lanes, has_l, False), spread(lanes, seq),
                 spread(lanes, plen), F_ACK | F_PSH, with_sacks=True,
                 track=False)

        def rtx_nonempty(st):
            cur = cur_c(st)
            return st["rtx_len"][cur] > st["rtx_pos"][cur]

        def op_tcpin(st, mask):
            """on_packet minus the push_data / reassembly-drain loops
            (those continue as C_PUSH / C_DRAIN)."""
            now = st["now"]
            pk = {kk: st[f"ar_{kk}"] for kk in PK_KEYS}
            plen = pk["plen"]
            cset(st, mask, c_segsrecv=cg(st, "c_segsrecv")
                 + where(mask, 1, 0))
            # in-domain wire: synchronized-state segments only
            bad = mask & (((pk["tflags"] & (F_SYN | F_FIN | F_RST)) != 0)
                          | ((pk["tflags"] & F_ACK) == 0))
            # a data segment arriving at a sender (or acking unsent
            # data) leaves the modelled tgen roles
            bad |= mask & (plen > 0) & (cg(st, "c_role") == 1)
            bad |= mask & s_lt(cg(st, "c_sndnxt"), pk["tack"])
            mark_abort(st, bad.any(), AB_STRUCT, 7)
            # RFC 3168 receiver: CWR ends the echo episode, a CE-marked
            # arrival (re)starts it — in that order.
            ecnact = cg(st, "c_ecnact") == 1
            cwr_in = mask & ecnact & ((pk["tflags"] & F_CWR) != 0)
            cset(st, cwr_in, c_ece=0)
            ce_in = mask & ecnact & (pk["ecn"] == ECN_CE)
            cset(st, ce_in, c_ece=1, c_ceseen=cg(st, "c_ceseen") + 1)
            # RFC 7323 ts_recent update (covering the ack point)
            span = plen.clamp(min=1)
            upd = mask & (pk["tsv"] != 0) \
                & s_leq(pk["tseq"], cg(st, "c_rcvnxt")) \
                & s_lt(cg(st, "c_rcvnxt"), s_add(pk["tseq"], span))
            cset(st, upd, c_tsrecent=where(upd, pk["tsv"],
                                           cg(st, "c_tsrecent")))
            # RTTM: sample only from a segment acking NEW data
            samp = mask & (pk["tse"] != 0) \
                & (cg(st, "c_rtobackoff") == 0) \
                & s_lt(cg(st, "c_snduna"), pk["tack"]) \
                & s_leq(pk["tack"], cg(st, "c_sndnxt"))
            update_rtt(st, samp, now - (pk["tse"] - 1))
            # ---- on_ack ----
            ack = pk["tack"]
            wnd = shl(pk["twin"], cg(st, "c_peerws"))
            wchanged = wnd != cg(st, "c_sndwnd")
            cset(st, mask, c_sndwnd=where(mask, wnd, cg(st, "c_sndwnd")))
            open_persist = mask & (wnd > 0) & (cg(st, "c_persistdl") >= 0)
            cset(st, open_persist, c_persistdl=-1, c_persistiv=0)
            # SACK scoreboard marks
            have_sack = mask & (pk["nsk"] > 0)
            if active(have_sack):
                lanes = lanes_of(have_sack)
                rows = rtx_rows(st, lanes)
                end = s_add(rows["rtx_seq"], rows["rtx_plen"])
                cov = torch.zeros_like(rows["valid"])
                nsk_l = pk["nsk"][lanes]
                for b in range(3):
                    bs = pk[f"sk{b}s"][lanes][:, None]
                    be = pk[f"sk{b}e"][lanes][:, None]
                    bv = (nsk_l > b)[:, None]
                    cov |= bv & s_leq(bs, rows["rtx_seq"]) \
                        & s_leq(end, be)
                newly = rows["valid"] & (rows["rtx_sacked"] == 0) & cov
                rows["rtx_sacked"] = where(newly, 1, rows["rtx_sacked"])
                rtx_scatter(st, rows, ("rtx_sacked",))
                cset(st, have_sack, c_sackskip=cg(st, "c_sackskip")
                     + spread(lanes, newly.sum(dim=1)))
            # ECN sender side: after the SACK marks, before the
            # new-ack/dupack dispatch (snd_una still pre-ack).
            ece_fl = mask & ecnact & ((pk["tflags"] & F_ECE) != 0)
            new_ack0 = mask & s_lt(cg(st, "c_snduna"), pk["tack"])
            acked0 = s_sub(pk["tack"], cg(st, "c_snduna"))
            is_d = cg(st, "c_cc") == CC_DCTCP
            acc = new_ack0 & ecnact & is_d
            cset(st, acc,
                 c_totack=cg(st, "c_totack") + where(acc, acked0, 0),
                 c_ceack=cg(st, "c_ceack")
                 + where(acc & ece_fl, acked0, 0))
            # window boundary: fold the echo fraction into alpha
            wb = acc & s_lt(cg(st, "c_dwend"), pk["tack"])
            alpha = cg(st, "c_alpha")
            nalpha = torch.clamp(
                alpha - (alpha >> DCTCP_G_SHIFT)
                + (cg(st, "c_ceack") << (DCTCP_SHIFT - DCTCP_G_SHIFT))
                // cg(st, "c_totack").clamp(min=1), max=DCTCP_MAX_ALPHA)
            cset(st, wb, c_alpha=nalpha, c_ceack=0, c_totack=0,
                 c_dwend=cg(st, "c_sndnxt"))
            # one cut per window; CWR announces it on fresh data
            red = ece_fl & (cg(st, "c_fastrec") == 0) \
                & s_lt(cg(st, "c_cwrend"), pk["tack"])
            mss_e = cg(st, "c_congmss")
            flight0 = s_sub(cg(st, "c_sndnxt"), cg(st, "c_snduna"))
            cw0 = cg(st, "c_cwnd")
            r_cw = torch.maximum(flight0 // 2, 2 * mss_e)
            d_cw = torch.maximum(
                cw0 - ((cw0 * cg(st, "c_alpha")) >> (DCTCP_SHIFT + 1)),
                2 * mss_e)
            ncw = where(is_d, d_cw, r_cw)
            cset(st, red, c_cwnd=where(red, ncw, cw0),
                 c_ssthresh=where(red, ncw, cg(st, "c_ssthresh")),
                 c_cwrend=cg(st, "c_sndnxt"), c_cwrp=1)
            # new ack / dupack
            rtx_ne = rtx_nonempty(st)
            new_ack = mask & s_lt(cg(st, "c_snduna"), ack)
            pure = plen == 0
            dup = mask & ~new_ack & (ack == cg(st, "c_snduna")) \
                & rtx_ne & pure & ~wchanged
            # handle_new_ack
            acked = s_sub(ack, cg(st, "c_snduna"))
            cset(st, new_ack,
                 c_snduna=where(new_ack, ack, cg(st, "c_snduna")),
                 c_dupacks=0, c_rtobackoff=0)
            clear_acked(st, new_ack)
            has_srtt = new_ack & (cg(st, "c_srtt") > 0)
            rto2 = (cg(st, "c_srtt")
                    + (4 * cg(st, "c_rttvar")).clamp(min=1_000_000)
                    ).clamp(MIN_RTO_NS, MAX_RTO_NS)
            cset(st, has_srtt, c_rto=rto2)
            in_rec = new_ack & (cg(st, "c_fastrec") == 1)
            rec_exit = in_rec & (s_lt(cg(st, "c_recover"), ack)
                                 | (ack == cg(st, "c_recover")))
            cset(st, rec_exit, c_fastrec=0, c_cwnd=cg(st, "c_ssthresh"))
            partial = in_rec & ~rec_exit
            retransmit_one(st, partial)
            # reno on_new_ack (not in recovery; an ack that just
            # triggered the ECN cut must not also grow the window)
            plain = new_ack & ~in_rec & ~red
            mss_c = cg(st, "c_congmss")
            cwnd = cg(st, "c_cwnd")
            ss = plain & (cwnd < cg(st, "c_ssthresh"))
            cwnd2 = where(ss, cwnd + torch.minimum(acked, 2 * mss_c),
                          cwnd + (mss_c * mss_c
                                  // cwnd.clamp(min=1)).clamp(min=1))
            cset(st, plain, c_cwnd=where(plain, cwnd2, cwnd))
            # RTO restart
            cset(st, new_ack, c_rtodl=where(rtx_nonempty(st),
                                            now + cg(st, "c_rto"), -1))
            # handle_dupack
            cset(st, dup, c_dupacks=cg(st, "c_dupacks") + where(dup, 1, 0))
            d_rec = dup & (cg(st, "c_fastrec") == 1)
            cset(st, d_rec, c_cwnd=cg(st, "c_cwnd") + cg(st, "c_congmss"))
            d_thr = dup & ~d_rec & (cg(st, "c_dupacks") == 3)
            flight = s_sub(cg(st, "c_sndnxt"), cg(st, "c_snduna"))
            cset(st, d_thr,
                 c_ssthresh=torch.maximum(flight // 2,
                                          2 * cg(st, "c_congmss")),
                 c_fastrec=1, c_recover=cg(st, "c_sndnxt"))
            cset(st, d_thr, c_cwnd=cg(st, "c_ssthresh")
                 + 3 * cg(st, "c_congmss"))
            retransmit_one(st, d_thr)
            # ---- on_data (receiver side; plen > 0) ----
            data = mask & (plen > 0)
            offset = s_sub(cg(st, "c_rcvnxt"), pk["tseq"])
            dup_data = data & (offset >= plen)
            emit_ack(st, dup_data)
            live = data & ~dup_data
            eff_seq = where(offset > 0, cg(st, "c_rcvnxt"), pk["tseq"])
            eff_len = where(offset > 0, plen - offset, plen)
            future = live & (s_sub(eff_seq, cg(st, "c_rcvnxt")) != 0)
            # reassembly setdefault (bounded by the receive buffer)
            cur = cur_c(st)
            rav = st["ra_valid"][cur]
            ras = st["ra_seq"][cur]
            exists = (rav & (ras == eff_seq[:, None])).any(dim=1)
            in_win = s_sub(eff_seq, cg(st, "c_rcvnxt")) < cg(st, "c_rbmax")
            store_it = future & in_win & ~exists
            # beyond the reassembly window: receiver discard
            st["drop_causes"][:, TEL_REASM_FULL] += future & ~in_win
            free = torch.argmin(rav.to(torch.uint8), dim=1)
            ra_over = store_it & rav.all(dim=1)
            mark_abort(st, ra_over.any(), AB_STRUCT, 8)
            rrows = crows(st, store_it & ~ra_over)
            st["ra_seq"][rrows, free] = eff_seq
            st["ra_plen"][rrows, free] = eff_len
            st["ra_valid"][rrows, free] = True
            emit_ack(st, future)
            # in-order delivery
            inord = live & ~future
            st["had_holes"] = where(inord, rav.any(dim=1).to(i64),
                                    st["had_holes"])
            space = cg(st, "c_rbmax") - cg(st, "c_rblen")
            take = torch.minimum(space, eff_len).clamp(min=0)
            # in-order bytes past the receive buffer: unacked tail, the
            # sender retransmits (TcpConn::deliver twin)
            st["drop_causes"][:, TEL_RECVWIN_TRUNC] += inord & (eff_len
                                                                > take)
            cset(st, inord,
                 c_rblen=cg(st, "c_rblen") + where(inord, take, 0),
                 c_rcvnxt=where(inord, s_add(cg(st, "c_rcvnxt"), take),
                                cg(st, "c_rcvnxt")))
            fct_touch(st, inord & (take > 0), take, inbound=True)
            # ---- continuation ----
            nxt = where(inord, C_DRAIN, where(data, C_FLUSH, C_PUSH))
            st["cont"] = where(mask, nxt, st["cont"])

        def op_drain(st, mask):
            """One reassembly chunk per micro-op (connection.py's
            while-rcv_nxt-in-reassembly loop)."""
            cur = cur_c(st)
            rav = st["ra_valid"][cur]
            ras = st["ra_seq"][cur]
            rap = st["ra_plen"][cur]
            match = rav & (ras == cg(st, "c_rcvnxt")[:, None])
            has = mask & match.any(dim=1)
            slot = torch.argmax(match.to(torch.uint8), dim=1)
            plen = rap.gather(1, slot[:, None])[:, 0]
            space = cg(st, "c_rbmax") - cg(st, "c_rblen")
            take = torch.minimum(space, plen).clamp(min=0)
            st["drop_causes"][:, TEL_RECVWIN_TRUNC] += has & (plen > take)
            cset(st, has,
                 c_rblen=cg(st, "c_rblen") + where(has, take, 0),
                 c_rcvnxt=where(has, s_add(cg(st, "c_rcvnxt"), take),
                                cg(st, "c_rcvnxt")))
            fct_touch(st, has & (take > 0), take, inbound=True)
            st["ra_valid"][crows(st, has), slot] = False
            st["cont"] = where(mask & ~has, C_ACKDATA, st["cont"])

        def op_ackdata(st, mask):
            """ack_data: every second in-order segment acks now; holes
            or a pinched window force it; else the 40ms delack."""
            now = st["now"]
            cset(st, mask, c_ssa=cg(st, "c_ssa") + where(mask, 1, 0))
            fire = mask & ((st["had_holes"] == 1)
                           | (cg(st, "c_ssa") >= 2)
                           | st["ra_valid"][cur_c(st)].any(dim=1)
                           | (recv_window(st) < cg(st, "c_effmss")))
            emit_ack(st, fire)
            arm = mask & ~fire & (cg(st, "c_delackdl") < 0)
            cset(st, arm, c_delackdl=now + DELACK_NS)
            st["had_holes"] = where(mask, 0, st["had_holes"])
            st["cont"] = where(mask, C_FLUSH, st["cont"])

        def op_push(st, mask):
            """push_data: one eff_mss segment per micro-op within
            min(cwnd, peer window); Nagle holds a sub-MSS tail."""
            now = st["now"]
            window = torch.minimum(cg(st, "c_cwnd"), cg(st, "c_sndwnd"))
            flight = s_sub(cg(st, "c_sndnxt"), cg(st, "c_snduna"))
            sblen = cg(st, "c_sblen")
            can = mask & (sblen > 0) & (flight < window)
            budget = torch.minimum(window - flight, cg(st, "c_effmss"))
            nagle_hold = can & (cg(st, "c_nodelay") == 0) \
                & (sblen < budget) & (flight > 0)
            chunk = torch.minimum(sblen, budget)
            do = can & ~nagle_hold & (chunk > 0)
            emit(st, do, cg(st, "c_sndnxt"), chunk, F_ACK | F_PSH,
                 with_sacks=False, track=True, fresh=True)
            cset(st, do,
                 c_sblen=cg(st, "c_sblen") - where(do, chunk, 0),
                 c_sndnxt=where(do, s_add(cg(st, "c_sndnxt"), chunk),
                                cg(st, "c_sndnxt")))
            fct_touch(st, do, chunk, inbound=False)
            stop = mask & ~do
            # zero-window persist arming
            parm = stop & (cg(st, "c_sndwnd") == 0) \
                & (cg(st, "c_sblen") > 0) & ~rtx_nonempty(st) \
                & (cg(st, "c_persistdl") < 0)
            cset(st, parm, c_persistiv=cg(st, "c_rto"),
                 c_persistdl=now + cg(st, "c_rto"))
            st["cont"] = where(stop, C_FLUSH, st["cont"])

        def op_flush(st, mask):
            """tcp_flush's notify: register the socket with the iface
            qdisc and kick the inet-out relay if it is idle."""
            need = mask & (st["eflag"] == 1) & (cg(st, "c_queued") == 0)
            cset(st, need, c_queued=1)
            st["eflag"] = where(mask, 0, st["eflag"])
            kick = need & (st["r1_pending"] == 0)
            st["cont"] = where(mask, C_ARM, st["cont"])
            st["cont"] = where(kick, C_R1, st["cont"])
            st["then"] = where(kick, C_ARM, st["then"])

        def next_deadline(st):
            nxt = full(H, I64_MAX)
            for key in ("c_rtodl", "c_delackdl", "c_persistdl"):
                d = cg(st, key)
                nxt = where((d >= 0) & (d < nxt), d, nxt)
            return nxt

        def op_arm(st, mask):
            """tcp_arm_timer + tcp_update_status (+ the deferred
            sendto-EAGAIN park)."""
            now = st["now"]
            nxt = next_deadline(st)
            have = nxt < I64_MAX
            arm = mask & have & (nxt != cg(st, "c_tmrdl"))
            cset(st, arm, c_tmrdl=where(arm, nxt, cg(st, "c_tmrdl")))
            sq = draw_seq(st, arm)
            th_push(st, arm, nxt, sq, TK_TCP, st["cur"])
            # update_status (ESTABLISHED lanes only in-domain)
            readable = cg(st, "c_rblen") > 0
            space = (cg(st, "c_sbmax") - cg(st, "c_sblen")) > 0
            old = cg(st, "c_status")
            set_bits = where(readable, S_READABLE, 0) \
                | where(space, S_WRITABLE, 0)
            clear_bits = where(~readable, S_READABLE, 0) & ~set_bits
            new = (old | set_bits) & ~clear_bits
            changed = where(mask, old ^ new, 0)
            cset(st, mask, c_status=where(mask, new, old))
            wake = mask & ((changed & cg(st, "c_await")) != 0) \
                & (cg(st, "c_wakep") == 0)
            sq = draw_seq(st, wake)
            th_push(st, wake, now, sq, TK_APP, st["cur"])
            cset(st, wake, c_wakep=1)
            # deferred sendto-EAGAIN: clear WRITABLE, park the stepper
            park = mask & (st["parkp"] == 1)
            cset(st, park, c_status=cg(st, "c_status") & ~S_WRITABLE,
                 c_await=S_WRITABLE, c_awaitseq=st["park_ctr"])
            st["park_ctr"] = where(park, st["park_ctr"] + 1,
                                   st["park_ctr"])
            st["parkp"] = where(park, 0, st["parkp"])
            st["cont"] = where(mask, where(park, C_IDLE, st["ret"]),
                               st["cont"])

        # -------- app steppers / timers ------------------------------

        def max_mem(bw, rtt, base):
            mem = bw * rtt // (8 * 1_000_000_000)
            return torch.minimum(mem.clamp(min=base), torch.full_like(
                mem, 10 * base))

        def op_app(st, mask):
            """One tcp_recv (client) / tcp_sendto (handler) per micro-op
            — the engine app loop with syscalls counted at the same
            points."""
            now = st["now"]
            client = mask & (cg(st, "c_role") == 0)
            handler = mask & (cg(st, "c_role") == 1)
            st["app_sys"][:, ASYS_RECV] += client
            st["app_sys"][:, ASYS_SEND] += handler
            # ---- client: recv 64 KiB or park ----
            empty = client & (cg(st, "c_rblen") == 0)
            cset(st, empty, c_await=S_READABLE, c_awaitseq=st["park_ctr"])
            st["park_ctr"] = where(empty, st["park_ctr"] + 1,
                                   st["park_ctr"])
            st["cont"] = where(empty, C_IDLE, st["cont"])
            got = client & ~empty
            take = cg(st, "c_rblen").clamp(max=1 << 16)
            win_before = recv_window(st)
            cset(st, got, c_rblen=cg(st, "c_rblen") - where(got, take, 0))
            winupd = got & (win_before < MSS) & (recv_window(st) >= MSS)
            emit_ack(st, winupd)
            # autotune_recv (socket_tcp.py twin)
            at = got & (cg(st, "c_rat") == 1)
            copied = cg(st, "c_atcopied") + where(at, take, 0)
            space2 = 2 * copied
            at_space = torch.maximum(cg(st, "c_atspace"), space2)
            grow = at & (at_space > cg(st, "c_rbmax"))
            nw = torch.minimum(at_space,
                               max_mem(st["bw_down"], cg(st, "c_srtt"),
                                       RMEM_MAX))
            cset(st, at, c_atcopied=copied, c_atspace=at_space)
            cset(st, grow & (nw > cg(st, "c_rbmax")), c_rbmax=nw)
            fresh = at & (cg(st, "c_atlast") == 0)
            cset(st, fresh, c_atlast=now)
            roll = at & ~fresh & (cg(st, "c_srtt") > 0) \
                & (now - cg(st, "c_atlast") > cg(st, "c_srtt"))
            cset(st, roll, c_atlast=now, c_atcopied=0)
            ngot = cg(st, "c_agot") + where(got, take, 0)
            cset(st, got, c_agot=ngot)
            # transfer completion leaves the modelled domain (close)
            mark_abort(st, (got & (ngot >= cg(st, "c_atotal"))).any(),
                       AB_STRUCT, 9)
            st["ret"] = where(got, C_APP, st["ret"])
            st["cont"] = where(got, C_FLUSH, st["cont"])
            # ---- handler: send up to 64 KiB or park ----
            want = (cg(st, "c_atotal") - cg(st, "c_agot")).clamp(
                max=1 << 16)
            space = cg(st, "c_sbmax") - cg(st, "c_sblen")
            w = torch.minimum(want, space).clamp(min=0)
            blocked = handler & (w == 0)
            st["parkp"] = where(blocked, 1, st["parkp"])
            st["ret"] = where(handler, C_APP, st["ret"])
            st["cont"] = where(blocked, C_FLUSH, st["cont"])
            wrote = handler & ~blocked
            nsent = cg(st, "c_agot") + where(wrote, w, 0)
            cset(st, wrote, c_sblen=cg(st, "c_sblen") + where(wrote, w, 0),
                 c_agot=nsent)
            # send completion -> shutdown_wr: out of the domain
            mark_abort(st, (wrote & (nsent >= cg(st, "c_atotal"))).any(),
                       AB_STRUCT, 10)
            st["cont"] = where(wrote, C_PUSH, st["cont"])

        def op_tmr(st, mask):
            """TK_TCP fire: stale entries re-arm; due deadlines run
            delack/persist/RTO in the engine's fixed order, then the
            flush chain."""
            now = st["now"]
            cset(st, mask, c_tmrdl=-1)
            nxt = next_deadline(st)
            have = nxt < I64_MAX
            fire = mask & have & (now >= nxt)
            stale = mask & ~fire
            rearm = stale & have
            cset(st, rearm, c_tmrdl=where(rearm, nxt, -1))
            sq = draw_seq(st, rearm)
            th_push(st, rearm, nxt, sq, TK_TCP, st["cur"])
            st["cont"] = where(stale, C_IDLE, st["cont"])
            # ---- on_timer (fire lanes) ----
            d_f = fire & (cg(st, "c_delackdl") >= 0) \
                & (now >= cg(st, "c_delackdl"))
            emit_ack(st, d_f)
            p_f = fire & (cg(st, "c_persistdl") >= 0) \
                & (now >= cg(st, "c_persistdl"))
            cset(st, p_f, c_persistdl=-1)
            probe = p_f & (cg(st, "c_sndwnd") == 0) \
                & (cg(st, "c_sblen") > 0) & ~rtx_nonempty(st)
            ones = torch.ones(H, dtype=i64, device=dev)
            emit(st, probe, cg(st, "c_sndnxt"), ones, F_ACK | F_PSH,
                 with_sacks=False, track=True, fresh=True)
            cset(st, probe,
                 c_sblen=cg(st, "c_sblen") - where(probe, 1, 0),
                 c_sndnxt=where(probe, s_add(cg(st, "c_sndnxt"), 1),
                                cg(st, "c_sndnxt")))
            fct_touch(st, probe, ones, inbound=False)
            niv = where(cg(st, "c_persistiv") > 0,
                        2 * cg(st, "c_persistiv"),
                        cg(st, "c_rto")).clamp(max=MAX_RTO_NS)
            cset(st, probe, c_persistiv=niv, c_persistdl=now + niv)
            # RTO
            r_f = fire & (cg(st, "c_rtodl") >= 0) \
                & (now >= cg(st, "c_rtodl"))
            rtx_ne = rtx_nonempty(st)
            cset(st, r_f & ~rtx_ne, c_rtodl=-1)
            r_go = r_f & rtx_ne
            flight = s_sub(cg(st, "c_sndnxt"), cg(st, "c_snduna"))
            cset(st, r_go,
                 c_ssthresh=torch.maximum(flight // 2,
                                          2 * cg(st, "c_congmss")),
                 c_cwnd=cg(st, "c_congmss"), c_dupacks=0, c_fastrec=0)
            # SACK reneging: forget every mark on RTO
            if active(r_go):
                rows = rtx_rows(st, lanes_of(r_go))
                rows["rtx_sacked"] = torch.zeros_like(rows["rtx_sacked"])
                rtx_scatter(st, rows, ("rtx_sacked",))
            cset(st, r_go,
                 c_rto=(2 * cg(st, "c_rto")).clamp(max=MAX_RTO_NS),
                 c_rtobackoff=cg(st, "c_rtobackoff") + 1)
            retransmit_one(st, r_go)
            cset(st, r_go, c_rtodl=now + cg(st, "c_rto"))
            st["ret"] = where(fire, C_IDLE, st["ret"])
            st["cont"] = where(fire, C_FLUSH, st["cont"])

        # -------- event pop ------------------------------------------

        def ib_head_time(st):
            pos = st["ib_pos"]
            safe = pos.clamp(max=I - 1)
            return where(st["ib_len"] > pos, st["ib_time"][hidx, safe],
                         I64_MAX), safe

        def next_event_time(st):
            ib_t, _ = ib_head_time(st)
            th_t = where(st["th_valid"], st["th_time"],
                         I64_MAX).min(dim=1).values
            return ib_t, th_t

        # The loop condition's timer-heap minimum, valid until the next
        # stage runs (the event pop is the first stage after it).
        th_memo = [None]

        def op_pop_event(st, mask, window_end):
            pos = st["ib_pos"]
            ib_t, safe = ib_head_time(st)
            tmin, tkind, ttgt, tslot = th_memo[0] or th_min(st)
            pick_ib = where(ib_t != tmin, ib_t < tmin, ib_t < I64_MAX)
            et = torch.minimum(ib_t, tmin)
            due = mask & (et < window_end)
            st["now"] = where(due, et, st["now"])
            st["events_run"] = where(due, st["events_run"] + 1,
                                     st["events_run"])
            # Down-host fault mask: arrivals at a dead/link-down host die
            # at their recorded instant; a dead host's timers discard.
            h_down = (st["h_fault"] & 1) != 0
            nic_dead = st["h_fault"] != 0

            # arrival: inbox -> codel -> relay 2
            arr = due & pick_ib
            st["ib_pos"] = where(arr, pos + 1, pos)
            pk_arr = {kk: st[f"ib_{kk}"][hidx, safe] for kk in PK_KEYS}
            size = pk_arr["plen"] + TCP_TOTAL_HDR
            arr_f = arr & nic_dead
            st["pkts_dropped"] = where(arr_f, st["pkts_dropped"] + 1,
                                       st["pkts_dropped"])
            st["drop_causes"][:, TEL_HOST_DOWN] += arr_f & h_down
            st["drop_causes"][:, TEL_LINK_DOWN] += arr_f & ~h_down
            tr_append(st, arr_f & h_down, et, TR_DRP, pk_arr,
                      RSN_HOSTDOWN)
            tr_append(st, arr_f & ~h_down, et, TR_DRP, pk_arr,
                      RSN_LINKDOWN)
            arr = arr & ~nic_dead
            st["codel_enq_pkts"] = where(arr, st["codel_enq_pkts"] + 1,
                                         st["codel_enq_pkts"])
            st["codel_enq_bytes"] = where(arr,
                                          st["codel_enq_bytes"] + size,
                                          st["codel_enq_bytes"])
            limit_full = arr & (st["cq_len"] - st["cq_pos"]
                                >= CODEL_HARD_LIMIT)
            st["codel_dropped"] = where(limit_full,
                                        st["codel_dropped"] + 1,
                                        st["codel_dropped"])
            st["codel_drop_bytes"] = where(limit_full,
                                           st["codel_drop_bytes"] + size,
                                           st["codel_drop_bytes"])
            st["pkts_dropped"] = where(limit_full, st["pkts_dropped"] + 1,
                                       st["pkts_dropped"])
            st["drop_causes"][:, TEL_RTR_LIMIT] += limit_full
            tr_append(st, limit_full, et, TR_DRP, pk_arr, RSN_RTRLIMIT)
            arr = arr & ~limit_full
            mark_abort(st, (arr & (st["cq_len"] - st["cq_pos"]
                                   >= CQ - 1)).any(), AB_STRUCT, 11)
            # DCTCP-K instantaneous marking law: an ECT(0) arrival
            # meeting the threshold (queue state BEFORE this enqueue,
            # packets leg first) is rewritten to CE and enqueued.
            depth = st["cq_len"] - st["cq_pos"]
            ect = arr & (pk_arr["ecn"] == ECN_ECT0)
            mark_p = ect & (depth >= k_pkts)
            mark_b = ect & ~mark_p & (st["codel_bytes"] >= k_bytes)
            mark = mark_p | mark_b
            st["codel_marked"] = where(mark, st["codel_marked"] + 1,
                                       st["codel_marked"])
            st["mark_causes"][:, MARK_THRESH_PKTS] += mark_p
            st["mark_causes"][:, MARK_THRESH_BYTES] += mark_b
            pk_arr["ecn"] = where(mark, ECN_CE, pk_arr["ecn"])
            if active(arr):
                tail = st["cq_len"] % CQ
                for kk in PK_KEYS:
                    hput(st[f"cq_{kk}"], arr, tail, pk_arr[kk])
                hput(st["cq_enq"], arr, tail, et)
            st["cq_len"] = where(arr, st["cq_len"] + 1, st["cq_len"])
            st["codel_peak"] = torch.maximum(
                st["codel_peak"],
                where(arr, st["cq_len"] - st["cq_pos"], 0))
            st["codel_bytes"] = where(arr, st["codel_bytes"] + size,
                                      st["codel_bytes"])
            go2 = arr & (st["r2_pending"] == 0)
            st["cont"] = where(go2, C_R2, st["cont"])
            st["then"] = where(go2, C_IDLE, st["then"])

            # timer
            tim = due & ~pick_ib
            hput(st["th_valid"], tim, tslot, False)
            tim = tim & ~h_down
            is_relay = tim & (tkind == TK_RELAY)
            for r in (1, 2):
                rw = is_relay & (ttgt == r)
                st[f"r{r}_pending"] = where(rw, 0, st[f"r{r}_pending"])
                st["cont"] = where(rw, C_R1 if r == 1 else C_R2,
                                   st["cont"])
                st["then"] = where(rw, C_IDLE, st["then"])
            bad_tgt = tim & (tkind != TK_RELAY) & (ttgt < 0)
            mark_abort(st, bad_tgt.any(), AB_STRUCT, 12)
            is_tcp = tim & (tkind == TK_TCP) & (ttgt >= 0)
            is_app = tim & (tkind == TK_APP) & (ttgt >= 0)
            st["cur"] = where(is_tcp | is_app, ttgt, st["cur"])
            st["cont"] = where(is_tcp, C_TMR, st["cont"])
            st["ret"] = where(is_tcp, C_IDLE, st["ret"])
            cset(st, is_app, c_wakep=0, c_await=0)
            st["cont"] = where(is_app, C_APP, st["cont"])
            st["ret"] = where(is_app, C_APP, st["ret"])

        # -------- per-iteration dispatcher ---------------------------

        def micro_iter(st, window_end, iters, n_due):
            """The fused schedule: ops consume the live continuation in
            dataflow order, so a delivered segment's whole chain runs in
            one iteration.  Each stage is guarded by an any-lane-active
            check, like the reference's `lax.cond` guards, and counted
            like the reference's kernel observatory (ks_count): a fire
            per pass with active lanes, its lane count, and the host
            wall from its guard's sync to the end of its issue."""
            fires, lanes, wall = st["ks_fires"], st["ks_lanes"], \
                st["ks_wall_s"]

            def run_stage(op, code, mask, n, *args):
                t0 = time.perf_counter()
                op(st, mask, *args)
                wall[code] += time.perf_counter() - t0
                fires[code] += 1
                lanes[code] += n

            def stage(op, cont, code):
                mask = st["cont"] == cont
                n = int(mask.sum())  # the guard's one host sync
                if n:
                    run_stage(op, code, mask, n)

            # The event pop fires on the idle lanes with a due event
            # (ks_count_pop), counted by the loop condition's sync; with
            # none due it is an identity and is skipped.
            if n_due:
                run_stage(op_pop_event, KS_POP, st["cont"] == C_IDLE,
                          n_due, window_end)
            th_memo[0] = None
            stage(op_tmr, C_TMR, KS_TIMERS)
            stage(op_app, C_APP, KS_STEP)
            stage(op_relay2, C_R2, KS_CODEL)
            stage(op_tcpin, C_TCPIN, KS_ON_PACKET)
            for _ in range(2):
                stage(op_drain, C_DRAIN, KS_REASM)
            stage(op_ackdata, C_ACKDATA, KS_ACK)
            stage(op_push, C_PUSH, KS_PUSH)
            stage(op_flush, C_FLUSH, KS_FLUSH)
            for _ in range(2):
                stage(op_relay1, C_R1, KS_INET_OUT)
            stage(op_arm, C_ARM, KS_ARM)
            # Per-round runaway valve: a continuation-cycle bug must
            # abort, not spin.
            mark_abort(st, iters > (1 << 17), AB_STRUCT, 13)

        def micro_busy(st, window_end):
            """The loop condition, the one host sync per iteration:
            (any lane busy or due and no abort, the idle lanes due)."""
            ib_t, _ = ib_head_time(st)
            th_memo[0] = th_min(st)
            due = torch.minimum(ib_t, th_memo[0][0]) < window_end
            busy = st["cont"] != C_IDLE
            go = ((busy | due).any() & (st["abort_code"] == 0)).to(i64)
            go, n_due = torch.stack([go, (due & ~busy).sum()]).tolist()
            return bool(go), n_due

        def window_plain(st, window_end) -> int:
            """The eager window (the kernel's plain version): iterations
            until no lane is busy or due, or an abort; returns their
            count and credits the stage counters in `st`."""
            it = 0
            while True:
                go, n_due = micro_busy(st, window_end)
                if not go:
                    break
                micro_iter(st, window_end, it, n_due)
                it += 1
            return it

        # -------- round end: propagation + inbox merge ---------------

        ar_o = torch.arange(O, dtype=i64, device=dev)
        k0 = torch.tensor(self._k[0], dtype=i64, device=dev)
        k1 = torch.tensor(self._k[1], dtype=i64, device=dev)

        def propagate(st, window_end):
            n = st["out_n"]
            valid = ar_o < n
            src = st["out_src"][:O]
            dst = st["out_dst"][:O]
            node = st["_node"]
            sn, dn = node[src], node[dst]
            latency = st["_lat"][sn, dn]
            reachable = latency < TIME_NEVER
            bits, _ = threefry2x32_torch(k0, k1, src,
                                         st["out_pseq"][:O] & M32)
            thr_v = st["_thr"][sn, dn]
            out_t = st["out_t"][:O]
            # pure acks are empty-control packets: never lossy
            lossy = ((bits < thr_v) & (st["out_plen"][:O] > 0)
                     & (out_t >= self.bootstrap_end))
            deliver = (out_t + latency).clamp(min=window_end)
            keep = valid & reachable & ~lossy
            min_lat = where(keep, latency, I64_MAX).min()
            for miss, rsn, tel in (
                    (valid & ~reachable, RSN_UNREACH, TEL_UNREACHABLE),
                    (valid & reachable & lossy, RSN_LOSS, TEL_LOSS_EDGE)):
                # JAX scatters into row OOB = H+1 with mode="drop"; the
                # port counts into a spare slot H and drops it.
                cnt = torch.zeros(H + 1, dtype=i64, device=dev).index_add_(
                    0, where(miss, src, H), miss.to(i64))[:H]
                st["pkts_dropped"] = st["pkts_dropped"] + cnt
                st["drop_causes"][:, tel] += cnt
                if tracing:
                    nt_ = st["tr_n"]
                    rank = torch.cumsum(miss, 0) - 1
                    slot = where(miss & (nt_ + rank < TR), nt_ + rank, TR)
                    for key, v in (
                            ("tr_t", out_t), ("tr_kind", TR_DRP),
                            ("tr_srchost", st["out_srchost"][:O]),
                            ("tr_pseq", st["out_pseq"][:O]),
                            ("tr_sip", st["out_sip"][:O]),
                            ("tr_sport", st["out_sport"][:O]),
                            ("tr_dip", st["out_dip"][:O]),
                            ("tr_dport", st["out_dport"][:O]),
                            ("tr_plen", st["out_plen"][:O]),
                            ("tr_reason", rsn), ("tr_owner", src)):
                        st[key][slot] = v
                    tot = nt_ + miss.sum()
                    st["tr_n"] = tot
                    mark_abort(st, tot > TR - O, AB_TRACE)

            new = {"time": deliver, "src": src, "seq": st["out_seq"][:O]}
            for kk in PK_KEYS:
                new[kk] = st[f"out_{kk}"][:O]
            over = merge_inbox(st, keep, dst, new)
            mark_abort(st, over.any(), AB_STRUCT, 14)
            st["out_n"] = torch.zeros((), dtype=i64, device=dev)
            return n, min_lat

        # -------- the multi-round loop -------------------------------

        def prepare(st):
            """A span's local buffers, counters and conn indexes, made
            anew in `st`."""
            z = torch.zeros((), dtype=i64, device=dev)
            st["abort_code"] = z.clone()
            st["abort_site"] = z.clone()
            st["cd_chain"] = torch.zeros(H, dtype=i64, device=dev)
            st["cd_sniff"] = torch.zeros(H, dtype=i64, device=dev)
            # conn lookup keys: (host, peer-ip-index, peer-port), over the
            # real conn rows (the trash row is left out)
            ips_sorted = st["_ips_sorted"]
            c_host = st["c_host"][:CC]
            pslot = torch.searchsorted(ips_sorted,
                                       st["c_pip"][:CC]).clamp(max=H - 1)
            pidx = st["_ips_perm"][pslot]
            ckey = (c_host * H + pidx) * 65536 + st["c_pport"][:CC]
            ckey = where(c_host >= 0, ckey,
                         I64_MAX - torch.arange(CC, dtype=i64, device=dev))
            order = torch.argsort(ckey, stable=True)
            st["_ckeys"] = ckey[order]
            st["_ckperm"] = order
            # Each host's conn rows (CSR over c_host, rows ascending; the
            # unused rows, c_host = -1, after the last host's): the window
            # kernel's lanes walk their own rows for the qdisc pick.
            owner = where(c_host >= 0, c_host, H)
            st["_conn_rows"] = torch.argsort(owner, stable=True)
            st["_conn_off"] = torch.cat([z.view(1), torch.cumsum(
                torch.bincount(owner, minlength=H + 1)[:H], 0)])
            # Flat span-local buffers carry one trash slot at the end.
            st["out_n"] = z.clone()
            for k in ("out_src", "out_dst", "out_seq", "out_t") + tuple(
                    f"out_{kk}" for kk in PK_KEYS):
                st[k] = torch.zeros(O + 1, dtype=i64, device=dev)
            if tracing:
                st["tr_n"] = z.clone()
                for k in ("tr_t", "tr_kind", "tr_srchost", "tr_pseq",
                          "tr_sip", "tr_sport", "tr_dip", "tr_dport",
                          "tr_plen", "tr_reason", "tr_owner"):
                    st[k] = torch.zeros(TR + 1, dtype=i64, device=dev)

            # Span-local stage counters (the reference's ks_fires /
            # ks_lanes, plus host wall per stage), the law calls made in
            # the window kernel's lanes and its windows: output only,
            # never engine state.
            st["ks_fires"] = np.zeros(KS_N, np.int64)
            st["ks_lanes"] = np.zeros(KS_N, np.int64)
            st["ks_wall_s"] = np.zeros(KS_N)
            st["ks_calls"] = np.zeros(2, np.int64)
            st["ks_windows"] = 0
            st["ks_window_ms"] = 0.0
            st["ks_spans"] = 0
            st["ks_span_ms"] = 0.0
            # The channels' sample rows (the reference's span-local
            # tel_* / fab_* buffers, zeroed at every span start).
            if tel_iv:
                make_rows(st, "tel", [n for n, _ in TEL_FIELDS],
                          self.TEL_ROWS, CC, dev)
            if fab_iv:
                make_rows(st, "fab", FAB_COLS, self.FAB_ROWS, H, dev)

        def round_end(st, window_end):
            """Propagation and the inbox merge after a window, then the
            round's scalars in one host sync: (packets, least kept
            latency, next start, abort word)."""
            self.eager_round_ends += 1
            n_out, min_lat = propagate(st, window_end)
            ib_t, th_t = next_event_time(st)
            return torch.stack([
                n_out, min_lat, torch.minimum(ib_t, th_t).min(),
                st["abort_code"]]).tolist()

        def sample(st, start, window_end):
            """The round boundary's channel rows (the reference
            round_body's netstat and fabric blocks): every conn's
            TEL_FIELDS and every host's fabric row, each at a round that
            crosses its channel's grid."""
            if tel_iv and grid_sampled(start, window_end, tel_iv):
                put_row(st, "tel", window_end,
                        {n: st[c][:CC] for n, c in TEL_FIELDS})
            if fab_iv and grid_sampled(start, window_end, fab_iv):
                put_row(st, "fab", window_end,
                        fabric_values(st, window_end, CQ, REFILL_NS))

        def run(st, start, stop, limit, runahead, max_rounds):
            prepare(st)
            if span is not None:
                # The whole loop in one launch and one read.
                got = span(st, start, stop, limit, runahead, max_rounds)
                st.update(got["rows"])
                for k in ("fires", "lanes", "calls"):
                    st[f"ks_{k}"] += got[k]
                st["ks_windows"] = got["rounds"]
                st["ks_spans"] = 1
                st["ks_span_ms"] = got["span_ms"]
                return (st, got["start"], got["runahead"], got["rounds"],
                        got["busy_rounds"], got["packets"],
                        got["busy_end"], got["iters"])
            if step is not None:
                step.begin(st)
            rounds = busy_rounds = packets = iters = 0
            busy_end = start
            aborted = False
            while (rounds < max_rounds and start < limit and start < stop
                   and not aborted):
                window_end = min(start + runahead, stop)
                if step is None:
                    iters += window_plain(st, window_end)
                else:
                    step(st, window_end)  # one launch, no host sync
                n_out, min_lat, nxt, code = round_end(st, window_end)
                sample(st, start, window_end)
                if 0 < min_lat < runahead:
                    runahead = min_lat
                start = nxt
                rounds += 1
                busy_rounds += int(n_out > 0)
                packets += n_out
                busy_end = window_end
                aborted = code != 0
            if step is not None:
                # The kernel's counts: the law calls are its lanes'.
                got = step.end()
                for k in ("fires", "lanes", "calls"):
                    st[f"ks_{k}"] += got[k]
                iters = got["iters"]
                st["ks_windows"] = got["windows"]
                st["ks_window_ms"] = got["window_ms"]
            return (st, start, runahead, rounds, busy_rounds, packets,
                    busy_end, iters)

        run.prepare, run.window_plain, run.round_end = (prepare,
                                                        window_plain,
                                                        round_end)
        run.sample = sample
        run.span, run.step = span, step
        return run

    # ------------------------------------------------------------------
    # Dispatch: export -> loop -> import
    # ------------------------------------------------------------------

    def export_state(self):
        """Fresh engine export -> the port's device state, or the
        int/None eligibility verdict passed through from
        span_export_tcp."""
        t0 = time.perf_counter_ns()
        d = self.engine.span_export_tcp(*self._caps())
        self.export_wall_ns += time.perf_counter_ns() - t0
        if d is None or isinstance(d, int):
            return d
        self.export_bytes += sum(
            len(v) for v in d.values()
            if isinstance(v, (bytes, bytearray, memoryview)))
        arrays = self._to_arrays(d)
        if self.netstat is not None:
            # The telemetry identity and its canonical order, from the
            # export's static columns.
            n = arrays["_n_conns"]
            host = arrays["c_host"][:n].astype(np.int32)
            lport = arrays["c_lport"][:n].astype(np.uint16)
            rport = arrays["c_pport"][:n].astype(np.uint16)
            rip = arrays["c_pip"][:n].astype(np.uint32)
            perm = np.lexsort((rip, rport, lport, host))
            self._tel_ident = (host[perm], lport[perm], rport[perm],
                               rip[perm], perm, n)
        st = state_from_numpy(arrays, self.device)
        self._n_conns = st.pop("_n_conns")
        st.update(self._statics_on_device())
        self._cache_statics(st)
        return st

    def _derive(self, st: dict) -> None:
        """The DERIVED chain registers, as every fresh export initializes
        them; the park-order counter is the scatter-max of each conn's
        await seq + 1 over its host, done on the card (a host round trip
        would be a sync per resident dispatch)."""
        H, n = self._H, self._n_conns
        dev = self.device
        i64 = torch.int64
        for k in ("cont", "then", "ret"):
            st[k] = torch.full((H,), C_IDLE, dtype=i64, device=dev)
        st["cur"] = torch.full((H,), -1, dtype=i64, device=dev)
        for k in ("eflag", "parkp", "had_holes"):
            st[k] = torch.zeros(H, dtype=i64, device=dev)
        for kk in PK_KEYS:
            st[f"ar_{kk}"] = torch.zeros(H, dtype=i64, device=dev)
        st["park_ctr"] = torch.zeros(H, dtype=i64, device=dev).scatter_reduce(
            0, st["c_host"][:n], st["c_awaitseq"][:n] + 1, "amax")

    def _fn_for(self, st: dict):
        return self._cached_build()

    def _fn_args(self, start, stop, limit, runahead, mr) -> tuple:
        return (start, stop, limit, runahead, mr)

    def _host_copy(self, st_out: dict):
        """Every codec column and the span's trace, on the host."""
        traces = None
        if self.tracing:
            n = int(st_out["tr_n"])
            tr = {k: st_out[f"tr_{k}"][:n].cpu().numpy()
                  for k in ("t", "kind", "srchost", "pseq", "sip", "sport",
                            "dip", "dport", "plen", "reason", "owner")}
            traces = {
                "n": n,
                "t": tr["t"].astype(np.int64).tobytes(),
                "kind": tr["kind"].astype(np.uint8).tobytes(),
                "srchost": tr["srchost"].astype(np.int32).tobytes(),
                "pseq": tr["pseq"].astype(np.int64).tobytes(),
                "sip": tr["sip"].astype(np.uint32).tobytes(),
                "sport": tr["sport"].astype(np.int32).tobytes(),
                "dip": tr["dip"].astype(np.uint32).tobytes(),
                "dport": tr["dport"].astype(np.int32).tobytes(),
                "size": tr["plen"].astype(np.int64).tobytes(),
                "reason": tr["reason"].astype(np.uint8).tobytes(),
                "owner": tr["owner"].astype(np.int32).tobytes(),
            }
        st_np = state_to_numpy(st_out, keys=list(st_out["_np_dtypes"]))
        st_np["_n_conns"] = self._n_conns
        return st_np, traces

    def _emit_netstat(self, rows: dict) -> None:
        """The span's connection rows as TEL_RECs: per sampled round,
        the live conns in the canonical (host, lport, rport, rip)
        order, byte-identical to the engine ring's for the same
        rounds."""
        tn = int(rows.get("tel_n", 0))
        host, lport, rport, rip, perm, n = self._tel_ident
        if tn == 0 or n == 0:
            return
        arr = np.zeros(tn * n, dtype=np.dtype(TEL_DTYPE))
        arr["t"] = np.repeat(rows["tel_t"][:tn].astype(np.int64), n)
        arr["host"] = np.tile(host, tn)
        arr["lport"] = np.tile(lport, tn)
        arr["rport"] = np.tile(rport, tn)
        arr["rip"] = np.tile(rip, tn)
        arr["state"] = ST_ESTABLISHED
        for name, _col in TEL_FIELDS:
            arr[name] = rows[f"tel_{name}"][:tn][:, perm].reshape(-1)
        self.netstat.extend(arr.tobytes())

    def _engine_import(self, st_np: dict, traces) -> None:
        back = self._from_arrays(st_np)
        self.import_bytes += sum(
            len(v) for v in back.values()
            if isinstance(v, (bytes, bytearray, memoryview)))
        self.engine.span_import_tcp(back, *self._caps(), traces)
