"""Reason and cause tables and the record layouts the run outputs name.

The port's copy of the constants of `shadow_tpu/trace/events.py`: the
device-eligibility reasons (EL_*), the packet-drop causes (TEL_*), the
ECN mark causes (MARK_*) and the syscall dispositions (SC_*) that
`sim-stats.json` writes, and the fixed records of the sim-time channels:
the flight recorder's (FR_*, REC), the per-connection telemetry record
(TEL_REC), the fabric observatory's queue samples and flow records
(FB_REC, FCT_REC behind FAB_HDR) and the kernel observatory's per-span
stage counters (KS_*, KS_REC).  The C++ engine (`native/netplane.cpp`)
keeps the same tables and records; tests/test_torch_imports.py pins
every value to the JAX package's.  The drop-cause indices the span
loops use stay in `ops/tcp_span.py` and `ops/phold_span.py`, pinned
against TEL_NAMES.
"""

from __future__ import annotations

import struct

# ---------------------------------------------------------------------
# Flight recorder (`flight-sim.bin`): one 32-byte record an event,
#
#     int64  t       simulated nanoseconds of the event
#     int32  kind    FR_* event kind
#     int32  a       eligibility reason (FR_ROUND), span family
#                    (FR_SPAN_*)
#     int64  b       packets (FR_ROUND / FR_SPAN_COMMIT), abort code
#                    (FR_SPAN_ABORT)
#     int64  c       window start (FR_ROUND), round index
#                    (FR_SPAN_START), rounds (FR_SPAN_COMMIT)
FLIGHT_REC_BYTES = 32
FR_ROUND = 0        # one conservative round executed
FR_SPAN_START = 1   # multi-round span entered (engine or device)
FR_SPAN_COMMIT = 2  # span committed: rounds/packets imported
FR_SPAN_ABORT = 3   # device span aborted (transactional rollback)
FR_FAULT_KILL = 4
FR_FAULT_RESTORE = 5
FR_FAULT_LINK_DOWN = 6
FR_FAULT_LINK_UP = 7
FR_FAULT_BLACKHOLE = 8
FR_FAULT_CLEAR = 9
FR_FAULT_QUARANTINE = 10
FR_N = 11

REC = struct.Struct("<qiiqq")
assert REC.size == FLIGHT_REC_BYTES
# numpy structured dtype for bulk decode (field order == REC).
REC_DTYPE = [("t", "<i8"), ("kind", "<i4"), ("a", "<i4"),
             ("b", "<i8"), ("c", "<i8")]

# Span families (the manager stamps them on its span records).
FAM_CPP = 0     # C++ engine run_span
FAM_PHOLD = 1   # device-resident PHOLD/udp-mesh family
FAM_TCP = 2     # device-resident TCP steady-stream family
FAM_NAMES = ("engine", "device-phold", "device-tcp")
assert len(FAM_NAMES) == FAM_TCP + 1

# Device-eligibility reason codes.  Every conservative round is
# credited EXACTLY ONE of these by the manager's round loop, so the
# audit (trace/audit.py) always sums to the total round count.
EL_DEVICE_SPAN = 0        # stepped inside a device-resident span
EL_ENGINE_SPAN = 1        # stepped inside a C++ engine span
EL_ENGINE_ROUTED = 2      # C++ span: EWMA measured it faster
EL_ENGINE_COLD = 3        # C++ span: device probe budget not earned
EL_ENGINE_ABORT = 4       # C++ span: device span aborted (rollback)
EL_ENGINE_TRANSIENT = 5   # C++ span: device family transiently out
EL_ENGINE_FAMILY = 6      # C++ span: no device-span family fits
EL_ENGINE_OFF = 7         # C++ span: tpu_device_spans=off
EL_ENGINE_PYLIMIT = 8     # C++ span capped before Python-side work
EL_ROUND_BOUNDARY = 9     # per-round: heartbeat/limit boundary
EL_ROUND_OUTBOX = 10      # per-round: object-path outbox pending
EL_ROUND_GATE = 11        # per-round: route model holds the device
EL_ROUND_CALLBACK = 12    # per-round: callback-capable host present
EL_ROUND_FORCED = 13      # per-round: forced-device audit mode
EL_ROUND_SCHED = 14       # per-round: non-span scheduler
EL_OBJ_PCAP = 15          # object-path host due now: pcap capture
EL_OBJ_CPU = 16           # object-path host due now: CPU model
EL_OBJ_PYTASK = 17        # engine host with transient Python work
EL_OBJ_OTHER = 18         # object-path host due now: other config
EL_DEVICE_SHARDED = 19    # stepped inside a sharded device span
EL_ENGINE_EXCHANGE = 20   # C++ span: sharded exchange over capacity
EL_ENGINE_UNSHARDED = 21  # C++ span: host axis % tpu_shards != 0
EL_SVC_QUIESCENT = 22     # C++ span: managed hosts quiescent
EL_N = 23

EL_NAMES = (
    "device-span",
    "engine-span",
    "engine-span:routed",
    "engine-span:cold-budget",
    "engine-span:abort-rollback",
    "engine-span:transient",
    "engine-span:ineligible-family",
    "engine-span:device-off",
    "engine-span:py-limit",
    "per-round:boundary",
    "per-round:outbox",
    "per-round:span-gate",
    "per-round:callback-host",
    "per-round:forced-device",
    "per-round:scheduler",
    "object-path:pcap",
    "object-path:cpu-model",
    "object-path:py-task",
    "object-path:other",
    "device-span:sharded",
    "engine-span:exchange-capacity",
    "engine-span:shard-unaligned",
    "engine-span:managed-quiescent",
)
assert len(EL_NAMES) == EL_N

# Packet-drop causes: every drop on every path is attributed to exactly
# one, so the wire causes (the first TEL_WIRE_N) sum to packets_dropped.
# The two TCP receiver discards after them sit outside that sum (the
# packet was delivered; only payload was refused).
TEL_CODEL = 0
TEL_RTR_LIMIT = 1
TEL_LOSS_EDGE = 2
TEL_UNREACHABLE = 3
TEL_NO_ROUTE = 4
TEL_NO_SOCKET = 5
TEL_TCP_STATE = 6
TEL_BACKLOG_FULL = 7
TEL_UDP_FILTER = 8
TEL_RECVBUF_FULL = 9
TEL_BUCKET_DEFER = 10
TEL_HOST_DOWN = 11
TEL_LINK_DOWN = 12
TEL_WIRE_N = 13
TEL_REASM_FULL = 13
TEL_RECVWIN_TRUNC = 14
TEL_N = 15

TEL_NAMES = (
    "codel",
    "router-queue",
    "loss-edge",
    "unreachable",
    "no-route",
    "no-socket",
    "tcp-state",
    "backlog-full",
    "udp-filter",
    "recv-buffer-full",
    "bucket-defer-overflow",
    "host-down",
    "link-down",
    "reassembly-full",
    "recv-window-trunc",
)
assert len(TEL_NAMES) == TEL_N

# Drop-reason string -> cause code (the engine's tel_cause_of): the
# object path's Host.trace_drop maps every reason through it; a reason
# without an entry counts as unattributed.
TEL_BY_REASON = {
    "codel": TEL_CODEL,
    "rtr-limit": TEL_RTR_LIMIT,
    "inet-loss": TEL_LOSS_EDGE,
    "unreachable": TEL_UNREACHABLE,
    "no-route": TEL_NO_ROUTE,
    "no-socket": TEL_NO_SOCKET,
    "tcp-closed": TEL_TCP_STATE,
    "tcp-stray": TEL_TCP_STATE,
    "tcp-dup-syn": TEL_TCP_STATE,
    "accept-backlog-full": TEL_BACKLOG_FULL,
    "udp-connected-filter": TEL_UDP_FILTER,
    "rcvbuf-full": TEL_RECVBUF_FULL,
    "host-down": TEL_HOST_DOWN,
    "link-down": TEL_LINK_DOWN,
}

# ECN mark causes: the DCTCP-K threshold leg that fired (packets checked
# first); they sum to the fabric ledger's marked_pkts.
MARK_THRESH_PKTS = 0   # queue depth >= DCTCP_K_PKTS at enqueue
MARK_THRESH_BYTES = 1  # queued bytes >= DCTCP_K_BYTES at enqueue
MARK_N = 2
MARK_NAMES = (
    "dctcp-k-pkts",
    "dctcp-k-bytes",
)
assert len(MARK_NAMES) == MARK_N

# Syscall dispositions of Python-dispatched syscalls (managed processes'
# ABI dispatch and internal apps' dispatch alike), one code each; the C
# twin of the enum lives in native/shim.c, which owns the SC_SHIM count
# of locally answered time reads.  Engine-resident apps dispatch
# C++-side and sit outside this accounting.
SC_SERVICED = 0   # emulated by the simulated kernel (done / error)
SC_PARKED = 1     # parked on a SyscallCondition (re-dispatched on wake)
SC_NATIVE = 2     # natively injected (DO_NATIVE / exit short-circuits)
SC_SHIM = 3       # answered shim-side (time family), no round trip
SC_PROTO = 4      # IPC protocol error ended the conversation
SC_N = 5
SC_NAMES = (
    "serviced",
    "parked-on-condition",
    "natively-injected",
    "shim-handled",
    "protocol-error",
)
assert len(SC_NAMES) == SC_N

# Result classes of a dispatch (what it returned, orthogonal to how the
# call was routed): the syscall observatory's records carry them.
RC_OK = 0      # completed with a non-error value
RC_ERR = 1     # completed with -errno
RC_NATIVE = 2  # executed natively; the manager never saw the value
RC_NONE = 3    # no result this dispatch (parked / protocol error)
RC_NAMES = ("ok", "error", "native", "none")

# ---------------------------------------------------------------------
# Sim-netstat (`telemetry-sim.bin`): one 104-byte record a live TCP
# connection a sampled round,
#
#     int64   t          the sampled round's window end
#     int32   host       host id
#     uint16  lport      local port,
#     uint16  rport      peer port,
#     uint32  rip        peer IP
#     int32   state      TCP state
#     int64[10]          cwnd, ssthresh, srtt, rto, rto_backoff,
#                        send-buffer bytes, recv-buffer bytes,
#                        retransmits, SACK-skipped retransmits, marks
TEL_REC_BYTES = 104
TEL_REC = struct.Struct("<qiHHIi10q")
assert TEL_REC.size == TEL_REC_BYTES
TEL_DTYPE = [("t", "<i8"), ("host", "<i4"), ("lport", "<u2"),
             ("rport", "<u2"), ("rip", "<u4"), ("state", "<i4"),
             ("cwnd", "<i8"), ("ssthresh", "<i8"), ("srtt", "<i8"),
             ("rto", "<i8"), ("backoff", "<i8"), ("sndbuf", "<i8"),
             ("rcvbuf", "<i8"), ("rtx", "<i8"), ("sacks", "<i8"),
             ("marks", "<i8")]
# The sampled fields, in record order after the identity header.
TEL_FIELD_NAMES = tuple(n for n, _ in TEL_DTYPE[6:])

# ---------------------------------------------------------------------
# Fabric observatory (`fabric-sim.bin`): FAB_HDR, then fb_n queue
# samples (FB_REC), then fct_n flow records (FCT_REC).
#
# Activity flags: a host is sampled in a round iff any bit is set.
FB_ACT_CODEL = 1    # router inbound CoDel queue non-empty
FB_ACT_TB_OUT = 2   # inet-out token-bucket relay parked on a refill
FB_ACT_TB_IN = 4    # inet-in token-bucket relay parked on a refill
FB_ACT_LINK = 8     # the eth link has ever forwarded a packet

# Queue sample (128 bytes): int64 t, int32 host, int32 flags, then
# int64 qdepth, qbytes, sojourn, qenq, qdrops, qmarks, r1_bal,
# r1_stalls, r2_bal, r2_stalls, psent, bsent, precv, brecv.
FB_REC_BYTES = 128
FB_REC = struct.Struct("<qii14q")
assert FB_REC.size == FB_REC_BYTES
FB_DTYPE = [("t", "<i8"), ("host", "<i4"), ("flags", "<i4"),
            ("qdepth", "<i8"), ("qbytes", "<i8"), ("sojourn", "<i8"),
            ("qenq", "<i8"), ("qdrops", "<i8"), ("qmarks", "<i8"),
            ("r1_bal", "<i8"), ("r1_stalls", "<i8"),
            ("r2_bal", "<i8"), ("r2_stalls", "<i8"),
            ("psent", "<i8"), ("bsent", "<i8"), ("precv", "<i8"),
            ("brecv", "<i8")]
# The sampled fields after the (t, host, flags) header, in record order.
FB_FIELD_NAMES = tuple(n for n, _ in FB_DTYPE[3:])

FCT_F_COMPLETE = 1  # connection reached CLOSED before the artifact
FCT_F_RECEIVER = 2  # this endpoint received more than it sent

# Flow record (64 bytes): int64 t_first, t_last, int32 host, uint16
# lport, rport, uint32 rip, int32 flags, int64 bytes_in, bytes_out,
# retransmits, marks.
FCT_REC_BYTES = 64
FCT_REC = struct.Struct("<qqiHHIi4q")
assert FCT_REC.size == FCT_REC_BYTES
FCT_DTYPE = [("t_first", "<i8"), ("t_last", "<i8"), ("host", "<i4"),
             ("lport", "<u2"), ("rport", "<u2"), ("rip", "<u4"),
             ("flags", "<i4"), ("bytes_in", "<i8"),
             ("bytes_out", "<i8"), ("rtx", "<i8"), ("marks", "<i8")]

FAB_MAGIC = 0x46425354  # "FBST"
FAB_VERSION = 1
FAB_HDR = struct.Struct("<IIQQ")  # magic, version, fb_n, fct_n
FAB_HDR_BYTES = 24
assert FAB_HDR.size == FAB_HDR_BYTES


def split_fabric(buf: bytes) -> tuple[bytes, bytes]:
    """fabric-sim.bin content -> (fb_bytes, fct_bytes); raises
    ValueError on a malformed header or truncated sections."""
    if len(buf) < FAB_HDR_BYTES:
        raise ValueError("fabric artifact shorter than its header")
    magic, version, fb_n, fct_n = FAB_HDR.unpack_from(buf, 0)
    if magic != FAB_MAGIC or version != FAB_VERSION:
        raise ValueError(f"bad fabric header {magic:#x} v{version}")
    fb_end = FAB_HDR_BYTES + fb_n * FB_REC_BYTES
    fct_end = fb_end + fct_n * FCT_REC_BYTES
    if len(buf) < fct_end:
        raise ValueError("fabric artifact truncated")
    return buf[FAB_HDR_BYTES:fb_end], buf[fb_end:fct_end]


def iter_fb_records(fb_bytes: bytes):
    """Yield FB_REC tuples (t, host, flags, then the 14 fields) from a
    packed queue-sample stream."""
    for off in range(0, len(fb_bytes) - len(fb_bytes) % FB_REC_BYTES,
                     FB_REC_BYTES):
        yield FB_REC.unpack_from(fb_bytes, off)


def iter_fct_records(fct_bytes: bytes):
    """Yield (t_first, t_last, host, lport, rport, rip, flags, bytes_in,
    bytes_out, rtx, marks) tuples from a packed FCT_REC stream."""
    for off in range(0, len(fct_bytes) - len(fct_bytes) % FCT_REC_BYTES,
                     FCT_REC_BYTES):
        yield FCT_REC.unpack_from(fct_bytes, off)


# ---------------------------------------------------------------------
# Kernel observatory (`kernel-sim.bin`): one 224-byte record a committed
# device span: int64 t (the span's first window start), int32 family
# (FAM_*), int32 hosts (the lanes), int64 rounds, int64 trips
# (micro-iterations), int64[KS_N] fires and int64[KS_N] active-lane
# sums per stage.  Per family, the trips of the committed records sum
# to the runner's micro_iters.
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
KS_NAMES = (
    "pop",
    "step",
    "codel",
    "on-packet",
    "reassembly",
    "ack",
    "push",
    "flush",
    "inet-out",
    "arm",
    "timers",
    "exchange",
)
assert len(KS_NAMES) == KS_N
KS_REC_BYTES = 224
KS_REC = struct.Struct("<qiiqq24q")
assert KS_REC.size == KS_REC_BYTES


def iter_ks_records(buf: bytes):
    """Yield (t, family, hosts, rounds, trips, fires, lanes) from a
    packed KS_REC stream."""
    for off in range(0, len(buf) - len(buf) % KS_REC_BYTES,
                     KS_REC_BYTES):
        rec = KS_REC.unpack_from(buf, off)
        yield (rec[0], rec[1], rec[2], rec[3], rec[4],
               rec[5:5 + KS_N], rec[5 + KS_N:5 + 2 * KS_N])


def iter_records(buf: bytes):
    """Yield (t, kind, a, b, c) tuples from a packed flight-record
    stream (`flight-sim.bin`)."""
    for off in range(0, len(buf) - len(buf) % FLIGHT_REC_BYTES,
                     FLIGHT_REC_BYTES):
        yield REC.unpack_from(buf, off)
