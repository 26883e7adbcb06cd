"""Reason and cause tables the run outputs name.

The port's copy of the constants of `shadow_tpu/trace/events.py` that
`sim-stats.json` writes: the device-eligibility reasons (EL_*), the
packet-drop causes (TEL_*), the ECN mark causes (MARK_*) and the
syscall dispositions (SC_*).  The C++ engine (`native/netplane.cpp`)
keeps the same tables; tests/test_torch_imports.py pins every value to
the JAX package's.  The drop-cause indices the span loops use stay in
`ops/tcp_span.py` and `ops/phold_span.py`, pinned against TEL_NAMES.
"""

from __future__ import annotations

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
TEL_WIRE_N = 13
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

# ECN mark causes: the DCTCP-K threshold leg that fired (packets checked
# first); they sum to the fabric ledger's marked_pkts.
MARK_N = 2
MARK_NAMES = (
    "dctcp-k-pkts",
    "dctcp-k-bytes",
)
assert len(MARK_NAMES) == MARK_N

# Syscall dispositions of Python-dispatched syscalls.  Engine-resident
# apps dispatch C++-side and sit outside this accounting, so the port
# (engine-resident hosts only) writes an empty table.
SC_N = 5
SC_NAMES = (
    "serviced",
    "parked-on-condition",
    "natively-injected",
    "shim-handled",
    "protocol-error",
)
assert len(SC_NAMES) == SC_N
