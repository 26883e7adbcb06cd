"""Device-resident multi-round loop for PHOLD-pure and udp-mesh
simulations, in PyTorch (the port of `shadow_tpu/ops/phold_span.py`).

Scope: PHOLD (every host one `phold` LP with its seeding thread over a
single bound UDP socket, family 0) and the paced udp-mesh (every host
one `udp-mesh` process, a sink main thread and a sender thread sharing
one socket, family 1).  The model is a field-for-field twin of the
engine's event loop (netplane.cpp run_until + the UDP data-plane
chain): the same event order (time, packet-before-local, (src, seq)),
the same event-seq draw points, the same token-bucket / CoDel /
recv-buffer arithmetic and the same status-change wake fan-out, so the
packet traces and counters are byte-identical to the serial path
(tests/test_torch_phold_span.py).

Transactional like the TCP family: the engine exports a read-only
snapshot (span_export_phold), the loop steps whole conservative
windows, and the result imports back only on a clean run; an aborted
span costs nothing but its wall, and the engine re-runs those rounds.

The micro-op interpreter: each host lane advances through its event
chain (pop an event, then an app step, a relay drain, a recv) as a
vectorized state machine over per-lane continuations.  The fused
schedule chains the ops of one lane inside one micro-iteration; the
unfused reference schedule advances every lane one micro-op per
iteration and is the comparator of the fused-vs-unfused differential.

How the JAX program maps onto eager PyTorch follows ops/tcp_span.py:
masked `.at[...].set(..., mode="drop")` writes become `hput` (masked
lanes write back their own value) or writes into a trash slot of the
flat buffers and of the inbox merge; uint32 words (status, wait masks,
the LCG, IPs) are int64 in [0, 2**32) with explicit masking; the
`lax.cond` guards become one host sync each, and a stage with no active
lane is skipped (every stage is the identity on an empty mask); the
inbox lexsort is three stable argsorts.

On the card with the fused schedule, a whole span is one launch of the
hand kernel `stt_phold_span` (ops/phold_span_kernel.py,
csrc/phold_span.cu): the round loop below, window, propagation, inbox
merge and the round's scalars, between grid barriers, with one host
read of the span's words at the end.  Its window is the lane law
(csrc/phold_lane.cuh: one thread per host lane through the same fused
iterations, the relays' token-bucket and CoDel-head laws from
csrc/queue_laws.cuh run in the lane), its round end
csrc/phold_round_end.cuh's laws, and the counters (micro-iterations,
stage fires and lanes, law calls) come back from the kernel.

The eager loop below (`run` without a span step) is its plain version:
the CPU runs it, and so does the card with `fused` off (the reference
schedule, which only tests set) or with a `window_factory` set.  That
hook makes the window step of the eager loop: `PHOLD_WINDOW.bind` one
launch of the window kernel `stt_phold_window` a round (ops/
phold_window.py, csrc/phold_window.cu), `eager_window` the eager window
(`window_plain`), where the relays' laws run through the standalone hand
kernels (ops/queues.py, csrc/queues.cu) at the sites where the JAX code
calls its Pallas kernels: on a CPU tensor each wrapper runs its plain
law, on a CUDA tensor it launches its kernel or raises.  The eager round
end (propagation and the inbox merge) follows each window there.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from shadow_tpu_torch.core.rng import (STREAM_PACKET_LOSS, mix_key,
                                       threefry2x32_torch)
from shadow_tpu_torch.core.simtime import TIME_NEVER
from shadow_tpu_torch.ops.phold_span_kernel import PHOLD_SPAN
from shadow_tpu_torch.ops.queues import (BUCKET_STEP, CODEL_HEAD,
                                         CODEL_INTERVAL_NS, CODEL_TARGET_NS,
                                         MTU, REFILL_NS)
from shadow_tpu_torch.ops.span_common import I64_MAX, merge_inbox
from shadow_tpu_torch.ops.span_mesh import (AB_OUT, AB_STRUCT, AB_TRACE,
                                            SpanMeshMixin)

M32 = 0xFFFFFFFF

# Continuations (one per host).
C_IDLE = 0
C_R1 = 1      # relay inet-out drain
C_R2 = 2      # relay inet-in drain
C_M_STEP = 3  # main app stepper entry (sleep-restart + send)
C_S_STEP = 4  # seeder stepper entry
C_M_RECV = 5  # main recv phase (after a send's relay drain returns)
C_S_POST = 6  # seeder post-send bookkeeping

# Timer kinds / status bits / syscall slots (netplane.cpp).
TK_RELAY = 0
TK_APP = 2
TK_APP_TIMEOUT = 3
S_READABLE = 1 << 1
S_WRITABLE = 1 << 2
ASYS_WRITE = 6
ASYS_RESOLVE = 7
ASYS_SENDTO = 13
ASYS_RECVFROM = 14
ASYS_NANOSLEEP = 15
ASYS_N = 16

PAYLOAD_LEN = 5  # trace records carry the payload length, not total
CODEL_HARD_LIMIT = 1000

# Trace kinds / drop reason codes (span_import_phold REASONS order).
TR_SND = 0
TR_DRP = 1
TR_RCV = 2
RSN_NONE = 0
RSN_CODEL = 1
RSN_RTRLIMIT = 2
RSN_RCVBUF = 3
RSN_NOSOCK = 4
RSN_NOROUTE = 5
RSN_LOSS = 6
RSN_UNREACH = 7
RSN_HOSTDOWN = 9
RSN_LINKDOWN = 10

# Sim-netstat drop-cause slots touched by this loop (netplane.cpp TEL_*
# twins); the per-host (H, TEL_N) `drop_causes` column round-trips
# through the codec so the engine's counters stay authoritative.
TEL_CODEL = 0
TEL_RTR_LIMIT = 1
TEL_LOSS_EDGE = 2
TEL_UNREACHABLE = 3
TEL_NO_ROUTE = 4
TEL_NO_SOCKET = 5
TEL_RECVBUF_FULL = 9
TEL_HOST_DOWN = 11
TEL_LINK_DOWN = 12
TEL_N = 15

# Stage slots this family occupies (netplane.cpp KS_* twins, the same
# table as the TCP family's; ops/tcp_span.py KS_NAMES names them).
KS_POP = 0
KS_STEP = 1
KS_CODEL = 2
KS_INET_OUT = 8
KS_ARM = 9
KS_TIMERS = 10
KS_N = 12

# Per-dispatch calls of the two standalone law kernels (the `ks_calls`
# slots): a call is made only on a stage pass with an active lane.
CALL_BUCKET = 0
CALL_CODEL = 1

PK_KEYS = ("srchost", "pseq", "sip", "sport", "dip", "dport")
TR_KEYS = ("t", "kind", "srchost", "pseq", "sip", "sport", "dip", "dport",
           "reason", "owner")
TR_DTYPES = {"t": np.int64, "kind": np.uint8, "srchost": np.int32,
             "pseq": np.int64, "sip": np.uint32, "sport": np.int32,
             "dip": np.uint32, "dport": np.int32, "reason": np.uint8,
             "owner": np.int32}
OUT_KEYS = ("src", "dst", "seq", "t") + PK_KEYS[1:]  # srchost is src

# Residency classes (the reference's tables): every codec column falls
# in exactly one.  STATIC: build-time config, cached on the card at the
# export and shared read-only by every later dispatch.  DERIVED:
# re-derived at span entry by the law `_to_arrays` applies to a fresh
# export.  CARRIED: a clean span's output is the next span's input
# while the engine's state_epoch is unchanged (a speculative window
# runs on a clone of these).
RESIDENT_STATIC = frozenset({
    "peers", "n_peers", "m_port", "m_mean", "s_count", "eth_ip",
    "recv_max", "send_max", "r1_refill", "r1_cap", "r1_unlimited",
    "r2_refill", "r2_cap", "r2_unlimited",
})
RESIDENT_DERIVED = frozenset({
    "cont", "then", "park_ctr", "out_first", "cd_chain", "cd_sniff",
})
RESIDENT_CARRIED = frozenset(
    {
     "app_pkts_dropped", "app_pkts_recv", "app_pkts_sent",
     "app_sys", "codel_bytes", "drop_causes", "codel_count", "codel_drop_next",
     "codel_dropped", "codel_dropping", "codel_first_above",
     "codel_enq_pkts", "codel_enq_bytes", "codel_drop_bytes",
     "codel_peak", "codel_marked", "r1_stalls", "r2_stalls",
     "r1_fwd_pkts", "r1_fwd_bytes", "r2_fwd_pkts", "r2_fwd_bytes",
     "codel_last_count", "cq_enq", "cq_len", "cq_pos",
     "eth_brecv", "eth_bsent", "eth_precv", "eth_psent",
     "event_seq", "events_run", "ib_len", "ib_pos", "ib_seq",
     "ib_src", "ib_time", "m_exit_time", "m_exited", "m_gotn",
     "m_lcg", "m_partdone", "m_state", "m_target", "m_waitmask",
     "m_waitseq", "m_wakep", "now", "packet_seq", "queued",
     "r1_bal", "r1_next", "r1_pending", "r1_pk_valid", "r2_bal",
     "r2_next", "r2_pending", "r2_pk_valid", "recv_bytes",
     "rq_len", "rq_pos", "s_exit_time", "s_exited", "s_partdone",
     "s_senti", "s_state", "s_target", "s_waitmask", "s_waitseq",
     "s_wakep", "send_bytes", "sock_closed", "sq_len", "sq_pos",
     "status", "th_kind", "th_seq", "th_tgt", "th_time",
     "th_valid", "h_fault"}
    | {f"{p}_{kk}" for p in ('rq', 'sq', 'cq', 'ib', 'r1_pk', 'r2_pk')
       for kk in PK_KEYS})


def state_from_numpy(d: dict, device) -> dict:
    """The numpy span state that `_to_arrays` builds from
    span_export_phold -> the port's tensors on `device`: every integer
    column int64 (uint32 columns keep their values in [0, 2**32)),
    bools bool.  The inputs are copied, never shared: the loop updates
    its state in place.  `state_to_numpy` inverts it exactly."""
    st = {}
    dtypes = {}
    for k, a in d.items():
        dtypes[k] = a.dtype
        if a.dtype == np.bool_:
            st[k] = torch.tensor(a, device=device)
        else:
            st[k] = torch.tensor(a.astype(np.int64), device=device)
    st["_np_dtypes"] = dtypes
    return st


def state_to_numpy(st: dict, keys=None) -> dict:
    """The port's tensors -> numpy with the codec's own dtypes.  `keys`
    limits the conversion (default: every codec column)."""
    dtypes = st["_np_dtypes"]
    return {k: st[k].cpu().numpy().astype(dtypes[k])
            for k in (dtypes if keys is None else keys)}


class PholdSpanRunner(SpanMeshMixin):
    """Builds and drives the PyTorch multi-round device loop for the
    PHOLD/udp-mesh family.  One instance per Manager."""

    # Ring capacities (the reference's: export refuses state beyond half
    # of each, and the loop aborts transactionally on overflow).
    CAP_I = 64    # inbox
    CAP_T = 16    # timer heap
    CAP_R = 256   # socket recv queue
    CAP_S = 256   # socket send queue
    CAP_C = 2048  # CoDel ring (covers the engine's 1000-entry hard limit)
    CAP_P = 4096  # peers
    MAX_ROUNDS = 256

    RESIDENT_STATIC = RESIDENT_STATIC
    RESIDENT_CARRIED = RESIDENT_CARRIED

    def __init__(self, engine, latency_ns, thresholds, host_node,
                 host_ips, seed, bootstrap_end, tracing: bool,
                 device=None):
        from shadow_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.engine = engine
        self.tracing = bool(tracing)
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
        self.cap_out = max(512, 16 * self._H)
        # The reference starts at max(1 << 14, 64 H); an overflow aborts
        # the span and re-runs it with 4x the buffer, which the eager
        # loop pays in full (a third of the 24-host mesh's loop on the
        # card), so narrow sims start at the size they grow to.
        self.cap_tr = max(1 << 16, 64 * self._H)
        self.spans = 0
        self.rounds = 0
        self.aborts = 0
        self.ineligible = 0
        self.over_caps = 0
        self.micro_iters = 0
        self.last_abort_code = 0
        self.last_was_cold = False
        self.compiled = False
        self.family = 0      # 0 phold, 1 udp-mesh (set from export)
        self._pay = PAYLOAD_LEN  # uniform payload bytes (set from export)
        # Fused micro-op dispatch (default); False runs the one-micro-op-
        # per-iteration reference schedule (the differential's comparator).
        self.fused = True
        # The span step.  None: one stt_phold_span launch a span on the
        # card with the fused schedule and no window_factory, else the
        # eager loop.  A hook `span_factory(shape, params)` makes the
        # step instead (the tests' host build of the span); a hook
        # returning None keeps the eager loop.
        self.span_factory = None
        # The eager loop's window step: None the eager window; a hook
        # `window_factory(shape, params)` makes it (PHOLD_WINDOW.bind:
        # one stt_phold_window launch a window; the tests' host build of
        # the lane law; eager_window: None, the eager window).
        self.window_factory = None
        # Per-stage fires, lanes and host wall of committed spans (KS_*
        # slots), beside micro_iters (the trips they are bounded by).
        self.ks_fires = np.zeros(KS_N, np.int64)
        self.ks_lanes = np.zeros(KS_N, np.int64)
        self.ks_wall_s = np.zeros(KS_N)
        # Calls of the standalone law kernels (CALL_* slots): of
        # committed spans, and of every dispatch (aborted ones too).
        self.ks_calls = np.zeros(2, np.int64)
        self.calls_all = np.zeros(2, np.int64)
        # Windows a kernel stepped (window-kernel launches, or rounds
        # inside the span kernel) and the window kernel's launch-to-end
        # time (ms, CUDA events) of committed spans, and the windows of
        # every dispatch.
        self.ks_windows = 0
        self.ks_window_ms = 0.0
        self.windows_all = 0
        # Span-kernel launches and their launch-to-end time (ms) of
        # committed spans, and the launches of every dispatch (aborted
        # and refused ones too).
        self.ks_spans = 0
        self.ks_span_ms = 0.0
        self.spans_all = 0
        # Stage fires of every dispatch (aborted and refused ones too).
        self.fires_all = np.zeros(KS_N, np.int64)
        self._fn = None
        self._fn_cache: dict = {}

    def _caps(self):
        return (self.CAP_I, self.CAP_T, self.CAP_R, self.CAP_S,
                self.CAP_C, self.CAP_P)

    # ------------------------------------------------------------------
    # Export bytes <-> numpy state (the reference codec, unchanged)
    # ------------------------------------------------------------------

    def _to_arrays(self, d: dict) -> dict:
        H = self._H
        I, T, R, S, C = (self.CAP_I, self.CAP_T, self.CAP_R,
                         self.CAP_S, self.CAP_C)

        def f(k, dt, shape=None):
            a = np.frombuffer(d[k], dtype=dt)
            a = a.reshape(shape) if shape is not None else a
            return a.copy()

        st = {}
        for k in ("now", "event_seq", "packet_seq", "recv_bytes",
                  "recv_max", "send_bytes", "send_max", "codel_bytes",
                  "codel_dropped", "m_waitseq", "m_gotn", "m_mean",
                  "s_waitseq", "s_senti", "s_count", "s_exit_time"):
            st[k] = f(k, np.int64)
        st["app_pkts_sent"] = f("pkts_sent", np.int64)
        st["app_pkts_recv"] = f("pkts_recv", np.int64)
        st["app_pkts_dropped"] = f("pkts_dropped", np.int64)
        st["drop_causes"] = f("drop_causes", np.int64, (H, TEL_N))
        for k in ("events_run", "eth_psent", "eth_precv", "eth_bsent",
                  "eth_brecv"):
            st[k] = f(k, np.int64)
        for k in ("eth_ip", "status", "m_waitmask", "s_waitmask",
                  "m_lcg", "m_target", "s_target"):
            st[k] = f(k, np.uint32)
        for k in ("queued", "m_state", "m_wakep", "s_state", "s_wakep",
                  "s_exited", "m_exited", "m_partdone", "s_partdone",
                  "sock_closed"):
            st[k] = f(k, np.uint8).astype(np.int32)
        # Down-host fault mask: bit0 down, bit1 link_down, bit2
        # blackhole; constant within a span.
        st["h_fault"] = f("h_fault", np.uint8).astype(np.int32)
        st["m_exit_time"] = f("m_exit_time", np.int64)
        st["out_first"] = np.zeros(H, np.int32)
        st["cd_chain"] = np.zeros(H, np.int32)
        st["cd_sniff"] = np.zeros(H, np.int32)
        self.family = int(np.frombuffer(d["family"], np.uint8)[0])
        self._pay = int(np.frombuffer(d["pay_size"], np.int64)[0])
        st["codel_dropping"] = f("codel_dropping", np.uint8).astype(
            np.int32)
        st["codel_first_above"] = f("codel_first_above", np.int64)
        for k in ("codel_count", "codel_last_count", "codel_drop_next",
                  "codel_enq_pkts", "codel_enq_bytes",
                  "codel_drop_bytes", "codel_peak", "codel_marked"):
            st[k] = f(k, np.int64)
        st["m_port"] = f("m_port", np.int32)
        st["n_peers"] = f("n_peers", np.int32)
        P = len(np.frombuffer(d["peers"], np.uint32)) // H
        st["peers"] = f("peers", np.uint32, (H, P))
        st["app_sys"] = f("app_sys", np.int64, (H, ASYS_N))
        for pfx, cap in (("rq", R), ("sq", S), ("cq", C), ("ib", I)):
            for kk, dt in (("srchost", np.int32), ("pseq", np.int64),
                           ("sip", np.uint32), ("sport", np.int32),
                           ("dip", np.uint32), ("dport", np.int32)):
                st[f"{pfx}_{kk}"] = f(f"{pfx}_{kk}", dt, (H, cap))
            st[f"{pfx}_len"] = f(f"{pfx}_len", np.int32)
        st["cq_enq"] = f("cq_enq", np.int64, (H, C))
        st["ib_time"] = f("ib_time", np.int64, (H, I))
        st["ib_src"] = f("ib_src", np.int32, (H, I))
        st["ib_seq"] = f("ib_seq", np.int64, (H, I))
        st["th_time"] = f("th_time", np.int64, (H, T))
        st["th_seq"] = f("th_seq", np.int64, (H, T))
        st["th_kind"] = f("th_kind", np.uint8, (H, T)).astype(np.int32)
        st["th_tgt"] = f("th_tgt", np.uint8, (H, T)).astype(np.int32)
        st["th_valid"] = (np.arange(T)[None, :]
                          < f("th_len", np.int32)[:, None])
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
            for kk, dt in (("srchost", np.int32), ("pseq", np.int64),
                           ("sip", np.uint32), ("sport", np.int32),
                           ("dip", np.uint32), ("dport", np.int32)):
                st[f"r{r}_pk_{kk}"] = f(f"r{r}_pk_{kk}", dt)
        for k in ("rq_pos", "sq_pos", "cq_pos", "ib_pos"):
            st[k] = np.zeros(H, np.int32)
        st["cont"] = np.zeros(H, np.int32)
        st["then"] = np.zeros(H, np.int32)
        st["park_ctr"] = np.maximum(st["m_waitseq"],
                                    st["s_waitseq"]) + 1
        # padded-slot invariants the sort/argmin tricks rely on
        st["ib_time"][np.arange(I)[None, :] >= st["ib_len"][:, None]] \
            = I64_MAX
        return st

    def _from_arrays(self, st: dict) -> dict:
        """Back to the engine's packed-byte import layout (rings
        re-packed from their head positions)."""
        out = {}

        def npv(k):
            return np.asarray(st[k])

        def ring(pfx, cap, pos_k, len_k, modulo, extra=()):
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

        ring("rq", self.CAP_R, "rq_pos", "rq_len", True)
        ring("sq", self.CAP_S, "sq_pos", "sq_len", True)
        ring("cq", self.CAP_C, "cq_pos", "cq_len", True,
             extra=("cq_enq",))
        # inbox is linear (pos resets to 0 at each round's merge)
        ring("ib", self.CAP_I, "ib_pos", "ib_len", False,
             extra=("ib_time", "ib_src", "ib_seq"))
        # timer heap: compact valid entries to the front
        tv = npv("th_valid")
        order = np.argsort(~tv, axis=1, kind="stable")
        for k in ("th_time", "th_seq"):
            a = np.take_along_axis(npv(k), order, axis=1)
            out[k] = np.ascontiguousarray(a).tobytes()
        for k in ("th_kind", "th_tgt"):
            a = np.take_along_axis(npv(k), order, axis=1)
            out[k] = np.ascontiguousarray(a.astype(np.uint8)).tobytes()
        out["th_len"] = tv.sum(axis=1).astype(np.int32).tobytes()
        for k in ("now", "event_seq", "packet_seq", "recv_bytes",
                  "send_bytes", "codel_bytes", "codel_count",
                  "codel_last_count", "codel_first_above",
                  "codel_drop_next", "codel_dropped",
                  "codel_enq_pkts", "codel_enq_bytes",
                  "codel_drop_bytes", "codel_peak", "codel_marked",
                  "m_waitseq",
                  "m_gotn", "s_waitseq", "s_senti", "s_exit_time"):
            out[k] = npv(k).astype(np.int64).tobytes()
        out["pkts_sent"] = npv("app_pkts_sent").astype(np.int64).tobytes()
        out["pkts_recv"] = npv("app_pkts_recv").astype(np.int64).tobytes()
        out["pkts_dropped"] = npv("app_pkts_dropped").astype(
            np.int64).tobytes()
        out["drop_causes"] = npv("drop_causes").astype(
            np.int64).tobytes()
        for k in ("events_run", "eth_psent", "eth_precv", "eth_bsent",
                  "eth_brecv"):
            out[k] = npv(k).astype(np.int64).tobytes()
        for k in ("status", "m_waitmask", "s_waitmask", "m_lcg",
                  "m_target", "s_target"):
            out[k] = npv(k).astype(np.uint32).tobytes()
        for k in ("queued", "m_state", "m_wakep", "s_state", "s_wakep",
                  "s_exited", "codel_dropping", "m_exited",
                  "m_partdone", "s_partdone", "sock_closed",
                  "out_first", "h_fault"):
            out[k] = npv(k).astype(np.uint8).tobytes()
        out["m_exit_time"] = npv("m_exit_time").astype(
            np.int64).tobytes()
        for r in (1, 2):
            out[f"r{r}_pending"] = npv(f"r{r}_pending").astype(
                np.uint8).tobytes()
            out[f"r{r}_pk_valid"] = npv(f"r{r}_pk_valid").astype(
                np.uint8).tobytes()
            for k in ("bal", "next", "stalls", "fwd_pkts", "fwd_bytes"):
                out[f"r{r}_{k}"] = npv(f"r{r}_{k}").astype(
                    np.int64).tobytes()
            for kk in PK_KEYS:
                out[f"r{r}_pk_{kk}"] = np.ascontiguousarray(
                    npv(f"r{r}_pk_{kk}")).tobytes()
        out["app_sys"] = npv("app_sys").astype(np.int64).tobytes()
        return out

    # ------------------------------------------------------------------
    # The multi-round step, in PyTorch
    # ------------------------------------------------------------------

    def _cached_build(self, P: int):
        """The built loop for peer width `P`, from the fn cache."""
        key = (self._H, P, self._caps(), self.cap_out, self.cap_tr,
               self.tracing, self.family, self.fused, str(self.device),
               self.window_factory, self.span_factory)
        return self._cache_fn(self._fn_cache, key, self._build)

    def _window_shape(self) -> tuple:
        """The window kernel's table dimensions and build parameters."""
        shape = {"n": self._H, "I": self.CAP_I, "T": self.CAP_T,
                 "R": self.CAP_R, "S": self.CAP_S, "C": self.CAP_C,
                 "asys": ASYS_N, "tel": TEL_N, "out": self.cap_out + 1,
                 "tr": self.cap_tr + 1}
        params = {"n": self._H, "cap_i": self.CAP_I, "cap_t": self.CAP_T,
                  "cap_r": self.CAP_R, "cap_s": self.CAP_S,
                  "cap_c": self.CAP_C, "cap_out": self.cap_out,
                  "cap_tr": self.cap_tr, "tracing": int(self.tracing),
                  "family": self.family}
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
        params.update(n_nodes=len(self._lat), k0=self._k[0], k1=self._k[1],
                      bootstrap_end=self.bootstrap_end,
                      time_never=TIME_NEVER)
        return shape, params

    def _span_step(self):
        """A build's span step: the hook's, else the span kernel's on the
        card with the fused schedule and no window hook; None runs the
        eager loop."""
        factory = self.span_factory
        if factory is None:
            if not (self.fused and self.device.type == "cuda"
                    and self.window_factory is None):
                return None
            factory = PHOLD_SPAN.bind
        return factory(*self._span_shape())

    def _build(self):
        """Return `run(st, pay, start, stop, limit, runahead,
        max_rounds)`, the eager twin of the reference's jitted span loop.
        Its parts hang on it: `run.prepare(st, pay)` makes a span's local
        buffers, `run.window_plain(st, window_end)` steps one window
        eagerly (the window kernel's plain version), `run.round_end(st,
        window_end)` the eager round end, `run.span` is the build's span
        step (None: the eager loop) and `run.step` the eager loop's window
        step (None: the eager window).
        `run` updates its input state in place (the reference's donation
        semantics), so a retry re-exports."""
        H = self._H
        I, T, R, S, C = (self.CAP_I, self.CAP_T, self.CAP_R,
                         self.CAP_S, self.CAP_C)
        O = self.cap_out
        TR = self.cap_tr
        tracing = self.tracing
        family = self.family
        fused = self.fused
        dev = self.device
        span = self._span_step()
        step = None if span is not None else self._window_step()
        i64 = torch.int64
        hidx = torch.arange(H, dtype=i64, device=dev)
        where = torch.where

        def active(mask) -> bool:
            """Any lane active?  The reference guards each stage with
            `lax.cond(mask.any())`; here the guard is one host sync, and
            every guarded body is the identity on an empty mask, so
            skipping it changes no state bit."""
            return bool(mask.any())

        def hput(arr, mask, col, val):
            """Masked element write into a host-major (H, W) array: the
            JAX `.at[mrows(mask), col].set(val, mode="drop")`.  Masked
            lanes write back their own old value (each lane owns its
            row, so no two lanes collide)."""
            arr[hidx, col] = where(mask, val, arr[hidx, col]).to(arr.dtype)

        def mark_abort(st, cond, bit):
            st["abort_code"] = st["abort_code"] | where(cond, bit, 0)

        def inc(st, key, mask, by=1):
            st[key] = where(mask, st[key] + by, st[key])

        # -------- primitive helpers ----------------------------------

        def th_push(st, mask, time_, seq, kind, tgt):
            if not active(mask):
                return
            tv = st["th_valid"]
            free = torch.argmin(tv.to(torch.uint8), dim=1)  # first free
            overflow = mask & tv.all(dim=1)
            ok = mask & ~overflow  # an overflowing lane writes nothing
            for key, v in (("th_time", time_), ("th_seq", seq),
                           ("th_kind", kind), ("th_tgt", tgt),
                           ("th_valid", True)):
                hput(st[key], ok, free, v)
            mark_abort(st, overflow.any(), AB_STRUCT)

        def th_min(st):
            t = where(st["th_valid"], st["th_time"], I64_MAX)
            best_t = t.min(dim=1).values
            s = where(t == best_t[:, None], st["th_seq"], I64_MAX)
            slot = torch.argmin(s, dim=1)
            return (best_t, st["th_kind"][hidx, slot],
                    st["th_tgt"][hidx, slot], slot)

        def draw_seq(st, mask):
            v = st["event_seq"]
            st["event_seq"] = where(mask, v + 1, v)
            return v

        def lcg_next(st, mask):
            # uint32 LCG: the port keeps the word in int64 and wraps it.
            v = st["m_lcg"]
            nv = (v * 1664525 + 1013904223) & M32
            st["m_lcg"] = where(mask, nv, v)
            return nv

        def seq_append(st, cap_total, mask, cols, count_key, abort_bit):
            """Ordered multi-append into a flat buffer (outbox/trace):
            lanes rank by host index.  Masked lanes and lanes past the
            capacity land in the trash slot at index cap_total."""
            if not active(mask):
                return
            n = st[count_key]
            rank = torch.cumsum(mask, 0) - 1
            slot = where(mask & (n + rank < cap_total), n + rank,
                         cap_total)
            for key, v in cols.items():
                st[key][slot] = v
            total = n + mask.sum()
            st[count_key] = total
            mark_abort(st, total > cap_total - H, abort_bit)

        def tr_append(st, mask, time_, kind, pk, reason):
            if not tracing:
                return
            seq_append(
                st, TR, mask,
                {"tr_t": time_, "tr_kind": kind,
                 "tr_srchost": pk["srchost"], "tr_pseq": pk["pseq"],
                 "tr_sip": pk["sip"], "tr_sport": pk["sport"],
                 "tr_dip": pk["dip"], "tr_dport": pk["dport"],
                 "tr_reason": reason, "tr_owner": hidx}, "tr_n", AB_TRACE)

        def wake_check(st, changed, time_):
            """adjust_status's app_wake fan-out, ordered by wait_seq
            when both siblings qualify."""
            m_ok = ((st["m_wakep"] == 0) & (st["m_exited"] == 0)
                    & ((changed & st["m_waitmask"]) != 0))
            s_ok = ((st["s_wakep"] == 0) & (st["s_exited"] == 0)
                    & ((changed & st["s_waitmask"]) != 0))
            first = m_ok | s_ok
            if not active(first):
                return
            both = m_ok & s_ok
            first_is_s = (both & (st["s_waitseq"] < st["m_waitseq"])) \
                | (s_ok & ~m_ok)
            sq1 = draw_seq(st, first)
            th_push(st, first & first_is_s, time_, sq1, TK_APP, 1)
            th_push(st, first & ~first_is_s, time_, sq1, TK_APP, 0)
            st["s_wakep"] = where(first & first_is_s, 1, st["s_wakep"])
            st["m_wakep"] = where(first & ~first_is_s, 1, st["m_wakep"])
            sq2 = draw_seq(st, both)
            th_push(st, both & first_is_s, time_, sq2, TK_APP, 0)
            th_push(st, both & ~first_is_s, time_, sq2, TK_APP, 1)
            st["m_wakep"] = where(both & first_is_s, 1, st["m_wakep"])
            st["s_wakep"] = where(both & ~first_is_s, 1, st["s_wakep"])

        def set_status(st, set_bits, clear_bits, mask, time_):
            cur = st["status"]
            nw = (cur | set_bits) & ~clear_bits
            changed = where(mask, cur ^ nw, 0)
            st["status"] = where(mask, nw, cur)
            wake_check(st, changed, time_)

        def bucket_try(st, r, now, mask):
            """The token-bucket law on the lanes of `mask` (one call of
            the standalone kernel's wrapper)."""
            bal = st[f"r{r}_bal"]
            nxt = st[f"r{r}_next"]
            bal3, nxt2, ok = BUCKET_STEP(
                bal, nxt, st[f"r{r}_refill"], st[f"r{r}_cap"],
                st[f"r{r}_unlimited"] == 1, st["_psize"], now)
            st["ks_calls"][CALL_BUCKET] += 1
            st[f"r{r}_bal"] = where(mask, bal3, bal)
            st[f"r{r}_next"] = where(mask, nxt2, nxt)
            return ok, nxt2

        def control_time(t, count):
            """CoDel's control law, t + interval / sqrt(count), with the
            engine's integer square root: a float64 sqrt and the same
            four correction steps."""
            v = count << 32
            g = torch.sqrt(v.to(torch.float64)).to(i64)
            g = where(g * g > v, g - 1, g)
            g = where(g * g > v, g - 1, g)
            g = where((g + 1) * (g + 1) <= v, g + 1, g)
            g = where((g + 1) * (g + 1) <= v, g + 1, g)
            g = g.clamp(min=1)
            return t + (CODEL_INTERVAL_NS << 16) // g

        # -------- micro-op: relay drains -----------------------------

        def codel_pop(st, pop, none, now, enq, pk):
            """Full CoDel (codel_pop twin): one dequeue per micro-op;
            the drop loop and the leading-drop sniff unroll across
            micro-ops via the cd_chain / cd_sniff substates.  Returns
            the popped lanes CoDel delivers."""
            psize = st["_psize"]
            st["cq_pos"] = where(pop, st["cq_pos"] + 1, st["cq_pos"])
            st["codel_bytes"] = where(pop, st["codel_bytes"] - psize,
                                      st["codel_bytes"])
            # dequeue_raw's ok/first_above law (the CoDel head kernel)
            _quiet, _above, _arm, cok, fa_new = CODEL_HEAD(
                pop, none, now, enq, st["codel_bytes"],
                st["codel_first_above"])
            st["ks_calls"][CALL_CODEL] += 1
            st["codel_first_above"] = fa_new
            st["codel_dropping"] = where(none, 0, st["codel_dropping"])
            st["cd_chain"] = where(none, 0, st["cd_chain"])
            st["cd_sniff"] = where(none, 0, st["cd_sniff"])

            in_sniff = st["cd_sniff"] == 1
            in_chain = (st["cd_chain"] == 1) & ~in_sniff
            top = pop & ~in_sniff & ~in_chain

            # sniff resolution (the dequeue after a leading drop): the
            # drop-state entry, delivered regardless of its own ok bit.
            sg = pop & in_sniff
            cnt_new = where(
                now - st["codel_drop_next"] < CODEL_INTERVAL_NS,
                where(st["codel_count"] > 2,
                      st["codel_count"] - st["codel_last_count"], 1), 1)
            st["codel_dropping"] = where(sg, 1, st["codel_dropping"])
            st["codel_count"] = where(sg, cnt_new, st["codel_count"])
            st["codel_last_count"] = where(sg, cnt_new,
                                           st["codel_last_count"])
            st["codel_drop_next"] = where(sg, control_time(now, cnt_new),
                                          st["codel_drop_next"])
            st["cd_sniff"] = where(sg, 0, st["cd_sniff"])

            # chain continuation: the post-dequeue drop_next update, then
            # the while condition decides drop-or-deliver.
            cg = pop & in_chain
            cg_exit = cg & ~cok
            st["codel_dropping"] = where(cg_exit, 0, st["codel_dropping"])
            st["cd_chain"] = where(cg_exit, 0, st["cd_chain"])
            cg_ok = cg & cok
            dn2 = control_time(st["codel_drop_next"], st["codel_count"])
            st["codel_drop_next"] = where(cg_ok, dn2,
                                          st["codel_drop_next"])
            cg_drop = cg_ok & (now >= st["codel_drop_next"])
            cg_deliver = cg_ok & ~cg_drop
            st["cd_chain"] = where(cg_deliver, 0, st["cd_chain"])

            # top entry while in drop state
            td = top & (st["codel_dropping"] == 1)
            td_exit = td & ~cok
            st["codel_dropping"] = where(td_exit, 0, st["codel_dropping"])
            td_ok = td & cok
            td_drop = td_ok & (now >= st["codel_drop_next"])
            st["cd_chain"] = where(td_drop, 1, st["cd_chain"])

            # leading-edge drop (AQM trigger).  `~td`: a lane that
            # entered this dequeue in drop state took the engine's
            # if-branch even when it just cleared dropping.
            tl = top & ~td & cok & (
                (now - st["codel_drop_next"] < CODEL_INTERVAL_NS)
                | (now - st["codel_first_above"] >= CODEL_INTERVAL_NS))
            st["cd_sniff"] = where(tl, 1, st["cd_sniff"])

            codel_drop = cg_drop | td_drop | tl
            # chain drops advance count; the leading drop does not
            st["codel_count"] = where(cg_drop | td_drop,
                                      st["codel_count"] + 1,
                                      st["codel_count"])
            inc(st, "codel_dropped", codel_drop)
            inc(st, "codel_drop_bytes", codel_drop, psize)
            inc(st, "app_pkts_dropped", codel_drop)
            st["drop_causes"][:, TEL_CODEL] += codel_drop
            tr_append(st, codel_drop, now, TR_DRP, pk, RSN_CODEL)
            # dropped lanes stay in the drain (the next micro-op
            # re-dequeues); delivered lanes carry on
            return pop & ~codel_drop

        def relay1_forward(st, fwd, now, pk):
            """device_push(dev=2): a cross-host send into the outbox."""
            ips_sorted = st["_ips_sorted"]
            dslot = torch.searchsorted(ips_sorted, pk["dip"]).clamp(
                max=H - 1)
            found = ips_sorted[dslot] == pk["dip"]
            dst = st["_ips_perm"][dslot]
            inc(st, "app_pkts_sent", fwd)
            # NIC link down: the send dies at the egress instant, before
            # the event-seq draw (the no-route drop's position).
            linkdn = fwd & ((st["h_fault"] & 2) != 0)
            inc(st, "app_pkts_dropped", linkdn)
            st["drop_causes"][:, TEL_LINK_DOWN] += linkdn
            tr_append(st, linkdn, now, TR_DRP, pk, RSN_LINKDOWN)
            fwd = fwd & ~linkdn
            miss = fwd & ~found
            inc(st, "app_pkts_dropped", miss)
            st["drop_causes"][:, TEL_NO_ROUTE] += miss
            tr_append(st, miss, now, TR_DRP, pk, RSN_NOROUTE)
            hit = fwd & found
            sq = draw_seq(st, hit)
            seq_append(
                st, O, hit,
                {"out_src": hidx, "out_dst": dst, "out_seq": sq,
                 "out_pseq": pk["pseq"], "out_sip": pk["sip"],
                 "out_sport": pk["sport"], "out_dip": pk["dip"],
                 "out_dport": pk["dport"], "out_t": now}, "out_n",
                AB_OUT)

        def relay2_deliver(st, fwd, now, pk):
            """iface_receive -> udp_push_in."""
            psize = st["_psize"]
            inc(st, "eth_precv", fwd)
            inc(st, "eth_brecv", fwd, psize)
            wrong = fwd & ((pk["dport"] != st["m_port"])
                           | (st["sock_closed"] == 1))
            inc(st, "app_pkts_dropped", wrong)
            st["drop_causes"][:, TEL_NO_SOCKET] += wrong
            tr_append(st, wrong, now, TR_DRP, pk, RSN_NOSOCK)
            deliver = fwd & ~wrong
            full = deliver & (st["recv_bytes"] + psize > st["recv_max"])
            inc(st, "app_pkts_dropped", full)
            st["drop_causes"][:, TEL_RECVBUF_FULL] += full
            tr_append(st, full, now, TR_DRP, pk, RSN_RCVBUF)
            good = deliver & ~full
            if not active(good):
                return
            mark_abort(st, (good & (st["rq_len"] - st["rq_pos"]
                                    >= R - 1)).any(), AB_STRUCT)
            tail = st["rq_len"] % R
            for kk in PK_KEYS:
                hput(st[f"rq_{kk}"], good, tail, pk[kk])
            inc(st, "rq_len", good)
            inc(st, "recv_bytes", good, psize)
            set_status(st, S_READABLE, 0, good, now)
            inc(st, "app_pkts_recv", good)
            tr_append(st, good, now, TR_RCV, pk, RSN_NONE)

        def op_relay(st, r, mask):
            now = st["now"]
            psize = st["_psize"]
            use_pend = mask & (st[f"r{r}_pk_valid"] == 1)
            if r == 1:
                src_avail = mask & (st["queued"] == 1) & (
                    st["sq_len"] > st["sq_pos"])
                pos = st["sq_pos"] % S
            else:
                src_avail = mask & (st["cq_len"] > st["cq_pos"])
                pos = st["cq_pos"] % C
            ring = "sq" if r == 1 else "cq"
            pk = {kk: where(use_pend, st[f"r{r}_pk_{kk}"],
                            st[f"{ring}_{kk}"][hidx, pos])
                  for kk in PK_KEYS}
            pop = mask & ~use_pend & src_avail
            none = mask & ~use_pend & ~src_avail
            st[f"r{r}_pk_valid"] = where(use_pend, 0, st[f"r{r}_pk_valid"])
            if r == 1:
                # iface_pop twin: dequeue, writable status, SND trace
                inc(st, "sq_pos", pop)
                st["send_bytes"] = where(pop, st["send_bytes"] - psize,
                                         st["send_bytes"])
                st["queued"] = where(pop, (st["sq_len"]
                                           > st["sq_pos"]).to(i64),
                                     st["queued"])
                # pull_out_packet guards the writable set with
                # !(status & S_CLOSED)
                set_status(st, S_WRITABLE, 0,
                           pop & (st["sock_closed"] == 0), now)
                inc(st, "eth_psent", pop)
                inc(st, "eth_bsent", pop, psize)
                tr_append(st, pop, now, TR_SND, pk, RSN_NONE)
            else:
                pop = codel_pop(st, pop, none, now,
                                st["cq_enq"][hidx, pos], pk)

            has_pkt = use_pend | pop
            done = none
            if active(has_pkt):
                ok, when = bucket_try(st, r, now, has_pkt)
                throttled = has_pkt & ~ok
                st[f"r{r}_stalls"] = st[f"r{r}_stalls"] + throttled
                st[f"r{r}_pending"] = where(throttled, 1,
                                            st[f"r{r}_pending"])
                st[f"r{r}_pk_valid"] = where(throttled, 1,
                                             st[f"r{r}_pk_valid"])
                for kk in PK_KEYS:
                    st[f"r{r}_pk_{kk}"] = where(throttled, pk[kk],
                                                st[f"r{r}_pk_{kk}"])
                sq = draw_seq(st, throttled)
                th_push(st, throttled, when, sq, TK_RELAY, r)
                fwd = has_pkt & ok
                st[f"r{r}_fwd_pkts"] = st[f"r{r}_fwd_pkts"] + fwd
                st[f"r{r}_fwd_bytes"] = st[f"r{r}_fwd_bytes"] \
                    + where(fwd, psize, 0)
                if r == 1:
                    relay1_forward(st, fwd, now, pk)
                else:
                    relay2_deliver(st, fwd, now, pk)
                done = none | throttled
            st["cont"] = where(done, st["then"], st["cont"])
            st["then"] = where(done, C_IDLE, st["then"])

        # -------- micro-op: app steppers -----------------------------

        def sq_push(st, sent, dip):
            """Enqueue one datagram per `sent` lane on the send queue;
            returns the lanes that must notify the inet-out relay."""
            psize = st["_psize"]
            pseq = st["packet_seq"]
            st["packet_seq"] = where(sent, pseq + 1, pseq)
            mark_abort(st, (sent & (st["sq_len"] - st["sq_pos"]
                                    >= S - 1)).any(), AB_STRUCT)
            tail = st["sq_len"] % S
            vals = {"srchost": hidx, "pseq": pseq, "sip": st["eth_ip"],
                    "sport": st["m_port"], "dip": dip,
                    "dport": st["m_port"]}
            for kk in PK_KEYS:
                hput(st[f"sq_{kk}"], sent, tail, vals[kk])
            inc(st, "sq_len", sent)
            inc(st, "send_bytes", sent, psize)
            newly = sent & (st["queued"] == 0)
            st["queued"] = where(newly, 1, st["queued"])
            return newly & (st["r1_pending"] == 0)

        def park(st, over, wm_k, ws_k, bit):
            """EAGAIN / empty-recv park: wait on `bit`, stamped with the
            host's park counter."""
            st[wm_k] = where(over, bit, st[wm_k])
            st[ws_k] = where(over, st["park_ctr"], st[ws_k])
            inc(st, "park_ctr", over)

        def phold_send_phase(st, mask, is_seed):
            """One phold_send attempt; returns (sent, parked, notify)."""
            now = st["now"]
            state_k = "s_state" if is_seed else "m_state"
            tgt_k = "s_target" if is_seed else "m_target"
            fresh = mask & (st[state_k] != 3)
            rnd = lcg_next(st, fresh)
            npeers = st["n_peers"].clamp(min=1)
            pick = st["peers"][hidx, rnd % npeers]
            st[tgt_k] = where(fresh, pick, st[tgt_k])
            st[state_k] = where(fresh, 3, st[state_k])
            st["app_sys"][:, ASYS_SENDTO] += mask
            over = mask & (st["send_bytes"] + st["_psize"]
                           > st["send_max"])
            set_status(st, 0, S_WRITABLE, over, now)
            park(st, over, "s_waitmask" if is_seed else "m_waitmask",
                 "s_waitseq" if is_seed else "m_waitseq", S_WRITABLE)
            sent = mask & ~over
            notify = sq_push(st, sent, st[tgt_k])
            st[state_k] = where(sent, 0, st[state_k])
            return sent, over, notify

        def arm_sleep(st, mask, is_seed):
            if not active(mask):
                return
            now = st["now"]
            st["app_sys"][:, ASYS_NANOSLEEP] += mask
            r1 = lcg_next(st, mask)
            r2 = lcg_next(st, mask)
            u = r1 % 1000 + r2 % 1000 + 1
            d = ((u * st["m_mean"]) // 1000).clamp(min=1)
            state_k = "s_state" if is_seed else "m_state"
            wake_k = "s_wakep" if is_seed else "m_wakep"
            st[state_k] = where(mask, 1, st[state_k])
            st[wake_k] = where(mask, 1, st[wake_k])
            sq = draw_seq(st, mask)
            th_push(st, mask, now + d, sq, TK_APP_TIMEOUT,
                    1 if is_seed else 0)

        def mesh_try_exit(st, mask):
            """mesh_try_exit twin: when both thread parts are done the
            process exits: the fd closes without a counted syscall, the
            recv queue dies with it, the send queue keeps draining."""
            now = st["now"]
            both = mask & (st["m_partdone"] == 1) \
                & (st["s_partdone"] == 1) & (st["sock_closed"] == 0)
            if not active(both):
                return
            st["sock_closed"] = where(both, 1, st["sock_closed"])
            # udp_close's adjust_status: set CLOSED, clear
            # ACTIVE|READABLE|WRITABLE (no wakes: both parts done)
            set_status(st, 1 << 3, (1 << 0) | S_READABLE | S_WRITABLE,
                       both, now)
            st["rq_pos"] = where(both, st["rq_len"], st["rq_pos"])
            st["recv_bytes"] = where(both, 0, st["recv_bytes"])
            st["m_exited"] = where(both, 1, st["m_exited"])
            st["m_exit_time"] = where(both, now, st["m_exit_time"])

        def recv_one(st, mask, got_by):
            """One recvfrom on the main thread: park the empty lanes on
            READABLE, else dequeue one datagram; returns the lanes that
            got one (m_gotn advanced by `got_by`)."""
            now = st["now"]
            st["app_sys"][:, ASYS_RECVFROM] += mask
            empty = mask & (st["rq_len"] <= st["rq_pos"])
            park(st, empty, "m_waitmask", "m_waitseq", S_READABLE)
            st["cont"] = where(empty, C_IDLE, st["cont"])
            got = mask & ~empty
            inc(st, "rq_pos", got)
            st["recv_bytes"] = where(got, st["recv_bytes"] - st["_psize"],
                                     st["recv_bytes"])
            now_empty = got & (st["rq_len"] <= st["rq_pos"])
            set_status(st, 0, S_READABLE, now_empty, now)
            inc(st, "m_gotn", got, got_by)
            return got

        def op_step_mesh(st, mask, is_seed):
            """udp-mesh micro-ops (app_step_mesh / app_step_mesh_snd
            twins): the sender streams one datagram per micro-op; the
            main sinks one datagram per micro-op."""
            now = st["now"]
            if is_seed:
                first = mask & (st["s_state"] == 0)
                st["app_sys"][:, ASYS_RESOLVE] += where(first,
                                                        st["n_peers"], 0)
                st["s_state"] = where(first, 1, st["s_state"])
                sending = mask & (st["s_senti"] < st["s_count"])
                st["app_sys"][:, ASYS_SENDTO] += sending
                over = sending & (st["send_bytes"] + st["_psize"]
                                  > st["send_max"])
                set_status(st, 0, S_WRITABLE, over, now)
                park(st, over, "s_waitmask", "s_waitseq", S_WRITABLE)
                st["cont"] = where(over, C_IDLE, st["cont"])
                sent = sending & ~over
                npeers = st["n_peers"].clamp(min=1)
                pick = st["peers"][hidx, st["s_senti"] % npeers]
                notify = sq_push(st, sent, pick)
                inc(st, "s_senti", sent)
                # keep sending (possibly via a relay drain first)
                st["cont"] = where(notify, C_R1,
                                   where(sent, C_S_STEP, st["cont"]))
                st["then"] = where(notify, C_S_STEP, st["then"])
                done = mask & ~sending
                st["app_sys"][:, ASYS_WRITE] += done  # "mesh sent"
                st["out_first"] = where(done & (st["out_first"] == 0), 2,
                                        st["out_first"])
                st["s_partdone"] = where(done, 1, st["s_partdone"])
                st["s_exited"] = where(done, 1, st["s_exited"])
                st["s_exit_time"] = where(done, now, st["s_exit_time"])
                st["s_waitmask"] = where(done, 0, st["s_waitmask"])
                st["cont"] = where(done, C_IDLE, st["cont"])
                mesh_try_exit(st, done)
            else:
                expect = st["s_count"] * st["_pay"]
                got = recv_one(st, mask, st["_pay"])
                more = got & (st["m_gotn"] < expect)
                st["cont"] = where(more, C_M_STEP, st["cont"])
                fin = got & ~more
                st["app_sys"][:, ASYS_WRITE] += fin  # "mesh received"
                st["out_first"] = where(fin & (st["out_first"] == 0), 1,
                                        st["out_first"])
                st["m_partdone"] = where(fin, 1, st["m_partdone"])
                st["m_waitmask"] = where(fin, 0, st["m_waitmask"])
                st["cont"] = where(fin, C_IDLE, st["cont"])
                mesh_try_exit(st, fin)

        def op_step(st, mask, is_seed):
            """C_M_STEP / C_S_STEP micro-op."""
            if family == 1:
                op_step_mesh(st, mask, is_seed)
                return
            state_k = "s_state" if is_seed else "m_state"
            restart = mask & (st[state_k] == 1)
            st["app_sys"][:, ASYS_NANOSLEEP] += restart
            st[state_k] = where(restart, 2, st[state_k])
            has_send = mask & ((st[state_k] == 2) | (st[state_k] == 3))
            sent, parked, notify = phold_send_phase(st, has_send, is_seed)
            if is_seed:
                inc(st, "s_senti", sent)
            nxt = C_S_POST if is_seed else C_M_RECV
            to_next = (mask & ~has_send) | sent
            go_drain = notify & sent
            st["cont"] = where(
                go_drain, C_R1, where(to_next, nxt,
                                      where(parked, C_IDLE, st["cont"])))
            st["then"] = where(go_drain, nxt, st["then"])

        def op_stage2(st, mask):
            """C_M_RECV / C_S_POST micro-op (phold only; mesh steppers
            never use these continuations)."""
            if family == 1:
                return
            now = st["now"]
            m_recv = mask & (st["cont"] == C_M_RECV)
            s_post = mask & (st["cont"] == C_S_POST)
            got = recv_one(st, m_recv, 1)
            arm_sleep(st, got, False)
            st["cont"] = where(got, C_IDLE, st["cont"])

            done = s_post & (st["s_senti"] >= st["s_count"])
            st["s_exited"] = where(done, 1, st["s_exited"])
            st["s_exit_time"] = where(done, now, st["s_exit_time"])
            st["s_waitmask"] = where(done, 0, st["s_waitmask"])
            st["cont"] = where(done, C_IDLE, st["cont"])
            more = s_post & ~done
            arm_sleep(st, more, True)
            st["cont"] = where(more, C_IDLE, st["cont"])

        # -------- micro-op: event pop --------------------------------

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

        def pick_inbox(ib_t, th_t):
            return where(ib_t != th_t, ib_t < th_t, ib_t < I64_MAX)

        # The loop condition's timer-heap minimum, valid until the next
        # stage runs (the fused schedule pops first after it).
        th_memo = [None]

        def op_pop_event(st, mask, window_end):
            pos = st["ib_pos"]
            psize = st["_psize"]
            ib_t, safe = ib_head_time(st)
            tmin, tkind, ttgt, tslot = th_memo[0] or th_min(st)
            pick_ib = pick_inbox(ib_t, tmin)
            et = torch.minimum(ib_t, tmin)
            due = mask & (et < window_end)
            st["now"] = where(due, et, st["now"])
            inc(st, "events_run", due)
            # Down-host fault mask: arrivals at a dead/link-down host die
            # at their recorded instant; a dead host's timers discard.
            h_down = (st["h_fault"] & 1) != 0
            nic_dead = st["h_fault"] != 0

            # arrival: inbox -> codel -> relay 2.  At the engine's hard
            # limit the arrival drops with an rtr-limit breadcrumb.
            arr = due & pick_ib
            st["ib_pos"] = where(arr, pos + 1, pos)
            pk_arr = {kk: st[f"ib_{kk}"][hidx, safe] for kk in PK_KEYS}
            arr_f = arr & nic_dead
            inc(st, "app_pkts_dropped", arr_f)
            st["drop_causes"][:, TEL_HOST_DOWN] += arr_f & h_down
            st["drop_causes"][:, TEL_LINK_DOWN] += arr_f & ~h_down
            tr_append(st, arr_f & h_down, et, TR_DRP, pk_arr,
                      RSN_HOSTDOWN)
            tr_append(st, arr_f & ~h_down, et, TR_DRP, pk_arr,
                      RSN_LINKDOWN)
            arr = arr & ~nic_dead
            inc(st, "codel_enq_pkts", arr)
            inc(st, "codel_enq_bytes", arr, psize)
            # The DCTCP-K marking law fires only on ECT(0) arrivals: this
            # family's UDP packets never are, so it is inert here.
            limit_full = arr & (st["cq_len"] - st["cq_pos"]
                                >= CODEL_HARD_LIMIT)
            inc(st, "codel_dropped", limit_full)
            inc(st, "codel_drop_bytes", limit_full, psize)
            inc(st, "app_pkts_dropped", limit_full)
            st["drop_causes"][:, TEL_RTR_LIMIT] += limit_full
            tr_append(st, limit_full, et, TR_DRP, pk_arr, RSN_RTRLIMIT)
            arr = arr & ~limit_full
            if active(arr):
                mark_abort(st, (arr & (st["cq_len"] - st["cq_pos"]
                                       >= C - 1)).any(), AB_STRUCT)
                tail = st["cq_len"] % C
                for kk in PK_KEYS:
                    hput(st[f"cq_{kk}"], arr, tail, pk_arr[kk])
                hput(st["cq_enq"], arr, tail, et)
                inc(st, "cq_len", arr)
                st["codel_peak"] = torch.maximum(
                    st["codel_peak"],
                    where(arr, st["cq_len"] - st["cq_pos"], 0))
                inc(st, "codel_bytes", arr, psize)
                go2 = arr & (st["r2_pending"] == 0)
                st["cont"] = where(go2, C_R2, st["cont"])
                st["then"] = where(go2, C_IDLE, st["then"])

            # timer
            tim = due & ~pick_ib
            if not active(tim):
                return
            hput(st["th_valid"], tim, tslot, False)
            # a dead host's timers discard silently
            tim = tim & ~h_down
            is_relay = tim & (tkind == TK_RELAY)
            for r in (1, 2):
                rw = is_relay & (ttgt == r)
                # relay._wakeup: state -> idle; the parked packet stays
                st[f"r{r}_pending"] = where(rw, 0, st[f"r{r}_pending"])
                st["cont"] = where(rw, C_R1 if r == 1 else C_R2,
                                   st["cont"])
                st["then"] = where(rw, C_IDLE, st["then"])

            is_to = tim & (tkind == TK_APP_TIMEOUT)
            if active(is_to):
                sq = draw_seq(st, is_to)
                th_push(st, is_to & (ttgt == 0), et, sq, TK_APP, 0)
                th_push(st, is_to & (ttgt == 1), et, sq, TK_APP, 1)

            is_app = tim & (tkind == TK_APP)
            m_app = is_app & (ttgt == 0)
            s_app = is_app & (ttgt == 1)
            st["m_wakep"] = where(m_app, 0, st["m_wakep"])
            st["s_wakep"] = where(s_app, 0, st["s_wakep"])
            st["m_waitmask"] = where(m_app, 0, st["m_waitmask"])
            st["s_waitmask"] = where(s_app, 0, st["s_waitmask"])
            s_live = s_app & (st["s_exited"] == 0)
            m_live = m_app & (st["m_exited"] == 0)
            st["cont"] = where(m_live, C_M_STEP,
                               where(s_live, C_S_STEP, st["cont"]))

        # -------- per-iteration dispatchers --------------------------

        def counted(st, op, code, mask, n, *args):
            """Run one stage pass on `n` > 0 active lanes and credit it:
            a fire, its lanes, and the host wall from its guard's sync to
            the end of its issue."""
            t0 = time.perf_counter()
            op(st, mask, *args)
            st["ks_wall_s"][code] += time.perf_counter() - t0
            st["ks_fires"][code] += 1
            st["ks_lanes"][code] += n

        def count_only(st, code, n):
            if n:
                st["ks_fires"][code] += 1
                st["ks_lanes"][code] += n

        def micro_iter_fused(st, window_end, n_due, n_tim):
            """Ops consume the live continuation in dataflow order, so a
            host flows through its whole event chain (pop -> app step ->
            relay drain -> recv/arm) inside one iteration.  Per-host op
            order is untouched, and hosts are independent within a
            round, so only the outbox/trace interleave changes, which
            the inbox lexsort and the canonical trace sort erase."""
            def stage(op, cont_mask, code):
                n = int(cont_mask.sum())  # the guard's one host sync
                if n:
                    counted(st, op, code, cont_mask, n)

            # The event pop fires on the idle lanes with a due event,
            # counted by the loop condition's sync; with none due it is
            # the identity and is skipped.  Its timer pops also credit
            # the timers slot (this family handles them inline).
            if n_due:
                counted(st, op_pop_event, KS_POP, st["cont"] == C_IDLE,
                        n_due, window_end)
            count_only(st, KS_TIMERS, n_tim)
            th_memo[0] = None
            stage(lambda s, m: op_step(s, m, False),
                  st["cont"] == C_M_STEP, KS_STEP)
            stage(lambda s, m: op_step(s, m, True),
                  st["cont"] == C_S_STEP, KS_STEP)
            # Two relay passes per iteration: the second lets a drain
            # that just emptied its source take the exhausted-exit in
            # the same iteration.
            for _ in range(2):
                stage(lambda s, m: op_relay(s, 1, m), st["cont"] == C_R1,
                      KS_INET_OUT)
                stage(lambda s, m: op_relay(s, 2, m), st["cont"] == C_R2,
                      KS_CODEL)
            stage(op_stage2, (st["cont"] == C_M_RECV)
                  | (st["cont"] == C_S_POST), KS_ARM)

        def micro_iter_unfused(st, window_end):
            """The reference schedule: a snapshot of the continuations,
            each host advancing one micro-op per iteration (a host that
            another op just moved waits for the next iteration)."""
            cont0 = st["cont"]
            masks = ((KS_INET_OUT, cont0 == C_R1),
                     (KS_CODEL, cont0 == C_R2),
                     (KS_STEP, (cont0 == C_M_STEP) | (cont0 == C_S_STEP)),
                     (KS_ARM, (cont0 == C_M_RECV) | (cont0 == C_S_POST)))
            for code, m in masks:
                count_only(st, code, int(m.sum()))
            for op, m in ((lambda s, mm: op_relay(s, 1, mm),
                           cont0 == C_R1),
                          (lambda s, mm: op_relay(s, 2, mm),
                           cont0 == C_R2),
                          (lambda s, mm: op_step(s, mm, False),
                           cont0 == C_M_STEP),
                          (lambda s, mm: op_step(s, mm, True),
                           cont0 == C_S_STEP),
                          (op_stage2, (cont0 == C_M_RECV)
                           | (cont0 == C_S_POST))):
                if active(m):
                    op(st, m)
            # Counted against the state the pop actually reads (earlier
            # ops may have armed timers).
            idle = cont0 == C_IDLE
            ib_t, th_t = next_event_time(st)
            due = idle & (torch.minimum(ib_t, th_t) < window_end)
            n_due, n_tim = (int(v) for v in torch.stack(
                [due.sum(), (due & ~pick_inbox(ib_t, th_t)).sum()]).tolist())
            count_only(st, KS_POP, n_due)
            count_only(st, KS_TIMERS, n_tim)
            if n_due:
                op_pop_event(st, idle, window_end)

        def micro_busy(st, window_end):
            """The loop condition, the one host sync per iteration: (any
            lane busy or due and no abort, the idle lanes due, of which
            timer pops)."""
            ib_t, _ = ib_head_time(st)
            memo = th_min(st)
            th_memo[0] = memo if fused else None
            due = torch.minimum(ib_t, memo[0]) < window_end
            busy = st["cont"] != C_IDLE
            go = ((busy | due).any() & (st["abort_code"] == 0)).to(i64)
            pop = due & ~busy
            go, n_due, n_tim = torch.stack(
                [go, pop.sum(), (pop & ~pick_inbox(ib_t, memo[0])).sum()]
            ).tolist()
            return bool(go), n_due, n_tim

        def window_plain(st, window_end) -> int:
            """The eager window (the kernel's plain version): iterations
            until no lane is busy or due, or an abort; returns their
            count and credits the stage counters in `st`."""
            it = 0
            while True:
                go, n_due, n_tim = micro_busy(st, window_end)
                if not go:
                    break
                if fused:
                    micro_iter_fused(st, window_end, n_due, n_tim)
                else:
                    micro_iter_unfused(st, window_end)
                # runaway valve: a continuation-cycle bug must abort,
                # not spin
                if it > (1 << 22):
                    st["abort_code"] = st["abort_code"] | AB_STRUCT
                it += 1
            th_memo[0] = None
            return it

        # -------- round end: propagation + inbox merge ---------------

        ar_o = torch.arange(O, dtype=i64, device=dev)
        k0 = torch.tensor(self._k[0], dtype=i64, device=dev)
        k1 = torch.tensor(self._k[1], dtype=i64, device=dev)
        bootstrap = self.bootstrap_end

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
            lossy = (bits < thr_v) & (out_t >= bootstrap)
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
                st["app_pkts_dropped"] = st["app_pkts_dropped"] + cnt
                st["drop_causes"][:, tel] += cnt
                if tracing:
                    nt_ = st["tr_n"]
                    rank = torch.cumsum(miss, 0) - 1
                    slot = where(miss & (nt_ + rank < TR), nt_ + rank, TR)
                    for key, v in (
                            ("tr_t", out_t), ("tr_kind", TR_DRP),
                            ("tr_srchost", src),
                            ("tr_pseq", st["out_pseq"][:O]),
                            ("tr_sip", st["out_sip"][:O]),
                            ("tr_sport", st["out_sport"][:O]),
                            ("tr_dip", st["out_dip"][:O]),
                            ("tr_dport", st["out_dport"][:O]),
                            ("tr_reason", rsn), ("tr_owner", src)):
                        st[key][slot] = v
                    tot = nt_ + miss.sum()
                    st["tr_n"] = tot
                    mark_abort(st, tot > TR - O, AB_TRACE)

            # Scatter the kept packets into their destination inboxes in
            # the inbox heap's total order (time, src, seq).
            new = {"time": deliver, "src": src, "seq": st["out_seq"][:O],
                   "srchost": src}
            for kk in PK_KEYS[1:]:
                new[kk] = st[f"out_{kk}"][:O]
            over = merge_inbox(st, keep, dst, new)
            mark_abort(st, over.any(), AB_STRUCT)
            st["out_n"] = torch.zeros((), dtype=i64, device=dev)
            return n, min_lat

        # -------- the multi-round loop -------------------------------

        def prepare(st, pay):
            """A span's local buffers and counters, made anew in `st`."""
            z = torch.zeros((), dtype=i64, device=dev)
            st["_pay"] = torch.tensor(pay, dtype=i64, device=dev)
            st["_psize"] = torch.tensor(pay + 28, dtype=i64, device=dev)
            st["abort_code"] = z.clone()
            # Flat span-local buffers carry one trash slot at the end.
            st["out_n"] = z.clone()
            for kk in OUT_KEYS:
                st[f"out_{kk}"] = torch.zeros(O + 1, dtype=i64, device=dev)
            if tracing:
                st["tr_n"] = z.clone()
                for kk in TR_KEYS:
                    st[f"tr_{kk}"] = torch.zeros(TR + 1, dtype=i64,
                                                 device=dev)
            # Span-local stage counters and kernel calls (output only,
            # never engine state).
            st["ks_fires"] = np.zeros(KS_N, np.int64)
            st["ks_lanes"] = np.zeros(KS_N, np.int64)
            st["ks_wall_s"] = np.zeros(KS_N)
            st["ks_calls"] = np.zeros(2, np.int64)
            st["ks_windows"] = 0
            st["ks_window_ms"] = 0.0
            st["ks_spans"] = 0
            st["ks_span_ms"] = 0.0

        def round_end(st, window_end):
            """Propagation and the inbox merge after a window, then the
            round's scalars in one host sync: (packets, least kept
            latency, next start, abort word)."""
            n_out, min_lat = propagate(st, window_end)
            ib_t, th_t = next_event_time(st)
            return torch.stack([
                n_out, min_lat, torch.minimum(ib_t, th_t).min(),
                st["abort_code"]]).tolist()

        def run(st, pay, start, stop, limit, runahead, max_rounds):
            prepare(st, pay)
            if span is not None:
                # The whole loop in one launch and one read.
                got = span(st, pay, start, stop, limit, runahead,
                           max_rounds)
                for k in ("fires", "lanes", "calls"):
                    st[f"ks_{k}"] += got[k]
                st["ks_windows"] = got["rounds"]
                st["ks_spans"] = 1
                st["ks_span_ms"] = got["span_ms"]
                return (st, got["start"], got["runahead"], got["rounds"],
                        got["busy_rounds"], got["packets"],
                        got["busy_end"], got["iters"])
            if step is not None:
                step.begin(st, pay)

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
        run.span, run.step = span, step
        return run

    # ------------------------------------------------------------------
    # Dispatch: export -> loop -> import
    # ------------------------------------------------------------------

    def export_state(self):
        """Fresh engine export -> the port's device state, or the
        int/None eligibility verdict passed through from
        span_export_phold."""
        t0 = time.perf_counter_ns()
        d = self.engine.span_export_phold(*self._caps())
        self.export_wall_ns += time.perf_counter_ns() - t0
        if d is None or isinstance(d, int):
            return d
        self.export_bytes += sum(
            len(v) for v in d.values()
            if isinstance(v, (bytes, bytearray, memoryview)))
        st = state_from_numpy(self._to_arrays(d), self.device)
        st.update(self._statics_on_device())
        self._cache_statics(st)
        return st

    def _derive(self, st: dict) -> None:
        """The DERIVED columns, as `_to_arrays` sets them on a fresh
        export: every continuation idle, no drain chain, and the
        park-order counter one past the larger wait seq."""
        z = torch.zeros(self._H, dtype=torch.int64, device=self.device)
        for k in ("cont", "then", "out_first", "cd_chain", "cd_sniff"):
            st[k] = z.clone()
        st["park_ctr"] = torch.maximum(st["m_waitseq"], st["s_waitseq"]) + 1

    def _fn_for(self, st: dict):
        return self._cached_build(st["peers"].shape[1])

    def _fn_args(self, start, stop, limit, runahead, mr) -> tuple:
        return (self._pay, start, stop, limit, runahead, mr)

    def _host_copy(self, st_out: dict):
        """Every codec column and the span's trace, on the host."""
        traces = None
        if self.tracing:
            n = int(st_out["tr_n"])
            traces = {"n": n}
            for k in TR_KEYS:
                traces[k] = st_out[f"tr_{k}"][:n].cpu().numpy().astype(
                    TR_DTYPES[k]).tobytes()
            traces["size"] = np.full(n, self._pay, np.int64).tobytes()
        return state_to_numpy(st_out), traces

    def _engine_import(self, st_np: dict, traces) -> None:
        back = self._from_arrays(st_np)
        self.import_bytes += sum(
            len(v) for v in back.values()
            if isinstance(v, (bytes, bytearray, memoryview)))
        self.engine.span_import_phold(back, *self._caps(), traces)
