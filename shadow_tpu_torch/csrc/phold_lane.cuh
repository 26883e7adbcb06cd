// One PHOLD/udp-mesh host lane stepping a whole conservative window:
// the lane law of stt_phold_window (phold_window.cu), the port of the
// fused micro-iteration of shadow_tpu/ops/phold_span.py (`run`, :1675;
// the fused dispatch :1370-1417) as the eager port runs it
// (ops/phold_span.py micro_iter_fused and the micro-ops it calls).
//
// Within a round the hosts are independent (netplane.cpp run_hosts_mt):
// a lane reads and writes only its own rows.  What the lanes share is
// the outbox and trace appends and the abort word; the round end's inbox
// lexsort and the trace's canonical sort erase the appends' interleave.
// So a lane runs its own loop, one iteration at a time, until it is
// neither busy nor due before the window's end, and needs no barrier.
//
// The lane keeps the fused schedule's per-iteration stage order exactly
// (pop, then C_M_STEP, then C_S_STEP, then two passes of (relay 1,
// relay 2), then stage 2), one CoDel dequeue per relay-2 pass, and never
// runs a chain on greedily.  Its own iteration index is therefore the
// lockstep loop's, and the window's counters follow from the lanes':
// micro-iterations = the lanes' largest count, `ks_lanes` = the sum of
// the lanes' stage counts, and `ks_fires[s]` = the number of iteration
// indices at which some lane ran stage s (a bitmap of indices per stage
// pass, OR-ed by the lanes and counted at the window's end).
//
// The relays' token-bucket law, the CoDel head law and CoDel's control
// law are queue_laws.cuh's `bucket_law`, `codel_head_law` and
// `control_time` (through `codel_ladder`), called in the lane.
//
// Plain C++ apart from the STT_LAW qualifiers and the three shared-word
// macros below (device atomics under __CUDACC__, plain operations in
// the host build), so the tier-1 tests build this header with the system
// C++ compiler and run the lanes serially (`window_serial`).

#pragma once

#include <cstdint>

#include "queue_laws.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
// A slot of a flat append buffer: one atomicAdd per group of converged
// lanes of a warp, each lane taking its rank in the group.
#define STT_CLAIM(ctr) ::stt::phold::claim_warp(ctr)
#define STT_ABORT(word, bit) \
  atomicOr((unsigned long long*)(word), (unsigned long long)(bit))
#define STT_OR32(word, bits) atomicOr((unsigned*)(word), (unsigned)(bits))
#define STT_ABORT_SEEN(word) (*(volatile const int64_t*)(word) != 0)
#else
#define STT_CLAIM(ctr) ((*(ctr))++)
#define STT_ABORT(word, bit) (*(word) |= (bit))
#define STT_OR32(word, bits) (*(word) |= (bits))
#define STT_ABORT_SEEN(word) (*(word) != 0)
#endif

namespace stt {
namespace phold {

#ifdef __CUDACC__
__device__ __forceinline__ int64_t claim_warp(int64_t* ctr) {
  namespace cg = cooperative_groups;
  const cg::coalesced_group g = cg::coalesced_threads();
  unsigned long long base = 0;
  if (g.thread_rank() == 0)
    base = atomicAdd((unsigned long long*)ctr, (unsigned long long)g.size());
  base = g.shfl(base, 0);
  return (int64_t)base + g.thread_rank();
}
#endif

// The loop's constants, each the value of the same name in
// ops/phold_span.py (the wrapper checks them all by name at bind).
#define STT_PHOLD_CONSTS(X)                                               \
  X(C_IDLE, 0) X(C_R1, 1) X(C_R2, 2) X(C_M_STEP, 3) X(C_S_STEP, 4)        \
  X(C_M_RECV, 5) X(C_S_POST, 6)                                           \
  X(TK_RELAY, 0) X(TK_APP, 2) X(TK_APP_TIMEOUT, 3)                        \
  X(S_READABLE, 2) X(S_WRITABLE, 4)                                       \
  X(ASYS_WRITE, 6) X(ASYS_RESOLVE, 7) X(ASYS_SENDTO, 13)                  \
  X(ASYS_RECVFROM, 14) X(ASYS_NANOSLEEP, 15) X(ASYS_N, 16)                \
  X(CODEL_HARD_LIMIT, 1000)                                               \
  X(TR_SND, 0) X(TR_DRP, 1) X(TR_RCV, 2)                                  \
  X(RSN_NONE, 0) X(RSN_CODEL, 1) X(RSN_RTRLIMIT, 2) X(RSN_RCVBUF, 3)      \
  X(RSN_NOSOCK, 4) X(RSN_NOROUTE, 5) X(RSN_HOSTDOWN, 9)                   \
  X(RSN_LINKDOWN, 10)                                                     \
  X(TEL_CODEL, 0) X(TEL_RTR_LIMIT, 1) X(TEL_NO_ROUTE, 4)                  \
  X(TEL_NO_SOCKET, 5) X(TEL_RECVBUF_FULL, 9) X(TEL_HOST_DOWN, 11)         \
  X(TEL_LINK_DOWN, 12) X(TEL_N, 15)                                       \
  X(KS_POP, 0) X(KS_STEP, 1) X(KS_CODEL, 2) X(KS_INET_OUT, 8)             \
  X(KS_ARM, 9) X(KS_TIMERS, 10) X(KS_N, 12)                               \
  X(CALL_BUCKET, 0) X(CALL_CODEL, 1)                                      \
  X(AB_TRACE, 1) X(AB_OUT, 2) X(AB_STRUCT, 4)                             \
  X(I64_MAX, 4611686018427387904)

#define STT_PHOLD_CONST_DEF(name, value) \
  constexpr int64_t name = (int64_t)(value##LL);
STT_PHOLD_CONSTS(STT_PHOLD_CONST_DEF)
#define STT_PHOLD_CONST_NAME(name, value) #name "=" #value " "
constexpr char kConsts[] = STT_PHOLD_CONSTS(STT_PHOLD_CONST_NAME);

constexpr int64_t M32 = 0xFFFFFFFFLL;
constexpr int kPk = 6;  // packet columns: ops/phold_span.py PK_KEYS
enum { PK_SRCHOST, PK_PSEQ, PK_SIP, PK_SPORT, PK_DIP, PK_DPORT };

// The stage passes of one fused iteration, in order; two relay passes
// per iteration.  Each has its bitmap of iteration indices.
enum {
  P_POP, P_TIM, P_MSTEP, P_SSTEP, P_R1A, P_R2A, P_R1B, P_R2B, P_ARM,
  kPasses
};

// The KS_* slot a pass's fires and lanes are credited to.
STT_LAW int pass_slot(int q) {
  switch (q) {
    case P_POP: return KS_POP;
    case P_TIM: return KS_TIMERS;
    case P_MSTEP: case P_SSTEP: return KS_STEP;
    case P_R1A: case P_R1B: return KS_INET_OUT;
    case P_R2A: case P_R2B: return KS_CODEL;
    default: return KS_ARM;
  }
}

// The lockstep loop's runaway valve (ops/phold_span.py run): an
// iteration index past it raises AB_STRUCT.  The bitmaps cover every
// index a lane can reach: the valve's, plus the one after it.
constexpr int64_t kValve = (int64_t)1 << 22;
constexpr int64_t kBitmapWords = (kValve + 2 + 31) / 32;

// The window's statistics words (int64), cumulative over a run's
// windows: stage fires and lanes by KS slot, law calls, iterations; then
// two words each launch leaves at zero (the window's largest lane
// iteration count, and the count of blocks done).  N_PASSES is the
// bitmaps' row count.
#define STT_PHOLD_STATS(X)                                      \
  X(ST_FIRES, 0) X(ST_LANES, 12) X(ST_CALLS, 24) X(ST_ITERS, 26) \
  X(ST_WIN_MAX, 27) X(ST_DONE, 28) X(ST_N, 29) X(N_PASSES, 9)
STT_PHOLD_STATS(STT_PHOLD_CONST_DEF)
constexpr char kStats[] = STT_PHOLD_STATS(STT_PHOLD_CONST_NAME);
static_assert(ST_LANES == ST_FIRES + KS_N && ST_CALLS == ST_LANES + KS_N &&
                  N_PASSES == kPasses,
              "stats layout");

// The per-launch constants, int64 words: X(field).
#define STT_PHOLD_PARAMS(X)                                             \
  X(n)            /* host lanes H */                                    \
  X(cap_i) X(cap_t) X(cap_r) X(cap_s) X(cap_c) /* ring widths */        \
  X(n_peer_cols)  /* P, the peers table's row width */                  \
  X(cap_out)      /* outbox slots O (the trash slot is O) */            \
  X(cap_tr)       /* trace slots TR (the trash slot is TR) */           \
  X(tracing) X(family) /* 0 phold, 1 udp-mesh */                        \
  X(psize) X(pay)  /* packet bytes, payload bytes */                    \
  X(window_end)                                                         \
  X(refill_ns) X(target_ns) X(mtu) X(interval_ns)                       \
  X(bitmap_words)  /* words per pass of the iteration bitmaps */

// The operands: X(type, field, key, dims).  `key` names the span-state
// key the wrapper points the field at, or "win.*", a buffer the wrapper
// owns; a key ending in "_*" stands for one pointer per packet column in
// PK_KEYS order (the field is then an array of kPk).  `dims` is the
// operand's shape in the names n (lanes), I T R S C (ring widths), P,
// asys (ASYS_N), tel (TEL_N), out (O + 1), tr (TR + 1), passes, words,
// stats; "" is a 0-d tensor.  Const fields are only read.  th_valid is
// 1-byte 0/1 (torch.bool), the bitmaps int32, everything else int64.
#define STT_PHOLD_OPERANDS(X)                                           \
  /* read-only in the window */                                         \
  X(const int64_t*, h_fault, "h_fault", "n")                            \
  X(const int64_t*, m_port, "m_port", "n")                              \
  X(const int64_t*, eth_ip, "eth_ip", "n")                              \
  X(const int64_t*, recv_max, "recv_max", "n")                          \
  X(const int64_t*, send_max, "send_max", "n")                          \
  X(const int64_t*, n_peers, "n_peers", "n")                            \
  X(const int64_t*, peers, "peers", "n,P")                              \
  X(const int64_t*, m_mean, "m_mean", "n")                              \
  X(const int64_t*, s_count, "s_count", "n")                            \
  X(const int64_t*, r1_refill, "r1_refill", "n")                        \
  X(const int64_t*, r1_cap, "r1_cap", "n")                              \
  X(const int64_t*, r1_unlimited, "r1_unlimited", "n")                  \
  X(const int64_t*, r2_refill, "r2_refill", "n")                        \
  X(const int64_t*, r2_cap, "r2_cap", "n")                              \
  X(const int64_t*, r2_unlimited, "r2_unlimited", "n")                  \
  X(const int64_t*, ips_sorted, "_ips_sorted", "n")                     \
  X(const int64_t*, ips_perm, "_ips_perm", "n")                         \
  X(const int64_t*, ib_len, "ib_len", "n")                              \
  X(const int64_t*, ib_time, "ib_time", "n,I")                          \
  X(const int64_t*, ib[kPk], "ib_*", "n,I")                             \
  /* hot words: in registers for the window, written back if changed */ \
  X(int64_t*, now, "now", "n")                                          \
  X(int64_t*, cont, "cont", "n")                                        \
  X(int64_t*, then, "then", "n")                                        \
  X(int64_t*, status, "status", "n")                                    \
  X(int64_t*, event_seq, "event_seq", "n")                              \
  X(int64_t*, m_lcg, "m_lcg", "n")                                      \
  X(int64_t*, r1_bal, "r1_bal", "n")                                    \
  X(int64_t*, r1_next, "r1_next", "n")                                  \
  X(int64_t*, r2_bal, "r2_bal", "n")                                    \
  X(int64_t*, r2_next, "r2_next", "n")                                  \
  X(int64_t*, first_above, "codel_first_above", "n")                    \
  X(int64_t*, dropping, "codel_dropping", "n")                          \
  X(int64_t*, chain, "cd_chain", "n")                                   \
  X(int64_t*, sniff, "cd_sniff", "n")                                   \
  X(int64_t*, count, "codel_count", "n")                                \
  X(int64_t*, last_count, "codel_last_count", "n")                      \
  X(int64_t*, drop_next, "codel_drop_next", "n")                        \
  X(int64_t*, ib_pos, "ib_pos", "n")                                    \
  X(int64_t*, rq_pos, "rq_pos", "n")                                    \
  X(int64_t*, rq_len, "rq_len", "n")                                    \
  X(int64_t*, sq_pos, "sq_pos", "n")                                    \
  X(int64_t*, sq_len, "sq_len", "n")                                    \
  X(int64_t*, cq_pos, "cq_pos", "n")                                    \
  X(int64_t*, cq_len, "cq_len", "n")                                    \
  /* cold words: read and written in memory */                          \
  X(int64_t*, events_run, "events_run", "n")                            \
  X(int64_t*, pkts_sent, "app_pkts_sent", "n")                          \
  X(int64_t*, pkts_recv, "app_pkts_recv", "n")                          \
  X(int64_t*, pkts_dropped, "app_pkts_dropped", "n")                    \
  X(int64_t*, drop_causes, "drop_causes", "n,tel")                      \
  X(int64_t*, app_sys, "app_sys", "n,asys")                             \
  X(int64_t*, enq_pkts, "codel_enq_pkts", "n")                          \
  X(int64_t*, enq_bytes, "codel_enq_bytes", "n")                        \
  X(int64_t*, cd_dropped, "codel_dropped", "n")                         \
  X(int64_t*, cd_drop_bytes, "codel_drop_bytes", "n")                   \
  X(int64_t*, codel_peak, "codel_peak", "n")                            \
  X(int64_t*, codel_bytes, "codel_bytes", "n")                          \
  X(int64_t*, r1_pending, "r1_pending", "n")                            \
  X(int64_t*, r2_pending, "r2_pending", "n")                            \
  X(int64_t*, r1_pk_valid, "r1_pk_valid", "n")                          \
  X(int64_t*, r2_pk_valid, "r2_pk_valid", "n")                          \
  X(int64_t*, r1_pk[kPk], "r1_pk_*", "n")                               \
  X(int64_t*, r2_pk[kPk], "r2_pk_*", "n")                               \
  X(int64_t*, r1_stalls, "r1_stalls", "n")                              \
  X(int64_t*, r2_stalls, "r2_stalls", "n")                              \
  X(int64_t*, r1_fwd_pkts, "r1_fwd_pkts", "n")                          \
  X(int64_t*, r1_fwd_bytes, "r1_fwd_bytes", "n")                        \
  X(int64_t*, r2_fwd_pkts, "r2_fwd_pkts", "n")                          \
  X(int64_t*, r2_fwd_bytes, "r2_fwd_bytes", "n")                        \
  X(int64_t*, queued, "queued", "n")                                    \
  X(int64_t*, send_bytes, "send_bytes", "n")                            \
  X(int64_t*, recv_bytes, "recv_bytes", "n")                            \
  X(int64_t*, eth_psent, "eth_psent", "n")                              \
  X(int64_t*, eth_bsent, "eth_bsent", "n")                              \
  X(int64_t*, eth_precv, "eth_precv", "n")                              \
  X(int64_t*, eth_brecv, "eth_brecv", "n")                              \
  X(int64_t*, sock_closed, "sock_closed", "n")                          \
  X(int64_t*, packet_seq, "packet_seq", "n")                            \
  X(int64_t*, park_ctr, "park_ctr", "n")                                \
  X(int64_t*, m_wakep, "m_wakep", "n")                                  \
  X(int64_t*, s_wakep, "s_wakep", "n")                                  \
  X(int64_t*, m_waitmask, "m_waitmask", "n")                            \
  X(int64_t*, s_waitmask, "s_waitmask", "n")                            \
  X(int64_t*, m_waitseq, "m_waitseq", "n")                              \
  X(int64_t*, s_waitseq, "s_waitseq", "n")                              \
  X(int64_t*, m_exited, "m_exited", "n")                                \
  X(int64_t*, s_exited, "s_exited", "n")                                \
  X(int64_t*, m_state, "m_state", "n")                                  \
  X(int64_t*, s_state, "s_state", "n")                                  \
  X(int64_t*, m_target, "m_target", "n")                                \
  X(int64_t*, s_target, "s_target", "n")                                \
  X(int64_t*, s_senti, "s_senti", "n")                                  \
  X(int64_t*, m_gotn, "m_gotn", "n")                                    \
  X(int64_t*, m_partdone, "m_partdone", "n")                            \
  X(int64_t*, s_partdone, "s_partdone", "n")                            \
  X(int64_t*, m_exit_time, "m_exit_time", "n")                          \
  X(int64_t*, s_exit_time, "s_exit_time", "n")                          \
  X(int64_t*, out_first, "out_first", "n")                              \
  X(int64_t*, th_time, "th_time", "n,T")                                \
  X(int64_t*, th_seq, "th_seq", "n,T")                                  \
  X(int64_t*, th_kind, "th_kind", "n,T")                                \
  X(int64_t*, th_tgt, "th_tgt", "n,T")                                  \
  X(uint8_t*, th_valid, "th_valid", "n,T")                              \
  X(int64_t*, rq[kPk], "rq_*", "n,R")                                   \
  X(int64_t*, sq[kPk], "sq_*", "n,S")                                   \
  X(int64_t*, cq[kPk], "cq_*", "n,C")                                   \
  X(int64_t*, cq_enq, "cq_enq", "n,C")                                  \
  /* the span's flat buffers and the abort word */                      \
  X(int64_t*, out_n, "out_n", "")                                       \
  X(int64_t*, out_src, "out_src", "out")                                \
  X(int64_t*, out_dst, "out_dst", "out")                                \
  X(int64_t*, out_seq, "out_seq", "out")                                \
  X(int64_t*, out_t, "out_t", "out")                                    \
  X(int64_t*, out_pk[kPk - 1], "out_pk*", "out") /* pseq .. dport */    \
  X(int64_t*, tr_n, "tr_n", "")     /* the tr_* operands: null when */  \
  X(int64_t*, tr_t, "tr_t", "tr")   /* the span is not traced */        \
  X(int64_t*, tr_kind, "tr_kind", "tr")                                 \
  X(int64_t*, tr_pk[kPk], "tr_*", "tr")                                 \
  X(int64_t*, tr_reason, "tr_reason", "tr")                             \
  X(int64_t*, tr_owner, "tr_owner", "tr")                               \
  X(int64_t*, abort_code, "abort_code", "")                             \
  /* the wrapper's window buffers */                                    \
  X(uint32_t*, bitmap, "win.bitmap", "passes,words")                    \
  X(int64_t*, stats, "win.stats", "stats")

#define STT_PHOLD_PARAM_FIELD(field) int64_t field;
#define STT_PHOLD_PARAM_NAME(field) #field " "
#define STT_PHOLD_OPERAND_FIELD(type, field, key, dims) type field;
#define STT_PHOLD_OPERAND_ENTRY(type, field, key, dims) \
  #type "|" key "|" dims ";"

struct Params {
  STT_PHOLD_PARAMS(STT_PHOLD_PARAM_FIELD)
};
struct Ops {
  STT_PHOLD_OPERANDS(STT_PHOLD_OPERAND_FIELD)
};

constexpr char kParamNames[] = STT_PHOLD_PARAMS(STT_PHOLD_PARAM_NAME);
constexpr char kOperands[] = STT_PHOLD_OPERANDS(STT_PHOLD_OPERAND_ENTRY);

// Pointers the operand string stands for: one per entry; kPk per "_*"
// key and kPk - 1 per "pk*" key (the outbox's packet columns after
// srchost, which is its `src`).
constexpr int operand_pointers(const char* s) {
  int n = 0;
  for (int i = 0; s[i] != 0; i++) {
    if (s[i] == ';') n += 1;
    if (s[i] == '|' && i >= 2 && s[i - 1] == '*' && s[i - 2] == '_')
      n += kPk - 1;
    else if (s[i] == '|' && i >= 2 && s[i - 1] == '*' && s[i - 2] == 'k')
      n += kPk - 2;
  }
  return n;
}
static_assert(sizeof(Params) ==
                  count_char(kParamNames, ' ') * sizeof(int64_t),
              "Params: one int64 word per name");
static_assert(sizeof(Ops) == operand_pointers(kOperands) * sizeof(void*),
              "Ops: one pointer per name");

struct Pk {
  int64_t v[kPk];
};

// One lane's counts over a window: the iterations 0..63 at which it ran
// each pass (later ones go straight to the shared bitmaps), how often it
// ran each pass, its law calls and its iterations.
struct LaneStats {
  uint64_t bits[kPasses];
  uint32_t lanes[kPasses];
  uint32_t calls[2];
  uint32_t iters;
};

// The inbox's time order pick (ops/phold_span.py pick_inbox).
STT_LAW bool pick_inbox(int64_t ib_t, int64_t th_t) {
  return ib_t != th_t ? ib_t < th_t : ib_t < I64_MAX;
}

struct ThMin {
  int64_t t, kind, tgt, slot;
};

// One host lane: `o` and `p` are the window's tables, `i` the lane.
// The hot words live in members for the window; every other column is
// read and written in memory, at the lane's own row.
struct Lane {
  const Ops& o;
  const Params& p;
  const int64_t i;
  LaneStats& s;
  int64_t now, cont, then, status, event_seq, m_lcg;
  int64_t r1_bal, r1_next, r2_bal, r2_next;
  CodelWords cw;
  int64_t ib_len, ib_pos, rq_pos, rq_len, sq_pos, sq_len, cq_pos, cq_len;

  STT_LAW Lane(const Ops& o_, const Params& p_, int64_t i_, LaneStats& s_)
      : o(o_), p(p_), i(i_), s(s_) {
    now = o.now[i];
    cont = o.cont[i];
    then = o.then[i];
    status = o.status[i];
    event_seq = o.event_seq[i];
    m_lcg = o.m_lcg[i];
    r1_bal = o.r1_bal[i];
    r1_next = o.r1_next[i];
    r2_bal = o.r2_bal[i];
    r2_next = o.r2_next[i];
    cw = {o.first_above[i], o.dropping[i], o.chain[i], o.sniff[i],
          o.count[i],       o.last_count[i], o.drop_next[i]};
    ib_len = o.ib_len[i];
    ib_pos = o.ib_pos[i];
    rq_pos = o.rq_pos[i];
    rq_len = o.rq_len[i];
    sq_pos = o.sq_pos[i];
    sq_len = o.sq_len[i];
    cq_pos = o.cq_pos[i];
    cq_len = o.cq_len[i];
  }

  // The hot words back to memory, each only if it changed.
  STT_LAW void store() const {
#define STT_PUT(ptr, v) \
  if ((ptr)[i] != (v)) (ptr)[i] = (v);
    STT_PUT(o.now, now) STT_PUT(o.cont, cont) STT_PUT(o.then, then)
    STT_PUT(o.status, status) STT_PUT(o.event_seq, event_seq)
    STT_PUT(o.m_lcg, m_lcg) STT_PUT(o.r1_bal, r1_bal)
    STT_PUT(o.r1_next, r1_next) STT_PUT(o.r2_bal, r2_bal)
    STT_PUT(o.r2_next, r2_next) STT_PUT(o.first_above, cw.first_above)
    STT_PUT(o.dropping, cw.dropping) STT_PUT(o.chain, cw.chain)
    STT_PUT(o.sniff, cw.sniff) STT_PUT(o.count, cw.count)
    STT_PUT(o.last_count, cw.last_count) STT_PUT(o.drop_next, cw.drop_next)
    STT_PUT(o.ib_pos, ib_pos) STT_PUT(o.rq_pos, rq_pos)
    STT_PUT(o.rq_len, rq_len) STT_PUT(o.sq_pos, sq_pos)
    STT_PUT(o.sq_len, sq_len) STT_PUT(o.cq_pos, cq_pos)
    STT_PUT(o.cq_len, cq_len)
#undef STT_PUT
  }

  STT_LAW void mark(int q, int64_t j) {
    s.lanes[q] += 1;
    if (j < 64)
      s.bits[q] |= (uint64_t)1 << j;
    else
      STT_OR32(o.bitmap + q * p.bitmap_words + (j >> 5), 1u << (j & 31));
  }

  STT_LAW void abort_(int64_t bit) const { STT_ABORT(o.abort_code, bit); }

  // -------- primitive helpers -------------------------------------

  STT_LAW void th_push(int64_t t, int64_t seq, int64_t kind, int64_t tgt) {
    const int64_t row = i * p.cap_t;
    for (int64_t k = 0; k < p.cap_t; k++) {
      if (!o.th_valid[row + k]) {
        o.th_time[row + k] = t;
        o.th_seq[row + k] = seq;
        o.th_kind[row + k] = kind;
        o.th_tgt[row + k] = tgt;
        o.th_valid[row + k] = 1;
        return;
      }
    }
    abort_(AB_STRUCT);  // a full heap writes nothing
  }

  // The earliest timer (time, then seq; the first slot on ties), as
  // th_min's masked argmin picks it, invalid slots reading I64_MAX.
  STT_LAW ThMin th_min() const {
    const int64_t row = i * p.cap_t;
    int64_t best = I64_MAX;
    for (int64_t k = 0; k < p.cap_t; k++) {
      const int64_t t = o.th_valid[row + k] ? o.th_time[row + k] : I64_MAX;
      best = t < best ? t : best;
    }
    int64_t best_seq = I64_MAX, slot = 0;
    for (int64_t k = 0; k < p.cap_t; k++) {
      const int64_t t = o.th_valid[row + k] ? o.th_time[row + k] : I64_MAX;
      const int64_t sv = t == best ? o.th_seq[row + k] : I64_MAX;
      if (sv < best_seq) {
        best_seq = sv;
        slot = k;
      }
    }
    return {best, o.th_kind[row + slot], o.th_tgt[row + slot], slot};
  }

  STT_LAW int64_t draw_seq() { return event_seq++; }

  STT_LAW int64_t lcg_next() {
    m_lcg = (m_lcg * 1664525 + 1013904223) & M32;
    return m_lcg;
  }

  STT_LAW void out_append(int64_t dst, int64_t seq, const Pk& pk) {
    const int64_t k = STT_CLAIM(o.out_n);
    const int64_t slot = k < p.cap_out ? k : p.cap_out;
    o.out_src[slot] = i;
    o.out_dst[slot] = dst;
    o.out_seq[slot] = seq;
    o.out_t[slot] = now;
    for (int c = 1; c < kPk; c++) o.out_pk[c - 1][slot] = pk.v[c];
    if (k + 1 > p.cap_out - p.n) abort_(AB_OUT);
  }

  STT_LAW void trace(int64_t t, int64_t kind, const Pk& pk, int64_t reason) {
    if (!p.tracing) return;
    const int64_t k = STT_CLAIM(o.tr_n);
    const int64_t slot = k < p.cap_tr ? k : p.cap_tr;
    o.tr_t[slot] = t;
    o.tr_kind[slot] = kind;
    for (int c = 0; c < kPk; c++) o.tr_pk[c][slot] = pk.v[c];
    o.tr_reason[slot] = reason;
    o.tr_owner[slot] = i;
    if (k + 1 > p.cap_tr - p.n) abort_(AB_TRACE);
  }

  STT_LAW void drop(int tel) {
    o.pkts_dropped[i] += 1;
    o.drop_causes[i * TEL_N + tel] += 1;
  }

  STT_LAW void sys(int slot, int64_t by = 1) {
    o.app_sys[i * ASYS_N + slot] += by;
  }

  // adjust_status's app_wake fan-out, ordered by wait seq when both
  // threads qualify.
  STT_LAW void wake_check(int64_t changed, int64_t t) {
    const bool m_ok = o.m_wakep[i] == 0 && o.m_exited[i] == 0 &&
                      (changed & o.m_waitmask[i]) != 0;
    const bool s_ok = o.s_wakep[i] == 0 && o.s_exited[i] == 0 &&
                      (changed & o.s_waitmask[i]) != 0;
    if (!m_ok && !s_ok) return;
    const bool both = m_ok && s_ok;
    const bool first_is_s =
        (both && o.s_waitseq[i] < o.m_waitseq[i]) || (s_ok && !m_ok);
    th_push(t, draw_seq(), TK_APP, first_is_s ? 1 : 0);
    (first_is_s ? o.s_wakep : o.m_wakep)[i] = 1;
    if (both) {
      th_push(t, draw_seq(), TK_APP, first_is_s ? 0 : 1);
      (first_is_s ? o.m_wakep : o.s_wakep)[i] = 1;
    }
  }

  STT_LAW void set_status(int64_t set_bits, int64_t clear_bits) {
    const int64_t nw = (status | set_bits) & ~clear_bits;
    const int64_t changed = status ^ nw;
    status = nw;
    wake_check(changed, now);
  }

  // EAGAIN / empty-recv park on `bit`, stamped with the park counter.
  STT_LAW void park(bool seed, int64_t bit) {
    (seed ? o.s_waitmask : o.m_waitmask)[i] = bit;
    (seed ? o.s_waitseq : o.m_waitseq)[i] = o.park_ctr[i];
    o.park_ctr[i] += 1;
  }

  // -------- relay drains ------------------------------------------

  // One CoDel dequeue (codel_pop twin) on a lane without a stashed
  // packet: `pop` when the ring has one, else the empty-queue reset.
  // Returns whether CoDel delivers the popped packet.
  STT_LAW bool codel_pop(bool pop, int64_t enq, const Pk& pk) {
    if (!pop) {
      cw.first_above = cw.dropping = cw.chain = cw.sniff = 0;
      return false;
    }
    cq_pos += 1;
    const int64_t bytes = o.codel_bytes[i] - p.psize;
    o.codel_bytes[i] = bytes;
    const CodelHeadOut h =
        codel_head_law(true, false, now, enq, bytes, cw.first_above,
                       p.target_ns, p.mtu, p.interval_ns);
    s.calls[CALL_CODEL] += 1;
    if (!codel_ladder(cw, h, now)) return true;
    o.cd_dropped[i] += 1;
    o.cd_drop_bytes[i] += p.psize;
    drop(TEL_CODEL);
    trace(now, TR_DRP, pk, RSN_CODEL);
    return false;  // the drain stays: the next pass dequeues again
  }

  // device_push(dev=2): a cross-host send into the outbox.
  STT_LAW void relay1_forward(const Pk& pk) {
    const int64_t dip = pk.v[PK_DIP];
    int64_t lo = 0, hi = p.n;  // searchsorted, left side
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (o.ips_sorted[mid] < dip)
        lo = mid + 1;
      else
        hi = mid;
    }
    const int64_t dslot = lo < p.n - 1 ? lo : p.n - 1;
    o.pkts_sent[i] += 1;
    if (o.h_fault[i] & 2) {  // NIC link down: dies at the egress instant
      drop(TEL_LINK_DOWN);
      trace(now, TR_DRP, pk, RSN_LINKDOWN);
      return;
    }
    if (o.ips_sorted[dslot] != dip) {
      drop(TEL_NO_ROUTE);
      trace(now, TR_DRP, pk, RSN_NOROUTE);
      return;
    }
    out_append(o.ips_perm[dslot], draw_seq(), pk);
  }

  // iface_receive -> udp_push_in.
  STT_LAW void relay2_deliver(const Pk& pk) {
    o.eth_precv[i] += 1;
    o.eth_brecv[i] += p.psize;
    if (pk.v[PK_DPORT] != o.m_port[i] || o.sock_closed[i] == 1) {
      drop(TEL_NO_SOCKET);
      trace(now, TR_DRP, pk, RSN_NOSOCK);
      return;
    }
    if (o.recv_bytes[i] + p.psize > o.recv_max[i]) {
      drop(TEL_RECVBUF_FULL);
      trace(now, TR_DRP, pk, RSN_RCVBUF);
      return;
    }
    if (rq_len - rq_pos >= p.cap_r - 1) abort_(AB_STRUCT);
    const int64_t slot = i * p.cap_r + rq_len % p.cap_r;
    for (int c = 0; c < kPk; c++) o.rq[c][slot] = pk.v[c];
    rq_len += 1;
    o.recv_bytes[i] += p.psize;
    set_status(S_READABLE, 0);
    o.pkts_recv[i] += 1;
    trace(now, TR_RCV, pk, RSN_NONE);
  }

  template <int R>
  STT_LAW void op_relay() {
    int64_t& bal = R == 1 ? r1_bal : r2_bal;
    int64_t& nxt = R == 1 ? r1_next : r2_next;
    int64_t* const pk_valid = R == 1 ? o.r1_pk_valid : o.r2_pk_valid;
    int64_t* const* stash = R == 1 ? o.r1_pk : o.r2_pk;
    const bool use_pend = pk_valid[i] == 1;
    Pk pk;
    bool pop;
    if (use_pend) {
      for (int c = 0; c < kPk; c++) pk.v[c] = stash[c][i];
      pk_valid[i] = 0;
      pop = false;
    } else if (R == 1) {
      pop = o.queued[i] == 1 && sq_len > sq_pos;
      const int64_t slot = i * p.cap_s + sq_pos % p.cap_s;
      for (int c = 0; c < kPk; c++) pk.v[c] = o.sq[c][slot];
      if (pop) {  // iface_pop: dequeue, writable status, SND trace
        sq_pos += 1;
        o.send_bytes[i] -= p.psize;
        o.queued[i] = sq_len > sq_pos;
        if (o.sock_closed[i] == 0) set_status(S_WRITABLE, 0);
        o.eth_psent[i] += 1;
        o.eth_bsent[i] += p.psize;
        trace(now, TR_SND, pk, RSN_NONE);
      }
    } else {
      const int64_t slot = i * p.cap_c + cq_pos % p.cap_c;
      for (int c = 0; c < kPk; c++) pk.v[c] = o.cq[c][slot];
      const bool avail = cq_len > cq_pos;
      pop = codel_pop(avail, avail ? o.cq_enq[slot] : 0, pk);
      if (!avail) {  // nothing queued: the drain is done
        cont = then;
        then = C_IDLE;
        return;
      }
    }
    if (!use_pend && !pop) {
      if (R == 1) {  // nothing queued: the drain is done
        cont = then;
        then = C_IDLE;
      }
      return;  // relay 2: CoDel dropped it, the drain stays
    }
    const BucketOut b =
        bucket_law(bal, nxt, R == 1 ? o.r1_refill[i] : o.r2_refill[i],
                   R == 1 ? o.r1_cap[i] : o.r2_cap[i],
                   (R == 1 ? o.r1_unlimited[i] : o.r2_unlimited[i]) == 1,
                   p.psize, now, p.refill_ns);
    s.calls[CALL_BUCKET] += 1;
    bal = b.bal;
    nxt = b.nxt;
    if (!b.ok) {  // throttled: stash the packet, wake at the refill
      (R == 1 ? o.r1_stalls : o.r2_stalls)[i] += 1;
      (R == 1 ? o.r1_pending : o.r2_pending)[i] = 1;
      pk_valid[i] = 1;
      for (int c = 0; c < kPk; c++) stash[c][i] = pk.v[c];
      th_push(b.nxt, draw_seq(), TK_RELAY, R);
      cont = then;
      then = C_IDLE;
      return;
    }
    (R == 1 ? o.r1_fwd_pkts : o.r2_fwd_pkts)[i] += 1;
    (R == 1 ? o.r1_fwd_bytes : o.r2_fwd_bytes)[i] += p.psize;
    if (R == 1)
      relay1_forward(pk);
    else
      relay2_deliver(pk);
  }

  // -------- app steppers ------------------------------------------

  // One datagram on the send queue; returns whether the inet-out relay
  // must be notified.
  STT_LAW bool sq_push(int64_t dip) {
    const int64_t pseq = o.packet_seq[i];
    o.packet_seq[i] = pseq + 1;
    if (sq_len - sq_pos >= p.cap_s - 1) abort_(AB_STRUCT);
    const int64_t slot = i * p.cap_s + sq_len % p.cap_s;
    const int64_t vals[kPk] = {i, pseq, o.eth_ip[i], o.m_port[i], dip,
                               o.m_port[i]};
    for (int c = 0; c < kPk; c++) o.sq[c][slot] = vals[c];
    sq_len += 1;
    o.send_bytes[i] += p.psize;
    const bool newly = o.queued[i] == 0;
    if (newly) o.queued[i] = 1;
    return newly && o.r1_pending[i] == 0;
  }

  // Two lcg draws, a sleep of 1..(2 * mean) and its timeout timer.
  STT_LAW void arm_sleep(bool seed) {
    sys(ASYS_NANOSLEEP);
    const int64_t r1 = lcg_next();
    const int64_t r2 = lcg_next();
    const int64_t u = r1 % 1000 + r2 % 1000 + 1;
    int64_t d = floor_div_pos(u * o.m_mean[i], 1000);
    d = d < 1 ? 1 : d;
    (seed ? o.s_state : o.m_state)[i] = 1;
    (seed ? o.s_wakep : o.m_wakep)[i] = 1;
    th_push(now + d, draw_seq(), TK_APP_TIMEOUT, seed ? 1 : 0);
  }

  // When both thread parts are done the process exits: the fd closes
  // without a counted syscall, the recv queue dies with it.
  STT_LAW void mesh_try_exit() {
    if (o.m_partdone[i] != 1 || o.s_partdone[i] != 1 ||
        o.sock_closed[i] != 0)
      return;
    o.sock_closed[i] = 1;
    set_status(1 << 3, (1 << 0) | S_READABLE | S_WRITABLE);
    rq_pos = rq_len;
    o.recv_bytes[i] = 0;
    o.m_exited[i] = 1;
    o.m_exit_time[i] = now;
  }

  // One recvfrom on the main thread: park on an empty queue, else
  // dequeue one datagram; returns whether it got one.
  STT_LAW bool recv_one(int64_t got_by) {
    sys(ASYS_RECVFROM);
    if (rq_len <= rq_pos) {
      park(false, S_READABLE);
      cont = C_IDLE;
      return false;
    }
    rq_pos += 1;
    o.recv_bytes[i] -= p.psize;
    if (rq_len <= rq_pos) set_status(0, S_READABLE);
    o.m_gotn[i] += got_by;
    return true;
  }

  // udp-mesh: the sender streams one datagram per step; the main sinks
  // one per step.
  STT_LAW void op_step_mesh(bool seed) {
    if (!seed) {
      if (!recv_one(p.pay)) return;
      if (o.m_gotn[i] < o.s_count[i] * p.pay) {
        cont = C_M_STEP;
        return;
      }
      sys(ASYS_WRITE);  // "mesh received"
      if (o.out_first[i] == 0) o.out_first[i] = 1;
      o.m_partdone[i] = 1;
      o.m_waitmask[i] = 0;
      cont = C_IDLE;
      mesh_try_exit();
      return;
    }
    if (o.s_state[i] == 0) {
      sys(ASYS_RESOLVE, o.n_peers[i]);
      o.s_state[i] = 1;
    }
    const int64_t senti = o.s_senti[i];
    if (senti < o.s_count[i]) {
      sys(ASYS_SENDTO);
      if (o.send_bytes[i] + p.psize > o.send_max[i]) {
        set_status(0, S_WRITABLE);
        park(true, S_WRITABLE);
        cont = C_IDLE;
        return;
      }
      const int64_t np = o.n_peers[i] < 1 ? 1 : o.n_peers[i];
      const bool notify =
          sq_push(o.peers[i * p.n_peer_cols + senti % np]);
      o.s_senti[i] = senti + 1;
      if (notify) {  // keep sending after a relay drain
        cont = C_R1;
        then = C_S_STEP;
      } else {
        cont = C_S_STEP;
      }
      return;
    }
    sys(ASYS_WRITE);  // "mesh sent"
    if (o.out_first[i] == 0) o.out_first[i] = 2;
    o.s_partdone[i] = 1;
    o.s_exited[i] = 1;
    o.s_exit_time[i] = now;
    o.s_waitmask[i] = 0;
    cont = C_IDLE;
    mesh_try_exit();
  }

  // C_M_STEP / C_S_STEP.
  STT_LAW void op_step(bool seed) {
    if (p.family == 1) {
      op_step_mesh(seed);
      return;
    }
    int64_t* const state = seed ? o.s_state : o.m_state;
    if (state[i] == 1) {  // the sleep restarts
      sys(ASYS_NANOSLEEP);
      state[i] = 2;
    }
    const bool has_send = state[i] == 2 || state[i] == 3;
    bool sent = false, parked = false, notify = false;
    if (has_send) {  // one phold_send attempt
      int64_t* const target = seed ? o.s_target : o.m_target;
      if (state[i] != 3) {
        const int64_t rnd = lcg_next();
        const int64_t np = o.n_peers[i] < 1 ? 1 : o.n_peers[i];
        target[i] = o.peers[i * p.n_peer_cols + rnd % np];
        state[i] = 3;
      }
      sys(ASYS_SENDTO);
      if (o.send_bytes[i] + p.psize > o.send_max[i]) {
        set_status(0, S_WRITABLE);
        park(seed, S_WRITABLE);
        parked = true;
      } else {
        notify = sq_push(target[i]);
        state[i] = 0;
        sent = true;
      }
    }
    if (seed && sent) o.s_senti[i] += 1;
    const int64_t nxt = seed ? C_S_POST : C_M_RECV;
    if (notify) {
      cont = C_R1;
      then = nxt;
    } else if (!has_send || sent) {
      cont = nxt;
    } else if (parked) {
      cont = C_IDLE;
    }
  }

  // C_M_RECV / C_S_POST (phold only).
  STT_LAW void op_stage2() {
    if (p.family == 1) return;
    if (cont == C_M_RECV) {
      if (recv_one(1)) {
        arm_sleep(false);
        cont = C_IDLE;
      }
      return;
    }
    if (o.s_senti[i] >= o.s_count[i]) {
      o.s_exited[i] = 1;
      o.s_exit_time[i] = now;
      o.s_waitmask[i] = 0;
    } else {
      arm_sleep(true);
    }
    cont = C_IDLE;
  }

  // -------- event pop ---------------------------------------------

  // The due event at `et` of an idle lane: an arrival (inbox -> CoDel
  // ring -> relay 2) or a timer.
  STT_LAW void op_pop_event(int64_t et, bool pick_ib, int64_t safe,
                            const ThMin& th) {
    now = et;
    o.events_run[i] += 1;
    const int64_t fault = o.h_fault[i];
    const bool h_down = (fault & 1) != 0;
    if (pick_ib) {
      ib_pos += 1;
      Pk pk;
      for (int c = 0; c < kPk; c++) pk.v[c] = o.ib[c][i * p.cap_i + safe];
      if (fault != 0) {  // arrivals at a dead / link-down host die
        drop(h_down ? TEL_HOST_DOWN : TEL_LINK_DOWN);
        trace(et, TR_DRP, pk, h_down ? RSN_HOSTDOWN : RSN_LINKDOWN);
        return;
      }
      o.enq_pkts[i] += 1;
      o.enq_bytes[i] += p.psize;
      if (cq_len - cq_pos >= CODEL_HARD_LIMIT) {
        o.cd_dropped[i] += 1;
        o.cd_drop_bytes[i] += p.psize;
        drop(TEL_RTR_LIMIT);
        trace(et, TR_DRP, pk, RSN_RTRLIMIT);
        return;
      }
      if (cq_len - cq_pos >= p.cap_c - 1) abort_(AB_STRUCT);
      const int64_t slot = i * p.cap_c + cq_len % p.cap_c;
      for (int c = 0; c < kPk; c++) o.cq[c][slot] = pk.v[c];
      o.cq_enq[slot] = et;
      cq_len += 1;
      if (cq_len - cq_pos > o.codel_peak[i]) o.codel_peak[i] = cq_len - cq_pos;
      o.codel_bytes[i] += p.psize;
      if (o.r2_pending[i] == 0) {
        cont = C_R2;
        then = C_IDLE;
      }
      return;
    }
    o.th_valid[i * p.cap_t + th.slot] = 0;
    if (h_down) return;  // a dead host's timers discard
    if (th.kind == TK_RELAY) {
      if (th.tgt == 1 || th.tgt == 2) {  // relay._wakeup
        (th.tgt == 1 ? o.r1_pending : o.r2_pending)[i] = 0;
        cont = th.tgt == 1 ? C_R1 : C_R2;
        then = C_IDLE;
      }
    } else if (th.kind == TK_APP_TIMEOUT) {
      const int64_t seq = draw_seq();
      if (th.tgt == 0 || th.tgt == 1) th_push(et, seq, TK_APP, th.tgt);
    } else if (th.kind == TK_APP && (th.tgt == 0 || th.tgt == 1)) {
      const bool seed = th.tgt == 1;
      (seed ? o.s_wakep : o.m_wakep)[i] = 0;
      (seed ? o.s_waitmask : o.m_waitmask)[i] = 0;
      if ((seed ? o.s_exited : o.m_exited)[i] == 0)
        cont = seed ? C_S_STEP : C_M_STEP;
    }
  }

  // -------- the window --------------------------------------------

  // The lane's fused iterations until it is neither busy nor due before
  // the window's end, or an abort is seen; then its hot words go back.
  STT_LAW void run() {
    for (int64_t j = 0; !STT_ABORT_SEEN(o.abort_code); j++) {
      if (cont == C_IDLE) {  // a busy lane does not pop
        const int64_t safe = ib_pos < p.cap_i - 1 ? ib_pos : p.cap_i - 1;
        const int64_t ib_t =
            ib_len > ib_pos ? o.ib_time[i * p.cap_i + safe] : I64_MAX;
        const ThMin th = th_min();
        const int64_t et = ib_t < th.t ? ib_t : th.t;
        if (et >= p.window_end) break;  // neither busy nor due
        const bool pick_ib = pick_inbox(ib_t, th.t);
        mark(P_POP, j);
        if (!pick_ib) mark(P_TIM, j);
        op_pop_event(et, pick_ib, safe, th);
      }
      if (cont == C_M_STEP) {
        mark(P_MSTEP, j);
        op_step(false);
      }
      if (cont == C_S_STEP) {
        mark(P_SSTEP, j);
        op_step(true);
      }
      // Two relay passes: the second lets a drain that just emptied its
      // source take the exhausted-exit in the same iteration.
      for (int k = 0; k < 2; k++) {
        if (cont == C_R1) {
          mark(k ? P_R1B : P_R1A, j);
          op_relay<1>();
        }
        if (cont == C_R2) {
          mark(k ? P_R2B : P_R2A, j);
          op_relay<2>();
        }
      }
      if (cont == C_M_RECV || cont == C_S_POST) {
        mark(P_ARM, j);
        op_stage2();
      }
      s.iters = (uint32_t)(j + 1);
      if (j > kValve) abort_(AB_STRUCT);  // a continuation cycle
    }
    store();
  }
};

#ifndef __CUDACC__
// The host build: every lane in turn, then the window's counts, as the
// kernel's last block settles them.
inline void window_serial(const Ops& o, const Params& p) {
  int64_t win_max = 0;
  for (int64_t i = 0; i < p.n; i++) {
    LaneStats s = {};
    Lane(o, p, i, s).run();
    for (int q = 0; q < kPasses; q++) {
      o.bitmap[q * p.bitmap_words] |= (uint32_t)s.bits[q];
      o.bitmap[q * p.bitmap_words + 1] |= (uint32_t)(s.bits[q] >> 32);
      o.stats[ST_LANES + pass_slot(q)] += s.lanes[q];
    }
    o.stats[ST_CALLS + CALL_BUCKET] += s.calls[CALL_BUCKET];
    o.stats[ST_CALLS + CALL_CODEL] += s.calls[CALL_CODEL];
    win_max = s.iters > win_max ? s.iters : win_max;
  }
  const int64_t words = (win_max + 31) / 32;
  for (int q = 0; q < kPasses; q++) {
    for (int64_t w = 0; w < words; w++) {
      o.stats[ST_FIRES + pass_slot(q)] +=
          __builtin_popcount(o.bitmap[q * p.bitmap_words + w]);
      o.bitmap[q * p.bitmap_words + w] = 0;
    }
  }
  o.stats[ST_ITERS] += win_max;
}
#endif

}  // namespace phold
}  // namespace stt
