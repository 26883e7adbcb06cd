// One TCP steady-stream host lane stepping a whole conservative window:
// the lane law of stt_tcp_window (tcp_window.cu), the port of the fused
// micro-iteration of shadow_tpu/ops/tcp_span.py (`micro_iter` :2053,
// stage order :2078-2096, under `micro_cond` :2133, inside `run` :2373)
// as the eager port runs it (ops/tcp_span.py micro_iter / micro_busy and
// the micro-ops they call).
//
// Lane independence.  Within a round the hosts are independent
// (netplane.cpp run_hosts_mt), and op by op the eager loop writes only
// the lane's own rows: host-major columns at row i; conn-major columns
// at the lane's current conn (`cur`, set only from the lane's own timer
// targets and from the conn lookup, whose key carries the host) or at
// the conn the qdisc pick chose among the host's own rows; the timer
// heap, rings and counters at row i.  The lanes share only the outbox
// and trace appends and the abort words: the round end's per-row inbox
// re-sort by (time, src, seq) (with (src, seq) unique by draw_seq) and
// the engine's canonical trace sort erase the appends' interleave.  So a
// lane runs its own loop, one iteration at a time, until it is neither
// busy nor due before the window's end.
//
// The lane keeps the fused schedule's per-iteration stage order exactly
// (pop, tmr, app, relay 2, tcpin, drain x2, ackdata, push, flush,
// relay 1 x2, arm) and never runs a chain on greedily.  Its iteration
// index is therefore the lockstep loop's, and the window's counters
// follow from the lanes': micro-iterations = the lanes' largest count,
// `ks_lanes` = the sum of the lanes' stage counts, and `ks_fires[s]` =
// the number of iteration indices at which some lane ran stage s (a
// bitmap of indices per stage pass, OR-ed by the lanes and counted at
// the window's end).
//
// Aborts.  The eager loop runs every lane through the first iteration
// j* at which any lane marks an abort, and stops; its abort bits are the
// bits marked in iteration j*, its abort site the site of the first
// site-bearing mark in j* in execution order (stage pass, then the mark's
// place in the pass).  Here each mark lowers four iteration words (any
// abort; per bit) and a site key (iteration, pass, place, site) with an
// atomic minimum, and a lane stops once its iteration passes the least
// aborting iteration seen so far, so every lane runs every iteration up
// to j*.  The window's end settles abort_code with the bits whose least
// iteration is j*, and abort_site with the key's site where its
// iteration is j*: the eager loop's bits and site, whatever order the
// lanes run in, for every abort a lane marks itself.  The outbox and
// trace capacity marks (AB_OUT / AB_TRACE, no site) are the exception:
// the claim that passes the capacity may come from any iteration, so
// their iteration can be later than the eager loop's.  A span that
// aborts is discarded either way.
//
// The relay tails are queue_laws.cuh's relay1_core / relay2_core (the
// token-bucket, CoDel-head and control laws), called in the lane.
//
// The lane's row scans are a team's (see "the team" below): the law
// runs on rank 0 and asks the tile for each scan, whose answer is the
// one the lane's own loop over the row gave.
//
// Plain C++ apart from the STT_LAW qualifiers and the shared-word
// macros below (device atomics and warp primitives under __CUDACC__,
// plain operations and ranks run in turn in the host build), so the
// tier-1 tests build this header with the system C++ compiler and run
// the lanes serially (`window_serial`, with a team of any size).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "queue_laws.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
// A slot of a flat append buffer: one atomicAdd per group of converged
// lanes of a warp, each lane taking its rank in the group.
#define STT_CLAIM(ctr) ::stt::tcp::claim_warp(ctr)
// The atomic minimum of an abort word (every key is >= 0).
#define STT_ABORT(word, key) \
  atomicMin((unsigned long long*)(word), (unsigned long long)(key))
#define STT_OR32(word, bits) atomicOr((unsigned*)(word), (unsigned)(bits))
// The least aborting iteration seen so far.
#define STT_ABORT_SEEN(word) (*(volatile const int64_t*)(word))
#define STT_CTZ64(v) (__ffsll((long long)(v)) - 1)
// A word other threads wrote with atomics, read past the L1.
#define STT_LOAD(ptr) (*(volatile const int64_t*)(ptr))
#define STT_HD __host__ __device__
#else
#define STT_CLAIM(ctr) ((*(ctr))++)
#define STT_ABORT(word, key) \
  (*(word) = (key) < *(word) ? (key) : *(word))
#define STT_OR32(word, bits) (*(word) |= (bits))
#define STT_ABORT_SEEN(word) (*(word))
#define STT_CTZ64(v) __builtin_ctzll(v)
#define STT_LOAD(ptr) (*(ptr))
#define STT_HD
#endif

namespace stt {
namespace tcp {

// The profiling build (-DSTT_TCP_PROFILE, its own library; the main
// kernel carries no timers): each lane accumulates clock64() cycles by
// stage pass (and the idle test that precedes the pop) and by row-scan
// helper, the helpers' calls and the entries its scans visited, and the
// law's word accesses by class (W_HOST host words and W_CONN conn words,
// all of them device-memory trips before the frame; W_CONN_DEV the conn
// words still read or written in device memory; W_ROW the row words the
// law itself moves, outside the tile's scans), into its row of a buffer
// of PF_N words a lane.
#define STT_TCP_PROFILE_WORDS(X)                                        \
  X(PF_CYCLES, 0) X(PF_ITERS, 1) X(PF_START_NS, 2) X(PF_END_NS, 3)      \
  X(PF_SM, 4) X(PF_PASS, 5) X(PF_HELPER, 19) X(PF_CALLS, 27)            \
  X(PF_VISIT, 35) X(PF_WORDS, 38) X(PF_N, 42) X(P_TEST, 13)            \
  X(H_TH_MIN, 0) X(H_FIRST_FREE, 1) X(H_RA_FIND, 2) X(H_SACK, 3)        \
  X(H_RTX, 4) X(H_QDISC, 5) X(H_HOLES, 6) X(H_SEARCH, 7) X(V_HEAP, 0)   \
  X(V_RA, 1) X(V_RTX, 2) X(W_HOST, 0) X(W_CONN, 1) X(W_CONN_DEV, 2)     \
  X(W_ROW, 3) X(W_N, 4)

#if defined(STT_TCP_PROFILE) && defined(__CUDACC__)
__device__ __forceinline__ int64_t pf_clock() { return clock64(); }
#define STT_PF_BEGIN(name) const int64_t pf_##name = ::stt::tcp::pf_clock()
#define STT_PF_END(name, word)                                     \
  do {                                                             \
    if (prof_) prof_[word] += ::stt::tcp::pf_clock() - pf_##name;  \
  } while (0)
#define STT_PF_HELPER(name, h)                     \
  do {                                             \
    STT_PF_END(name, PF_HELPER + (h));             \
    if (prof_) prof_[PF_CALLS + (h)] += 1;         \
  } while (0)
#define STT_PF_VISIT(v, n) \
  do {                     \
    if (prof_) prof_[PF_VISIT + (v)] += (n); \
  } while (0)
#else
#define STT_PF_BEGIN(name) \
  do {                     \
  } while (0)
#define STT_PF_END(name, word) \
  do {                         \
  } while (0)
#define STT_PF_HELPER(name, h) \
  do {                         \
  } while (0)
#define STT_PF_VISIT(v, n) \
  do {                     \
  } while (0)
#endif

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
// ops/tcp_span.py (the wrapper checks them all by name at bind).
#define STT_TCP_CONSTS(X)                                                   \
  X(C_IDLE, 0) X(C_R1, 1) X(C_R2, 2) X(C_TCPIN, 3) X(C_DRAIN, 4)            \
  X(C_ACKDATA, 5) X(C_PUSH, 6) X(C_FLUSH, 7) X(C_ARM, 8) X(C_APP, 9)        \
  X(C_TMR, 10)                                                              \
  X(TK_RELAY, 0) X(TK_TCP, 1) X(TK_APP, 2)                                  \
  X(S_READABLE, 2) X(S_WRITABLE, 4)                                         \
  X(ASYS_SEND, 3) X(ASYS_RECV, 4) X(ASYS_N, 16)                             \
  X(F_FIN, 1) X(F_SYN, 2) X(F_RST, 4) X(F_PSH, 8) X(F_ACK, 16)              \
  X(F_ECE, 64) X(F_CWR, 128) X(MSS, 1460)                                   \
  X(ECN_ECT0, 2) X(ECN_CE, 3) X(DCTCP_SHIFT, 10) X(DCTCP_G_SHIFT, 4)        \
  X(DCTCP_MAX_ALPHA, 1024) X(CC_DCTCP, 1)                                   \
  X(MARK_THRESH_PKTS, 0) X(MARK_THRESH_BYTES, 1) X(MARK_N, 2)               \
  X(MAX_WINDOW, 65535) X(TCP_TOTAL_HDR, 40)                                 \
  X(MIN_RTO_NS, 200000000) X(MAX_RTO_NS, 60000000000)                       \
  X(DELACK_NS, 40000000) X(RMEM_MAX, 6291456)                               \
  X(CODEL_HARD_LIMIT, 1000)                                                 \
  X(TR_SND, 0) X(TR_DRP, 1) X(TR_RCV, 2)                                    \
  X(RSN_CODEL, 1) X(RSN_RTRLIMIT, 2) X(RSN_HOSTDOWN, 9) X(RSN_LINKDOWN, 10) \
  X(TEL_CODEL, 0) X(TEL_RTR_LIMIT, 1) X(TEL_HOST_DOWN, 11)                  \
  X(TEL_LINK_DOWN, 12) X(TEL_REASM_FULL, 13) X(TEL_RECVWIN_TRUNC, 14)       \
  X(TEL_N, 15)                                                              \
  X(KS_POP, 0) X(KS_STEP, 1) X(KS_CODEL, 2) X(KS_ON_PACKET, 3)              \
  X(KS_REASM, 4) X(KS_ACK, 5) X(KS_PUSH, 6) X(KS_FLUSH, 7)                  \
  X(KS_INET_OUT, 8) X(KS_ARM, 9) X(KS_TIMERS, 10) X(KS_N, 12)               \
  X(AB_TRACE, 1) X(AB_OUT, 2) X(AB_STRUCT, 4)                               \
  X(I64_MAX, 4611686018427387904)

#define STT_TCP_CONST_DEF(name, value) \
  constexpr int64_t name = (int64_t)(value##LL);
STT_TCP_CONSTS(STT_TCP_CONST_DEF)
#define STT_TCP_CONST_NAME(name, value) #name "=" #value " "
constexpr char kConsts[] = STT_TCP_CONSTS(STT_TCP_CONST_NAME);

constexpr int64_t M32 = 0xFFFFFFFFLL;
constexpr int64_t SEQ_HALF = (int64_t)1 << 31;
constexpr int64_t SEQ_MOD = (int64_t)1 << 32;
// The packet columns (ops/tcp_span.py PK_KEYS); the trace's are the
// routing identity (ROUTE_KEYS) and plen.
enum {
  PK_SRCHOST, PK_PSEQ, PK_SIP, PK_SPORT, PK_DIP, PK_DPORT, PK_TSEQ, PK_TACK,
  PK_TFLAGS, PK_TWIN, PK_TSV, PK_TSE, PK_PLEN, PK_NSK, PK_SK0S, PK_SK0E,
  PK_SK1S, PK_SK1E, PK_SK2S, PK_SK2E, PK_ECN, kPkTcp
};
constexpr int kRoute = 6;
static_assert(kPkTcp == kPk && PK_PLEN == kPlenCol, "packet columns");

// The stage passes of one fused iteration, in order; two drain and two
// relay-1 passes per iteration.  Each has its bitmap of iteration
// indices.  P_END is the iteration's end (the runaway valve's mark).
enum {
  P_POP, P_TMR, P_APP, P_R2, P_TCPIN, P_DRAIN_A, P_DRAIN_B, P_ACK, P_PUSH,
  P_FLUSH, P_R1A, P_R1B, P_ARM, kPasses, P_END = kPasses
};

// The KS_* slot a pass's fires and lanes are credited to.
STT_LAW int pass_slot(int q) {
  switch (q) {
    case P_POP: return KS_POP;
    case P_TMR: return KS_TIMERS;
    case P_APP: return KS_STEP;
    case P_R2: return KS_CODEL;
    case P_TCPIN: return KS_ON_PACKET;
    case P_DRAIN_A: case P_DRAIN_B: return KS_REASM;
    case P_ACK: return KS_ACK;
    case P_PUSH: return KS_PUSH;
    case P_FLUSH: return KS_FLUSH;
    case P_R1A: case P_R1B: return KS_INET_OUT;
    default: return KS_ARM;
  }
}

// The lockstep loop's runaway valve (ops/tcp_span.py micro_iter): an
// iteration index past it marks AB_STRUCT at site 13.  The bitmaps cover
// every index a lane can reach: the valve's, plus the one after it.
constexpr int64_t kValve = (int64_t)1 << 17;
constexpr int64_t kBitmapWords = (kValve + 2 + 31) / 32;

// The window's statistics words (int64), cumulative over a run's
// windows: stage fires and lanes by KS slot, law calls (bucket, CoDel
// head), iterations; then words each launch leaves as it found them:
// the window's largest lane iteration count and the count of blocks done
// (0), the least aborting iteration, the least iteration of each abort
// bit (AB_TRACE, AB_OUT, AB_STRUCT) and the least site key (I64_MAX
// each), the two lane queues the tiles take their lanes from (0).
// N_PASSES is the bitmaps' row count.
#define STT_TCP_STATS(X)                                                 \
  X(ST_FIRES, 0) X(ST_LANES, 12) X(ST_CALLS, 24) X(ST_ITERS, 26)         \
  X(ST_WIN_MAX, 27) X(ST_DONE, 28) X(ST_AB_ITER, 29) X(ST_AB_BITS, 30)   \
  X(ST_AB_SITE, 33) X(ST_QUEUE, 34) X(ST_N, 36) X(N_PASSES, 13)          \
  X(CALL_BUCKET, 0) X(CALL_CODEL, 1)
STT_TCP_STATS(STT_TCP_CONST_DEF)
constexpr char kStats[] = STT_TCP_STATS(STT_TCP_CONST_NAME);
STT_TCP_PROFILE_WORDS(STT_TCP_CONST_DEF)
constexpr char kProfileWords[] = STT_TCP_PROFILE_WORDS(STT_TCP_CONST_NAME);
static_assert(ST_LANES == ST_FIRES + KS_N && ST_CALLS == ST_LANES + KS_N &&
                  ST_AB_SITE == ST_AB_BITS + 3 && ST_N == ST_QUEUE + 2 &&
                  N_PASSES == kPasses,
              "stats layout");

// The per-launch constants, int64 words: X(field).
#define STT_TCP_PARAMS(X)                                               \
  X(n)            /* host lanes H */                                    \
  X(conns)        /* conn capacity CC (the trash row is CC) */          \
  X(cap_i) X(cap_t) X(cap_cq) X(cap_rt) X(cap_ra) X(cap_op)             \
  X(cap_out)      /* outbox slots O (the trash slot is O) */            \
  X(cap_tr)       /* trace slots TR (the trash slot is TR) */           \
  X(tracing)                                                            \
  X(k_pkts) X(k_bytes) /* the DCTCP-K marking thresholds */             \
  X(window_end)                                                         \
  X(refill_ns) X(target_ns) X(mtu) X(interval_ns)                       \
  X(th_cache)     /* 1: keep the timer heap's minimum between pops */   \
  X(bitmap_words) /* words per pass of the iteration bitmaps */

// The operands: X(type, field, key, dims).  `key` names the span-state
// key the wrapper points the field at, or "win.*", a buffer the wrapper
// owns; a key ending in "_*" stands for one pointer per packet column in
// PK_KEYS order (the field is then an array of kPk), one ending in "_@"
// for one per trace packet column (ROUTE_KEYS, then plen).  `dims` is
// the operand's shape in the names n (lanes), n+1, cc (CC), cc+1 (CC
// plus the trash row), I T CQ RT RA OP (ring widths), asys, tel, mark,
// out (O + 1), tr (TR + 1), passes, words, stats; "" is a 0-d tensor.
// Const fields are only read.  th_valid and ra_valid are 1-byte 0/1
// (torch.bool), the bitmaps int32, everything else int64.
#define STT_TCP_OPERANDS(X)                                             \
  /* read-only in the window */                                         \
  X(const int64_t*, h_fault, "h_fault", "n")                            \
  X(const int64_t*, eth_ip, "eth_ip", "n")                              \
  X(const int64_t*, bw_down, "bw_down", "n")                            \
  X(const int64_t*, r1_refill, "r1_refill", "n")                        \
  X(const int64_t*, r1_cap, "r1_cap", "n")                              \
  X(const int64_t*, r1_unlimited, "r1_unlimited", "n")                  \
  X(const int64_t*, r2_refill, "r2_refill", "n")                        \
  X(const int64_t*, r2_cap, "r2_cap", "n")                              \
  X(const int64_t*, r2_unlimited, "r2_unlimited", "n")                  \
  X(const int64_t*, ips_sorted, "_ips_sorted", "n")                     \
  X(const int64_t*, ips_perm, "_ips_perm", "n")                         \
  X(const int64_t*, ckeys, "_ckeys", "cc")                              \
  X(const int64_t*, ckperm, "_ckperm", "cc")                            \
  X(const int64_t*, conn_off, "_conn_off", "n+1")                       \
  X(const int64_t*, conn_rows, "_conn_rows", "cc")                      \
  X(const int64_t*, ib_len, "ib_len", "n")                              \
  X(const int64_t*, ib_time, "ib_time", "n,I")                          \
  X(const int64_t*, ib[kPk], "ib_*", "n,I")                             \
  X(const int64_t*, c_role, "c_role", "cc+1")                           \
  X(const int64_t*, c_lip, "c_lip", "cc+1")                             \
  X(const int64_t*, c_lport, "c_lport", "cc+1")                         \
  X(const int64_t*, c_pip, "c_pip", "cc+1")                             \
  X(const int64_t*, c_pport, "c_pport", "cc+1")                         \
  X(const int64_t*, c_ourws, "c_ourws", "cc+1")                         \
  X(const int64_t*, c_peerws, "c_peerws", "cc+1")                       \
  X(const int64_t*, c_effmss, "c_effmss", "cc+1")                       \
  X(const int64_t*, c_nodelay, "c_nodelay", "cc+1")                     \
  X(const int64_t*, c_congmss, "c_congmss", "cc+1")                     \
  X(const int64_t*, c_rat, "c_rat", "cc+1")                             \
  X(const int64_t*, c_atotal, "c_atotal", "cc+1")                       \
  X(const int64_t*, c_ecnact, "c_ecnact", "cc+1")                       \
  X(const int64_t*, c_cc, "c_cc", "cc+1")                               \
  /* hot words: in registers for the window, written back if changed */ \
  X(int64_t*, now, "now", "n")                                          \
  X(int64_t*, cont, "cont", "n")                                        \
  X(int64_t*, then, "then", "n")                                        \
  X(int64_t*, ret, "ret", "n")                                          \
  X(int64_t*, cur, "cur", "n")                                          \
  X(int64_t*, event_seq, "event_seq", "n")                              \
  X(int64_t*, packet_seq, "packet_seq", "n")                            \
  X(int64_t*, ib_pos, "ib_pos", "n")                                    \
  X(int64_t*, cq_pos, "cq_pos", "n")                                    \
  X(int64_t*, cq_len, "cq_len", "n")                                    \
  /* cold host words: read and written in memory */                     \
  X(int64_t*, eflag, "eflag", "n")                                      \
  X(int64_t*, parkp, "parkp", "n")                                      \
  X(int64_t*, had_holes, "had_holes", "n")                              \
  X(int64_t*, park_ctr, "park_ctr", "n")                                \
  X(int64_t*, events_run, "events_run", "n")                            \
  X(int64_t*, pkts_sent, "pkts_sent", "n")                              \
  X(int64_t*, pkts_recv, "pkts_recv", "n")                              \
  X(int64_t*, pkts_dropped, "pkts_dropped", "n")                        \
  X(int64_t*, eth_psent, "eth_psent", "n")                              \
  X(int64_t*, eth_bsent, "eth_bsent", "n")                              \
  X(int64_t*, eth_precv, "eth_precv", "n")                              \
  X(int64_t*, eth_brecv, "eth_brecv", "n")                              \
  X(int64_t*, drop_causes, "drop_causes", "n,tel")                      \
  X(int64_t*, mark_causes, "mark_causes", "n,mark")                     \
  X(int64_t*, app_sys, "app_sys", "n,asys")                             \
  X(int64_t*, codel_bytes, "codel_bytes", "n")                          \
  X(int64_t*, first_above, "codel_first_above", "n")                    \
  X(int64_t*, dropping, "codel_dropping", "n")                          \
  X(int64_t*, chain, "cd_chain", "n")                                   \
  X(int64_t*, sniff, "cd_sniff", "n")                                   \
  X(int64_t*, count, "codel_count", "n")                                \
  X(int64_t*, last_count, "codel_last_count", "n")                      \
  X(int64_t*, drop_next, "codel_drop_next", "n")                        \
  X(int64_t*, cd_dropped, "codel_dropped", "n")                         \
  X(int64_t*, cd_drop_bytes, "codel_drop_bytes", "n")                   \
  X(int64_t*, enq_pkts, "codel_enq_pkts", "n")                          \
  X(int64_t*, enq_bytes, "codel_enq_bytes", "n")                        \
  X(int64_t*, codel_peak, "codel_peak", "n")                            \
  X(int64_t*, codel_marked, "codel_marked", "n")                        \
  X(int64_t*, r1_bal, "r1_bal", "n")                                    \
  X(int64_t*, r1_next, "r1_next", "n")                                  \
  X(int64_t*, r1_stalls, "r1_stalls", "n")                              \
  X(int64_t*, r1_pending, "r1_pending", "n")                            \
  X(int64_t*, r1_pk_valid, "r1_pk_valid", "n")                          \
  X(int64_t*, r1_fwd_pkts, "r1_fwd_pkts", "n")                          \
  X(int64_t*, r1_fwd_bytes, "r1_fwd_bytes", "n")                        \
  X(int64_t*, r1_pk[kPk], "r1_pk_*", "n")                               \
  X(int64_t*, r2_bal, "r2_bal", "n")                                    \
  X(int64_t*, r2_next, "r2_next", "n")                                  \
  X(int64_t*, r2_stalls, "r2_stalls", "n")                              \
  X(int64_t*, r2_pending, "r2_pending", "n")                            \
  X(int64_t*, r2_pk_valid, "r2_pk_valid", "n")                          \
  X(int64_t*, r2_fwd_pkts, "r2_fwd_pkts", "n")                          \
  X(int64_t*, r2_fwd_bytes, "r2_fwd_bytes", "n")                        \
  X(int64_t*, r2_pk[kPk], "r2_pk_*", "n")                               \
  X(int64_t*, ar[kPk], "ar_*", "n") /* the packet C_TCPIN processes */  \
  X(int64_t*, cq[kPk], "cq_*", "n,CQ")                                  \
  X(int64_t*, cq_enq, "cq_enq", "n,CQ")                                 \
  X(int64_t*, th_time, "th_time", "n,T")                                \
  X(int64_t*, th_seq, "th_seq", "n,T")                                  \
  X(int64_t*, th_kind, "th_kind", "n,T")                                \
  X(int64_t*, th_tgt, "th_tgt", "n,T")                                  \
  X(uint8_t*, th_valid, "th_valid", "n,T")                              \
  /* conn-major words, at the lane's own conn rows */                   \
  X(int64_t*, c_queued, "c_queued", "cc+1")                             \
  X(int64_t*, c_snduna, "c_snduna", "cc+1")                             \
  X(int64_t*, c_sndnxt, "c_sndnxt", "cc+1")                             \
  X(int64_t*, c_rcvnxt, "c_rcvnxt", "cc+1")                             \
  X(int64_t*, c_recover, "c_recover", "cc+1")                           \
  X(int64_t*, c_status, "c_status", "cc+1")                             \
  X(int64_t*, c_await, "c_await", "cc+1")                               \
  X(int64_t*, c_awaitseq, "c_awaitseq", "cc+1")                         \
  X(int64_t*, c_wakep, "c_wakep", "cc+1")                               \
  X(int64_t*, c_sndwnd, "c_sndwnd", "cc+1")                             \
  X(int64_t*, c_sblen, "c_sblen", "cc+1")                               \
  X(int64_t*, c_sbmax, "c_sbmax", "cc+1")                               \
  X(int64_t*, c_rblen, "c_rblen", "cc+1")                               \
  X(int64_t*, c_rbmax, "c_rbmax", "cc+1")                               \
  X(int64_t*, c_delackdl, "c_delackdl", "cc+1")                         \
  X(int64_t*, c_persistdl, "c_persistdl", "cc+1")                       \
  X(int64_t*, c_persistiv, "c_persistiv", "cc+1")                       \
  X(int64_t*, c_cwnd, "c_cwnd", "cc+1")                                 \
  X(int64_t*, c_ssthresh, "c_ssthresh", "cc+1")                         \
  X(int64_t*, c_srtt, "c_srtt", "cc+1")                                 \
  X(int64_t*, c_rttvar, "c_rttvar", "cc+1")                             \
  X(int64_t*, c_rto, "c_rto", "cc+1")                                   \
  X(int64_t*, c_rtodl, "c_rtodl", "cc+1")                               \
  X(int64_t*, c_tmrdl, "c_tmrdl", "cc+1")                               \
  X(int64_t*, c_tsrecent, "c_tsrecent", "cc+1")                         \
  X(int64_t*, c_segssent, "c_segssent", "cc+1")                         \
  X(int64_t*, c_segsrecv, "c_segsrecv", "cc+1")                         \
  X(int64_t*, c_rtxcount, "c_rtxcount", "cc+1")                         \
  X(int64_t*, c_sackskip, "c_sackskip", "cc+1")                         \
  X(int64_t*, c_dupacks, "c_dupacks", "cc+1")                           \
  X(int64_t*, c_rtobackoff, "c_rtobackoff", "cc+1")                     \
  X(int64_t*, c_fastrec, "c_fastrec", "cc+1")                           \
  X(int64_t*, c_ssa, "c_ssa", "cc+1")                                   \
  X(int64_t*, c_atcopied, "c_atcopied", "cc+1")                         \
  X(int64_t*, c_atspace, "c_atspace", "cc+1")                           \
  X(int64_t*, c_atlast, "c_atlast", "cc+1")                             \
  X(int64_t*, c_agot, "c_agot", "cc+1")                                 \
  X(int64_t*, c_fbyte, "c_fbyte", "cc+1")                               \
  X(int64_t*, c_lbyte, "c_lbyte", "cc+1")                               \
  X(int64_t*, c_bin, "c_bin", "cc+1")                                   \
  X(int64_t*, c_bout, "c_bout", "cc+1")                                 \
  X(int64_t*, c_ece, "c_ece", "cc+1")                                   \
  X(int64_t*, c_cwrp, "c_cwrp", "cc+1")                                 \
  X(int64_t*, c_cwrend, "c_cwrend", "cc+1")                             \
  X(int64_t*, c_alpha, "c_alpha", "cc+1")                               \
  X(int64_t*, c_ceack, "c_ceack", "cc+1")                               \
  X(int64_t*, c_totack, "c_totack", "cc+1")                             \
  X(int64_t*, c_dwend, "c_dwend", "cc+1")                               \
  X(int64_t*, c_ceseen, "c_ceseen", "cc+1")                             \
  X(int64_t*, rtx_len, "rtx_len", "cc+1")                               \
  X(int64_t*, rtx_pos, "rtx_pos", "cc+1")                               \
  X(int64_t*, rtx_seq, "rtx_seq", "cc+1,RT")                            \
  X(int64_t*, rtx_plen, "rtx_plen", "cc+1,RT")                          \
  X(int64_t*, rtx_rtxed, "rtx_rtxed", "cc+1,RT")                        \
  X(int64_t*, rtx_sacked, "rtx_sacked", "cc+1,RT")                      \
  X(int64_t*, rtx_sent, "rtx_sent", "cc+1,RT")                          \
  X(int64_t*, ra_seq, "ra_seq", "cc+1,RA")                              \
  X(int64_t*, ra_plen, "ra_plen", "cc+1,RA")                            \
  X(uint8_t*, ra_valid, "ra_valid", "cc+1,RA")                          \
  X(int64_t*, op_len, "op_len", "cc+1")                                 \
  X(int64_t*, op_pos, "op_pos", "cc+1")                                 \
  X(int64_t*, op[kPk], "op_*", "cc+1,OP")                               \
  /* the span's flat buffers and the abort words */                     \
  X(int64_t*, out_n, "out_n", "")                                       \
  X(int64_t*, out_src, "out_src", "out")                                \
  X(int64_t*, out_dst, "out_dst", "out")                                \
  X(int64_t*, out_seq, "out_seq", "out")                                \
  X(int64_t*, out_t, "out_t", "out")                                    \
  X(int64_t*, out_pk[kPk], "out_*", "out")                              \
  X(int64_t*, tr_n, "tr_n", "")     /* the tr_* operands: null when */  \
  X(int64_t*, tr_t, "tr_t", "tr")   /* the span is not traced */        \
  X(int64_t*, tr_kind, "tr_kind", "tr")                                 \
  X(int64_t*, tr_pk[kRoute + 1], "tr_@", "tr")                          \
  X(int64_t*, tr_reason, "tr_reason", "tr")                             \
  X(int64_t*, tr_owner, "tr_owner", "tr")                               \
  X(int64_t*, abort_code, "abort_code", "")                             \
  X(int64_t*, abort_site, "abort_site", "")                             \
  /* the wrapper's window buffers */                                    \
  X(uint32_t*, bitmap, "win.bitmap", "passes,words")                    \
  X(int64_t*, stats, "win.stats", "stats")

#define STT_TCP_PARAM_FIELD(field) int64_t field;
#define STT_TCP_PARAM_NAME(field) #field " "
#define STT_TCP_OPERAND_FIELD(type, field, key, dims) type field;
#define STT_TCP_OPERAND_ENTRY(type, field, key, dims) \
  #type "|" key "|" dims ";"

struct Params {
  STT_TCP_PARAMS(STT_TCP_PARAM_FIELD)
};
struct Ops {
  STT_TCP_OPERANDS(STT_TCP_OPERAND_FIELD)
};

constexpr char kParamNames[] = STT_TCP_PARAMS(STT_TCP_PARAM_NAME);
constexpr char kOperands[] = STT_TCP_OPERANDS(STT_TCP_OPERAND_ENTRY);

// Pointers the operand string stands for: one per entry; kPk per "_*"
// key and kRoute + 1 per "_@" key.
constexpr int operand_pointers(const char* s) {
  int n = 0;
  for (int i = 0; s[i] != 0; i++) {
    if (s[i] == ';') n += 1;
    if (s[i] == '|' && i >= 2 && s[i - 2] == '_' && s[i - 1] == '*')
      n += kPk - 1;
    else if (s[i] == '|' && i >= 2 && s[i - 2] == '_' && s[i - 1] == '@')
      n += kRoute;
  }
  return n;
}
static_assert(sizeof(Params) ==
                  count_char(kParamNames, ' ') * sizeof(int64_t),
              "Params: one int64 word per name");
static_assert(sizeof(Ops) == operand_pointers(kOperands) * sizeof(void*),
              "Ops: one pointer per name");
// Both tables go to the kernel as __grid_constant__ parameters.
static_assert(sizeof(Ops) + sizeof(Params) <= 4096, "kernel parameters");

// -------- the lane frame ----------------------------------------------
//
// The lane's host and conn words, staged in its tile's shared memory for
// the window (see "the frame" at Lane).  Its words are groups of
// consecutive operand pointers of Ops, one word each at the lane's row:
//
//   host, read-only   h_fault .. r2_unlimited           (row i)
//   host, written     eflag .. ar[kPk - 1]              (row i; the three
//                     matrix pointers' places unused), then the lane's
//                     rows of drop_causes, mark_causes and app_sys
//   conn, read-only   c_role .. c_cc                    (each conn row)
//   conn, written     c_queued .. rtx_pos, op_len, op_pos
//
// up to kFrameConns of the lane's conn rows (its first in _conn_rows
// order).  A word's place follows from its operand's index in Ops, so
// the groups are checked to be consecutive there.
#define STT_OPI(field) \
  ((int)(offsetof(::stt::tcp::Ops, field) / sizeof(void*)))

constexpr int kHR0 = STT_OPI(h_fault);
constexpr int kHRn = STT_OPI(r2_unlimited) + 1 - kHR0;
constexpr int kHW0 = STT_OPI(eflag), kHWn = STT_OPI(cq) - kHW0;
constexpr int kCR0 = STT_OPI(c_role), kCRn = STT_OPI(c_cc) + 1 - kCR0;
constexpr int kCW0 = STT_OPI(c_queued), kCWn = STT_OPI(rtx_pos) + 1 - kCW0;
constexpr int kCO0 = STT_OPI(op_len), kCOn = 2;
static_assert(kHRn == 9 && STT_OPI(ar) + kPk == STT_OPI(cq) &&
                  kCRn == 14 && STT_OPI(c_queued) == STT_OPI(th_valid) + 1 &&
                  STT_OPI(rtx_pos) + 1 == STT_OPI(rtx_seq) &&
                  STT_OPI(op_pos) == kCO0 + 1,
              "the frame's operand groups are consecutive in Ops");
// The host words: the read-only group, the written group, the matrices.
constexpr int kFhDrop = kHRn + kHWn;
constexpr int kFhMark = kFhDrop + TEL_N;
constexpr int kFhAsys = kFhMark + MARK_N;
constexpr int kHostWords = kFhAsys + ASYS_N;
constexpr int kConnWords = kCRn + kCWn + kCOn;
// The conn rows a frame holds: a tgen server serves 7 (one per client).
constexpr int kFrameConns = 8;
constexpr int kFrameWords = kHostWords + kFrameConns * kConnWords;

// A host word's place from its operand's index (a group's pointer).
STT_HD constexpr int host_col(int opi) {
  return opi < kHW0 ? opi - kHR0 : kHRn + opi - kHW0;
}
// A conn word's place in its row's slot, and the operand's index of
// place j (the inverse).
STT_HD constexpr int conn_col(int opi) {
  return opi < kCW0   ? opi - kCR0
         : opi < kCO0 ? kCRn + opi - kCW0
                      : kCRn + kCWn + opi - kCO0;
}
STT_HD constexpr int conn_opi(int j) {
  return j < kCRn          ? kCR0 + j
         : j < kCRn + kCWn ? kCW0 + j - kCRn
                           : kCO0 + j - kCRn - kCWn;
}
static_assert(conn_col(conn_opi(kConnWords - 1)) == kConnWords - 1 &&
                  host_col(STT_OPI(ar) + kPk - 1) == kFhDrop - 1,
              "frame places");

struct Frame {
  int64_t w[kFrameWords];  // host words, then kConnWords a conn slot
  int64_t row[kFrameConns];  // the conn row in each slot
  int64_t n;                 // slots in use
};

struct Pk {
  int64_t v[kPk];
};

#ifdef __CUDACC__
#define STT_UNROLL_NONE _Pragma("unroll 1")
#else
#define STT_UNROLL_NONE
#endif

// One lane's counts over a window: the iteration bits of the 32-index
// chunk it is in for each pass (flushed to the shared bitmaps when it
// moves on), how often it ran each pass, its law calls and iterations.
struct LaneStats {
  uint32_t bits[kPasses];
  uint32_t lanes[kPasses];
  uint32_t calls[2];
  uint32_t iters;
  int64_t chunk;
};

// Sequence arithmetic on uint32 values carried in int64 (connection.py
// twins): the signed distance, the wrapped sum, the orders.
STT_LAW int64_t s_sub(int64_t a, int64_t b) {
  const int64_t d = (a - b) & M32;
  return d >= SEQ_HALF ? d - SEQ_MOD : d;
}
STT_LAW int64_t s_add(int64_t a, int64_t n) { return (a + n) & M32; }
STT_LAW bool s_lt(int64_t a, int64_t b) { return s_sub(a, b) < 0; }
STT_LAW bool s_leq(int64_t a, int64_t b) { return s_sub(a, b) <= 0; }

// torch.bitwise_left_shift / >> on int64: a shift outside [0, 64) gives
// 0 (left) or the sign (right).
STT_LAW int64_t shl(int64_t a, int64_t b) {
  return (b < 0 || b >= 64) ? 0 : (int64_t)((uint64_t)a << b);
}
STT_LAW int64_t shr(int64_t a, int64_t b) {
  return (b < 0 || b >= 64) ? (a < 0 ? -1 : 0) : a >> b;
}
STT_LAW int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
STT_LAW int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }
STT_LAW int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Eight 0/1 bytes of a bool row as one word (rows of a multiple of 8
// bytes, 8-aligned: the wrapper checks both).
STT_LAW uint64_t load8(const uint8_t* p) {
#ifdef __CUDACC__
  return *(const uint64_t*)p;
#else
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
#endif
}

// searchsorted (left side) over the n sorted words of `a`.
STT_LAW int64_t search_left(const int64_t* a, int64_t n, int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// -------- the team ----------------------------------------------------
//
// A host lane is stepped by a tile of kTeam threads of one warp (the
// kernel's tiles; the host build's team of runtime size, its ranks run
// in turn).  Rank 0, the leader, runs the lane law above; the others
// wait in `serve` for its row scans, each a Req naming a scan and its
// row, and the whole tile runs it.  A scan is a per-rank partial over
// a strided slice of the row (rank r takes elements r, r + T, ...) and
// a combine: team_reduce folds the partials with an associative,
// commutative join (a butterfly of shuffles on the card, the ranks in
// turn on the host); team_first takes the first hit in row order in
// rounds of T elements (a ballot on the card), so a scan that finds an
// early hit stops early, and every rank leaves the round together;
// team_for splits a loop over the tile with team_sync (__syncwarp) after
// each phase that later phases read.
//
// Hazards, and what keeps them away:
// - Read after write inside the tile.  Only the leader writes outside a
//   scan.  Every scan starts and ends at a __syncwarp of the tile
//   (team_serve), so the leader's writes before a scan are seen by every
//   rank in it, and the ranks' writes in a scan (the SACK marks, the
//   reneging clear, the staging in shared memory) are seen by the
//   leader after it.  Inside a scan the ranks write disjoint elements.
// - Leader-only work.  STT_CLAIM slots, STT_ABORT atomics, STT_OR32
//   bitmap words, store(), the counters and the stats flush are the
//   leader's alone, since only it runs the law (STT_CLAIM aggregates the
//   leaders that claim together: one per warp at kTeam = 32).
// - Convergence.  Every combine is reached by the whole tile: the leader
//   and the waiting ranks enter one function (team_serve, not inlined),
//   and its loops end on tile-uniform values (a ballot, a reduced
//   count); no rank leaves a round early.
// - Aborts.  Only the leader marks them (abort_, unchanged): the least
//   iteration per bit and the site key, and the lane's stop past the
//   least aborting iteration seen, are the one-thread lane's, word for
//   word.

constexpr int kTeam = 32;  // the kernel's tile: one warp
constexpr int kTeamMax = 32;  // the host build's largest team
static_assert(kTeam >= 1 && kTeam <= 32 && (kTeam & (kTeam - 1)) == 0,
              "a team is a power-of-two tile of one warp");
// The reassembly slots the SACK staging holds (cap_ra <= kSackMax; the
// kernel refuses a larger cap).  Staged arrays take one pad element per
// 16 so that a rank's chunk of 16 starts on another bank.
constexpr int kSackMax = 512;
constexpr int kSackPad = kSackMax + kSackMax / 16;
STT_LAW int spad(int64_t k) { return (int)(k + (k >> 4)); }

// The timer heap's least entries a rank keeps of its slice (the words
// rank, rank + T, ... of the lane's heap row).
constexpr int kKeep = 4;

// A tile's scratch in shared memory (the host build's: one per window).
struct TeamScratch {
  int64_t key[kSackPad];  // the SACK staging: distance from rcv_nxt,
  int64_t val[kSackPad];  // then length, then the running end
  int64_t cnt[kTeamMax];  // a rank's count, then its offset
  int64_t brk[kTeamMax][3];  // a rank's first breaks
  // Each rank's kept heap entries (time, seq, slot), ascending, their
  // count, and the bound every entry of its slice up to which is kept
  // (the largest key: all of them; tcp_lane.cuh th_min).
  int64_t ht[kTeamMax][kKeep], hs[kTeamMax][kKeep], hslot[kTeamMax][kKeep];
  int64_t hn[kTeamMax];
  int64_t bt[kTeamMax], bs[kTeamMax], bslot[kTeamMax];
  Frame fr;  // the lane's frame
};

#ifdef __CUDACC__
struct Team {
  unsigned mask;  // the tile's threads in their warp
  int rank;       // 0 .. kTeam - 1
  int base;       // the warp lane of rank 0
  static constexpr int size = kTeam;
};

__device__ __forceinline__ void team_sync(const Team& t) {
  __syncwarp(t.mask);
}

template <class V>
__device__ __forceinline__ V team_xor(const Team& t, V v, int m) {
  static_assert(sizeof(V) % 4 == 0, "shuffled in 32-bit words");
  uint32_t w[sizeof(V) / 4];
  memcpy(w, &v, sizeof(V));
#pragma unroll
  for (int k = 0; k < (int)(sizeof(V) / 4); k++)
    w[k] = __shfl_xor_sync(t.mask, w[k], m, kTeam);
  memcpy(&v, w, sizeof(V));
  return v;
}

// The join of every rank's part(rank, T), the same on every rank.
template <class P, class Part, class Join>
__device__ __forceinline__ P team_reduce(const Team& t, Part part,
                                         Join join) {
  P v = part(t.rank, kTeam);
#pragma unroll
  for (int m = kTeam / 2; m > 0; m >>= 1) v = join(v, team_xor(t, v, m));
  return v;
}

// The first hit(k) >= 0 for k in [0, n) in order, or -1.
template <class Hit>
__device__ __forceinline__ int64_t team_first(const Team& t, int64_t n,
                                              Hit hit) {
  for (int64_t base = 0; base < n; base += kTeam) {
    const int64_t k = base + t.rank;
    const int64_t h = k < n ? hit(k) : -1;
    const unsigned b = (__ballot_sync(t.mask, h >= 0) & t.mask) >> t.base;
    if (b) return __shfl_sync(t.mask, (long long)h, __ffs(b) - 1, kTeam);
  }
  return -1;
}

template <class F>
__device__ __forceinline__ void team_for(const Team& t, int64_t n, F f) {
  for (int64_t k = t.rank; k < n; k += kTeam) f(k);
}

// Each rank's exclusive prefix (from `id`) of part(rank) under `join`
// into out[rank]; returns the join of every rank's part.
template <class Part, class Join>
__device__ __forceinline__ int64_t team_exclusive(const Team& t,
                                                  int64_t* out, int64_t id,
                                                  Part part, Join join) {
  int64_t x = part(t.rank);
#pragma unroll
  for (int d = 1; d < kTeam; d <<= 1) {
    const int64_t y = __shfl_up_sync(t.mask, (long long)x, d, kTeam);
    if (t.rank >= d) x = join(y, x);
  }
  const int64_t ex = __shfl_up_sync(t.mask, (long long)x, 1, kTeam);
  out[t.rank] = t.rank ? ex : id;
  return __shfl_sync(t.mask, (long long)x, kTeam - 1, kTeam);
}
#else
struct Team {
  int size;  // the ranks, run in turn
};

inline void team_sync(const Team&) {}

template <class P, class Part, class Join>
inline P team_reduce(const Team& t, Part part, Join join) {
  P v = part(0, t.size);
  for (int r = 1; r < t.size; r++) v = join(v, part(r, t.size));
  return v;
}

template <class Hit>
inline int64_t team_first(const Team& t, int64_t n, Hit hit) {
  for (int64_t base = 0; base < n; base += t.size)
    for (int r = 0; r < t.size && base + r < n; r++) {
      const int64_t h = hit(base + r);
      if (h >= 0) return h;
    }
  return -1;
}

template <class F>
inline void team_for(const Team& t, int64_t n, F f) {
  for (int r = 0; r < t.size; r++)
    for (int64_t k = r; k < n; k += t.size) f(k);
}

template <class Part, class Join>
inline int64_t team_exclusive(const Team& t, int64_t* out, int64_t id,
                              Part part, Join join) {
  int64_t acc = id;
  for (int r = 0; r < t.size; r++) {
    out[r] = acc;
    acc = join(acc, part(r));
  }
  return acc;
}
#endif

// The first slot of word w of a bool row whose byte is set (`set`) or
// free, or -1.
STT_LAW int64_t byte_in_word(uint64_t v, int64_t w, bool set) {
  constexpr uint64_t kOnes = 0x0101010101010101ull;
  if (set ? v == 0 : v == kOnes) return -1;
  for (int b = 0; b < 8; b++)
    if ((((v >> (8 * b)) & 0xff) != 0) == set) return 8 * w + b;
  return -1;
}

// The valid bytes of a word of a 0/1 bool row.
STT_LAW int popcount8(uint64_t v) {
#ifdef __CUDACC__
  return __popcll(v & 0x0101010101010101ull);
#else
  return __builtin_popcountll(v & 0x0101010101010101ull);
#endif
}

// ---- the lane's frame, by the tile ----

// Operand pointer k of the table (Ops is an array of pointers).
STT_LAW int64_t* op_ptr(const Ops& o, int k) {
  int64_t* ptr;
  memcpy(&ptr, reinterpret_cast<const char*>(&o) + k * sizeof(void*),
         sizeof ptr);
  return ptr;
}

// Each word of lane i's frame with its device word: f(k, the device
// word of frame word k), a rank's share of them, host words a rank a
// word and conn words a rank a column (the column's pointer read once
// for every slot).  With `written`, only the words the window can
// change (the poison build: every word, the read-only ones it
// overwrote included).
template <class F>
STT_LAW void frame_for(const Team& t, const Ops& o, const Frame& fr,
                       int64_t i, bool written, F f) {
#ifdef STT_TCP_FRAME_POISON
  written = false;
#endif
  team_for(t, kHostWords, [&](int64_t k) {
    if (written && k < kHRn) return;
    if (k < kFhDrop) {
      const int opi = k < kHRn ? kHR0 + (int)k : kHW0 + (int)k - kHRn;
      if (opi != STT_OPI(drop_causes) && opi != STT_OPI(mark_causes) &&
          opi != STT_OPI(app_sys))
        f(k, op_ptr(o, opi) + i);
    } else if (k < kFhMark) {
      f(k, o.drop_causes + i * TEL_N + (k - kFhDrop));
    } else if (k < kFhAsys) {
      f(k, o.mark_causes + i * MARK_N + (k - kFhMark));
    } else {
      f(k, o.app_sys + i * ASYS_N + (k - kFhAsys));
    }
  });
  team_for(t, kConnWords, [&](int64_t j) {
    if (written && j < kCRn) return;
    int64_t* const col = op_ptr(o, conn_opi((int)j));
    for (int64_t s = 0; s < fr.n; s++)
      f(kHostWords + s * kConnWords + j, col + fr.row[s]);
  });
}

// One word from device memory into shared memory: on the card an 8-byte
// cp.async (LDGSTS: no trip through registers; the words are single
// scattered cells, under TMA's 16-byte minimum), waited for by
// frame_copy_wait.
STT_LAW void frame_copy(int64_t* dst, const int64_t* src) {
#ifdef __CUDACC__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

STT_LAW void frame_copy_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

#ifdef STT_TCP_FRAME_POISON
// What the poison build (tier-1's host build only) leaves in every
// gathered device word for the lane's window.
constexpr int64_t kPoison = 0x7EADBEEF0BADF00DLL;
#endif

// Lane i's frame gathered by the tile: its conn rows (the first
// kFrameConns of _conn_rows[_conn_off[i]:]), then its words.
STT_LAW void frame_gather(const Team& t, const Ops& o, int64_t i,
                          Frame& fr) {
  const int64_t k0 = o.conn_off[i];
  const int64_t n = min64(o.conn_off[i + 1] - k0, kFrameConns);
  team_for(t, n, [&](int64_t s) { fr.row[s] = o.conn_rows[k0 + s]; });
  team_for(t, 1, [&](int64_t) { fr.n = n; });
  team_sync(t);
  frame_for(t, o, fr, i, false,
            [&](int64_t k, const int64_t* dev) { frame_copy(&fr.w[k], dev); });
  frame_copy_wait();
#ifdef STT_TCP_FRAME_POISON
  frame_for(t, o, fr, i, false,
            [&](int64_t, int64_t* dev) { *dev = kPoison; });
#endif
}

// A place for word k of a frame-sized staging: the tile's SACK staging,
// free outside a SACK scan.
static_assert(kFrameWords <= 2 * kSackPad, "the SACK staging holds a frame");
STT_LAW int64_t& frame_stage(TeamScratch& sh, int64_t k) {
  return k < kSackPad ? sh.key[k] : sh.val[k - kSackPad];
}

// Each frame word that changed, back to device memory by the tile: the
// device words (still what the gather read: within a window no other
// lane writes the lane's words) copied beside the frame first, all of a
// rank's at once, then each changed word stored.
STT_LAW void frame_writeback(const Team& t, const Ops& o, int64_t i,
                             TeamScratch& sh) {
  const Frame& fr = sh.fr;
  frame_for(t, o, fr, i, true, [&](int64_t k, const int64_t* dev) {
    frame_copy(&frame_stage(sh, k), dev);
  });
  frame_copy_wait();
  frame_for(t, o, fr, i, true, [&](int64_t k, int64_t* dev) {
    if (frame_stage(sh, k) != fr.w[k]) *dev = fr.w[k];
  });
}

// The frame slot of conn row c, or -1 (a row past the frame's cap, or
// not the lane's: the trash row, the clamped read of a lane with no
// conn).
STT_LAW int frame_slot(const Frame& fr, int64_t c) {
  for (int s = 0; s < fr.n; s++)
    if (fr.row[s] == c) return s;
  return -1;
}

// Conn word `field` of row c as the tile's scans read it: the frame's
// copy where it holds the row, else device memory.
#define STT_SCAN_CW(fr, field, c) \
  ::stt::tcp::frame_cw(fr, conn_col(STT_OPI(field)), o.field, c)
STT_LAW int64_t frame_cw(const Frame& fr, int j, const int64_t* col,
                         int64_t c) {
  const int s = frame_slot(fr, c);
  return s >= 0 ? fr.w[kHostWords + s * kConnWords + j] : col[c];
}

// A conn row as the law holds it: the row, and its words in the frame
// (null: device memory), found once where the law picks the row.  It
// reads as the row's index where an index is wanted.
struct Conn {
  int64_t row;
  int64_t* f;
  STT_LAW operator int64_t() const { return row; }
};

// Conn row c's words in the frame, or null.  Not inlined on the card:
// the law looks rows up at a few places only (where it picks a row),
// and a search inlined at every conn word it reads ran a 10,000-host
// window ~45% slower (PERF.md).
#ifdef __CUDACC__
__device__ __noinline__
#else
inline
#endif
int64_t* frame_words(Frame& fr, int64_t c) {
  const int s = frame_slot(fr, c);
  return s >= 0 ? fr.w + kHostWords + s * kConnWords : nullptr;
}

// ---- the scans' partials and joins ----

// A timer heap entry's order: (time, seq), then its slot (the first
// slot wins a tie, as the eager masked argmin picks it).
struct Key {
  int64_t t, s, slot;
};
STT_LAW Key key_max() { return {I64_MAX, I64_MAX, I64_MAX}; }

STT_LAW bool key_lt(const Key& a, const Key& b) {
  return a.t != b.t ? a.t < b.t : (a.s != b.s ? a.s < b.s : a.slot < b.slot);
}

// A rank's slice of the first `words` words of a lane's heap row (words
// r, r + size, ...) rescanned: its kKeep least entries into `c`
// (ascending, padded with the largest key); returns the slice's count of
// entries and (in `last`) the count of its words up to the last that
// holds one.  The slice's valid words are read eight at a time, and a
// word's times and seqs together, so that a rescan waits on memory a
// few times, not once a word.
STT_LAW int64_t heap_part(const int64_t* time, const int64_t* seq,
                          const uint8_t* valid, int64_t words, int r,
                          int size, Key* c, int64_t& last) {
  int64_t n = 0;
  last = 0;
  STT_UNROLL
  for (int k = 0; k < kKeep; k++) c[k] = key_max();
  for (int64_t w0 = r; w0 < words; w0 += 8 * (int64_t)size) {
    uint64_t vs[8];
    STT_UNROLL
    for (int u = 0; u < 8; u++) {
      const int64_t w = w0 + (int64_t)u * size;
      vs[u] = w < words ? load8(valid + 8 * w) : 0;
    }
    STT_UNROLL_NONE
    for (int u = 0; u < 8; u++) {
      const uint64_t v = vs[u];
      if (!v) continue;
      const int64_t w = w0 + (int64_t)u * size;
      last = w + 1;
      int64_t tw[8], sw[8];
      STT_UNROLL
      for (int b = 0; b < 8; b++) {
        tw[b] = time[8 * w + b];
        sw[b] = seq[8 * w + b];
      }
      STT_UNROLL
      for (int b = 0; b < 8; b++) {
        if (((v >> (8 * b)) & 0xff) == 0) continue;
        n += 1;
        const Key k = {tw[b], sw[b], 8 * w + b};
        if (!key_lt(k, c[kKeep - 1])) continue;
        c[kKeep - 1] = k;
        STT_UNROLL
        for (int j = kKeep - 1; j > 0; j--)
          if (key_lt(c[j], c[j - 1])) {
            const Key x = c[j];
            c[j] = c[j - 1];
            c[j - 1] = x;
          }
      }
    }
  }
  return n;
}

// The timer heap's least (its key, the largest if the heap is empty),
// the count of its row's words up to the last that holds an entry, and
// the slots visited.
struct HeapMin {
  Key min;
  int64_t last, visited;
};

STT_LAW HeapMin heap_min_join(const HeapMin& a, const HeapMin& b) {
  return {key_lt(a.min, b.min) ? a.min : b.min,
          a.last > b.last ? a.last : b.last, a.visited + b.visited};
}

// A bitonic sorting network over `size` (a power of two) elements by
// the tile: `less(a, b)` orders, `swap(a, b)` exchanges; ascending.
template <class Less, class Swap>
STT_LAW void team_bitonic(const Team& t, int64_t size, Less less,
                          Swap swap) {
  for (int64_t run = 2; run <= size; run <<= 1)
    for (int64_t stride = run >> 1; stride > 0; stride >>= 1) {
      team_for(t, size >> 1, [&](int64_t q) {
        const int64_t lo = 2 * q - (q & (stride - 1)), hi = lo + stride;
        if (less(hi, lo) == ((lo & run) == 0)) swap(lo, hi);
      });
      team_sync(t);
    }
}

// The qdisc pick over a host's conns: least head priority, ties to the
// largest conn row.
struct Pick {
  int64_t best, sel;
};

STT_LAW Pick pick_join(const Pick& a, const Pick& b) {
  const bool lt = a.best != b.best ? a.best < b.best : a.sel > b.sel;
  return lt ? a : b;
}

// The first three run breaks of a sorted staging (ascending).
struct Breaks {
  int64_t k[3];
};

STT_LAW Breaks breaks_join(const Breaks& a, const Breaks& b) {
  Breaks m;
  int i = 0, j = 0;
  for (int n = 0; n < 3; n++)
    m.k[n] = a.k[i] <= b.k[j] ? a.k[i++] : b.k[j++];
  return m;
}

// The merged reassembly runs of a row (connection.py _sack_blocks), one
// sorted pass: the tile stages the valid entries' distances from rcv_nxt
// and lengths (rank r's words r, r + T, ..., at the offset of the ranks
// before it), sorts them (a bitonic network over the next power of two,
// padded with I64_MAX), and reads off the runs: with M_k the running
// maximum of max(d, d + len) over the sorted entries, entry k > 0 starts
// a run iff d_k > M_{k-1}, and a run's end is M at its last entry.  This
// is the fixpoint's answer for every row: a run is the closed interval
// grown by every entry starting inside it, its start the least distance
// past the previous run's end; the order among equal distances changes
// neither.  `sk` gets (nsk, s0, e0, s1, e1, s2, e2), zeros for absent
// runs; returns the entries staged.
STT_LAW int64_t sack_sorted(const Team& t, TeamScratch& sh,
                            const int64_t* seq, const int64_t* plen,
                            const uint8_t* valid, int64_t cap,
                            int64_t rcvnxt, int64_t* sk) {
  const int64_t words = cap / 8;
  int64_t* const key = sh.key;
  int64_t* const val = sh.val;
  const auto sum = [](int64_t a, int64_t b) { return a + b; };
  // Each rank's offset: the valid entries of the ranks before it.
  const int64_t n = team_exclusive(
      t, sh.cnt, 0,
      [&](int r) {
        int64_t m = 0;
        for (int64_t w = r; w < words; w += t.size)
          m += popcount8(load8(valid + 8 * w));
        return m;
      },
      sum);
  for (int k = 0; k < 7; k++) sk[k] = 0;
  if (n == 0) return 0;
  team_for(t, t.size, [&](int64_t r) {
    int64_t off = sh.cnt[r];
    for (int64_t w = r; w < words; w += t.size) {
      uint64_t v = load8(valid + 8 * w);
      while (v) {
        const int b = STT_CTZ64(v) >> 3;
        v &= ~((uint64_t)0xff << (8 * b));
        key[spad(off)] = s_sub(seq[8 * w + b], rcvnxt);
        val[spad(off)] = plen[8 * w + b];
        off += 1;
      }
    }
  });
  int64_t size = 1;
  while (size < n) size <<= 1;
  team_for(t, size - n, [&](int64_t k) {
    key[spad(n + k)] = I64_MAX;
    val[spad(n + k)] = 0;
  });
  team_sync(t);
  team_bitonic(
      t, size,
      [&](int64_t a, int64_t b) { return key[spad(a)] < key[spad(b)]; },
      [&](int64_t a, int64_t b) {
        const int x = spad(a), y = spad(b);
        const int64_t k = key[x], v = val[x];
        key[x] = key[y];
        val[x] = val[y];
        key[y] = k;
        val[y] = v;
      });
  // The running end over rank-sized chunks: each rank's chunk from the
  // maximum of the chunks before it, writing M over the lengths and
  // noting its first three breaks.
  const int64_t chunk = (n + t.size - 1) / t.size;
  team_exclusive(
      t, sh.cnt, -I64_MAX,
      [&](int r) {
        int64_t m = -I64_MAX;
        for (int64_t k = r * chunk; k < n && k < (r + 1) * chunk; k++) {
          const int64_t d = key[spad(k)], e = d + val[spad(k)];
          m = max64(m, max64(d, e));
        }
        return m;
      },
      [](int64_t a, int64_t b) { return max64(a, b); });
  team_for(t, t.size, [&](int64_t r) {
    int64_t m = sh.cnt[r];
    int nb = 0;
    sh.brk[r][0] = sh.brk[r][1] = sh.brk[r][2] = I64_MAX;
    for (int64_t k = r * chunk; k < n && k < (r + 1) * chunk; k++) {
      const int64_t d = key[spad(k)], e = d + val[spad(k)];
      if (k > 0 && d > m && nb < 3) sh.brk[r][nb++] = k;
      m = max64(m, max64(d, e));
      val[spad(k)] = m;
    }
  });
  team_sync(t);
  const Breaks br = team_reduce<Breaks>(
      t,
      [&](int r, int) {
        return Breaks{{sh.brk[r][0], sh.brk[r][1], sh.brk[r][2]}};
      },
      [](const Breaks& a, const Breaks& b) { return breaks_join(a, b); });
  int64_t start = 0;
  for (int r = 0; r < 3 && start < n; r++) {
    const int64_t next = br.k[r] < n ? br.k[r] : n;
    sk[0] = r + 1;
    sk[1 + 2 * r] = s_add(rcvnxt, key[spad(start)]);
    sk[2 + 2 * r] = s_add(rcvnxt, val[spad(next - 1)]);
    start = next;
  }
  return n;
}

// -------- the lane's row scans, served by the whole tile --------------

enum ScanOp : int64_t {
  SCAN_DONE,       // the lane is done: the waiting ranks leave
  SCAN_TH_MIN,     // a: words to scan, b: every rank rescans -> (t, s,
                   // slot, last, visited): the heap's least
  SCAN_TH_FREE,    // a: words to scan, b: the first -> free slot or -1
  SCAN_RA_FREE,    // a: conn -> first free reassembly slot or -1
  SCAN_RA_FIND,    // a: conn, b: seq -> first valid slot of seq or -1
  SCAN_RA_ANY,     // a: conn -> first valid slot or -1
  SCAN_SACK,       // a: conn -> (nsk, s0, e0, s1, e1, s2, e2, staged)
  SCAN_ACKED,      // a: conn -> the leading run of fully acked entries
  SCAN_UNSACKED,   // a: conn -> the first entry not SACKed, or -1
  SCAN_SACK_MARK,  // a: conn, b: its written row -> entries newly marked
  SCAN_RENEGE,     // a: written row: every SACK mark cleared
  SCAN_QDISC,      // the qdisc pick over the lane's conns -> (best, sel)
  SCAN_GATHER,     // the lane's frame filled from device memory
  SCAN_WRITEBACK,  // the frame's changed words back to device memory
};

struct Req {
  int64_t op, a, b;
};

struct Res {
  int64_t v[8];
};

// One scan of lane i's rows by the tile (every rank calls it with the
// same request; the result is the same on every rank).
STT_LAW Res serve(const Team& t, const Ops& o, const Params& p, int64_t i,
                  const Req& rq, TeamScratch& sh) {
  Res res = {{0, 0, 0, 0, 0, 0, 0, 0}};
  const int64_t c = rq.a;
  Frame& fr = sh.fr;
  switch (rq.op) {
    case SCAN_TH_MIN: {
      // Each rank keeps its slice's least entries (TeamScratch ht/hs/
      // hslot, ascending) and a bound: every entry of its slice up to
      // the bound is kept (the lane inserts its pushes and removes its
      // pops).  A rank whose kept entries ran out under a finite bound
      // (or every rank, with b) rescans its slice; the heap's least is
      // the least of the ranks' first.
      const int64_t row = i * p.cap_t;
      const HeapMin m = team_reduce<HeapMin>(
          t,
          [&](int r, int n) {
            HeapMin h = {key_max(), 0, 0};
            const bool ran_out = sh.hn[r] == 0 &&
                                 key_lt(Key{sh.bt[r], sh.bs[r], sh.bslot[r]},
                                        key_max());
            if (rq.b || ran_out) {
              Key least[kKeep];
              h.visited = heap_part(o.th_time + row, o.th_seq + row,
                                    o.th_valid + row, rq.a, r, n, least,
                                    h.last);
              STT_UNROLL
              for (int k = 0; k < kKeep; k++) {
                sh.ht[r][k] = least[k].t;
                sh.hs[r][k] = least[k].s;
                sh.hslot[r][k] = least[k].slot;
              }
              sh.hn[r] = h.visited < kKeep ? h.visited : kKeep;
              const Key b = h.visited > kKeep ? least[kKeep - 1] : key_max();
              sh.bt[r] = b.t;
              sh.bs[r] = b.s;
              sh.bslot[r] = b.slot;
            }
            if (sh.hn[r] > 0)
              h.min = {sh.ht[r][0], sh.hs[r][0], sh.hslot[r][0]};
            return h;
          },
          [](const HeapMin& a, const HeapMin& b) {
            return heap_min_join(a, b);
          });
      res.v[0] = m.min.t;
      res.v[1] = m.min.s;
      res.v[2] = m.min.slot;
      res.v[3] = m.last;
      res.v[4] = m.visited;
      break;
    }
    case SCAN_TH_FREE:
    case SCAN_RA_FREE:
    case SCAN_RA_FIND:
    case SCAN_RA_ANY: {
      const bool heap = rq.op == SCAN_TH_FREE;
      const uint8_t* const row =
          heap ? o.th_valid + i * p.cap_t : o.ra_valid + c * p.cap_ra;
      const int64_t w0 = heap ? rq.b : 0;
      const int64_t words = heap ? rq.a - w0 : p.cap_ra / 8;
      const bool set = rq.op == SCAN_RA_FIND || rq.op == SCAN_RA_ANY;
      const int64_t* const seq = o.ra_seq + c * p.cap_ra;
      res.v[0] = team_first(t, words, [&](int64_t k) -> int64_t {
        const int64_t w = w0 + k;
        uint64_t v = load8(row + 8 * w);
        if (rq.op != SCAN_RA_FIND) return byte_in_word(v, w, set);
        while (v) {
          const int b = STT_CTZ64(v) >> 3;
          v &= ~((uint64_t)0xff << (8 * b));
          if (seq[8 * w + b] == rq.b) return 8 * w + b;
        }
        return -1;
      });
      break;
    }
    case SCAN_SACK:
      res.v[7] = sack_sorted(t, sh, o.ra_seq + c * p.cap_ra,
                             o.ra_plen + c * p.cap_ra,
                             o.ra_valid + c * p.cap_ra, p.cap_ra,
                             STT_SCAN_CW(fr, c_rcvnxt, c), res.v);
      break;
    case SCAN_ACKED:
    case SCAN_UNSACKED:
    case SCAN_SACK_MARK: {
      const int64_t pos = STT_SCAN_CW(fr, rtx_pos, c);
      const int64_t len = STT_SCAN_CW(fr, rtx_len, c) - pos;
      const int64_t n = len < p.cap_rt ? len : p.cap_rt;
      const int64_t* const seq = o.rtx_seq + c * p.cap_rt;
      const int64_t* const plen = o.rtx_plen + c * p.cap_rt;
      const int64_t* const sacked = o.rtx_sacked + c * p.cap_rt;
      if (rq.op == SCAN_ACKED) {
        const int64_t una = STT_SCAN_CW(fr, c_snduna, c);
        const int64_t first = team_first(t, n, [&](int64_t k) -> int64_t {
          const int64_t s = (pos + k) % p.cap_rt;
          return s_leq(s_add(seq[s], plen[s]), una) ? -1 : k;
        });
        res.v[0] = first < 0 ? (n > 0 ? n : 0) : first;
        res.v[1] = first < 0 ? res.v[0] : first + 1;  // entries visited
      } else if (rq.op == SCAN_UNSACKED) {
        res.v[0] = team_first(t, n, [&](int64_t k) -> int64_t {
          return sacked[(pos + k) % p.cap_rt] == 0 ? k : -1;
        });
      } else {
        // The SACK blocks the packet in C_TCPIN carries.
        int64_t blk[7];
        STT_UNROLL
        for (int k = 0; k < 7; k++)
          blk[k] = fr.w[host_col(STT_OPI(ar)) + PK_NSK + k];
        int64_t* const out = o.rtx_sacked + rq.b * p.cap_rt;
        res.v[0] = team_reduce<int64_t>(
            t,
            [&](int r, int size) {
              int64_t newly = 0;
              for (int64_t k = r; k < n; k += size) {
                const int64_t s = (pos + k) % p.cap_rt;
                const int64_t end = s_add(seq[s], plen[s]);
                bool cov = false;
                STT_UNROLL
                for (int b = 0; b < 3; b++)
                  cov = cov || (blk[0] > b && s_leq(blk[1 + 2 * b], seq[s]) &&
                                s_leq(end, blk[2 + 2 * b]));
                if (cov && sacked[s] == 0) {
                  out[s] = 1;
                  newly += 1;
                }
              }
              return newly;
            },
            [](int64_t a, int64_t b) { return a + b; });
      }
      break;
    }
    case SCAN_RENEGE:
      team_for(t, p.cap_rt,
               [&](int64_t k) { o.rtx_sacked[c * p.cap_rt + k] = 0; });
      break;
    case SCAN_QDISC: {
      const int64_t k0 = o.conn_off[i], k1 = o.conn_off[i + 1];
      const Pick pick = team_reduce<Pick>(
          t,
          [&](int r, int size) {
            Pick m = {I64_MAX, -1};
            for (int64_t k = k0 + r; k < k1; k += size) {
              // The first kFrameConns rows from the frame, the rest
              // from device memory.
              const int64_t s = k - k0;
              const int64_t* const w =
                  s < fr.n ? fr.w + kHostWords + s * kConnWords : nullptr;
              const int64_t cc = w ? fr.row[s] : o.conn_rows[k];
              const int64_t pos =
                  w ? w[conn_col(STT_OPI(op_pos))] : o.op_pos[cc];
              const int64_t queued =
                  w ? w[conn_col(STT_OPI(c_queued))] : o.c_queued[cc];
              const int64_t len =
                  w ? w[conn_col(STT_OPI(op_len))] : o.op_len[cc];
              if (queued != 1 || len <= pos) continue;
              m = pick_join(m, {o.op[PK_PSEQ][cc * p.cap_op + pos % p.cap_op],
                                cc});
            }
            return m;
          },
          [](const Pick& a, const Pick& b) { return pick_join(a, b); });
      res.v[0] = pick.best;
      res.v[1] = pick.sel;
      break;
    }
    case SCAN_GATHER:
      frame_gather(t, o, i, fr);
      break;
    case SCAN_WRITEBACK:
      frame_writeback(t, o, i, sh);
      break;
    default:
      break;
  }
  return res;
}

#ifdef __CUDACC__
// The tile's one entry to a scan, the leader's and the waiting ranks'
// alike (not inlined: one copy of every scan, entered by the whole tile,
// with its own registers; inlined at every call it ran a 10k window
// 2x slower, PERF.md).  The leader's writes before it, and the ranks'
// writes in it, are ordered by the __syncwarp at either end.
#ifdef STT_TCP_PROFILE
// The profiling build's clocks of the tile's scans, by scan op: calls,
// and rank 0's cycles waiting for the tile at entry, in the scan, and
// waiting at the exit (stt_tcp_serve_profile reads and clears them).
constexpr int kScanOps = 16;
__device__ unsigned long long g_serve_prof[kScanOps][4];
#endif

__device__ __noinline__ Res team_serve(const Team& t, const Ops& o,
                                       const Params& p, int64_t i, Req& rq,
                                       TeamScratch& sh) {
#ifdef STT_TCP_PROFILE
  const long long c0 = clock64();
#endif
  __syncwarp(t.mask);
  rq.op = __shfl_sync(t.mask, (long long)rq.op, 0, kTeam);
  rq.a = __shfl_sync(t.mask, (long long)rq.a, 0, kTeam);
  rq.b = __shfl_sync(t.mask, (long long)rq.b, 0, kTeam);
#ifdef STT_TCP_PROFILE
  const long long c1 = clock64();
#endif
  const Res r = serve(t, o, p, i, rq, sh);
#ifdef STT_TCP_PROFILE
  const long long c2 = clock64();
#endif
  __syncwarp(t.mask);
#ifdef STT_TCP_PROFILE
  if (t.rank == 0 && rq.op >= 0 && rq.op < kScanOps) {
    unsigned long long* const g = g_serve_prof[rq.op];
    atomicAdd(g, 1ull);
    atomicAdd(g + 1, (unsigned long long)(c1 - c0));
    atomicAdd(g + 2, (unsigned long long)(c2 - c1));
    atomicAdd(g + 3, (unsigned long long)(clock64() - c2));
  }
#endif
  return r;
}
#endif

// One host lane: `o` and `p` are the window's tables, `i` the lane.  The
// hot words live in members for the window, the host and conn words in
// the lane's frame, and the rows (the timer heap, the CoDel ring, the
// inbox, the rtx, reassembly and egress rings) in device memory.
//
// The frame.  The law is one thread's chain of dependent steps: a
// micro-iteration of a tgen server reads a conn word, branches on it,
// reads the next.  The tile gathers the lane's host words and the conn
// words of its first kFrameConns conn rows into the frame in its shared
// memory (SCAN_GATHER: a rank a word, cp.async), the law reads and
// writes them there through STT_H / STT_C (a conn row's frame words
// found once where the law picks the row: `Conn`), and the tile writes
// each changed word back when the lane's window ends (SCAN_WRITEBACK,
// on every way out of run()).  Conn rows past the cap, the trash row
// and rows of no slot stay in device memory behind the same accessor:
// every lane runs in the same kernel, exactly.  By lane independence
// (above) no other lane reads or writes these words within a window, so
// the gathered copy stays the only live one until the write-back, which
// ends before the tile compacts the lane's row.  What it buys is
// measured (PERF.md): a lane reads the same few hundred words again and
// again, so in device memory they were mostly L1 hits already; the
// frame takes two thirds of the law's device accesses away, speeds the
// 16-host spans by a few per cent and leaves a 10,000-host window where
// it was, set by the law's instruction chain and its row scans.
struct Lane {
  const Ops& o;
  const Params& p;
  const int64_t i;
  LaneStats& s;
  const Team& t_;    // the tile stepping the lane (the law runs on rank 0)
  TeamScratch& sh_;  // its scratch
  Frame& fr_;        // the lane's frame, in the scratch
  const int64_t window_end;
  const RelayParams rp;  // the relay cores' constants
  int64_t now, cont, then, ret, cur, event_seq, packet_seq;
  int64_t ib_len, ib_pos, cq_pos, cq_len;
  int64_t* cur_f_;  // cur's words in the frame (null: not there)
  // The timer heap's minimum (time, seq, slot), valid while th_ok; and
  // the count of 8-slot words of the row that may hold a valid entry
  // (-1 until the first scan).
  int64_t th_t, th_s, th_slot, th_words;
  bool th_ok;
  // th_kept: the ranks' kept heap entries (TeamScratch ht/hs/hslot) hold
  // every entry of their slices up to their bounds; false until the
  // first rescan of every slice.  th_free: every slot below it holds an
  // entry.
  int64_t th_free;
  bool th_kept;
  // Where the lane is, for the abort keys: iteration, pass, place.
  int64_t j_;
  int q_, at_;
#ifdef STT_TCP_PROFILE
  int64_t* prof_ = nullptr;  // the lane's profile words (profiling build)
  // The law's word accesses by class (W_*), two counts of 32 bits a
  // word (so that counting costs the law an add, not a trip), flushed
  // into prof_ at the window's end.
  mutable uint64_t pfw_[W_N / 2] = {};
#define STT_PF_WORDS(w, n) \
  (pfw_[(w) >> 1] += (uint64_t)(n) << (32 * ((w) & 1)))
#else
#define STT_PF_WORDS(w, n) ((void)0)
#endif

  STT_LAW Lane(const Ops& o_, const Params& p_, int64_t i_, LaneStats& s_,
               const Team& t, TeamScratch& sh)
      : Lane(o_, p_, i_, s_, t, sh, p_.window_end) {}

  // The same lane with its window's end given apart from the table (a
  // span kernel's rounds each end elsewhere, the table stays constant).
  STT_LAW Lane(const Ops& o_, const Params& p_, int64_t i_, LaneStats& s_,
               const Team& t, TeamScratch& sh, int64_t window_end_)
      : o(o_), p(p_), i(i_), s(s_), t_(t), sh_(sh), fr_(sh.fr),
        window_end(window_end_),
        rp{p_.n, 0, p_.conns, TEL_N, p_.refill_ns, p_.target_ns, p_.mtu,
           p_.interval_ns, TCP_TOTAL_HDR} {
    now = o.now[i];
    cont = o.cont[i];
    then = o.then[i];
    ret = o.ret[i];
    cur = o.cur[i];
    event_seq = o.event_seq[i];
    packet_seq = o.packet_seq[i];
    ib_len = o.ib_len[i];
    ib_pos = o.ib_pos[i];
    cq_pos = o.cq_pos[i];
    cq_len = o.cq_len[i];
    cur_f_ = nullptr;  // set once the frame is gathered
    th_ok = false;
    th_words = -1;
    th_t = th_s = th_slot = 0;
    th_kept = false;
    th_free = 0;
    j_ = 0;
    q_ = at_ = 0;
  }

  // The hot words back to memory, each only if it changed.
  STT_LAW void store() const {
#define STT_PUT(ptr, v) \
  if ((ptr)[i] != (v)) (ptr)[i] = (v);
    STT_PUT(o.now, now) STT_PUT(o.cont, cont) STT_PUT(o.then, then)
    STT_PUT(o.ret, ret) STT_PUT(o.cur, cur) STT_PUT(o.event_seq, event_seq)
    STT_PUT(o.packet_seq, packet_seq) STT_PUT(o.ib_pos, ib_pos)
    STT_PUT(o.cq_pos, cq_pos) STT_PUT(o.cq_len, cq_len)
#undef STT_PUT
  }

  // -------- the frame's words -------------------------------------

  // Host word j of the lane (its place in the frame).
  STT_LAW int64_t& hw_(int j) const {
    STT_PF_WORDS(W_HOST, 1);
    return fr_.w[j];
  }

  // Conn row c as a handle (its frame words looked up).
  STT_LAW Conn conn_at(int64_t c) const { return {c, frame_words(fr_, c)}; }

  // Conn word j (its place; `col` its column) of the row: the frame's
  // copy, or device memory for a row the frame does not hold.
  STT_LAW int64_t& cw_(int j, int64_t* col, const Conn& c) const {
    STT_PF_WORDS(W_CONN, 1);
    STT_PF_WORDS(W_CONN_DEV, !c.f);
    return *(c.f ? c.f + j : col + c.row);
  }
  STT_LAW int64_t cw_(int j, const int64_t* col, const Conn& c) const {
    STT_PF_WORDS(W_CONN, 1);
    STT_PF_WORDS(W_CONN_DEV, !c.f);
    return *(c.f ? c.f + j : col + c.row);
  }

#define STT_H(field) hw_(host_col(STT_OPI(field)))
#define STT_HP(field, k) hw_(host_col(STT_OPI(field)) + (int)(k))
#define STT_H_DROP(tel) hw_(kFhDrop + (int)(tel))
#define STT_H_MARK(m) hw_(kFhMark + (int)(m))
#define STT_H_ASYS(a) hw_(kFhAsys + (int)(a))
#define STT_C(field, c) cw_(conn_col(STT_OPI(field)), o.field, (c))

  // -------- counters and aborts ----------------------------------

  STT_LAW void flush_bits() {
    for (int q = 0; q < kPasses; q++) {
      if (s.bits[q])
        STT_OR32(o.bitmap + q * p.bitmap_words + s.chunk, s.bits[q]);
      s.bits[q] = 0;
    }
  }

  // Pass q runs at iteration j.
  STT_LAW void mark(int q, int64_t j) {
    q_ = q;
    at_ = 0;
    s.lanes[q] += 1;
    if ((j >> 5) != s.chunk) {
      flush_bits();
      s.chunk = j >> 5;
    }
    s.bits[q] |= 1u << (j & 31);
  }

  // An abort mark at the lane's iteration, pass and place (`at_`, set
  // by the pass before each marking call in execution order); `site`
  // 0 marks no site (the capacity bits).
  STT_LAW void abort_(int64_t bit, int64_t site) const {
    int64_t* const st = o.stats;
    STT_ABORT(st + ST_AB_ITER, j_);
    STT_ABORT(st + ST_AB_BITS + (bit == AB_TRACE ? 0 : bit == AB_OUT ? 1 : 2),
              j_);
    if (site)
      STT_ABORT(st + ST_AB_SITE, (j_ << 24) | ((int64_t)q_ << 16) |
                                     ((int64_t)at_ << 8) | site);
  }

  // -------- conn rows ---------------------------------------------

  // The lane's conn: read at `cur` clamped into [0, CC) (the eager
  // gathers clamp), written at `cur` (the trash row CC for cur < 0).
  STT_LAW Conn crd() const {
    return cur >= 0 && cur < p.conns ? Conn{cur, cur_f_}
                                     : conn_at(clamp64(cur, 0, p.conns - 1));
  }
  STT_LAW Conn cwr() const {
    return cur >= 0 ? Conn{cur, cur_f_} : Conn{p.conns, nullptr};
  }
  STT_LAW void set_cur(const Conn& c) {
    cur = c.row;
    cur_f_ = c.f;
  }

  STT_LAW bool rtx_nonempty(const Conn& c) const {
    return STT_C(rtx_len, c) > STT_C(rtx_pos, c);
  }

  STT_LAW int64_t recv_window(const Conn& c) const {
    const int64_t cap = shl(MAX_WINDOW, STT_C(c_ourws, c));
    const int64_t space = max64(STT_C(c_rbmax, c) - STT_C(c_rblen, c), 0);
    return min64(cap, space);
  }

  STT_LAW int64_t wire_window(const Conn& c) const {
    // non-SYN segments only in-domain: always scaled
    return min64(shr(recv_window(c), STT_C(c_ourws, c)), MAX_WINDOW);
  }

  STT_LAW int64_t next_deadline(const Conn& c) const {
    int64_t nxt = I64_MAX;
    const int64_t d[3] = {STT_C(c_rtodl, c), STT_C(c_delackdl, c),
                          STT_C(c_persistdl, c)};
    for (int k = 0; k < 3; k++)
      if (d[k] >= 0 && d[k] < nxt) nxt = d[k];
    return nxt;
  }

  STT_LAW void fct_touch(int64_t nbytes, bool inbound) {
    const Conn c = crd(), w = cwr();
    const int64_t fb = STT_C(c_fbyte, c);
    const int64_t b = (inbound ? STT_C(c_bin, c) : STT_C(c_bout, c)) + nbytes;
    STT_C(c_fbyte, w) = fb < 0 ? now : fb;
    STT_C(c_lbyte, w) = now;
    (inbound ? STT_C(c_bin, w) : STT_C(c_bout, w)) = b;
  }

  // -------- primitive helpers -------------------------------------

  STT_LAW int64_t draw_seq() { return event_seq++; }

  // A row scan by the lane's tile (`serve`).
  STT_LAW Res scan(int64_t op, int64_t a = 0, int64_t b = 0) const {
    Req rq = {op, a, b};
#ifdef __CUDACC__
    return team_serve(t_, o, p, i, rq, sh_);
#else
    return serve(t_, o, p, i, rq, sh_);
#endif
  }

  STT_LAW void th_push(int64_t t, int64_t seq, int64_t kind, int64_t tgt) {
    const int64_t row = i * p.cap_t;
    const int64_t words = p.cap_t / 8;
    const int64_t scanned = th_words < 0 ? words : th_words;
    STT_PF_BEGIN(ff);
    // The first free slot: th_free's word read here, the words after it
    // by the tile; every slot from 8 * th_words on is free.
    const int64_t w0 = th_free / 8;
    int64_t k = -1;
    if (w0 < scanned) {
      k = byte_in_word(load8(o.th_valid + row + 8 * w0), w0, false);
      STT_PF_WORDS(W_ROW, 1);
      if (k < 0 && w0 + 1 < scanned)
        k = scan(SCAN_TH_FREE, scanned, w0 + 1).v[0];
    }
    if (k < 0) k = scanned < words ? 8 * scanned : -1;
    STT_PF_HELPER(ff, H_FIRST_FREE);
    if (k < 0) {  // a full heap writes nothing
      abort_(AB_STRUCT, 1);
      return;
    }
    STT_PF_WORDS(W_ROW, 5);
    o.th_time[row + k] = t;
    o.th_seq[row + k] = seq;
    o.th_kind[row + k] = kind;
    o.th_tgt[row + k] = tgt;
    o.th_valid[row + k] = 1;
    th_free = k + 1;
    if (th_words >= 0 && k / 8 + 1 > th_words) th_words = k / 8 + 1;
    // (time, seq) is unique per host: the new entry is the minimum
    // exactly when it sorts before the cached one.
    if (th_ok && (t < th_t || (t == th_t && seq < th_s))) {
      th_t = t;
      th_s = seq;
      th_slot = k;
    }
    if (th_kept) keep(Key{t, seq, k});
  }

  // A pushed entry into its rank's kept entries if within the bound (so
  // every entry of the slice up to the bound stays kept); a full list
  // keeps its kKeep least and lowers the bound to the largest of them.
  STT_LAW void keep(const Key& key) {
    const int r = (int)((key.slot / 8) % t_.size);
    if (key_lt(Key{sh_.bt[r], sh_.bs[r], sh_.bslot[r]}, key)) return;
    const auto at = [&](int64_t j) {
      return Key{sh_.ht[r][j], sh_.hs[r][j], sh_.hslot[r][j]};
    };
    const auto put = [&](int64_t j, const Key& x) {
      sh_.ht[r][j] = x.t;
      sh_.hs[r][j] = x.s;
      sh_.hslot[r][j] = x.slot;
    };
    const bool full = sh_.hn[r] == kKeep;
    int64_t j = full ? kKeep - 1 : sh_.hn[r];
    if (full && key_lt(at(j), key)) {
      j = kKeep;  // the key itself is the one that goes
    } else {
      for (; j > 0 && key_lt(key, at(j - 1)); j--) put(j, at(j - 1));
      put(j, key);
    }
    if (full) {
      const Key last = at(kKeep - 1);
      sh_.bt[r] = last.t;
      sh_.bs[r] = last.s;
      sh_.bslot[r] = last.slot;
    } else {
      sh_.hn[r] += 1;
    }
  }

  // The earliest timer (time, then seq; the first slot on ties), as
  // th_min's masked argmin picks it; (I64_MAX, ...) on an empty heap,
  // whose slot is never popped.  With th_cache the minimum is kept
  // between pops, and the ranks keep their slices' least entries, so a
  // call rescans only the slices whose kept entries ran out (every
  // slice at the lane's first call) and the least is the least of the
  // ranks' first.  Without th_cache every call rescans every slice.
  STT_LAW void th_min() {
    if (th_ok && p.th_cache) return;
    const bool all = !p.th_cache || !th_kept;
    STT_PF_BEGIN(tm);
    const Res m = scan(SCAN_TH_MIN, th_words < 0 ? p.cap_t / 8 : th_words,
                       all);
    STT_PF_HELPER(tm, H_TH_MIN);
    STT_PF_VISIT(V_HEAP, m.v[4]);
    if (all) th_words = m.v[3];
    th_kept = true;
    const bool empty = m.v[0] == I64_MAX && m.v[1] == I64_MAX;
    th_t = m.v[0];
    th_s = m.v[1];
    th_slot = empty ? 0 : m.v[2];
    th_ok = true;
  }

  STT_LAW void out_append(int64_t dst, int64_t seq, const Pk& pk) {
    const int64_t k = STT_CLAIM(o.out_n);
    const int64_t slot = k < p.cap_out ? k : p.cap_out;
    o.out_src[slot] = i;
    o.out_dst[slot] = dst;
    o.out_seq[slot] = seq;
    o.out_t[slot] = now;
    for (int c = 0; c < kPk; c++) o.out_pk[c][slot] = pk.v[c];
    if (k + 1 > p.cap_out - p.n) abort_(AB_OUT, 0);
  }

  STT_LAW void trace(int64_t t, int64_t kind, const Pk& pk, int64_t reason) {
    if (!p.tracing) return;
    const int64_t k = STT_CLAIM(o.tr_n);
    const int64_t slot = k < p.cap_tr ? k : p.cap_tr;
    o.tr_t[slot] = t;
    o.tr_kind[slot] = kind;
    for (int c = 0; c < kRoute; c++) o.tr_pk[c][slot] = pk.v[c];
    o.tr_pk[kRoute][slot] = pk.v[PK_PLEN];
    o.tr_reason[slot] = reason;
    o.tr_owner[slot] = i;
    if (k + 1 > p.cap_tr - p.n) abort_(AB_TRACE, 0);
  }

  STT_LAW void drop_cause(int tel) { STT_H_DROP(tel) += 1; }

  // -------- TCP helpers (connection.py twins) ---------------------

  // The first valid reassembly slot of conn c starting at `seq` (-1 if
  // none), eight slots a word: the rows are mostly empty.
  STT_LAW int64_t ra_find(int64_t c, int64_t seq) const {
    STT_PF_BEGIN(rf);
    const int64_t k = scan(SCAN_RA_FIND, c, seq).v[0];
    STT_PF_HELPER(rf, H_RA_FIND);
    return k;
  }

  // Merged reassembly runs of conn c (connection.py _sack_blocks; one
  // sorted pass by the tile, sack_sorted).  `sk` gets (nsk, s0, e0, s1,
  // e1, s2, e2), zeros for absent runs.
  STT_LAW void sack_blocks(int64_t c, int64_t* sk) const {
    STT_PF_BEGIN(sb);
    const Res r = scan(SCAN_SACK, c);
    for (int k = 0; k < 7; k++) sk[k] = r.v[k];
    STT_PF_HELPER(sb, H_SACK);
    STT_PF_VISIT(V_RA, r.v[7]);
  }

  // One segment from the lane's conn into its egress ring (emission
  // order IS flush order); every in-domain emission carries ACK, echoes
  // ECE, and fresh data consumes a pending one-shot CWR.
  STT_LAW void emit(int64_t tseq, int64_t plen, int64_t flags,
                    bool with_sacks, bool track, bool fresh) {
    const Conn c = crd(), w = cwr();
    const int64_t win = wire_window(c);
    int64_t sk[7] = {0, 0, 0, 0, 0, 0, 0};
    if (with_sacks) sack_blocks(c, sk);
    const int64_t tse = STT_C(c_tsrecent, c);
    STT_C(c_tsrecent, w) = 0;
    int64_t fl = flags | (STT_C(c_ece, c) == 1 ? F_ECE : 0);
    if (fresh && plen > 0 && STT_C(c_cwrp, c) == 1 && STT_C(c_ecnact, c) == 1) {
      fl |= F_CWR;
      STT_C(c_cwrp, w) = 0;
    }
    const int64_t ecn = (STT_C(c_ecnact, c) == 1 && plen > 0) ? ECN_ECT0 : 0;
    const int64_t pseq = packet_seq++;
    const int64_t len = STT_C(op_len, c);
    if (len - STT_C(op_pos, c) >= p.cap_op - 1) abort_(AB_STRUCT, 2);
    const int64_t slot = w * p.cap_op + len % p.cap_op;
    const int64_t vals[kPk] = {
        i,      pseq,   STT_C(c_lip, c), STT_C(c_lport, c), STT_C(c_pip, c),
        STT_C(c_pport, c), tseq, STT_C(c_rcvnxt, c), fl, win,
        now + 1, tse,   plen,   sk[0],  sk[1],
        sk[2],  sk[3],  sk[4],  sk[5],  sk[6],
        ecn};
    for (int k = 0; k < kPk; k++) o.op[k][slot] = vals[k];
    STT_PF_WORDS(W_ROW, kPk);
    STT_C(op_len, w) += 1;
    STT_C(c_segssent, w) += 1;
    // note_ack_sent: segs_since_ack=0, delack cleared
    STT_C(c_ssa, w) = 0;
    STT_C(c_delackdl, w) = -1;
    STT_H(eflag) = 1;
    if (track) {
      const int64_t rlen = STT_C(rtx_len, c);
      if (rlen - STT_C(rtx_pos, c) >= p.cap_rt - 1) abort_(AB_STRUCT, 3);
      const int64_t r = w * p.cap_rt + rlen % p.cap_rt;
      STT_PF_WORDS(W_ROW, 5);
      o.rtx_seq[r] = tseq;
      o.rtx_plen[r] = plen;
      o.rtx_rtxed[r] = 0;
      o.rtx_sacked[r] = 0;
      o.rtx_sent[r] = now;
      STT_C(rtx_len, w) += 1;
      if (STT_C(c_rtodl, c) < 0) STT_C(c_rtodl, w) = now + STT_C(c_rto, c);
    }
  }

  STT_LAW void emit_ack() {
    emit(STT_C(c_sndnxt, crd()), 0, F_ACK, true, false, false);
  }

  STT_LAW void update_rtt(int64_t sample) {
    const Conn c = crd(), w = cwr();
    sample = max64(sample, 1);
    const int64_t srtt = STT_C(c_srtt, c), rttvar = STT_C(c_rttvar, c);
    const bool first = srtt == 0;
    const int64_t n_srtt =
        first ? sample : floor_div_pos(7 * srtt + sample, 8);
    const int64_t err = srtt - sample < 0 ? sample - srtt : srtt - sample;
    const int64_t n_var =
        first ? floor_div_pos(sample, 2) : floor_div_pos(3 * rttvar + err, 4);
    const int64_t rto =
        clamp64(n_srtt + max64(4 * n_var, 1000000), MIN_RTO_NS, MAX_RTO_NS);
    STT_C(c_srtt, w) = n_srtt;
    STT_C(c_rttvar, w) = n_var;
    STT_C(c_rto, w) = rto;
  }

  // Pop the leading fully-acked rtx entries (a ring-order run).
  STT_LAW void clear_acked() {
    const Conn c = crd(), w = cwr();
    STT_PF_BEGIN(ca);
    const Res r = scan(SCAN_ACKED, c);
    STT_PF_HELPER(ca, H_RTX);
    STT_PF_VISIT(V_RTX, r.v[1]);
    STT_C(rtx_pos, w) = STT_C(rtx_pos, c) + r.v[0];
  }

  // The first non-SACKed rtx entry (head fallback), re-stamped and
  // re-emitted with the current scoreboard attached.
  STT_LAW void retransmit_one() {
    const Conn c = crd(), w = cwr();
    const int64_t pos = STT_C(rtx_pos, c), n = STT_C(rtx_len, c) - pos;
    if (n <= 0) return;  // nothing valid: nothing re-sent
    STT_PF_BEGIN(ro);
    const int64_t k = scan(SCAN_UNSACKED, c).v[0];
    const int64_t first = k < 0 ? 0 : k;
    STT_PF_HELPER(ro, H_RTX);
    const int64_t slot = (pos + first) % p.cap_rt;
    const int64_t seq = o.rtx_seq[c * p.cap_rt + slot];
    const int64_t plen = o.rtx_plen[c * p.cap_rt + slot];
    o.rtx_sent[w * p.cap_rt + slot] = now;
    o.rtx_rtxed[w * p.cap_rt + slot] = 1;
    STT_PF_WORDS(W_ROW, 4);
    STT_C(c_rtxcount, w) += 1;
    emit(seq, plen, F_ACK | F_PSH, true, false, false);
  }

  // -------- relays ------------------------------------------------

  STT_LAW Relay1Words r1_words() const {
    return {STT_H(r1_pk_valid), STT_H(r1_bal),       STT_H(r1_next),
            STT_H(r1_stalls),   STT_H(r1_pending),   STT_H(r1_fwd_pkts),
            STT_H(r1_fwd_bytes), STT_H(pkts_sent),   STT_H(pkts_dropped),
            STT_H(eth_psent),   STT_H(eth_bsent),
            STT_H_DROP(TEL_LINK_DOWN)};
  }

  STT_LAW void r1_store(const Relay1Words& b) const {
    STT_H(r1_pk_valid) = b.pk_valid;
    STT_H(r1_bal) = b.bal;
    STT_H(r1_next) = b.nxt;
    STT_H(r1_stalls) = b.stalls;
    STT_H(r1_pending) = b.pending;
    STT_H(r1_fwd_pkts) = b.fwd_pkts;
    STT_H(r1_fwd_bytes) = b.fwd_bytes;
    STT_H(pkts_sent) = b.pkts_sent;
    STT_H(pkts_dropped) = b.pkts_dropped;
    STT_H(eth_psent) = b.eth_psent;
    STT_H(eth_bsent) = b.eth_bsent;
    STT_H_DROP(TEL_LINK_DOWN) = b.drop_cause;
  }

  // inet-out drain: iface_pop over the host's queued conns (min head
  // priority = the engine's per-iface qdisc heap; ties to the largest
  // row, as the eager scatter's amax), SND trace, token bucket,
  // cross-host outbox.
  STT_LAW void op_relay1() {
    const bool use_pend = STT_H(r1_pk_valid) == 1;
    STT_PF_BEGIN(qd);
    const Res pick = scan(SCAN_QDISC);
    const int64_t best = pick.v[0], sel = pick.v[1];
    STT_PF_HELPER(qd, H_QDISC);
    const bool pop = !use_pend && best < I64_MAX;
    // The picked conn, read and written only when one is popped (then
    // sel is a row of the lane).
    const Conn sc = pop ? conn_at(sel) : Conn{sel, nullptr};
    Pk pk;
    if (use_pend) {
      for (int c = 0; c < kPk; c++) pk.v[c] = STT_HP(r1_pk, c);
    } else if (pop) {
      const int64_t slot = sc * p.cap_op + STT_C(op_pos, sc) % p.cap_op;
      for (int c = 0; c < kPk; c++) pk.v[c] = o.op[c][slot];
      STT_PF_WORDS(W_ROW, kPk);
    }
    Relay1Words w = r1_words();
    const RelayOut r =
        relay1_core(w, use_pend, pop, pk.v, now, STT_H(h_fault),
                    STT_H(r1_refill), STT_H(r1_cap), STT_H(r1_unlimited) == 1,
                    p.refill_ns, TCP_TOTAL_HDR);
    s.calls[CALL_BUCKET] += r.bucket_call;
    r1_store(w);
    if (r.stash)
      for (int c = 0; c < kPk; c++) STT_HP(r1_pk, c) = pk.v[c];
    if (pop) {  // iface_pop: dequeue + requeue-if-more + SND trace
      STT_C(op_pos, sc) += 1;
      STT_C(c_queued, sc) = STT_C(op_len, sc) > STT_C(op_pos, sc) ? 1 : 0;
      trace(now, TR_SND, pk, 0);
    }
    if (r.throttled) {
      const int64_t sq = draw_seq();
      th_push(r.when, sq, TK_RELAY, 1);
    }
    if (r.linkdn) trace(now, TR_DRP, pk, RSN_LINKDOWN);
    if (r.fwd) {  // device_push(dev=2): dst must be a remote engine host
      const int64_t dip = pk.v[PK_DIP];
      STT_PF_BEGIN(sl);
      const int64_t dslot = min64(search_left(o.ips_sorted, p.n, dip), p.n - 1);
      STT_PF_HELPER(sl, H_SEARCH);
      const bool found = o.ips_sorted[dslot] == dip;
      const int64_t dst = o.ips_perm[dslot];
      at_ = 1;
      if (!found || dst == i) abort_(AB_STRUCT, 4);
      if (found) {
        const int64_t sq = draw_seq();
        out_append(dst, sq, pk);
      }
    }
    if (r.done) cont = then;
  }

  STT_LAW Relay2Words r2_words() const {
    return {STT_H(r2_pk_valid),
            cq_pos,
            STT_H(codel_bytes),
            {STT_H(first_above), STT_H(dropping), STT_H(chain), STT_H(sniff),
             STT_H(count), STT_H(last_count), STT_H(drop_next)},
            STT_H(cd_dropped),
            STT_H(cd_drop_bytes),
            STT_H(pkts_dropped),
            STT_H_DROP(TEL_CODEL),
            STT_H(r2_bal),
            STT_H(r2_next),
            STT_H(r2_stalls),
            STT_H(r2_pending),
            STT_H(r2_fwd_pkts),
            STT_H(r2_fwd_bytes),
            STT_H(eth_precv),
            STT_H(eth_brecv)};
  }

  STT_LAW void r2_store(const Relay2Words& b) {
    cq_pos = b.cq_pos;
    STT_H(r2_pk_valid) = b.pk_valid;
    STT_H(codel_bytes) = b.codel_bytes;
    STT_H(first_above) = b.cw.first_above;
    STT_H(dropping) = b.cw.dropping;
    STT_H(chain) = b.cw.chain;
    STT_H(sniff) = b.cw.sniff;
    STT_H(count) = b.cw.count;
    STT_H(last_count) = b.cw.last_count;
    STT_H(drop_next) = b.cw.drop_next;
    STT_H(cd_dropped) = b.dropped;
    STT_H(cd_drop_bytes) = b.drop_bytes;
    STT_H(pkts_dropped) = b.pkts_dropped;
    STT_H_DROP(TEL_CODEL) = b.drop_cause;
    STT_H(r2_bal) = b.bal;
    STT_H(r2_next) = b.nxt;
    STT_H(r2_stalls) = b.stalls;
    STT_H(r2_pending) = b.pending;
    STT_H(r2_fwd_pkts) = b.fwd_pkts;
    STT_H(r2_fwd_bytes) = b.fwd_bytes;
    STT_H(eth_precv) = b.eth_precv;
    STT_H(eth_brecv) = b.eth_brecv;
  }

  // inet-in drain: CoDel pop -> token bucket -> iface_receive -> conn
  // match -> hand to C_TCPIN.
  STT_LAW void op_relay2() {
    const bool use_pend = STT_H(r2_pk_valid) == 1;
    const bool pop = !use_pend && cq_len > cq_pos;
    Pk pk;
    int64_t enq = 0;
    if (use_pend) {
      for (int c = 0; c < kPk; c++) pk.v[c] = STT_HP(r2_pk, c);
    } else if (pop) {
      const int64_t slot = i * p.cap_cq + cq_pos % p.cap_cq;
      for (int c = 0; c < kPk; c++) pk.v[c] = o.cq[c][slot];
      enq = o.cq_enq[slot];
      STT_PF_WORDS(W_ROW, kPk + 1);
    }
    Relay2Words w = r2_words();
    const RelayOut r =
        relay2_core(w, use_pend, pop, pk.v, enq, now, STT_H(r2_refill),
                    STT_H(r2_cap), STT_H(r2_unlimited) == 1, rp);
    s.calls[CALL_BUCKET] += r.bucket_call;
    s.calls[CALL_CODEL] += r.codel_call;
    r2_store(w);
    if (r.stash)
      for (int c = 0; c < kPk; c++) STT_HP(r2_pk, c) = pk.v[c];
    if (r.codel_drop) trace(now, TR_DRP, pk, RSN_CODEL);
    if (r.throttled) {
      const int64_t sq = draw_seq();
      th_push(r.when, sq, TK_RELAY, 2);
    }
    if (r.fwd) {
      at_ = 1;
      if (pk.v[PK_DIP] != STT_H(eth_ip)) abort_(AB_STRUCT, 5);
      // conn lookup: (dsthost, src-ip-host, sport) key
      const int64_t sip = pk.v[PK_SIP];
      STT_PF_BEGIN(sl);
      const int64_t sslot = min64(search_left(o.ips_sorted, p.n, sip), p.n - 1);
      const bool sfound = o.ips_sorted[sslot] == sip;
      const int64_t sidx = o.ips_perm[sslot];
      const int64_t akey = (i * p.n + sidx) * 65536 + pk.v[PK_SPORT];
      const int64_t kslot =
          min64(search_left(o.ckeys, p.conns, akey), p.conns - 1);
      STT_PF_HELPER(sl, H_SEARCH);
      const bool kfound = sfound && o.ckeys[kslot] == akey;
      const Conn conn = conn_at(o.ckperm[kslot]);
      const bool good = kfound && STT_C(c_lport, conn) == pk.v[PK_DPORT];
      at_ = 2;
      if (!good) abort_(AB_STRUCT, 6);
      if (good) {  // delivered: trace RCV at arrival, hand to C_TCPIN
        STT_H(pkts_recv) += 1;
        trace(now, TR_RCV, pk, 0);
        set_cur(conn);
        for (int c = 0; c < kPk; c++) STT_HP(ar, c) = pk.v[c];
        ret = C_R2;
        cont = C_TCPIN;
      }
    }
    if (r.done) cont = C_IDLE;
  }

  // -------- TCP state machine -------------------------------------

  // on_packet minus the push_data / reassembly-drain loops (those
  // continue as C_PUSH / C_DRAIN).
  STT_LAW void op_tcpin() {
    const Conn c = crd(), w = cwr();
    Pk pk;
    for (int k = 0; k < kPk; k++) pk.v[k] = STT_HP(ar, k);
    const int64_t plen = pk.v[PK_PLEN], tfl = pk.v[PK_TFLAGS];
    const int64_t tseq = pk.v[PK_TSEQ], ack = pk.v[PK_TACK];
    STT_C(c_segsrecv, w) = STT_C(c_segsrecv, c) + 1;
    // in-domain wire: synchronized-state segments only; a data segment
    // arriving at a sender (or acking unsent data) leaves the modelled
    // tgen roles
    if ((tfl & (F_SYN | F_FIN | F_RST)) != 0 || (tfl & F_ACK) == 0 ||
        (plen > 0 && STT_C(c_role, c) == 1) || s_lt(STT_C(c_sndnxt, c), ack))
      abort_(AB_STRUCT, 7);
    // RFC 3168 receiver: CWR ends the echo episode, a CE-marked arrival
    // (re)starts it — in that order.
    const bool ecnact = STT_C(c_ecnact, c) == 1;
    if (ecnact && (tfl & F_CWR) != 0) STT_C(c_ece, w) = 0;
    if (ecnact && pk.v[PK_ECN] == ECN_CE) {
      const int64_t seen = STT_C(c_ceseen, c) + 1;
      STT_C(c_ece, w) = 1;
      STT_C(c_ceseen, w) = seen;
    }
    // RFC 7323 ts_recent update (covering the ack point)
    const int64_t span = max64(plen, 1);
    if (pk.v[PK_TSV] != 0 && s_leq(tseq, STT_C(c_rcvnxt, c)) &&
        s_lt(STT_C(c_rcvnxt, c), s_add(tseq, span)))
      STT_C(c_tsrecent, w) = pk.v[PK_TSV];
    // RTTM: sample only from a segment acking NEW data
    if (pk.v[PK_TSE] != 0 && STT_C(c_rtobackoff, c) == 0 &&
        s_lt(STT_C(c_snduna, c), ack) && s_leq(ack, STT_C(c_sndnxt, c)))
      update_rtt(now - (pk.v[PK_TSE] - 1));
    // ---- on_ack ----
    const int64_t wnd = shl(pk.v[PK_TWIN], STT_C(c_peerws, c));
    const bool wchanged = wnd != STT_C(c_sndwnd, c);
    STT_C(c_sndwnd, w) = wnd;
    if (wnd > 0 && STT_C(c_persistdl, c) >= 0) {
      STT_C(c_persistdl, w) = -1;
      STT_C(c_persistiv, w) = 0;
    }
    // SACK scoreboard marks
    if (pk.v[PK_NSK] > 0) {
      STT_PF_BEGIN(sm);
      const int64_t newly = scan(SCAN_SACK_MARK, c, w).v[0];
      STT_PF_HELPER(sm, H_RTX);
      STT_PF_VISIT(V_RTX, clamp64(STT_C(rtx_len, c) - STT_C(rtx_pos, c), 0,
                                  p.cap_rt));
      STT_C(c_sackskip, w) = STT_C(c_sackskip, c) + newly;
    }
    // ECN sender side: after the SACK marks, before the new-ack/dupack
    // dispatch (snd_una still pre-ack).
    const bool ece_fl = ecnact && (tfl & F_ECE) != 0;
    const bool new_ack0 = s_lt(STT_C(c_snduna, c), ack);
    const int64_t acked0 = s_sub(ack, STT_C(c_snduna, c));
    const bool is_d = STT_C(c_cc, c) == CC_DCTCP;
    const bool acc = new_ack0 && ecnact && is_d;
    if (acc) {
      const int64_t tot = STT_C(c_totack, c) + acked0;
      const int64_t ce = STT_C(c_ceack, c) + (ece_fl ? acked0 : 0);
      STT_C(c_totack, w) = tot;
      STT_C(c_ceack, w) = ce;
    }
    // window boundary: fold the echo fraction into alpha
    if (acc && s_lt(STT_C(c_dwend, c), ack)) {
      const int64_t alpha = STT_C(c_alpha, c);
      const int64_t nalpha = min64(
          alpha - (alpha >> DCTCP_G_SHIFT) +
              floor_div_pos(STT_C(c_ceack, c) << (DCTCP_SHIFT - DCTCP_G_SHIFT),
                            max64(STT_C(c_totack, c), 1)),
          DCTCP_MAX_ALPHA);
      const int64_t dwend = STT_C(c_sndnxt, c);
      STT_C(c_alpha, w) = nalpha;
      STT_C(c_ceack, w) = 0;
      STT_C(c_totack, w) = 0;
      STT_C(c_dwend, w) = dwend;
    }
    // one cut per window; CWR announces it on fresh data
    const bool red =
        ece_fl && STT_C(c_fastrec, c) == 0 && s_lt(STT_C(c_cwrend, c), ack);
    if (red) {
      const int64_t mss_e = STT_C(c_congmss, c);
      const int64_t flight0 = s_sub(STT_C(c_sndnxt, c), STT_C(c_snduna, c));
      const int64_t cw0 = STT_C(c_cwnd, c);
      const int64_t r_cw = max64(floor_div_pos(flight0, 2), 2 * mss_e);
      const int64_t d_cw = max64(
          cw0 - (mul_wrap(cw0, STT_C(c_alpha, c)) >> (DCTCP_SHIFT + 1)),
          2 * mss_e);
      const int64_t ncw = is_d ? d_cw : r_cw;
      const int64_t cwrend = STT_C(c_sndnxt, c);
      STT_C(c_cwnd, w) = ncw;
      STT_C(c_ssthresh, w) = ncw;
      STT_C(c_cwrend, w) = cwrend;
      STT_C(c_cwrp, w) = 1;
    }
    // new ack / dupack
    const bool rtx_ne = rtx_nonempty(c);
    const bool new_ack = s_lt(STT_C(c_snduna, c), ack);
    const bool dup = !new_ack && ack == STT_C(c_snduna, c) && rtx_ne &&
                     plen == 0 && !wchanged;
    const int64_t acked = s_sub(ack, STT_C(c_snduna, c));
    bool in_rec = false;
    if (new_ack) {  // handle_new_ack
      STT_C(c_snduna, w) = ack;
      STT_C(c_dupacks, w) = 0;
      STT_C(c_rtobackoff, w) = 0;
      clear_acked();
      if (STT_C(c_srtt, c) > 0)
        STT_C(c_rto, w) = clamp64(
            STT_C(c_srtt, c) + max64(4 * STT_C(c_rttvar, c), 1000000),
            MIN_RTO_NS, MAX_RTO_NS);
      in_rec = STT_C(c_fastrec, c) == 1;
      const bool rec_exit =
          in_rec &&
          (s_lt(STT_C(c_recover, c), ack) || ack == STT_C(c_recover, c));
      if (rec_exit) {
        const int64_t ss = STT_C(c_ssthresh, c);
        STT_C(c_fastrec, w) = 0;
        STT_C(c_cwnd, w) = ss;
      }
      if (in_rec && !rec_exit) {  // partial ack
        at_ = 1;
        retransmit_one();
      }
      // reno on_new_ack (not in recovery; an ack that just triggered
      // the ECN cut must not also grow the window)
      if (!in_rec && !red) {
        const int64_t mss_c = STT_C(c_congmss, c), cwnd = STT_C(c_cwnd, c);
        const int64_t cwnd2 =
            cwnd < STT_C(c_ssthresh, c)
                ? cwnd + min64(acked, 2 * mss_c)
                : cwnd + max64(floor_div_pos(mss_c * mss_c, max64(cwnd, 1)),
                               1);
        STT_C(c_cwnd, w) = cwnd2;
      }
      // RTO restart
      STT_C(c_rtodl, w) = rtx_nonempty(c) ? now + STT_C(c_rto, c) : -1;
    }
    if (dup) {  // handle_dupack
      const int64_t dupacks = STT_C(c_dupacks, c) + 1;
      STT_C(c_dupacks, w) = dupacks;
      const bool d_rec = STT_C(c_fastrec, c) == 1;
      if (d_rec) STT_C(c_cwnd, w) = STT_C(c_cwnd, c) + STT_C(c_congmss, c);
      if (!d_rec && STT_C(c_dupacks, c) == 3) {
        const int64_t flight = s_sub(STT_C(c_sndnxt, c), STT_C(c_snduna, c));
        const int64_t ssth =
            max64(floor_div_pos(flight, 2), 2 * STT_C(c_congmss, c));
        const int64_t recover = STT_C(c_sndnxt, c);
        STT_C(c_ssthresh, w) = ssth;
        STT_C(c_fastrec, w) = 1;
        STT_C(c_recover, w) = recover;
        STT_C(c_cwnd, w) = STT_C(c_ssthresh, c) + 3 * STT_C(c_congmss, c);
        at_ = 2;
        retransmit_one();
      }
    }
    // ---- on_data (receiver side; plen > 0) ----
    const bool data = plen > 0;
    const int64_t offset = s_sub(STT_C(c_rcvnxt, c), tseq);
    const bool dup_data = data && offset >= plen;
    if (dup_data) {
      at_ = 3;
      emit_ack();
    }
    const bool live = data && !dup_data;
    const int64_t eff_seq = offset > 0 ? STT_C(c_rcvnxt, c) : tseq;
    const int64_t eff_len = offset > 0 ? plen - offset : plen;
    const bool future = live && s_sub(eff_seq, STT_C(c_rcvnxt, c)) != 0;
    // reassembly setdefault (bounded by the receive buffer)
    if (future) {
      const bool exists = ra_find(c, eff_seq) >= 0;
      const bool in_win =
          s_sub(eff_seq, STT_C(c_rcvnxt, c)) < STT_C(c_rbmax, c);
      if (!in_win) drop_cause(TEL_REASM_FULL);  // receiver discard
      if (in_win && !exists) {
        STT_PF_BEGIN(ff);
        const int64_t k = scan(SCAN_RA_FREE, c).v[0];
        STT_PF_HELPER(ff, H_FIRST_FREE);
        at_ = 4;
        if (k < 0) {
          abort_(AB_STRUCT, 8);
        } else {
          o.ra_seq[w * p.cap_ra + k] = eff_seq;
          o.ra_plen[w * p.cap_ra + k] = eff_len;
          o.ra_valid[w * p.cap_ra + k] = 1;
          STT_PF_WORDS(W_ROW, 3);
        }
      }
      at_ = 5;
      emit_ack();
    }
    // in-order delivery
    const bool inord = live && !future;
    if (inord) {  // (nothing was stored: the reassembly row as it came)
      STT_PF_BEGIN(hh);
      const bool had_any = scan(SCAN_RA_ANY, c).v[0] >= 0;
      STT_PF_HELPER(hh, H_HOLES);
      STT_H(had_holes) = had_any ? 1 : 0;
      const int64_t space = STT_C(c_rbmax, c) - STT_C(c_rblen, c);
      const int64_t take = max64(min64(space, eff_len), 0);
      // in-order bytes past the receive buffer: unacked tail, the
      // sender retransmits (TcpConn::deliver twin)
      if (eff_len > take) drop_cause(TEL_RECVWIN_TRUNC);
      const int64_t rblen = STT_C(c_rblen, c) + take;
      const int64_t rcvnxt = s_add(STT_C(c_rcvnxt, c), take);
      STT_C(c_rblen, w) = rblen;
      STT_C(c_rcvnxt, w) = rcvnxt;
      if (take > 0) fct_touch(take, true);
    }
    // ---- continuation ----
    cont = inord ? C_DRAIN : (data ? C_FLUSH : C_PUSH);
  }

  // One reassembly chunk per micro-op (connection.py's
  // while-rcv_nxt-in-reassembly loop).
  STT_LAW void op_drain() {
    const Conn c = crd(), w = cwr();
    const int64_t row = c * p.cap_ra, rcvnxt = STT_C(c_rcvnxt, c);
    const int64_t slot = ra_find(c, rcvnxt);
    if (slot < 0) {
      cont = C_ACKDATA;
      return;
    }
    const int64_t plen = o.ra_plen[row + slot];
    const int64_t space = STT_C(c_rbmax, c) - STT_C(c_rblen, c);
    const int64_t take = max64(min64(space, plen), 0);
    if (plen > take) drop_cause(TEL_RECVWIN_TRUNC);
    const int64_t rblen = STT_C(c_rblen, c) + take;
    STT_C(c_rblen, w) = rblen;
    STT_C(c_rcvnxt, w) = s_add(rcvnxt, take);
    if (take > 0) fct_touch(take, true);
    o.ra_valid[w * p.cap_ra + slot] = 0;
    STT_PF_WORDS(W_ROW, 2);
  }

  // ack_data: every second in-order segment acks now; holes or a
  // pinched window force it; else the 40ms delack.
  STT_LAW void op_ackdata() {
    const Conn c = crd(), w = cwr();
    const int64_t ssa = STT_C(c_ssa, c) + 1;
    STT_C(c_ssa, w) = ssa;
    STT_PF_BEGIN(hh);
    const bool any_ra = scan(SCAN_RA_ANY, c).v[0] >= 0;
    STT_PF_HELPER(hh, H_HOLES);
    const bool fire = STT_H(had_holes) == 1 || STT_C(c_ssa, c) >= 2 || any_ra ||
                      recv_window(c) < STT_C(c_effmss, c);
    if (fire) {
      emit_ack();
    } else if (STT_C(c_delackdl, c) < 0) {
      STT_C(c_delackdl, w) = now + DELACK_NS;
    }
    STT_H(had_holes) = 0;
    cont = C_FLUSH;
  }

  // push_data: one eff_mss segment per micro-op within min(cwnd, peer
  // window); Nagle holds a sub-MSS tail.
  STT_LAW void op_push() {
    const Conn c = crd(), w = cwr();
    const int64_t window = min64(STT_C(c_cwnd, c), STT_C(c_sndwnd, c));
    const int64_t flight = s_sub(STT_C(c_sndnxt, c), STT_C(c_snduna, c));
    const int64_t sblen = STT_C(c_sblen, c);
    const bool can = sblen > 0 && flight < window;
    const int64_t budget = min64(window - flight, STT_C(c_effmss, c));
    const bool nagle_hold =
        can && STT_C(c_nodelay, c) == 0 && sblen < budget && flight > 0;
    const int64_t chunk = min64(sblen, budget);
    if (can && !nagle_hold && chunk > 0) {
      const int64_t sndnxt = STT_C(c_sndnxt, c);
      emit(sndnxt, chunk, F_ACK | F_PSH, false, true, true);
      const int64_t sb = STT_C(c_sblen, c) - chunk;
      const int64_t nx = s_add(STT_C(c_sndnxt, c), chunk);
      STT_C(c_sblen, w) = sb;
      STT_C(c_sndnxt, w) = nx;
      fct_touch(chunk, false);
      return;
    }
    // zero-window persist arming
    if (STT_C(c_sndwnd, c) == 0 && STT_C(c_sblen, c) > 0 && !rtx_nonempty(c) &&
        STT_C(c_persistdl, c) < 0) {
      const int64_t rto = STT_C(c_rto, c);
      STT_C(c_persistiv, w) = rto;
      STT_C(c_persistdl, w) = now + rto;
    }
    cont = C_FLUSH;
  }

  // tcp_flush's notify: register the socket with the iface qdisc and
  // kick the inet-out relay if it is idle.
  STT_LAW void op_flush() {
    const Conn c = crd(), w = cwr();
    const bool need = STT_H(eflag) == 1 && STT_C(c_queued, c) == 0;
    if (need) STT_C(c_queued, w) = 1;
    STT_H(eflag) = 0;
    cont = C_ARM;
    if (need && STT_H(r1_pending) == 0) {
      cont = C_R1;
      then = C_ARM;
    }
  }

  // tcp_arm_timer + tcp_update_status (+ the deferred sendto-EAGAIN
  // park).
  STT_LAW void op_arm() {
    const Conn c = crd(), w = cwr();
    const int64_t nxt = next_deadline(c);
    if (nxt < I64_MAX && nxt != STT_C(c_tmrdl, c)) {
      STT_C(c_tmrdl, w) = nxt;
      const int64_t sq = draw_seq();
      th_push(nxt, sq, TK_TCP, cur);
    }
    // update_status (ESTABLISHED lanes only in-domain)
    const bool readable = STT_C(c_rblen, c) > 0;
    const bool space = STT_C(c_sbmax, c) - STT_C(c_sblen, c) > 0;
    const int64_t old = STT_C(c_status, c);
    const int64_t set_bits =
        (readable ? S_READABLE : 0) | (space ? S_WRITABLE : 0);
    const int64_t clear_bits = (readable ? 0 : S_READABLE) & ~set_bits;
    const int64_t nw = (old | set_bits) & ~clear_bits;
    STT_C(c_status, w) = nw;
    if (((old ^ nw) & STT_C(c_await, c)) != 0 && STT_C(c_wakep, c) == 0) {
      const int64_t sq = draw_seq();
      at_ = 1;
      th_push(now, sq, TK_APP, cur);
      STT_C(c_wakep, w) = 1;
    }
    // deferred sendto-EAGAIN: clear WRITABLE, park the stepper
    const bool park = STT_H(parkp) == 1;
    if (park) {
      const int64_t status = STT_C(c_status, c) & ~S_WRITABLE;
      STT_C(c_status, w) = status;
      STT_C(c_await, w) = S_WRITABLE;
      STT_C(c_awaitseq, w) = STT_H(park_ctr);
      STT_H(park_ctr) += 1;
      STT_H(parkp) = 0;
    }
    cont = park ? C_IDLE : ret;
  }

  // -------- app steppers / timers ---------------------------------

  static STT_LAW int64_t max_mem(int64_t bw, int64_t rtt, int64_t base) {
    const int64_t mem = floor_div_pos(mul_wrap(bw, rtt), 8 * 1000000000LL);
    return min64(max64(mem, base), 10 * base);
  }

  // One tcp_recv (client) / tcp_sendto (handler) per micro-op — the
  // engine app loop with syscalls counted at the same points.
  STT_LAW void op_app() {
    const Conn c = crd(), w = cwr();
    const int64_t role = STT_C(c_role, c);
    if (role == 0) {  // ---- client: recv 64 KiB or park ----
      STT_H_ASYS(ASYS_RECV) += 1;
      if (STT_C(c_rblen, c) == 0) {
        STT_C(c_await, w) = S_READABLE;
        STT_C(c_awaitseq, w) = STT_H(park_ctr);
        STT_H(park_ctr) += 1;
        cont = C_IDLE;
        return;
      }
      const int64_t take = min64(STT_C(c_rblen, c), 1 << 16);
      const int64_t win_before = recv_window(c);
      STT_C(c_rblen, w) = STT_C(c_rblen, c) - take;
      if (win_before < MSS && recv_window(c) >= MSS) emit_ack();
      // autotune_recv (socket_tcp.py twin)
      if (STT_C(c_rat, c) == 1) {
        const int64_t copied = STT_C(c_atcopied, c) + take;
        const int64_t at_space = max64(STT_C(c_atspace, c), 2 * copied);
        const bool grow = at_space > STT_C(c_rbmax, c);
        const int64_t nw =
            min64(at_space,
                  max_mem(STT_H(bw_down), STT_C(c_srtt, c), RMEM_MAX));
        STT_C(c_atcopied, w) = copied;
        STT_C(c_atspace, w) = at_space;
        if (grow && nw > STT_C(c_rbmax, c)) STT_C(c_rbmax, w) = nw;
        const bool fresh = STT_C(c_atlast, c) == 0;
        if (fresh) STT_C(c_atlast, w) = now;
        if (!fresh && STT_C(c_srtt, c) > 0 &&
            now - STT_C(c_atlast, c) > STT_C(c_srtt, c)) {
          STT_C(c_atlast, w) = now;
          STT_C(c_atcopied, w) = 0;
        }
      }
      const int64_t ngot = STT_C(c_agot, c) + take;
      STT_C(c_agot, w) = ngot;
      // transfer completion leaves the modelled domain (close)
      at_ = 1;
      if (ngot >= STT_C(c_atotal, c)) abort_(AB_STRUCT, 9);
      ret = C_APP;
      cont = C_FLUSH;
      return;
    }
    if (role != 1) return;
    // ---- handler: send up to 64 KiB or park ----
    STT_H_ASYS(ASYS_SEND) += 1;
    const int64_t want = min64(STT_C(c_atotal, c) - STT_C(c_agot, c), 1 << 16);
    const int64_t space = STT_C(c_sbmax, c) - STT_C(c_sblen, c);
    const int64_t wr = max64(min64(want, space), 0);
    ret = C_APP;
    if (wr == 0) {
      STT_H(parkp) = 1;
      cont = C_FLUSH;
      return;
    }
    const int64_t nsent = STT_C(c_agot, c) + wr;
    STT_C(c_sblen, w) = STT_C(c_sblen, c) + wr;
    STT_C(c_agot, w) = nsent;
    // send completion -> shutdown_wr: out of the domain
    at_ = 2;
    if (nsent >= STT_C(c_atotal, c)) abort_(AB_STRUCT, 10);
    cont = C_PUSH;
  }

  // TK_TCP fire: stale entries re-arm; due deadlines run delack /
  // persist / RTO in the engine's fixed order, then the flush chain.
  STT_LAW void op_tmr() {
    const Conn c = crd(), w = cwr();
    STT_C(c_tmrdl, w) = -1;
    const int64_t nxt = next_deadline(c);
    const bool have = nxt < I64_MAX;
    if (!(have && now >= nxt)) {  // stale
      if (have) {
        STT_C(c_tmrdl, w) = nxt;
        const int64_t sq = draw_seq();
        th_push(nxt, sq, TK_TCP, cur);
      }
      cont = C_IDLE;
      return;
    }
    // ---- on_timer ----
    if (STT_C(c_delackdl, c) >= 0 && now >= STT_C(c_delackdl, c)) {
      at_ = 1;
      emit_ack();
    }
    if (STT_C(c_persistdl, c) >= 0 && now >= STT_C(c_persistdl, c)) {
      STT_C(c_persistdl, w) = -1;
      if (STT_C(c_sndwnd, c) == 0 && STT_C(c_sblen, c) > 0 &&
          !rtx_nonempty(c)) {
        at_ = 2;
        emit(STT_C(c_sndnxt, c), 1, F_ACK | F_PSH, false, true, true);
        const int64_t sb = STT_C(c_sblen, c) - 1;
        const int64_t nx = s_add(STT_C(c_sndnxt, c), 1);
        STT_C(c_sblen, w) = sb;
        STT_C(c_sndnxt, w) = nx;
        fct_touch(1, false);
        const int64_t niv = min64(
            STT_C(c_persistiv, c) > 0 ? 2 * STT_C(c_persistiv, c)
                                      : STT_C(c_rto, c),
            MAX_RTO_NS);
        STT_C(c_persistiv, w) = niv;
        STT_C(c_persistdl, w) = now + niv;
      }
    }
    // RTO
    if (STT_C(c_rtodl, c) >= 0 && now >= STT_C(c_rtodl, c)) {
      if (!rtx_nonempty(c)) {
        STT_C(c_rtodl, w) = -1;
      } else {
        const int64_t flight = s_sub(STT_C(c_sndnxt, c), STT_C(c_snduna, c));
        const int64_t ssth =
            max64(floor_div_pos(flight, 2), 2 * STT_C(c_congmss, c));
        const int64_t cw = STT_C(c_congmss, c);
        STT_C(c_ssthresh, w) = ssth;
        STT_C(c_cwnd, w) = cw;
        STT_C(c_dupacks, w) = 0;
        STT_C(c_fastrec, w) = 0;
        // SACK reneging: forget every mark on RTO
        STT_PF_BEGIN(rn);
        scan(SCAN_RENEGE, w);
        STT_PF_HELPER(rn, H_RTX);
        STT_PF_VISIT(V_RTX, p.cap_rt);
        const int64_t rto = min64(2 * STT_C(c_rto, c), MAX_RTO_NS);
        STT_C(c_rto, w) = rto;
        STT_C(c_rtobackoff, w) = STT_C(c_rtobackoff, c) + 1;
        at_ = 3;
        retransmit_one();
        STT_C(c_rtodl, w) = now + STT_C(c_rto, c);
      }
    }
    ret = C_IDLE;
    cont = C_FLUSH;
  }

  // -------- event pop ---------------------------------------------

  // The due event at `et` of an idle lane: an arrival (inbox -> CoDel
  // ring -> relay 2) or a timer.
  STT_LAW void op_pop_event(int64_t et, bool pick_ib, int64_t safe) {
    now = et;
    STT_H(events_run) += 1;
    const int64_t fault = STT_H(h_fault);
    const bool h_down = (fault & 1) != 0;
    if (pick_ib) {
      ib_pos += 1;
      Pk pk;
      for (int c = 0; c < kPk; c++) pk.v[c] = o.ib[c][i * p.cap_i + safe];
      STT_PF_WORDS(W_ROW, kPk);
      const int64_t size = pk.v[PK_PLEN] + TCP_TOTAL_HDR;
      if (fault != 0) {  // arrivals at a dead / link-down host die
        STT_H(pkts_dropped) += 1;
        drop_cause(h_down ? TEL_HOST_DOWN : TEL_LINK_DOWN);
        trace(et, TR_DRP, pk, h_down ? RSN_HOSTDOWN : RSN_LINKDOWN);
        return;
      }
      STT_H(enq_pkts) += 1;
      STT_H(enq_bytes) += size;
      if (cq_len - cq_pos >= CODEL_HARD_LIMIT) {
        STT_H(cd_dropped) += 1;
        STT_H(cd_drop_bytes) += size;
        STT_H(pkts_dropped) += 1;
        drop_cause(TEL_RTR_LIMIT);
        trace(et, TR_DRP, pk, RSN_RTRLIMIT);
        return;
      }
      if (cq_len - cq_pos >= p.cap_cq - 1) abort_(AB_STRUCT, 11);
      // DCTCP-K instantaneous marking law: an ECT(0) arrival meeting the
      // threshold (queue state BEFORE this enqueue, packets leg first)
      // is rewritten to CE and enqueued.
      if (pk.v[PK_ECN] == ECN_ECT0) {
        const bool mark_p = cq_len - cq_pos >= p.k_pkts;
        const bool mark_b = !mark_p && STT_H(codel_bytes) >= p.k_bytes;
        if (mark_p || mark_b) {
          STT_H(codel_marked) += 1;
          STT_H_MARK((mark_p ? MARK_THRESH_PKTS : MARK_THRESH_BYTES)) += 1;
          pk.v[PK_ECN] = ECN_CE;
        }
      }
      const int64_t slot = i * p.cap_cq + cq_len % p.cap_cq;
      for (int c = 0; c < kPk; c++) o.cq[c][slot] = pk.v[c];
      o.cq_enq[slot] = et;
      STT_PF_WORDS(W_ROW, kPk + 1);
      cq_len += 1;
      if (cq_len - cq_pos > STT_H(codel_peak))
        STT_H(codel_peak) = cq_len - cq_pos;
      STT_H(codel_bytes) += size;
      if (STT_H(r2_pending) == 0) {
        cont = C_R2;
        then = C_IDLE;
      }
      return;
    }
    // timer
    o.th_valid[i * p.cap_t + th_slot] = 0;
    th_ok = false;
    if (th_slot < th_free) th_free = th_slot;
    if (th_kept) {  // the popped entry is its rank's least kept
      const int r = (int)((th_slot / 8) % t_.size);
      const int64_t n = sh_.hn[r];
      if (n > 0 && sh_.hslot[r][0] == th_slot) {
        for (int64_t j = 1; j < n; j++) {
          sh_.ht[r][j - 1] = sh_.ht[r][j];
          sh_.hs[r][j - 1] = sh_.hs[r][j];
          sh_.hslot[r][j - 1] = sh_.hslot[r][j];
        }
        sh_.hn[r] = n - 1;
      } else {
        th_kept = false;
      }
    }
    if (h_down) return;  // a dead host's timers discard
    const int64_t slot = i * p.cap_t + th_slot;
    const int64_t kind = o.th_kind[slot], tgt = o.th_tgt[slot];
    STT_PF_WORDS(W_ROW, 3);
    if (kind == TK_RELAY && (tgt == 1 || tgt == 2)) {
      (tgt == 1 ? STT_H(r1_pending) : STT_H(r2_pending)) = 0;
      cont = tgt == 1 ? C_R1 : C_R2;
      then = C_IDLE;
    }
    at_ = 1;
    if (kind != TK_RELAY && tgt < 0) abort_(AB_STRUCT, 12);
    if (tgt >= 0 && kind == TK_TCP) {
      set_cur(conn_at(tgt));
      cont = C_TMR;
      ret = C_IDLE;
    } else if (tgt >= 0 && kind == TK_APP) {
      set_cur(conn_at(tgt));
      STT_C(c_wakep, cwr()) = 0;
      STT_C(c_await, cwr()) = 0;
      cont = C_APP;
      ret = C_APP;
    }
  }

  // -------- the window --------------------------------------------

  // The lane's fused iterations until it is neither busy nor due before
  // the window's end, or past the least aborting iteration; then its hot
  // words and counts go back.
  STT_LAW void run() {
    s.chunk = 0;
    if (*o.abort_code != 0) return;  // the eager loop runs no iteration
    scan(SCAN_GATHER);
    cur_f_ = frame_words(fr_, cur);
    for (int64_t j = 0; j <= STT_ABORT_SEEN(o.stats + ST_AB_ITER); j++) {
      j_ = j;
      if (cont == C_IDLE) {  // a busy lane does not pop
        STT_PF_BEGIN(test);
        const int64_t safe = min64(ib_pos, p.cap_i - 1);
        const int64_t ib_t =
            ib_len > ib_pos ? o.ib_time[i * p.cap_i + safe] : I64_MAX;
        STT_PF_WORDS(W_ROW, ib_len > ib_pos);
        th_min();
        const int64_t et = min64(ib_t, th_t);
        STT_PF_END(test, PF_PASS + P_TEST);
        if (et >= window_end) break;  // neither busy nor due
        const bool pick_ib = ib_t != th_t ? ib_t < th_t : ib_t < I64_MAX;
        STT_PF_BEGIN(pop);
        mark(P_POP, j);
        op_pop_event(et, pick_ib, safe);
        STT_PF_END(pop, PF_PASS + P_POP);
      }
#define STT_PASS(q, code, op)             \
  if (cont == (code)) {                   \
    STT_PF_BEGIN(pass);                   \
    mark((q), j);                         \
    op();                                 \
    STT_PF_END(pass, PF_PASS + (q));      \
  }
      STT_PASS(P_TMR, C_TMR, op_tmr)
      STT_PASS(P_APP, C_APP, op_app)
      STT_PASS(P_R2, C_R2, op_relay2)
      STT_PASS(P_TCPIN, C_TCPIN, op_tcpin)
      STT_PASS(P_DRAIN_A, C_DRAIN, op_drain)
      STT_PASS(P_DRAIN_B, C_DRAIN, op_drain)
      STT_PASS(P_ACK, C_ACKDATA, op_ackdata)
      STT_PASS(P_PUSH, C_PUSH, op_push)
      STT_PASS(P_FLUSH, C_FLUSH, op_flush)
      STT_PASS(P_R1A, C_R1, op_relay1)
      STT_PASS(P_R1B, C_R1, op_relay1)
      STT_PASS(P_ARM, C_ARM, op_arm)
#undef STT_PASS
      s.iters = (uint32_t)(j + 1);
      // Per-round runaway valve: a continuation-cycle bug must abort,
      // not spin.
      q_ = P_END;
      at_ = 0;
      if (j > kValve) abort_(AB_STRUCT, 13);
    }
    flush_bits();
    store();
    scan(SCAN_WRITEBACK);
#ifdef STT_TCP_PROFILE
    if (prof_)
      for (int w = 0; w < W_N; w++)
        prof_[PF_WORDS + w] += (int64_t)(pfw_[w >> 1] >> (32 * (w & 1)) &
                                         0xFFFFFFFFu);
#endif
  }
};

// The window's abort words settled into abort_code / abort_site once
// every lane is done (see the header; the kernel's last block, the host
// build's driver), each left at I64_MAX for the next launch.
STT_LAW void settle_abort(const Ops& o) {
  int64_t* const st = o.stats;
  const int64_t j = STT_LOAD(st + ST_AB_ITER);
  if (j != I64_MAX) {
    int64_t bits = 0;
    const int64_t bit_of[3] = {AB_TRACE, AB_OUT, AB_STRUCT};
    for (int b = 0; b < 3; b++)
      if (STT_LOAD(st + ST_AB_BITS + b) == j) bits |= bit_of[b];
    *o.abort_code |= bits;
    const int64_t key = STT_LOAD(st + ST_AB_SITE);
    if (key != I64_MAX && (key >> 24) == j && *o.abort_site == 0)
      *o.abort_site = key & 0xff;
  }
  for (int w = ST_AB_ITER; w <= ST_AB_SITE; w++) st[w] = I64_MAX;
}

#ifndef __CUDACC__
// The host build: every lane in turn, each by a team of `team` ranks
// run in turn (`after(lane)` right after each lane's window, with the
// team's scratch), then the window's counts, as the kernel's last block
// settles them.  Returns 0, or 1 for a reassembly row wider than the
// SACK staging or a team outside [1, kTeamMax].
template <class After>
inline int window_serial(const Ops& o, const Params& p, int team,
                         After after) {
  if (p.cap_ra > kSackMax || team < 1 || team > kTeamMax) return 1;
  const Team t = {team};
  TeamScratch sh;
  int64_t win_max = 0;
  for (int64_t i = 0; i < p.n; i++) {
    LaneStats s = {};
    Lane lane(o, p, i, s, t, sh);
    lane.run();
    after(lane, sh);
    for (int q = 0; q < kPasses; q++)
      o.stats[ST_LANES + pass_slot(q)] += s.lanes[q];
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
  settle_abort(o);
  return 0;
}

inline int window_serial(const Ops& o, const Params& p, int team = 1) {
  return window_serial(o, p, team, [](Lane&, TeamScratch&) {});
}
#endif

}  // namespace tcp
}  // namespace stt
