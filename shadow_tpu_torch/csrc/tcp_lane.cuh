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
// Plain C++ apart from the STT_LAW qualifiers and the shared-word
// macros below (device atomics under __CUDACC__, plain operations in
// the host build), so the tier-1 tests build this header with the system
// C++ compiler and run the lanes serially (`window_serial`).

#pragma once

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
#else
#define STT_CLAIM(ctr) ((*(ctr))++)
#define STT_ABORT(word, key) \
  (*(word) = (key) < *(word) ? (key) : *(word))
#define STT_OR32(word, bits) (*(word) |= (bits))
#define STT_ABORT_SEEN(word) (*(word))
#define STT_CTZ64(v) __builtin_ctzll(v)
#define STT_LOAD(ptr) (*(ptr))
#endif

namespace stt {
namespace tcp {

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
// each).  N_PASSES is the bitmaps' row count.
#define STT_TCP_STATS(X)                                                 \
  X(ST_FIRES, 0) X(ST_LANES, 12) X(ST_CALLS, 24) X(ST_ITERS, 26)         \
  X(ST_WIN_MAX, 27) X(ST_DONE, 28) X(ST_AB_ITER, 29) X(ST_AB_BITS, 30)   \
  X(ST_AB_SITE, 33) X(ST_N, 34) X(N_PASSES, 13) X(CALL_BUCKET, 0)        \
  X(CALL_CODEL, 1)
STT_TCP_STATS(STT_TCP_CONST_DEF)
constexpr char kStats[] = STT_TCP_STATS(STT_TCP_CONST_NAME);
static_assert(ST_LANES == ST_FIRES + KS_N && ST_CALLS == ST_LANES + KS_N &&
                  ST_AB_SITE == ST_AB_BITS + 3 && N_PASSES == kPasses,
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

struct Pk {
  int64_t v[kPk];
};

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

// One host lane: `o` and `p` are the window's tables, `i` the lane.  The
// hot words live in members for the window; every other column is read
// and written in memory at the lane's own rows.
struct Lane {
  const Ops& o;
  const Params& p;
  const int64_t i;
  LaneStats& s;
  const int64_t window_end;
  const RelayParams rp;  // the relay cores' constants
  int64_t now, cont, then, ret, cur, event_seq, packet_seq;
  int64_t ib_len, ib_pos, cq_pos, cq_len;
  // The timer heap's minimum (time, seq, slot), valid while th_ok; and
  // the count of 8-slot words of the row that may hold a valid entry
  // (-1 until the first scan).
  int64_t th_t, th_s, th_slot, th_words;
  bool th_ok;
  // Where the lane is, for the abort keys: iteration, pass, place.
  int64_t j_;
  int q_, at_;

  STT_LAW Lane(const Ops& o_, const Params& p_, int64_t i_, LaneStats& s_)
      : o(o_), p(p_), i(i_), s(s_), window_end(p_.window_end),
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
    th_ok = false;
    th_words = -1;
    th_t = th_s = th_slot = 0;
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
  STT_LAW int64_t crd() const { return clamp64(cur, 0, p.conns - 1); }
  STT_LAW int64_t cwr() const { return cur >= 0 ? cur : p.conns; }

  STT_LAW bool rtx_nonempty(int64_t c) const {
    return o.rtx_len[c] > o.rtx_pos[c];
  }

  STT_LAW int64_t recv_window(int64_t c) const {
    const int64_t cap = shl(MAX_WINDOW, o.c_ourws[c]);
    const int64_t space = max64(o.c_rbmax[c] - o.c_rblen[c], 0);
    return min64(cap, space);
  }

  STT_LAW int64_t wire_window(int64_t c) const {
    // non-SYN segments only in-domain: always scaled
    return min64(shr(recv_window(c), o.c_ourws[c]), MAX_WINDOW);
  }

  STT_LAW int64_t next_deadline(int64_t c) const {
    int64_t nxt = I64_MAX;
    const int64_t d[3] = {o.c_rtodl[c], o.c_delackdl[c], o.c_persistdl[c]};
    for (int k = 0; k < 3; k++)
      if (d[k] >= 0 && d[k] < nxt) nxt = d[k];
    return nxt;
  }

  STT_LAW void fct_touch(int64_t nbytes, bool inbound) {
    const int64_t c = crd(), w = cwr();
    const int64_t fb = o.c_fbyte[c];
    const int64_t b = (inbound ? o.c_bin : o.c_bout)[c] + nbytes;
    o.c_fbyte[w] = fb < 0 ? now : fb;
    o.c_lbyte[w] = now;
    (inbound ? o.c_bin : o.c_bout)[w] = b;
  }

  // -------- primitive helpers -------------------------------------

  STT_LAW int64_t draw_seq() { return event_seq++; }

  // The first free slot of a bool row (`words` words of 8; -1 if full;
  // every slot from 8 * scan on is free).
  static STT_LAW int64_t first_free(const uint8_t* row, int64_t words,
                                    int64_t scan) {
    constexpr uint64_t kOnes = 0x0101010101010101ull;
    for (int64_t w = 0; w < scan; w++) {
      const uint64_t v = load8(row + 8 * w);
      if (v != kOnes)
        for (int b = 0; b < 8; b++)
          if (((v >> (8 * b)) & 0xff) == 0) return 8 * w + b;
    }
    return scan < words ? 8 * scan : -1;
  }

  STT_LAW void th_push(int64_t t, int64_t seq, int64_t kind, int64_t tgt) {
    const int64_t row = i * p.cap_t;
    const int64_t words = p.cap_t / 8;
    const int64_t k =
        first_free(o.th_valid + row, words, th_words < 0 ? words : th_words);
    if (k < 0) {  // a full heap writes nothing
      abort_(AB_STRUCT, 1);
      return;
    }
    o.th_time[row + k] = t;
    o.th_seq[row + k] = seq;
    o.th_kind[row + k] = kind;
    o.th_tgt[row + k] = tgt;
    o.th_valid[row + k] = 1;
    if (th_words >= 0 && k / 8 + 1 > th_words) th_words = k / 8 + 1;
    // (time, seq) is unique per host: the new entry is the minimum
    // exactly when it sorts before the cached one.
    if (th_ok && (t < th_t || (t == th_t && seq < th_s))) {
      th_t = t;
      th_s = seq;
      th_slot = k;
    }
  }

  // The earliest timer (time, then seq; the first slot on ties), as
  // th_min's masked argmin picks it; (I64_MAX, ...) on an empty heap,
  // whose slot is never popped.
  STT_LAW void th_min() {
    if (th_ok && p.th_cache) return;
    const int64_t row = i * p.cap_t;
    const int64_t words = th_words < 0 ? p.cap_t / 8 : th_words;
    int64_t bt = I64_MAX, bs = I64_MAX, slot = 0, last = 0;
    for (int64_t w = 0; w < words; w++) {
      uint64_t v = load8(o.th_valid + row + 8 * w);
      if (v) last = w + 1;
      while (v) {
        const int b = STT_CTZ64(v) >> 3;
        v &= ~((uint64_t)0xff << (8 * b));
        const int64_t k = 8 * w + b;
        const int64_t t = o.th_time[row + k];
        if (t < bt || (t == bt && o.th_seq[row + k] < bs)) {
          bt = t;
          bs = o.th_seq[row + k];
          slot = k;
        }
      }
    }
    th_words = last;
    th_t = bt;
    th_s = bs;
    th_slot = slot;
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

  STT_LAW void drop_cause(int tel) { o.drop_causes[i * TEL_N + tel] += 1; }

  // -------- TCP helpers (connection.py twins) ---------------------

  // The first valid reassembly slot of conn c starting at `seq` (-1 if
  // none), eight slots a word: the rows are mostly empty.
  STT_LAW int64_t ra_find(int64_t c, int64_t seq) const {
    const int64_t row = c * p.cap_ra;
    for (int64_t w = 0; w < p.cap_ra / 8; w++) {
      uint64_t v = load8(o.ra_valid + row + 8 * w);
      while (v) {
        const int b = STT_CTZ64(v) >> 3;
        v &= ~((uint64_t)0xff << (8 * b));
        if (o.ra_seq[row + 8 * w + b] == seq) return 8 * w + b;
      }
    }
    return -1;
  }

  // Merged reassembly runs of conn c (connection.py _sack_blocks): the
  // eager loop sorts the valid entries by their distance from rcv_nxt
  // and starts a run at an entry beyond every earlier end.  A run is so
  // the interval [start, end] closed under "an entry starting within it
  // extends it": its start the least distance past the previous run's
  // end, its end the fixpoint of the entries starting inside.  The sort's
  // order among equal starts changes neither, so none is kept.  `sk`
  // gets (nsk, s0, e0, s1, e1, s2, e2), zeros for absent runs.
  STT_LAW void sack_blocks(int64_t c, int64_t* sk) const {
    const int64_t row = c * p.cap_ra;
    const uint8_t* const valid = o.ra_valid + row;
    const int64_t words = p.cap_ra / 8;
    const int64_t rcvnxt = o.c_rcvnxt[c];
    for (int k = 0; k < 7; k++) sk[k] = 0;
    int64_t prev_end = 0;
    for (int r = 0; r < 3; r++) {
      int64_t start = I64_MAX;
      bool found = false;
      for (int64_t w = 0; w < words; w++) {
        uint64_t v = load8(valid + 8 * w);
        while (v) {
          const int b = STT_CTZ64(v) >> 3;
          v &= ~((uint64_t)0xff << (8 * b));
          const int64_t rel = s_sub(o.ra_seq[row + 8 * w + b], rcvnxt);
          if ((r == 0 || rel > prev_end) && (!found || rel < start)) {
            start = rel;
            found = true;
          }
        }
      }
      if (!found) break;
      int64_t end = start;
      for (bool grew = true; grew;) {
        grew = false;
        for (int64_t w = 0; w < words; w++) {
          uint64_t v = load8(valid + 8 * w);
          while (v) {
            const int b = STT_CTZ64(v) >> 3;
            v &= ~((uint64_t)0xff << (8 * b));
            const int64_t k = row + 8 * w + b;
            const int64_t rel = s_sub(o.ra_seq[k], rcvnxt);
            const int64_t e = rel + o.ra_plen[k];
            if (rel >= start && rel <= end && e > end) {
              end = e;
              grew = true;
            }
          }
        }
      }
      sk[0] = r + 1;
      sk[1 + 2 * r] = s_add(rcvnxt, start);
      sk[2 + 2 * r] = s_add(rcvnxt, end);
      prev_end = end;
    }
  }

  // One segment from the lane's conn into its egress ring (emission
  // order IS flush order); every in-domain emission carries ACK, echoes
  // ECE, and fresh data consumes a pending one-shot CWR.
  STT_LAW void emit(int64_t tseq, int64_t plen, int64_t flags,
                    bool with_sacks, bool track, bool fresh) {
    const int64_t c = crd(), w = cwr();
    const int64_t win = wire_window(c);
    int64_t sk[7] = {0, 0, 0, 0, 0, 0, 0};
    if (with_sacks) sack_blocks(c, sk);
    const int64_t tse = o.c_tsrecent[c];
    o.c_tsrecent[w] = 0;
    int64_t fl = flags | (o.c_ece[c] == 1 ? F_ECE : 0);
    if (fresh && plen > 0 && o.c_cwrp[c] == 1 && o.c_ecnact[c] == 1) {
      fl |= F_CWR;
      o.c_cwrp[w] = 0;
    }
    const int64_t ecn = (o.c_ecnact[c] == 1 && plen > 0) ? ECN_ECT0 : 0;
    const int64_t pseq = packet_seq++;
    const int64_t len = o.op_len[c];
    if (len - o.op_pos[c] >= p.cap_op - 1) abort_(AB_STRUCT, 2);
    const int64_t slot = w * p.cap_op + len % p.cap_op;
    const int64_t vals[kPk] = {
        i,      pseq,   o.c_lip[c], o.c_lport[c], o.c_pip[c],
        o.c_pport[c], tseq, o.c_rcvnxt[c], fl, win,
        now + 1, tse,   plen,   sk[0],  sk[1],
        sk[2],  sk[3],  sk[4],  sk[5],  sk[6],
        ecn};
    for (int k = 0; k < kPk; k++) o.op[k][slot] = vals[k];
    o.op_len[w] += 1;
    o.c_segssent[w] += 1;
    // note_ack_sent: segs_since_ack=0, delack cleared
    o.c_ssa[w] = 0;
    o.c_delackdl[w] = -1;
    o.eflag[i] = 1;
    if (track) {
      const int64_t rlen = o.rtx_len[c];
      if (rlen - o.rtx_pos[c] >= p.cap_rt - 1) abort_(AB_STRUCT, 3);
      const int64_t r = w * p.cap_rt + rlen % p.cap_rt;
      o.rtx_seq[r] = tseq;
      o.rtx_plen[r] = plen;
      o.rtx_rtxed[r] = 0;
      o.rtx_sacked[r] = 0;
      o.rtx_sent[r] = now;
      o.rtx_len[w] += 1;
      if (o.c_rtodl[c] < 0) o.c_rtodl[w] = now + o.c_rto[c];
    }
  }

  STT_LAW void emit_ack() {
    emit(o.c_sndnxt[crd()], 0, F_ACK, true, false, false);
  }

  STT_LAW void update_rtt(int64_t sample) {
    const int64_t c = crd(), w = cwr();
    sample = max64(sample, 1);
    const int64_t srtt = o.c_srtt[c], rttvar = o.c_rttvar[c];
    const bool first = srtt == 0;
    const int64_t n_srtt =
        first ? sample : floor_div_pos(7 * srtt + sample, 8);
    const int64_t err = srtt - sample < 0 ? sample - srtt : srtt - sample;
    const int64_t n_var =
        first ? floor_div_pos(sample, 2) : floor_div_pos(3 * rttvar + err, 4);
    const int64_t rto =
        clamp64(n_srtt + max64(4 * n_var, 1000000), MIN_RTO_NS, MAX_RTO_NS);
    o.c_srtt[w] = n_srtt;
    o.c_rttvar[w] = n_var;
    o.c_rto[w] = rto;
  }

  // Pop the leading fully-acked rtx entries (a ring-order run).
  STT_LAW void clear_acked() {
    const int64_t c = crd(), w = cwr();
    const int64_t pos = o.rtx_pos[c], n = o.rtx_len[c] - pos;
    const int64_t una = o.c_snduna[c];
    int64_t pops = 0;
    for (int64_t k = 0; k < n && k < p.cap_rt; k++) {
      const int64_t r = c * p.cap_rt + (pos + k) % p.cap_rt;
      if (!s_leq(s_add(o.rtx_seq[r], o.rtx_plen[r]), una)) break;
      pops += 1;
    }
    o.rtx_pos[w] = pos + pops;
  }

  // The first non-SACKed rtx entry (head fallback), re-stamped and
  // re-emitted with the current scoreboard attached.
  STT_LAW void retransmit_one() {
    const int64_t c = crd(), w = cwr();
    const int64_t pos = o.rtx_pos[c], n = o.rtx_len[c] - pos;
    if (n <= 0) return;  // nothing valid: nothing re-sent
    int64_t first = 0;
    for (int64_t k = 0; k < n && k < p.cap_rt; k++)
      if (o.rtx_sacked[c * p.cap_rt + (pos + k) % p.cap_rt] == 0) {
        first = k;
        break;
      }
    const int64_t slot = (pos + first) % p.cap_rt;
    const int64_t seq = o.rtx_seq[c * p.cap_rt + slot];
    const int64_t plen = o.rtx_plen[c * p.cap_rt + slot];
    o.rtx_sent[w * p.cap_rt + slot] = now;
    o.rtx_rtxed[w * p.cap_rt + slot] = 1;
    o.c_rtxcount[w] += 1;
    emit(seq, plen, F_ACK | F_PSH, true, false, false);
  }

  // -------- relays ------------------------------------------------

  STT_LAW Relay1Words r1_words() const {
    return {o.r1_pk_valid[i], o.r1_bal[i],       o.r1_next[i],
            o.r1_stalls[i],   o.r1_pending[i],   o.r1_fwd_pkts[i],
            o.r1_fwd_bytes[i], o.pkts_sent[i],   o.pkts_dropped[i],
            o.eth_psent[i],   o.eth_bsent[i],
            o.drop_causes[i * TEL_N + TEL_LINK_DOWN]};
  }

  STT_LAW void r1_store(const Relay1Words& a, const Relay1Words& b) const {
    STT_PUT_CHANGED(o.r1_pk_valid, i, a.pk_valid, b.pk_valid)
    STT_PUT_CHANGED(o.r1_bal, i, a.bal, b.bal)
    STT_PUT_CHANGED(o.r1_next, i, a.nxt, b.nxt)
    STT_PUT_CHANGED(o.r1_stalls, i, a.stalls, b.stalls)
    STT_PUT_CHANGED(o.r1_pending, i, a.pending, b.pending)
    STT_PUT_CHANGED(o.r1_fwd_pkts, i, a.fwd_pkts, b.fwd_pkts)
    STT_PUT_CHANGED(o.r1_fwd_bytes, i, a.fwd_bytes, b.fwd_bytes)
    STT_PUT_CHANGED(o.pkts_sent, i, a.pkts_sent, b.pkts_sent)
    STT_PUT_CHANGED(o.pkts_dropped, i, a.pkts_dropped, b.pkts_dropped)
    STT_PUT_CHANGED(o.eth_psent, i, a.eth_psent, b.eth_psent)
    STT_PUT_CHANGED(o.eth_bsent, i, a.eth_bsent, b.eth_bsent)
    STT_PUT_CHANGED(o.drop_causes, i * TEL_N + TEL_LINK_DOWN, a.drop_cause,
                    b.drop_cause)
  }

  // inet-out drain: iface_pop over the host's queued conns (min head
  // priority = the engine's per-iface qdisc heap; ties to the largest
  // row, as the eager scatter's amax), SND trace, token bucket,
  // cross-host outbox.
  STT_LAW void op_relay1() {
    const bool use_pend = o.r1_pk_valid[i] == 1;
    int64_t best = I64_MAX, sel = -1;
    for (int64_t k = o.conn_off[i]; k < o.conn_off[i + 1]; k++) {
      const int64_t c = o.conn_rows[k];
      const int64_t pos = o.op_pos[c];
      if (o.c_queued[c] != 1 || o.op_len[c] <= pos) continue;
      const int64_t hp = o.op[PK_PSEQ][c * p.cap_op + pos % p.cap_op];
      if (hp < best || (hp == best && c > sel)) {
        best = hp;
        sel = c;
      }
    }
    const bool pop = !use_pend && best < I64_MAX;
    const int64_t sel_safe = clamp64(sel, 0, p.conns - 1);
    Pk pk;
    if (use_pend) {
      for (int c = 0; c < kPk; c++) pk.v[c] = o.r1_pk[c][i];
    } else if (pop) {
      const int64_t slot = sel_safe * p.cap_op + o.op_pos[sel_safe] % p.cap_op;
      for (int c = 0; c < kPk; c++) pk.v[c] = o.op[c][slot];
    }
    const Relay1Words w0 = r1_words();
    Relay1Words w = w0;
    const RelayOut r =
        relay1_core(w, use_pend, pop, pk.v, now, o.h_fault[i],
                    o.r1_refill[i], o.r1_cap[i], o.r1_unlimited[i] == 1,
                    p.refill_ns, TCP_TOTAL_HDR);
    s.calls[CALL_BUCKET] += r.bucket_call;
    r1_store(w0, w);
    if (r.stash)
      for (int c = 0; c < kPk; c++) o.r1_pk[c][i] = pk.v[c];
    if (pop) {  // iface_pop: dequeue + requeue-if-more + SND trace
      const int64_t wr = sel;
      o.op_pos[wr] += 1;
      o.c_queued[wr] = o.op_len[sel_safe] > o.op_pos[sel_safe] ? 1 : 0;
      trace(now, TR_SND, pk, 0);
    }
    if (r.throttled) {
      const int64_t sq = draw_seq();
      th_push(r.when, sq, TK_RELAY, 1);
    }
    if (r.linkdn) trace(now, TR_DRP, pk, RSN_LINKDOWN);
    if (r.fwd) {  // device_push(dev=2): dst must be a remote engine host
      const int64_t dip = pk.v[PK_DIP];
      const int64_t dslot = min64(search_left(o.ips_sorted, p.n, dip), p.n - 1);
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
    return {o.r2_pk_valid[i],
            cq_pos,
            o.codel_bytes[i],
            {o.first_above[i], o.dropping[i], o.chain[i], o.sniff[i],
             o.count[i], o.last_count[i], o.drop_next[i]},
            o.cd_dropped[i],
            o.cd_drop_bytes[i],
            o.pkts_dropped[i],
            o.drop_causes[i * TEL_N + TEL_CODEL],
            o.r2_bal[i],
            o.r2_next[i],
            o.r2_stalls[i],
            o.r2_pending[i],
            o.r2_fwd_pkts[i],
            o.r2_fwd_bytes[i],
            o.eth_precv[i],
            o.eth_brecv[i]};
  }

  STT_LAW void r2_store(const Relay2Words& a, const Relay2Words& b) {
    cq_pos = b.cq_pos;
    STT_PUT_CHANGED(o.r2_pk_valid, i, a.pk_valid, b.pk_valid)
    STT_PUT_CHANGED(o.codel_bytes, i, a.codel_bytes, b.codel_bytes)
    STT_PUT_CHANGED(o.first_above, i, a.cw.first_above, b.cw.first_above)
    STT_PUT_CHANGED(o.dropping, i, a.cw.dropping, b.cw.dropping)
    STT_PUT_CHANGED(o.chain, i, a.cw.chain, b.cw.chain)
    STT_PUT_CHANGED(o.sniff, i, a.cw.sniff, b.cw.sniff)
    STT_PUT_CHANGED(o.count, i, a.cw.count, b.cw.count)
    STT_PUT_CHANGED(o.last_count, i, a.cw.last_count, b.cw.last_count)
    STT_PUT_CHANGED(o.drop_next, i, a.cw.drop_next, b.cw.drop_next)
    STT_PUT_CHANGED(o.cd_dropped, i, a.dropped, b.dropped)
    STT_PUT_CHANGED(o.cd_drop_bytes, i, a.drop_bytes, b.drop_bytes)
    STT_PUT_CHANGED(o.pkts_dropped, i, a.pkts_dropped, b.pkts_dropped)
    STT_PUT_CHANGED(o.drop_causes, i * TEL_N + TEL_CODEL, a.drop_cause,
                    b.drop_cause)
    STT_PUT_CHANGED(o.r2_bal, i, a.bal, b.bal)
    STT_PUT_CHANGED(o.r2_next, i, a.nxt, b.nxt)
    STT_PUT_CHANGED(o.r2_stalls, i, a.stalls, b.stalls)
    STT_PUT_CHANGED(o.r2_pending, i, a.pending, b.pending)
    STT_PUT_CHANGED(o.r2_fwd_pkts, i, a.fwd_pkts, b.fwd_pkts)
    STT_PUT_CHANGED(o.r2_fwd_bytes, i, a.fwd_bytes, b.fwd_bytes)
    STT_PUT_CHANGED(o.eth_precv, i, a.eth_precv, b.eth_precv)
    STT_PUT_CHANGED(o.eth_brecv, i, a.eth_brecv, b.eth_brecv)
  }

  // inet-in drain: CoDel pop -> token bucket -> iface_receive -> conn
  // match -> hand to C_TCPIN.
  STT_LAW void op_relay2() {
    const bool use_pend = o.r2_pk_valid[i] == 1;
    const bool pop = !use_pend && cq_len > cq_pos;
    Pk pk;
    int64_t enq = 0;
    if (use_pend) {
      for (int c = 0; c < kPk; c++) pk.v[c] = o.r2_pk[c][i];
    } else if (pop) {
      const int64_t slot = i * p.cap_cq + cq_pos % p.cap_cq;
      for (int c = 0; c < kPk; c++) pk.v[c] = o.cq[c][slot];
      enq = o.cq_enq[slot];
    }
    const Relay2Words w0 = r2_words();
    Relay2Words w = w0;
    const RelayOut r =
        relay2_core(w, use_pend, pop, pk.v, enq, now, o.r2_refill[i],
                    o.r2_cap[i], o.r2_unlimited[i] == 1, rp);
    s.calls[CALL_BUCKET] += r.bucket_call;
    s.calls[CALL_CODEL] += r.codel_call;
    r2_store(w0, w);
    if (r.stash)
      for (int c = 0; c < kPk; c++) o.r2_pk[c][i] = pk.v[c];
    if (r.codel_drop) trace(now, TR_DRP, pk, RSN_CODEL);
    if (r.throttled) {
      const int64_t sq = draw_seq();
      th_push(r.when, sq, TK_RELAY, 2);
    }
    if (r.fwd) {
      at_ = 1;
      if (pk.v[PK_DIP] != o.eth_ip[i]) abort_(AB_STRUCT, 5);
      // conn lookup: (dsthost, src-ip-host, sport) key
      const int64_t sip = pk.v[PK_SIP];
      const int64_t sslot = min64(search_left(o.ips_sorted, p.n, sip), p.n - 1);
      const bool sfound = o.ips_sorted[sslot] == sip;
      const int64_t sidx = o.ips_perm[sslot];
      const int64_t akey = (i * p.n + sidx) * 65536 + pk.v[PK_SPORT];
      const int64_t kslot =
          min64(search_left(o.ckeys, p.conns, akey), p.conns - 1);
      const bool kfound = sfound && o.ckeys[kslot] == akey;
      const int64_t conn = o.ckperm[kslot];
      const bool good = kfound && o.c_lport[conn] == pk.v[PK_DPORT];
      at_ = 2;
      if (!good) abort_(AB_STRUCT, 6);
      if (good) {  // delivered: trace RCV at arrival, hand to C_TCPIN
        o.pkts_recv[i] += 1;
        trace(now, TR_RCV, pk, 0);
        cur = conn;
        for (int c = 0; c < kPk; c++) o.ar[c][i] = pk.v[c];
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
    const int64_t c = crd(), w = cwr();
    Pk pk;
    for (int k = 0; k < kPk; k++) pk.v[k] = o.ar[k][i];
    const int64_t plen = pk.v[PK_PLEN], tfl = pk.v[PK_TFLAGS];
    const int64_t tseq = pk.v[PK_TSEQ], ack = pk.v[PK_TACK];
    o.c_segsrecv[w] = o.c_segsrecv[c] + 1;
    // in-domain wire: synchronized-state segments only; a data segment
    // arriving at a sender (or acking unsent data) leaves the modelled
    // tgen roles
    if ((tfl & (F_SYN | F_FIN | F_RST)) != 0 || (tfl & F_ACK) == 0 ||
        (plen > 0 && o.c_role[c] == 1) || s_lt(o.c_sndnxt[c], ack))
      abort_(AB_STRUCT, 7);
    // RFC 3168 receiver: CWR ends the echo episode, a CE-marked arrival
    // (re)starts it — in that order.
    const bool ecnact = o.c_ecnact[c] == 1;
    if (ecnact && (tfl & F_CWR) != 0) o.c_ece[w] = 0;
    if (ecnact && pk.v[PK_ECN] == ECN_CE) {
      const int64_t seen = o.c_ceseen[c] + 1;
      o.c_ece[w] = 1;
      o.c_ceseen[w] = seen;
    }
    // RFC 7323 ts_recent update (covering the ack point)
    const int64_t span = max64(plen, 1);
    if (pk.v[PK_TSV] != 0 && s_leq(tseq, o.c_rcvnxt[c]) &&
        s_lt(o.c_rcvnxt[c], s_add(tseq, span)))
      o.c_tsrecent[w] = pk.v[PK_TSV];
    // RTTM: sample only from a segment acking NEW data
    if (pk.v[PK_TSE] != 0 && o.c_rtobackoff[c] == 0 &&
        s_lt(o.c_snduna[c], ack) && s_leq(ack, o.c_sndnxt[c]))
      update_rtt(now - (pk.v[PK_TSE] - 1));
    // ---- on_ack ----
    const int64_t wnd = shl(pk.v[PK_TWIN], o.c_peerws[c]);
    const bool wchanged = wnd != o.c_sndwnd[c];
    o.c_sndwnd[w] = wnd;
    if (wnd > 0 && o.c_persistdl[c] >= 0) {
      o.c_persistdl[w] = -1;
      o.c_persistiv[w] = 0;
    }
    // SACK scoreboard marks
    const int64_t nsk = pk.v[PK_NSK];
    if (nsk > 0) {
      const int64_t pos = o.rtx_pos[c], n = o.rtx_len[c] - pos;
      int64_t newly = 0;
      for (int64_t k = 0; k < n && k < p.cap_rt; k++) {
        const int64_t slot = (pos + k) % p.cap_rt;
        const int64_t seq = o.rtx_seq[c * p.cap_rt + slot];
        const int64_t end = s_add(seq, o.rtx_plen[c * p.cap_rt + slot]);
        bool cov = false;
        for (int b = 0; b < 3; b++)
          cov = cov || (nsk > b && s_leq(pk.v[PK_SK0S + 2 * b], seq) &&
                        s_leq(end, pk.v[PK_SK0E + 2 * b]));
        if (cov && o.rtx_sacked[c * p.cap_rt + slot] == 0) {
          o.rtx_sacked[w * p.cap_rt + slot] = 1;
          newly += 1;
        }
      }
      o.c_sackskip[w] = o.c_sackskip[c] + newly;
    }
    // ECN sender side: after the SACK marks, before the new-ack/dupack
    // dispatch (snd_una still pre-ack).
    const bool ece_fl = ecnact && (tfl & F_ECE) != 0;
    const bool new_ack0 = s_lt(o.c_snduna[c], ack);
    const int64_t acked0 = s_sub(ack, o.c_snduna[c]);
    const bool is_d = o.c_cc[c] == CC_DCTCP;
    const bool acc = new_ack0 && ecnact && is_d;
    if (acc) {
      const int64_t tot = o.c_totack[c] + acked0;
      const int64_t ce = o.c_ceack[c] + (ece_fl ? acked0 : 0);
      o.c_totack[w] = tot;
      o.c_ceack[w] = ce;
    }
    // window boundary: fold the echo fraction into alpha
    if (acc && s_lt(o.c_dwend[c], ack)) {
      const int64_t alpha = o.c_alpha[c];
      const int64_t nalpha = min64(
          alpha - (alpha >> DCTCP_G_SHIFT) +
              floor_div_pos(o.c_ceack[c] << (DCTCP_SHIFT - DCTCP_G_SHIFT),
                            max64(o.c_totack[c], 1)),
          DCTCP_MAX_ALPHA);
      const int64_t dwend = o.c_sndnxt[c];
      o.c_alpha[w] = nalpha;
      o.c_ceack[w] = 0;
      o.c_totack[w] = 0;
      o.c_dwend[w] = dwend;
    }
    // one cut per window; CWR announces it on fresh data
    const bool red =
        ece_fl && o.c_fastrec[c] == 0 && s_lt(o.c_cwrend[c], ack);
    if (red) {
      const int64_t mss_e = o.c_congmss[c];
      const int64_t flight0 = s_sub(o.c_sndnxt[c], o.c_snduna[c]);
      const int64_t cw0 = o.c_cwnd[c];
      const int64_t r_cw = max64(floor_div_pos(flight0, 2), 2 * mss_e);
      const int64_t d_cw = max64(
          cw0 - (mul_wrap(cw0, o.c_alpha[c]) >> (DCTCP_SHIFT + 1)),
          2 * mss_e);
      const int64_t ncw = is_d ? d_cw : r_cw;
      const int64_t cwrend = o.c_sndnxt[c];
      o.c_cwnd[w] = ncw;
      o.c_ssthresh[w] = ncw;
      o.c_cwrend[w] = cwrend;
      o.c_cwrp[w] = 1;
    }
    // new ack / dupack
    const bool rtx_ne = rtx_nonempty(c);
    const bool new_ack = s_lt(o.c_snduna[c], ack);
    const bool dup = !new_ack && ack == o.c_snduna[c] && rtx_ne &&
                     plen == 0 && !wchanged;
    const int64_t acked = s_sub(ack, o.c_snduna[c]);
    bool in_rec = false;
    if (new_ack) {  // handle_new_ack
      o.c_snduna[w] = ack;
      o.c_dupacks[w] = 0;
      o.c_rtobackoff[w] = 0;
      clear_acked();
      if (o.c_srtt[c] > 0)
        o.c_rto[w] = clamp64(o.c_srtt[c] + max64(4 * o.c_rttvar[c], 1000000),
                             MIN_RTO_NS, MAX_RTO_NS);
      in_rec = o.c_fastrec[c] == 1;
      const bool rec_exit =
          in_rec && (s_lt(o.c_recover[c], ack) || ack == o.c_recover[c]);
      if (rec_exit) {
        const int64_t ss = o.c_ssthresh[c];
        o.c_fastrec[w] = 0;
        o.c_cwnd[w] = ss;
      }
      if (in_rec && !rec_exit) {  // partial ack
        at_ = 1;
        retransmit_one();
      }
      // reno on_new_ack (not in recovery; an ack that just triggered
      // the ECN cut must not also grow the window)
      if (!in_rec && !red) {
        const int64_t mss_c = o.c_congmss[c], cwnd = o.c_cwnd[c];
        const int64_t cwnd2 =
            cwnd < o.c_ssthresh[c]
                ? cwnd + min64(acked, 2 * mss_c)
                : cwnd + max64(floor_div_pos(mss_c * mss_c, max64(cwnd, 1)),
                               1);
        o.c_cwnd[w] = cwnd2;
      }
      // RTO restart
      o.c_rtodl[w] = rtx_nonempty(c) ? now + o.c_rto[c] : -1;
    }
    if (dup) {  // handle_dupack
      const int64_t dupacks = o.c_dupacks[c] + 1;
      o.c_dupacks[w] = dupacks;
      const bool d_rec = o.c_fastrec[c] == 1;
      if (d_rec) o.c_cwnd[w] = o.c_cwnd[c] + o.c_congmss[c];
      if (!d_rec && o.c_dupacks[c] == 3) {
        const int64_t flight = s_sub(o.c_sndnxt[c], o.c_snduna[c]);
        const int64_t ssth =
            max64(floor_div_pos(flight, 2), 2 * o.c_congmss[c]);
        const int64_t recover = o.c_sndnxt[c];
        o.c_ssthresh[w] = ssth;
        o.c_fastrec[w] = 1;
        o.c_recover[w] = recover;
        o.c_cwnd[w] = o.c_ssthresh[c] + 3 * o.c_congmss[c];
        at_ = 2;
        retransmit_one();
      }
    }
    // ---- on_data (receiver side; plen > 0) ----
    const bool data = plen > 0;
    const int64_t offset = s_sub(o.c_rcvnxt[c], tseq);
    const bool dup_data = data && offset >= plen;
    if (dup_data) {
      at_ = 3;
      emit_ack();
    }
    const bool live = data && !dup_data;
    const int64_t eff_seq = offset > 0 ? o.c_rcvnxt[c] : tseq;
    const int64_t eff_len = offset > 0 ? plen - offset : plen;
    const bool future = live && s_sub(eff_seq, o.c_rcvnxt[c]) != 0;
    // reassembly setdefault (bounded by the receive buffer)
    const int64_t row = c * p.cap_ra;
    if (future) {
      const bool exists = ra_find(c, eff_seq) >= 0;
      const bool in_win = s_sub(eff_seq, o.c_rcvnxt[c]) < o.c_rbmax[c];
      if (!in_win) drop_cause(TEL_REASM_FULL);  // receiver discard
      if (in_win && !exists) {
        const int64_t words = p.cap_ra / 8;
        const int64_t k = first_free(o.ra_valid + row, words, words);
        at_ = 4;
        if (k < 0) {
          abort_(AB_STRUCT, 8);
        } else {
          o.ra_seq[w * p.cap_ra + k] = eff_seq;
          o.ra_plen[w * p.cap_ra + k] = eff_len;
          o.ra_valid[w * p.cap_ra + k] = 1;
        }
      }
      at_ = 5;
      emit_ack();
    }
    // in-order delivery
    const bool inord = live && !future;
    if (inord) {  // (nothing was stored: the reassembly row as it came)
      bool had_any = false;
      for (int64_t k = 0; k < p.cap_ra / 8 && !had_any; k++)
        had_any = load8(o.ra_valid + row + 8 * k) != 0;
      o.had_holes[i] = had_any ? 1 : 0;
      const int64_t space = o.c_rbmax[c] - o.c_rblen[c];
      const int64_t take = max64(min64(space, eff_len), 0);
      // in-order bytes past the receive buffer: unacked tail, the
      // sender retransmits (TcpConn::deliver twin)
      if (eff_len > take) drop_cause(TEL_RECVWIN_TRUNC);
      const int64_t rblen = o.c_rblen[c] + take;
      const int64_t rcvnxt = s_add(o.c_rcvnxt[c], take);
      o.c_rblen[w] = rblen;
      o.c_rcvnxt[w] = rcvnxt;
      if (take > 0) fct_touch(take, true);
    }
    // ---- continuation ----
    cont = inord ? C_DRAIN : (data ? C_FLUSH : C_PUSH);
  }

  // One reassembly chunk per micro-op (connection.py's
  // while-rcv_nxt-in-reassembly loop).
  STT_LAW void op_drain() {
    const int64_t c = crd(), w = cwr();
    const int64_t row = c * p.cap_ra, rcvnxt = o.c_rcvnxt[c];
    const int64_t slot = ra_find(c, rcvnxt);
    if (slot < 0) {
      cont = C_ACKDATA;
      return;
    }
    const int64_t plen = o.ra_plen[row + slot];
    const int64_t space = o.c_rbmax[c] - o.c_rblen[c];
    const int64_t take = max64(min64(space, plen), 0);
    if (plen > take) drop_cause(TEL_RECVWIN_TRUNC);
    const int64_t rblen = o.c_rblen[c] + take;
    o.c_rblen[w] = rblen;
    o.c_rcvnxt[w] = s_add(rcvnxt, take);
    if (take > 0) fct_touch(take, true);
    o.ra_valid[w * p.cap_ra + slot] = 0;
  }

  // ack_data: every second in-order segment acks now; holes or a
  // pinched window force it; else the 40ms delack.
  STT_LAW void op_ackdata() {
    const int64_t c = crd(), w = cwr();
    const int64_t ssa = o.c_ssa[c] + 1;
    o.c_ssa[w] = ssa;
    bool any_ra = false;
    for (int64_t k = 0; k < p.cap_ra / 8 && !any_ra; k++)
      any_ra = load8(o.ra_valid + c * p.cap_ra + 8 * k) != 0;
    const bool fire = o.had_holes[i] == 1 || o.c_ssa[c] >= 2 || any_ra ||
                      recv_window(c) < o.c_effmss[c];
    if (fire) {
      emit_ack();
    } else if (o.c_delackdl[c] < 0) {
      o.c_delackdl[w] = now + DELACK_NS;
    }
    o.had_holes[i] = 0;
    cont = C_FLUSH;
  }

  // push_data: one eff_mss segment per micro-op within min(cwnd, peer
  // window); Nagle holds a sub-MSS tail.
  STT_LAW void op_push() {
    const int64_t c = crd(), w = cwr();
    const int64_t window = min64(o.c_cwnd[c], o.c_sndwnd[c]);
    const int64_t flight = s_sub(o.c_sndnxt[c], o.c_snduna[c]);
    const int64_t sblen = o.c_sblen[c];
    const bool can = sblen > 0 && flight < window;
    const int64_t budget = min64(window - flight, o.c_effmss[c]);
    const bool nagle_hold =
        can && o.c_nodelay[c] == 0 && sblen < budget && flight > 0;
    const int64_t chunk = min64(sblen, budget);
    if (can && !nagle_hold && chunk > 0) {
      const int64_t sndnxt = o.c_sndnxt[c];
      emit(sndnxt, chunk, F_ACK | F_PSH, false, true, true);
      const int64_t sb = o.c_sblen[c] - chunk;
      const int64_t nx = s_add(o.c_sndnxt[c], chunk);
      o.c_sblen[w] = sb;
      o.c_sndnxt[w] = nx;
      fct_touch(chunk, false);
      return;
    }
    // zero-window persist arming
    if (o.c_sndwnd[c] == 0 && o.c_sblen[c] > 0 && !rtx_nonempty(c) &&
        o.c_persistdl[c] < 0) {
      const int64_t rto = o.c_rto[c];
      o.c_persistiv[w] = rto;
      o.c_persistdl[w] = now + rto;
    }
    cont = C_FLUSH;
  }

  // tcp_flush's notify: register the socket with the iface qdisc and
  // kick the inet-out relay if it is idle.
  STT_LAW void op_flush() {
    const int64_t c = crd(), w = cwr();
    const bool need = o.eflag[i] == 1 && o.c_queued[c] == 0;
    if (need) o.c_queued[w] = 1;
    o.eflag[i] = 0;
    cont = C_ARM;
    if (need && o.r1_pending[i] == 0) {
      cont = C_R1;
      then = C_ARM;
    }
  }

  // tcp_arm_timer + tcp_update_status (+ the deferred sendto-EAGAIN
  // park).
  STT_LAW void op_arm() {
    const int64_t c = crd(), w = cwr();
    const int64_t nxt = next_deadline(c);
    if (nxt < I64_MAX && nxt != o.c_tmrdl[c]) {
      o.c_tmrdl[w] = nxt;
      const int64_t sq = draw_seq();
      th_push(nxt, sq, TK_TCP, cur);
    }
    // update_status (ESTABLISHED lanes only in-domain)
    const bool readable = o.c_rblen[c] > 0;
    const bool space = o.c_sbmax[c] - o.c_sblen[c] > 0;
    const int64_t old = o.c_status[c];
    const int64_t set_bits =
        (readable ? S_READABLE : 0) | (space ? S_WRITABLE : 0);
    const int64_t clear_bits = (readable ? 0 : S_READABLE) & ~set_bits;
    const int64_t nw = (old | set_bits) & ~clear_bits;
    o.c_status[w] = nw;
    if (((old ^ nw) & o.c_await[c]) != 0 && o.c_wakep[c] == 0) {
      const int64_t sq = draw_seq();
      at_ = 1;
      th_push(now, sq, TK_APP, cur);
      o.c_wakep[w] = 1;
    }
    // deferred sendto-EAGAIN: clear WRITABLE, park the stepper
    const bool park = o.parkp[i] == 1;
    if (park) {
      const int64_t status = o.c_status[c] & ~S_WRITABLE;
      o.c_status[w] = status;
      o.c_await[w] = S_WRITABLE;
      o.c_awaitseq[w] = o.park_ctr[i];
      o.park_ctr[i] += 1;
      o.parkp[i] = 0;
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
    const int64_t c = crd(), w = cwr();
    const int64_t role = o.c_role[c];
    if (role == 0) {  // ---- client: recv 64 KiB or park ----
      o.app_sys[i * ASYS_N + ASYS_RECV] += 1;
      if (o.c_rblen[c] == 0) {
        o.c_await[w] = S_READABLE;
        o.c_awaitseq[w] = o.park_ctr[i];
        o.park_ctr[i] += 1;
        cont = C_IDLE;
        return;
      }
      const int64_t take = min64(o.c_rblen[c], 1 << 16);
      const int64_t win_before = recv_window(c);
      o.c_rblen[w] = o.c_rblen[c] - take;
      if (win_before < MSS && recv_window(c) >= MSS) emit_ack();
      // autotune_recv (socket_tcp.py twin)
      if (o.c_rat[c] == 1) {
        const int64_t copied = o.c_atcopied[c] + take;
        const int64_t at_space = max64(o.c_atspace[c], 2 * copied);
        const bool grow = at_space > o.c_rbmax[c];
        const int64_t nw =
            min64(at_space, max_mem(o.bw_down[i], o.c_srtt[c], RMEM_MAX));
        o.c_atcopied[w] = copied;
        o.c_atspace[w] = at_space;
        if (grow && nw > o.c_rbmax[c]) o.c_rbmax[w] = nw;
        const bool fresh = o.c_atlast[c] == 0;
        if (fresh) o.c_atlast[w] = now;
        if (!fresh && o.c_srtt[c] > 0 && now - o.c_atlast[c] > o.c_srtt[c]) {
          o.c_atlast[w] = now;
          o.c_atcopied[w] = 0;
        }
      }
      const int64_t ngot = o.c_agot[c] + take;
      o.c_agot[w] = ngot;
      // transfer completion leaves the modelled domain (close)
      at_ = 1;
      if (ngot >= o.c_atotal[c]) abort_(AB_STRUCT, 9);
      ret = C_APP;
      cont = C_FLUSH;
      return;
    }
    if (role != 1) return;
    // ---- handler: send up to 64 KiB or park ----
    o.app_sys[i * ASYS_N + ASYS_SEND] += 1;
    const int64_t want = min64(o.c_atotal[c] - o.c_agot[c], 1 << 16);
    const int64_t space = o.c_sbmax[c] - o.c_sblen[c];
    const int64_t wr = max64(min64(want, space), 0);
    ret = C_APP;
    if (wr == 0) {
      o.parkp[i] = 1;
      cont = C_FLUSH;
      return;
    }
    const int64_t nsent = o.c_agot[c] + wr;
    o.c_sblen[w] = o.c_sblen[c] + wr;
    o.c_agot[w] = nsent;
    // send completion -> shutdown_wr: out of the domain
    at_ = 2;
    if (nsent >= o.c_atotal[c]) abort_(AB_STRUCT, 10);
    cont = C_PUSH;
  }

  // TK_TCP fire: stale entries re-arm; due deadlines run delack /
  // persist / RTO in the engine's fixed order, then the flush chain.
  STT_LAW void op_tmr() {
    const int64_t c = crd(), w = cwr();
    o.c_tmrdl[w] = -1;
    const int64_t nxt = next_deadline(c);
    const bool have = nxt < I64_MAX;
    if (!(have && now >= nxt)) {  // stale
      if (have) {
        o.c_tmrdl[w] = nxt;
        const int64_t sq = draw_seq();
        th_push(nxt, sq, TK_TCP, cur);
      }
      cont = C_IDLE;
      return;
    }
    // ---- on_timer ----
    if (o.c_delackdl[c] >= 0 && now >= o.c_delackdl[c]) {
      at_ = 1;
      emit_ack();
    }
    if (o.c_persistdl[c] >= 0 && now >= o.c_persistdl[c]) {
      o.c_persistdl[w] = -1;
      if (o.c_sndwnd[c] == 0 && o.c_sblen[c] > 0 && !rtx_nonempty(c)) {
        at_ = 2;
        emit(o.c_sndnxt[c], 1, F_ACK | F_PSH, false, true, true);
        const int64_t sb = o.c_sblen[c] - 1;
        const int64_t nx = s_add(o.c_sndnxt[c], 1);
        o.c_sblen[w] = sb;
        o.c_sndnxt[w] = nx;
        fct_touch(1, false);
        const int64_t niv = min64(
            o.c_persistiv[c] > 0 ? 2 * o.c_persistiv[c] : o.c_rto[c],
            MAX_RTO_NS);
        o.c_persistiv[w] = niv;
        o.c_persistdl[w] = now + niv;
      }
    }
    // RTO
    if (o.c_rtodl[c] >= 0 && now >= o.c_rtodl[c]) {
      if (!rtx_nonempty(c)) {
        o.c_rtodl[w] = -1;
      } else {
        const int64_t flight = s_sub(o.c_sndnxt[c], o.c_snduna[c]);
        const int64_t ssth =
            max64(floor_div_pos(flight, 2), 2 * o.c_congmss[c]);
        const int64_t cw = o.c_congmss[c];
        o.c_ssthresh[w] = ssth;
        o.c_cwnd[w] = cw;
        o.c_dupacks[w] = 0;
        o.c_fastrec[w] = 0;
        // SACK reneging: forget every mark on RTO
        for (int64_t k = 0; k < p.cap_rt; k++)
          o.rtx_sacked[w * p.cap_rt + k] = 0;
        const int64_t rto = min64(2 * o.c_rto[c], MAX_RTO_NS);
        o.c_rto[w] = rto;
        o.c_rtobackoff[w] = o.c_rtobackoff[c] + 1;
        at_ = 3;
        retransmit_one();
        o.c_rtodl[w] = now + o.c_rto[c];
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
    o.events_run[i] += 1;
    const int64_t fault = o.h_fault[i];
    const bool h_down = (fault & 1) != 0;
    if (pick_ib) {
      ib_pos += 1;
      Pk pk;
      for (int c = 0; c < kPk; c++) pk.v[c] = o.ib[c][i * p.cap_i + safe];
      const int64_t size = pk.v[PK_PLEN] + TCP_TOTAL_HDR;
      if (fault != 0) {  // arrivals at a dead / link-down host die
        o.pkts_dropped[i] += 1;
        drop_cause(h_down ? TEL_HOST_DOWN : TEL_LINK_DOWN);
        trace(et, TR_DRP, pk, h_down ? RSN_HOSTDOWN : RSN_LINKDOWN);
        return;
      }
      o.enq_pkts[i] += 1;
      o.enq_bytes[i] += size;
      if (cq_len - cq_pos >= CODEL_HARD_LIMIT) {
        o.cd_dropped[i] += 1;
        o.cd_drop_bytes[i] += size;
        o.pkts_dropped[i] += 1;
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
        const bool mark_b = !mark_p && o.codel_bytes[i] >= p.k_bytes;
        if (mark_p || mark_b) {
          o.codel_marked[i] += 1;
          o.mark_causes[i * MARK_N +
                        (mark_p ? MARK_THRESH_PKTS : MARK_THRESH_BYTES)] += 1;
          pk.v[PK_ECN] = ECN_CE;
        }
      }
      const int64_t slot = i * p.cap_cq + cq_len % p.cap_cq;
      for (int c = 0; c < kPk; c++) o.cq[c][slot] = pk.v[c];
      o.cq_enq[slot] = et;
      cq_len += 1;
      if (cq_len - cq_pos > o.codel_peak[i]) o.codel_peak[i] = cq_len - cq_pos;
      o.codel_bytes[i] += size;
      if (o.r2_pending[i] == 0) {
        cont = C_R2;
        then = C_IDLE;
      }
      return;
    }
    // timer
    o.th_valid[i * p.cap_t + th_slot] = 0;
    th_ok = false;
    if (h_down) return;  // a dead host's timers discard
    const int64_t slot = i * p.cap_t + th_slot;
    const int64_t kind = o.th_kind[slot], tgt = o.th_tgt[slot];
    if (kind == TK_RELAY && (tgt == 1 || tgt == 2)) {
      (tgt == 1 ? o.r1_pending : o.r2_pending)[i] = 0;
      cont = tgt == 1 ? C_R1 : C_R2;
      then = C_IDLE;
    }
    at_ = 1;
    if (kind != TK_RELAY && tgt < 0) abort_(AB_STRUCT, 12);
    if (tgt >= 0 && kind == TK_TCP) {
      cur = tgt;
      cont = C_TMR;
      ret = C_IDLE;
    } else if (tgt >= 0 && kind == TK_APP) {
      cur = tgt;
      o.c_wakep[cwr()] = 0;
      o.c_await[cwr()] = 0;
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
    for (int64_t j = 0; j <= STT_ABORT_SEEN(o.stats + ST_AB_ITER); j++) {
      j_ = j;
      if (cont == C_IDLE) {  // a busy lane does not pop
        const int64_t safe = min64(ib_pos, p.cap_i - 1);
        const int64_t ib_t =
            ib_len > ib_pos ? o.ib_time[i * p.cap_i + safe] : I64_MAX;
        th_min();
        const int64_t et = min64(ib_t, th_t);
        if (et >= window_end) break;  // neither busy nor due
        const bool pick_ib = ib_t != th_t ? ib_t < th_t : ib_t < I64_MAX;
        mark(P_POP, j);
        op_pop_event(et, pick_ib, safe);
      }
      if (cont == C_TMR) {
        mark(P_TMR, j);
        op_tmr();
      }
      if (cont == C_APP) {
        mark(P_APP, j);
        op_app();
      }
      if (cont == C_R2) {
        mark(P_R2, j);
        op_relay2();
      }
      if (cont == C_TCPIN) {
        mark(P_TCPIN, j);
        op_tcpin();
      }
      for (int k = 0; k < 2; k++) {
        if (cont == C_DRAIN) {
          mark(k ? P_DRAIN_B : P_DRAIN_A, j);
          op_drain();
        }
      }
      if (cont == C_ACKDATA) {
        mark(P_ACK, j);
        op_ackdata();
      }
      if (cont == C_PUSH) {
        mark(P_PUSH, j);
        op_push();
      }
      if (cont == C_FLUSH) {
        mark(P_FLUSH, j);
        op_flush();
      }
      for (int k = 0; k < 2; k++) {
        if (cont == C_R1) {
          mark(k ? P_R1B : P_R1A, j);
          op_relay1();
        }
      }
      if (cont == C_ARM) {
        mark(P_ARM, j);
        op_arm();
      }
      s.iters = (uint32_t)(j + 1);
      // Per-round runaway valve: a continuation-cycle bug must abort,
      // not spin.
      q_ = P_END;
      at_ = 0;
      if (j > kValve) abort_(AB_STRUCT, 13);
    }
    flush_bits();
    store();
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
// The host build: every lane in turn, then the window's counts, as the
// kernel's last block settles them.
inline void window_serial(const Ops& o, const Params& p) {
  int64_t win_max = 0;
  for (int64_t i = 0; i < p.n; i++) {
    LaneStats s = {};
    Lane(o, p, i, s).run();
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
}
#endif

}  // namespace tcp
}  // namespace stt
