// The PHOLD/udp-mesh round end as per-lane and per-packet laws: the
// part of the reference's span loop after each window (shadow_tpu/ops/
// phold_span.py `propagate` :1454 with the inbox lexsort :1574, and the
// runahead and next-start update of `round_body` :1594-1667), as the
// eager port runs it (ops/phold_span.py `propagate`, ops/span_common.py
// `merge_inbox`).  stt_phold_span (phold_span.cu) runs these between
// grid barriers; the tier-1 tests build this header for the host and run
// the same phases serially (`span_serial`).
//
// The merge in three steps, each owned by one side:
//
//   fill_rows      (every cell of the inbox, before the first window of
//                  a launch) writes the fill values beyond each row's
//                  length, so that compaction only fills what it
//                  vacates;
//   compact_row    (the destination row's owner, after its window) moves
//                  the row's unconsumed remainder to the front and writes
//                  the fill values into the slots it vacates;
//   round_packet   (each outbox packet) propagates the packet with
//                  propagate_law.cuh's `propagate_lane` and, when kept,
//                  appends it at rem[dst] + an atomic count per row; a
//                  slot at or past I - 1 sets AB_STRUCT and writes
//                  nothing, as the eager merge's `ok_slot` does;
//   settle_row     (the owner again) sorts [0, len) by (time, src, seq)
//                  and returns the row's next-event time.
//
// (src, seq) is unique per packet (a host draws each seq once), so the
// sorted row does not depend on the order in which arrivals were
// appended: atomic appends give the eager merge's rows exactly.  The
// slots beyond len always hold the eager merge's fill (I64_MAX for time
// and seq, 0 for the rest): fill_rows writes them all before a launch's
// first round, in inbox order so that a warp's stores are contiguous,
// then each round only the slots compaction vacates, and nothing else
// writes there.
//
// Plain C++ apart from the qualifiers and the shared-word macros below
// (device atomics and L2 loads under __CUDACC__, plain operations in the
// host build).

#pragma once

#include <cstdint>

#include "phold_lane.cuh"
#include "propagate_law.cuh"

#ifdef __CUDACC__
// Words written by other blocks before a grid barrier: read from L2, so
// no line this SM cached earlier can be stale.
#define STT_LOAD(ptr) ((int64_t)__ldcg((const long long*)(ptr)))
#define STT_ADD(word, v) \
  ((int64_t)atomicAdd((unsigned long long*)(word), (unsigned long long)(v)))
#define STT_MIN(word, v) atomicMin((long long*)(word), (long long)(v))
#else
#define STT_LOAD(ptr) (*(ptr))
#define STT_ADD(word, v) ::stt::phold::host_add(word, v)
#define STT_MIN(word, v) ::stt::phold::host_min(word, v)
#endif

namespace stt {
namespace phold {

#ifndef __CUDACC__
inline int64_t host_add(int64_t* word, int64_t v) {
  const int64_t old = *word;
  *word = old + v;
  return old;
}
inline void host_min(int64_t* word, int64_t v) {
  if (v < *word) *word = v;
}
#endif

// The round end's operands beyond the window's (STT_PHOLD_OPERANDS):
// the routing matrices, the inbox columns the merge writes, and the
// span's two buffers.  Dims as there, plus v (the graph's nodes), span
// (the span words).
#define STT_ROUND_OPERANDS(X)                                           \
  X(const int64_t*, lat, "_lat", "v,v")                                 \
  X(const int64_t*, thr, "_thr", "v,v")                                 \
  X(const int64_t*, node, "_node", "n")                                 \
  X(int64_t*, ib_len, "ib_len", "n")                                    \
  X(int64_t*, ib_time, "ib_time", "n,I")                                \
  X(int64_t*, ib_src, "ib_src", "n,I")                                  \
  X(int64_t*, ib_seq, "ib_seq", "n,I")                                  \
  X(int64_t*, ib[kPk], "ib_*", "n,I")                                   \
  X(int64_t*, arrivals, "span.arrivals", "n") /* per row, a round */    \
  X(int64_t*, words, "span.words", "span")

// The span's constants, int64 words; the first five are the launch's
// (start, stop, limit, runahead, max_rounds: the reference run's
// arguments), the rest the build's.
#define STT_ROUND_PARAMS(X)                                             \
  X(start) X(stop) X(limit) X(runahead) X(max_rounds)                   \
  X(n_nodes) X(k0) X(k1) X(bootstrap_end) X(time_never)

// The span words (int64).  Out: the run's scalars (the eager run's
// return values), the abort word at the end, and the phase clocks:
// clock64() cycles of block 0's thread 0, summed over the rounds: each
// phase from its start to its grid barrier's exit (so the slowest
// thread's work in it and the barrier), the part of those inside the
// barriers, and the whole span.
// Scratch: four per-round values in two slots by the round's parity
// (written before a barrier, read after it, reset a round later).
#define STT_SPAN_WORDS(X)                                               \
  X(SW_START, 0) X(SW_RUNAHEAD, 1) X(SW_ROUNDS, 2) X(SW_BUSY_ROUNDS, 3) \
  X(SW_PACKETS, 4) X(SW_BUSY_END, 5) X(SW_ABORT, 6)                     \
  X(SW_CLK_WINDOW, 7) X(SW_CLK_PROPAGATE, 8) X(SW_CLK_SETTLE, 9)        \
  X(SW_CLK_WAIT, 10) X(SW_CLK_SPAN, 11)                                 \
  X(SW_NEXT, 12) X(SW_MIN_LAT, 14) X(SW_OUT_N, 16) X(SW_CODE, 18)       \
  X(SW_N, 20)
STT_SPAN_WORDS(STT_PHOLD_CONST_DEF)
constexpr char kSpanWords[] = STT_SPAN_WORDS(STT_PHOLD_CONST_NAME);

struct RoundParams {
  STT_ROUND_PARAMS(STT_PHOLD_PARAM_FIELD)
};
struct RoundOps {
  STT_ROUND_OPERANDS(STT_PHOLD_OPERAND_FIELD)
};

// The span kernel's tables: the window's, then the round end's.
struct SpanParams {
  Params w;
  RoundParams r;
};
struct SpanOps {
  Ops w;
  RoundOps r;
};

constexpr char kSpanParamNames[] =
    STT_PHOLD_PARAMS(STT_PHOLD_PARAM_NAME)
        STT_ROUND_PARAMS(STT_PHOLD_PARAM_NAME);
constexpr char kSpanOperands[] =
    STT_PHOLD_OPERANDS(STT_PHOLD_OPERAND_ENTRY)
        STT_ROUND_OPERANDS(STT_PHOLD_OPERAND_ENTRY);
static_assert(sizeof(SpanParams) ==
                  count_char(kSpanParamNames, ' ') * sizeof(int64_t),
              "SpanParams: one int64 word per name");
static_assert(sizeof(SpanOps) ==
                  operand_pointers(kSpanOperands) * sizeof(void*),
              "SpanOps: one pointer per name");

constexpr int kInboxCols = 3 + kPk;  // time, src, seq, then PK_KEYS

STT_LAW int64_t* inbox_col(const RoundOps& r, int c) {
  return c == 0 ? r.ib_time : c == 1 ? r.ib_src : c == 2 ? r.ib_seq
                                                        : r.ib[c - 3];
}

STT_LAW int64_t inbox_fill(int c) {
  return c == 0 || c == 2 ? I64_MAX : 0;  // time and seq; 0 elsewhere
}

// Inbox cell x (row x / I, slot x % I), before a launch's first window:
// the fill values where the slot lies at or beyond its row's length.
STT_LAW void fill_rows(const Ops& o, const RoundOps& r, const Params& p,
                       int64_t x) {
  if (x % p.cap_i < o.ib_len[x / p.cap_i]) return;
  for (int c = 0; c < kInboxCols; c++) inbox_col(r, c)[x] = inbox_fill(c);
}

// The owner, after its window: the unconsumed remainder [pos, len) to
// the front, ib_pos to 0 and ib_len to the remainder, the vacated slots
// [rem, len) filled, the row's arrival count cleared.
STT_LAW void compact_row(const Ops& o, const RoundOps& r, const Params& p,
                         int64_t i, int64_t pos, int64_t len) {
  const int64_t row = i * p.cap_i;
  const int64_t rem = len - pos;
  if (pos > 0) {
    for (int c = 0; c < kInboxCols; c++) {
      int64_t* const col = inbox_col(r, c) + row;
      for (int64_t k = 0; k < rem; k++) col[k] = STT_LOAD(&col[pos + k]);
      const int64_t fill = inbox_fill(c);
      for (int64_t k = rem; k < len; k++) col[k] = fill;
    }
  }
  if (pos != 0) o.ib_pos[i] = 0;
  if (len != rem) r.ib_len[i] = rem;
  r.arrivals[i] = 0;
}

// One outbox packet j of the window ending at `window_end`: propagation,
// the drop counts and trace lines of an unreachable or lost packet, else
// its append to the destination row.
// Returns the packet's latency when kept (the runahead's minimum), else
// I64_MAX.
STT_LAW int64_t round_packet(const Ops& o, const RoundOps& r,
                             const Params& p, const RoundParams& q,
                             int64_t window_end, int64_t j) {
  const int64_t src = STT_LOAD(&o.out_src[j]);
  const int64_t dst = STT_LOAD(&o.out_dst[j]);
  const int64_t t = STT_LOAD(&o.out_t[j]);
  Pk pk;
  pk.v[PK_SRCHOST] = src;
  for (int c = 1; c < kPk; c++) pk.v[c] = STT_LOAD(&o.out_pk[c - 1][j]);
  const int64_t cell = r.node[src] * q.n_nodes + r.node[dst];
  const int64_t lat = r.lat[cell];
  const PropagateOut v = propagate_lane(
      lat, r.thr[cell], (uint32_t)q.k0, (uint32_t)q.k1, src,
      (uint32_t)(pk.v[PK_PSEQ] & M32), t, false, window_end,
      q.bootstrap_end, q.time_never);
  if (!v.keep) {
    const int tel = v.reachable ? TEL_LOSS_EDGE : TEL_UNREACHABLE;
    STT_ADD(&o.pkts_dropped[src], 1);
    STT_ADD(&o.drop_causes[src * TEL_N + tel], 1);
    if (p.tracing) {
      const int64_t k = STT_CLAIM(o.tr_n);
      const int64_t slot = k < p.cap_tr ? k : p.cap_tr;
      o.tr_t[slot] = t;
      o.tr_kind[slot] = TR_DRP;
      for (int c = 0; c < kPk; c++) o.tr_pk[c][slot] = pk.v[c];
      o.tr_reason[slot] = v.reachable ? RSN_LOSS : RSN_UNREACH;
      o.tr_owner[slot] = src;
    }
    return I64_MAX;
  }
  const int64_t slot = STT_LOAD(&r.ib_len[dst]) + STT_ADD(&r.arrivals[dst], 1);
  if (slot >= p.cap_i - 1) {
    STT_ABORT(o.abort_code, AB_STRUCT);  // the row is full: nothing written
    return lat;
  }
  const int64_t at = dst * p.cap_i + slot;
  r.ib_time[at] = v.deliver;
  r.ib_src[at] = src;
  r.ib_seq[at] = STT_LOAD(&o.out_seq[j]);
  for (int c = 0; c < kPk; c++) r.ib[c][at] = pk.v[c];
  return lat;
}

// The inbox heap's total order (ops/span_common.py lexsort3).
STT_LAW bool inbox_less(int64_t t, int64_t s, int64_t q, int64_t t2,
                        int64_t s2, int64_t q2) {
  return t != t2 ? t < t2 : s != s2 ? s < s2 : q < q2;
}

// The owner, after the appends: the row's length, its [0, len) sorted
// by (time, src, seq) (an insertion sort in place, every column moved
// with its key: the remainder is sorted already, so only the arrivals
// move), and the row's next-event time, min(inbox head, earliest timer),
// as ops/phold_span.py next_event_time takes it.
STT_LAW int64_t settle_row(const Ops& o, const RoundOps& r, const Params& p,
                           int64_t i) {
  const int64_t row = i * p.cap_i;
  const int64_t rem = STT_LOAD(&r.ib_len[i]);
  int64_t len = rem + STT_LOAD(&r.arrivals[i]);
  len = len < p.cap_i - 1 ? len : p.cap_i - 1;
  len = len > rem ? len : rem;
  int64_t* const t = r.ib_time + row;
  int64_t* const s = r.ib_src + row;
  int64_t* const q = r.ib_seq + row;
  for (int64_t k = 1; k < len; k++) {
    const int64_t tk = STT_LOAD(&t[k]), sk = STT_LOAD(&s[k]),
                  qk = STT_LOAD(&q[k]);
    int64_t m = k;
    while (m > 0 && inbox_less(tk, sk, qk, STT_LOAD(&t[m - 1]),
                               STT_LOAD(&s[m - 1]), STT_LOAD(&q[m - 1])))
      m--;
    if (m == k) continue;
    for (int c = 0; c < kInboxCols; c++) {
      int64_t* const col = inbox_col(r, c) + row;
      const int64_t v = STT_LOAD(&col[k]);
      for (int64_t x = k; x > m; x--) col[x] = STT_LOAD(&col[x - 1]);
      col[m] = v;
    }
  }
  if (len != rem) r.ib_len[i] = len;
  int64_t next = len > 0 ? STT_LOAD(&t[0]) : I64_MAX;
  const int64_t trow = i * p.cap_t;
  for (int64_t k = 0; k < p.cap_t; k++)
    if (o.th_valid[trow + k] && o.th_time[trow + k] < next)
      next = o.th_time[trow + k];
  return next;
}

// One thread's close of the round's appends (after every packet): the
// outbox count and the abort word as the round left them, into the
// round's slot, the outbox emptied, and the trace check the eager
// propagation makes after its drops (AB_TRACE on tr_n > TR - O).
STT_LAW void close_round(const Ops& o, const RoundOps& r, const Params& p,
                         int slot) {
  const int64_t n = STT_LOAD(o.out_n);
  r.words[SW_OUT_N + slot] = n;
  *o.out_n = 0;
  if (p.tracing && STT_LOAD(o.tr_n) > p.cap_tr - p.cap_out)
    STT_ABORT(o.abort_code, AB_TRACE);
  r.words[SW_CODE + slot] = STT_LOAD(o.abort_code);
}

// The round loop's scalars: the reference round_cond (:1588-1592) and
// round_body's updates, read from the round's slot after the last
// barrier of the round.  An aggregate, so that the kernel keeps one copy
// a block in shared memory.
struct SpanRun {
  int64_t start, runahead, rounds, busy_rounds, packets, busy_end, code;

  STT_LAW static SpanRun begin(const RoundParams& q) {
    return {q.start, q.runahead, 0, 0, 0, q.start, 0};
  }

  STT_LAW bool go(const RoundParams& q) const {
    return rounds < q.max_rounds && start < q.limit && start < q.stop &&
           code == 0;
  }

  STT_LAW int64_t window_end(const RoundParams& q) const {
    const int64_t e = start + runahead;
    return e < q.stop ? e : q.stop;
  }

  STT_LAW void advance(const int64_t* words, int slot, int64_t window_end) {
    const int64_t n = STT_LOAD(&words[SW_OUT_N + slot]);
    const int64_t min_lat = STT_LOAD(&words[SW_MIN_LAT + slot]);
    if (min_lat > 0 && min_lat < runahead) runahead = min_lat;
    start = STT_LOAD(&words[SW_NEXT + slot]);
    rounds += 1;
    busy_rounds += n > 0;
    packets += n;
    busy_end = window_end;
    code = STT_LOAD(&words[SW_CODE + slot]);
  }

  STT_LAW void finish(int64_t* words) const {
    words[SW_START] = start;
    words[SW_RUNAHEAD] = runahead;
    words[SW_ROUNDS] = rounds;
    words[SW_BUSY_ROUNDS] = busy_rounds;
    words[SW_PACKETS] = packets;
    words[SW_BUSY_END] = busy_end;
    words[SW_ABORT] = code;
  }
};

#ifndef __CUDACC__
// The host build: the kernel's phases in turn, every lane and packet of
// a phase before the next phase.  `order`, when given, visits the
// round's outbox packets in that order instead (a permutation of
// [0, n), drawn by the caller), which the kernel's atomic appends may do.
template <class Order>
inline void span_serial(const SpanOps& so, const SpanParams& sp,
                        Order order) {
  const Ops& o = so.w;
  const RoundOps& r = so.r;
  const RoundParams& q = sp.r;
  Params p = sp.w;
  SpanRun run = SpanRun::begin(q);
  for (int slot = 0; slot < 2; slot++) {
    r.words[SW_NEXT + slot] = I64_MAX;
    r.words[SW_MIN_LAT + slot] = I64_MAX;
  }
  if (run.go(q))
    for (int64_t x = 0; x < p.n * p.cap_i; x++) fill_rows(o, r, p, x);
  while (run.go(q)) {
    const int slot = (int)(run.rounds & 1);
    p.window_end = run.window_end(q);
    // A: the lanes' windows, then each owner compacts its row.
    window_serial(o, p);
    for (int64_t i = 0; i < p.n; i++)
      compact_row(o, r, p, i, o.ib_pos[i], o.ib_len[i]);
    // B: every packet of the outbox.
    r.words[SW_NEXT + 1 - slot] = I64_MAX;
    r.words[SW_MIN_LAT + 1 - slot] = I64_MAX;
    const int64_t n = *o.out_n < p.cap_out ? *o.out_n : p.cap_out;
    for (int64_t k = 0; k < n; k++) {
      const int64_t lat = round_packet(o, r, p, q, p.window_end,
                                       order(k, n));
      STT_MIN(&r.words[SW_MIN_LAT + slot], lat);
    }
    // C: the rows settled, the round closed.
    close_round(o, r, p, slot);
    for (int64_t i = 0; i < p.n; i++) {
      const int64_t next = settle_row(o, r, p, i);
      STT_MIN(&r.words[SW_NEXT + slot], next);
    }
    // D: the next round's scalars.
    run.advance(r.words, slot, p.window_end);
  }
  run.finish(r.words);
}
#endif

}  // namespace phold
}  // namespace stt
