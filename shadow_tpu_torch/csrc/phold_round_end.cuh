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
//   compact_cols   (the row's team, right after the lane's window, a
//                  rank a column) moves the row's unconsumed remainder to
//                  the front and writes the fill values into the slots it
//                  vacates; compact_done sets the row's position, length
//                  and arrival count;
//   round_packet   (each outbox packet) propagates the packet with
//                  propagate_law.cuh's `propagate_lane` and, when kept,
//                  appends it at rem[dst] + an atomic count per row; a
//                  slot at or past I - 1 sets AB_STRUCT and writes
//                  nothing, as the eager merge's `ok_slot` does;
//   settle_*       (the row's team: the keys staged in its scratch,
//                  each entry placed by a merge of the sorted remainder
//                  and the arrivals, the columns moved through the
//                  scratch; settle_row at a team of one, an insertion
//                  sort in place) sort [0, len) by (time, src, seq) and
//                  give the row's head time; the lane's heap least, kept
//                  by its window, completes the row's next-event time.
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

// Rank `rank` of `size` of row i's team, after the lane's window (its
// position `pos`, its length `len`): columns rank, rank + size, ... of
// the row, the unconsumed remainder [pos, len) moved to the front and
// the vacated slots [len - pos, len) filled.
STT_LAW void compact_cols(const RoundOps& r, const Params& p, int64_t i,
                          int64_t pos, int64_t len, int rank, int size) {
  if (pos <= 0) return;
  const int64_t rem = len - pos;
  for (int c = rank; c < kInboxCols; c += size) {
    int64_t* const col = inbox_col(r, c) + i * p.cap_i;
    for (int64_t k = 0; k < rem; k++) col[k] = STT_LOAD(&col[pos + k]);
    const int64_t fill = inbox_fill(c);
    for (int64_t k = rem; k < len; k++) col[k] = fill;
  }
}

// The row's words once its columns are compacted: position 0, length the
// remainder, no arrivals yet.
STT_LAW void compact_done(const Ops& o, const RoundOps& r, int64_t i,
                          int64_t pos, int64_t len) {
  if (pos != 0) {
    o.ib_pos[i] = 0;
    r.ib_len[i] = len - pos;
  }
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

// Row i's settle: its first slot, the remainder the compaction left, its
// final length (the appends past I - 1 wrote nothing).
struct RowSettle {
  int64_t row, rem, len;
};

STT_LAW RowSettle settle_begin(const RoundOps& r, const Params& p,
                               int64_t i) {
  const int64_t rem = STT_LOAD(&r.ib_len[i]);
  int64_t len = rem + STT_LOAD(&r.arrivals[i]);
  len = len < p.cap_i - 1 ? len : p.cap_i - 1;
  len = len > rem ? len : rem;
  return {i * p.cap_i, rem, len};
}

// A row settled by one thread (a team of one, the ring's width): the
// row's [0, len) insertion-sorted by (time, src, seq) in place, every
// column moved with its key (the remainder is sorted already, so only
// the arrivals move), its length written; returns the row's head time.
// A team of one has no scratch of its own (64 lanes a block), and in the
// one-thread kernel this phase took 3% of the ring's span: the rows
// there hold a few entries.
STT_LAW int64_t settle_row(const RoundOps& r, const RowSettle& w,
                           int64_t i) {
  int64_t* const t = r.ib_time + w.row;
  int64_t* const s = r.ib_src + w.row;
  int64_t* const q = r.ib_seq + w.row;
  for (int64_t k = 1; k < w.len; k++) {
    const int64_t tk = STT_LOAD(&t[k]), sk = STT_LOAD(&s[k]),
                  qk = STT_LOAD(&q[k]);
    int64_t m = k;
    while (m > 0 && inbox_less(tk, sk, qk, STT_LOAD(&t[m - 1]),
                               STT_LOAD(&s[m - 1]), STT_LOAD(&q[m - 1])))
      m--;
    if (m == k) continue;
    for (int c = 0; c < kInboxCols; c++) {
      int64_t* const col = inbox_col(r, c) + w.row;
      const int64_t v = STT_LOAD(&col[k]);
      for (int64_t x = k; x > m; x--) col[x] = STT_LOAD(&col[x - 1]);
      col[m] = v;
    }
  }
  if (w.len != w.rem) r.ib_len[i] = w.len;
  return w.len > 0 ? STT_LOAD(&t[0]) : I64_MAX;
}

// ---- a row settled by its team ----

// The rows a team's settle stages in its scratch: cap_i <= kRowMax (a
// wider inbox runs at a team of one).
constexpr int kRowMax = 64;

// A row's keys and each entry's final slot, and its head time.
struct SettleScratch {
  int64_t t[kRowMax], s[kRowMax], q[kRowMax];
  int8_t dst[kRowMax];
  int64_t head;
};

STT_LAW bool row_less(const SettleScratch& x, int64_t a, int64_t b) {
  return inbox_less(x.t[a], x.s[a], x.q[a], x.t[b], x.s[b], x.q[b]);
}

// Stage the keys of [0, len): entries k = rank, rank + size, ...
STT_LAW void settle_stage(const RoundOps& r, SettleScratch& x,
                          const RowSettle& w, int rank, int size) {
  for (int64_t k = rank; k < w.len; k += size) {
    x.t[k] = STT_LOAD(&r.ib_time[w.row + k]);
    x.s[k] = STT_LOAD(&r.ib_src[w.row + k]);
    x.q[k] = STT_LOAD(&r.ib_seq[w.row + k]);
  }
}

// Whether the remainder's entries rank, rank + size, ... each follow
// their predecessor (a part of the sortedness check).
STT_LAW bool settle_sorted_part(const SettleScratch& x, const RowSettle& w,
                                int rank, int size) {
  for (int64_t k = 1 + rank; k < w.rem; k += size)
    if (row_less(x, k, k - 1)) return false;
  return true;
}

// Each staged entry's final slot, stably as the eager lexsort places it:
// the entries below it, and its equals before it.  With the remainder
// sorted (the engine exports a row sorted, each settle leaves it sorted
// and a window consumes its head) a remainder entry's slot is its own
// plus the arrivals below it, and an arrival's the remainder below it (a
// binary search) plus the arrivals below it: each rank counts keys below
// its own.  The entry that lands in slot 0 gives the head time.
STT_LAW void settle_dest(SettleScratch& x, const RowSettle& w, bool sorted,
                         int rank, int size) {
  for (int64_t k = rank; k < w.len; k += size) {
    int64_t d = 0, from = 0;
    if (sorted && k < w.rem) {
      d = k;
      from = w.rem;
    } else if (sorted) {
      int64_t lo = 0, hi = w.rem;  // remainder entries below k
      while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (row_less(x, k, mid))
          hi = mid;
        else
          lo = mid + 1;
      }
      d = lo;
      from = w.rem;
    }
    for (int64_t m = from; m < w.len; m++)
      if (row_less(x, m, k) || (m < k && !row_less(x, k, m))) d++;
    x.dst[k] = (int8_t)d;
    if (d == 0) x.head = x.t[k];
  }
}

// The staged keys to their final slots (entries that move only).
STT_LAW void settle_keys(const RoundOps& r, const SettleScratch& x,
                         const RowSettle& w, int rank, int size) {
  for (int64_t k = rank; k < w.len; k += size) {
    const int64_t d = x.dst[k];
    if (d == k) continue;
    r.ib_time[w.row + d] = x.t[k];
    r.ib_src[w.row + d] = x.s[k];
    r.ib_seq[w.row + d] = x.q[k];
  }
}

// Packet column c of the row: staged into x.t (after settle_keys), then
// stored at the final slots.
STT_LAW void settle_load_col(const RoundOps& r, SettleScratch& x,
                             const RowSettle& w, int c, int rank,
                             int size) {
  for (int64_t k = rank; k < w.len; k += size)
    x.t[k] = STT_LOAD(&r.ib[c][w.row + k]);
}

STT_LAW void settle_store_col(const RoundOps& r, const SettleScratch& x,
                              const RowSettle& w, int c, int rank,
                              int size) {
  for (int64_t k = rank; k < w.len; k += size)
    if (x.dst[k] != k) r.ib[c][w.row + x.dst[k]] = x.t[k];
}

// The row's length and head time once settled by its team (one rank).
STT_LAW int64_t settle_end(const RoundOps& r, const SettleScratch& x,
                           const RowSettle& w, int64_t i) {
  if (w.len > w.rem) {
    r.ib_len[i] = w.len;
    return x.head;
  }
  return w.len > 0 ? STT_LOAD(&r.ib_time[w.row]) : I64_MAX;
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
// The host build: the lane's heap least after its window (its kept
// least, or a rescan when an abort ended the window first), then its row
// compacted by the ranks in turn; returns the heap least's time.
inline int64_t lane_done(const RoundOps& r, Lane& lane, const Team& t) {
  const int64_t timer = lane.th_min();
  const int64_t pos = lane.ib_pos, len = lane.ib_len;
  for (int rank = 0; rank < t.size; rank++)
    compact_cols(r, lane.p, lane.i, pos, len, rank, t.size);
  compact_done(lane.o, r, lane.i, pos, len);
  return timer;
}

// Row i settled by `size` ranks run in turn, each step by every rank
// before the next (one rank: settle_row); returns the row's head time.
inline int64_t settle_team(const RoundOps& r, const Params& p, int64_t i,
                           int size, SettleScratch& x) {
  const RowSettle w = settle_begin(r, p, i);
  if (size == 1) return settle_row(r, w, i);
  if (w.len > w.rem) {
    for (int k = 0; k < size; k++) settle_stage(r, x, w, k, size);
    bool sorted = true;
    for (int k = 0; k < size; k++)
      sorted = settle_sorted_part(x, w, k, size) && sorted;
    for (int k = 0; k < size; k++) settle_dest(x, w, sorted, k, size);
    for (int k = 0; k < size; k++) settle_keys(r, x, w, k, size);
    for (int c = 0; c < kPk; c++) {
      for (int k = 0; k < size; k++) settle_load_col(r, x, w, c, k, size);
      for (int k = 0; k < size; k++) settle_store_col(r, x, w, c, k, size);
    }
  }
  return settle_end(r, x, w, i);
}

// The host build: the kernel's phases in turn, every lane, packet and row
// of a phase before the next phase, each lane and row by a team of
// `team` ranks run in turn.  `order`, when given, visits the round's
// outbox packets in that order instead (a permutation of [0, n), drawn
// by the caller), which the kernel's atomic appends may do.  Returns 0,
// or 1 for a table the kernel refuses (window_serial's; a team of more
// than one on an inbox wider than kRowMax).
template <class Order>
inline int span_serial(const SpanOps& so, const SpanParams& sp, int team,
                       Order order) {
  const Ops& o = so.w;
  const RoundOps& r = so.r;
  const RoundParams& q = sp.r;
  Params p = sp.w;
  if (team > 1 && p.cap_i > kRowMax) return 1;
  SpanRun run = SpanRun::begin(q);
  for (int slot = 0; slot < 2; slot++) {
    r.words[SW_NEXT + slot] = I64_MAX;
    r.words[SW_MIN_LAT + slot] = I64_MAX;
  }
  if (run.go(q))
    for (int64_t x = 0; x < p.n * p.cap_i; x++) fill_rows(o, r, p, x);
  SettleScratch* const x = new SettleScratch;
  int err = 0;
  while (run.go(q) && !err) {
    const int slot = (int)(run.rounds & 1);
    p.window_end = run.window_end(q);
    // A: the lanes' windows, each lane's heap least into the round's
    // next-event word and its row compacted after it.
    err = window_serial(o, p, team, [&](Lane& lane, const Team& t) {
      STT_MIN(&r.words[SW_NEXT + slot], lane_done(r, lane, t));
    });
    // B: every packet of the outbox.
    r.words[SW_NEXT + 1 - slot] = I64_MAX;
    r.words[SW_MIN_LAT + 1 - slot] = I64_MAX;
    const int64_t n = *o.out_n < p.cap_out ? *o.out_n : p.cap_out;
    for (int64_t k = 0; k < n; k++) {
      const int64_t lat = round_packet(o, r, p, q, p.window_end,
                                       order(k, n));
      STT_MIN(&r.words[SW_MIN_LAT + slot], lat);
    }
    // C: the round closed, the rows settled.
    close_round(o, r, p, slot);
    for (int64_t i = 0; i < p.n; i++)
      STT_MIN(&r.words[SW_NEXT + slot], settle_team(r, p, i, team, *x));
    // D: the next round's scalars.
    run.advance(r.words, slot, p.window_end);
  }
  delete x;
  run.finish(r.words);
  return err;
}
#endif

}  // namespace phold
}  // namespace stt
