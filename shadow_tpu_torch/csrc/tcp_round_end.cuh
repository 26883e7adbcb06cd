// The TCP stream's round end as per-row and per-packet laws: the part of
// the reference's span loop after each window (shadow_tpu/ops/tcp_span.py
// `propagate` :2142 with the inbox lexsort :2260, and the runahead and
// next-start update of `round_body` :2280, under `round_cond` :2274),
// as the eager port runs it (ops/tcp_span.py `propagate` and
// `round_end`, ops/span_common.py `merge_inbox`).  stt_tcp_span
// (tcp_span.cu) runs these between grid barriers; the tier-1 tests build
// this header for the host and run the same phases in turn
// (`span_serial`).
//
// The TCP twin of phold_round_end.cuh: the same merge in the same steps,
// over the TCP packet's 21 columns, with the TCP loss rule (pure acks,
// plen 0, are never lossy) and trace line (plen in it), and with the
// row work done by the lane's tile:
//
//   fill_rows      (every cell of the inbox, before the first window of
//                  a launch) writes the fill values beyond each row's
//                  length, so that compaction only fills what it
//                  vacates;
//   compact_cols   (the row's tile, right after its window, a rank a
//                  column) moves the row's unconsumed remainder to the
//                  front and fills the slots it vacates; compact_done
//                  sets the row's position, length and arrival count;
//   round_packet   (each outbox packet) propagates the packet with
//                  propagate_law.cuh's `propagate_lane`, counts and
//                  traces a drop, or appends a kept packet at rem[dst] +
//                  an atomic count per row; a slot at or past I - 1
//                  writes nothing and raises the round's overflow word
//                  (the eager merge's `ok_slot` and its AB_STRUCT);
//   settle_*       (the row's tile) place each entry of [0, len) at its
//                  rank in (time, src, seq) order and give the row's
//                  head time; the lane's timer-heap least, kept by its
//                  window, completes the row's next-event time;
//   close_round    (one thread) the round's outbox count, the trace
//                  check and the overflow into the abort word, as the
//                  eager round end marks them after the window's.
//
// (src, seq) is unique per packet (a host draws each seq once), so the
// settled row does not depend on the order of the appends, and the drop
// trace lines, claimed in any order, are the eager ones as a set: the
// engine's import sorts a span's trace canonically (tier-1 holds a
// shuffled outbox to the same state and the same sorted trace).  An
// entering row is sorted (the engine exports its inbox sorted, and
// every round end leaves its rows sorted), and a window only consumes
// a row's head, so a row's remainder is sorted: the ranks are a merge
// (each remainder entry moved past the arrivals below it, each arrival
// placed by a binary search of the remainder and a count of the
// arrivals below it).  A row with arrivals whose remainder is not
// sorted is ranked in full, by counting, stably as the eager lexsort.
//
// Plain C++ apart from the qualifiers and the shared-word macros below
// (device atomics under __CUDACC__, plain operations in the host build).

#pragma once

#include <cstdint>

#include "propagate_law.cuh"
#include "tcp_lane.cuh"

#ifdef __CUDACC__
#define STT_ADD(word, v) \
  ((int64_t)atomicAdd((unsigned long long*)(word), (unsigned long long)(v)))
#define STT_MIN(word, v) atomicMin((long long*)(word), (long long)(v))
#else
#define STT_ADD(word, v) ::stt::tcp::host_add(word, v)
#define STT_MIN(word, v) ::stt::tcp::host_min(word, v)
#endif

namespace stt {
namespace tcp {

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

// The round end's constants beyond the window's (STT_TCP_CONSTS), each
// the value of the same name in ops/tcp_span.py.
#define STT_TCP_ROUND_CONSTS(X) \
  X(TEL_LOSS_EDGE, 2) X(TEL_UNREACHABLE, 3) X(RSN_LOSS, 6) X(RSN_UNREACH, 7)
STT_TCP_ROUND_CONSTS(STT_TCP_CONST_DEF)
constexpr char kSpanConsts[] =
    STT_TCP_CONSTS(STT_TCP_CONST_NAME) STT_TCP_ROUND_CONSTS(STT_TCP_CONST_NAME);

// The round end's operands beyond the window's (STT_TCP_OPERANDS): the
// routing matrices, the inbox columns the merge writes, and the span's
// buffers.  Dims as there, plus v (the graph's nodes) and span (the span
// words).
#define STT_TCP_ROUND_OPERANDS(X)                                       \
  X(const int64_t*, lat, "_lat", "v,v")                                 \
  X(const int64_t*, thr, "_thr", "v,v")                                 \
  X(const int64_t*, node, "_node", "n")                                 \
  X(int64_t*, ib_len, "ib_len", "n")                                    \
  X(int64_t*, ib_time, "ib_time", "n,I")                                \
  X(int64_t*, ib_src, "ib_src", "n,I")                                  \
  X(int64_t*, ib_seq, "ib_seq", "n,I")                                  \
  X(int64_t*, ib[kPk], "ib_*", "n,I")                                   \
  X(int64_t*, timer, "span.timer", "n") /* heap least after a window */ \
  X(int64_t*, arrivals, "span.arrivals", "n") /* per row, a round */    \
  X(int64_t*, words, "span.words", "span")

// The span's constants, int64 words; the first five are the launch's
// (start, stop, limit, runahead, max_rounds: the eager run's arguments),
// the rest the build's.
#define STT_TCP_ROUND_PARAMS(X)                                         \
  X(start) X(stop) X(limit) X(runahead) X(max_rounds)                   \
  X(n_nodes) X(k0) X(k1) X(bootstrap_end) X(time_never)

// The span words (int64).  Out: the run's scalars (the eager run's
// return values), the abort word at the end, and the phase clocks:
// clock64() cycles of block 0's thread 0, summed over the rounds: each
// phase from its start to its grid barrier's exit (so the slowest
// thread's work in it and the barrier), the part of those inside the
// barriers, and the whole span.
// Scratch: four per-round values in two slots by the round's parity
// (written before a barrier, read after it, reset a round later), and
// the round's inbox overflow (raised by the appends, cleared by
// close_round).
#define STT_TCP_SPAN_WORDS(X)                                           \
  X(SW_START, 0) X(SW_RUNAHEAD, 1) X(SW_ROUNDS, 2) X(SW_BUSY_ROUNDS, 3) \
  X(SW_PACKETS, 4) X(SW_BUSY_END, 5) X(SW_ABORT, 6)                     \
  X(SW_CLK_WINDOW, 7) X(SW_CLK_PROPAGATE, 8) X(SW_CLK_SETTLE, 9)        \
  X(SW_CLK_WAIT, 10) X(SW_CLK_SPAN, 11)                                 \
  X(SW_NEXT, 12) X(SW_MIN_LAT, 14) X(SW_OUT_N, 16) X(SW_CODE, 18)       \
  X(SW_OVER, 20) X(SW_N, 21)
STT_TCP_SPAN_WORDS(STT_TCP_CONST_DEF)
constexpr char kSpanWords[] = STT_TCP_SPAN_WORDS(STT_TCP_CONST_NAME);

struct RoundParams {
  STT_TCP_ROUND_PARAMS(STT_TCP_PARAM_FIELD)
};
struct RoundOps {
  STT_TCP_ROUND_OPERANDS(STT_TCP_OPERAND_FIELD)
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
    STT_TCP_PARAMS(STT_TCP_PARAM_NAME) STT_TCP_ROUND_PARAMS(STT_TCP_PARAM_NAME);
constexpr char kSpanOperands[] =
    STT_TCP_OPERANDS(STT_TCP_OPERAND_ENTRY)
        STT_TCP_ROUND_OPERANDS(STT_TCP_OPERAND_ENTRY);
static_assert(sizeof(SpanParams) ==
                  count_char(kSpanParamNames, ' ') * sizeof(int64_t),
              "SpanParams: one int64 word per name");
static_assert(sizeof(SpanOps) ==
                  operand_pointers(kSpanOperands) * sizeof(void*),
              "SpanOps: one pointer per name");
// Both tables go to the kernel as __grid_constant__ parameters.
static_assert(sizeof(SpanOps) + sizeof(SpanParams) <= 4096,
              "kernel parameters");

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
STT_LAW void fill_rows(const RoundOps& r, const Params& p, int64_t x) {
  if (x % p.cap_i < r.ib_len[x / p.cap_i]) return;
  for (int c = 0; c < kInboxCols; c++) inbox_col(r, c)[x] = inbox_fill(c);
}

// Rank `rank` of `size` of row i's tile, after the lane's window (its
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
// the drop counts and trace line of an unreachable or lost packet, else
// its append to the destination row.  Returns the packet's latency when
// kept (the runahead's minimum), else I64_MAX.
STT_LAW int64_t round_packet(const Ops& o, const RoundOps& r,
                             const Params& p, const RoundParams& q,
                             int64_t window_end, int64_t j) {
  const int64_t src = STT_LOAD(&o.out_src[j]);
  const int64_t dst = STT_LOAD(&o.out_dst[j]);
  const int64_t t = STT_LOAD(&o.out_t[j]);
  Pk pk;
  for (int c = 0; c < kPk; c++) pk.v[c] = STT_LOAD(&o.out_pk[c][j]);
  const int64_t cell = r.node[src] * q.n_nodes + r.node[dst];
  const int64_t lat = r.lat[cell];
  // Pure acks (empty control segments) are never lossy.
  const PropagateOut v = propagate_lane(
      lat, r.thr[cell], (uint32_t)q.k0, (uint32_t)q.k1, src,
      (uint32_t)(pk.v[PK_PSEQ] & M32), t, !(pk.v[PK_PLEN] > 0), window_end,
      q.bootstrap_end, q.time_never);
  if (!v.keep) {
    const int64_t tel = v.reachable ? TEL_LOSS_EDGE : TEL_UNREACHABLE;
    STT_ADD(&o.pkts_dropped[src], 1);
    STT_ADD(&o.drop_causes[src * TEL_N + tel], 1);
    if (p.tracing) {
      const int64_t k = STT_CLAIM(o.tr_n);
      const int64_t slot = k < p.cap_tr ? k : p.cap_tr;
      o.tr_t[slot] = t;
      o.tr_kind[slot] = TR_DRP;
      for (int c = 0; c < kRoute; c++) o.tr_pk[c][slot] = pk.v[c];
      o.tr_pk[kRoute][slot] = pk.v[PK_PLEN];
      o.tr_reason[slot] = v.reachable ? RSN_LOSS : RSN_UNREACH;
      o.tr_owner[slot] = src;
    }
    return I64_MAX;
  }
  const int64_t slot =
      STT_LOAD(&r.ib_len[dst]) + STT_ADD(&r.arrivals[dst], 1);
  if (slot >= p.cap_i - 1) {
    r.words[SW_OVER] = 1;  // the row is full: nothing written
    return lat;
  }
  const int64_t at = dst * p.cap_i + slot;
  r.ib_time[at] = v.deliver;
  r.ib_src[at] = src;
  r.ib_seq[at] = STT_LOAD(&o.out_seq[j]);
  for (int c = 0; c < kPk; c++) r.ib[c][at] = pk.v[c];
  return lat;
}

// ---- a row settled by its tile ----

// The rows the settle stages in the tile's scratch (TeamScratch, free
// once the lane's window is done): cap_i <= kRowMax (the kernel refuses
// a larger inbox).
constexpr int kRowMax = 512;

// A row's keys and each entry's final slot, and its head time.
struct SettleScratch {
  int64_t t[kRowMax], s[kRowMax], q[kRowMax];
  int16_t dst[kRowMax];
  int64_t head;
};
static_assert(sizeof(SettleScratch) <= sizeof(TeamScratch),
              "the settle's scratch lies in the tile's");

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

// The inbox heap's total order (ops/span_common.py lexsort3) of staged
// entries a and b.
STT_LAW bool row_less(const SettleScratch& x, int64_t a, int64_t b) {
  return x.t[a] != x.t[b] ? x.t[a] < x.t[b]
         : x.s[a] != x.s[b] ? x.s[a] < x.s[b]
                            : x.q[a] < x.q[b];
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
// the count of the entries below it, and of its equals before it.  With
// the remainder sorted, a remainder entry's slot is its own plus the
// arrivals below it, and an arrival's the remainder at or below it
// (a binary search) plus the arrivals below it.  The entry that lands in
// slot 0 gives the head time.
STT_LAW void settle_dest(SettleScratch& x, const RowSettle& w, bool sorted,
                         int rank, int size) {
  for (int64_t k = rank; k < w.len; k += size) {
    int64_t d = 0;
    int64_t from = 0;
    if (sorted && k < w.rem) {
      d = k;
      from = w.rem;
    } else if (sorted) {
      int64_t lo = 0, hi = w.rem;  // remainder entries at or below k
      while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (row_less(x, k, mid)) hi = mid;
        else lo = mid + 1;
      }
      d = lo;
      from = w.rem;
    }
    for (int64_t m = from; m < w.len; m++)
      if (row_less(x, m, k) || (m < k && !row_less(x, k, m))) d++;
    x.dst[k] = (int16_t)d;
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

// The row's next-event time (one rank, after the settle):
// min(inbox head, the lane's timer-heap least), as ops/tcp_span.py
// next_event_time takes it, and its length written.
STT_LAW int64_t settle_end(const RoundOps& r, const SettleScratch& x,
                           const RowSettle& w, int64_t i) {
  int64_t head = I64_MAX;
  if (w.len > w.rem) {
    r.ib_len[i] = w.len;
    head = x.head;
  } else if (w.len > 0) {
    head = STT_LOAD(&r.ib_time[w.row]);
  }
  const int64_t timer = STT_LOAD(&r.timer[i]);
  return head < timer ? head : timer;
}

// One thread's close of the round (after every packet): the outbox
// count and the abort word into the round's slot, the outbox emptied,
// and the marks the eager round end makes after the window's, in its
// order: AB_TRACE on tr_n > TR - O (when traced), then AB_STRUCT at site
// 14 on an inbox row's overflow.
STT_LAW void close_round(const Ops& o, const RoundOps& r, const Params& p,
                         int slot) {
  const int64_t n = STT_LOAD(o.out_n);
  r.words[SW_OUT_N + slot] = n;
  *o.out_n = 0;
  if (p.tracing && STT_LOAD(o.tr_n) > p.cap_tr - p.cap_out)
    *o.abort_code |= AB_TRACE;
  if (STT_LOAD(&r.words[SW_OVER])) {
    *o.abort_code |= AB_STRUCT;
    if (*o.abort_site == 0) *o.abort_site = 14;
    r.words[SW_OVER] = 0;
  }
  r.words[SW_CODE + slot] = *o.abort_code;
}

// The round loop's scalars: the reference round_cond and round_body's
// updates, read from the round's slot after the last barrier of the
// round.  An aggregate, so that the kernel keeps one copy a block in
// shared memory.
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
// The host build: the lane's timer-heap least after its window (its kept
// minimum, or a scan when an abort ended it first), then its row
// compacted by the ranks in turn.
inline void lane_done(const RoundOps& r, Lane& lane, int size) {
  if (!lane.th_ok) lane.th_min();
  r.timer[lane.i] = lane.th_t;
  const int64_t pos = lane.o.ib_pos[lane.i], len = r.ib_len[lane.i];
  for (int rank = 0; rank < size; rank++)
    compact_cols(r, lane.p, lane.i, pos, len, rank, size);
  compact_done(lane.o, r, lane.i, pos, len);
}

// Row i settled by `size` ranks run in turn, each step by every rank
// before the next; returns the row's next-event time.
inline int64_t settle_row(const RoundOps& r, const Params& p, int64_t i,
                          int size, SettleScratch& x) {
  const RowSettle w = settle_begin(r, p, i);
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

// The host build of the span: the kernel's phases in turn, every lane,
// packet and row of a phase before the next phase, each lane and row by
// a team of `team` ranks run in turn.  `order`, when given, visits the
// round's outbox packets in that order instead (a permutation of [0, n),
// drawn by the caller), which the kernel's atomic appends may do.
// Returns 0, or window_serial's 1 for a table the lane refuses.
template <class Order>
inline int span_serial(const SpanOps& so, const SpanParams& sp, int team,
                       Order order) {
  const Ops& o = so.w;
  const RoundOps& r = so.r;
  const RoundParams& q = sp.r;
  Params p = sp.w;
  if (p.cap_i > kRowMax) return 1;
  SpanRun run = SpanRun::begin(q);
  for (int slot = 0; slot < 2; slot++) {
    r.words[SW_NEXT + slot] = I64_MAX;
    r.words[SW_MIN_LAT + slot] = I64_MAX;
  }
  r.words[SW_OVER] = 0;
  if (run.go(q))
    for (int64_t x = 0; x < p.n * p.cap_i; x++) fill_rows(r, p, x);
  SettleScratch* const x = new SettleScratch;
  int err = 0;
  while (run.go(q) && !err) {
    const int slot = (int)(run.rounds & 1);
    p.window_end = run.window_end(q);
    // A: the lanes' windows, each lane's row compacted after it.
    err = window_serial(o, p, team, [&](Lane& lane, TeamScratch&) {
      lane_done(r, lane, team);
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
      STT_MIN(&r.words[SW_NEXT + slot], settle_row(r, p, i, team, *x));
    // D: the next round's scalars.
    run.advance(r.words, slot, p.window_end);
  }
  delete x;
  run.finish(r.words);
  return err;
}
#endif

}  // namespace tcp
}  // namespace stt
