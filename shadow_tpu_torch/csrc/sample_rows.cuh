// The sim-time channels' round-boundary samples, the law both span
// kernels (stt_tcp_span, stt_phold_span) run after a round's row settle:
// the reference round_body's netstat and fabric blocks
// (shadow_tpu/ops/tcp_span.py:2288-2357, shadow_tpu/ops/phold_span.py:
// 1602-1655), as the eager loops run them (ops/span_common.py
// `fabric_values`, ops/tcp_span.py `sample`).
//
// A round [start, window_end) samples a channel iff it crosses the
// channel's grid (`sampled`: the stateless rule of the engine and the
// object path).  The sampled round takes the channel's next row: every
// TCP conn its TEL_FIELDS (`tel_sample`, a column of a conn), every host
// its fabric row (`fab_sample`, a column of a host): the activity mask,
// the CoDel queue's depth, bytes and head sojourn, its enqueue, drop and
// mark counts, each relay bucket's balance at window_end (refills due by
// then added, `bucket_peek`) and stall count, and the link counters.
// Rows are laid out row-major, [row * width + column], int64 throughout;
// a row at or past the buffer's `rows` is not written (the runner clamps
// a recording span to its rows, so it never happens).
//
// Plain C++ apart from the qualifiers; the state words are read with
// STT_LOAD_CG (past the L1 on the card: other blocks wrote them before
// the grid barrier that ended the window).

#pragma once

#include <cstdint>

#include "propagate_law.cuh"

namespace stt {

// A fabric row's columns (ops/span_common.py FAB_COLS): the activity
// mask, then FB_REC's fields; a TEL row's (ops/tcp_span.py TEL_FIELDS).
constexpr int kFabCols = 15;
constexpr int kTelCols = 10;

// The operand tables' extra pointers of the rows' expansions: an entry
// whose key ends in "_%" stands for kTelCols pointers, "_&" for
// kFabCols (the table's one pointer each already counted).
constexpr int sample_pointers(const char* s) {
  int n = 0;
  for (int i = 2; s[i] != 0; i++)
    if (s[i] == '|' && s[i - 2] == '_')
      n += s[i - 1] == '%' ? kTelCols - 1 : s[i - 1] == '&' ? kFabCols - 1 : 0;
  return n;
}

// The activity bits (trace/events.py FB_ACT_*).
constexpr int64_t FB_ACT_CODEL = 1, FB_ACT_TB_OUT = 2, FB_ACT_TB_IN = 4,
                  FB_ACT_LINK = 8;

// Does the round [start, window_end) cross the grid of `iv` (0: off)?
STT_LAW bool sampled(int64_t start, int64_t window_end, int64_t iv) {
  return iv > 0 && start / iv != window_end / iv;
}

// Relay bucket balance at `t` without stepping the bucket.
STT_LAW int64_t bucket_peek(int64_t next, int64_t bal, int64_t cap,
                            int64_t refill, int64_t t, int64_t refill_ns) {
  if (next == 0 || t < next) return bal;
  const int64_t adv = bal + (1 + (t - next) / refill_ns) * refill;
  return adv < cap ? adv : cap;
}

// The state columns a fabric sample reads, per host (cq_enq: the CoDel
// ring's enqueue times, `cq_cap` a host).
struct FabSrc {
  const int64_t *cq_len, *cq_pos, *cq_enq, *bytes, *enq, *drops, *marks;
  const int64_t *pending[2], *bal[2], *next[2], *cap[2], *refill[2],
      *stalls[2];
  const int64_t *psent, *bsent, *precv, *brecv;
};

// Host i's fabric row at `window_end`: column i of row `row` of the
// kFabCols buffers `fab` (rows x n).
STT_LAW void fab_sample(const FabSrc& s, int64_t* const* fab, int64_t row,
                        int64_t n, int64_t i, int64_t window_end,
                        int64_t cq_cap, int64_t refill_ns) {
  const int64_t pos = STT_LOAD_CG(&s.cq_pos[i]);
  const int64_t depth = STT_LOAD_CG(&s.cq_len[i]) - pos;
  const int64_t psent = STT_LOAD_CG(&s.psent[i]);
  const int64_t precv = STT_LOAD_CG(&s.precv[i]);
  int64_t v[kFabCols];
  v[0] = (depth > 0 ? FB_ACT_CODEL : 0) |
         (STT_LOAD_CG(&s.pending[0][i]) == 1 ? FB_ACT_TB_OUT : 0) |
         (STT_LOAD_CG(&s.pending[1][i]) == 1 ? FB_ACT_TB_IN : 0) |
         (psent + precv > 0 ? FB_ACT_LINK : 0);
  v[1] = depth;
  v[2] = STT_LOAD_CG(&s.bytes[i]);
  v[3] = depth > 0
             ? window_end - STT_LOAD_CG(&s.cq_enq[i * cq_cap + pos % cq_cap])
             : 0;
  v[4] = STT_LOAD_CG(&s.enq[i]);
  v[5] = STT_LOAD_CG(&s.drops[i]);
  v[6] = STT_LOAD_CG(&s.marks[i]);
  for (int r = 0; r < 2; r++) {
    v[7 + 2 * r] = bucket_peek(STT_LOAD_CG(&s.next[r][i]),
                               STT_LOAD_CG(&s.bal[r][i]), s.cap[r][i],
                               s.refill[r][i], window_end, refill_ns);
    v[8 + 2 * r] = STT_LOAD_CG(&s.stalls[r][i]);
  }
  v[11] = psent;
  v[12] = STT_LOAD_CG(&s.bsent[i]);
  v[13] = precv;
  v[14] = STT_LOAD_CG(&s.brecv[i]);
  for (int c = 0; c < kFabCols; c++) fab[c][row * n + i] = v[c];
}

// Conn c's TEL row: column c of row `row` of the kTelCols buffers `tel`
// (rows x conns) from the conn columns `cols`.
STT_LAW void tel_sample(const int64_t* const* cols, int64_t* const* tel,
                        int64_t row, int64_t conns, int64_t c) {
  for (int k = 0; k < kTelCols; k++)
    tel[k][row * conns + c] = STT_LOAD_CG(&cols[k][c]);
}

// A span's sample rows: the rows taken so far, a channel each.  Every
// block keeps a copy (advanced alike, from the round's start and end).
struct SampleRun {
  int64_t tel_n, fab_n;

  STT_LAW void count(int64_t start, int64_t window_end, int64_t tel_iv,
                     int64_t fab_iv) {
    tel_n += sampled(start, window_end, tel_iv);
    fab_n += sampled(start, window_end, fab_iv);
  }
};

}  // namespace stt
