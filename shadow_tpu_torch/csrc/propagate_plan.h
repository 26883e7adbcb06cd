/* The plan of per-round propagation (csrc/propagate.cu
 * stt_propagate_round): everything one round's launch needs that does
 * not change from round to round, built once per round stage and
 * capacity (ops/propagate.py RoundStage) or per call of the tensor API
 * (Propagate.launch), so that a round is one C call of three arguments.
 *
 * Plain C: ops/propagate.py mirrors SttPropagatePlan field by field as a
 * ctypes.Structure, and the tier-1 tests build this header for the host
 * and hold its sizeof/offsetof, and stt_round_layout, against the
 * mirror. */

#pragma once

#include <stdint.h>

/* The kernel's grid cap (132 SMs x 16 blocks) and so the partial minima
 * a plan's scratch holds. */
#define STT_PROPAGATE_MAX_BLOCKS 2112

/* Byte offsets of one n-packet round in the round buffer, the inputs in
 * export order with the 8-byte columns first, the two minima at the next
 * multiple of 8, then the outputs:
 *
 *   [src_host | t_send | src_node | dst_node | pkt_seq | is_ctl]
 *   [pad to 8 | mins (2 x i64) | deliver | keep | reachable | lossy]
 *
 * so every column lies aligned to its width, the inputs are one copy in
 * and the minima and outputs one copy out. */
typedef struct SttRoundLayout {
  int64_t src_host, t_send, src_node, dst_node, pkt_seq, is_ctl;
  int64_t mins, deliver, keep, reachable, lossy, total;
} SttRoundLayout;

static inline SttRoundLayout stt_round_layout(int64_t n) {
  SttRoundLayout o;
  o.src_host = 0;
  o.t_send = 8 * n;
  o.src_node = 16 * n;
  o.dst_node = 20 * n;
  o.pkt_seq = 24 * n;
  o.is_ctl = 28 * n;
  o.mins = (29 * n + 7) & ~(int64_t)7;
  o.deliver = o.mins + 16;
  o.keep = o.deliver + 8 * n;
  o.reachable = o.keep + n;
  o.lossy = o.reachable + n;
  o.total = o.lossy + n;
  return o;
}

/* The columns in the kernel's order, for a plan over the caller's
 * tensors (`buf_host` NULL). */
enum {
  STT_COL_SRC_NODE, STT_COL_DST_NODE, STT_COL_SRC_HOST, STT_COL_PKT_SEQ,
  STT_COL_T_SEND, STT_COL_IS_CTL, STT_COL_DELIVER, STT_COL_KEEP,
  STT_COL_REACHABLE, STT_COL_LOSSY, STT_COL_MINS, STT_NCOLS
};

typedef struct SttPropagatePlan {
  /* The law's constants: the (v, v) int64 latency and loss-threshold
   * matrices on the card, the loss stream's key, bootstrap_end and
   * TIME_NEVER. */
  const int64_t* lat;
  const int64_t* thr;
  int64_t v;
  uint32_t k0, k1;
  int64_t bootstrap_end;
  int64_t time_never;
  /* The round buffer, laid out by stt_round_layout: its host address,
   * the address the card reads it at (mapped pinned memory), and a
   * buffer on the card of the same size (NULL: none).  A round of at
   * least copy_min packets is copied to buf_dev, run there and copied
   * back; a smaller one is run in place over the bus.  cap: the
   * packets the buffers hold. */
  uint8_t* buf_host;
  uint8_t* buf_mapped;
  uint8_t* buf_dev;
  int64_t cap;
  int64_t copy_min;
  /* With buf_host NULL: the caller's columns on the card (STT_COL_*). */
  void* cols[STT_NCOLS];
  /* On the card: 2 x STT_PROPAGATE_MAX_BLOCKS partial minima, then the
   * last-block ticket (zero between launches). */
  int64_t* scratch;
  /* The CUDA stream, and two timing events (NULL: none). */
  void* stream;
  void* events[2];
  /* 0: return after the launch (and the copies).  Else wait for the
   * round's stream at most wait_ns and fail past it. */
  int64_t wait_ns;
  int32_t device;
  /* Record the events around the launch on every time_every-th call
   * that waits (0: never). */
  int32_t time_every;
  /* Written by the calls: how many were made, how many of them were
   * timed and their card time in all, and whether the last round went
   * through buf_dev. */
  int64_t calls;
  int64_t timed;
  double kernel_ms;
  int32_t copied;
  int32_t pad;
} SttPropagatePlan;
