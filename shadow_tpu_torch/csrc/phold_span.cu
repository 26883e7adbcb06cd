// The PHOLD/udp-mesh device span as one persistent kernel for Hopper
// (sm_90a): stt_phold_span runs a whole span, `max_rounds` rounds of
// window -> propagation -> inbox merge -> round scalars, in one
// cooperative launch, with grid barriers between the phases.
//
//   stt_phold_span  <- PholdSpanRunner._build.run, shadow_tpu/ops/
//                      phold_span.py:1675-1790 (a jitted XLA while_loop
//                      over rounds, round_cond :1588, round_body :1594:
//                      the fused window loop, `propagate` :1454 with the
//                      inbox lexsort :1574, the runahead update :1656),
//                      without the fabric block (ROADMAP A7a), with the
//                      relays' make_bucket_step / make_codel_head
//                      (shadow_tpu/ops/pallas_queues.py:80, :119) as
//                      queue_laws.cuh's laws in the lane
//
// What bounds it.  By bytes (ops/phold_span_kernel.py span_need_bytes):
// per round, what the window must read (each lane's last busy/due test,
// the slots it dequeues and copies) and what the round end must move
// (each outbox packet read, each kept one written at its final slot,
// each entry the compaction or the merge moves, the keys that place the
// arrivals), and each word the span changes, once: kilobytes to tens of
// megabytes a span on chip_smoke.py's exports.  What the loop paid before was the host: one
// window launch (its ~190-pointer table refilled), then the eager round
// end (propagation over the whole 16H-slot outbox, three stable argsorts
// of every inbox row) and a host sync, every round.
//
// Design.  One launch a span; the host fills the operand table once,
// launches, and reads one block of span words and statistics at the end.
// The grid is as many blocks as the lanes need, capped at what the card
// holds at once (the occupancy calculator's blocks per SM times the SMs),
// so that a cooperative launch keeps every block resident; lanes and
// packets go grid-stride.  Each round, with a grid barrier
// (cooperative_groups::this_grid().sync()) after each phase:
//
//   A  each lane: its window (phold_lane.cuh `Lane`, unchanged: the hot
//      words in registers for the window), then the compaction of its
//      own inbox row (phold_round_end.cuh compact_row; before the first
//      round, every thread fills the slots beyond the rows' lengths in
//      inbox order, fill_rows, so that a warp's stores are contiguous);
//   B  each outbox packet: propagation and its append to the destination
//      row (round_packet), the least kept latency by a block reduction
//      and one atomicMin a block; block 0 also settles the window's
//      stage fires and iterations from the iteration bitmaps;
//   C  each lane: its row sorted and its next-event time (settle_row),
//      reduced as the latency is; block 0's thread 0 closes the round
//      (close_round);
//   D  each block's thread 0: the round's scalars from the round's slot
//      of the span words into the block's copy (SpanRun, in shared
//      memory), and every thread the same round_cond decision from it.
//
// D needs no grid barrier of its own: the per-round words sit in two
// slots by the round's parity, written before a barrier and reset in the
// next round's phase B, after every block has read them.  The loop's
// state lives in shared memory, one copy a block, so that it takes no
// registers from the lane's window; the window's parameters stay in the
// kernel's parameter space, where the lane reads them as the window
// kernel's does, and the round's window end goes to the lane apart.
// Data written by other blocks before a barrier is read from L2
// (STT_LOAD), so no stale L1 line is read.  A lane that sees the abort word stops its window
// early, but every thread reaches every barrier: the loop's decision
// reads the abort word only as phase C's close left it.
//
// Interface: a host table of pointers in STT_PHOLD_OPERANDS then
// STT_ROUND_OPERANDS order (ops/phold_span_kernel.py fills it by the
// names stt_phold_span_operands() returns) and one of SpanParams words
// (by stt_phold_span_params()).  The entry point launches once on the
// caller's stream with cudaLaunchCooperativeKernel and returns its error
// code (a grid the card cannot hold at once is refused there), so the
// wrapper raises on a refused launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "phold_round_end.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace stt::phold;

// Threads a block, as the window kernel's: the lanes diverge from their
// first iteration, so a block's size buys latency hiding, not
// coalescing.
constexpr int kThreads = 64;

__device__ __forceinline__ void flush_warp(const Ops& o, const Params& p,
                                           const LaneStats& s) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool leader = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int q = 0; q < kPasses; q++) {
    const unsigned lo = __reduce_or_sync(kAll, (unsigned)s.bits[q]);
    const unsigned hi = __reduce_or_sync(kAll, (unsigned)(s.bits[q] >> 32));
    const unsigned n = __reduce_add_sync(kAll, s.lanes[q]);
    if (leader) {
      uint32_t* const words = o.bitmap + q * p.bitmap_words;
      if (lo) atomicOr(words, lo);
      if (hi) atomicOr(words + 1, hi);
      if (n)
        atomicAdd((unsigned long long*)&o.stats[ST_LANES + pass_slot(q)],
                  (unsigned long long)n);
    }
  }
  const unsigned cb = __reduce_add_sync(kAll, s.calls[0]);
  const unsigned cc = __reduce_add_sync(kAll, s.calls[1]);
  const unsigned it = __reduce_max_sync(kAll, s.iters);
  if (leader) {
    if (cb) atomicAdd((unsigned long long*)&o.stats[ST_CALLS], cb);
    if (cc) atomicAdd((unsigned long long*)&o.stats[ST_CALLS + 1], cc);
    if (it)
      atomicMax((unsigned long long*)&o.stats[ST_WIN_MAX],
                (unsigned long long)it);
  }
}

// Block 0, phase B: the window's fires (the iteration bitmaps counted
// and cleared) and iterations (the largest lane count), as the window
// kernel's last block settles them.
__device__ void settle_window(const Ops& o, const Params& p) {
  __shared__ unsigned long long fires[kPasses];
  if (threadIdx.x < kPasses) fires[threadIdx.x] = 0;
  __syncthreads();
  const int64_t win_max = STT_LOAD(&o.stats[ST_WIN_MAX]);
  const int64_t words = (win_max + 31) / 32;
  for (int q = 0; q < kPasses; q++) {
    unsigned long long c = 0;
    for (int64_t w = threadIdx.x; w < words; w += blockDim.x)
      c += __popc(atomicExch(o.bitmap + q * p.bitmap_words + w, 0u));
    if (c) atomicAdd(&fires[q], c);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 0; q < kPasses; q++)
      o.stats[ST_FIRES + pass_slot(q)] += fires[q];
    o.stats[ST_ITERS] += win_max;
    o.stats[ST_WIN_MAX] = 0;
  }
}

// The least of every thread's `v` into `word`: a warp shuffle, the
// block's warps in shared memory, one atomicMin a block.
__device__ void block_min(int64_t v, int64_t* word) {
  __shared__ long long part[kThreads / 32];
  long long x = v;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long y = __shfl_down_sync(0xffffffffu, x, off);
    x = y < x ? y : x;
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; w++) x = part[w] < x ? part[w] : x;
    if (x < I64_MAX) STT_MIN(word, x);
  }
}

// The phase clocks (SW_CLK_* order) and the last mark, block 0 thread 0's.
enum { CLK_WAIT = 3, CLK_SPAN = 4, CLK_MARK = 5 };

__global__ void __launch_bounds__(kThreads)
    phold_span_kernel(const __grid_constant__ SpanOps so,
                      const __grid_constant__ SpanParams sp) {
  cg::grid_group grid = cg::this_grid();
  const Ops& o = so.w;
  const RoundOps& r = so.r;
  const RoundParams& q = sp.r;
  // The window's parameters stay in the parameter space (read-only, so
  // no store can alias them); each round's window end goes to the lanes
  // apart.  Per block, the same in every block: the round loop's scalars
  // (thread 0 writes them, between block barriers).  Block 0's thread 0
  // keeps the phase clocks.
  const Params& p = sp.w;
  __shared__ SpanRun run;
  __shared__ long long clk[CLK_MARK + 1];
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (threadIdx.x == 0) run = SpanRun::begin(q);
  // The fills beyond each row's length, once a launch, in inbox order,
  // before any compaction moves a row's length.
  if (SpanRun::begin(q).go(q)) {
    for (int64_t x = tid; x < p.n * p.cap_i; x += stride)
      fill_rows(o, r, p, x);
    grid.sync();
  }
  if (lead) {
    for (int k = 0; k <= CLK_MARK; k++) clk[k] = 0;
    clk[CLK_SPAN] = clock64();
    for (int s = 0; s < 2; s++) {
      r.words[SW_NEXT + s] = I64_MAX;
      r.words[SW_MIN_LAT + s] = I64_MAX;
    }
  }
  __syncthreads();
  // A phase's end: the grid barrier; the phase's clock runs from its
  // start to the barrier's exit (so it holds the slowest thread's work),
  // and the time inside the barrier is summed apart.
  auto phase_end = [&](int phase) {
    const long long t = lead ? clock64() : 0;
    grid.sync();
    if (lead) {
      const long long t2 = clock64();
      clk[phase] += t2 - clk[CLK_MARK];
      clk[CLK_WAIT] += t2 - t;
      clk[CLK_MARK] = t2;
    }
  };
  while (run.go(q)) {
    const int slot = (int)(run.rounds & 1);
    const int64_t window_end = run.window_end(q);
    if (lead) clk[CLK_MARK] = clock64();
    // A: the windows, then each owner's row compacted.
    for (int64_t base = tid - threadIdx.x; base < p.n; base += stride) {
      const int64_t i = base + threadIdx.x;
      LaneStats s = {};
      if (i < p.n) {
        Lane lane(o, p, i, s, window_end);
        lane.run();
        compact_row(o, r, p, i, lane.ib_pos, lane.ib_len);
      }
      __syncwarp();
      flush_warp(o, p, s);
    }
    phase_end(0);
    // B: the outbox, and block 0 settles the window's counts.
    if (blockIdx.x == 0) settle_window(o, p);
    if (lead) {
      r.words[SW_NEXT + 1 - slot] = I64_MAX;
      r.words[SW_MIN_LAT + 1 - slot] = I64_MAX;
    }
    const int64_t n_out = STT_LOAD(o.out_n);
    const int64_t n = n_out < p.cap_out ? n_out : p.cap_out;
    int64_t min_lat = I64_MAX;
    for (int64_t j = tid; j < n; j += stride) {
      const int64_t lat = round_packet(o, r, p, q, window_end, j);
      min_lat = lat < min_lat ? lat : min_lat;
    }
    block_min(min_lat, &r.words[SW_MIN_LAT + slot]);
    phase_end(1);
    // C: the rows settled, the round closed.
    int64_t next = I64_MAX;
    for (int64_t i = tid; i < p.n; i += stride) {
      const int64_t e = settle_row(o, r, p, i);
      next = e < next ? e : next;
    }
    block_min(next, &r.words[SW_NEXT + slot]);
    if (lead) close_round(o, r, p, slot);
    phase_end(2);
    // D: the next round's scalars.
    if (threadIdx.x == 0) run.advance(r.words, slot, window_end);
    __syncthreads();
  }
  if (lead) {
    run.finish(r.words);
    for (int k = 0; k < CLK_SPAN; k++) r.words[SW_CLK_WINDOW + k] = clk[k];
    r.words[SW_CLK_SPAN] = clock64() - clk[CLK_SPAN];
  }
}

}  // namespace

// The name strings of the tables, for the wrapper to fill them by name
// and check the loop's constants, the statistics and span-word layouts.
extern "C" const char* stt_phold_span_operands() { return kSpanOperands; }
extern "C" const char* stt_phold_span_params() { return kSpanParamNames; }
extern "C" const char* stt_phold_span_words() { return kSpanWords; }
extern "C" const char* stt_phold_consts() { return kConsts; }
extern "C" const char* stt_phold_stats() { return kStats; }
extern "C" long long stt_phold_bitmap_words() { return kBitmapWords; }

// The grid a span of n lanes launches with: blocks for every lane, at
// most what the card holds at once; 0 when the card cannot launch a
// cooperative grid.  Negative: a CUDA error code.
extern "C" int stt_phold_span_grid(long long n) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, phold_span_kernel, kThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return 0;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)per_sm * sms;
  const long long b = need < cap ? need : cap;
  return (int)(b > 0 ? b : 1);
}

extern "C" int stt_phold_span(const void* const* ptrs,
                              const long long* words, int blocks,
                              void* stream) {
  SpanOps so;
  std::memcpy(&so, ptrs, sizeof(so));
  SpanParams sp;
  std::memcpy(&sp, words, sizeof(sp));
  void* args[] = {&so, &sp};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)phold_span_kernel, dim3(blocks), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* stt_phold_span_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
