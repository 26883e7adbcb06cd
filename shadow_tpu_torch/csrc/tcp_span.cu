// The TCP steady-stream device span as one persistent kernel for Hopper
// (sm_90a): stt_tcp_span runs a whole span, `max_rounds` rounds of
// window -> propagation -> inbox merge -> round scalars, in one
// cooperative launch, with grid barriers between the phases.
//
//   stt_tcp_span  <- TcpSpanRunner._build.run, shadow_tpu/ops/
//                    tcp_span.py:2373 (a jitted XLA while_loop over
//                    rounds :2449, round_cond :2274, round_body :2280:
//                    the fused window loop, `propagate` :2142 with the
//                    inbox lexsort :2260, the runahead update), without
//                    the netstat and fabric blocks (ROADMAP A7a), with
//                    the relays' make_bucket_step / make_codel_head
//                    (shadow_tpu/ops/pallas_queues.py:80, :119) as
//                    queue_laws.cuh's laws in the lane
//
// What bounds it.  By bytes (ops/tcp_span_kernel.py
// tcp_span_need_bytes): per round, what the window must read (each
// lane's last busy/due test, the slots it dequeues, the packets it
// copies) and what the round end must move (each outbox packet read,
// each kept one written at its final slot, each entry the compaction or
// the merge moves, the keys that place the arrivals), and each word the
// span changes, once.  What the loop paid before was the host: one
// window launch (stt_tcp_window), then the eager round end (propagation
// over the whole outbox, three stable argsorts of every inbox row of
// 24 columns: ~28 ms a round at 10,000 hosts) and a host sync, every
// round.  Within a round the card's time follows the slowest lane's
// window, as in stt_tcp_window: the window phase takes ~98% of a
// 10,000-host span's cycles (PERF.md), set by a tgen server's law, one
// thread's chain of dependent steps over its host and conn words and
// the tile's scans of its rows (the timer heap's least ~25 k cycles a
// call).  The lane frame (tcp_lane.cuh, "the frame") holds those words
// in the tile's shared memory for the window; they were mostly L1 hits
// before, so the chain's length, not where its words live, sets the
// time at 10,000 hosts.
//
// Design.  One launch a span; the host fills the operand table once,
// launches, and reads one block of span words and statistics at the
// end.  The grid is as many blocks as the lanes need, capped at what the
// card holds at once (the occupancy calculator's blocks per SM times the
// SMs), so that a cooperative launch keeps every block resident.  Each
// round, with a grid barrier (cooperative_groups::this_grid().sync())
// after each phase:
//
//   A  each tile (tcp_tile.cuh: 32 threads, 4 a block) takes lanes from
//      the servers-first queue and steps each through its window with
//      tcp_lane.cuh's lane law (the leader runs the law, the tile its row
//      scans; the tile gathers the lane's frame first and writes its
//      changed words back at the window's end, before the compaction
//      below reads the lane's position); the leader keeps the lane's
//      timer-heap least (the lane's kept minimum at its last busy/due
//      test) and the tile compacts the lane's inbox row, a rank a
//      column (before the first round, every thread fills the slots
//      beyond the rows' lengths in inbox order, fill_rows, so that a
//      warp's stores are contiguous);
//   B  each outbox packet: propagation, a drop's counts and trace line,
//      a kept packet's append to its destination row (round_packet), the
//      least kept latency by a block reduction and one atomicMin a
//      block; block 0 also settles the window (its stage fires from the
//      iteration bitmaps, its iterations, its abort words into
//      abort_code / abort_site) and resets the lane queue;
//   C  each tile: its rows settled (the keys staged in the tile's
//      scratch, each entry's final slot, the 24 columns moved through
//      the scratch a column at a time) and their next-event times,
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
// kernel's does, and each round's window end goes to the lane apart.
// Data written by other blocks before a barrier is read with STT_LOAD
// (tcp_lane.cuh: past the L1).  A lane that sees an abort stops its
// window early, but every thread reaches every barrier: the loop's
// decision reads the abort word only as phase C's close left it.
//
// Interface: a host table of pointers in STT_TCP_OPERANDS then
// STT_TCP_ROUND_OPERANDS order (ops/tcp_span_kernel.py fills it by the
// names stt_tcp_span_operands() returns) and one of SpanParams words (by
// stt_tcp_span_params()).  The entry point launches once on the caller's
// stream with cudaLaunchCooperativeKernel and returns its error code (a
// grid the card cannot hold at once is refused there), so the wrapper
// raises on a refused launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "tcp_round_end.cuh"
#include "tcp_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace stt::tcp;
using stt::kPk;

// Block 0, phase B: the window's fires (the iteration bitmaps counted
// and cleared), its iterations (the largest lane count) and its aborts,
// and the lane queue reset, as the window kernel's last block settles
// them.
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
    o.stats[ST_QUEUE] = 0;
    o.stats[ST_QUEUE + 1] = 0;
    settle_abort(o);
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
  __syncthreads();
}

// Phase A for one tile: lanes from the queue, each stepped through its
// window, its timer-heap least kept and its row compacted by the tile.
// Returns the leader's lanes' counts summed.
__device__ __noinline__ LaneStats tile_windows(const Ops& o,
                                               const RoundOps& r,
                                               const Params& p,
                                               int64_t window_end,
                                               const Team& t,
                                               TeamScratch& sh) {
  LaneStats sum = {};
  for (;;) {
    long long i = 0;
    if (t.rank == 0) i = next_lane(o, p);
    i = __shfl_sync(t.mask, i, 0, kTeam);
    if (i >= p.n) break;
    if (t.rank == 0) {
      LaneStats s = {};
      Lane lane(o, p, i, s, t, sh, window_end);
      lane.run();
      // The heap's least as the lane's last busy/due test left it (an
      // abort may end the window before one: then a scan).
      if (!lane.th_ok) lane.th_min();
      r.timer[i] = lane.th_t;
      Req done = {SCAN_DONE, 0, 0};
      team_serve(t, o, p, i, done, sh);
      add_stats(sum, s);
    } else {
      for (;;) {
        Req rq = {0, 0, 0};
        team_serve(t, o, p, i, rq, sh);
        if (rq.op == SCAN_DONE) break;
      }
    }
    // The team's last __syncwarp ordered the leader's stores.
    const int64_t pos = STT_LOAD(&o.ib_pos[i]), len = STT_LOAD(&r.ib_len[i]);
    compact_cols(r, p, i, pos, len, t.rank, kTeam);
    __syncwarp(t.mask);
    if (t.rank == 0) compact_done(o, r, i, pos, len);
  }
  return sum;
}

// Phase C for one tile: row i settled, each step by every rank before
// the next; returns the row's next-event time (on every rank).
__device__ __noinline__ int64_t tile_settle(const RoundOps& r,
                                            const Params& p, int64_t i,
                                            const Team& t,
                                            SettleScratch& x) {
  const RowSettle w = settle_begin(r, p, i);
  if (w.len > w.rem) {
    settle_stage(r, x, w, t.rank, kTeam);
    __syncwarp(t.mask);
    const bool sorted = __all_sync(t.mask,
                                   settle_sorted_part(x, w, t.rank, kTeam));
    settle_dest(x, w, sorted, t.rank, kTeam);
    __syncwarp(t.mask);
    settle_keys(r, x, w, t.rank, kTeam);
    for (int c = 0; c < kPk; c++) {
      __syncwarp(t.mask);
      settle_load_col(r, x, w, c, t.rank, kTeam);
      __syncwarp(t.mask);
      settle_store_col(r, x, w, c, t.rank, kTeam);
    }
    __syncwarp(t.mask);
  }
  long long next = 0;
  if (t.rank == 0) next = settle_end(r, x, w, i);
  next = __shfl_sync(t.mask, next, 0, kTeam);
  __syncwarp(t.mask);
  return next;
}

// The phase clocks (SW_CLK_* order) and the last mark, block 0 thread 0's.
enum { CLK_WAIT = 3, CLK_SPAN = 4, CLK_MARK = 5 };

__global__ void __launch_bounds__(kThreads, 1)
    tcp_span_kernel(const __grid_constant__ SpanOps so,
                    const __grid_constant__ SpanParams sp) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const Ops& o = so.w;
  const RoundOps& r = so.r;
  const RoundParams& q = sp.r;
  const Params& p = sp.w;
  // Per block, the same in every block: the round loop's scalars (thread
  // 0 writes them, between block barriers).  Block 0's thread 0 keeps
  // the phase clocks.
  __shared__ SpanRun run;
  __shared__ long long clk[CLK_MARK + 1];
  const int lane_id = threadIdx.x & 31;
  Team t;
  t.base = lane_id & ~(kTeam - 1);
  t.rank = lane_id - t.base;
  t.mask = kTeam == 32 ? 0xffffffffu : ((1u << kTeam) - 1) << t.base;
  const int tile = threadIdx.x / kTeam;
  TeamScratch& sh = reinterpret_cast<TeamScratch*>(smem)[tile];
  SettleScratch& settle = reinterpret_cast<SettleScratch&>(sh);
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tiles = (int64_t)gridDim.x * kTiles;
  const int64_t my_tile = (int64_t)blockIdx.x * kTiles + tile;
  if (threadIdx.x == 0) run = SpanRun::begin(q);
  if (lead) {
    for (int k = 0; k <= CLK_MARK; k++) clk[k] = 0;
    clk[CLK_SPAN] = clock64();
    for (int s = 0; s < 2; s++) {
      r.words[SW_NEXT + s] = I64_MAX;
      r.words[SW_MIN_LAT + s] = I64_MAX;
    }
    r.words[SW_OVER] = 0;
  }
  // The fills beyond each row's length, once a launch, in inbox order,
  // before any compaction moves a row's length.
  if (SpanRun::begin(q).go(q)) {
    for (int64_t x = tid; x < p.n * p.cap_i; x += stride)
      fill_rows(r, p, x);
    grid.sync();
  }
  __syncthreads();
  // A phase's end: the grid barrier; the phase's clock runs from its
  // start to the barrier's exit (so it holds the slowest thread's work),
  // and the time inside the barrier is summed apart.
  auto phase_end = [&](int phase) {
    const long long t0 = lead ? clock64() : 0;
    grid.sync();
    if (lead) {
      const long long t2 = clock64();
      clk[phase] += t2 - clk[CLK_MARK];
      clk[CLK_WAIT] += t2 - t0;
      clk[CLK_MARK] = t2;
    }
  };
  while (run.go(q)) {
    const int slot = (int)(run.rounds & 1);
    const int64_t window_end = run.window_end(q);
    if (lead) clk[CLK_MARK] = clock64();
    // A: the windows, each lane's row compacted by its tile.
    const LaneStats sum = tile_windows(o, r, p, window_end, t, sh);
    __syncwarp();
    flush_warp(o, sum);
    phase_end(0);
    // B: the outbox, and block 0 settles the window.
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
    for (int64_t i = my_tile; i < p.n; i += tiles) {
      const int64_t e = tile_settle(r, p, i, t, settle);
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
extern "C" const char* stt_tcp_span_operands() { return kSpanOperands; }
extern "C" const char* stt_tcp_span_params() { return kSpanParamNames; }
extern "C" const char* stt_tcp_span_words() { return kSpanWords; }
extern "C" const char* stt_tcp_span_consts() { return kSpanConsts; }
extern "C" const char* stt_tcp_span_stats() { return kStats; }
extern "C" long long stt_tcp_span_bitmap_words() { return kBitmapWords; }

// The grid a span of n lanes launches with: blocks for every lane (kTiles
// lanes a block), at most what the card holds at once; 0 when the card
// cannot launch a cooperative grid.  Negative: a CUDA error code.  The
// first call also lets the kernel take its dynamic shared memory.
extern "C" int stt_tcp_span_grid(long long n) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(tcp_span_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tcp_span_kernel, kThreads, kSmem);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return 0;
  const long long need = (n + kTiles - 1) / kTiles;
  const long long cap = (long long)per_sm * sms;
  const long long b = need < cap ? need : cap;
  return (int)(b > 0 ? b : 1);
}

extern "C" int stt_tcp_span(const void* const* ptrs, const long long* words,
                            int blocks, void* stream) {
  SpanOps so;
  std::memcpy(&so, ptrs, sizeof(so));
  SpanParams sp;
  std::memcpy(&sp, words, sizeof(sp));
  if (sp.w.cap_ra > kSackMax || sp.w.cap_i > kRowMax)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&so, &sp};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)tcp_span_kernel, dim3(blocks), dim3(kThreads), args,
      kSmem, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The launch's shape on the current device, for the record: threads a
// tile, tiles a block, blocks a launch at n lanes, dynamic shared memory
// a block.  Returns a CUDA error code (0 when the shape was found).
extern "C" int stt_tcp_span_launch_shape(long long n, long long* out) {
  const int b = stt_tcp_span_grid(n);
  out[0] = kTeam;
  out[1] = kTiles;
  out[2] = b > 0 ? b : 0;
  out[3] = kSmem;
  return b < 0 ? -b : 0;
}

// The lane frame's shape (tcp_lane.cuh): conn rows a frame holds, its
// bytes (a tile's), host words, conn words a row.
extern "C" void stt_tcp_span_frame(long long* out) {
  out[0] = kFrameConns;
  out[1] = sizeof(Frame);
  out[2] = kHostWords;
  out[3] = kConnWords;
}

extern "C" const char* stt_tcp_span_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
