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
// Where the time went (PERF.md: a profiling build of the kernel before
// the team, tools/phold_span_profile.py).  At one thread a lane a
// few lanes share a warp: mesh-24's 24 lanes and mesh-codel-10's 10 sat
// in one warp of one block, so each divergent lane waited while the warp
// ran the others' paths, a micro-iteration cost ~16-22 k cycles, and
// mesh-24's 24 row sorts (rows of up to 63 entries) ran the same way, a
// quarter of its span.  The timer heap's two serial scans per busy/due
// test took a fifth of those windows; a team argmin served by the
// waiting ranks cost ~2.5 k cycles a call, twice the leader's scan of
// the team's copy of the keys.  With thousands of lanes the
// opposite holds: 32 like lanes a warp share every instruction of the
// law, and a wider team ran phold-8k 30% slower.
//
// Design.  One launch a span; the host fills the operand table once,
// launches, and reads one block of span words and statistics at the end.
// A lane is stepped by a team of W threads of one warp (phold_lane.cuh,
// "the team"), W a template parameter (1, 8, 32) that the wrapper picks
// per launch from the lane count: the widest whose teams fit in a warp
// an SM, else 1 (ops/phold_span_kernel.py pick_team).  The grid is as
// many blocks of kThreads as the teams need, capped at what the card
// holds at once (the occupancy calculator's blocks per SM times the SMs),
// so that a cooperative launch keeps every block resident; teams, lanes,
// packets and rows go grid-stride.  Each round, with a grid barrier
// (cooperative_groups::this_grid().sync()) after each phase:
//
//   A  each team's lanes: the team loads the lane's heap valid bits (and,
//      W > 1, the valid keys into its shared memory), the leader steps
//      the lane through its window (phold_lane.cuh `Lane`: the hot words
//      in registers, the heap's least kept between tests and rescanned
//      from the team's copy) while the other ranks wait; the lane's heap least
//      (its last busy/due test's, or a rescan after an abort) goes to the
//      round's next-event word by a block reduction, and the team compacts
//      the lane's inbox row a rank a column (before the first round,
//      every thread fills the slots beyond the rows' lengths in inbox
//      order, fill_rows, so that a warp's stores are contiguous);
//   B  each outbox packet: propagation and its append to the destination
//      row (round_packet), the least kept latency by a block reduction
//      and one atomicMin a block; block 0 also settles the window's
//      stage fires and iterations from the iteration bitmaps;
//   C  each row: settled by its team (W > 1: the keys staged in the
//      team's scratch in shared memory, each entry's slot by a merge of
//      the sorted remainder and the arrivals, the columns moved through
//      the scratch; W = 1: the row's thread insertion-sorts it, a few
//      entries at the ring's width) and its head time, reduced into the
//      next-event word as the latency is; block 0's thread 0 closes the
//      round (close_round);
//   D  each block's thread 0: the round's scalars from the round's slot
//      of the span words into the block's copy (SpanRun, in shared
//      memory), and every thread the same round_cond decision from it.
//
// D needs no grid barrier of its own: the per-round words sit in two
// slots by the round's parity, written before a barrier and reset in the
// next round's phase B, after every block has read them (the first
// round's are reset before the launch's first barrier).  The loop's
// state lives in shared memory, one copy a block, so that it takes no
// registers from the lane's window; the window's parameters stay in the
// kernel's parameter space, where the lane reads them as the window
// kernel's does, and the round's window end goes to the lane apart.
// Data written by other blocks before a barrier is read from L2
// (STT_LOAD), so no stale L1 line is read.  A lane that sees the abort
// word stops its window early, but every thread reaches every barrier:
// the loop's decision reads the abort word only as phase C's close left
// it.
//
// The profiling build (-DSTT_PHOLD_PROFILE, its own library,
// tools/phold_span_profile.py) adds each lane's clocks and counts into
// the buffer stt_phold_span_profile_buffer() names.
//
// Interface: a host table of pointers in STT_PHOLD_OPERANDS then
// STT_ROUND_OPERANDS order (ops/phold_span_kernel.py fills it by the
// names stt_phold_span_operands() returns) and one of SpanParams words
// (by stt_phold_span_params()).  The entry point launches the team
// width's kernel once on the caller's stream with
// cudaLaunchCooperativeKernel and returns its error code (a width it
// does not hold, or a grid the card cannot hold at once, is refused), so
// the wrapper raises on a refused launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "phold_round_end.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace stt::phold;

// Threads a block, at every team width: 64 lanes of one thread, 8 teams
// of 8 or 2 of 32.  At a team of one, eight blocks an SM (registers at
// most 128 a thread) keep a grid of 1,056 blocks: the ring's 65,536
// lanes at one a thread.  A wider team runs only where the lanes' teams
// fit in a warp an SM (ops/phold_span_kernel.py pick_team), so its
// blocks are few and its registers unbounded.
constexpr int kThreads = 64;
constexpr int kMinBlocks = 8;

// A warp's lanes' counts (`s`, summed over the lanes its leaders
// stepped) into the statistics words: a __reduce_*_sync and one atomic
// each.
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

// A lane's counts added into its leader's sum.
__device__ __forceinline__ void add_stats(LaneStats& sum,
                                          const LaneStats& s) {
  for (int q = 0; q < kPasses; q++) {
    sum.bits[q] |= s.bits[q];
    sum.lanes[q] += s.lanes[q];
  }
  sum.calls[0] += s.calls[0];
  sum.calls[1] += s.calls[1];
  sum.iters = s.iters > sum.iters ? s.iters : sum.iters;
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

// Phase A for one team: its lanes (team, team + teams, ...), each with
// its heap's valid bits and keys loaded by the team, stepped through its
// window by the leader while the ranks wait; each lane's heap least (its
// kept least at the last busy/due test, or a rescan after an abort) into
// `least`, and its row compacted by the team a rank a column.  Returns
// the leader's lanes' counts summed.
// The team's copy of its lane's heap keys (shared memory, one a team of
// more than one; none at a team of one).
template <int W>
__device__ HeapStage* team_stage() {
  if constexpr (W > 1) {
    __shared__ HeapStage x[kThreads / W];
    return &x[threadIdx.x / W];
  } else {
    return nullptr;
  }
}

template <int W>
__device__ LaneStats team_windows(const Ops& o, const RoundOps& r,
                                  const Params& p, int64_t window_end,
                                  const Team<W>& t, int64_t team,
                                  int64_t teams, int64_t& least,
                                  int64_t* prof) {
  LaneStats sum = {};
  HeapStage* const stage = team_stage<W>();
  for (int64_t i = team; i < p.n; i += teams) {
    const uint64_t mask = heap_load(t, o, p, i, stage);
    int64_t pos = 0, len = 0;
    if (t.rank == 0) {
      LaneStats s = {};
      Lane lane(o, p, i, s, mask, stage, window_end);
#ifdef STT_PHOLD_PROFILE
      if (prof) lane.prof_ = prof + i * PF_N;
#endif
      lane.run();
      const int64_t timer = lane.th_min();
      least = timer < least ? timer : least;
      pos = lane.ib_pos;
      len = lane.ib_len;
      add_stats(sum, s);
    }
#ifdef STT_PHOLD_PROFILE
    const long long c0 = clock64();
#endif
    pos = team_bcast(t, pos);
    len = team_bcast(t, len);
    compact_cols(r, p, i, pos, len, t.rank, W);
    team_sync(t);
    if (t.rank == 0) compact_done(o, r, i, pos, len);
#ifdef STT_PHOLD_PROFILE
    if (prof && t.rank == 0) prof[i * PF_N + PF_COMPACT] += clock64() - c0;
#endif
  }
  return sum;
}

// The team's scratch for the row settle (shared memory, one a team).
template <int W>
__device__ SettleScratch& team_scratch(int team) {
  __shared__ SettleScratch x[kThreads / W];
  return x[team];
}

// Phase C for one team of W > 1: row i settled, each step by every rank
// before the next; returns the row's head time (on every rank).
template <int W>
__device__ int64_t team_settle(const RoundOps& r, const Params& p,
                               int64_t i, const Team<W>& t,
                               SettleScratch& x) {
  const RowSettle w = settle_begin(r, p, i);
  if (w.len > w.rem) {
    settle_stage(r, x, w, t.rank, W);
    __syncwarp(t.mask);
    const bool sorted =
        __all_sync(t.mask, settle_sorted_part(x, w, t.rank, W));
    settle_dest(x, w, sorted, t.rank, W);
    __syncwarp(t.mask);
    settle_keys(r, x, w, t.rank, W);
    for (int c = 0; c < kPk; c++) {
      __syncwarp(t.mask);
      settle_load_col(r, x, w, c, t.rank, W);
      __syncwarp(t.mask);
      settle_store_col(r, x, w, c, t.rank, W);
    }
    __syncwarp(t.mask);
  }
  long long head = 0;
  if (t.rank == 0) head = settle_end(r, x, w, i);
  head = __shfl_sync(t.mask, head, 0, W);
  __syncwarp(t.mask);
  return head;
}

// The phase clocks (SW_CLK_* order) and the last mark, block 0 thread 0's.
enum { CLK_WAIT = 3, CLK_SPAN = 4, CLK_MARK = 5 };

template <int W>
__global__ void __launch_bounds__(kThreads, W == 1 ? kMinBlocks : 1)
    phold_span_kernel(const __grid_constant__ SpanOps so,
                      const __grid_constant__ SpanParams sp,
                      int64_t* prof) {
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
  const Team<W> t = Team<W>::of_thread();
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t team = tid / W, teams = stride / W;
  if (threadIdx.x == 0) run = SpanRun::begin(q);
  // The round words' two slots reset before the first barrier: phase A
  // of the first round writes its slot's next-event word.
  if (lead) {
    for (int k = 0; k <= CLK_MARK; k++) clk[k] = 0;
    clk[CLK_SPAN] = clock64();
    for (int s = 0; s < 2; s++) {
      r.words[SW_NEXT + s] = I64_MAX;
      r.words[SW_MIN_LAT + s] = I64_MAX;
    }
  }
  // The fills beyond each row's length, once a launch, in inbox order,
  // before any compaction moves a row's length.
  if (SpanRun::begin(q).go(q)) {
    for (int64_t x = tid; x < p.n * p.cap_i; x += stride)
      fill_rows(o, r, p, x);
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
    // A: the windows, each lane's heap least and its row compacted.
    int64_t least = I64_MAX;
    const LaneStats sum =
        team_windows(o, r, p, window_end, t, team, teams, least, prof);
    __syncwarp();
    flush_warp(o, p, sum);
    block_min(least, &r.words[SW_NEXT + slot]);
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
    // C: the rows settled (by a thread at W = 1, else by a team), the
    // round closed.
    int64_t next = I64_MAX;
    for (int64_t i = team; i < p.n; i += teams) {
#ifdef STT_PHOLD_PROFILE
      const long long c0 = clock64();
#endif
      int64_t e;
      if constexpr (W > 1)
        e = team_settle(r, p, i, t, team_scratch<W>(threadIdx.x / W));
      else
        e = settle_row(r, settle_begin(r, p, i), i);
#ifdef STT_PHOLD_PROFILE
      STT_PF_USE(e);
      if (prof && t.rank == 0) prof[i * PF_N + PF_SETTLE] += clock64() - c0;
#endif
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

// The kernel of a team width (null: not an instantiated width).
const void* kernel_of(int team) {
  switch (team) {
    case 1: return (const void*)phold_span_kernel<1>;
    case 8: return (const void*)phold_span_kernel<8>;
    case 32: return (const void*)phold_span_kernel<32>;
    default: return nullptr;
  }
}

}  // namespace

// The name strings of the tables, for the wrapper to fill them by name
// and check the loop's constants, the statistics and span-word layouts;
// the team widths the library holds, widest first.
extern "C" const char* stt_phold_span_operands() { return kSpanOperands; }
extern "C" const char* stt_phold_span_params() { return kSpanParamNames; }
extern "C" const char* stt_phold_span_words() { return kSpanWords; }
extern "C" const char* stt_phold_consts() { return kConsts; }
extern "C" const char* stt_phold_stats() { return kStats; }
extern "C" long long stt_phold_bitmap_words() { return kBitmapWords; }
extern "C" const char* stt_phold_span_teams() { return "32 8 1"; }
extern "C" long long stt_phold_span_row_max() { return kRowMax; }

// The grid of a span of n lanes at team width `team`: out[0] the blocks
// its lanes need (a team a lane, kThreads / team teams a block), out[1]
// the blocks the card holds at once (the occupancy calculator's blocks
// an SM times the SMs; 0 when the card cannot launch a cooperative
// grid), out[2] the threads a block, out[3] the SMs.  Returns a CUDA
// error code.
extern "C" int stt_phold_span_grid(long long n, int team, long long* out) {
  const void* k = kernel_of(team);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads,
                                                      0);
  if (e != cudaSuccess) return (int)e;
  const long long need = (n * team + kThreads - 1) / kThreads;
  out[0] = need > 0 ? need : 1;
  out[1] = coop ? (long long)per_sm * sms : 0;
  out[2] = kThreads;
  out[3] = sms;
  return 0;
}

// The profiling build (-DSTT_PHOLD_PROFILE, its own library,
// tools/phold_span_profile.py): the buffer of PF_N words a lane
// (phold_lane.cuh STT_PHOLD_PROFILE_WORDS) the launches that follow add
// their lanes' clocks and counts into (null: none); the main build
// ignores it.
static int64_t* g_prof = nullptr;
extern "C" void stt_phold_span_profile_buffer(void* prof) {
  g_prof = (int64_t*)prof;
}
extern "C" const char* stt_phold_profile_words() { return kProfileWords; }
extern "C" int stt_phold_span_profiling() {
#ifdef STT_PHOLD_PROFILE
  return 1;
#else
  return 0;
#endif
}

// One span: the kernel of team width `team` on `blocks` blocks.  A width
// the library does not hold, a heap wider than the valid bits' register
// or, at a team of more than one, an inbox wider than the settle's
// scratch is refused (cudaErrorInvalidValue), as is a grid the card
// cannot hold at once (by the cooperative launch).
extern "C" int stt_phold_span(const void* const* ptrs,
                              const long long* words, int team, int blocks,
                              void* stream) {
  SpanOps so;
  std::memcpy(&so, ptrs, sizeof(so));
  SpanParams sp;
  std::memcpy(&sp, words, sizeof(sp));
  const void* k = kernel_of(team);
  if (k == nullptr || sp.w.cap_t > kMaskSlots ||
      (team > 1 && sp.w.cap_i > kRowMax))
    return (int)cudaErrorInvalidValue;
  int64_t* prof = g_prof;
  void* args[] = {&so, &sp, &prof};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      k, dim3(blocks), dim3(kThreads), args, 0, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* stt_phold_span_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
