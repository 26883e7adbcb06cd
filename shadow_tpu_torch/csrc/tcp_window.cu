// The TCP steady-stream device-span window as one kernel for Hopper
// (sm_90a): stt_tcp_window steps every host lane through a whole
// conservative window in one launch.
//
//   stt_tcp_window  <- TcpSpanRunner._build.run's window loop,
//                      shadow_tpu/ops/tcp_span.py:2373 (the fused
//                      micro-iteration micro_iter :2053 under micro_cond
//                      :2133, a jitted XLA while_loop :2449, not Pallas),
//                      with the relays' make_bucket_step /
//                      make_codel_head (shadow_tpu/ops/pallas_queues.py
//                      :80, :119) as queue_laws.cuh's relay cores in the
//                      lane
//
// What bounds it.  The lane law (tcp_lane.cuh) is integer control flow
// over a lane's own rows with no reuse across lanes: by bytes, a window
// must read each lane's last busy/due test, the slots it dequeues and
// the packets it copies, and write the words it changes
// (ops/tcp_window.py window_need_bytes).  What the eager loop paid
// instead was the host: one loop-condition sync and one guard sync per
// stage per micro-iteration, dozens of eager ops per stage each
// rewriting all H lanes, and one fused relay-kernel launch per relay
// stage fire (ops/tcp_span.py).  Here the whole window is one launch
// with no host sync: a lane runs its own iterations until it is neither
// busy nor due, so the card's time follows the slowest lane's
// iterations, each a chain of dependent trips to memory (the conn's
// words, its rings, the timer heap).
//
// Design.  One thread per lane, grid stride, blocks of kThreads.  The
// lane's hot words (time, continuation registers, its conn, seqs, ring
// positions) live in registers for the window and go back once, where
// changed; conn rows, rings, the timer heap and counters are read and
// written at the lane's own rows.  The timer heap's minimum is kept
// between pops (Params.th_cache; its rows are scanned eight slots a
// word, and only up to the last word that held an entry).  Outbox and
// trace slots come from a warp-aggregated atomicAdd on out_n / tr_n
// (tcp_lane.cuh STT_CLAIM); an abort lowers its iteration words with
// atomicMin, and a lane stops once its iteration passes the least one.
// The window's counters: each lane ORs its iteration bits into the
// shared bitmaps once per 32 iterations; each warp reduces its lanes'
// stage counts, law calls and iteration counts with __reduce_*_sync and
// one atomic each; the last block done (a done counter after a fence, no
// grid barrier) counts the bitmaps, clears them, settles the abort words
// into abort_code / abort_site and leaves its scratch words as the next
// window needs them.
//
// Interface: a host table of operand pointers in STT_TCP_OPERANDS order
// (ops/tcp_window.py fills it by the names stt_tcp_operands() returns)
// and one of Params words (by stt_tcp_params()).  The entry point
// launches once on the caller's stream and returns cudaGetLastError(),
// so the wrapper raises on a refused launch.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "tcp_lane.cuh"

namespace {

using stt::tcp::kPasses;
using stt::tcp::LaneStats;
using stt::tcp::Ops;
using stt::tcp::Params;

// Threads a block.  The lanes diverge from their first iteration, so a
// block's size buys latency hiding and spread over the SMs, not
// coalescing.
constexpr int kThreads = 64;

__device__ __forceinline__ void flush_warp(const Ops& o, const LaneStats& s) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool leader = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int q = 0; q < kPasses; q++) {
    const unsigned n = __reduce_add_sync(kAll, s.lanes[q]);
    if (leader && n)
      atomicAdd((unsigned long long*)&o.stats[stt::tcp::ST_LANES +
                                               stt::tcp::pass_slot(q)],
                (unsigned long long)n);
  }
  const unsigned cb = __reduce_add_sync(kAll, s.calls[0]);
  const unsigned cc = __reduce_add_sync(kAll, s.calls[1]);
  const unsigned it = __reduce_max_sync(kAll, s.iters);
  if (leader) {
    if (cb) atomicAdd((unsigned long long*)&o.stats[stt::tcp::ST_CALLS], cb);
    if (cc)
      atomicAdd((unsigned long long*)&o.stats[stt::tcp::ST_CALLS + 1], cc);
    if (it)
      atomicMax((unsigned long long*)&o.stats[stt::tcp::ST_WIN_MAX],
                (unsigned long long)it);
  }
}

__global__ void __launch_bounds__(kThreads)
    tcp_window_kernel(const __grid_constant__ Ops o,
                      const __grid_constant__ Params p) {
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < p.n;
       base += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = base + threadIdx.x;
    LaneStats s = {};
    if (i < p.n) stt::tcp::Lane(o, p, i, s).run();
    __syncwarp();
    flush_warp(o, s);
  }
  // The last block done settles the window's fires, iterations and
  // aborts.
  __shared__ bool last;
  __shared__ unsigned long long fires[kPasses];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd((unsigned long long*)&o.stats[stt::tcp::ST_DONE],
                     1ull) == gridDim.x - 1;
  if (threadIdx.x < kPasses) fires[threadIdx.x] = 0;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int64_t win_max = (int64_t)atomicAdd(
      (unsigned long long*)&o.stats[stt::tcp::ST_WIN_MAX], 0ull);
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
      o.stats[stt::tcp::ST_FIRES + stt::tcp::pass_slot(q)] += fires[q];
    o.stats[stt::tcp::ST_ITERS] += win_max;
    o.stats[stt::tcp::ST_WIN_MAX] = 0;
    o.stats[stt::tcp::ST_DONE] = 0;
    stt::tcp::settle_abort(o);
  }
}

int blocks_for(int64_t n) {
  // One lane per thread, capped so a huge lane count loops inside the
  // grid instead (132 SMs x 16 blocks).
  const int64_t b = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;
  return (int)(b < cap ? b : cap);
}

}  // namespace

// The name strings of the tables, for the wrapper to fill them by name
// and check the loop's constants and the statistics layout.
extern "C" const char* stt_tcp_operands() { return stt::tcp::kOperands; }
extern "C" const char* stt_tcp_params() { return stt::tcp::kParamNames; }
extern "C" const char* stt_tcp_consts() { return stt::tcp::kConsts; }
extern "C" const char* stt_tcp_stats() { return stt::tcp::kStats; }
extern "C" long long stt_tcp_bitmap_words() {
  return stt::tcp::kBitmapWords;
}

extern "C" int stt_tcp_window(const void* const* ptrs, const long long* words,
                              void* stream) {
  Ops o;
  std::memcpy(&o, ptrs, sizeof(o));
  Params p;
  std::memcpy(&p, words, sizeof(p));
  if (p.n <= 0) return 0;
  tcp_window_kernel<<<blocks_for(p.n), kThreads, 0, (cudaStream_t)stream>>>(
      o, p);
  return (int)cudaGetLastError();
}

extern "C" const char* stt_tcp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
