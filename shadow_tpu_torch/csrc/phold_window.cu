// The PHOLD/udp-mesh device-span window as one kernel for Hopper
// (sm_90a): stt_phold_window steps every host lane through a whole
// conservative window in one launch.
//
//   stt_phold_window  <- PholdSpanRunner._build.run's window loop,
//                        shadow_tpu/ops/phold_span.py:1675 (the fused
//                        micro-iteration :1370-1417, a jitted XLA
//                        while_loop, not Pallas), with the relays'
//                        make_bucket_step / make_codel_head
//                        (shadow_tpu/ops/pallas_queues.py:80, :119) as
//                        queue_laws.cuh's laws in the lane
//
// What bounds it.  The lane law (phold_lane.cuh) is integer control
// flow over a lane's own rows with no reuse across lanes: by bytes, a
// window must read each lane's busy/due test, the slots it dequeues and
// the packets it copies, and write the words it changes
// (ops/phold_window.py window_need_bytes): 100-350 bytes a lane on
// chip_smoke.py's exports.  What the eager loop paid instead was the
// host: dozens of eager ops and a host sync per stage guard per
// micro-iteration, each op rewriting all H lanes, and one standalone
// law-kernel launch per relay pass (ops/phold_span.py).  Here the whole
// window is one launch with no host sync: a lane runs its own
// iterations until it is neither busy nor due, so the card's time
// follows the slowest lane's iterations, each a few dependent trips to
// memory (not profiled; PERF.md).
//
// Design.  One thread per lane, grid stride, blocks of kThreads.  The
// lane's hot words (time, continuation, status, seqs, the buckets' and
// CoDel's words, ring positions) live in registers for the window and
// go back once, where changed; rings, the timer heap and counters are
// read and written at the lane's own rows.  Outbox and trace slots come
// from a warp-aggregated atomicAdd on out_n / tr_n (phold_lane.cuh
// STT_CLAIM); the abort word is an atomicOr, and a lane stops at the
// next iteration once it sees it.  The window's counters: each warp
// reduces its lanes' stage counts, law calls, iteration counts and
// first 64 iteration bits with __reduce_*_sync and one atomic each; the
// last block done (a done counter after a fence, no grid barrier)
// counts the iteration bitmaps, clears them and leaves its scratch words
// at zero for the next window.
//
// Interface: a host table of operand pointers in STT_PHOLD_OPERANDS
// order (ops/phold_window.py fills it by the names stt_phold_operands()
// returns) and one of Params words (by stt_phold_params()).  The entry
// point launches once on the caller's stream and returns
// cudaGetLastError(), so the wrapper raises on a refused launch.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "phold_lane.cuh"

namespace {

using stt::phold::kPasses;
using stt::phold::LaneStats;
using stt::phold::Ops;
using stt::phold::Params;

// Threads a block.  The lanes diverge from their first iteration, so a
// block's size buys latency hiding and spread over the SMs, not
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
        atomicAdd((unsigned long long*)&o.stats[stt::phold::ST_LANES +
                                                 stt::phold::pass_slot(q)],
                  (unsigned long long)n);
    }
  }
  const unsigned cb = __reduce_add_sync(kAll, s.calls[0]);
  const unsigned cc = __reduce_add_sync(kAll, s.calls[1]);
  const unsigned it = __reduce_max_sync(kAll, s.iters);
  if (leader) {
    if (cb)
      atomicAdd((unsigned long long*)&o.stats[stt::phold::ST_CALLS], cb);
    if (cc)
      atomicAdd((unsigned long long*)&o.stats[stt::phold::ST_CALLS + 1], cc);
    if (it)
      atomicMax((unsigned long long*)&o.stats[stt::phold::ST_WIN_MAX],
                (unsigned long long)it);
  }
}

__global__ void __launch_bounds__(kThreads)
    phold_window_kernel(const __grid_constant__ Ops o,
                        const __grid_constant__ Params p) {
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < p.n;
       base += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = base + threadIdx.x;
    LaneStats s = {};
    if (i < p.n) stt::phold::Lane(o, p, i, s).run();
    __syncwarp();
    flush_warp(o, p, s);
  }
  // The last block done settles the window's fires and iterations.
  __shared__ bool last;
  __shared__ unsigned long long fires[kPasses];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd((unsigned long long*)&o.stats[stt::phold::ST_DONE],
                     1ull) == gridDim.x - 1;
  if (threadIdx.x < kPasses) fires[threadIdx.x] = 0;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int64_t win_max = (int64_t)atomicAdd(
      (unsigned long long*)&o.stats[stt::phold::ST_WIN_MAX], 0ull);
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
      o.stats[stt::phold::ST_FIRES + stt::phold::pass_slot(q)] += fires[q];
    o.stats[stt::phold::ST_ITERS] += win_max;
    o.stats[stt::phold::ST_WIN_MAX] = 0;
    o.stats[stt::phold::ST_DONE] = 0;
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
extern "C" const char* stt_phold_operands() {
  return stt::phold::kOperands;
}
extern "C" const char* stt_phold_params() { return stt::phold::kParamNames; }
extern "C" const char* stt_phold_consts() { return stt::phold::kConsts; }
extern "C" const char* stt_phold_stats() { return stt::phold::kStats; }
extern "C" long long stt_phold_bitmap_words() {
  return stt::phold::kBitmapWords;
}

extern "C" int stt_phold_window(const void* const* ptrs,
                                const long long* words, void* stream) {
  Ops o;
  std::memcpy(&o, ptrs, sizeof(o));
  Params p;
  std::memcpy(&p, words, sizeof(p));
  if (p.n <= 0) return 0;
  phold_window_kernel<<<blocks_for(p.n), kThreads, 0,
                        (cudaStream_t)stream>>>(o, p);
  return (int)cudaGetLastError();
}

extern "C" const char* stt_phold_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
