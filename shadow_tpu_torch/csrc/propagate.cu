// Per-round packet propagation for Hopper (sm_90a): one C call and one
// launch per round of the per-round loop (ops/propagate.py
// TpuPropagator).
//
//   stt_propagate_round  <- build_propagate_kernel.kernel
//                           (shadow_tpu/ops/propagate.py:391, body
//                           :423-440), a jitted XLA program: the round's
//                           latency gather, threefry loss draw, arrival
//                           clamp and the two minima over kept packets.
//
// What bounds it.  Per packet it reads 29 bytes (src_node, dst_node i32;
// src_host, t_send i64; pkt_seq u32; is_ctl u8) and writes 11 (deliver
// i64; keep, reachable, lossy u8), and does one threefry2x32 (20 rounds
// of add/rotate/xor, ~100 integer operations) and two gathers from a V x V
// pair of int64 matrices that a few kilobytes hold.  40 bytes against
// ~100 simple integer operations per packet is far below the card's
// operations-per-byte line, so the kernel is bound by bytes: at a
// 1,048,576-packet round ~42 MB, ~12.5 us at 3.35 TB/s.  The rounds the
// per-round loop actually sends are far smaller (the 10,000-host tier's
// median is 150 packets), and there a round is bound by what surrounds
// the launch: the host's copies, its calls and its waits.
//
// What the design does about it.
// - The round buffer is pinned host memory mapped into the card's
//   address space (stt_propagate_host_alloc), laid out by
//   propagate_plan.h stt_round_layout.  The host writes the engine's
//   columns there; a round under the plan's copy_min packets is run in
//   place, the kernel reading the columns and writing the results and
//   the minima over the bus, with no copy either way.  A larger round,
//   where reads over the bus cost more than two copies, is copied to a
//   buffer on the card in one cudaMemcpyAsync, run there and copied back
//   in one more.  Both branches launch the same kernel; the size alone
//   chooses.
// - The minima are settled in the kernel: each block reduces its own
//   (warp shuffles, then one word per warp), a one-block round writes
//   them directly, and in a larger grid each block writes its pair to
//   the plan's scratch, fences and takes a ticket; the last block folds
//   the partials (propagate_law.cuh combine_minima), writes the two
//   words and resets the ticket for the next round.  No fill launch, no
//   atomics on the minima.
// - Everything that does not change from round to round is in the plan
//   (propagate_plan.h), built once; a round is stt_propagate_round(plan,
//   n, window_end): the copies if large, the launch, the timing events on
//   every plan.time_every-th round (two event records and the elapsed
//   time cost ~8 us of host a round, a third of the call), and a bounded
//   wait on the plan's own stream.
// - The lane loop is as before: any n runs as it is (a grid-stride loop,
//   one thread per packet, the ragged end masked by the loop bound); the
//   threefry state lives in registers (rotations by __funnelshift_l);
//   when both matrices fit in 48 KB of shared memory (V <= 55; the 3-tier
//   graph has V = 3) each block stages them there once, otherwise they
//   are read through the read-only cache.  Node indices are clamped into
//   [0, V) as XLA's gather clamps them.
//
// Interface: plain C entry points over raw pointers and the plan; each
// returns a cudaError_t code, which the wrapper raises on.

#include <chrono>
#include <cstdint>
#include <cuda_runtime.h>

#include "propagate_law.cuh"
#include "propagate_plan.h"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMatrixBytes = 48 * 1024;

struct PropagateArgs {
  const int64_t* lat;
  const int64_t* thr;
  int64_t v;
  uint32_t k0, k1;
  const int32_t* src_node;
  const int32_t* dst_node;
  const int64_t* src_host;
  const uint32_t* pkt_seq;
  const int64_t* t_send;
  const uint8_t* is_ctl;
  int64_t n;
  int64_t window_end, bootstrap_end, time_never;
  int64_t* deliver;
  uint8_t* keep;
  uint8_t* reachable;
  uint8_t* lossy;
  int64_t* mins;     // [min_deliver, min_latency] over kept packets
  int64_t* part;     // 2 x gridDim.x partial minima (grids of > 1 block)
  unsigned int* ticket;
};

__device__ __forceinline__ long long warp_min(long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long y = __shfl_down_sync(0xffffffffu, x, off);
    x = y < x ? y : x;
  }
  return x;
}

// The block's minimum pair on thread 0 (warp shuffles, one word per
// warp, then warp 0).  `red` is the block's shared scratch.
__device__ __forceinline__ void block_min(int64_t& min_d, int64_t& min_l,
                                          long long (*red)[kThreads / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  min_d = warp_min(min_d);
  min_l = warp_min(min_l);
  __syncthreads();  // `red` may still be read from an earlier call
  if (lane == 0) {
    red[0][warp] = min_d;
    red[1][warp] = min_l;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
    min_d = warp_min(lane < nw ? red[0][lane] : INT64_MAX);
    min_l = warp_min(lane < nw ? red[1][lane] : INT64_MAX);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    propagate_kernel(const PropagateArgs a) {
  extern __shared__ int64_t smem[];
  __shared__ long long red[2][kThreads / 32];
  __shared__ bool last;
  const int64_t vv = a.v * a.v;
  const int64_t* lat = a.lat;
  const int64_t* thr = a.thr;
  if (kStaged) {
    for (int64_t j = threadIdx.x; j < vv; j += blockDim.x) {
      smem[j] = a.lat[j];
      smem[vv + j] = a.thr[j];
    }
    __syncthreads();
    lat = smem;
    thr = smem + vv;
  }
  int64_t min_d = INT64_MAX, min_l = INT64_MAX;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t s = a.src_node[i], d = a.dst_node[i];
    s = s < 0 ? 0 : (s >= a.v ? a.v - 1 : s);
    d = d < 0 ? 0 : (d >= a.v ? a.v - 1 : d);
    const int64_t k = s * a.v + d;
    const int64_t l =
        kStaged ? lat[k] : (int64_t)__ldg((const long long*)(lat + k));
    const int64_t t =
        kStaged ? thr[k] : (int64_t)__ldg((const long long*)(thr + k));
    const stt::PropagateOut o = stt::propagate_lane(
        l, t, a.k0, a.k1, a.src_host[i], a.pkt_seq[i], a.t_send[i],
        a.is_ctl[i] != 0, a.window_end, a.bootstrap_end, a.time_never);
    a.deliver[i] = o.deliver;
    a.keep[i] = o.keep ? 1 : 0;
    a.reachable[i] = o.reachable ? 1 : 0;
    a.lossy[i] = o.lossy ? 1 : 0;
    if (o.keep) stt::fold_minima(min_d, min_l, o.deliver, l);
  }
  block_min(min_d, min_l, red);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) {
      a.mins[0] = min_d;
      a.mins[1] = min_l;
    }
    return;
  }
  // Several blocks: publish this block's pair, and the last block to
  // finish settles the round's.
  if (threadIdx.x == 0) {
    a.part[2 * blockIdx.x] = min_d;
    a.part[2 * blockIdx.x + 1] = min_l;
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  min_d = min_l = INT64_MAX;
  stt::combine_minima(a.part, gridDim.x, threadIdx.x, blockDim.x, min_d,
                      min_l);
  block_min(min_d, min_l, red);
  if (threadIdx.x == 0) {
    a.mins[0] = min_d;
    a.mins[1] = min_l;
    *a.ticket = 0;  // the next round's launch starts from 0
  }
}

int blocks_for(int64_t n) {
  // One packet per thread (one block for an empty round, which writes
  // the minima), capped so a huge round loops inside the grid.
  const int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) return 1;
  return (int)(b < STT_PROPAGATE_MAX_BLOCKS ? b : STT_PROPAGATE_MAX_BLOCKS);
}

cudaError_t wait_stream(cudaStream_t s, int64_t limit_ns) {
  // Spin on the stream with a deadline: a round that never ends fails
  // the call instead of hanging the caller.
  const auto t0 = std::chrono::steady_clock::now();
  for (;;) {
    const cudaError_t e = cudaStreamQuery(s);
    if (e != cudaErrorNotReady) return e;
    if (std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - t0)
            .count() > limit_ns)
      return cudaErrorTimeout;
  }
}

}  // namespace

extern "C" int stt_propagate_round(SttPropagatePlan* p, long long n,
                                   long long window_end) {
  if (n < 0 || (p->buf_host != nullptr && n > p->cap))
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != p->device) err = cudaSetDevice(p->device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)p->stream;
  PropagateArgs a{};
  a.lat = p->lat;
  a.thr = p->thr;
  a.v = p->v;
  a.k0 = p->k0;
  a.k1 = p->k1;
  a.n = n;
  a.window_end = window_end;
  a.bootstrap_end = p->bootstrap_end;
  a.time_never = p->time_never;
  a.part = p->scratch;
  a.ticket = (unsigned int*)(p->scratch + 2 * STT_PROPAGATE_MAX_BLOCKS);
  const SttRoundLayout L = stt_round_layout(n);
  p->copied = 0;
  if (p->buf_host != nullptr) {
    uint8_t* base = p->buf_mapped;
    if (p->buf_dev != nullptr && n >= p->copy_min) {
      p->copied = 1;
      base = p->buf_dev;
      err = cudaMemcpyAsync(base, p->buf_host, (size_t)L.mins,
                            cudaMemcpyHostToDevice, s);
      if (err != cudaSuccess) return (int)err;
    }
    a.src_node = (const int32_t*)(base + L.src_node);
    a.dst_node = (const int32_t*)(base + L.dst_node);
    a.src_host = (const int64_t*)(base + L.src_host);
    a.pkt_seq = (const uint32_t*)(base + L.pkt_seq);
    a.t_send = (const int64_t*)(base + L.t_send);
    a.is_ctl = base + L.is_ctl;
    a.mins = (int64_t*)(base + L.mins);
    a.deliver = (int64_t*)(base + L.deliver);
    a.keep = base + L.keep;
    a.reachable = base + L.reachable;
    a.lossy = base + L.lossy;
  } else {
    void* const* c = p->cols;
    a.src_node = (const int32_t*)c[STT_COL_SRC_NODE];
    a.dst_node = (const int32_t*)c[STT_COL_DST_NODE];
    a.src_host = (const int64_t*)c[STT_COL_SRC_HOST];
    a.pkt_seq = (const uint32_t*)c[STT_COL_PKT_SEQ];
    a.t_send = (const int64_t*)c[STT_COL_T_SEND];
    a.is_ctl = (const uint8_t*)c[STT_COL_IS_CTL];
    a.deliver = (int64_t*)c[STT_COL_DELIVER];
    a.keep = (uint8_t*)c[STT_COL_KEEP];
    a.reachable = (uint8_t*)c[STT_COL_REACHABLE];
    a.lossy = (uint8_t*)c[STT_COL_LOSSY];
    a.mins = (int64_t*)c[STT_COL_MINS];
  }
  const bool timed = p->events[0] != nullptr && p->events[1] != nullptr &&
                     p->wait_ns > 0 && p->time_every > 0 &&
                     p->calls % p->time_every == 0;
  p->calls++;
  if (timed && (err = cudaEventRecord((cudaEvent_t)p->events[0], s)) !=
                   cudaSuccess)
    return (int)err;
  const size_t smem = (size_t)(2 * p->v * p->v) * sizeof(int64_t);
  if (smem <= (size_t)kSmemMatrixBytes) {
    propagate_kernel<true><<<blocks_for(n), kThreads, smem, s>>>(a);
  } else {
    propagate_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (timed && (err = cudaEventRecord((cudaEvent_t)p->events[1], s)) !=
                   cudaSuccess)
    return (int)err;
  if (p->copied &&
      (err = cudaMemcpyAsync(p->buf_host + L.mins, p->buf_dev + L.mins,
                             (size_t)(L.total - L.mins),
                             cudaMemcpyDeviceToHost, s)) != cudaSuccess)
    return (int)err;
  if (p->wait_ns <= 0) return 0;
  if ((err = wait_stream(s, p->wait_ns)) != cudaSuccess) return (int)err;
  if (timed) {
    float ms = 0.0f;
    err = cudaEventElapsedTime(&ms, (cudaEvent_t)p->events[0],
                               (cudaEvent_t)p->events[1]);
    p->kernel_ms += ms;
    p->timed++;
  }
  return (int)err;
}

// The round buffer: `bytes` of pinned host memory mapped into the card's
// address space; *host is its host address and *mapped the address the
// card reads it at.  Fails (and frees it) if the memory is not mapped.
extern "C" int stt_propagate_host_alloc(long long bytes, void** host,
                                        void** mapped) {
  *host = *mapped = nullptr;
  cudaError_t err = cudaHostAlloc(host, (size_t)bytes, cudaHostAllocMapped);
  if (err != cudaSuccess) return (int)err;
  err = cudaHostGetDevicePointer(mapped, *host, 0);
  if (err == cudaSuccess && *mapped == nullptr) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) {
    cudaFreeHost(*host);
    *host = *mapped = nullptr;
  }
  return (int)err;
}

extern "C" int stt_propagate_host_free(void* host) {
  return (int)cudaFreeHost(host);
}

// Two timing events for a plan's events[] (and their release).
extern "C" int stt_propagate_events_create(void** events) {
  cudaError_t err = cudaEventCreate((cudaEvent_t*)&events[0]);
  if (err == cudaSuccess) err = cudaEventCreate((cudaEvent_t*)&events[1]);
  return (int)err;
}

extern "C" int stt_propagate_events_destroy(void** events) {
  for (int i = 0; i < 2; i++) {
    if (events[i] != nullptr) cudaEventDestroy((cudaEvent_t)events[i]);
    events[i] = nullptr;
  }
  return 0;
}

extern "C" const char* stt_propagate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
