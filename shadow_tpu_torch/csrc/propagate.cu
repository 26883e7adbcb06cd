// Per-round packet propagation for Hopper (sm_90a): one launch per
// round of the per-round loop (ops/propagate.py TpuPropagator).
//
//   stt_propagate  <- build_propagate_kernel.kernel
//                     (shadow_tpu/ops/propagate.py:391, body :423-440),
//                     a jitted XLA program: the round's latency gather,
//                     threefry loss draw, arrival clamp and the two
//                     minima over kept packets.
//
// What bounds it.  Per packet it reads 29 bytes (src_node, dst_node i32;
// src_host, t_send i64; pkt_seq u32; is_ctl u8) and writes 11 (deliver
// i64; keep, reachable, lossy u8), and does one threefry2x32 (20 rounds
// of add/rotate/xor, ~100 integer operations) and two gathers from a V x V
// pair of int64 matrices that a few kilobytes hold.  40 bytes against
// ~100 simple integer operations per packet is far below the card's
// operations-per-byte line, so it is bound by bytes: at a 1,048,576-packet
// round ~42 MB, ~12.5 us at 3.35 TB/s.  The rounds the per-round loop
// actually sends are far smaller (hundreds to thousands of packets), so
// there it is bound by the launch.
//
// What the design does about it.  The XLA program needed power-of-two
// padding and a compile per bucket; here any n runs as it is (a
// grid-stride loop, one thread per packet, the ragged end masked by the
// loop bound).  The threefry state lives in registers (rotations by
// __funnelshift_l).  When both matrices fit in 48 KB of shared memory
// (V <= 55; the 3-tier graph has V = 3) each block stages them there
// once, so the two gathers per packet never touch device memory;
// otherwise they go through the read-only cache.  The two minima are a
// warp-shuffle and then a block reduction, then one 64-bit atomicMin per
// block and minimum into a 2-word output that the wrapper fills with
// INT64_MAX on the same stream first: no second pass.  Node indices are
// clamped into [0, V) as XLA's gather clamps them.
//
// Interface: a plain C entry point over raw pointers; it launches once
// on the caller's stream and returns cudaGetLastError() so the wrapper
// raises on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "propagate_law.cuh"

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
  long long* mins;  // [min_deliver, min_latency] over kept packets
};

__device__ __forceinline__ long long warp_min(long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long y = __shfl_down_sync(0xffffffffu, x, off);
    x = y < x ? y : x;
  }
  return x;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    propagate_kernel(const PropagateArgs a) {
  extern __shared__ int64_t smem[];
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
  long long min_d = INT64_MAX, min_l = INT64_MAX;
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
    if (o.keep) {
      min_d = o.deliver < min_d ? o.deliver : min_d;
      min_l = l < min_l ? l : min_l;
    }
  }
  // Block minimum: warp shuffles, one word per warp, then warp 0.
  __shared__ long long part[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  min_d = warp_min(min_d);
  min_l = warp_min(min_l);
  if (lane == 0) {
    part[0][warp] = min_d;
    part[1][warp] = min_l;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
    min_d = lane < nw ? part[0][lane] : INT64_MAX;
    min_l = lane < nw ? part[1][lane] : INT64_MAX;
    min_d = warp_min(min_d);
    min_l = warp_min(min_l);
    if (lane == 0) {
      if (min_d != INT64_MAX) atomicMin(a.mins, min_d);
      if (min_l != INT64_MAX) atomicMin(a.mins + 1, min_l);
    }
  }
}

int blocks_for(int64_t n) {
  // One packet per thread, capped so a huge round loops inside the grid
  // (132 SMs x 16 blocks).
  const int64_t b = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;
  return (int)(b < cap ? b : cap);
}

}  // namespace

extern "C" int stt_propagate(
    const void* lat, const void* thr, long long v, unsigned int k0,
    unsigned int k1, const void* src_node, const void* dst_node,
    const void* src_host, const void* pkt_seq, const void* t_send,
    const void* is_ctl, long long n, long long window_end,
    long long bootstrap_end, long long time_never, void* deliver,
    void* keep, void* reachable, void* lossy, void* mins, void* stream) {
  if (n <= 0) return 0;
  const PropagateArgs a{
      (const int64_t*)lat,      (const int64_t*)thr,
      v,                        k0,
      k1,                       (const int32_t*)src_node,
      (const int32_t*)dst_node, (const int64_t*)src_host,
      (const uint32_t*)pkt_seq, (const int64_t*)t_send,
      (const uint8_t*)is_ctl,   n,
      window_end,               bootstrap_end,
      time_never,               (int64_t*)deliver,
      (uint8_t*)keep,           (uint8_t*)reachable,
      (uint8_t*)lossy,          (long long*)mins};
  const size_t smem = (size_t)(2 * v * v) * sizeof(int64_t);
  if (smem <= (size_t)kSmemMatrixBytes) {
    propagate_kernel<true><<<blocks_for(n), kThreads, smem,
                             (cudaStream_t)stream>>>(a);
  } else {
    propagate_kernel<false><<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* stt_propagate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
