// Lane-parallel queue-scan kernels for Hopper (sm_90a).
//
// Replace the two Pallas kernels of the JAX package,
// shadow_tpu/ops/pallas_queues.py:
//   stt_bucket_step  <- make_bucket_step (law bucket_step_ref)
//   stt_codel_head   <- make_codel_head  (law codel_head_ref)
// Both are per-lane integer laws over the host lane of the TCP device
// span: one thread per lane with a grid-stride loop, integer-exact, no
// shared memory.  The laws themselves are device functions in
// queue_laws.cuh, shared with the fused relay kernels (relay.cu), which
// are what the span loop launches; these standalone kernels serve the
// laws one launch each (chip_smoke.py holds them against their plain
// versions).
//
// Bound: both move every input once and write every output once and do
// a handful of integer operations per lane, so they are bound by bytes.
//   bucket step: in 5 x i64 (bal, nxt, refill, cap, size) + i64 now +
//                1 B unlimited, out 2 x i64 + 1 B ok   = 66 B per lane
//   codel head:  in 2 x 1 B (pop, none) + 4 x i64, out 4 x 1 B + i64
//                                                      = 46 B per lane
// At H = 10,000 that is 0.66 MB and 0.46 MB over 3.35 TB/s, about
// 0.20 us and 0.14 us: far below a launch, so at this size both are
// launch-bound and the design keeps them to one launch each.  The
// scalar operands (`now`, and `size` where a caller passes one) come
// in as stride-0 operands (stride 0 reads lane 0 for every lane), so
// no broadcast (H,) tensor is materialised, unlike the Pallas wrapper.
//
// Bool outputs are written as 1-byte 0/1 values that a torch.bool
// tensor reads back.  Each entry point launches on the caller's stream
// and returns cudaGetLastError() so the wrapper can raise on a refused
// launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "queue_laws.cuh"

namespace {

__global__ void bucket_step_kernel(
    const int64_t* __restrict__ bal, const int64_t* __restrict__ nxt,
    const int64_t* __restrict__ refill, const int64_t* __restrict__ cap,
    const uint8_t* __restrict__ unlimited,
    const int64_t* __restrict__ size, int64_t size_stride,
    const int64_t* __restrict__ now, int64_t now_stride,
    int64_t refill_ns, int64_t n, int64_t* __restrict__ bal_out,
    int64_t* __restrict__ nxt_out, uint8_t* __restrict__ ok_out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const stt::BucketOut o = stt::bucket_law(
        bal[i], nxt[i], refill[i], cap[i], unlimited[i] != 0,
        size[i * size_stride], now[i * now_stride], refill_ns);
    bal_out[i] = o.bal;
    nxt_out[i] = o.nxt;
    ok_out[i] = o.ok ? 1 : 0;
  }
}

__global__ void codel_head_kernel(
    const uint8_t* __restrict__ pop, const uint8_t* __restrict__ none,
    const int64_t* __restrict__ now, int64_t now_stride,
    const int64_t* __restrict__ enq,
    const int64_t* __restrict__ bytes_after,
    const int64_t* __restrict__ first_above, int64_t target_ns,
    int64_t mtu, int64_t interval_ns, int64_t n,
    uint8_t* __restrict__ quiet_out, uint8_t* __restrict__ above_out,
    uint8_t* __restrict__ arm_out, uint8_t* __restrict__ cok_out,
    int64_t* __restrict__ fa_out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const stt::CodelHeadOut o = stt::codel_head_law(
        pop[i] != 0, none[i] != 0, now[i * now_stride], enq[i],
        bytes_after[i], first_above[i], target_ns, mtu, interval_ns);
    fa_out[i] = o.fa;
    quiet_out[i] = o.quiet ? 1 : 0;
    above_out[i] = o.above ? 1 : 0;
    arm_out[i] = o.arm ? 1 : 0;
    cok_out[i] = o.cok ? 1 : 0;
  }
}

constexpr int kThreads = 256;

int blocks_for(int64_t n) {
  // Enough blocks to cover n at one lane per thread, capped so a huge
  // lane count loops inside the grid instead (132 SMs x 16 blocks).
  int64_t b = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;
  return (int)(b < cap ? b : cap);
}

}  // namespace

extern "C" int stt_bucket_step(
    const void* bal, const void* nxt, const void* refill, const void* cap,
    const void* unlimited, const void* size, long long size_stride,
    const void* now, long long now_stride, long long refill_ns,
    long long n, void* bal_out, void* nxt_out, void* ok_out,
    void* stream) {
  if (n <= 0) return 0;
  bucket_step_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)bal, (const int64_t*)nxt, (const int64_t*)refill,
      (const int64_t*)cap, (const uint8_t*)unlimited, (const int64_t*)size,
      size_stride, (const int64_t*)now, now_stride, refill_ns, n,
      (int64_t*)bal_out, (int64_t*)nxt_out, (uint8_t*)ok_out);
  return (int)cudaGetLastError();
}

extern "C" int stt_codel_head(
    const void* pop, const void* none, const void* now, long long now_stride,
    const void* enq, const void* bytes_after, const void* first_above,
    long long target_ns, long long mtu, long long interval_ns, long long n,
    void* quiet_out, void* above_out, void* arm_out, void* cok_out,
    void* fa_out, void* stream) {
  if (n <= 0) return 0;
  codel_head_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pop, (const uint8_t*)none, (const int64_t*)now,
      now_stride, (const int64_t*)enq, (const int64_t*)bytes_after,
      (const int64_t*)first_above, target_ns, mtu, interval_ns, n,
      (uint8_t*)quiet_out, (uint8_t*)above_out, (uint8_t*)arm_out,
      (uint8_t*)cok_out, (int64_t*)fa_out);
  return (int)cudaGetLastError();
}

// Timing entry points: `reps` back-to-back launches of one kernel on
// the stream, so CUDA events around the call see device time, not the
// Python wrapper's per-call host cost.
extern "C" int stt_bucket_step_repeat(
    const void* bal, const void* nxt, const void* refill, const void* cap,
    const void* unlimited, const void* size, long long size_stride,
    const void* now, long long now_stride, long long refill_ns,
    long long n, void* bal_out, void* nxt_out, void* ok_out, int reps,
    void* stream) {
  for (int r = 0; r < reps; r++) {
    int code = stt_bucket_step(bal, nxt, refill, cap, unlimited, size,
                               size_stride, now, now_stride, refill_ns, n,
                               bal_out, nxt_out, ok_out, stream);
    if (code != 0) return code;
  }
  return 0;
}

extern "C" int stt_codel_head_repeat(
    const void* pop, const void* none, const void* now, long long now_stride,
    const void* enq, const void* bytes_after, const void* first_above,
    long long target_ns, long long mtu, long long interval_ns, long long n,
    void* quiet_out, void* above_out, void* arm_out, void* cok_out,
    void* fa_out, int reps, void* stream) {
  for (int r = 0; r < reps; r++) {
    int code = stt_codel_head(pop, none, now, now_stride, enq, bytes_after,
                              first_above, target_ns, mtu, interval_ns, n,
                              quiet_out, above_out, arm_out, cok_out,
                              fa_out, stream);
    if (code != 0) return code;
  }
  return 0;
}

extern "C" const char* stt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
