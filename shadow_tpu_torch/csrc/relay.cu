// Fused relay-law kernels for Hopper (sm_90a): one launch per relay
// micro-op pass of the TCP device span (ops/tcp_span.py op_relay1 /
// op_relay2), computing the micro-op's whole lane-local tail in place.
//
//   stt_relay1_law  <- make_bucket_step (shadow_tpu/ops/pallas_queues.py:80)
//                      at the reference's relay-1 bucket_try site, fused
//                      with the rest of op_relay1's lane-local tail
//   stt_relay2_law  <- make_codel_head (shadow_tpu/ops/pallas_queues.py:119)
//                      with make_bucket_step, fused with the rest of
//                      op_relay2's lane-local tail
//
// What bounds them.  Both are integer laws over the 10,000-host lane
// with no reuse and no matrix product, so the bound is bytes: the mask
// byte and four flag bytes of every lane, plus, for each lane of the
// stage's mask, the words its branch reads and changes: a packet (21
// words) read and handed back where there is one, the bucket's five
// words where it is charged, the CoDel ladder's words a dequeue needs,
// the counters it bumps, and for a throttled lane the 21-word stash.  At
// the main path's occupancy that is well under a microsecond of HBM
// time.  What they take instead is the launch (a few microseconds) and,
// per lane, its chain of dependent loads: mask byte, lane words, packet.
// Reading only what each branch needs made that chain ~15 trips long
// (a relay-2 launch took ~15 us at 10% density); the lanes now load all
// their words in one trip and write back only what changed
// (queue_laws.cuh), which reads more bytes than the bound counts and
// took the same launch to ~5-6 us.
//
// What the design does about it.  The standalone law kernels
// (queues.cu) needed one launch per law plus well over a hundred eager
// PyTorch launches around each law, every one rewriting all H lanes
// (`where(mask, new, old)`).  Here each relay pass is ONE launch: the
// laws are device functions (queue_laws.cuh) inside a kernel that also
// gathers the packet, runs the CoDel ladder and the counters, and
// writes state in place for the mask's lanes only, and only the words
// that change.  A lane off the mask reads its mask byte and writes its
// four flag bytes (the flags are lane masks for the ordered appends the
// caller keeps in PyTorch).  One thread per lane, grid-stride, no
// shared memory: there is nothing to share between lanes.  Closing the remaining gap to the bound is launch work (CUDA
// graphs, then the persistent span kernel, ROADMAP B5), not a further
// redesign.
//
// Interface: a host table of operand pointers in the order of the
// STT_RELAY*_OPERANDS lists (filled per call by ops/relay.py from
// data_ptr()s, by the names stt_relay*_operands() returns) and a host
// table of RelayParams words (filled once per span build, by the names
// of stt_relay_params()).  Each entry point launches once on the
// caller's stream and returns cudaGetLastError() so the wrapper raises
// on a refused launch.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "queue_laws.cuh"

namespace {

__global__ void relay1_kernel(const stt::Relay1Ops o,
                              const stt::RelayParams p) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < p.n;
       i += (int64_t)gridDim.x * blockDim.x)
    stt::relay1_lane(o, p, i);
}

__global__ void relay2_kernel(const stt::Relay2Ops o,
                              const stt::RelayParams p) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < p.n;
       i += (int64_t)gridDim.x * blockDim.x)
    stt::relay2_lane(o, p, i);
}

// 64 threads a block: at H = 10,000 the lanes spread over every SM (157
// blocks for 132) rather than 40 of them, which cut a launch at full
// mask density from ~9.7 us to 7-8 us on an H100 (PERF.md).
constexpr int kThreads = 64;

int blocks_for(int64_t n) {
  // One lane per thread, capped so a huge lane count loops inside the
  // grid instead (132 SMs x 16 blocks).
  const int64_t b = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;
  return (int)(b < cap ? b : cap);
}

template <typename Ops, typename Kernel>
int launch(Kernel kernel, const void* const* ptrs, const long long* words,
           void* stream) {
  Ops o;
  std::memcpy(&o, ptrs, sizeof(o));
  stt::RelayParams p;
  std::memcpy(&p, words, sizeof(p));
  if (p.n <= 0) return 0;
  kernel<<<blocks_for(p.n), kThreads, 0, (cudaStream_t)stream>>>(o, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The name strings of the tables, for the wrapper to fill them by name.
extern "C" const char* stt_relay1_operands() { return stt::kRelay1Operands; }
extern "C" const char* stt_relay2_operands() { return stt::kRelay2Operands; }
extern "C" const char* stt_relay_params() { return stt::kRelayParamNames; }
extern "C" int stt_relay_plen_col() { return stt::kPlenCol; }

extern "C" int stt_relay1_law(const void* const* ptrs,
                              const long long* params, void* stream) {
  return launch<stt::Relay1Ops>(relay1_kernel, ptrs, params, stream);
}

extern "C" int stt_relay2_law(const void* const* ptrs,
                              const long long* params, void* stream) {
  return launch<stt::Relay2Ops>(relay2_kernel, ptrs, params, stream);
}

extern "C" const char* stt_relay_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
