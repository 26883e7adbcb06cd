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
// (ops/tcp_window.py window_need_bytes).  The lanes are independent, so
// the card's time follows the slowest lane's iterations, each one
// thread's chain of dependent steps (over the lane's host and conn
// words, in its frame, and its rings' words), and its row scans: at
// 10,000 hosts a tgen server's timer heap
// holds ~1,300 stale RTO entries, which one thread a lane (the earlier
// design) rescanned after every pop, one dependent load a slot, while 31
// other lanes' branches took turns on its warp.
//
// Design.  A tile of kTeam threads (one warp at kTeam = 32) steps one
// lane (tcp_lane.cuh, "the team"): rank 0 runs the lane law with the
// lane's hot words in registers, and the whole tile serves its row
// scans (the heap's least, each rank keeping its slice's least entries
// between rescans; the first free heap slot past a kept bound; the
// reassembly lookups; the SACK runs as one sorted pass in the tile's
// shared memory; the rtx ring walks; the qdisc pick), each a strided
// slice of the row and a combine by shuffles.  Tiles take lanes from a
// queue (a counter in the
// statistics words), the lanes that serve several conns (tgen servers,
// the heavy ones) first, then the rest; the grid is the card's SMs times
// the blocks the occupancy calculator fits on one.  Outbox and trace
// slots come from an atomicAdd aggregated over the leaders that claim
// together (tcp_lane.cuh STT_CLAIM); an abort lowers its iteration words
// with atomicMin, and a lane stops once its iteration passes the least
// one.  The window's counters: each leader ORs its lane's iteration bits
// into the shared bitmaps once per 32 iterations and sums its lanes'
// stage counts, law calls and iteration counts; each warp reduces them
// with __reduce_*_sync and one atomic each; the last block done (a done
// counter after a fence, no grid barrier) counts the bitmaps, clears
// them, settles the abort words into abort_code / abort_site and leaves
// its scratch words (the queues among them) as the next window needs
// them.
//
// The lane frame (tcp_lane.cuh, "the frame"): the tile gathers the
// lane's host words and the conn words of its first kFrameConns conn
// rows into shared memory when it takes the lane (cp.async, a rank a
// word), the law reads and writes them there, and the tile writes the
// changed ones back when the lane's window ends; the rows (the timer
// heap, the rings, the inbox) are what the lane still reads from device
// memory.
//
// Shared memory: one TeamScratch a tile (the SACK staging of kSackMax
// distances and lengths, padded, the ranks' counts and breaks, the
// ranks' kept heap entries and the lane frame), kTiles a block,
// dynamic.  The kernel refuses cap_ra > kSackMax.  kTeam = 32,
// kTiles = 4 and kKeep = 4 are the measured best of those tried
// (PERF.md).
//
// The profiling build (-DSTT_TCP_PROFILE, its own library,
// tools/tcp_window_profile.py) fills a row of clocks and counts per lane
// (tcp_lane.cuh STT_TCP_PROFILE_WORDS) into the buffer
// stt_tcp_profile_buffer() names, and rank 0's clocks of the tile's
// scans by op (stt_tcp_serve_profile).
//
// Interface: a host table of operand pointers in STT_TCP_OPERANDS order
// (ops/tcp_window.py fills it by the names stt_tcp_operands() returns)
// and one of Params words (by stt_tcp_params()).  The entry point
// launches once on the caller's stream and returns cudaGetLastError(),
// so the wrapper raises on a refused launch.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "tcp_tile.cuh"

namespace {

using stt::tcp::kPasses;
using stt::tcp::LaneStats;
using stt::tcp::Ops;
using stt::tcp::Params;
using stt::tcp::Req;
using stt::tcp::Team;
using stt::tcp::TeamScratch;

constexpr int kTeam = stt::tcp::kTeam;
constexpr int kTiles = stt::tcp::kTiles;
constexpr int kThreads = stt::tcp::kThreads;
constexpr int kSmem = stt::tcp::kSmem;
using stt::tcp::flush_warp;
using stt::tcp::next_lane;

#ifdef STT_TCP_PROFILE
__device__ __forceinline__ int64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (int64_t)t;
}
#endif

// One lane by its tile: the leader runs the law (its profile row filled
// in the profiling build), then releases the waiting ranks.
__device__ void leader_lane(const Ops& o, const Params& p, int64_t i,
                            LaneStats& s, const Team& t, TeamScratch& sh,
                            int64_t* prof) {
  stt::tcp::Lane lane(o, p, i, s, t, sh);
#ifdef STT_TCP_PROFILE
  using namespace stt::tcp;
  int64_t* const row = prof ? prof + i * PF_N : nullptr;
  int64_t t0 = 0;
  if (row) {
    row[PF_START_NS] = global_ns();
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    row[PF_SM] = sm;
    lane.prof_ = row;
    t0 = clock64();
  }
#endif
  lane.run();
#ifdef STT_TCP_PROFILE
  if (row) {
    row[PF_CYCLES] = clock64() - t0;
    row[PF_ITERS] = s.iters;
    row[PF_END_NS] = global_ns();
  }
#endif
  Req done = {stt::tcp::SCAN_DONE, 0, 0};
  stt::tcp::team_serve(t, o, p, i, done, sh);
}

__global__ void __launch_bounds__(kThreads, 1)
    tcp_window_kernel(const __grid_constant__ Ops o,
                      const __grid_constant__ Params p, int64_t* prof) {
  extern __shared__ __align__(16) unsigned char smem[];
  TeamScratch* const scratch = reinterpret_cast<TeamScratch*>(smem);
  const int lane_id = threadIdx.x & 31;
  Team t;
  t.base = lane_id & ~(kTeam - 1);
  t.rank = lane_id - t.base;
  t.mask = kTeam == 32 ? 0xffffffffu : ((1u << kTeam) - 1) << t.base;
  TeamScratch& sh = scratch[threadIdx.x / kTeam];
  LaneStats sum = {};  // the leader's lanes, summed
  for (;;) {
    long long i = 0;
    if (t.rank == 0) i = next_lane(o, p);
    i = __shfl_sync(t.mask, i, 0, kTeam);
    if (i >= p.n) break;
    if (t.rank == 0) {
      LaneStats s = {};
      leader_lane(o, p, i, s, t, sh, prof);
      stt::tcp::add_stats(sum, s);
    } else {
      for (;;) {
        Req rq = {0, 0, 0};
        stt::tcp::team_serve(t, o, p, i, rq, sh);
        if (rq.op == stt::tcp::SCAN_DONE) break;
      }
    }
  }
  __syncwarp();
  flush_warp(o, sum);
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
    o.stats[stt::tcp::ST_QUEUE] = 0;
    o.stats[stt::tcp::ST_QUEUE + 1] = 0;
    stt::tcp::settle_abort(o);
  }
}

// Blocks a launch on the current device: as many as it holds at once
// (its SMs times the occupancy calculator's blocks an SM), no more than
// the lanes need.  A device's first call also lets the kernel take
// kSmem there; its cap is kept per device.
constexpr int kMaxDevices = 64;
int g_cap[kMaxDevices] = {};

cudaError_t blocks_for(int64_t n, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(tcp_window_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tcp_window_kernel, kThreads, kSmem);
    if (e != cudaSuccess) return e;
    if (sms <= 0 || per_sm <= 0) return cudaErrorInvalidConfiguration;
    g_cap[dev] = sms * per_sm;
  }
  const int64_t b = (n + kTiles - 1) / kTiles;
  *blocks = (int)(b < g_cap[dev] ? b : g_cap[dev]);
  return cudaSuccess;
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

// The profiling build's buffer (PF_N int64 words a lane, zeroed by the
// caller) for the launches that follow; the main build ignores it.
static int64_t* g_prof = nullptr;
extern "C" void stt_tcp_profile_buffer(void* prof) {
  g_prof = (int64_t*)prof;
}
extern "C" const char* stt_tcp_profile_words() {
  return stt::tcp::kProfileWords;
}
extern "C" int stt_tcp_profiling() {
#ifdef STT_TCP_PROFILE
  return 1;
#else
  return 0;
#endif
}

// The profiling build's scan clocks (calls, entry wait, scan, exit wait
// cycles of rank 0, by scan op: 16 x 4 words) into `out`, then cleared;
// the main build writes nothing and returns 0 ops.
extern "C" int stt_tcp_serve_profile(unsigned long long* out) {
#ifdef STT_TCP_PROFILE
  using stt::tcp::g_serve_prof;
  cudaMemcpyFromSymbol(out, g_serve_prof, sizeof(g_serve_prof));
  static const unsigned long long zeros[stt::tcp::kScanOps][4] = {};
  cudaMemcpyToSymbol(g_serve_prof, zeros, sizeof(zeros));
  return stt::tcp::kScanOps;
#else
  (void)out;
  return 0;
#endif
}

extern "C" int stt_tcp_window(const void* const* ptrs, const long long* words,
                              void* stream) {
  Ops o;
  std::memcpy(&o, ptrs, sizeof(o));
  Params p;
  std::memcpy(&p, words, sizeof(p));
  if (p.n <= 0) return 0;
  if (p.cap_ra > stt::tcp::kSackMax) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e = blocks_for(p.n, &blocks);
  if (e != cudaSuccess) return (int)e;
  tcp_window_kernel<<<blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
      o, p, g_prof);
  return (int)cudaGetLastError();
}

// The launch's shape on the current device, for the record: threads a
// tile, tiles a block, blocks a launch at n lanes, dynamic shared memory
// a block.  Returns a CUDA error code (0 when the shape was found).
extern "C" int stt_tcp_launch_shape(long long n, long long* out) {
  int blocks = 0;
  const cudaError_t e = blocks_for(n, &blocks);
  out[0] = kTeam;
  out[1] = kTiles;
  out[2] = blocks;
  out[3] = kSmem;
  return (int)e;
}

// The lane frame's shape (tcp_lane.cuh): conn rows a frame holds, its
// bytes (a tile's), host words, conn words a row.
extern "C" void stt_tcp_frame(long long* out) {
  out[0] = stt::tcp::kFrameConns;
  out[1] = sizeof(stt::tcp::Frame);
  out[2] = stt::tcp::kHostWords;
  out[3] = stt::tcp::kConnWords;
}

extern "C" const char* stt_tcp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
