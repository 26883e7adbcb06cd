// The TCP lane's tile on the card, shared by the kernels that step TCP
// lanes (tcp_window.cu stt_tcp_window, tcp_span.cu stt_tcp_span): a tile
// of kTeam threads (one warp) a lane (tcp_lane.cuh, "the team"), kTiles
// tiles a block with their scratch in dynamic shared memory, the lane
// queue the tiles take their lanes from, and each warp's flush of its
// lanes' counts into the statistics words.

#pragma once

#include <cstdint>

#include "tcp_lane.cuh"

namespace stt {
namespace tcp {

// Tiles a block: the tiles' scratch and the blocks an SM holds.
constexpr int kTiles = 4;
constexpr int kThreads = kTiles * kTeam;
// The tiles' scratch, dynamic shared memory a block (over the 48 KB a
// block gets without asking).
constexpr int kSmem = kTiles * (int)sizeof(TeamScratch);

// One warp's lanes' counts (`s`, summed over the lanes its leader
// stepped) into the statistics words: a __reduce_*_sync and one atomic
// each.
__device__ __forceinline__ void flush_warp(const Ops& o, const LaneStats& s) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool leader = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int q = 0; q < kPasses; q++) {
    const unsigned n = __reduce_add_sync(kAll, s.lanes[q]);
    if (leader && n)
      atomicAdd((unsigned long long*)&o.stats[ST_LANES + pass_slot(q)],
                (unsigned long long)n);
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

// The next lane for a tile (p.n when none is left): a first pass over
// the lanes takes those with several conn rows and a second the rest.
// Lanes are independent, so the order changes no result.
__device__ __forceinline__ int64_t next_lane(const Ops& o, const Params& p) {
  unsigned long long* const q = (unsigned long long*)&o.stats[ST_QUEUE];
  for (int pass = 0; pass < 2; pass++)
    for (;;) {
      const int64_t k = (int64_t)atomicAdd(q + pass, 1ull);
      if (k >= p.n) break;
      if ((o.conn_off[k + 1] - o.conn_off[k] > 1) == (pass == 0)) return k;
    }
  return p.n;
}

// A lane's stats summed into a warp leader's.
STT_LAW void add_stats(LaneStats& sum, const LaneStats& s) {
  for (int q = 0; q < kPasses; q++) sum.lanes[q] += s.lanes[q];
  sum.calls[0] += s.calls[0];
  sum.calls[1] += s.calls[1];
  sum.iters = s.iters > sum.iters ? s.iters : sum.iters;
}

}  // namespace tcp
}  // namespace stt
