// The per-round propagation law as per-lane device functions: the one
// source on the card of threefry2x32 and of the lane law of one packet
// crossing the network (ops/propagate.py propagate_ref is its plain
// PyTorch version; the engine's C++ twin is netplane.cpp finish_round).
//
//   propagate.cu  stt_propagate_round  calls propagate_lane on every
//                 packet of a round, one launch per round, and settles
//                 the round's minima with combine_minima.
//
// Integer-exact against the plain version: uint32 threefry words, int64
// times and thresholds, bools as 1-byte 0/1 (torch.bool).  Plain C++
// apart from the qualifiers, so the tier-1 tests build it for the host
// and a persistent span kernel (ROADMAP B5) can draw its loss bits from
// the same threefry.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define STT_LAW __device__ __forceinline__
#else
#define STT_LAW inline
#endif

namespace stt {

STT_LAW uint32_t rotl32(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

// Four threefry rounds with rotations r0..r3.
STT_LAW void threefry_mix4(uint32_t& x0, uint32_t& x1, int r0, int r1,
                           int r2, int r3) {
  x0 += x1; x1 = rotl32(x1, r0) ^ x0;
  x0 += x1; x1 = rotl32(x1, r1) ^ x0;
  x0 += x1; x1 = rotl32(x1, r2) ^ x0;
  x0 += x1; x1 = rotl32(x1, r3) ^ x0;
}

struct Threefry2x32 {
  uint32_t x0, x1;
};

// threefry2x32 with 20 rounds (core/rng.py threefry2x32_torch): five
// groups of four rounds, rotations (13, 15, 26, 6) and (17, 29, 16, 24)
// in turn, a key injection after each group.  Everything stays in
// registers.
STT_LAW Threefry2x32 threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                  uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  threefry_mix4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  threefry_mix4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  threefry_mix4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  threefry_mix4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  threefry_mix4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  return Threefry2x32{x0, x1};
}

struct PropagateOut {
  int64_t deliver;
  bool keep, reachable, lossy;
};

// One packet of a round (shadow_tpu/ops/propagate.py kernel body):
// `lat` and `thr` are its (src_node, dst_node) entries of the latency
// and loss-threshold matrices.  A packet is lost when its first threefry
// word, keyed by the loss stream and counted by (src_host, pkt_seq),
// falls under the threshold, unless it is a control packet or was sent
// before bootstrap ends; it is kept when reachable and not lost, and
// delivered at max(t_send + lat, window_end).
STT_LAW PropagateOut propagate_lane(int64_t lat, int64_t thr, uint32_t k0,
                                    uint32_t k1, int64_t src_host,
                                    uint32_t pkt_seq, int64_t t_send,
                                    bool is_ctl, int64_t window_end,
                                    int64_t bootstrap_end,
                                    int64_t time_never) {
  PropagateOut o;
  o.reachable = lat < time_never;
  const uint32_t bits =
      threefry2x32(k0, k1, (uint32_t)src_host, pkt_seq).x0;
  o.lossy = (int64_t)bits < thr && !is_ctl && t_send >= bootstrap_end;
  // int64 add wrapping as XLA's and torch's do (an unreachable lane adds
  // TIME_NEVER; its deliver is written but never used).
  const int64_t arrive = (int64_t)((uint64_t)t_send + (uint64_t)lat);
  o.deliver = arrive > window_end ? arrive : window_end;
  o.keep = o.reachable && !o.lossy;
  return o;
}

// The round's two minima over kept packets (deliver, latency), INT64_MAX
// where none is kept.  fold_minima folds one pair into a running pair;
// combine_minima folds the per-block partials part[2b], part[2b + 1] for
// b = rank, rank + ranks, ... < blocks: what one thread of the kernel's
// last block does before the block's own reduction, and, with rank 0 of
// one rank, the whole combine.  STT_LOAD_CG reads a partial through L2
// on the card (other blocks wrote it), plainly on the host.
#ifdef __CUDA_ARCH__
#define STT_LOAD_CG(p) ((int64_t)__ldcg((const long long*)(p)))
#else
#define STT_LOAD_CG(p) (*(p))
#endif

STT_LAW void fold_minima(int64_t& min_d, int64_t& min_l, int64_t d,
                         int64_t l) {
  min_d = d < min_d ? d : min_d;
  min_l = l < min_l ? l : min_l;
}

STT_LAW void combine_minima(const int64_t* part, int64_t blocks,
                            int64_t rank, int64_t ranks, int64_t& min_d,
                            int64_t& min_l) {
  for (int64_t b = rank; b < blocks; b += ranks) {
    fold_minima(min_d, min_l, STT_LOAD_CG(part + 2 * b),
                STT_LOAD_CG(part + 2 * b + 1));
  }
}

}  // namespace stt
