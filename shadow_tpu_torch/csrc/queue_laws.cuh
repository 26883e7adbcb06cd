// The queue laws of the TCP device span as per-lane device functions:
// the one source on the card of the token-bucket and CoDel-head laws
// (ops/queues.py bucket_step_ref / codel_head_ref are their plain
// PyTorch versions) and of the two relay micro-ops' lane-local tails
// built from them (ops/relay.py relay1_law_ref / relay2_law_ref).
//
//   queues.cu  stt_bucket_step / stt_codel_head   call bucket_law /
//              codel_head_law, one law per launch;
//   relay.cu   stt_relay1_law / stt_relay2_law    call relay1_lane /
//              relay2_lane, a relay micro-op's whole lane-local tail per
//              launch, in place.
//
// Everything here is integer-exact against the plain versions:
// int64 lanes, bools read as 1-byte 0/1 (torch.bool) or as int64 0/1
// state words, floor division where the plain version floors.  The
// functions are plain C++ apart from the qualifiers, so a persistent
// span kernel (ROADMAP B5) can call them from its own lane loop.

#pragma once

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define STT_LAW __device__ __forceinline__
#define STT_SQRT_RN(x) __dsqrt_rn(x)
#define STT_UNROLL _Pragma("unroll")
#else
#include <cmath>
#define STT_LAW inline
#define STT_SQRT_RN(x) std::sqrt(x)
#define STT_UNROLL
#endif

namespace stt {

// Floor division for a positive divisor.  JAX (and torch) `//` floors;
// C++ `/` truncates toward zero, which differs for the lanes with
// now < nxt (a negative numerator).
STT_LAW int64_t floor_div_pos(int64_t a, int64_t b) {
  int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Two's-complement product, wrapping as torch's and XLA's int64 `*` do.
STT_LAW int64_t mul_wrap(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}

struct BucketOut {
  int64_t bal, nxt;
  bool ok;
};

// Token-bucket refill + conformance (netplane token_bucket twin): first
// touch (nxt == 0) arms the bucket; otherwise a lazy catch-up refill of
// k whole intervals, capped at cap; then the conformance check and debit.
STT_LAW BucketOut bucket_law(int64_t bal, int64_t nxt, int64_t refill,
                             int64_t cap, bool unlimited, int64_t size,
                             int64_t now, int64_t refill_ns) {
  const bool first = nxt == 0;
  int64_t k = 1 + floor_div_pos(now - nxt, refill_ns);
  if (k < 0) k = 0;
  const bool do_ref = !first && now >= nxt;
  int64_t bal2 = bal;
  if (do_ref) {
    const int64_t topped = bal + k * refill;
    bal2 = cap < topped ? cap : topped;
  }
  BucketOut o;
  o.nxt = first ? now + refill_ns : (do_ref ? nxt + k * refill_ns : nxt);
  o.ok = unlimited || size <= bal2;
  o.bal = (!unlimited && o.ok) ? bal2 - size : bal2;
  return o;
}

struct CodelHeadOut {
  bool quiet, above, arm, cok;
  int64_t fa;
};

// CoDel head classification of one relay dequeue (netplane codel_pop
// dequeue_raw twin).  `bytes_after` is the queue byte count after the pop.
STT_LAW CodelHeadOut codel_head_law(bool pop, bool none, int64_t now,
                                    int64_t enq, int64_t bytes_after,
                                    int64_t first_above, int64_t target_ns,
                                    int64_t mtu, int64_t interval_ns) {
  CodelHeadOut o;
  // Sojourn vs target with the MTU standing-queue escape.
  o.quiet = pop && (now - enq < target_ns || bytes_after <= mtu);
  o.above = pop && !o.quiet;
  o.arm = o.above && first_above == 0;
  o.cok = o.above && !o.arm && now >= first_above;
  o.fa = (o.quiet || none) ? 0 : (o.arm ? now + interval_ns : first_above);
  return o;
}

// CoDel's control law t + interval / sqrt(count) in the reference's
// fixed point: g = isqrt(count << 32) from a correctly rounded float64
// sqrt and two +-1 corrections each way (IEEE sqrt is correctly rounded
// on the CPU and here, and the int64 products wrap alike), then
// t + (100 ms << 16) / max(g, 1).  Exact for 0 <= count < 2**31.
STT_LAW int64_t control_time(int64_t t, int64_t count) {
  const int64_t v = (int64_t)((uint64_t)count << 32);
  int64_t g = (int64_t)STT_SQRT_RN((double)v);
  if (mul_wrap(g, g) > v) g -= 1;
  if (mul_wrap(g, g) > v) g -= 1;
  if (mul_wrap(g + 1, g + 1) <= v) g += 1;
  if (mul_wrap(g + 1, g + 1) <= v) g += 1;
  if (g < 1) g = 1;
  return t + ((int64_t)100000000 << 16) / g;
}

// ---------------------------------------------------------------------
// The relay micro-ops' lane-local tails.
// ---------------------------------------------------------------------

constexpr int kPk = 21;       // packet columns (tcp_span.py PK_KEYS)
constexpr int kPlenCol = 12;  // PK_KEYS.index("plen"): a constant, so the
                              // packet stays in registers

// Each table below is written once, as an X-macro that makes both the
// struct the kernel reads and the name string the wrapper (ops/relay.py)
// fills it by, so its order lives in this one place.
//
// The per-launch constants of both relay laws, int64 words: X(field).
#define STT_RELAY_PARAMS(X)                                             \
  X(n)           /* host lanes */                                       \
  X(ring)        /* relay 1: CAP_OP (conn egress ring); relay 2: CAP_CQ \
                    (host CoDel ring) */                                \
  X(conns)       /* relay 1: CC (sel clamps to CC - 1) */               \
  X(dc_stride)   /* row stride of drop_causes, in words */              \
  X(refill_ns)                                                          \
  X(target_ns)                                                          \
  X(mtu)                                                                \
  X(interval_ns) /* CoDel first_above arm horizon */                    \
  X(hdr)         /* TCP_TOTAL_HDR */

// The operands of one relay law: X(type, field, key, dims).  `key` names
// what the wrapper points the field at: a span-state key; a lane
// argument of the call ("mask", "pop", "sel"); "drop_causes", the
// relay's column of that (n, TEL_N) array at its row stride; or "out.*",
// an output buffer the wrapper owns.  A key ending in "_*" stands for
// one pointer per packet column in PK_KEYS order (the field is then an
// array of kPk).  `dims` is the operand's shape: n host lanes, ring the
// ring width, conns+1 the conn-major rows (trash row last).  Const
// fields are only read; the rest are written in place.  Bools are 1-byte
// 0/1 (torch.bool); every other operand is int64.
#define STT_RELAY1_OPERANDS(X)                                        \
  X(const uint8_t*, mask, "mask", "n")   /* the stage's lanes */      \
  X(const uint8_t*, pop, "pop", "n")     /* a queued conn was picked */ \
  X(const int64_t*, sel, "sel", "n")     /* its conn row (-1: none) */ \
  X(const int64_t*, now, "now", "n")                                  \
  X(const int64_t*, h_fault, "h_fault", "n")                          \
  X(const int64_t*, refill, "r1_refill", "n")                         \
  X(const int64_t*, cap, "r1_cap", "n")                               \
  X(const int64_t*, unlimited, "r1_unlimited", "n")                   \
  X(const int64_t*, op_pos, "op_pos", "conns+1")                      \
  X(const int64_t*, ring[kPk], "op_*", "conns+1,ring")                \
  X(int64_t*, pk_valid, "r1_pk_valid", "n")                           \
  X(int64_t*, bal, "r1_bal", "n")                                     \
  X(int64_t*, nxt, "r1_next", "n")                                    \
  X(int64_t*, stalls, "r1_stalls", "n")                               \
  X(int64_t*, pending, "r1_pending", "n")                             \
  X(int64_t*, fwd_pkts, "r1_fwd_pkts", "n")                           \
  X(int64_t*, fwd_bytes, "r1_fwd_bytes", "n")                         \
  X(int64_t*, pkts_sent, "pkts_sent", "n")                            \
  X(int64_t*, pkts_dropped, "pkts_dropped", "n")                      \
  X(int64_t*, eth_psent, "eth_psent", "n")                            \
  X(int64_t*, eth_bsent, "eth_bsent", "n")                            \
  X(int64_t*, stash[kPk], "r1_pk_*", "n")                             \
  X(int64_t*, drop_cause, "drop_causes", "n,*") /* TEL_LINK_DOWN */   \
  X(uint8_t*, throttled, "out.throttled", "n")                        \
  X(uint8_t*, linkdn, "out.linkdn", "n")                              \
  X(uint8_t*, fwd, "out.fwd", "n") /* not dropped at a dead NIC */    \
  X(uint8_t*, done, "out.done", "n")                                  \
  X(int64_t*, when, "out.when", "n") /* throttled: next refill */     \
  X(int64_t*, pk[kPk], "out.pk_*", "n") /* the lane's packet */

#define STT_RELAY2_OPERANDS(X)                                        \
  X(const uint8_t*, mask, "mask", "n")                                \
  X(const int64_t*, now, "now", "n")                                  \
  X(const int64_t*, cq_len, "cq_len", "n")                            \
  X(const int64_t*, refill, "r2_refill", "n")                         \
  X(const int64_t*, cap, "r2_cap", "n")                               \
  X(const int64_t*, unlimited, "r2_unlimited", "n")                   \
  X(const int64_t*, cq_enq, "cq_enq", "n,ring")                       \
  X(const int64_t*, ring[kPk], "cq_*", "n,ring")                      \
  X(int64_t*, pk_valid, "r2_pk_valid", "n")                           \
  X(int64_t*, cq_pos, "cq_pos", "n")                                  \
  X(int64_t*, codel_bytes, "codel_bytes", "n")                        \
  X(int64_t*, first_above, "codel_first_above", "n")                  \
  X(int64_t*, dropping, "codel_dropping", "n")                        \
  X(int64_t*, chain, "cd_chain", "n")                                 \
  X(int64_t*, sniff, "cd_sniff", "n")                                 \
  X(int64_t*, count, "codel_count", "n")                              \
  X(int64_t*, last_count, "codel_last_count", "n")                    \
  X(int64_t*, drop_next, "codel_drop_next", "n")                      \
  X(int64_t*, dropped, "codel_dropped", "n")                          \
  X(int64_t*, drop_bytes, "codel_drop_bytes", "n")                    \
  X(int64_t*, pkts_dropped, "pkts_dropped", "n")                      \
  X(int64_t*, bal, "r2_bal", "n")                                     \
  X(int64_t*, nxt, "r2_next", "n")                                    \
  X(int64_t*, stalls, "r2_stalls", "n")                               \
  X(int64_t*, pending, "r2_pending", "n")                             \
  X(int64_t*, fwd_pkts, "r2_fwd_pkts", "n")                           \
  X(int64_t*, fwd_bytes, "r2_fwd_bytes", "n")                         \
  X(int64_t*, eth_precv, "eth_precv", "n")                            \
  X(int64_t*, eth_brecv, "eth_brecv", "n")                            \
  X(int64_t*, stash[kPk], "r2_pk_*", "n")                             \
  X(int64_t*, drop_cause, "drop_causes", "n,*") /* TEL_CODEL */       \
  X(uint8_t*, codel_drop, "out.codel_drop", "n")                      \
  X(uint8_t*, throttled, "out.throttled", "n")                        \
  X(uint8_t*, fwd, "out.fwd", "n")                                    \
  X(uint8_t*, done, "out.done", "n")                                  \
  X(int64_t*, when, "out.when", "n")                                  \
  X(int64_t*, pk[kPk], "out.pk_*", "n")

#define STT_PARAM_FIELD(field) int64_t field;
#define STT_PARAM_NAME(field) #field " "
#define STT_OPERAND_FIELD(type, field, key, dims) type field;
#define STT_OPERAND_ENTRY(type, field, key, dims) #type "|" key "|" dims ";"

struct RelayParams {
  STT_RELAY_PARAMS(STT_PARAM_FIELD)
};
struct Relay1Ops {
  STT_RELAY1_OPERANDS(STT_OPERAND_FIELD)
};
struct Relay2Ops {
  STT_RELAY2_OPERANDS(STT_OPERAND_FIELD)
};

// The name strings: "field field ..." and "type|key|dims;...".
constexpr char kRelayParamNames[] = STT_RELAY_PARAMS(STT_PARAM_NAME);
constexpr char kRelay1Operands[] = STT_RELAY1_OPERANDS(STT_OPERAND_ENTRY);
constexpr char kRelay2Operands[] = STT_RELAY2_OPERANDS(STT_OPERAND_ENTRY);

// Pointers an operand string stands for: one per entry, kPk per "_*" key.
constexpr int operand_pointers(const char* s) {
  int n = 0;
  for (int i = 0; s[i] != 0; i++) {
    if (s[i] == ';') n += 1;
    if (s[i] == '|' && i >= 2 && s[i - 1] == '*' && s[i - 2] == '_')
      n += kPk - 1;
  }
  return n;
}
constexpr int count_char(const char* s, char c) {
  int n = 0;
  for (int i = 0; s[i] != 0; i++) n += s[i] == c;
  return n;
}
static_assert(sizeof(RelayParams) ==
                  count_char(kRelayParamNames, ' ') * sizeof(int64_t),
              "RelayParams: one int64 word per name");
static_assert(sizeof(Relay1Ops) ==
                  operand_pointers(kRelay1Operands) * sizeof(void*),
              "Relay1Ops: one pointer per name");
static_assert(sizeof(Relay2Ops) ==
                  operand_pointers(kRelay2Operands) * sizeof(void*),
              "Relay2Ops: one pointer per name");

// How the lanes below spend their time.  A lane's cost on the card is
// its chain of dependent loads (each a trip to memory), not its bytes:
// the mask byte, then the lane's words, then its packet (relay 1: the
// picked conn's ring position first).  So each lane of the mask loads
// every word a branch of it may need at once, one trip for all, and
// writes back only the words that change.  A lane off the mask reads its
// mask byte only; `pk` is handed back on lanes with a packet and `when`
// on throttled lanes.

// The relay-1 (inet-out drain) tail of lane i after the qdisc pick: the
// packet (the throttled stash or the picked conn's ring head), the eth
// send counters, the r1 token bucket, the stash of a throttled packet,
// the forward counters and the NIC-link-down drop.
STT_LAW void relay1_lane(const Relay1Ops& o, const RelayParams& p,
                         int64_t i) {
  if (!o.mask[i]) {
    o.throttled[i] = o.linkdn[i] = o.fwd[i] = o.done[i] = 0;
    return;
  }
  // One trip: the lane's words.
  const bool use_pend = o.pk_valid[i] == 1;
  const bool pop = o.pop[i] != 0;
  int64_t s = o.sel[i];
  const int64_t now = o.now[i], fault = o.h_fault[i];
  const int64_t bal0 = o.bal[i], nxt0 = o.nxt[i], refill = o.refill[i],
                cap = o.cap[i], unlimited = o.unlimited[i];
  const int64_t stalls = o.stalls[i], fwd_pkts = o.fwd_pkts[i],
                fwd_bytes = o.fwd_bytes[i], sent = o.pkts_sent[i],
                dropped = o.pkts_dropped[i], psent = o.eth_psent[i],
                bsent = o.eth_bsent[i];
  if (!use_pend && !pop) {  // nothing to send: the drain is done
    o.throttled[i] = o.linkdn[i] = o.fwd[i] = 0;
    o.done[i] = 1;
    return;
  }
  // The packet: the stash, or the picked conn's ring head (two trips).
  int64_t pk[kPk];
  if (use_pend) {
    STT_UNROLL for (int k = 0; k < kPk; k++) pk[k] = o.stash[k][i];
  } else {
    s = s < 0 ? 0 : (s > p.conns - 1 ? p.conns - 1 : s);
    const int64_t slot = s * p.ring + o.op_pos[s] % p.ring;
    STT_UNROLL for (int k = 0; k < kPk; k++) pk[k] = o.ring[k][slot];
  }
  const int64_t size = pk[kPlenCol] + p.hdr;
  if (pop) {
    o.eth_psent[i] = psent + 1;
    o.eth_bsent[i] = bsent + size;
  }
  const BucketOut b = bucket_law(bal0, nxt0, refill, cap, unlimited == 1,
                                 size, now, p.refill_ns);
  if (b.bal != bal0) o.bal[i] = b.bal;
  if (b.nxt != nxt0) o.nxt[i] = b.nxt;
  const bool throttled = !b.ok;
  bool linkdn = false;
  if (throttled) {
    o.stalls[i] = stalls + 1;
    o.pending[i] = 1;
    if (!use_pend) {  // a pending packet is already the stash
      o.pk_valid[i] = 1;
      STT_UNROLL for (int k = 0; k < kPk; k++) o.stash[k][i] = pk[k];
    }
    o.when[i] = b.nxt;
  } else {
    if (use_pend) o.pk_valid[i] = 0;
    o.fwd_pkts[i] = fwd_pkts + 1;
    o.fwd_bytes[i] = fwd_bytes + size;
    o.pkts_sent[i] = sent + 1;
    // NIC link down: the send dies at the egress instant.
    linkdn = (fault & 2) != 0;
    if (linkdn) {
      o.pkts_dropped[i] = dropped + 1;
      o.drop_cause[i * p.dc_stride] += 1;
    }
  }
  o.throttled[i] = throttled;
  o.linkdn[i] = linkdn;
  o.fwd[i] = !throttled && !linkdn;
  o.done[i] = throttled;
  STT_UNROLL for (int k = 0; k < kPk; k++) o.pk[k][i] = pk[k];
}

// The CoDel words of one lane.
struct CodelWords {
  int64_t first_above, dropping, chain, sniff, count, last_count, drop_next;
};

// CoDel's control-law ladder after a dequeue whose head law gave `h`
// (the reference's sniff / chain / top stages), on the lane's words `w`
// in place.  Returns whether CoDel drops the packet.
STT_LAW bool codel_ladder(CodelWords& w, const CodelHeadOut& h,
                          int64_t now) {
  constexpr int64_t kInterval = 100000000;  // the control law's 100 ms
  w.first_above = h.fa;
  bool drop = false;
  if (w.sniff == 1) {
    // Sniff: re-enter the dropping state with a count carried over from
    // a recent episode.
    const int64_t cnt = now - w.drop_next < kInterval && w.count > 2
                            ? w.count - w.last_count
                            : 1;
    w.dropping = 1;
    w.count = w.last_count = cnt;
    w.drop_next = control_time(now, cnt);
    w.sniff = 0;
  } else if (w.chain == 1) {
    // Chain: the next drop of an episode, or its end.
    if (!h.cok) {
      w.dropping = w.chain = 0;
    } else {
      w.drop_next = control_time(w.drop_next, w.count);
      drop = now >= w.drop_next;
      if (drop)
        w.count += 1;
      else
        w.chain = 0;
    }
  } else if (w.dropping == 1) {
    // Top, dropping: the due drop, or the episode's end.
    if (!h.cok) {
      w.dropping = 0;
    } else if (now >= w.drop_next) {
      drop = true;
      w.chain = 1;
      w.count += 1;
    }
  } else if (h.cok && (now - w.drop_next < kInterval ||
                       now - h.fa >= kInterval)) {
    // Top, not dropping: a drop that opens a sniff.
    drop = true;
    w.sniff = 1;
  }
  return drop;
}

// The relay-2 (inet-in drain) tail of lane i: the CoDel dequeue (or the
// throttled stash), the head law and the control-law ladder, the drop
// counters, the r2 token bucket, the stash of a throttled packet and the
// forward/eth receive counters.
STT_LAW void relay2_lane(const Relay2Ops& o, const RelayParams& p,
                         int64_t i) {
  if (!o.mask[i]) {
    o.codel_drop[i] = o.throttled[i] = o.fwd[i] = o.done[i] = 0;
    return;
  }
  // One trip: the lane's words.
  const bool use_pend = o.pk_valid[i] == 1;
  const int64_t cp = o.cq_pos[i], len = o.cq_len[i], now = o.now[i];
  const int64_t cbytes0 = o.codel_bytes[i];
  const CodelWords w0 = {o.first_above[i], o.dropping[i], o.chain[i],
                         o.sniff[i],       o.count[i],    o.last_count[i],
                         o.drop_next[i]};
  const int64_t bal0 = o.bal[i], nxt0 = o.nxt[i], refill = o.refill[i],
                cap = o.cap[i], unlimited = o.unlimited[i];
  const int64_t stalls = o.stalls[i], fwd_pkts = o.fwd_pkts[i],
                fwd_bytes = o.fwd_bytes[i], precv = o.eth_precv[i],
                brecv = o.eth_brecv[i], cd_dropped = o.dropped[i],
                cd_bytes = o.drop_bytes[i], dropped = o.pkts_dropped[i];
  const bool pop = !use_pend && len > cp;
  if (!use_pend && !pop) {
    // An empty queue ends the drain and any dropping state.
    if (w0.first_above != 0) o.first_above[i] = 0;
    if (w0.dropping != 0) o.dropping[i] = 0;
    if (w0.chain != 0) o.chain[i] = 0;
    if (w0.sniff != 0) o.sniff[i] = 0;
    o.codel_drop[i] = o.throttled[i] = o.fwd[i] = 0;
    o.done[i] = 1;
    return;
  }
  // The packet: the stash, or the ring head with its enqueue stamp (one
  // more trip).
  int64_t pk[kPk];
  const int64_t slot = i * p.ring + cp % p.ring;
  int64_t enq = 0;
  if (use_pend) {
    STT_UNROLL for (int k = 0; k < kPk; k++) pk[k] = o.stash[k][i];
  } else {
    STT_UNROLL for (int k = 0; k < kPk; k++) pk[k] = o.ring[k][slot];
    enq = o.cq_enq[slot];
  }
  const int64_t size = pk[kPlenCol] + p.hdr;
  if (pop) {
    o.cq_pos[i] = cp + 1;
    const int64_t cbytes = cbytes0 - size;
    o.codel_bytes[i] = cbytes;
    const CodelHeadOut h = codel_head_law(true, false, now, enq, cbytes,
                                          w0.first_above, p.target_ns,
                                          p.mtu, p.interval_ns);
    CodelWords w = w0;
    const bool drop = codel_ladder(w, h, now);
    if (w.first_above != w0.first_above) o.first_above[i] = w.first_above;
    if (w.dropping != w0.dropping) o.dropping[i] = w.dropping;
    if (w.chain != w0.chain) o.chain[i] = w.chain;
    if (w.sniff != w0.sniff) o.sniff[i] = w.sniff;
    if (w.count != w0.count) o.count[i] = w.count;
    if (w.last_count != w0.last_count) o.last_count[i] = w.last_count;
    if (w.drop_next != w0.drop_next) o.drop_next[i] = w.drop_next;
    if (drop) {
      o.dropped[i] = cd_dropped + 1;
      o.drop_bytes[i] = cd_bytes + size;
      o.pkts_dropped[i] = dropped + 1;
      o.drop_cause[i * p.dc_stride] += 1;
      o.codel_drop[i] = 1;
      o.throttled[i] = o.fwd[i] = o.done[i] = 0;
      STT_UNROLL for (int k = 0; k < kPk; k++) o.pk[k][i] = pk[k];
      return;
    }
  }
  const BucketOut b = bucket_law(bal0, nxt0, refill, cap, unlimited == 1,
                                 size, now, p.refill_ns);
  if (b.bal != bal0) o.bal[i] = b.bal;
  if (b.nxt != nxt0) o.nxt[i] = b.nxt;
  const bool throttled = !b.ok;
  if (throttled) {
    o.stalls[i] = stalls + 1;
    o.pending[i] = 1;
    if (!use_pend) {
      o.pk_valid[i] = 1;
      STT_UNROLL for (int k = 0; k < kPk; k++) o.stash[k][i] = pk[k];
    }
    o.when[i] = b.nxt;
  } else {
    if (use_pend) o.pk_valid[i] = 0;
    o.fwd_pkts[i] = fwd_pkts + 1;
    o.fwd_bytes[i] = fwd_bytes + size;
    o.eth_precv[i] = precv + 1;
    o.eth_brecv[i] = brecv + size;
  }
  o.codel_drop[i] = 0;
  o.throttled[i] = throttled;
  o.fwd[i] = !throttled;
  o.done[i] = throttled;
  STT_UNROLL for (int k = 0; k < kPk; k++) o.pk[k][i] = pk[k];
}

}  // namespace stt
