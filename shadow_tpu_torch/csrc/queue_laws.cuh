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

// ---------------------------------------------------------------------
// The relay tails as scalar cores over one lane's words.  A core takes
// the lane's words (in place), whether it sends the stashed packet
// (`use_pend`) or dequeues one (`pop`), and that packet; it returns what
// the caller must do around it.  The array-indexed wrappers below
// (relay1_lane / relay2_lane, what relay.cu launches) load the words,
// call the core and write back what changed; the TCP window's lane
// (tcp_lane.cuh) calls the cores on its own words.
// ---------------------------------------------------------------------

// What a relay tail hands back: the flags the caller's ordered steps
// (trace, timer push, outbox or conn hand-off) are masked by, the
// throttled packet's refill instant, whether the packet must go to the
// stash, and the laws it called.
struct RelayOut {
  bool codel_drop, throttled, linkdn, fwd, done, stash;
  bool bucket_call, codel_call;
  int64_t when;
};

// One lane's relay-1 words (the r1_* state, the send counters and the
// link-down drop column).
struct Relay1Words {
  int64_t pk_valid, bal, nxt, stalls, pending, fwd_pkts, fwd_bytes,
      pkts_sent, pkts_dropped, eth_psent, eth_bsent, drop_cause;
};

// The relay-1 (inet-out drain) tail after the qdisc pick: the eth send
// counters of a popped packet, the r1 token bucket, the stash of a
// throttled packet, the forward counters and the NIC-link-down drop.
// `pk` is read only when there is a packet (use_pend or pop).
STT_LAW RelayOut relay1_core(Relay1Words& w, bool use_pend, bool pop,
                             const int64_t* pk, int64_t now, int64_t fault,
                             int64_t refill, int64_t cap, bool unlimited,
                             int64_t refill_ns, int64_t hdr) {
  RelayOut r = {};
  if (!use_pend && !pop) {  // nothing to send: the drain is done
    r.done = true;
    return r;
  }
  const int64_t size = pk[kPlenCol] + hdr;
  if (pop) {
    w.eth_psent += 1;
    w.eth_bsent += size;
  }
  const BucketOut b =
      bucket_law(w.bal, w.nxt, refill, cap, unlimited, size, now, refill_ns);
  r.bucket_call = true;
  w.bal = b.bal;
  w.nxt = b.nxt;
  r.throttled = !b.ok;
  if (r.throttled) {
    w.stalls += 1;
    w.pending = 1;
    if (!use_pend) {  // a pending packet is already the stash
      w.pk_valid = 1;
      r.stash = true;
    }
    r.when = b.nxt;
  } else {
    if (use_pend) w.pk_valid = 0;
    w.fwd_pkts += 1;
    w.fwd_bytes += size;
    w.pkts_sent += 1;
    // NIC link down: the send dies at the egress instant.
    r.linkdn = (fault & 2) != 0;
    if (r.linkdn) {
      w.pkts_dropped += 1;
      w.drop_cause += 1;
    }
  }
  r.fwd = !r.throttled && !r.linkdn;
  r.done = r.throttled;
  return r;
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


// One lane's relay-2 words (the ring position, CoDel's words and
// counters, the r2_* state, the receive counters and the CoDel drop
// column).
struct Relay2Words {
  int64_t pk_valid, cq_pos, codel_bytes;
  CodelWords cw;
  int64_t dropped, drop_bytes, pkts_dropped, drop_cause, bal, nxt, stalls,
      pending, fwd_pkts, fwd_bytes, eth_precv, eth_brecv;
};

// The relay-2 (inet-in drain) tail: the CoDel dequeue of `pk` enqueued
// at `enq` (or the stashed packet), the head law and the control-law
// ladder, the drop counters, the r2 token bucket, the stash of a
// throttled packet and the forward/eth receive counters.  With neither a
// stash nor a packet queued the drain ends and so does any dropping
// state.
STT_LAW RelayOut relay2_core(Relay2Words& w, bool use_pend, bool pop,
                             const int64_t* pk, int64_t enq, int64_t now,
                             int64_t refill, int64_t cap, bool unlimited,
                             const RelayParams& p) {
  RelayOut r = {};
  if (!use_pend && !pop) {
    w.cw.first_above = w.cw.dropping = w.cw.chain = w.cw.sniff = 0;
    r.done = true;
    return r;
  }
  const int64_t size = pk[kPlenCol] + p.hdr;
  if (pop) {
    w.cq_pos += 1;
    w.codel_bytes -= size;
    const CodelHeadOut h =
        codel_head_law(true, false, now, enq, w.codel_bytes,
                       w.cw.first_above, p.target_ns, p.mtu, p.interval_ns);
    r.codel_call = true;
    if (codel_ladder(w.cw, h, now)) {
      w.dropped += 1;
      w.drop_bytes += size;
      w.pkts_dropped += 1;
      w.drop_cause += 1;
      r.codel_drop = true;
      return r;
    }
  }
  const BucketOut b =
      bucket_law(w.bal, w.nxt, refill, cap, unlimited, size, now, p.refill_ns);
  r.bucket_call = true;
  w.bal = b.bal;
  w.nxt = b.nxt;
  r.throttled = !b.ok;
  if (r.throttled) {
    w.stalls += 1;
    w.pending = 1;
    if (!use_pend) {
      w.pk_valid = 1;
      r.stash = true;
    }
    r.when = b.nxt;
  } else {
    if (use_pend) w.pk_valid = 0;
    w.fwd_pkts += 1;
    w.fwd_bytes += size;
    w.eth_precv += 1;
    w.eth_brecv += size;
  }
  r.fwd = !r.throttled;
  r.done = r.throttled;
  return r;
}

// How the wrappers below spend their time.  A lane's cost on the card is
// its chain of dependent loads (each a trip to memory), not its bytes:
// the mask byte, then the lane's words, then its packet (relay 1: the
// picked conn's ring position first).  So each lane of the mask loads
// every word a branch of it may need at once, one trip for all, and
// writes back only the words that change.  A lane off the mask reads its
// mask byte only; `pk` is handed back on lanes with a packet and `when`
// on throttled lanes.

#define STT_PUT_CHANGED(ptr, idx, v0, v) \
  if ((v) != (v0)) (ptr)[idx] = (v);

// The relay-1 tail of lane i (relay1_core on the lane's words): the
// packet is the throttled stash or the picked conn's ring head.
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
  const int64_t refill = o.refill[i], cap = o.cap[i],
                unlimited = o.unlimited[i];
  const int64_t dc = i * p.dc_stride;
  const Relay1Words w0 = {o.pk_valid[i], o.bal[i],       o.nxt[i],
                          o.stalls[i],   o.pending[i],   o.fwd_pkts[i],
                          o.fwd_bytes[i], o.pkts_sent[i], o.pkts_dropped[i],
                          o.eth_psent[i], o.eth_bsent[i], o.drop_cause[dc]};
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
  Relay1Words w = w0;
  const RelayOut r = relay1_core(w, use_pend, pop, pk, now, fault, refill,
                                 cap, unlimited == 1, p.refill_ns, p.hdr);
  STT_PUT_CHANGED(o.pk_valid, i, w0.pk_valid, w.pk_valid)
  STT_PUT_CHANGED(o.bal, i, w0.bal, w.bal)
  STT_PUT_CHANGED(o.nxt, i, w0.nxt, w.nxt)
  STT_PUT_CHANGED(o.stalls, i, w0.stalls, w.stalls)
  STT_PUT_CHANGED(o.pending, i, w0.pending, w.pending)
  STT_PUT_CHANGED(o.fwd_pkts, i, w0.fwd_pkts, w.fwd_pkts)
  STT_PUT_CHANGED(o.fwd_bytes, i, w0.fwd_bytes, w.fwd_bytes)
  STT_PUT_CHANGED(o.pkts_sent, i, w0.pkts_sent, w.pkts_sent)
  STT_PUT_CHANGED(o.pkts_dropped, i, w0.pkts_dropped, w.pkts_dropped)
  STT_PUT_CHANGED(o.eth_psent, i, w0.eth_psent, w.eth_psent)
  STT_PUT_CHANGED(o.eth_bsent, i, w0.eth_bsent, w.eth_bsent)
  STT_PUT_CHANGED(o.drop_cause, dc, w0.drop_cause, w.drop_cause)
  if (r.stash) {
    STT_UNROLL for (int k = 0; k < kPk; k++) o.stash[k][i] = pk[k];
  }
  if (r.throttled) o.when[i] = r.when;
  o.throttled[i] = r.throttled;
  o.linkdn[i] = r.linkdn;
  o.fwd[i] = r.fwd;
  o.done[i] = r.done;
  STT_UNROLL for (int k = 0; k < kPk; k++) o.pk[k][i] = pk[k];
}

// The relay-2 tail of lane i (relay2_core on the lane's words): the
// packet is the throttled stash or the CoDel ring's head with its
// enqueue stamp.
STT_LAW void relay2_lane(const Relay2Ops& o, const RelayParams& p,
                         int64_t i) {
  if (!o.mask[i]) {
    o.codel_drop[i] = o.throttled[i] = o.fwd[i] = o.done[i] = 0;
    return;
  }
  // One trip: the lane's words.
  const bool use_pend = o.pk_valid[i] == 1;
  const int64_t cp = o.cq_pos[i], len = o.cq_len[i], now = o.now[i];
  const int64_t refill = o.refill[i], cap = o.cap[i],
                unlimited = o.unlimited[i];
  const int64_t dc = i * p.dc_stride;
  const Relay2Words w0 = {
      o.pk_valid[i],
      cp,
      o.codel_bytes[i],
      {o.first_above[i], o.dropping[i], o.chain[i], o.sniff[i], o.count[i],
       o.last_count[i], o.drop_next[i]},
      o.dropped[i],
      o.drop_bytes[i],
      o.pkts_dropped[i],
      o.drop_cause[dc],
      o.bal[i],
      o.nxt[i],
      o.stalls[i],
      o.pending[i],
      o.fwd_pkts[i],
      o.fwd_bytes[i],
      o.eth_precv[i],
      o.eth_brecv[i]};
  const bool pop = !use_pend && len > cp;
  // The packet: the stash, or the ring head with its enqueue stamp (one
  // more trip).
  int64_t pk[kPk];
  const int64_t slot = i * p.ring + cp % p.ring;
  int64_t enq = 0;
  if (use_pend) {
    STT_UNROLL for (int k = 0; k < kPk; k++) pk[k] = o.stash[k][i];
  } else if (pop) {
    STT_UNROLL for (int k = 0; k < kPk; k++) pk[k] = o.ring[k][slot];
    enq = o.cq_enq[slot];
  }
  Relay2Words w = w0;
  const RelayOut r = relay2_core(w, use_pend, pop, pk, enq, now, refill, cap,
                                 unlimited == 1, p);
  STT_PUT_CHANGED(o.pk_valid, i, w0.pk_valid, w.pk_valid)
  STT_PUT_CHANGED(o.cq_pos, i, w0.cq_pos, w.cq_pos)
  STT_PUT_CHANGED(o.codel_bytes, i, w0.codel_bytes, w.codel_bytes)
  STT_PUT_CHANGED(o.first_above, i, w0.cw.first_above, w.cw.first_above)
  STT_PUT_CHANGED(o.dropping, i, w0.cw.dropping, w.cw.dropping)
  STT_PUT_CHANGED(o.chain, i, w0.cw.chain, w.cw.chain)
  STT_PUT_CHANGED(o.sniff, i, w0.cw.sniff, w.cw.sniff)
  STT_PUT_CHANGED(o.count, i, w0.cw.count, w.cw.count)
  STT_PUT_CHANGED(o.last_count, i, w0.cw.last_count, w.cw.last_count)
  STT_PUT_CHANGED(o.drop_next, i, w0.cw.drop_next, w.cw.drop_next)
  STT_PUT_CHANGED(o.dropped, i, w0.dropped, w.dropped)
  STT_PUT_CHANGED(o.drop_bytes, i, w0.drop_bytes, w.drop_bytes)
  STT_PUT_CHANGED(o.pkts_dropped, i, w0.pkts_dropped, w.pkts_dropped)
  STT_PUT_CHANGED(o.drop_cause, dc, w0.drop_cause, w.drop_cause)
  STT_PUT_CHANGED(o.bal, i, w0.bal, w.bal)
  STT_PUT_CHANGED(o.nxt, i, w0.nxt, w.nxt)
  STT_PUT_CHANGED(o.stalls, i, w0.stalls, w.stalls)
  STT_PUT_CHANGED(o.pending, i, w0.pending, w.pending)
  STT_PUT_CHANGED(o.fwd_pkts, i, w0.fwd_pkts, w.fwd_pkts)
  STT_PUT_CHANGED(o.fwd_bytes, i, w0.fwd_bytes, w.fwd_bytes)
  STT_PUT_CHANGED(o.eth_precv, i, w0.eth_precv, w.eth_precv)
  STT_PUT_CHANGED(o.eth_brecv, i, w0.eth_brecv, w.eth_brecv)
  if (r.stash) {
    STT_UNROLL for (int k = 0; k < kPk; k++) o.stash[k][i] = pk[k];
  }
  if (r.throttled) o.when[i] = r.when;
  o.codel_drop[i] = r.codel_drop;
  o.throttled[i] = r.throttled;
  o.fwd[i] = r.fwd;
  o.done[i] = r.done;
  if (use_pend || pop) {
    STT_UNROLL for (int k = 0; k < kPk; k++) o.pk[k][i] = pk[k];
  }
}
}  // namespace stt
