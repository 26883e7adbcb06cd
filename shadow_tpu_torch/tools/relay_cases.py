"""Seeded relay-law states whose lanes reach every branch of the relay
laws (ops/relay.py): the inputs on which `chip_smoke.py` holds the fused
kernels against their plain versions, and on which the tier-1 tests hold
the plain versions against the reference's laws; with the comparison
both use (`relay_mismatch`) and the bytes a law must move on them
(`relay_need_bytes`, the kernels' bound).

Every lane gets one case per relay (a branch it is built to reach) and
random values elsewhere; the per-lane values come from numpy with the
seed.  The rings are full-width (the span's CAP_CQ / CAP_OP) and are
filled on the device with a per-slot pattern, so a read of the wrong
slot shows; only the head slot of each lane carries its packet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from shadow_tpu_torch.ops.relay import CONTROL_INTERVAL_NS
from shadow_tpu_torch.ops.tcp_span import (CODEL_TARGET_NS, MTU, PK_KEYS,
                                           REFILL_NS, TCP_TOTAL_HDR, TEL_N)

# Relay-2 cases (inet-in drain), each the branch its lanes are built for.
R2_CASES = ("pend_fwd", "pend_throttled", "empty", "quiet", "quiet_mtu",
            "arm", "above_early", "sniff_entry", "sniff_big_count",
            "chain_exit", "chain_drop", "chain_ok", "top_drop", "top_exit",
            "top_ok", "tl_recent", "tl_first_above", "top_deliver",
            "unlimited", "first_touch", "lapsed_refill")
# Relay-1 cases (inet-out drain after the qdisc pick).
R1_CASES = ("pend_fwd", "pend_throttled", "pop_fwd", "pop_throttled",
            "no_packet", "pop_linkdown", "pend_linkdown", "first_touch",
            "lapsed_refill", "exact_balance")

I64 = np.int64


def _bucket(rng, H, now, size, case):
    """Bucket words per lane: mostly random (throttled or not), with the
    cases that force one side."""
    bal = rng.integers(0, 4_000, H, dtype=I64)
    nxt = now + rng.integers(-5 * REFILL_NS, 5 * REFILL_NS, H, dtype=I64)
    refill = rng.integers(0, 3_000, H, dtype=I64)
    cap = rng.integers(1, 20_000, H, dtype=I64)
    unl = (rng.random(H) < 0.1).astype(I64)
    hard = np.isin(case, ("pend_throttled", "pop_throttled"))
    # hard-throttled: empty bucket, no refill
    bal[hard], refill[hard], unl[hard] = 0, 0, 0
    unl[np.isin(case, ("pend_fwd", "pop_fwd", "unlimited", "pop_linkdown",
                       "pend_linkdown"))] = 1
    nxt[case == "first_touch"] = 0
    lapsed = case == "lapsed_refill"
    nxt[lapsed] = now[lapsed] - rng.integers(10 * REFILL_NS, 100 * REFILL_NS,
                                             int(lapsed.sum()), dtype=I64)
    exact = case == "exact_balance"
    nxt[exact] = now[exact] + REFILL_NS  # no refill before the check
    bal[exact], unl[exact] = size[exact], 0
    return bal, nxt, refill, cap, unl


def _packets(rng, H):
    pk = {k: rng.integers(0, 1 << 32, H, dtype=I64) for k in PK_KEYS}
    pk["plen"] = rng.integers(0, 1461, H, dtype=I64)
    return pk


def relay_case_lanes(H: int, seed: int, density: float):
    """Per-lane numpy values of both relays' cases.  Returns (lanes,
    cases) where lanes maps state keys (and "mask1", "mask2", "pop",
    "sel", the ring head packets "head1_*"/"head2_*" and positions) to
    (H,) arrays, and cases maps 1 and 2 to each lane's case name."""
    rng = np.random.default_rng(seed)
    v = {}
    now = I64(3_000_000_000) + rng.integers(0, 10**9, H, dtype=I64)
    v["now"] = now
    n_act = max(1, int(round(density * H)))
    for r in (1, 2):
        m = np.zeros(H, bool)
        m[rng.permutation(H)[:n_act]] = True
        v[f"mask{r}"] = m
    c2 = np.asarray(R2_CASES)[rng.permutation(H) % len(R2_CASES)]
    c1 = np.asarray(R1_CASES)[rng.permutation(H) % len(R1_CASES)]

    # ---- relay 2: CoDel ring, head law, ladder, bucket
    head2 = _packets(rng, H)
    stash2 = _packets(rng, H)
    pend2 = np.isin(c2, ("pend_fwd", "pend_throttled")) \
        | (rng.random(H) < 0.05)
    pend2[np.isin(c2, ("empty",))] = False
    v["r2_pk_valid"] = pend2.astype(I64)
    v["cq_pos"] = rng.integers(0, 6_000, H, dtype=I64)
    depth = rng.integers(1, 60, H, dtype=I64)
    depth[c2 == "empty"] = 0
    v["cq_len"] = v["cq_pos"] + depth
    size2 = np.where(pend2, stash2["plen"], head2["plen"]) + TCP_TOTAL_HDR
    # sojourn: above target unless the case wants the quiet exits
    enq = now - rng.integers(CODEL_TARGET_NS, 4 * CODEL_TARGET_NS, H,
                             dtype=I64)
    quiet = c2 == "quiet"
    enq[quiet] = now[quiet] - rng.integers(0, CODEL_TARGET_NS,
                                           int(quiet.sum()), dtype=I64)
    # bytes after the pop: above the MTU escape unless quiet_mtu
    after = rng.integers(MTU + 1, 40 * MTU, H, dtype=I64)
    qm = c2 == "quiet_mtu"
    after[qm] = rng.integers(0, MTU + 1, int(qm.sum()), dtype=I64)
    v["codel_bytes"] = after + size2
    fa = now - rng.integers(0, 3 * CONTROL_INTERVAL_NS, H, dtype=I64)
    fa[c2 == "arm"] = 0
    early = c2 == "above_early"
    fa[early] = now[early] + rng.integers(1, CONTROL_INTERVAL_NS,
                                          int(early.sum()), dtype=I64)
    # a live episode meets a quiet head (not ok to drop): it ends
    exits = np.isin(c2, ("chain_exit", "top_exit"))
    enq[exits] = now[exits] - 1
    v["codel_first_above"] = fa
    sniff = np.isin(c2, ("sniff_entry", "sniff_big_count"))
    chain = np.isin(c2, ("chain_exit", "chain_drop", "chain_ok"))
    top_dropping = np.isin(c2, ("top_drop", "top_exit", "top_ok"))
    v["cd_sniff"] = sniff.astype(I64)
    v["cd_chain"] = chain.astype(I64)
    v["codel_dropping"] = (top_dropping | chain
                           | (rng.random(H) < 0.3)).astype(I64)
    v["codel_dropping"][np.isin(c2, ("tl_recent", "tl_first_above",
                                     "top_deliver"))] = 0
    # an empty queue resets a live episode
    v["cd_sniff"][c2 == "empty"] = v["cd_chain"][c2 == "empty"] = 1
    count = rng.integers(0, 1_000, H, dtype=I64)
    big = c2 == "sniff_big_count"
    count[big] = rng.integers(1 << 30, (1 << 31) - 1, int(big.sum()),
                              dtype=I64)
    count[np.flatnonzero(big)[:1]] = (1 << 31) - 1
    # counts around the carry-over threshold (count > 2)
    small = (c2 == "sniff_entry") & (rng.random(H) < 0.5)
    count[small] = rng.integers(0, 6, int(small.sum()), dtype=I64)
    last = (count * rng.random(H)).astype(I64)
    last[big] = 0   # cnt_new = count - last: the largest counts
    v["codel_count"] = count
    v["codel_last_count"] = last
    dn = now + rng.integers(-3 * CONTROL_INTERVAL_NS, 3 * CONTROL_INTERVAL_NS,
                            H, dtype=I64)
    recent = np.isin(c2, ("sniff_entry", "sniff_big_count", "tl_recent"))
    dn[recent] = now[recent] - rng.integers(0, CONTROL_INTERVAL_NS,
                                            int(recent.sum()), dtype=I64)
    due = np.isin(c2, ("chain_drop", "top_drop"))
    dn[due] = now[due] - 3 * CONTROL_INTERVAL_NS
    later = np.isin(c2, ("chain_ok", "top_ok"))
    dn[later] = now[later] + rng.integers(1, CONTROL_INTERVAL_NS,
                                          int(later.sum()), dtype=I64)
    stale = np.isin(c2, ("tl_first_above", "top_deliver"))
    dn[stale] = now[stale] - CONTROL_INTERVAL_NS \
        - rng.integers(0, CONTROL_INTERVAL_NS, int(stale.sum()), dtype=I64)
    fa_old = c2 == "tl_first_above"
    fa[fa_old] = now[fa_old] - CONTROL_INTERVAL_NS \
        - rng.integers(0, CONTROL_INTERVAL_NS, int(fa_old.sum()), dtype=I64)
    fresh = c2 == "top_deliver"
    fa[fresh] = now[fresh] - rng.integers(0, CONTROL_INTERVAL_NS - 1,
                                          int(fresh.sum()), dtype=I64)
    # lanes exactly on each comparison's edge
    ivl = CONTROL_INTERVAL_NS

    def edge(case):
        return (c2 == case) & (rng.random(H) < 0.3)

    e = edge("top_drop")
    dn[e] = now[e]                        # now >= drop_next: due now
    e = edge("chain_drop")                # the next drop falls due now
    dn[e] = now[e] - np.array([(ivl << 16) // max(math.isqrt(int(c) << 32), 1)
                               for c in count[e]], dtype=I64)
    e = edge("tl_first_above")
    fa[e] = now[e] - ivl                  # above target for one interval
    e = edge("top_deliver")
    dn[e] = now[e] - ivl                  # the last episode just too old
    e = edge("sniff_entry")
    dn[e] = now[e] - ivl                  # too old to carry its count
    v["codel_drop_next"] = dn
    v["cq_enq_head"] = enq
    (v["r2_bal"], v["r2_next"], v["r2_refill"], v["r2_cap"],
     v["r2_unlimited"]) = _bucket(rng, H, now, size2, c2)
    for k in PK_KEYS:
        v[f"head2_{k}"] = head2[k]
        v[f"r2_pk_{k}"] = stash2[k]

    # ---- relay 1: qdisc pick, bucket, link down
    head1 = _packets(rng, H)
    stash1 = _packets(rng, H)
    pend1 = np.isin(c1, ("pend_fwd", "pend_throttled", "pend_linkdown"))
    v["r1_pk_valid"] = pend1.astype(I64)
    pop = ~pend1 & (c1 != "no_packet")
    v["pop"] = pop & v["mask1"]
    size1 = np.where(pend1, stash1["plen"], head1["plen"]) + TCP_TOTAL_HDR
    (v["r1_bal"], v["r1_next"], v["r1_refill"], v["r1_cap"],
     v["r1_unlimited"]) = _bucket(rng, H, now, size1, c1)
    fault = np.where(rng.random(H) < 0.1, I64(1), I64(0))
    fault[np.isin(c1, ("pop_linkdown", "pend_linkdown"))] = 2
    v["h_fault"] = fault
    v["op_pos_head"] = rng.integers(0, 1_000, H, dtype=I64)
    for k in PK_KEYS:
        v[f"head1_{k}"] = head1[k]
        v[f"r1_pk_{k}"] = stash1[k]

    # ---- counters both relays bump
    for k in ("r1_stalls", "r1_pending", "r1_fwd_pkts", "r1_fwd_bytes",
              "r2_stalls", "r2_pending", "r2_fwd_pkts", "r2_fwd_bytes",
              "pkts_sent", "pkts_dropped", "eth_psent", "eth_bsent",
              "eth_precv", "eth_brecv", "codel_dropped",
              "codel_drop_bytes"):
        v[k] = rng.integers(0, 1 << 40, H, dtype=I64)
    for k in ("r1_pending", "r2_pending"):
        v[k] = rng.integers(0, 2, H, dtype=I64)
    v["drop_causes"] = rng.integers(0, 1 << 40, (H, TEL_N), dtype=I64)
    return v, {1: c1, 2: c2}


def _ring(rows: int, width: int, col: int, device):
    """A (rows, width) ring with a per-slot pattern (no two slots of one
    column alike, columns unlike), made on the device."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    w = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    return ((r * 1_000_003 + w * 7_919 + col * 104_729) & 0xFFFFFF) | (
        1 << 40)


def relay_case_state(H: int, *, seed: int, density: float, cq_cap: int,
                     op_cap: int, conns: int, device):
    """The span state both relay laws read and write, on `device`, with
    the lanes of `relay_case_lanes`.  Relay 1's conn-major arrays have
    `conns` + 1 rows (the trash row last); lane i owns conn row
    perm[i] (conns >= H).  Returns (st, mask1, pop, sel, mask2, cases)."""
    if conns < H:
        raise ValueError("relay_case_state needs conns >= H")
    v, cases = relay_case_lanes(H, seed, density)

    def t(a):
        return torch.tensor(a, device=device)

    st = {}
    skip = ("mask1", "mask2", "pop", "cq_enq_head", "op_pos_head")
    for k, a in v.items():
        if not k.startswith(("head1_", "head2_")) and k not in skip:
            st[k] = t(a)
    lane = torch.arange(H, device=device)
    # relay 2: host-major CoDel rings, the head packet at cq_pos % CQ
    slot2 = st["cq_pos"] % cq_cap
    for j, k in enumerate(PK_KEYS + ("enq",)):
        ring = _ring(H, cq_cap, j, device)
        ring[lane, slot2] = t(v["cq_enq_head"] if k == "enq"
                              else v[f"head2_{k}"])
        st[f"cq_{k}"] = ring
    # relay 1: conn-major egress rings, lane i's conn row perm[i]
    rng = np.random.default_rng(seed + 1)
    sel_np = rng.permutation(conns)[:H].astype(I64)
    op_pos = torch.zeros(conns + 1, dtype=torch.int64, device=device)
    op_pos[t(sel_np)] = t(v["op_pos_head"])
    st["op_pos"] = op_pos
    slot1 = op_pos[t(sel_np)] % op_cap
    for j, k in enumerate(PK_KEYS):
        ring = _ring(conns + 1, op_cap, 40 + j, device)
        ring[t(sel_np), slot1] = t(v[f"head1_{k}"])
        st[f"op_{k}"] = ring
    mask1, mask2, pop = t(v["mask1"]), t(v["mask2"]), t(v["pop"])
    sel = torch.where(pop, t(sel_np), -1)
    return st, mask1, pop, sel, mask2, cases


def clone_state(st: dict) -> dict:
    """A copy of a span state: each tensor cloned, anything else kept."""
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in st.items()}


def carried(law, out):
    """The lanes whose packet the span reads after relay law `law`
    (every flag but `done`): the lanes that carried a packet."""
    carry = torch.zeros_like(out[0])
    for name, flag in zip(law.flag_names, out[:4]):
        if name != "done":
            carry = carry | flag
    return carry


def relay_mismatch(law, got, want, st_k, st_p) -> tuple:
    """(max |err|, names that differ) of a relay law's run (`got`, state
    `st_k`) against its plain version's (`want`, `st_p`): the flags on
    every lane, the packet on the lanes that carried one, `when` on the
    throttled lanes and every state word."""
    err, bad = 0, []

    def diff(name, a, b):
        nonlocal err
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append(f"{name}: {a.dtype}{tuple(a.shape)} vs "
                       f"{b.dtype}{tuple(b.shape)}")
            return
        ne = a != b
        if ne.any():
            bad.append(f"{name} ({int(ne.sum())} words)")
            err = max(err, int((a.to(torch.int64)[ne]
                                - b.to(torch.int64)[ne]).abs().max()))

    for name, g, w in zip(law.flag_names, got, want):
        diff(name, g, w)
    throttled = want[law.flag_names.index("throttled")]
    diff("when", got[4][throttled], want[4][throttled])
    carry = carried(law, want)
    for k in want[5]:
        diff(f"pk_{k}", got[5][k][carry], want[5][k][carry])
    for k in st_p:
        diff(k, st_k[k], st_p[k])
    return err, bad


def relay_need_bytes(law, st0, st1, mask, lane, out) -> int:
    """The bytes relay law `law` must move on these inputs (`st0` before,
    `st1` and `out` from its plain version): every lane's mask byte and
    four flag bytes; on the mask's lanes each word its branch reads,
    once; each state word that changed, written once (a blind write, as
    of the stash, costs its write only); the packet handed back on the
    lanes that carried one and `when` on the throttled lanes."""
    from shadow_tpu_torch.ops.queues import codel_head_ref
    H = mask.shape[0]
    f = dict(zip(law.flag_names, out[:4]))
    reads = {}

    def need(lanes, *keys):
        for k in keys:
            reads[k] = reads.get(k, torch.zeros_like(mask)) | lanes

    cols = lambda pfx: [f"{pfx}{k}" for k in PK_KEYS]  # noqa: E731
    now = st0["now"]
    extra = 0
    if law.relay == 1:
        use_pend = mask & (st0["r1_pk_valid"] == 1)
        pop = lane[0] & mask
        has = use_pend | pop
        extra = int(mask.sum())  # the pop byte
        need(mask, "r1_pk_valid")
        need(pop, "sel", "op_pos", *cols("op_"), "eth_psent", "eth_bsent")
        need(use_pend, *cols("r1_pk_"))
        need(has, "now", "r1_bal", "r1_next", "r1_refill", "r1_cap",
             "r1_unlimited")
        need(f["throttled"], "r1_stalls")
        need(f["fwd"] | f["linkdn"], "h_fault", "r1_fwd_pkts",
             "r1_fwd_bytes", "pkts_sent")
        need(f["linkdn"], "pkts_dropped", "drop_causes")
        carry = has
    else:
        use_pend = mask & (st0["r2_pk_valid"] == 1)
        rest = mask & ~use_pend
        pop = rest & (st0["cq_len"] > st0["cq_pos"])
        need(mask, "r2_pk_valid")
        need(rest, "cq_pos", "cq_len")
        need(pop, *cols("cq_"), "cq_enq", "codel_bytes", "codel_first_above",
             "now", "cd_sniff")
        lanes = torch.arange(H, device=mask.device)
        slot = st0["cq_pos"] % st0["cq_enq"].shape[1]
        size = st0["cq_plen"][lanes, slot] + TCP_TOTAL_HDR
        cok = codel_head_ref(CODEL_TARGET_NS, MTU, pop, rest & ~pop, now,
                             st0["cq_enq"][lanes, slot],
                             st0["codel_bytes"] - size,
                             st0["codel_first_above"])[3]
        sniff = pop & (st0["cd_sniff"] == 1)
        dnext, count = st0["codel_drop_next"], st0["codel_count"]
        need(sniff, "codel_count", "codel_drop_next")
        need(sniff & (now - dnext < CONTROL_INTERVAL_NS) & (count > 2),
             "codel_last_count")
        need(pop & ~sniff, "cd_chain")
        chain = pop & ~sniff & (st0["cd_chain"] == 1)
        need(chain & cok, "codel_count", "codel_drop_next")
        top = pop & ~sniff & ~chain
        need(top, "codel_dropping")
        need(top & cok, "codel_drop_next")
        need(top & (st0["codel_dropping"] == 1) & f["codel_drop"],
             "codel_count")
        need(f["codel_drop"], "codel_dropped", "codel_drop_bytes",
             "pkts_dropped", "drop_causes")
        need(use_pend, *cols("r2_pk_"), "now")
        need(use_pend | pop & ~f["codel_drop"], "r2_bal", "r2_next",
             "r2_refill", "r2_cap", "r2_unlimited")
        need(f["throttled"], "r2_stalls")
        need(f["fwd"], "r2_fwd_pkts", "r2_fwd_bytes", "eth_precv",
             "eth_brecv")
        carry = use_pend | pop
    words = sum(int(r.sum()) for r in reads.values())
    words += sum(int((v != st1[k]).sum()) for k, v in st0.items())
    words += len(PK_KEYS) * int(carry.sum()) + int(f["throttled"].sum())
    return 5 * H + extra + 8 * words
