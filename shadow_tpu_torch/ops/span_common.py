"""The round-end inbox merge both device-span loops run unchanged (the
TCP family's and the PHOLD/udp-mesh family's, twins of the same code in
the reference's two span kernels).

At a round's end the propagation hands over the kept outbox packets;
`merge_inbox` appends them to their destination inboxes and restores
the inbox heap's total order (time, src, seq) on every row.  JAX drops
out-of-bounds scatter rows (`mode="drop"`); PyTorch raises on them, so
the merge builds each inbox column with one trash row (index H) that
masked packets write and nothing reads.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.trace.events import (FB_ACT_CODEL, FB_ACT_LINK,
                                           FB_ACT_TB_IN, FB_ACT_TB_OUT,
                                           FB_FIELD_NAMES)

I64_MAX = 1 << 62  # "no event" sentinel (== TIME_NEVER)


def lexsort3(primary, secondary, tertiary):
    """Row-wise jnp.lexsort((tertiary, secondary, primary)) as three
    stable argsorts, least significant key first."""
    idx = torch.argsort(tertiary, dim=1, stable=True)
    for key in (secondary, primary):
        idx = idx.gather(1, torch.argsort(key.gather(1, idx), dim=1,
                                          stable=True))
    return idx


def merge_inbox(st, keep, dst, new: dict):
    """Scatter the kept outbox packets into their destination inboxes in
    `st` (the `ib_*` columns, `ib_pos`, `ib_len`): compact each row's
    unconsumed remainder to the front, append the arrivals per
    destination in outbox order, and re-sort each row by (time, src,
    seq).  `keep` and `dst` are the (O,) outbox mask and destinations;
    `new` maps every inbox column suffix (time, src, seq and the packet
    keys) to its (O,) outbox values.  Returns the mask of kept packets
    whose row would pass its last slot (the caller's AB_STRUCT)."""
    H, I = st["ib_time"].shape
    O = keep.shape[0]
    dev = keep.device
    i64 = torch.int64
    ar_o = torch.arange(O, dtype=i64, device=dev)
    ar_i = torch.arange(I, dtype=i64, device=dev)[None, :]
    rem = st["ib_len"] - st["ib_pos"]
    shift = (st["ib_pos"][:, None] + ar_i).clamp(max=I - 1)
    live = ar_i < rem[:, None]
    ib = {}
    for k in new:
        a = st[f"ib_{k}"]
        fill = I64_MAX if k in ("time", "seq") else 0
        # (H + 1, I): row H is the scatter's trash row
        out = torch.empty((H + 1, I), dtype=a.dtype, device=dev)
        out[:H] = torch.where(live, a.gather(1, shift), fill)
        out[H] = fill
        ib[k] = out
    # stable per-destination rank in delivery order
    seg = torch.where(keep, dst, H)
    order = torch.argsort(seg * (O + 1) + ar_o, stable=True)
    sseg = seg[order]
    rank0 = ar_o - torch.searchsorted(sseg, sseg)
    rank = torch.empty_like(rank0)
    rank[order] = rank0
    slot = rem[seg.clamp(max=H - 1)] + rank
    ok_slot = keep & (slot < I - 1)
    rows = torch.where(ok_slot, dst, H)
    cols = torch.where(ok_slot, slot, 0)
    for k, v in new.items():
        ib[k][rows, cols] = v
    add = torch.zeros(H + 1, dtype=i64, device=dev).index_add_(
        0, rows, torch.ones(O, dtype=i64, device=dev))[:H]
    sort_idx = lexsort3(ib["time"][:H], ib["src"][:H], ib["seq"][:H])
    for k, v in ib.items():
        st[f"ib_{k}"] = v[:H].gather(1, sort_idx)
    st["ib_pos"] = torch.zeros(H, dtype=i64, device=dev)
    st["ib_len"] = rem + add
    return keep & (slot >= I - 1)


# ---------------------------------------------------------------------
# The sim-time channels' rows (the reference round_body's netstat and
# fabric blocks): at a round that crosses its channel's sampling grid,
# row `<prefix>_n` of the span-local buffers takes the sample, and the
# count advances.  The span kernels write the same rows on the card
# (csrc/*_round_end.cuh `fab_sample` / `tel_sample`).

# A fabric row's columns: the activity mask, then FB_REC's fields.
FAB_COLS = ("flags",) + FB_FIELD_NAMES


def make_rows(st, prefix: str, cols, rows: int, width: int, device):
    """A span's empty `<prefix>_*` buffers: the count (a host int), the
    rows' times (rows,) and one (rows, width) array a column."""
    st[f"{prefix}_n"] = 0
    st[f"{prefix}_t"] = torch.zeros(rows, dtype=torch.int64, device=device)
    for c in cols:
        st[f"{prefix}_{c}"] = torch.zeros((rows, width), dtype=torch.int64,
                                          device=device)


def put_row(st, prefix: str, window_end: int, values: dict) -> None:
    """The next row of `<prefix>_*` from `values` (column -> (width,))."""
    r = st[f"{prefix}_n"]
    st[f"{prefix}_t"][r] = window_end
    for c, v in values.items():
        st[f"{prefix}_{c}"][r] = v
    st[f"{prefix}_n"] = r + 1


def bucket_peek(st, r: int, window_end: int, refill_ns: int):
    """Relay r's bucket balance at `window_end` without stepping it: the
    refills due by then added, up to the cap (the reference's
    `bucket_peek`)."""
    nr, bal = st[f"r{r}_next"], st[f"r{r}_bal"]
    k = 1 + torch.div(window_end - nr, refill_ns, rounding_mode="floor")
    adv = torch.minimum(st[f"r{r}_cap"], bal + k * st[f"r{r}_refill"])
    return torch.where((nr == 0) | (window_end < nr), bal, adv)


def fabric_values(st, window_end: int, cq_cap: int, refill_ns: int) -> dict:
    """Every host's fabric row at a round boundary: FAB_COLS -> (H,)."""
    depth = st["cq_len"] - st["cq_pos"]
    flags = (torch.where(depth > 0, FB_ACT_CODEL, 0)
             | torch.where(st["r1_pending"] == 1, FB_ACT_TB_OUT, 0)
             | torch.where(st["r2_pending"] == 1, FB_ACT_TB_IN, 0)
             | torch.where(st["eth_psent"] + st["eth_precv"] > 0,
                           FB_ACT_LINK, 0))
    hidx = torch.arange(depth.shape[0], device=depth.device)
    head = st["cq_enq"][hidx, st["cq_pos"] % cq_cap]
    sojourn = torch.where(depth > 0, window_end - head, 0)
    return {"flags": flags, "qdepth": depth, "qbytes": st["codel_bytes"],
            "sojourn": sojourn, "qenq": st["codel_enq_pkts"],
            "qdrops": st["codel_dropped"], "qmarks": st["codel_marked"],
            "r1_bal": bucket_peek(st, 1, window_end, refill_ns),
            "r1_stalls": st["r1_stalls"],
            "r2_bal": bucket_peek(st, 2, window_end, refill_ns),
            "r2_stalls": st["r2_stalls"],
            "psent": st["eth_psent"], "bsent": st["eth_bsent"],
            "precv": st["eth_precv"], "brecv": st["eth_brecv"]}


# The state words a host's fabric sample reads (csrc/sample_rows.cuh
# fab_sample: the ring's length, position and head time, six queue and
# stall counters, each relay's pending bit, balance, next refill, cap and
# refill amount, the four link counters) and a conn's TEL sample.
FAB_READ_WORDS = 23
TEL_READ_WORDS = 10


def sample_need_bytes(st, conns: int, hosts: int) -> int:
    """The bytes a span's sample rows must move: each row taken (its
    time and a column a conn or host) written once, and what each row's
    samples read, once a row."""
    tel = st.get("tel_n", 0) * 8 * (1 + 2 * TEL_READ_WORDS * conns)
    fab = st.get("fab_n", 0) * 8 * (1 + (len(FAB_COLS) + FAB_READ_WORDS)
                                    * hosts)
    return tel + fab
