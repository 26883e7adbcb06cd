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
