"""Exported span states and the comparison of two window steps on them:
what the window kernels (ops/phold_window.py, ops/tcp_window.py) are
held against their plain versions with, in the tier-1 tests (through
host builds of their lane laws) and in `chip_smoke.py` (on the card).

- `capture_export(mgr, nth)` runs a Manager until its `nth` in-domain
  PHOLD export and returns it as the runner's numpy state with the
  span's arguments; the earlier exports decline as a transient miss, so
  the C++ path serves those rounds, and the run stops at the capture.
  `capture_tcp_export` does the same for the TCP family.
- `device_state(runner, st_np)` is that state on the runner's device
  (`tools/relay_cases.clone_state` copies one); `tcp_device_state` the
  TCP family's.
- `window_mismatch(a, b)` names what differs between two PHOLD span
  states after the same window(s): every tensor column, and the outbox
  and the trace up to their counts in canonical order (the order no
  consumer sees: the round end's inbox merge sorts, and so does the
  trace).  `tcp_window_mismatch` does the same for two TCP span states,
  with the conn-major columns' trash row left out (the eager loop
  scribbles on it for masked lanes; nothing reads it).
"""

from __future__ import annotations

import numpy as np
import torch

from shadow_tpu_torch.ops import tcp_span
from shadow_tpu_torch.ops.phold_span import (OUT_KEYS, TR_KEYS,
                                             state_from_numpy)
from shadow_tpu_torch.ops.span_mesh import SAMPLE_ROWS

# The TCP span's outbox and trace columns (ops/tcp_span.py).
TCP_OUT_KEYS = ("src", "dst", "seq", "t") + tcp_span.PK_KEYS
TCP_TR_KEYS = ("t", "kind", "srchost", "pseq", "sip", "sport", "dip",
               "dport", "plen", "reason", "owner")


class _Captured(Exception):
    pass


def capture_export(mgr, nth: int, caps: dict | None = None):
    """Run `mgr` until its `nth` in-domain PHOLD export (with `caps`,
    runner attributes such as CAP_C, set before any export).  Returns
    (runner, numpy state, (start, stop, limit, runahead))."""
    runner = mgr.make_dev_span_runner()
    for k, v in (caps or {}).items():
        setattr(runner, k, v)
    eng = mgr.plane.engine
    got = {}

    class Stub:
        ineligible = 0
        last_transient = True
        last_was_cold = False
        seen = 0

        def try_span(self, start, stop, limit, runahead, dynamic,
                     max_rounds, spec_mr=0):
            d = eng.span_export_phold(*runner._caps())
            if isinstance(d, dict):
                self.seen += 1
                if self.seen == nth:
                    got["st"] = runner._to_arrays(d)
                    got["args"] = (int(start), int(stop), int(limit),
                                   int(runahead))
                    raise _Captured
            return None

    mgr._dev_span = Stub()
    try:
        mgr.run()
    except _Captured:
        pass
    if not got:
        raise AssertionError(f"fewer than {nth} in-domain PHOLD exports")
    return runner, got["st"], got["args"]


def capture_tcp_export(mgr, nth: int, caps: dict | None = None):
    """Run `mgr` until its `nth` in-domain TCP export (with `caps`, runner
    attributes such as CAP_RT, set before any export).  Returns (runner,
    numpy state, (start, stop, limit, runahead))."""
    runner = mgr.make_tcp_span_runner()
    for k, v in (caps or {}).items():
        setattr(runner, k, v)
    eng = mgr.plane.engine
    got = {}

    class Stub:
        ineligible = 0
        last_transient = True
        last_was_cold = False
        seen = 0

        def try_span(self, start, stop, limit, runahead, dynamic,
                     max_rounds, spec_mr=0):
            d = eng.span_export_tcp(*runner._caps())
            if isinstance(d, dict):
                self.seen += 1
                if self.seen == nth:
                    got["st"] = runner._to_arrays(d)
                    got["args"] = (int(start), int(stop), int(limit),
                                   int(runahead))
                    raise _Captured
            return None

    mgr._dev_span_tcp = Stub()
    try:
        mgr.run()
    except _Captured:
        pass
    if not got:
        raise AssertionError(f"fewer than {nth} in-domain TCP exports")
    return runner, got["st"], got["args"]


def _flight_grid(d: dict, s: int, n_seg: int) -> tuple:
    """Server conn s's flight [snd_una, snd_nxt) cut into n_seg
    segments: (seqs, lengths)."""
    una = int(d["c_snduna"][s])
    span = (int(d["c_sndnxt"][s]) - una) % (1 << 32)
    length = span // n_seg
    seq = (una + length * np.arange(n_seg)) % (1 << 32)
    plen = np.full(n_seg, length)
    plen[-1] = span - length * (n_seg - 1)
    return seq, plen


def _waiting(d: dict) -> np.ndarray:
    """Arrivals waiting in their host's inbox, by the server conn they are
    for."""
    role, host = d["c_role"], d["c_host"]
    waiting = np.zeros(len(role), dtype=np.int64)
    for h in np.unique(host[role == 1]):
        for k in range(int(d["ib_pos"][h]), int(d["ib_len"][h])):
            hit = np.flatnonzero((host == h) & (d["c_pip"] == d["ib_sip"][h, k])
                                 & (d["c_pport"] == d["ib_sport"][h, k]))
            waiting[hit] += 1
    return waiting


def tcp_over_cap(st_np: dict, rows: int) -> dict:
    """A TCP export (numpy, as capture_tcp_export gives it) with one tgen
    server serving `rows` conn rows: the server whose conn has the most
    arrivals waiting takes idle conns (no data, no timer, not queued;
    their peer ports 1, 2, ...) in the unused rows past the live conns,
    and that busy conn trades rows with the last of them.  A lane's
    conns are its rows in ascending order (the span's `_conn_rows`), so
    the busy conn is the lane's last: with `rows` one more than the lane
    frame's cap (csrc/tcp_lane.cuh kFrameConns) the law reaches it past
    the frame, in device memory.  The conn indexes the state holds
    (`cur`, the timer heap's targets) follow the trade."""
    d = {k: (v.copy() if isinstance(v, np.ndarray) else v)
         for k, v in st_np.items()}
    host = d["c_host"]
    s = int(np.argmax(_waiting(d)))
    h = int(host[s])
    extra = rows - int((host == h).sum())
    spare = np.flatnonzero(host < 0)[:extra]
    assert extra > 0 and len(spare) == extra and d["c_role"][s] == 1
    conn_keys = [k for k, v in d.items() if isinstance(v, np.ndarray)
                 and tcp_span._is_conn_major(k)]
    for k, e in enumerate(spare):
        for key in conn_keys:
            d[key][e] = 0
        for key in ("c_role", "c_lip", "c_lport", "c_pip", "c_ourws",
                    "c_peerws", "c_effmss", "c_congmss", "c_sbmax",
                    "c_rbmax", "c_cwnd", "c_ssthresh", "c_rto"):
            d[key][e] = d[key][s]
        d["c_host"][e] = h
        d["c_pport"][e] = 1 + k
        for key in ("c_rtodl", "c_delackdl", "c_persistdl", "c_tmrdl",
                    "c_fbyte"):
            d[key][e] = -1
    last = int(spare[-1])
    for key in conn_keys:
        d[key][[s, last]] = d[key][[last, s]]
    conn_tgt = (d["th_kind"] != 0) & d["th_valid"]
    tgt = d["th_tgt"]
    d["th_tgt"] = np.where(conn_tgt & (tgt == s), last,
                           np.where(conn_tgt & (tgt == last), s, tgt))
    d["cur"] = np.where(d["cur"] == s, last,
                        np.where(d["cur"] == last, s, d["cur"]))
    d["_n_conns"] = max(int(d["_n_conns"]), last + 1)
    return d


def tcp_wide_rows(st_np: dict, seed: int = 0) -> dict:
    """A TCP export (numpy, as capture_tcp_export gives it) with its rows
    filled to width, still a state of the stream.  The server conn with
    the most arrivals waiting in its host's inbox, its client, and the
    first client whose host has arrivals waiting:

    - the server's rtx ring holds its flight [snd_una, snd_nxt) cut into
      480 small segments (cap_rt 512), those of its client's first run
      marked SACKed;
    - each client's reassembly row holds 298 segments of its server's
      flight so cut, in shuffled slots, behind the hole at rcv_nxt = the
      server's snd_una: three runs with holes between them;
    - the server host's timer heap holds 3,000 more RTO entries of its
      conns, drawn before the export (seqs from event_seq on), stale:
      most due after the window, a hundred inside it."""
    rng = np.random.default_rng(seed)
    d = {k: (v.copy() if isinstance(v, np.ndarray) else v)
         for k, v in st_np.items()}
    role, host = d["c_role"], d["c_host"]

    def peer(c):
        return int(np.flatnonzero((d["c_pport"] == d["c_lport"][c])
                                  & (d["c_pip"] == d["c_lip"][c]))[0])

    waiting = _waiting(d)
    s = int(np.argmax(waiting))
    n_seg = 480
    held = np.r_[2:100, 130:250, 300:380]  # a client's three runs
    assert role[s] == 1 and waiting[s] > 0 and n_seg < d["rtx_seq"].shape[1] - 1
    seq, plen = _flight_grid(d, s, n_seg)
    for k, v in (("rtx_seq", seq), ("rtx_plen", plen), ("rtx_rtxed", 0),
                 ("rtx_sent", d["now"][host[s]])):
        d[k][s] = 0
        d[k][s, :n_seg] = v
    d["rtx_sacked"][s] = 0
    d["rtx_sacked"][s, held[held < 100]] = 1
    d["rtx_pos"][s], d["rtx_len"][s] = 0, n_seg
    clients = {peer(s)}
    arriving = np.flatnonzero((role == 0)
                              & (d["ib_len"] > d["ib_pos"])[host])
    clients.update(arriving[:1].tolist())
    for c in sorted(clients):
        seq, plen = _flight_grid(d, peer(c), n_seg)
        slots = rng.permutation(d["ra_seq"].shape[1])[:len(held)]
        d["ra_valid"][c] = False
        d["ra_seq"][c] = 0
        d["ra_plen"][c] = 0
        d["ra_valid"][c, slots] = True
        d["ra_seq"][c, slots] = seq[held]
        d["ra_plen"][c, slots] = plen[held]
        d["c_rcvnxt"][c] = seq[0]
    # The server host's heap: stale RTO entries of its conns.
    h = int(host[s])
    conns = np.flatnonzero(host == h)
    free = rng.permutation(np.flatnonzero(~d["th_valid"][h]))[:3000]
    start, end = int(d["now"].max()), int(d["c_rtodl"][conns].max())
    t = rng.integers(start + 10_000_000, end, len(free))
    t[:100] = rng.integers(start, start + 10_000_000, 100)
    es = int(d["event_seq"][h])
    d["th_time"][h, free] = t // 1_000_000 * 1_000_000
    d["th_seq"][h, free] = es + np.arange(len(free))
    d["th_kind"][h, free] = 1  # TK_TCP
    d["th_tgt"][h, free] = rng.choice(conns, len(free))
    d["th_valid"][h, free] = True
    d["event_seq"][h] = es + len(free)
    return d


def tcp_device_state(runner, st_np: dict) -> dict:
    """A captured TCP export on the runner's device, as its export_state
    makes it (the conn count kept on the runner)."""
    st = tcp_span.state_from_numpy(st_np, runner.device)
    runner._n_conns = st.pop("_n_conns")
    st.update(runner._statics_on_device())
    return st


def tcp_window_mismatch(a: dict, b: dict) -> list:
    """The names of what differs between two TCP span states: tensor
    columns (conn-major ones without their trash row), then "outbox" /
    "trace" (counts and canonical rows)."""
    ta = {k for k, v in a.items() if isinstance(v, torch.Tensor)
          and not k.startswith(SAMPLE_ROWS)}
    tb = {k for k, v in b.items() if isinstance(v, torch.Tensor)
          and not k.startswith(SAMPLE_ROWS)}
    bad = sorted(ta ^ tb) + sample_rows_mismatch(a, b)
    for k in ta & tb:
        if k.startswith(("out_", "tr_")):
            continue
        x, y = a[k], b[k]
        if tcp_span._is_conn_major(k):
            x, y = x[:-1], y[:-1]
        if x.dtype != y.dtype or not torch.equal(x, y):
            bad.append(k)
    for name, prefix, keys in (("outbox", "out_", TCP_OUT_KEYS),
                               ("trace", "tr_", TCP_TR_KEYS)):
        count = f"{prefix}n"
        if count not in a:
            continue
        if int(a[count]) != int(b[count]) or not np.array_equal(
                canon(a, prefix, keys, count), canon(b, prefix, keys, count)):
            bad.append(name)
    return sorted(bad)


def device_state(runner, st_np: dict) -> dict:
    st = state_from_numpy(st_np, runner.device)
    st.update(runner._statics_on_device())
    return st


def canon(st: dict, prefix: str, keys, count: str) -> np.ndarray:
    """The first st[count] rows of the flat buffer `prefix`, one column
    per key, sorted on every column."""
    n = int(st[count])
    cols = np.stack([st[f"{prefix}{k}"][:n].cpu().numpy() for k in keys])
    return cols[:, np.lexsort(cols[::-1])] if n else cols


def sample_rows_mismatch(a: dict, b: dict) -> list:
    """The channels' sample rows that differ between two span states
    (the eager loop's tensors or a span kernel's rows read to the host):
    each channel's count, then its rows' times and columns up to it."""
    bad = []
    for prefix in ("tel", "fab"):
        n = f"{prefix}_n"
        if n not in a and n not in b:
            continue
        if a.get(n) != b.get(n):
            bad.append(n)
            continue
        keys = {k for k in (*a, *b) if k.startswith(f"{prefix}_") and k != n}
        for k in sorted(keys):
            x, y = (np.asarray(v[k].cpu() if isinstance(v[k], torch.Tensor)
                               else v[k])[:a[n]] if k in v else None
                    for v in (a, b))
            if x is None or y is None or not np.array_equal(x, y):
                bad.append(k)
    return bad


def window_mismatch(a: dict, b: dict) -> list:
    """The names of what differs between two span states: tensor
    columns, then "outbox" / "trace" (counts and canonical rows)."""
    keys_a = {k for k in a if not k.startswith(SAMPLE_ROWS)}
    keys_b = {k for k in b if not k.startswith(SAMPLE_ROWS)}
    bad = sorted(keys_a ^ keys_b) + sample_rows_mismatch(a, b)
    for k in keys_a & keys_b:
        if k.startswith(("out_", "tr_")) \
                or not isinstance(a[k], torch.Tensor):
            continue
        if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
            bad.append(k)
    for name, prefix, keys in (("outbox", "out_", OUT_KEYS),
                               ("trace", "tr_", TR_KEYS)):
        count = f"{prefix}n"
        if count not in a:
            continue
        if int(a[count]) != int(b[count]) or not np.array_equal(
                canon(a, prefix, keys, count), canon(b, prefix, keys, count)):
            bad.append(name)
    return sorted(bad)
