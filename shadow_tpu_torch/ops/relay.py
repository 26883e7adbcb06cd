"""The relay micro-ops' lane laws: plain PyTorch versions and the fused
CUDA kernels (`csrc/relay.cu`) behind one wrapper each.

The TCP device span drains two relays per host (ops/tcp_span.py):
relay 1 (inet-out: qdisc pick -> token bucket -> outbox) and relay 2
(inet-in: CoDel dequeue -> token bucket -> connection).  Each micro-op
has a lane-local tail — every lane reads and writes only its own host's
words — and a few ordered, cross-lane steps around it (trace and outbox
appends, timer pushes, the qdisc pick, the connection lookup).  The
tails live here; the ordered steps stay in tcp_span.py.

- `relay1_law_ref` / `relay2_law_ref` are the tails in plain PyTorch:
  the eager code of the reference's op_relay1 / op_relay2, with the
  bucket and CoDel-head laws of ops/queues.py, updating the span state
  in place on the mask's lanes.  A wrapper uses them only for tensors
  that lie on the CPU; `chip_smoke.py` holds the kernels against them
  on the card.
- `RelayLaw` is the wrapper.  `bind` makes the per-span-build callable:
  on CUDA tensors it launches the kernel or raises (there is no
  fallback).  Once per build it reads the kernel's operand names
  (`parse_operands`: the table's order lives in csrc/queue_laws.cuh
  alone) and checks every operand's device, dtype, shape and
  contiguity by them; per call it collects the operands' data_ptr()s
  into one table and makes one ctypes call.  Its plain integer
  `launches` counter is bumped only where it launches.

The kernel writes state in place, so no two written operands may share
storage (checked per call) and no caller may hold an operand tensor
across a call expecting its old value.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from operator import itemgetter

import torch

from shadow_tpu_torch.ops.queues import (CODEL_INTERVAL_NS, KernelLibrary,
                                         bucket_step_ref, codel_head_ref)

# The CoDel control law's interval (netplane codel_pop twin): the
# sniff window and the numerator of control_time.
CONTROL_INTERVAL_NS = 100_000_000


@dataclass(frozen=True)
class RelayConsts:
    """The span constants the relay laws read (tcp_span.py owns them)."""

    pk_keys: tuple        # packet columns, in the kernel's order
    hdr: int              # TCP_TOTAL_HDR
    refill_ns: int        # token-bucket refill interval
    target_ns: int        # CoDel target
    mtu: int
    tel_codel: int        # drop_causes column of a CoDel drop
    tel_link_down: int    # drop_causes column of a NIC-link-down drop


def control_time(t, count):
    """CoDel's next drop instant t + interval / sqrt(count), in the
    reference's fixed point: isqrt(count << 32) from a float64 sqrt with
    +-1 corrections (exact for 0 <= count < 2**31)."""
    v = count << 32
    g = torch.sqrt(v.to(torch.float64)).to(torch.int64)
    g = torch.where(g * g > v, g - 1, g)
    g = torch.where(g * g > v, g - 1, g)
    g = torch.where((g + 1) * (g + 1) <= v, g + 1, g)
    g = torch.where((g + 1) * (g + 1) <= v, g + 1, g)
    g = g.clamp(min=1)
    return t + (CONTROL_INTERVAL_NS << 16) // g


def _put(st, key, mask, val):
    """State `key` takes `val` on the mask's lanes, in place."""
    t = st[key]
    t.copy_(torch.where(mask, val, t))


def _bucket(c, st, r, now, mask, size):
    """bucket_try: the token-bucket law, written back on `mask`."""
    bal3, nxt2, ok = bucket_step_ref(
        c.refill_ns, st[f"{r}_bal"], st[f"{r}_next"], st[f"{r}_refill"],
        st[f"{r}_cap"], st[f"{r}_unlimited"] == 1, size, now)
    _put(st, f"{r}_bal", mask, bal3)
    _put(st, f"{r}_next", mask, nxt2)
    return ok, nxt2


def relay1_law_ref(c: RelayConsts, st, mask, pop, sel, *, ring, conns):
    """op_relay1's lane-local tail after the qdisc pick (`pop`: a queued
    conn `sel` was picked): the packet (the throttled stash or the
    picked conn's ring head), the eth send counters, the r1 bucket, the
    stash of a throttled packet, the forward counters and the
    NIC-link-down drop.  Returns (throttled, linkdn, fwd, done, when,
    pk); `fwd` excludes the link-down drops."""
    where = torch.where
    now = st["now"]
    use_pend = mask & (st["r1_pk_valid"] == 1)
    sel_safe = sel.clamp(0, conns - 1)
    hsel = st["op_pos"][sel_safe] % ring
    pk = {kk: where(use_pend, st[f"r1_pk_{kk}"],
                    st[f"op_{kk}"][sel_safe, hsel])
          for kk in c.pk_keys}
    _put(st, "r1_pk_valid", use_pend, 0)
    size = pk["plen"] + c.hdr
    _put(st, "eth_psent", pop, st["eth_psent"] + 1)
    _put(st, "eth_bsent", pop, st["eth_bsent"] + size)

    has_pkt = use_pend | pop
    ok, when = _bucket(c, st, "r1", now, has_pkt, size)
    throttled = has_pkt & ~ok
    st["r1_stalls"] += throttled
    _put(st, "r1_pending", throttled, 1)
    _put(st, "r1_pk_valid", throttled, 1)
    for kk in c.pk_keys:
        _put(st, f"r1_pk_{kk}", throttled, pk[kk])

    fwd = has_pkt & ok
    st["r1_fwd_pkts"] += fwd
    st["r1_fwd_bytes"] += where(fwd, size, 0)
    _put(st, "pkts_sent", fwd, st["pkts_sent"] + 1)
    # NIC link down: the send dies at the egress instant, before the dst
    # lookup and the event-seq draw.
    linkdn = fwd & ((st["h_fault"] & 2) != 0)
    _put(st, "pkts_dropped", linkdn, st["pkts_dropped"] + 1)
    st["drop_causes"][:, c.tel_link_down] += linkdn
    done = mask & ~has_pkt | throttled
    return throttled, linkdn, fwd & ~linkdn, done, when, pk


def relay2_law_ref(c: RelayConsts, st, mask, *, ring):
    """op_relay2's lane-local tail: the CoDel dequeue (or the throttled
    stash), the head law, the sniff/chain/top control-law ladder, the
    drop counters, the r2 bucket, the stash of a throttled packet and
    the forward/eth receive counters.  Returns (codel_drop, throttled,
    fwd, done, when, pk)."""
    where = torch.where
    hidx = torch.arange(mask.shape[0], device=mask.device)
    now = st["now"]
    use_pend = mask & (st["r2_pk_valid"] == 1)
    src_avail = mask & ~use_pend & (st["cq_len"] > st["cq_pos"])
    pos = st["cq_pos"] % ring
    pk = {kk: where(use_pend, st[f"r2_pk_{kk}"], st[f"cq_{kk}"][hidx, pos])
          for kk in c.pk_keys}
    enq = st["cq_enq"][hidx, pos]
    pop = mask & ~use_pend & src_avail
    none = mask & ~use_pend & ~src_avail
    size = pk["plen"] + c.hdr

    _put(st, "r2_pk_valid", use_pend, 0)
    _put(st, "cq_pos", pop, st["cq_pos"] + 1)
    _put(st, "codel_bytes", pop, st["codel_bytes"] - size)
    # dequeue_raw's ok/first_above law
    quiet, above, arm, cok, fa_new = codel_head_ref(
        c.target_ns, c.mtu, pop, none, now, enq, st["codel_bytes"],
        st["codel_first_above"])
    st["codel_first_above"].copy_(fa_new)
    _put(st, "codel_dropping", none, 0)
    _put(st, "cd_chain", none, 0)
    _put(st, "cd_sniff", none, 0)

    in_sniff = st["cd_sniff"] == 1
    in_chain = (st["cd_chain"] == 1) & ~in_sniff
    top = pop & ~in_sniff & ~in_chain

    sg = pop & in_sniff
    cnt_new = where(
        now - st["codel_drop_next"] < CONTROL_INTERVAL_NS,
        where(st["codel_count"] > 2,
              st["codel_count"] - st["codel_last_count"], 1), 1)
    _put(st, "codel_dropping", sg, 1)
    _put(st, "codel_count", sg, cnt_new)
    _put(st, "codel_last_count", sg, cnt_new)
    _put(st, "codel_drop_next", sg, control_time(now, cnt_new))
    _put(st, "cd_sniff", sg, 0)

    cg_ = pop & in_chain
    cg_exit = cg_ & ~cok
    _put(st, "codel_dropping", cg_exit, 0)
    _put(st, "cd_chain", cg_exit, 0)
    cg_ok = cg_ & cok
    _put(st, "codel_drop_next", cg_ok,
         control_time(st["codel_drop_next"], st["codel_count"]))
    cg_drop = cg_ok & (now >= st["codel_drop_next"])
    _put(st, "cd_chain", cg_ok & ~cg_drop, 0)

    td = top & (st["codel_dropping"] == 1)
    _put(st, "codel_dropping", td & ~cok, 0)
    td_drop = td & cok & (now >= st["codel_drop_next"])
    _put(st, "cd_chain", td_drop, 1)

    tl = top & ~td & cok & (
        (now - st["codel_drop_next"] < CONTROL_INTERVAL_NS)
        | (now - st["codel_first_above"] >= CONTROL_INTERVAL_NS))
    _put(st, "cd_sniff", tl, 1)

    codel_drop = cg_drop | td_drop | tl
    _put(st, "codel_count", cg_drop | td_drop, st["codel_count"] + 1)
    _put(st, "codel_dropped", codel_drop, st["codel_dropped"] + 1)
    _put(st, "codel_drop_bytes", codel_drop, st["codel_drop_bytes"] + size)
    _put(st, "pkts_dropped", codel_drop, st["pkts_dropped"] + 1)
    st["drop_causes"][:, c.tel_codel] += codel_drop
    pop = pop & ~codel_drop

    has_pkt = use_pend | pop
    ok, when = _bucket(c, st, "r2", now, has_pkt, size)
    throttled = has_pkt & ~ok
    st["r2_stalls"] += throttled
    _put(st, "r2_pending", throttled, 1)
    _put(st, "r2_pk_valid", throttled, 1)
    for kk in c.pk_keys:
        _put(st, f"r2_pk_{kk}", throttled, pk[kk])

    fwd = has_pkt & ok
    st["r2_fwd_pkts"] += fwd
    st["r2_fwd_bytes"] += where(fwd, size, 0)
    # iface_receive: the eth counters
    _put(st, "eth_precv", fwd, st["eth_precv"] + 1)
    _put(st, "eth_brecv", fwd, st["eth_brecv"] + size)
    return codel_drop, throttled, fwd, none | throttled, when, pk


# ---------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------

def _declare_relay(lib) -> None:
    p = ctypes.c_void_p
    for fn in (lib.stt_relay1_law, lib.stt_relay2_law):
        fn.argtypes = [p, p, p]
        fn.restype = ctypes.c_int
    for fn in (lib.stt_relay1_operands, lib.stt_relay2_operands,
               lib.stt_relay_params):
        fn.argtypes = []
        fn.restype = ctypes.c_char_p
    lib.stt_relay_plen_col.argtypes = []
    lib.stt_relay_plen_col.restype = ctypes.c_int


LIBRARY = KernelLibrary("relay.cu", "libstt_relay.so", _declare_relay,
                        "stt_relay_error_string")


@dataclass(frozen=True)
class Operand:
    """One pointer of a relay kernel's operand table."""

    key: str        # state key, lane argument, "drop_causes" or "out.*"
    dims: tuple     # shape in the names n, ring, conns+1 ("*": any)
    written: bool   # a non-const field: written in place


def parse_operands(text: str, pk_keys) -> list:
    """The operand table a `stt_relay*_operands()` string names
    ("type|key|dims;" per field, queue_laws.cuh), with every "_*" key
    expanded to one operand per packet column in `pk_keys` order."""
    ops = []
    for entry in filter(None, text.split(";")):
        ctype, key, dims = entry.split("|")
        keys = ([key[:-1] + k for k in pk_keys] if key.endswith("_*")
                else [key])
        ops += [Operand(k, tuple(dims.split(",")),
                        not ctype.startswith("const")) for k in keys]
    return ops


class RelayLaw:
    """Wrapper of one fused relay kernel (`relay` 1 or 2; replaces the
    Pallas make_bucket_step / make_codel_head at the reference's relay
    sites, fused with the micro-op's lane-local tail)."""

    # The call's lane arguments and the flags it hands back, by name:
    # the kernel's table names the same ones.
    LANE_ARGS = {1: ("mask", "pop", "sel"), 2: ("mask",)}
    FLAGS = {1: ("throttled", "linkdn", "fwd", "done"),
             2: ("codel_drop", "throttled", "fwd", "done")}

    def __init__(self, relay: int, consts: RelayConsts):
        self.relay = relay
        self.c = consts
        self.lane_args = self.LANE_ARGS[relay]
        self.flag_names = self.FLAGS[relay]
        self.tel_col = consts.tel_link_down if relay == 1 \
            else consts.tel_codel
        self.launches = 0

    @property
    def name(self) -> str:
        return f"relay{self.relay}_law"

    def ref(self, st, mask, *lane, ring, conns):
        """The plain version (in place on `st`)."""
        if self.relay == 1:
            return relay1_law_ref(self.c, st, mask, *lane, ring=ring,
                                  conns=conns)
        return relay2_law_ref(self.c, st, mask, ring=ring)

    def bind(self, n: int, ring: int, conns: int) -> "BoundRelayLaw":
        """The callable of one span build: `n` host lanes, `ring` the
        CAP_OP (relay 1) or CAP_CQ (relay 2) ring width, `conns` the
        conn capacity CC (relay 1's conn-major arrays have CC + 1 rows)."""
        return BoundRelayLaw(self, n, ring, conns)

    def split_table(self, ops) -> tuple:
        """The kernel's operand table (`parse_operands`) as (lane args,
        state operands, outputs); raises unless it is laid out so: the
        lane arguments first, in the call's order, then the state, then
        exactly this law's outputs."""
        n_lane = len(self.lane_args)
        keys = [o.key for o in ops]
        n_dyn = sum(not k.startswith("out.") for k in keys)
        outs = {f"out.{f}" for f in self.flag_names} | {"out.when"} \
            | {f"out.pk_{k}" for k in self.c.pk_keys}
        if tuple(keys[:n_lane]) != self.lane_args \
                or sorted(keys[n_dyn:]) != sorted(outs):
            raise RuntimeError(f"{self.name}: the kernel's table {keys} is "
                               f"not the lane arguments {self.lane_args}, "
                               f"the state, then the outputs")
        return ops[:n_lane], ops[n_lane:n_dyn], ops[n_dyn:]

    def out_buffers(self, n: int, device) -> tuple:
        """Fresh output buffers: (the call's result, (*flags, when, pk),
        and the same tensors by their table keys "out.*")."""
        flags = torch.zeros((len(self.flag_names), n), dtype=torch.bool,
                            device=device)
        when = torch.zeros(n, dtype=torch.int64, device=device)
        pk = dict(zip(self.c.pk_keys,
                      torch.zeros((len(self.c.pk_keys), n),
                                  dtype=torch.int64, device=device)))
        by_key = {f"out.{f}": t for f, t in zip(self.flag_names, flags)}
        by_key["out.when"] = when
        by_key.update((f"out.pk_{k}", t) for k, t in pk.items())
        return (*flags, when, pk), by_key

    def param_words(self, n: int, ring: int, conns: int,
                    dc_stride: int) -> dict:
        """The kernel's per-launch constants, by their table names."""
        c = self.c
        return {"n": n, "ring": ring, "conns": conns, "dc_stride": dc_stride,
                "refill_ns": c.refill_ns, "target_ns": c.target_ns,
                "mtu": c.mtu, "interval_ns": CODEL_INTERVAL_NS,
                "hdr": c.hdr}


class BoundRelayLaw:
    """One span build's relay law: call with (st, mask, *lane args);
    lane args are (pop, sel) for relay 1 and none for relay 2.  Returns
    (*flags, when, pk): the flags on every lane; `pk` on the mask's lanes
    that carry a packet and `when` on its throttled lanes (elsewhere the
    kernel leaves them as they were; the plain version fills them)."""

    def __init__(self, law: RelayLaw, n: int, ring: int, conns: int):
        self.law = law
        self.n, self.ring, self.conns = n, ring, conns
        self._table = None   # ctypes pointer table, made at first launch

    def __call__(self, st, mask, *lane):
        if mask.device.type == "cpu":
            return self.law.ref(st, mask, *lane, ring=self.ring,
                                conns=self.conns)
        return self.launch(st, mask, *lane)

    # -- the kernel -----------------------------------------------------

    def _check(self, name, t, dtype, dims):
        sizes = {"n": self.n, "ring": self.ring, "conns+1": self.conns + 1}
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{self.law.name} {name}: expected a tensor, "
                            f"got {type(t)}")
        if t.device.type != "cuda":
            raise ValueError(f"{self.law.name} {name}: expected a CUDA "
                             f"tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{self.law.name} {name}: expected {dtype}, "
                            f"got {t.dtype}")
        if t.dim() != len(dims) or any(
                d != "*" and s != sizes[d] for s, d in zip(t.shape, dims)):
            raise ValueError(f"{self.law.name} {name}: expected shape "
                             f"({', '.join(dims)}), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{self.law.name} {name}: expected a "
                             f"contiguous tensor")

    def _prepare(self, st, mask, lane):
        """Once per build: read the kernel's operand and parameter names,
        check every operand by them, allocate the outputs and fill the
        constant parts of the pointer and parameter tables."""
        law, c = self.law, self.law.c
        lane_dtypes = {"mask": torch.bool, "pop": torch.bool,
                       "sel": torch.int64}
        for name, t in zip(law.lane_args, (mask, *lane)):
            self._check(name, t, lane_dtypes[name], ("n",))
        lib = LIBRARY.build()
        ops = parse_operands(
            getattr(lib, f"stt_relay{law.relay}_operands")().decode(),
            c.pk_keys)
        lane_ops, state_ops, out_ops = law.split_table(ops)
        for o in state_ops:
            self._check(o.key, st[o.key], torch.int64, o.dims)
        self.outs, out = law.out_buffers(self.n, mask.device)
        keys = [o.key for o in state_ops]
        self._state = itemgetter(*keys)
        # drop_causes: the relay's column, at its row stride
        dc = st["drop_causes"]
        self._offs = [dc.element_size() * law.tel_col
                      if k == "drop_causes" else 0 for k in keys]
        self._n_dyn = len(lane_ops) + len(state_ops)
        self._table = (ctypes.c_uint64 * len(ops))()
        self._table[self._n_dyn:] = [out[o.key].data_ptr() for o in out_ops]
        words = law.param_words(self.n, self.ring, self.conns, dc.stride(0))
        names = lib.stt_relay_params().decode().split()
        if sorted(names) != sorted(words) \
                or c.pk_keys.index("plen") != lib.stt_relay_plen_col():
            raise RuntimeError(f"{law.name}: the kernel's parameters "
                               f"{names} are not {list(words)}, or its "
                               f"packet length column differs")
        self._params = (ctypes.c_longlong * len(names))(
            *(words[k] for k in names))
        self._fn = getattr(lib, f"stt_{law.name}")
        self._addr = (ctypes.addressof(self._table),
                      ctypes.addressof(self._params))

    def launch(self, st, mask, *lane):
        """Launch once on the current stream.  Returns the outputs, views
        of buffers this binding owns and overwrites at its next launch."""
        if self._table is None:
            self._prepare(st, mask, lane)
        state = [t.data_ptr() + off
                 for t, off in zip(self._state(st), self._offs)]
        if len(set(state)) != len(state):
            raise RuntimeError(f"{self.law.name}: two state operands share "
                               f"storage; the kernel writes in place")
        self._table[:self._n_dyn] = [t.data_ptr() for t in (mask, *lane)] \
            + state
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        code = self._fn(self._addr[0], self._addr[1], stream)
        self.law.launches += 1
        LIBRARY.check(code, self.law.name)
        return self.outs
