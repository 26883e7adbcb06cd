"""The port's relay laws (ops/relay.py) against the JAX package.

1. The plain relay laws on seeded lanes built to reach every branch
   (shadow_tpu_torch/tools/relay_cases.py, numpy-made): each case lands
   in its branch, only the mask's lanes change, and the bucket and
   CoDel-head parts equal the reference's laws run through the Pallas
   kernels in interpret mode (`make_bucket_step` / `make_codel_head`).
   Integer laws: exact equality.  The fused CUDA kernels are held
   against these plain laws on the card by chip_smoke.py; here their
   lane code (csrc/queue_laws.cuh, plain C++ apart from its qualifiers)
   is built for the host and held against them on the same lanes,
   through operand tables filled by the header's own names.
2. CoDel's control law, exact against the integer square root for
   every count below 2**31 the span can hold.
3. A 16-host stream with narrow host bandwidth, where CoDel drops and
   the relays throttle inside device spans: the reference's serial
   object path vs the port's forced device spans, identical traces.
4. The per-stage fire/lane counters of those spans keep the reference
   observatory's bounds.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu.ops import pallas_queues as plq
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import run_simulation
from shadow_tpu_torch.ops import relay, tcp_span
from shadow_tpu_torch.ops.tcp_span import (CODEL_TARGET_NS, KS_N, KS_PASSES,
                                           MTU, PK_KEYS, REFILL_NS,
                                           RELAY1_LAW, RELAY2_LAW,
                                           TCP_TOTAL_HDR, TEL_CODEL,
                                           TEL_LINK_DOWN)
from shadow_tpu_torch.tools.netgen import tcp_stream_yaml
from shadow_tpu_torch.tools.relay_cases import (R1_CASES, R2_CASES,
                                                carried, clone_state,
                                                relay_case_state,
                                                relay_mismatch,
                                                relay_need_bytes)

H = 1000
CQ, OP = 64, 16       # ring widths (the law reads one slot per lane)
CONNS = 2 * H + 3
DENSITIES = [0.001, 0.1, 1.0]


def _case_run(relay_no, density, seed=5):
    st0, m1, pop, sel, m2, cases = relay_case_state(
        H, seed=seed, density=density, cq_cap=CQ, op_cap=OP, conns=CONNS,
        device="cpu")
    st = clone_state(st0)
    if relay_no == 1:
        out = RELAY1_LAW.bind(H, OP, CONNS)(st, m1, pop, sel)
        mask = m1
    else:
        out = RELAY2_LAW.bind(H, CQ, CONNS)(st, m2)
        mask = m2
    return st0, st, mask, out, cases[relay_no]


def _np(t):
    return t.numpy()


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("relay_no", [1, 2])
def test_torch_relay_law_touches_only_masked_lanes(host_laws, relay_no,
                                                   density):
    """Every state word off the mask keeps its value (rings and the
    conn-major arrays are not written at all); the flags are false off
    the mask; the CPU path never launches."""
    st0, st, mask, out, _cases = _case_run(relay_no, density)
    off = ~mask
    law = RELAY1_LAW if relay_no == 1 else RELAY2_LAW
    for k, v in st0.items():
        if k.startswith(("cq_", "op_")) and v.dim() == 2 or k == "op_pos":
            assert torch.equal(v, st[k]), k
        elif v.shape[0] == H:
            assert torch.equal(v[off], st[k][off]), k
    for flag in out[:4]:
        assert flag.dtype == torch.bool and not flag[off].any()
    written = {k for k in st0 if not torch.equal(st0[k], st[k])}
    assert written <= {o.key for o in _host_ops(host_laws, law)
                       if o.written}, written
    assert mask.sum() == max(1, round(density * H))
    assert law.launches == 0


def _outcome(st0, st, mask, out, cases, case, pend):
    lanes = mask.numpy() & (cases == case) \
        & (st0[pend].numpy() == int(case.startswith("pend")))
    return lanes, {k: v.numpy()[lanes] for k, v in st.items()
                   if v.dim() == 1 and v.shape[0] == H}, \
        {k: v.numpy()[lanes] for k, v in st0.items()
         if v.dim() == 1 and v.shape[0] == H}


@pytest.mark.parametrize("density", [0.1, 1.0])
def test_torch_relay2_law_reaches_every_branch(density):
    """Each relay-2 case lands in the branch it is built for."""
    st0, st, mask, out, cases = _case_run(2, density)
    codel_drop, throttled, fwd, done, when, pk = (
        o.numpy() if isinstance(o, torch.Tensor) else o for o in out)
    seen = set()
    for case in R2_CASES:
        lanes, a, b = _outcome(st0, st, mask, out, cases, case,
                               "r2_pk_valid")
        if not lanes.any():
            continue
        seen.add(case)
        cd = codel_drop[lanes]
        has = throttled[lanes] | fwd[lanes]
        if case == "pend_fwd":
            assert fwd[lanes].all() and not cd.any()
            assert (a["r2_pk_valid"] == 0).all()
        elif case == "pend_throttled":
            assert throttled[lanes].all()
            assert (a["r2_stalls"] == b["r2_stalls"] + 1).all()
        elif case == "empty":
            assert done[lanes].all() and not has.any()
            assert (a["cd_chain"] == 0).all() and (a["cd_sniff"] == 0).all()
            assert (a["codel_dropping"] == 0).all()
            assert (a["codel_first_above"] == 0).all()
        elif case in ("quiet", "quiet_mtu"):
            assert (a["codel_first_above"] == 0).all()
            assert (a["cq_pos"] == b["cq_pos"] + 1).all()
        elif case == "arm":
            assert (a["codel_first_above"]
                    == b["now"] + plq.CODEL_INTERVAL_NS).all()
        elif case == "above_early":
            assert (a["codel_first_above"] == b["codel_first_above"]).all()
        elif case in ("sniff_entry", "sniff_big_count"):
            assert (a["codel_dropping"] == 1).all()
            assert (a["cd_sniff"] == 0).all() and not cd.any()
            recent = b["now"] - b["codel_drop_next"] \
                < plq.CODEL_INTERVAL_NS
            cnt = np.where(recent & (b["codel_count"] > 2),
                           b["codel_count"] - b["codel_last_count"], 1)
            assert (a["codel_count"] == cnt).all()
            assert (a["codel_drop_next"] == _control_time_int(
                b["now"], cnt)).all()
        elif case == "chain_exit":
            assert (a["codel_dropping"] == 0).all()
            assert (a["cd_chain"] == 0).all() and not cd.any()
        elif case == "chain_drop":
            assert cd.all() and (a["cd_chain"] == 1).all()
            assert (a["codel_count"] == b["codel_count"] + 1).all()
            assert (a["codel_drop_next"] == _control_time_int(
                b["codel_drop_next"], b["codel_count"])).all()
        elif case == "chain_ok":
            assert not cd.any() and (a["cd_chain"] == 0).all()
        elif case == "top_drop":
            assert cd.all() and (a["cd_chain"] == 1).all()
        elif case == "top_exit":
            assert not cd.any() and (a["codel_dropping"] == 0).all()
        elif case == "top_ok":
            assert not cd.any() and (a["codel_dropping"] == 1).all()
        elif case in ("tl_recent", "tl_first_above"):
            assert cd.all() and (a["cd_sniff"] == 1).all()
        elif case == "top_deliver":
            assert not cd.any() and (a["cd_sniff"] == 0).all()
        if cd.any():
            assert (a["codel_dropped"] == b["codel_dropped"] + cd).all()
            assert not has[cd].any()
    dc = st["drop_causes"][:, TEL_CODEL] - st0["drop_causes"][:, TEL_CODEL]
    assert torch.equal(dc, out[0].to(torch.int64))
    assert seen == set(R2_CASES), set(R2_CASES) - seen


@pytest.mark.parametrize("density", [0.1, 1.0])
def test_torch_relay1_law_reaches_every_branch(density):
    """Each relay-1 case lands in the branch it is built for."""
    st0, st, mask, out, cases = _case_run(1, density)
    throttled, linkdn, fwd, done, when, pk = (
        o.numpy() if isinstance(o, torch.Tensor) else o for o in out)
    seen = set()
    for case in R1_CASES:
        lanes, a, b = _outcome(st0, st, mask, out, cases, case,
                               "r1_pk_valid")
        if not lanes.any():
            continue
        seen.add(case)
        if case in ("pend_fwd", "pop_fwd"):
            assert fwd[lanes].all()
            assert (a["pkts_sent"] == b["pkts_sent"] + 1).all()
        elif case in ("pend_throttled", "pop_throttled"):
            assert throttled[lanes].all() and done[lanes].all()
            assert (a["r1_pk_valid"] == 1).all()
            assert (a["r1_pending"] == 1).all()
        elif case == "no_packet":
            assert done[lanes].all() and not fwd[lanes].any()
            assert not throttled[lanes].any()
        elif case in ("pop_linkdown", "pend_linkdown"):
            assert linkdn[lanes].all() and not fwd[lanes].any()
            assert (a["pkts_dropped"] == b["pkts_dropped"] + 1).all()
        elif case == "first_touch":
            assert (a["r1_next"] == b["now"] + REFILL_NS).all()
        elif case == "lapsed_refill":
            assert (a["r1_next"] > b["now"]).all()
        elif case == "exact_balance":
            assert fwd[lanes].all() and (a["r1_bal"] == 0).all()
        if case.startswith("pop"):
            assert (a["eth_psent"] == b["eth_psent"] + 1).all()
    dc = st["drop_causes"][:, TEL_LINK_DOWN] \
        - st0["drop_causes"][:, TEL_LINK_DOWN]
    assert torch.equal(dc, out[1].to(torch.int64))
    assert seen == set(R1_CASES), set(R1_CASES) - seen


def _control_time_int(t, count):
    """CoDel's control law with Python integers: t + (100 ms << 16) //
    max(isqrt(count << 32), 1)."""
    return np.array([int(a) + (100_000_000 << 16)
                     // max(math.isqrt(int(c) << 32), 1)
                     for a, c in zip(t, count)], dtype=np.int64)


def _pallas_bucket(bal, nxt, refill, cap, unlimited, size, now):
    step = plq.make_bucket_step(jax, jnp, H, REFILL_NS, True)
    return [np.asarray(x) for x in step(bal, nxt, refill, cap, unlimited,
                                        size, now)]


@pytest.mark.parametrize("relay_no", [1, 2])
def test_torch_relay_law_bucket_equals_pallas(relay_no):
    """The bucket part: on the lanes with a packet the r{1,2} bucket
    words are the Pallas bucket step's, `when` is its next refill on
    every mask lane, and a lane throttles iff the step refuses it."""
    st0, st, mask, out, _cases = _case_run(relay_no, 1.0)
    r = f"r{relay_no}"
    flags, when, pk = out[:4], out[4], out[5]
    if relay_no == 1:
        throttled, linkdn, fwd = flags[0], flags[1], flags[2]
        has = throttled | fwd | linkdn
    else:
        throttled, fwd = flags[1], flags[2]
        has = throttled | fwd
    size = _np(pk["plen"]) + TCP_TOTAL_HDR
    bal3, nxt2, ok = _pallas_bucket(
        _np(st0[f"{r}_bal"]), _np(st0[f"{r}_next"]), _np(st0[f"{r}_refill"]),
        _np(st0[f"{r}_cap"]), _np(st0[f"{r}_unlimited"]) == 1, size,
        _np(st0["now"]))
    has, m = _np(has), _np(mask)
    np.testing.assert_array_equal(_np(st[f"{r}_bal"]),
                                  np.where(has, bal3, _np(st0[f"{r}_bal"])))
    np.testing.assert_array_equal(_np(st[f"{r}_next"]),
                                  np.where(has, nxt2, _np(st0[f"{r}_next"])))
    np.testing.assert_array_equal(_np(when)[m], nxt2[m])
    np.testing.assert_array_equal(_np(throttled), has & ~ok)
    assert has.any() and (has & ~ok).any() and (has & ok).any()


def test_torch_relay2_law_codel_head_equals_pallas():
    """The CoDel-head part: the dequeue (cq_pos, codel_bytes) and the
    first_above word are the Pallas head's on the same inputs."""
    st0, st, mask, out, _cases = _case_run(2, 1.0)
    m = _np(mask)
    use_pend = m & (_np(st0["r2_pk_valid"]) == 1)
    pos0, cq_len = _np(st0["cq_pos"]), _np(st0["cq_len"])
    pop = m & ~use_pend & (cq_len > pos0)
    none = m & ~use_pend & ~pop
    slot = pos0 % CQ
    lanes = np.arange(H)
    enq = _np(st0["cq_enq"])[lanes, slot]
    plen = np.where(use_pend, _np(st0["r2_pk_plen"]),
                    _np(st0["cq_plen"])[lanes, slot])
    np.testing.assert_array_equal(_np(out[5]["plen"])[m], plen[m])
    after = _np(st0["codel_bytes"]) - np.where(pop, plen + TCP_TOTAL_HDR, 0)
    head = plq.make_codel_head(jax, jnp, H, CODEL_TARGET_NS, MTU, True)
    quiet, above, arm, cok, fa_new = (np.asarray(x) for x in head(
        pop, none, _np(st0["now"]), enq, after,
        _np(st0["codel_first_above"])))
    np.testing.assert_array_equal(_np(st["codel_first_above"]), fa_new)
    np.testing.assert_array_equal(_np(st["codel_bytes"]), after)
    np.testing.assert_array_equal(_np(st["cq_pos"]), pos0 + pop)
    assert quiet.any() and arm.any() and cok.any() and none.any()


def test_torch_control_time_exact_below_2_31():
    """control_time == t + (100 ms << 16) // max(isqrt(count << 32), 1)
    for counts from 0 to 2**31 - 1 (edges, powers of two and seeded
    samples)."""
    rng = np.random.default_rng(3)
    counts = np.unique(np.concatenate([
        np.arange(0, 5000), (1 << 31) - 1 - np.arange(5000),
        [1 << k for k in range(31)], [(1 << k) - 1 for k in range(1, 32)],
        rng.integers(0, 1 << 31, 20_000)])).astype(np.int64)
    t = rng.integers(0, 1 << 40, counts.shape[0], dtype=np.int64)
    got = relay.control_time(torch.from_numpy(t),
                             torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got, _control_time_int(t, counts))


def test_torch_relay_wrappers_refuse_non_cuda_devices():
    """Off the CPU a relay wrapper launches its kernel or raises: a
    tensor on another device is refused before any build."""
    st0, m1, pop, sel, m2, _ = relay_case_state(
        8, seed=1, density=1.0, cq_cap=CQ, op_cap=OP, conns=20,
        device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        RELAY1_LAW.bind(8, OP, 20)(st0, m1, pop, sel)
    with pytest.raises(ValueError, match="CUDA"):
        RELAY2_LAW.bind(8, CQ, 20)(st0, m2)
    assert relay.LIBRARY.lib is None
    assert RELAY1_LAW.launches == RELAY2_LAW.launches == 0


# The lane laws of csrc/queue_laws.cuh are plain C++ apart from their
# qualifiers: built for the host, they run here on the same lanes as the
# plain versions, through the operand and parameter tables the kernel's
# own name strings describe.
HOST_SHIM = r"""
#include <cstring>
#include "queue_laws.cuh"
extern "C" const char* host_operands(int r) {
  return r == 1 ? stt::kRelay1Operands : stt::kRelay2Operands;
}
extern "C" const char* host_params() { return stt::kRelayParamNames; }
extern "C" int host_plen_col() { return stt::kPlenCol; }
extern "C" void host_relay(int r, const void* const* ptrs,
                           const long long* words) {
  stt::RelayParams p;
  std::memcpy(&p, words, sizeof p);
  if (r == 1) {
    stt::Relay1Ops o;
    std::memcpy(&o, ptrs, sizeof o);
    for (int64_t i = 0; i < p.n; i++) stt::relay1_lane(o, p, i);
  } else {
    stt::Relay2Ops o;
    std::memcpy(&o, ptrs, sizeof o);
    for (int64_t i = 0; i < p.n; i++) stt::relay2_lane(o, p, i);
  }
}
"""


@pytest.fixture(scope="module")
def host_laws(tmp_path_factory):
    """queue_laws.cuh's relay lanes built for the host with the system
    C++ compiler (the one the engine builds with)."""
    import ctypes
    import os
    import shutil
    import subprocess
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("relay_host")
    (d / "shim.cpp").write_text(HOST_SHIM)
    csrc = os.path.join(os.path.dirname(relay.__file__), "..", "csrc")
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", csrc, "-o", str(d / "librelay_host.so"),
                    str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "librelay_host.so"))
    lib.host_operands.argtypes = [ctypes.c_int]
    lib.host_operands.restype = ctypes.c_char_p
    lib.host_params.restype = ctypes.c_char_p
    lib.host_plen_col.restype = ctypes.c_int
    lib.host_relay.argtypes = [ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p]
    lib.host_relay.restype = None
    return lib


def _host_ops(lib, law):
    return relay.parse_operands(lib.host_operands(law.relay).decode(),
                                PK_KEYS)


def _host_run(lib, law, st, mask, lane, ring, conns):
    """One relay law through the host build: the pointer table filled by
    the kernel's own names, as the wrapper fills it on the card."""
    import ctypes
    lane_ops, state_ops, out_ops = law.split_table(_host_ops(lib, law))
    outs, by_key = law.out_buffers(H, "cpu")
    dc = st["drop_causes"]
    ptrs = [t.data_ptr() for t in (mask, *lane)]
    ptrs += [dc.data_ptr() + 8 * law.tel_col if o.key == "drop_causes"
             else st[o.key].data_ptr() for o in state_ops]
    ptrs += [by_key[o.key].data_ptr() for o in out_ops]
    words = law.param_words(H, ring, conns, dc.stride(0))
    names = lib.host_params().decode().split()
    table = (ctypes.c_uint64 * len(ptrs))(*ptrs)
    params = (ctypes.c_longlong * len(names))(*(words[k] for k in names))
    lib.host_relay(law.relay, table, params)
    return outs


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("relay_no", [1, 2])
def test_torch_relay_lane_laws_host_build_equal_plain(host_laws, relay_no,
                                                     density):
    """The kernels' lane code (queue_laws.cuh, host build) equals the
    plain relay laws on every branch case: every flag and state word,
    the packet on the lanes that carried one, `when` on throttled lanes."""
    st0, m1, pop, sel, m2, _cases = relay_case_state(
        H, seed=5, density=density, cq_cap=CQ, op_cap=OP, conns=CONNS,
        device="cpu")
    law = RELAY1_LAW if relay_no == 1 else RELAY2_LAW
    mask, lane, ring = (m1, (pop, sel), OP) if relay_no == 1 \
        else (m2, (), CQ)
    st_k, st_p = clone_state(st0), clone_state(st0)
    got = _host_run(host_laws, law, st_k, mask, lane, ring, CONNS)
    want = law.ref(st_p, mask, *lane, ring=ring, conns=CONNS)
    err, bad = relay_mismatch(law, got, want, st_k, st_p)
    assert not bad, (bad, err)
    if density == 1.0:
        assert all(flag.any() for flag in want[:4])


def test_torch_relay_need_bytes_by_hand():
    """The relay kernels' bound counts what each lane's branch needs,
    checked on lanes counted by hand (8 lanes, one on the mask): 5 bytes
    (mask + four flags) per lane, and 8 per word read or changed."""
    n = 8
    st0, m1, pop, sel, m2, _ = relay_case_state(
        n, seed=2, density=1.0, cq_cap=CQ, op_cap=OP, conns=2 * n,
        device="cpu")
    one = torch.zeros(n, dtype=torch.bool)
    one[0] = True

    def need(law, st, mask, lane, ring):
        out = law.ref(clone_state(st), mask, *lane, ring=ring, conns=2 * n)
        after = clone_state(st)
        law.ref(after, mask, *lane, ring=ring, conns=2 * n)
        return relay_need_bytes(law, st, after, mask, lane, out)

    # relay 2, an empty queue already out of any dropping state: the
    # pending word and the queue's two positions
    st = clone_state(st0)
    for k in ("r2_pk_valid", "codel_first_above", "codel_dropping",
              "cd_chain", "cd_sniff"):
        st[k][0] = 0
    st["cq_len"][0] = st["cq_pos"][0]
    assert need(RELAY2_LAW, st, one, (), CQ) == 5 * n + 8 * 3
    # relay 1, nothing queued and nothing pending: the pop byte and the
    # pending word
    st = clone_state(st0)
    st["r1_pk_valid"][0] = 0
    no_pop = torch.zeros(n, dtype=torch.bool)
    assert need(RELAY1_LAW, st, one, (no_pop, sel), OP) == 5 * n + 1 + 8
    # relay 1, a pending packet forwarded by an unlimited bucket that
    # does not refill yet: reads pending + stash (21) + now + bucket (5)
    # + fault + three counters = 32 words, writes pending and the three
    # counters, hands back the packet (21)
    st["r1_pk_valid"][0] = 1
    st["r1_unlimited"][0] = 1
    st["h_fault"][0] = 0
    st["r1_next"][0] = st["now"][0] + REFILL_NS
    assert need(RELAY1_LAW, st, one, (no_pop, sel), OP) \
        == 5 * n + 1 + 8 * (32 + 4 + 21)


class _Recording(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, st):
        super().__init__(st)
        self.seen = set()

    def __getitem__(self, k):
        self.seen.add(k)
        return super().__getitem__(k)


def test_torch_relay_operand_lists_match_the_kernel_tables(host_laws):
    """The kernels' operand tables, read by name from the header's own
    strings: laid out as the wrapper fills them (lane arguments, state,
    outputs); their state keys are exactly the keys the plain versions
    touch; only non-const operands change; the parameter names are the
    wrapper's and the packet length column is PK_KEYS'."""
    st0, m1, pop, sel, m2, _cases = relay_case_state(
        H, seed=5, density=1.0, cq_cap=CQ, op_cap=OP, conns=CONNS,
        device="cpu")
    for law, mask, lane, ring in ((RELAY1_LAW, m1, (pop, sel), OP),
                                  (RELAY2_LAW, m2, (), CQ)):
        _lane, state_ops, _out = law.split_table(_host_ops(host_laws, law))
        st = _Recording(clone_state(st0))
        law.ref(st, mask, *lane, ring=ring, conns=CONNS)
        keys = {o.key for o in state_ops}
        assert keys == st.seen, (keys ^ st.seen)
        changed = {k for k in st0 if not torch.equal(st0[k], st[k])}
        assert changed <= {o.key for o in state_ops if o.written}, changed
        for o in state_ops:
            sizes = {"n": H, "ring": ring, "conns+1": CONNS + 1}
            assert all(d == "*" or s == sizes[d]
                       for s, d in zip(st0[o.key].shape, o.dims)), o
    assert sorted(host_laws.host_params().decode().split()) == \
        sorted(RELAY1_LAW.param_words(1, 1, 1, 1))
    assert host_laws.host_plen_col() == PK_KEYS.index("plen")


def test_torch_stage_slots_pinned():
    """The port's stage slots and names are the reference observatory's."""
    from shadow_tpu.ops import tcp_span as ref
    from shadow_tpu.trace.events import KS_NAMES
    for name in ("KS_POP", "KS_STEP", "KS_CODEL", "KS_ON_PACKET", "KS_REASM",
                 "KS_ACK", "KS_PUSH", "KS_FLUSH", "KS_INET_OUT", "KS_ARM",
                 "KS_TIMERS", "KS_EXCHANGE", "KS_N"):
        assert getattr(tcp_span, name) == getattr(ref, name), name
    assert tcp_span.KS_NAMES == KS_NAMES


# ---------------------------------------- narrow bandwidth, device spans

# (bw_down, bw_up): a 1 Mbit downlink behind a 100 Mbit uplink queues
# at the receivers' CoDel (drops, relay-2 throttling); a 10 Mbit server
# uplink shared by its clients throttles relay 1 too.
NARROW = {"codel": ("1 Mbit", "100 Mbit"), "uplink": ("2 Mbit", "10 Mbit")}
STOP = "500ms"
_COUNTED = ("codel_dropped", "r1_stalls", "r2_stalls")


def _narrow_yaml(which, scheduler, spans=None):
    down, up = NARROW[which]
    return tcp_stream_yaml(16, nbytes=50_000_000, loss=0.0, stop_time=STOP,
                           seed=11, scheduler=scheduler, device_spans=spans,
                           bw_down=down, bw_up=up)


@pytest.fixture(scope="module")
def narrow_runs():
    """Both narrow streams, serial object path and forced port device
    spans, with the relay counters' growth inside committed spans."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    orig = tcp_span.TcpSpanRunner._span_call
    runs = {}
    try:
        for which in NARROW:
            grew = dict.fromkeys(_COUNTED, 0)

            def spy(self, fn, st, *a, grew=grew):
                before = {k: int(st[k].sum()) for k in _COUNTED}
                out, dt = orig(self, fn, st, *a)
                if int(out[0]["abort_code"]) == 0:
                    for k in _COUNTED:
                        grew[k] += int(out[0][k].sum()) - before[k]
                return out, dt

            m_ser, s_ser = jrun(JConfig.from_yaml_text(
                _narrow_yaml(which, "serial")))
            tcp_span.TcpSpanRunner._span_call = spy
            try:
                mgr, s_dev = run_simulation(ConfigOptions.from_yaml_text(
                    _narrow_yaml(which, "tpu", "force")), device="cpu")
            finally:
                tcp_span.TcpSpanRunner._span_call = orig
            runs[which] = (m_ser, s_ser, mgr, s_dev, grew)
    finally:
        torch.set_num_threads(prev)
    return runs


@pytest.mark.parametrize("which", list(NARROW))
def test_torch_narrow_stream_device_spans_match_serial(narrow_runs, which):
    """Device spans that drop at CoDel and throttle at the relays give
    the serial path's trace byte for byte."""
    m_ser, s_ser, mgr, s_dev, grew = narrow_runs[which]
    r = mgr._dev_span_tcp
    assert s_ser.ok and s_dev.ok
    assert r is not None and r.spans > 0 and r.aborts == 0, \
        r.abort_kind_counts()
    assert m_ser.trace_lines() == mgr.trace_lines()
    assert (s_ser.events, s_ser.packets_sent, s_ser.packets_dropped) == \
        (s_dev.events, s_dev.packets_sent, s_dev.packets_dropped)
    assert r.rounds * 2 >= s_dev.rounds
    assert grew["r1_stalls"] + grew["r2_stalls"] > 0, grew
    if which == "codel":
        assert grew["codel_dropped"] > 0, grew
    else:
        assert grew["r1_stalls"] > 0 and grew["r2_stalls"] > 0, grew


@pytest.mark.parametrize("which", list(NARROW))
def test_torch_stage_counters_keep_the_observatory_bounds(narrow_runs,
                                                          which):
    """The per-stage counters of committed spans: the event pop fires at
    most once per trip (micro-iteration), every stage at most its passes
    per trip, a fire has at least one lane and at most H, the relays and
    the pop fired, and a stage that fired spent host wall."""
    _m_ser, _s_ser, mgr, _s_dev, _grew = narrow_runs[which]
    r = mgr._dev_span_tcp
    trips = r.micro_iters
    fires, lanes, wall = r.ks_fires, r.ks_lanes, r.ks_wall_s
    assert trips > 0 and fires.shape == lanes.shape == (KS_N,)
    for code in range(KS_N):
        passes = KS_PASSES.get(code, 0)
        assert fires[code] <= passes * trips, code
        assert fires[code] <= lanes[code] <= 16 * fires[code], code
        assert (wall[code] > 0) == (fires[code] > 0), code
    for code in (tcp_span.KS_POP, tcp_span.KS_CODEL, tcp_span.KS_INET_OUT,
                 tcp_span.KS_ON_PACKET):
        assert fires[code] > 0, code
    # The relay kernels' lane counts: every relay-2 fire is one launch.
    assert RELAY2_LAW.launches == RELAY1_LAW.launches == 0
