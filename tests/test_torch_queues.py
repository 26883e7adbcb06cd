"""The port's queue-scan laws against the JAX package's Pallas kernels.

The same numpy-seeded adversarial lanes as tests/test_overlap.py —
first-touch buckets (nxt == 0), lapsed multi-interval refills,
now < nxt, exact-balance debits, unlimited lanes; CoDel lanes
straddling the target and the MTU standing-queue escape — go through
`make_bucket_step(..., use_pallas=True)` / `make_codel_head(..., True)`
(interpret mode on the CPU) and through the port's wrappers on CPU
tensors, which run the plain PyTorch laws.  Integer laws: exact
equality.  The CUDA kernels themselves are held against the same laws
on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shadow_tpu.ops import pallas_queues as plq
from shadow_tpu.ops.tcp_span import CODEL_TARGET_NS, MTU, REFILL_NS
from shadow_tpu_torch.ops import queues
from shadow_tpu_torch.ops.tcp_span import BUCKET_STEP, CODEL_HEAD


def _inputs(H, seed=7):
    rng = np.random.default_rng(seed)
    i64 = np.int64
    now = i64(3_000_000_000) + rng.integers(0, 10**9, H, dtype=i64)
    bal = rng.integers(0, 10_000, H, dtype=i64)
    nxt = np.where(rng.random(H) < 0.25, i64(0),
                   now + rng.integers(-5 * REFILL_NS, 5 * REFILL_NS, H,
                                      dtype=i64))
    refill = rng.integers(1, 4_000, H, dtype=i64)
    cap = rng.integers(1, 20_000, H, dtype=i64)
    unlimited = rng.random(H) < 0.3
    size = rng.integers(0, 3_000, H, dtype=i64)
    size[:4] = bal[:4]  # exact-balance conformance edge
    pop = rng.random(H) < 0.7
    none = ~pop & (rng.random(H) < 0.5)
    enq = now - rng.integers(0, 3 * CODEL_TARGET_NS, H, dtype=i64)
    bytes_after = rng.integers(0, 4 * MTU, H, dtype=i64)
    bytes_after[:4] = MTU  # standing-queue escape boundary
    first_above = np.where(rng.random(H) < 0.4, i64(0),
                           now + rng.integers(-10**8, 10**8, H, dtype=i64))
    return dict(now=now, bal=bal, nxt=nxt, refill=refill, cap=cap,
                unlimited=unlimited, size=size, pop=pop, none=none,
                enq=enq, bytes_after=bytes_after, first_above=first_above)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("scalar_now", [False, True], ids=["lane", "scalar"])
@pytest.mark.parametrize("H", [1, 64, 1000])
def test_torch_bucket_step_equals_pallas(H, scalar_now):
    d = _inputs(H)
    now = d["now"][0] if scalar_now else d["now"]
    pal = plq.make_bucket_step(jax, jnp, H, REFILL_NS, True)
    want = pal(d["bal"], d["nxt"], d["refill"], d["cap"], d["unlimited"],
               d["size"], now)
    got = BUCKET_STEP(_t(d["bal"]), _t(d["nxt"]), _t(d["refill"]),
                      _t(d["cap"]), _t(d["unlimited"]), _t(d["size"]),
                      torch.tensor(now) if scalar_now else _t(now))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert BUCKET_STEP.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("scalar_now", [False, True], ids=["lane", "scalar"])
@pytest.mark.parametrize("H", [1, 64, 1000])
def test_torch_codel_head_equals_pallas(H, scalar_now):
    d = _inputs(H)
    now = d["now"][0] if scalar_now else d["now"]
    pal = plq.make_codel_head(jax, jnp, H, CODEL_TARGET_NS, MTU, True)
    want = pal(d["pop"], d["none"], now, d["enq"], d["bytes_after"],
               d["first_above"])
    got = CODEL_HEAD(_t(d["pop"]), _t(d["none"]),
                     torch.tensor(now) if scalar_now else _t(now),
                     _t(d["enq"]), _t(d["bytes_after"]),
                     _t(d["first_above"]))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert CODEL_HEAD.launches == 0


def test_torch_queue_wrappers_refuse_non_cuda_devices():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device is refused before any build, never computed by the
    plain law."""
    m = torch.empty(4, dtype=torch.int64, device="meta")
    b = torch.empty(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        BUCKET_STEP(m, m, m, m, b, m, m)
    with pytest.raises(ValueError, match="CUDA"):
        CODEL_HEAD(b, b, m, m, m, m)
    assert queues.LIBRARY.lib is None
