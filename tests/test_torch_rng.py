"""The port's counter-based RNG against the JAX package, bit for bit.

Threefry keys every loss decision; the engine, the numpy path and the
device loop must draw identical bits.  The port's torch form computes
on int64 masked to 32 bits (PyTorch has no uint32 add or shift).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shadow_tpu.core import rng as jrng
from shadow_tpu_torch.core import rng as prng

KAT = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


@pytest.mark.parametrize("case", KAT, ids=["zero", "ones", "pi"])
def test_torch_threefry_known_answer_vectors(case):
    (k0, k1), (c0, c1), (e0, e1) = case
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    r0, r1 = prng.threefry2x32_torch(t(k0), t(k1), t(c0), t(c1))
    assert (int(r0), int(r1)) == (e0, e1)
    n0, n1 = prng.threefry2x32_np(k0, k1, c0, c1)
    assert (int(n0), int(n1)) == (e0, e1)
    assert prng.threefry2x32_py(k0, k1, c0, c1) == (e0, e1)


def test_torch_threefry_equals_jax_bit_for_bit():
    r = np.random.default_rng(5)
    k0, k1 = 0xDEADBEEF, 0x12345678
    c0 = r.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    c1 = r.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    c0[:2] = (0, 0xFFFFFFFF)
    c1[:2] = (0xFFFFFFFF, 0)
    j0, j1 = jrng.threefry2x32_jax(jnp.uint32(k0), jnp.uint32(k1),
                                   jnp.asarray(c0), jnp.asarray(c1))
    t0, t1 = prng.threefry2x32_torch(
        torch.tensor(k0), torch.tensor(k1),
        torch.from_numpy(c0.astype(np.int64)),
        torch.from_numpy(c1.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(j0).astype(np.int64),
                                  t0.numpy())
    np.testing.assert_array_equal(np.asarray(j1).astype(np.int64),
                                  t1.numpy())
    n0, n1 = prng.threefry2x32_np(k0, k1, c0, c1)
    np.testing.assert_array_equal(np.asarray(j0), n0)
    np.testing.assert_array_equal(np.asarray(j1), n1)


@pytest.mark.parametrize("seed,stream", [(1, 1), (11, 1), (11, 2),
                                         (2**40 + 3, 7)])
def test_torch_mix_key_matches(seed, stream):
    assert prng.mix_key(seed, stream) == jrng.mix_key(seed, stream)


@pytest.mark.parametrize("p", [0.0, 1e-9, 0.005, 0.02, 0.5, 1.0, 1.5])
def test_torch_loss_threshold_matches(p):
    assert prng.loss_threshold_u32(p) == jrng.loss_threshold_u32(p)


@pytest.mark.parametrize("host_id", [0, 1, 9999])
def test_torch_host_rng_matches(host_id):
    a = jrng.HostRng(seed=11, host_id=host_id)
    b = prng.HostRng(seed=11, host_id=host_id)
    assert (a._k0, a._k1) == (b._k0, b._k1)
    assert [a.next_u64() for _ in range(6)] == \
        [b.next_u64() for _ in range(6)]
