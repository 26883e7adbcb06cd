"""Deterministic, order-independent randomness (the port's copy).

Every per-packet loss decision is a counter-based threefry2x32 draw
keyed by the packet's identity,

    bits = threefry2x32(key=(seed, stream), ctr=(src_host_id, packet_seq))

so the engine's C++ twin, the numpy path and the device loop compute
bit-identical decisions in any execution order.  This module is the
port's own copy of `shadow_tpu/core/rng.py`; tests/test_torch_rng.py
holds it against the JAX package bit for bit.

PyTorch has no uint32 add, shift or min, so the torch form computes on
int64 tensors and masks with `& 0xFFFFFFFF` after every add and rotate.
It is counter-based, so it needs no `torch.Generator`.
"""

from __future__ import annotations

import numpy as np

# Threefry constants (public algorithm specification).
_PARITY = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_M32 = 0xFFFFFFFF

# Stream identifiers: disjoint key-spaces for independent uses of the
# seed (pinned to the JAX package's values by the tier-1 tests).
STREAM_PACKET_LOSS = 1
STREAM_HOST = 2  # per-host general-purpose stream (ports, auxv, jitter)


def threefry2x32_torch(k0, k1, c0, c1):
    """20-round threefry2x32 over int64 tensors holding uint32 values.

    Inputs broadcast against each other (keys are usually 0-d); the
    outputs are int64 tensors in [0, 2**32)."""
    def rotl(x, r):
        return ((x << r) & _M32) | (x >> (32 - r))

    k0 = k0 & _M32
    k1 = k1 & _M32
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for d in range(5):  # 5 groups x 4 rounds = 20
        for r in _ROT_A if d % 2 == 0 else _ROT_B:
            x0 = (x0 + x1) & _M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & _M32
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & _M32
    return x0, x1


def threefry2x32_np(k0, k1, c0, c1):
    """Numpy form; scalar or array uint32 inputs -> (uint32, uint32)."""
    u32 = np.uint32
    k0, k1, c0, c1 = (np.asarray(v, dtype=u32) for v in (k0, k1, c0, c1))

    def rotl(x, r):
        return (x << u32(r)) | (x >> u32(32 - r))

    with np.errstate(over="ignore"):
        k2 = k0 ^ k1 ^ u32(_PARITY)
        ks = (k0, k1, k2)
        x0 = (c0 + k0).astype(u32)
        x1 = (c1 + k1).astype(u32)
        for d in range(5):
            for r in _ROT_A if d % 2 == 0 else _ROT_B:
                x0 = (x0 + x1).astype(u32)
                x1 = rotl(x1, r) ^ x0
            x0 = (x0 + ks[(d + 1) % 3]).astype(u32)
            x1 = (x1 + ks[(d + 2) % 3] + u32(d + 1)).astype(u32)
    return x0, x1


def threefry2x32_py(k0: int, k1: int, c0: int, c1: int) -> tuple[int, int]:
    """Pure-Python-int threefry2x32 for the host stream's scalar draws."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for d in range(5):
        for r in _ROT_A if d % 2 == 0 else _ROT_B:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & _M32
        x1 = (x1 + ks[(d + 2) % 3] + d + 1) & _M32
    return x0, x1


def mix_key(seed: int, stream: int):
    """Fold (seed, stream) into a 2x32 threefry key (host-side, cheap)."""
    k = (seed * 0x9E3779B97F4A7C15 + stream) & 0xFFFFFFFFFFFFFFFF
    return (k & 0xFFFFFFFF, k >> 32)


def loss_threshold_u32(probability: float) -> int:
    """Integer threshold for `drop iff bits < threshold`, computed once
    on the host in float64.  It lies in [0, 2**32], so comparisons run
    in >= 33-bit arithmetic (int64 on the device)."""
    if probability <= 0.0:
        return 0
    if probability >= 1.0:
        return 1 << 32
    return int(probability * float(1 << 32))


class HostRng:
    """Stateful counter-based stream for one host: (key, counter).

    Once the host is on the engine, the engine owns the stream position
    (set_host_rng) and Python-side draws delegate through rng_next, so
    the one counter keeps the stream identical to the reference."""

    __slots__ = ("_k0", "_k1", "_host_id", "_counter", "_engine")

    def __init__(self, seed: int, host_id: int):
        k0, k1 = mix_key(seed, STREAM_HOST)
        self._k0 = k0 ^ (host_id & 0xFFFFFFFF)
        self._k1 = k1 ^ (host_id >> 32)
        self._host_id = host_id
        self._counter = 0
        self._engine = None

    def attach_engine(self, engine) -> None:
        self._engine = engine

    def next_u64(self) -> int:
        if self._engine is not None:
            return self._engine.rng_next(self._host_id)
        b0, b1 = threefry2x32_py(self._k0, self._k1,
                                 self._counter & 0xFFFFFFFF,
                                 self._counter >> 32)
        self._counter += 1
        return (b1 << 32) | b0

    def next_u32(self) -> int:
        return self.next_u64() & 0xFFFFFFFF

    def randrange(self, lo: int, hi: int) -> int:
        """Integer in [lo, hi) (ephemeral ports)."""
        return lo + self.next_u64() % (hi - lo)

    def bytes(self, n: int) -> bytes:
        """n bytes of the stream (getrandom)."""
        out = bytearray()
        while len(out) < n:
            out += self.next_u64().to_bytes(8, "little")
        return bytes(out[:n])
