"""Token-bucket rate limiting (ref: src/main/network/relay/token_bucket.rs).

Discrete, integer-ns refills: the bucket refills `refill_size` bytes every
`refill_interval_ns`, capped at `capacity`. Integer arithmetic everywhere —
the conforming-time computation must be identical on every scheduler for
byte-identical traces.

The port's copy of `shadow_tpu/net/token_bucket.py`.
"""

from __future__ import annotations

REFILL_INTERVAL_NS = 1_000_000  # 1 ms, like the reference's relay config


class TokenBucket:
    __slots__ = ("capacity", "refill_size", "refill_interval_ns",
                 "_balance", "_next_refill_time")

    def __init__(self, capacity: int, refill_size: int,
                 refill_interval_ns: int = REFILL_INTERVAL_NS):
        assert capacity > 0 and refill_size > 0
        self.capacity = capacity
        self.refill_size = refill_size
        self.refill_interval_ns = refill_interval_ns
        self._balance = capacity
        self._next_refill_time = 0  # lazily anchored at first use

    @classmethod
    def for_bandwidth(cls, bits_per_sec: int, mtu: int) -> "TokenBucket":
        """Bucket for a link rate: 1ms worth of bytes per refill, with at
        least one MTU of burst so any single packet can always conform
        (relay/mod.rs:278-318)."""
        bytes_per_refill = (bits_per_sec * REFILL_INTERVAL_NS) // (8 * 10**9)
        refill = max(bytes_per_refill, 1)
        return cls(capacity=max(refill, mtu), refill_size=refill)

    def _advance(self, now: int) -> None:
        if self._next_refill_time == 0:
            self._next_refill_time = now + self.refill_interval_ns
            return
        if now >= self._next_refill_time:
            intervals = 1 + (now - self._next_refill_time) // self.refill_interval_ns
            self._balance = min(self.capacity,
                                self._balance + intervals * self.refill_size)
            self._next_refill_time += intervals * self.refill_interval_ns

    def try_remove(self, size: int, now: int):
        """Returns (True, 0) on success or (False, next_refill_time)."""
        self._advance(now)
        if size <= self._balance:
            self._balance -= size
            return True, 0
        return False, self._next_refill_time

    def balance_at(self, now: int) -> int:
        self._advance(now)
        return self._balance

    def peek_balance(self, now: int) -> int:
        """Read-only balance at `now`: the value _advance(now) WOULD
        leave, without mutating.  The fabric observatory samples
        through this — sampling a virgin bucket must not anchor its
        refill clock (the sim must be byte-identical with the channel
        on or off).  Twins: netplane.cpp TokenBucketN::peek_balance
        and the device kernels' bucket_peek."""
        if self._next_refill_time == 0 or now < self._next_refill_time:
            return self._balance
        intervals = 1 + (now - self._next_refill_time) \
            // self.refill_interval_ns
        return min(self.capacity,
                   self._balance + intervals * self.refill_size)
