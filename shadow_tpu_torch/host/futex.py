"""Per-process futex table for managed (real-binary) threads.

Ref: src/main/host/futex_table.rs + src/main/host/futex.c — the host
keeps a table keyed by futex word address; blocked threads park on a
condition attached to the word, FUTEX_WAKE pops waiters in FIFO order
(deterministic: arrival order is event-queue order).  Keys are managed-
process virtual addresses, which is exactly the kernel's key for
process-private futexes; we only support private-equivalent use (all
waiters and wakers inside one managed process), the dominant case for
pthreads/glibc.
"""

from __future__ import annotations

from shadow_tpu_torch.host.condition import ManualCondition


class FutexWaiter:
    __slots__ = ("condition", "bitset", "woken", "addr")

    def __init__(self, addr: int, condition: ManualCondition, bitset: int):
        self.addr = addr
        self.condition = condition
        self.bitset = bitset
        self.woken = False


class FutexTable:
    """addr -> FIFO list of waiters."""

    def __init__(self):
        self._waiters: dict[int, list[FutexWaiter]] = {}

    def add_waiter(self, addr: int, condition: ManualCondition,
                   bitset: int = 0xFFFFFFFF) -> FutexWaiter:
        w = FutexWaiter(addr, condition, bitset)
        self._waiters.setdefault(addr, []).append(w)
        # Timeout/teardown must not leave a dead entry in the FIFO.
        condition.on_disarm = lambda: self.discard(w)
        return w

    def discard(self, waiter: FutexWaiter) -> None:
        lst = self._waiters.get(waiter.addr)
        if lst and waiter in lst:
            lst.remove(waiter)
            if not lst:
                del self._waiters[waiter.addr]

    def wake(self, host, addr: int, count: int,
             bitset: int = 0xFFFFFFFF) -> int:
        """Wake up to `count` waiters whose bitset intersects; returns
        how many were woken."""
        lst = self._waiters.get(addr)
        if not lst:
            return 0
        woken = 0
        for w in list(lst):
            if woken >= count:
                break
            if not (w.bitset & bitset):
                continue
            w.woken = True
            # fire() disarms, which runs on_disarm -> discard(w).
            w.condition.fire(host)
            woken += 1
        return woken

    def requeue(self, host, addr: int, wake_count: int, requeue_limit: int,
                addr2: int) -> tuple[int, int]:
        """Wake `wake_count` waiters of `addr`, move up to
        `requeue_limit` of the remainder onto `addr2`.  Returns (woken,
        requeued) — the caller picks the kernel return convention
        (FUTEX_REQUEUE reports woken only; CMP_REQUEUE woken+requeued,
        futex(2))."""
        woken = self.wake(host, addr, wake_count)
        lst = self._waiters.get(addr)
        moved = 0
        while lst and moved < requeue_limit:
            w = lst.pop(0)
            w.addr = addr2
            self._waiters.setdefault(addr2, []).append(w)
            moved += 1
        if lst is not None and not lst:
            self._waiters.pop(addr, None)
        return woken, moved

    def __len__(self) -> int:
        return sum(len(v) for v in self._waiters.values())
