"""Syscall service plane: host-affine servicing of managed hosts, the
port's copy of `shadow_tpu/svc/plane.py`.

Under the serial per-host walk, while host A's native process computes
between syscalls every other managed host waits its turn: one futex
wait, dispatch and resume round trip a syscall.  This plane lifts
managed-host servicing out of that walk into a host-affine worker pool.

Determinism argument:

- A conservative round's hosts are independent by construction: the
  window is narrower than the least cross-host latency, so nothing one
  host does inside the window can reach another host inside it.
  Executing them concurrently is what the thread_per_core scheduler
  already does.
- Per-host event order is untouched: each host's whole
  ``execute(until)`` runs as one unit on one worker group (hosts are
  assigned by ``host.id % workers``, stable for the run).
- Cross-host effects go through the propagator's ``send`` and the
  destination inbox, both thread-safe (the Manager arms the scalar
  propagator's threaded mode whenever this plane is active).

The wall win: workers blocked in the IPC futex recv release the GIL, so
N managed hosts' round trips overlap instead of serializing; the plane
advertises itself to the shim through the IPC block's svc_flags word
(the shim then spins briefly for fast answers before it parks).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor


class SyscallServicePlane:
    """Host-affine worker pool draining managed hosts' due servicing
    work each conservative round.

    ``dispatch(hosts, until)`` partitions the round's due managed
    hosts into ``workers`` affinity groups (``host.id % workers``,
    each group in ascending host id) and returns a join callable; the
    manager runs the rest of the round's hosts while the groups drain,
    then joins before the propagation barrier."""

    def __init__(self, workers: int):
        assert workers >= 1
        self.workers = workers
        self._pool = ThreadPoolExecutor(
            max_workers=workers,
            thread_name_prefix="svc-worker")
        # Wall-side telemetry for metrics.wall.svc.
        self.rounds = 0          # rounds with >= 1 managed host due
        self.hosts_serviced = 0  # host-rounds drained by the pool

    @staticmethod
    def _run_group(group, until: int) -> None:
        for h in group:
            h.execute(until)

    def dispatch(self, hosts, until: int):
        """Start draining `hosts` (due managed hosts, ascending id);
        returns a 0-arg join callable that re-raises the first worker
        exception.  An empty host list returns a no-op join."""
        if not hosts:
            return lambda: None
        self.rounds += 1
        self.hosts_serviced += len(hosts)
        n = self.workers
        groups = [[] for _ in range(n)]
        for h in hosts:  # ascending id in, ascending id per group out
            groups[h.id % n].append(h)
        futures = [self._pool.submit(self._run_group, g, until)
                   for g in groups if g]

        def join():
            for f in futures:
                f.result()  # re-raise worker exceptions in round order
        return join

    def wall_summary(self) -> dict:
        """The metrics.wall.svc block."""
        return {"workers": self.workers, "rounds": self.rounds,
                "hosts_serviced": self.hosts_serviced}

    def shutdown(self) -> None:
        self._pool.shutdown()
