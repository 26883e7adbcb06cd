"""Failure containment for managed processes: the port's copy of
`shadow_tpu/svc/containment.py` with the `abort` policy only (the
`quarantine` and `restart` policies need the Manager's quarantine path,
ROADMAP A7c; the config refuses them).

Wall-side failures of real binaries (a userspace spin that never makes
a syscall, a posix_spawn that loses a race against the kernel's fork
budget) are events the simulation does not own.  This module holds what
turns them into a deterministic outcome:

 - the hang watchdog (`experimental.managed_watchdog`): a managed thread
   that produces no IPC event for that much wall time while its native
   process lives is killed, and the death resolves through the normal
   path at the sim instant its host was serving;
 - the spawn gate (`experimental.managed_spawn_stagger`): successive
   managed spawns keep a wall distance, and a spawn that fails with
   EAGAIN or ENOMEM is retried with a short backoff;
 - the preflight: a fleet that cannot fit the fd table or /dev/shm fails
   before its first spawn, naming the limit to raise.

Under `abort` a failure stays a plugin error of the run.
"""

from __future__ import annotations

import threading
import time as _walltime

# Bounded posix_spawn retry on transient kernel pressure
# (EAGAIN/ENOMEM), wall-side only: 4 attempts over ~70 ms of backoff.
SPAWN_RETRIES = 3
SPAWN_BACKOFF_S = 0.01  # doubles per attempt: 10/20/40 ms


class _SpawnGate:
    """Wall-time spawn stagger: successive managed posix_spawns across
    the whole run keep at least `stagger_ns` of wall distance.  Wall
    only: the simulation's bytes are the same at any stagger."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0.0

    def wait(self, stagger_ns: int) -> None:
        if stagger_ns <= 0:
            return
        with self._lock:
            now = _walltime.monotonic()
            wait_s = self._next - now
            self._next = max(self._next, now) + stagger_ns / 1e9
        if wait_s > 0:
            _walltime.sleep(wait_s)


SPAWN_GATE = _SpawnGate()


class ContainmentPlane:
    """Owned by the Manager when managed processes are configured; hosts
    reach it through `host.containment`.  Thread-safe: triggers fire
    from service-plane workers and scheduler threads."""

    def __init__(self, watchdog_ns: int = 0):
        self.watchdog_ns = int(watchdog_ns)
        # False after the round loop: the end-of-run forced teardown
        # must not engage the watchdog.
        self.active = True

    def ledger(self) -> dict:
        """The fault ledger (`fault-ledger.json`): the replayable
        quarantine ops and every containment event.  `abort` contains
        nothing, so both stay empty."""
        return {"ops": [], "events": []}

    def hang_kill(self, host, thread) -> bool:
        """Watchdog expiry on a managed thread's IPC recv: SIGKILL the
        native process so the recv resolves through the normal death
        path.  Returns True when a kill was issued."""
        import os
        import signal
        process = thread.process
        if not self.active or process.exited or \
                process.native_pid is None:
            return False
        try:
            os.kill(process.native_pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        return True


def preflight_managed(n_processes: int) -> None:
    """Size the fd table and /dev/shm against the configured fleet
    before spawning.  Each managed process costs the manager ~8 fds
    (IPC block, /proc/pid/mem, transfer socketpair, stdio redirect
    files, pidfd) and one ~600 KiB /dev/shm IPC block; failing fast with
    the exact limit to raise beats thousands of spawns followed by
    EMFILE mid-run."""
    import os
    import resource

    problems = []
    fds_needed = 8 * n_processes + 256
    try:
        soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    except (ValueError, OSError):  # pragma: no cover
        soft = None
    if soft is not None and soft < fds_needed:
        problems.append(
            f"fd table: RLIMIT_NOFILE soft limit is {soft} but "
            f"{n_processes} managed processes need ~{fds_needed} "
            f"(raise it: `ulimit -n {fds_needed}` or "
            f"LimitNOFILE in the service unit)")
    # Budget 1 MiB of shared memory a process for headroom.
    shm_needed = n_processes * (1 << 20)
    try:
        st = os.statvfs("/dev/shm")
        shm_free = st.f_bavail * st.f_frsize
    except OSError:  # pragma: no cover
        shm_free = None
    if shm_free is not None and shm_free < shm_needed:
        problems.append(
            f"/dev/shm: {shm_free // (1 << 20)} MiB free but "
            f"{n_processes} managed processes need "
            f"~{shm_needed // (1 << 20)} MiB of IPC blocks")
    if problems:
        raise RuntimeError("managed-fleet resource preflight: "
                           + "; ".join(problems))
