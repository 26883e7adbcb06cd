"""Native-child death watcher (ref: src/main/utility/childpid_watcher.rs).

One daemon thread blocks in waitid(P_ALL, WEXITED|WNOWAIT); when a
managed process dies it marks that process's IPC block CLOSED, which
futex-wakes any manager thread parked in the channel recv — the same
close-channel-on-death contract the reference implements with
pidfd+epoll.  This replaces 100ms wall-clock polling slices in every
blocked channel wait (a scheduler tax and flakiness source at scale);
the poll remains only as a long-interval safety net.

WNOWAIT leaves the zombie in place: the owning ManagedThread still
reaps it with waitpid and sees the real status.
"""

from __future__ import annotations

import os
import threading
import time


class ChildWatcher:
    def __init__(self):
        self._lock = threading.Lock()
        self._blocks: dict[int, object] = {}   # native_pid -> IpcBlock
        self._notified: set[int] = set()
        self._thread: threading.Thread | None = None

    def register(self, pid: int, block) -> None:
        with self._lock:
            self._blocks[pid] = block
            self._notified.discard(pid)
        self._ensure_thread()

    def unregister(self, pid: int | None) -> None:
        """MUST be called (by the owning manager thread) before the
        block is closed/unmapped: mark_closed runs under the same lock,
        so after unregister returns the watcher can no longer touch the
        block."""
        if pid is None:
            return
        with self._lock:
            self._blocks.pop(pid, None)
            self._notified.discard(pid)

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            t = threading.Thread(target=self._run, name="child-watcher",
                                 daemon=True)
            self._thread = t
        t.start()

    def _notify(self, pid: int) -> bool:
        """Mark `pid` dead and close its block (idempotent).  Returns
        True if this was the first notification."""
        with self._lock:
            if pid in self._notified:
                return False
            self._notified.add(pid)
            block = self._blocks.get(pid)
            if block is not None:
                # Wake the parked channel recv; the ManagedThread sees
                # ChannelClosed and reaps.  Under the lock so an
                # unregister+close cannot race the write.
                block.mark_closed()
        return True

    def _scan_registered(self) -> None:
        """waitid(P_ALL) can keep returning one unreaped zombie;
        per-pid WNOHANG probes keep other deaths from being starved
        behind it."""
        with self._lock:
            pids = [p for p in self._blocks if p not in self._notified]
        for pid in pids:
            try:
                info = os.waitid(os.P_PID, pid,
                                 os.WEXITED | os.WNOWAIT | os.WNOHANG)
            except (ChildProcessError, InterruptedError):
                continue  # reaped already; unregister follows shortly
            if info is not None and info.si_pid == pid:
                self._notify(pid)

    def _run(self) -> None:
        while True:
            try:
                info = os.waitid(os.P_ALL, 0, os.WEXITED | os.WNOWAIT)
            except ChildProcessError:
                time.sleep(0.05)  # no children right now
                continue
            except InterruptedError:
                continue
            if info is None:
                continue
            if not self._notify(info.si_pid):
                # An already-notified zombie awaiting its reap; make
                # sure it cannot shadow other deaths, then back off.
                self._scan_registered()
                time.sleep(0.02)


WATCHER = ChildWatcher()
