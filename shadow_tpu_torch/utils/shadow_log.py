"""Sim-time-aware logger: the port's copy of
`shadow_tpu/utils/shadow_log.py`.

Log records carry wall time, level, simulated time and host context.
Records are buffered and flushed in batches (a warning or worse
flushes at once), so logging costs an append, not a write a line.
"""

from __future__ import annotations

import sys
import time as _walltime

_LEVELS = {"error": 0, "warning": 1, "info": 2, "debug": 3, "trace": 4}


def _fmt_sim(ns: int | None) -> str:
    if ns is None:
        return "n/a"
    sec, rem = divmod(ns, 10**9)
    return f"{sec // 3600:02d}:{(sec // 60) % 60:02d}:{sec % 60:02d}." \
           f"{rem:09d}"


class ShadowLogger:
    """Buffered, leveled, sim-time-stamped logging to stderr."""

    def __init__(self, level: str = "info", stream=None,
                 flush_every: int = 64):
        self.level = _LEVELS.get(level, 2)
        self.stream = stream
        self.flush_every = flush_every
        self._buf: list[str] = []
        self._warned: set[str] = set()
        self._t0 = _walltime.monotonic()

    def set_level(self, level: str) -> None:
        self.level = _LEVELS.get(level, 2)

    def enabled(self, level: str) -> bool:
        return _LEVELS.get(level, 2) <= self.level

    def log(self, level: str, msg: str, sim_ns: int | None = None,
            host: str | None = None) -> None:
        lvl = _LEVELS.get(level, 2)
        if lvl > self.level:
            return
        wall = _walltime.monotonic() - self._t0
        ctx = f" [{host}]" if host else ""
        self._buf.append(f"{wall:09.6f} [{level}] {_fmt_sim(sim_ns)}"
                         f"{ctx} {msg}\n")
        if lvl <= _LEVELS["warning"] or len(self._buf) >= self.flush_every:
            self.flush()

    def warn_once(self, key: str, msg: str, sim_ns: int | None = None,
                  host: str | None = None) -> None:
        """One-shot warning: diagnosable without flooding the log."""
        if key in self._warned:
            return
        self._warned.add(key)
        self.log("warning", msg, sim_ns=sim_ns, host=host)

    def error(self, msg: str, **kw) -> None:
        self.log("error", msg, **kw)

    def warning(self, msg: str, **kw) -> None:
        self.log("warning", msg, **kw)

    def info(self, msg: str, **kw) -> None:
        self.log("info", msg, **kw)

    def debug(self, msg: str, **kw) -> None:
        self.log("debug", msg, **kw)

    def flush(self) -> None:
        if self._buf:
            # sys.stderr read at flush time, so a redirected stderr (the
            # tests' capture) receives the lines.
            stream = self.stream if self.stream is not None else sys.stderr
            stream.write("".join(self._buf))
            self._buf.clear()
            stream.flush()


# Process-wide logger; the manager re-levels it from general.log_level.
LOG = ShadowLogger()
