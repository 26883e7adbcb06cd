"""Engine-resident tgen applications (the port's copy of
`shadow_tpu/host/engine_app.py`, cut to tgen-server and tgen-client).

The tgen apps have C++ twins inside the engine (netplane.cpp AppN):
the same socket-operation sequence at the same instants, so the whole
app/syscall/TCP path stays in C++ with a byte-identical packet trace.
This module holds the spawn-argument mapping and the bookkeeping proxy
the Manager keeps in `host.processes`.
"""

from __future__ import annotations

# (config path, argv shape) -> engine app kind (netplane.cpp twins)
KIND_SERVER = 0
KIND_CLIENT = 1


class EngineAppProcess:
    """A process backed by an engine-resident app: exit state is polled
    from the engine, never mirrored."""

    def __init__(self, host, name: str, expected_final_state: str):
        self.host = host
        self.name = name
        self.pid = host.register_process(self)
        self.expected_final_state = expected_final_state
        self.app_idx: int | None = None   # set right after app_spawn

    def _status(self):
        return self.host.plane.engine.app_status(self.app_idx)

    @property
    def exited(self) -> bool:
        return bool(self._status()[0])

    @property
    def exit_code(self):
        exited, code, _t = self._status()
        return code if exited else None

    def close_all(self) -> None:
        """The teardown sweep: a still-running app's engine sockets close
        like the object path's fd table (FINs for mid-stream
        connections, traced at the host's current instant)."""
        if self.app_idx is not None and not self.exited:
            self.host.plane.engine.app_teardown(self.app_idx,
                                                self.host.now())

    def matches_expected_final_state(self) -> bool:
        """Engine apps take no signals in this slice (config refuses
        shutdown_time), so the terminating signal is always None."""
        exited, code, _t = self._status()
        expected = self.expected_final_state
        if expected in ("running", "any"):
            return expected == "any" or not exited
        parts = expected.split()
        want = int(parts[1]) if len(parts) > 1 else 0
        return bool(exited) and code == want


def engine_app_args(pcfg, dns):
    """(kind, a, b, c, d, e) for engine.app_spawn, or None when `pcfg`
    is not an engine-runnable tgen app."""
    args = list(pcfg.args)
    if pcfg.path == "tgen-server":
        if len(args) != 1:
            return None
        return (KIND_SERVER, int(args[0]), 0, 0, 0, 0)
    if pcfg.path == "tgen-client":
        if len(args) not in (3, 4):
            return None
        ip = dns.ip_for_name(args[0])
        if ip is None:
            return None
        count = int(args[3]) if len(args) > 3 else 1
        return (KIND_CLIENT, ip, int(args[1]), int(args[2]), count, 0)
    return None
