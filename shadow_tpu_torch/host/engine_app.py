"""Engine-resident applications (the port's copy of
`shadow_tpu/host/engine_app.py`: the tgen TCP apps and the UDP/PHOLD
apps, with default-disposition signal delivery).

The apps have C++ twins inside the engine (netplane.cpp AppN): the
same socket-operation sequence at the same instants, so the whole
app/syscall/network path stays in C++ with a byte-identical packet
trace.  This module holds the spawn-argument mapping and the
bookkeeping proxy the Manager keeps in `host.processes`.
"""

from __future__ import annotations

import struct

from shadow_tpu_torch.host.process import matches_final_state

# (config path, argv shape) -> engine app kind (netplane.cpp twins)
KIND_SERVER = 0
KIND_CLIENT = 1
KIND_UDP_FLOOD = 3
KIND_UDP_SINK = 4
KIND_UDP_MESH = 5
KIND_PHOLD = 7
KIND_UDP_ECHO = 9
KIND_UDP_PING = 10


class _EngineFdView:
    """The fd-table face of an engine app for the Manager's teardown
    sweep: `close_all` on a still-running app closes its engine sockets
    like the object path's fd table (FINs for mid-stream connections,
    traced at the host's current instant)."""

    __slots__ = ("_proc",)

    def __init__(self, proc):
        self._proc = proc

    def close_all(self, host) -> None:
        p = self._proc
        if p.app_idx is not None and not p.exited:
            host.plane.engine.app_teardown(p.app_idx, host.now())

    def __len__(self) -> int:
        return 0


class _AppThreadView:
    """The thread-table entry kill/tgkill addressing reads (tid and
    liveness), polling the engine app that backs the thread."""

    __slots__ = ("tid", "_proc", "_app_idx")

    def __init__(self, tid: int, proc, app_idx: int):
        self.tid = tid
        self._proc = proc
        self._app_idx = app_idx

    @property
    def state(self):
        from shadow_tpu_torch.host.process import ST_EXITED, ST_RUNNABLE
        exited, _c, _t = self._proc.host.plane.engine.app_status(
            self._app_idx)
        return ST_EXITED if exited else ST_RUNNABLE


class EngineAppProcess:
    """A process backed by an engine-resident app: exit state is polled
    from the engine, never mirrored."""

    def __init__(self, host, name: str, expected_final_state: str):
        self.host = host
        self.name = name
        self.pid = host.register_process(self)
        self.expected_final_state = expected_final_state
        self.app_idx: int | None = None   # set right after app_spawn
        self.term_signal = None
        self.stderr = bytearray()  # the engine apps write none
        self.fds = _EngineFdView(self)
        # The Process attributes host-wide machinery (kill addressing,
        # wait4 scans over host.processes) reads on every process.
        self.parent_pid: int | None = None
        self.pgid = self.pid
        self.sid = self.pid
        self.zombies: list = []
        self.stop_report: int | None = None
        self.continue_report = False
        self._stopped = False
        self._shielded: list[tuple] = []

    @property
    def threads(self) -> tuple:
        """The engine enumerates the process's app threads in spawn
        order (main, accepted handlers, then the mesh sender), so tgkill
        addressing matches the Python twin's tid numbering."""
        if self.app_idx is None:
            return ()
        idxs = self.host.plane.engine.app_threads(self.app_idx)
        return tuple(_AppThreadView(self.pid + i, self, idx)
                     for i, idx in enumerate(idxs))

    def _status(self):
        return self.host.plane.engine.app_status(self.app_idx)

    @property
    def exited(self) -> bool:
        return bool(self._status()[0])

    @property
    def exit_code(self):
        exited, code, _t = self._status()
        return code if exited else None

    @property
    def stdout(self) -> bytearray:
        """The exact bytes the app wrote (the engine builds them as it
        goes; the udp-mesh apps write ordered lines)."""
        _e, _c, _t, out = self.host.plane.engine.app_poll(self.app_idx)
        return bytearray(out)

    @property
    def stopped(self) -> bool:
        return self._stopped

    def raise_signal(self, host, sig: int, target_tid=None,
                     si_code: int = 0, si_pid: int = 0,
                     si_status: int = 0) -> None:
        """Engine apps install no handlers: apply the default action
        (terminate, stop, continue or ignore).  A stop shields the
        non-KILL fatal signals until the continue, as
        Process.raise_signal does."""
        from shadow_tpu_torch.host import signals as sigmod
        if self.exited or sig <= 0 or sig >= sigmod.NSIG:
            return
        eng = self.host.plane.engine
        if sig == sigmod.SIGCONT:
            if self._stopped:
                self._stopped = False
                self.stop_report = None
                self.continue_report = True
                eng.app_continue(self.app_idx, host.now())
                shielded, self._shielded = self._shielded, []
                for s, ttid, scode, spid, sstatus in shielded:
                    self.raise_signal(host, s, ttid, scode, spid, sstatus)
            return
        disp = sigmod.ProcessSignals().disposition(sig)
        if sig == sigmod.SIGKILL:
            self.term_signal = sig
            eng.app_kill(self.app_idx, sig, host.now())
            return
        if self._stopped:
            if disp not in ("ignore", "stop"):
                self._shielded.append(
                    (sig, target_tid, si_code, si_pid, si_status))
            return
        if disp == "stop":
            self._stopped = True
            self.stop_report = sig
            self.continue_report = False
            eng.app_stop(self.app_idx)
            return
        if disp != "terminate":
            return
        self.term_signal = sig
        eng.app_kill(self.app_idx, sig, host.now())

    def matches_expected_final_state(self) -> bool:
        exited, code, _t = self._status()
        return matches_final_state(self.expected_final_state, exited,
                                   code if exited else None,
                                   self.term_signal)


# Engine-runnable app -> the (least, most) argv length its engine twin
# takes (None: no upper bound).  Any other shape runs as an object-path
# app in the reference.
ENGINE_ARGC = {"tgen-server": (1, 1), "tgen-client": (3, 4),
               "udp-flood": (4, 5), "udp-sink": (1, 2),
               "udp-mesh": (4, None), "udp-echo-server": (1, 1),
               "udp-pinger": (3, 3), "phold": (5, None)}


def argv_fits(path: str, args: list) -> bool:
    """Whether `path` with `args` is an engine-runnable app's shape."""
    argc = ENGINE_ARGC.get(path)
    return argc is not None and argc[0] <= len(args) \
        and (argc[1] is None or len(args) <= argc[1])


def engine_app_args(pcfg, dns):
    """(kind, a, b, c, d, e[, peers]) for engine.app_spawn, or None when
    `pcfg` is not an engine-runnable app.  `peers` is the u32 IP buffer
    of the apps that take a peer list."""
    path, args = pcfg.path, list(pcfg.args)
    if not argv_fits(path, args):
        return None
    if path == "tgen-server":
        return (KIND_SERVER, int(args[0]), 0, 0, 0, 0)
    if path == "udp-sink":
        expect = int(args[1]) if len(args) > 1 else 0
        has_expect = 1 if len(args) > 1 else 0
        return (KIND_UDP_SINK, int(args[0]), expect, has_expect, 0, 0)
    if path == "udp-echo-server":
        return (KIND_UDP_ECHO, int(args[0]), 0, 0, 0, 0)
    if path in ("udp-mesh", "phold"):
        # udp-mesh <port> <count> <size> <peer...>
        # phold <port> <my_index> <n_init> <mean_delay_ns> <peer...>
        n = 3 if path == "udp-mesh" else 4
        peers = _pack_peers(dns, args[n:])
        if peers is None:
            return None
        kind = KIND_UDP_MESH if path == "udp-mesh" else KIND_PHOLD
        return (kind, *(int(a) for a in args[:n]), *(0,) * (5 - n), peers)
    # the apps addressing one peer by name: tgen-client, udp-flood,
    # udp-pinger
    ip = dns.ip_for_name(args[0])
    if ip is None:
        return None
    if path == "tgen-client":
        count = int(args[3]) if len(args) > 3 else 1
        return (KIND_CLIENT, ip, int(args[1]), int(args[2]), count, 0)
    if path == "udp-flood":
        interval = int(args[4]) if len(args) > 4 else 0
        return (KIND_UDP_FLOOD, ip, int(args[1]), int(args[2]),
                int(args[3]), interval)
    return (KIND_UDP_PING, ip, int(args[1]), int(args[2]), 0, 0)


def _pack_peers(dns, names):
    """Resolve peer names into the u32 IP buffer app_spawn takes; None
    when any name is unresolvable."""
    ips = [dns.ip_for_name(peer) for peer in names]
    if None in ips:
        return None
    return b"".join(struct.pack("<I", ip) for ip in ips)
