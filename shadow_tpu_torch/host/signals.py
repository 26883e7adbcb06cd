"""Emulated POSIX signals for simulated processes.

Manager-side signal state: per-process action table + pending sets,
per-thread masks.  The reference splits this between the simulator
(src/main/host/syscall/handler/signal.rs, process.rs signal ingest) and
the shim (src/lib/shim/src/signals.rs, which runs emulated handlers
in-process); our split is the same — this module decides *what* is
delivered *when*, and the shim invokes the app's handler function when
the manager sends an EV_SIGNAL event down the IPC channel
(native/shim.c).

Design invariants:
 - signals are delivered only at response points (when the manager is
   about to answer a syscall), which is exactly when the managed thread
   is parked in the channel's recv — delivery is therefore a
   deterministic simulation event, never an async interrupt;
 - a signal raised at a thread blocked in an interruptible syscall
   disarms the condition and converts the pending call into -EINTR (or
   a restart when SA_RESTART applies — handler/mod.rs restart protocol);
 - dispositions follow Linux: uncatchable SIGKILL/SIGSTOP, default
   table below, ignored signals discarded at generation time even when
   blocked.
"""

from __future__ import annotations

# Signal numbers (x86-64)
SIGHUP = 1
SIGINT = 2
SIGQUIT = 3
SIGILL = 4
SIGTRAP = 5
SIGABRT = 6
SIGBUS = 7
SIGFPE = 8
SIGKILL = 9
SIGUSR1 = 10
SIGSEGV = 11
SIGUSR2 = 12
SIGPIPE = 13
SIGALRM = 14
SIGTERM = 15
SIGSTKFLT = 16
SIGCHLD = 17
SIGCONT = 18
SIGSTOP = 19
SIGTSTP = 20
SIGTTIN = 21
SIGTTOU = 22
SIGURG = 23
SIGXCPU = 24
SIGXFSZ = 25
SIGVTALRM = 26
SIGPROF = 27
SIGWINCH = 28
SIGIO = 29
SIGPWR = 30
SIGSYS = 31

NSIG = 64

# siginfo si_code values (asm-generic/siginfo.h) delivered to
# SA_SIGINFO handlers through the shim's EV_SIGNAL args.
SI_USER = 0        # kill(2)
SI_KERNEL = 0x80   # kernel-generated (itimer SIGALRM, ...)
SI_TKILL = -6      # tgkill(2)
CLD_EXITED = 1     # child exited normally
CLD_KILLED = 2     # child terminated by signal

_NAMES = {
    "SIGHUP": SIGHUP, "SIGINT": SIGINT, "SIGQUIT": SIGQUIT,
    "SIGILL": SIGILL, "SIGTRAP": SIGTRAP, "SIGABRT": SIGABRT,
    "SIGBUS": SIGBUS, "SIGFPE": SIGFPE, "SIGKILL": SIGKILL,
    "SIGUSR1": SIGUSR1, "SIGSEGV": SIGSEGV, "SIGUSR2": SIGUSR2,
    "SIGPIPE": SIGPIPE, "SIGALRM": SIGALRM, "SIGTERM": SIGTERM,
    "SIGSTKFLT": SIGSTKFLT, "SIGCHLD": SIGCHLD, "SIGCONT": SIGCONT,
    "SIGSTOP": SIGSTOP, "SIGTSTP": SIGTSTP, "SIGTTIN": SIGTTIN,
    "SIGTTOU": SIGTTOU, "SIGURG": SIGURG, "SIGXCPU": SIGXCPU,
    "SIGXFSZ": SIGXFSZ, "SIGVTALRM": SIGVTALRM, "SIGPROF": SIGPROF,
    "SIGWINCH": SIGWINCH, "SIGIO": SIGIO, "SIGPWR": SIGPWR,
    "SIGSYS": SIGSYS,
}
_NUM_TO_NAME = {num: name for name, num in _NAMES.items()}


def parse_signal(spec) -> int:
    """'SIGTERM' | 'TERM' | 15 -> 15 (config shutdown_signal,
    expected_final_state 'signaled ...')."""
    if isinstance(spec, int):
        return spec
    s = str(spec).strip().upper()
    if s.isdigit():
        return int(s)
    if not s.startswith("SIG"):
        s = "SIG" + s
    if s in _NAMES:
        return _NAMES[s]
    raise ValueError(f"unknown signal {spec!r}")


def signal_name(sig: int) -> str:
    return _NUM_TO_NAME.get(sig, f"SIG{sig}")


def bit(sig: int) -> int:
    return 1 << (sig - 1)


# Default dispositions (man 7 signal).  Stop/continue job control IS
# modeled at the process level (stopped processes consume no events
# until SIGCONT; wait4 reports via WUNTRACED/WCONTINUED); there is no
# controlling terminal, so SIGTTIN/SIGTTOU only arrive via explicit
# kill.  SIGCONT's continue side-effect fires at raise time regardless
# of disposition (kernel semantics), so its default action here is
# "ignore".
_DEFAULT_IGNORE = frozenset({SIGCHLD, SIGURG, SIGWINCH, SIGCONT})
_STOP_SIGNALS = frozenset({SIGSTOP, SIGTSTP, SIGTTIN, SIGTTOU})

# SIGCHLD si_code values for job control (uapi/asm-generic/siginfo.h;
# CLD_EXITED/CLD_KILLED live with the other si_code constants above).
CLD_STOPPED, CLD_CONTINUED = 5, 6
SA_NOCLDSTOP = 0x00000001

# Hardware-fault signals: the app's sigaction is additionally installed
# natively so a *real* fault in managed code (e.g. a GC's intentional
# SIGSEGV) reaches the app's handler without a round trip.  Emulated
# kill() delivery for these still goes through the normal path.
FAULT_SIGNALS = frozenset({SIGSEGV, SIGBUS, SIGFPE, SIGILL, SIGTRAP})

# sigaction flags (uapi/asm/signal.h)
SA_SIGINFO = 0x00000004
SA_RESTORER = 0x04000000
SA_ONSTACK = 0x08000000
SA_RESTART = 0x10000000
SA_NODEFER = 0x40000000
SA_RESETHAND = 0x80000000

SIG_DFL = 0
SIG_IGN = 1

# Syscalls re-run after a handler when SA_RESTART is set (Linux restarts
# these for slow devices; everything else returns EINTR).  Names are
# from the syscalls_native SYS table.
RESTARTABLE = frozenset({
    "read", "write", "readv", "writev", "recvfrom", "sendto", "recvmsg",
    "sendmsg", "accept", "accept4", "connect", "wait4", "waitid",
    "futex", "flock",
})


class SigAction:
    __slots__ = ("handler", "flags", "restorer", "mask")

    def __init__(self, handler: int = SIG_DFL, flags: int = 0,
                 restorer: int = 0, mask: int = 0):
        self.handler = handler
        self.flags = flags
        self.restorer = restorer
        self.mask = mask


class ProcessSignals:
    """Per-process emulated signal state (actions are process-wide,
    masks are per-thread and live on the thread objects)."""

    __slots__ = ("actions", "pending_process", "info")

    def __init__(self):
        self.actions: dict[int, SigAction] = {}
        self.pending_process: set[int] = set()
        # Per-pending-signal siginfo: sig -> (si_code, si_pid, si_status).
        # Standard (non-RT) signals carry one instance, like the kernel.
        self.info: dict[int, tuple] = {}

    def action(self, sig: int) -> SigAction:
        act = self.actions.get(sig)
        return act if act is not None else SigAction()

    def clone(self) -> "ProcessSignals":
        """fork: child inherits the action table, not the pending set."""
        child = ProcessSignals()
        child.actions = {
            s: SigAction(a.handler, a.flags, a.restorer, a.mask)
            for s, a in self.actions.items()}
        return child

    def disposition(self, sig: int) -> str:
        """'handler' | 'ignore' | 'terminate' | 'stop'."""
        if sig == SIGKILL:
            return "terminate"
        if sig == SIGSTOP:
            return "stop"  # uncatchable, unblockable
        act = self.actions.get(sig)
        if act is None or act.handler == SIG_DFL:
            if sig in _STOP_SIGNALS:
                return "stop"
            return "ignore" if sig in _DEFAULT_IGNORE else "terminate"
        if act.handler == SIG_IGN:
            return "ignore"
        return "handler"

    # -- pending bookkeeping -----------------------------------------

    def take_deliverable(self, thread) -> int | None:
        """Lowest-numbered pending signal not blocked by `thread`'s
        mask, removed from its pending set (Linux delivers standard
        signals lowest-first — a stable deterministic order)."""
        mask = getattr(thread, "sig_mask", 0)
        candidates = [s for s in getattr(thread, "sig_pending", ())
                      if not (mask & bit(s))]
        candidates += [s for s in self.pending_process
                       if not (mask & bit(s))]
        if not candidates:
            return None
        sig = min(candidates)
        thread.sig_pending.discard(sig)
        self.pending_process.discard(sig)
        return sig

    def take_info(self, sig: int) -> tuple:
        """Pop the queued siginfo for `sig`: (si_code, si_pid, si_status)."""
        return self.info.pop(sig, (0, 0, 0))

    def has_deliverable(self, thread) -> bool:
        mask = getattr(thread, "sig_mask", 0)
        return any(not (mask & bit(s))
                   for s in getattr(thread, "sig_pending", ())) or \
            any(not (mask & bit(s)) for s in self.pending_process)

    def pending_mask(self, thread) -> int:
        m = 0
        for s in getattr(thread, "sig_pending", ()):
            m |= bit(s)
        for s in self.pending_process:
            m |= bit(s)
        return m
