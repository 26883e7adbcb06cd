"""Processes and threads: the port's copy of `shadow_tpu/host/process.py`
(without strace and the checkpoint transcript: ROADMAP A7b-2 and A7c).

Internal (Python-coroutine) apps and managed processes (host/managed.py)
share this Process: pid, fd table, signals, fork/wait bookkeeping, job
control and the final-state match.  An internal app is a generator that
yields syscall tuples and receives results; a Thread drives it: dispatch
the syscall, continue on done, park on block, and re-run the same
syscall after the condition fires (the restart protocol).
"""

from __future__ import annotations


ST_RUNNABLE = 0
ST_BLOCKED = 1
ST_EXITED = 2


class ProcessExit(Exception):
    def __init__(self, code: int = 0):
        super().__init__(f"exit({code})")
        self.code = code


class Thread:
    def __init__(self, process, gen, tid: int):
        self.process = process
        self.gen = gen
        self.tid = tid
        self.state = ST_RUNNABLE
        self._started = False
        self._pending_call = None   # syscall to re-run after unblock
        self._pending_send = None   # result to feed into the generator
        self._pending_throw = None  # OSError to raise into the generator
        self.last_condition = None
        self.sig_mask = 0
        self.sig_pending: set[int] = set()

    def resume(self, host) -> None:
        """Drive the app generator until it blocks or exits
        (managed_thread.rs:190-333 event loop)."""
        if self.state == ST_EXITED:
            return
        if self.process.stopped:
            # Job control: the process is stopped — park this resume
            # until SIGCONT flushes it.
            self.process._stopped_resumes.append(self.resume)
            return
        self.state = ST_RUNNABLE
        process = self.process
        while True:
            if self._pending_call is not None:
                call, restarted = self._pending_call, True
                self._pending_call = None
            else:
                try:
                    if self._pending_throw is not None:
                        exc, self._pending_throw = self._pending_throw, None
                        call = self.gen.throw(exc)
                    elif not self._started:
                        self._started = True
                        call = next(self.gen)
                    else:
                        call, self._pending_send = (
                            self.gen.send(self._pending_send), None)
                except StopIteration as si:
                    self._exit(host, si.value if isinstance(si.value, int) else 0)
                    return
                except ProcessExit as pe:
                    self._exit(host, pe.code)
                    return
                except Exception as e:
                    # The app let an error escape (syscall OSError or its
                    # own bug): that crashes the *process*, never the
                    # simulation — like a native segfault under the
                    # reference (plugin error, run continues).
                    import traceback
                    self._crash(host, "".join(traceback.format_exception(e)))
                    return
                restarted = False
            if not isinstance(call, tuple) or not call:
                self._crash(host, f"app yielded non-syscall {call!r}")
                return
            result = host.syscall_handler.dispatch(host, process, self, call,
                                                   restarted)
            host.count_syscall(call[0])
            kind = result[0]
            if kind == "done":
                self._pending_send = result[1]
            elif kind == "exit":
                self._exit(host, result[1])
                return
            elif kind == "error":
                self._pending_throw = result[1]
            elif kind == "block":
                condition = result[1]
                self._pending_call = call
                self.last_condition = condition
                self.state = ST_BLOCKED
                condition.arm(host, self._wakeup)
                return
            else:  # pragma: no cover
                raise AssertionError(f"bad dispatch result {result!r}")

    def _wakeup(self, host) -> None:
        if self.state == ST_BLOCKED:
            self.resume(host)

    def _crash(self, host, why: str) -> None:
        self.process.stderr += f"[shadow-tpu] thread crash: {why}\n".encode()
        self._exit(host, 101)

    def _exit(self, host, code: int) -> None:
        if self.state == ST_EXITED:
            return
        self.state = ST_EXITED
        if self.last_condition is not None:
            self.last_condition.disarm()
        self.gen.close()
        self.process.thread_exited(host, self, code)


class Process:
    def __init__(self, host, name: str, argv: list[str],
                 env: dict[str, str], expected_final_state="exited 0"):
        self.host = host
        self.name = name
        self.argv = argv
        self.env = env
        self.pid = host.register_process(self)
        self.threads: list[Thread] = []
        self._next_tid = self.pid
        self.exited = False
        self.exit_code: int | None = None
        self.term_signal: int | None = None  # fatal emulated signal
        from shadow_tpu_torch.host.signals import ProcessSignals
        self.signals = ProcessSignals()
        # fork/wait bookkeeping (ref: process.rs zombies & reaping)
        self.parent_pid: int | None = None
        self.zombies: list[int] = []      # exited, unreaped child pids
        self._wait_conds: list = []       # parked wait4 conditions
        # Job control: top-level processes lead their own group/session;
        # fork children inherit the parent's (managed.py _do_fork).
        self.pgid = self.pid
        self.sid = self.pid
        # Stop/continue state (ref: process.rs stop/continue handling):
        # a stopped process consumes no events — thread resumes defer
        # into _stopped_resumes until SIGCONT flushes them.  stop_report
        # / continue_report feed wait4's WUNTRACED/WCONTINUED exactly
        # once per transition.
        self.stopped = False
        self._stopped_resumes: list = []
        self.stop_report: int | None = None
        self.continue_report = False
        # Signals (other than KILL/CONT) raised while stopped: Linux
        # keeps them pending until the continue — the stop shields even
        # fatal defaults (signal.c: only SIGKILL/SIGCONT wake a stopped
        # task).
        self._stopped_sigs: list = []
        self.signal_fds: list = []  # signalfd(2) watchers
        self._nonzero_exit: int | None = None  # first failing thread wins
        self.stdout = bytearray()
        self.stderr = bytearray()
        self.expected_final_state = expected_final_state
        self.fds = host_descriptor_table()

    def spawn_thread(self, host, gen) -> Thread:
        t = Thread(self, gen, self._next_tid)
        self._next_tid += 1
        self.threads.append(t)
        return t

    def start(self, host, gen) -> None:
        """Create the main thread and run it now (process.rs:944 spawn)."""
        t = self.spawn_thread(host, gen)
        t.resume(host)

    def thread_exited(self, host, thread, code: int) -> None:
        if code != 0 and self._nonzero_exit is None:
            self._nonzero_exit = code
        if all(t.state == ST_EXITED for t in self.threads):
            # A crashed helper thread must not be masked by a clean main
            # thread: any nonzero thread exit becomes the process code.
            self.exited = True
            self.exit_code = (self._nonzero_exit
                              if self._nonzero_exit is not None else code)
            self.fds.close_all(host)
            low = getattr(self, "fds_low", None)
            if low is not None:
                low.close_all(host)
            if self.parent_pid is not None:
                parent = host.processes.get(self.parent_pid)
                if parent is not None and not parent.exited:
                    parent.child_exited(host, self)

    def refresh_signal_fds(self, host) -> None:
        """Re-evaluate level-triggered signalfd readiness after any
        pending-set mutation (single invariant point)."""
        for sfd in self.signal_fds:
            sfd.refresh(host)

    def child_exited(self, host, child) -> None:
        """A child became a zombie: wake parked wait4()s, raise SIGCHLD
        (default-ignored unless the app installed a handler)."""
        self.zombies.append(child.pid)
        waiters, self._wait_conds = self._wait_conds, []
        for cond in waiters:
            cond.fire(host)
        from shadow_tpu_torch.host.signals import (CLD_EXITED, CLD_KILLED,
                                             SIGCHLD)
        if child.term_signal is not None:
            code, status = CLD_KILLED, child.term_signal
        else:
            code, status = CLD_EXITED, child.exit_code or 0
        self.raise_signal(host, SIGCHLD, si_code=code, si_pid=child.pid,
                          si_status=status)

    # -- job control (ref: process.rs stop/continue handling) ---------

    def stop_process(self, host, sig: int) -> None:
        """SIGSTOP/SIGTSTP default action: freeze — subsequent thread
        resumes defer until SIGCONT; the parent is notified (SIGCHLD
        CLD_STOPPED unless SA_NOCLDSTOP) and parked wait4s re-check."""
        if self.exited or self.stopped:
            return
        self.stopped = True
        self.stop_report = sig
        self.continue_report = False
        # kernel prepare_signal(): generating a stop signal discards
        # pending SIGCONT.
        from shadow_tpu_torch.host.signals import CLD_STOPPED, SIGCONT
        self.signals.pending_process.discard(SIGCONT)
        for t in self.threads:
            getattr(t, "sig_pending", set()).discard(SIGCONT)
        self._notify_parent_jobctl(host, CLD_STOPPED, sig)

    def continue_process(self, host) -> None:
        """SIGCONT side-effect (fires at raise time regardless of the
        signal's disposition, like the kernel): flush every deferred
        resume back onto the event queue."""
        if self.exited or not self.stopped:
            return
        self.stopped = False
        self.stop_report = None
        self.continue_report = True
        # kernel prepare_signal(): SIGCONT discards pending stop sigs.
        from shadow_tpu_torch.host.signals import (_STOP_SIGNALS, CLD_CONTINUED,
                                             SIGCONT)
        self.signals.pending_process.difference_update(_STOP_SIGNALS)
        for t in self.threads:
            getattr(t, "sig_pending", set()).difference_update(
                _STOP_SIGNALS)
        resumes, self._stopped_resumes = self._stopped_resumes, []
        from shadow_tpu_torch.core.event import TaskRef
        for r in resumes:
            host.schedule_task_at(
                host.now(), TaskRef("sigcont-resume",
                                    lambda h, _r=r: _r(h)))
        self._notify_parent_jobctl(host, CLD_CONTINUED, SIGCONT)
        # Signals the stop shielded are re-raised now, in raise order,
        # through the full raise path (thread targeting, blocked
        # queueing, condition interrupts all re-run).
        shielded, self._stopped_sigs = self._stopped_sigs, []
        for sig, tid, code, pid, status in shielded:
            self.raise_signal(host, sig, target_tid=tid, si_code=code,
                              si_pid=pid, si_status=status)

    def _notify_parent_jobctl(self, host, code: int, sig: int) -> None:
        from shadow_tpu_torch.host.signals import (SA_NOCLDSTOP, SIGCHLD)
        parent = host.processes.get(self.parent_pid) \
            if self.parent_pid is not None else None
        if parent is None or parent.exited:
            return
        waiters, parent._wait_conds = parent._wait_conds, []
        for cond in waiters:
            cond.fire(host)
        act = parent.signals.action(SIGCHLD)
        if not (act.flags & SA_NOCLDSTOP):
            parent.raise_signal(host, SIGCHLD, si_code=code,
                                si_pid=self.pid, si_status=sig)

    def raise_signal(self, host, sig: int, target_tid=None,
                     si_code: int = 0, si_pid: int = 0,
                     si_status: int = 0) -> None:
        """Internal (Python) apps have no handler mechanism: non-ignored
        signals apply the default action — terminate, stop, or continue
        (man 7 signal).  ManagedProcess overrides this with full
        handler delivery."""
        from shadow_tpu_torch.host.signals import NSIG, SIGCONT, SIGKILL
        if self.exited or sig <= 0 or sig >= NSIG:
            return
        if sig == SIGCONT:
            self.continue_process(host)
            return  # default SIGCONT action beyond the continue: ignore
        disp = self.signals.disposition(sig)
        if self.stopped and sig != SIGKILL:
            # The stop shields everything but KILL/CONT until the
            # continue (signal.c: stopped tasks don't wake for them).
            if disp not in ("ignore", "stop"):
                self._stopped_sigs.append((sig, target_tid, si_code,
                                           si_pid, si_status))
            return
        if disp == "ignore":
            return
        if disp == "stop":
            self.stop_process(host, sig)
            return
        self.term_signal = sig
        for t in list(self.threads):
            t._exit(host, 128 + sig)

    def matches_expected_final_state(self) -> bool:
        return matches_final_state(self.expected_final_state,
                                   self.exited, self.exit_code,
                                   self.term_signal)


def matches_final_state(expected, exited: bool, exit_code,
                        term_signal) -> bool:
    """The ONE expected_final_state matcher, shared by Process and
    EngineAppProcess so serial and engine backends can never disagree
    on run success.  Unknown shapes are rejected at config parse
    (core/config._validate_final_state); the permissive True fallback
    here only covers non-config constructions."""
    if expected in ("running", "any"):
        return expected == "any" or not exited
    if isinstance(expected, str) and expected.startswith("exited"):
        parts = expected.split()
        want = int(parts[1]) if len(parts) > 1 else 0
        return exited and exit_code == want and term_signal is None
    if isinstance(expected, str) and expected.startswith("signaled"):
        from shadow_tpu_torch.host.signals import parse_signal
        parts = expected.split()
        if term_signal is None:
            return False
        return len(parts) < 2 or term_signal == parse_signal(parts[1])
    return True


def host_descriptor_table():
    from shadow_tpu_torch.host.descriptor import DescriptorTable
    return DescriptorTable()
