"""Processes and threads of internal (Python-coroutine) applications:
the port's copy of `shadow_tpu/host/process.py`, without signals, job
control, strace and the checkpoint transcript (ROADMAP A7b and A7c; the
config refuses what needs them).

An app is a generator that yields syscall tuples and receives results;
a Thread drives it: dispatch the syscall, continue on done, park on
block, and re-run the same syscall after the condition fires (the
restart protocol).
"""

from __future__ import annotations

from shadow_tpu_torch.host.descriptor import DescriptorTable

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

    def resume(self, host) -> None:
        """Drive the app generator until it blocks or exits."""
        if self.state == ST_EXITED:
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
                    self._exit(host, si.value if isinstance(si.value, int)
                               else 0)
                    return
                except ProcessExit as pe:
                    self._exit(host, pe.code)
                    return
                except Exception as e:
                    # The app let an error escape (a syscall's OSError or
                    # its own bug): that crashes the process, never the
                    # simulation.
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
        self._nonzero_exit: int | None = None  # first failing thread wins
        self.stdout = bytearray()
        self.stderr = bytearray()
        self.expected_final_state = expected_final_state
        self.fds = DescriptorTable()

    def spawn_thread(self, host, gen) -> Thread:
        t = Thread(self, gen, self._next_tid)
        self._next_tid += 1
        self.threads.append(t)
        return t

    def start(self, host, gen) -> None:
        """Create the main thread and run it now."""
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

    def matches_expected_final_state(self) -> bool:
        return matches_final_state(self.expected_final_state, self.exited,
                                   self.exit_code)


def matches_final_state(expected, exited: bool, exit_code) -> bool:
    """The one expected_final_state matcher (no process of the port takes
    a signal: the config refuses `signaled` states and shutdown_time)."""
    if expected in ("running", "any"):
        return expected == "any" or not exited
    parts = expected.split()
    want = int(parts[1]) if len(parts) > 1 else 0
    return bool(exited) and exit_code == want
