"""Managed processes: real, unmodified Linux binaries under the sim, the
port's copy of `shadow_tpu/host/managed.py` (without strace, ROADMAP
A7b-2: the `_sc_note` / `_sc_trip` seams feed the syscall observatory's
host attributes, which stay None until it is ported).

The manager half of the interposition stack (the in-process half lives
in native/shim.c).  Mirrors the reference's resume chain — Process →
Thread → ManagedThread driving the native process over shared-memory
IPC (src/main/host/managed_thread.rs:97-333, process.rs:944,
memory_manager/memory_copier.rs) — with the same protocol:

 - spawn at the scheduled sim instant via posix_spawn with LD_PRELOAD;
 - StartReq/StartRes handshake gates the app's main();
 - resume(): receive Syscall events, dispatch into the simulated
   kernel, answer Complete / DoNative, or park on a SyscallCondition
   and re-run the same syscall when it fires (restart protocol,
   handler/mod.rs:127-136);
 - child death is detected by the ChildWatcher thread closing the dead
   process's IPC block (child_watcher.py; the reference's
   childpid_watcher.rs makes the same close-channel-on-death move with
   pidfd+epoll), with a long-interval waitpid poll as the safety net;
 - an unblocked-syscall CPU-latency model parks the thread every so
   often so syscall-spinning code advances simulated time
   (handler/mod.rs:271-321).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import signal
import socket as _socket
import struct
import threading
import time as _walltime

from shadow_tpu_torch.core.event import TaskRef
from shadow_tpu_torch.host import signals as sigmod
from shadow_tpu_torch.host.child_watcher import WATCHER
from shadow_tpu_torch.host.condition import SyscallCondition
from shadow_tpu_torch.host.futex import FutexTable
from shadow_tpu_torch.host.process import Process, ST_BLOCKED, ST_EXITED, ST_RUNNABLE
from shadow_tpu_torch.host.shim_abi import (ChannelClosed, ChannelTimeout, IpcBlock,
                                      EV_CLONE_DONE, EV_CLONE_RES,
                                      EV_FORK_DONE, EV_FORK_RES, EV_SIGNAL,
                                      EV_SIGNAL_DONE, EV_START_REQ,
                                      EV_START_RES, EV_SYSCALL,
                                      EV_SYSCALL_COMPLETE,
                                      EV_SYSCALL_COMPLETE_FDXFER,
                                      EV_SYSCALL_DO_NATIVE, EV_XFER_DONE)
from shadow_tpu_torch.host.syscalls_native import syscall_name
from shadow_tpu_torch.trace import events as trev

# The unblocked-syscall CPU-latency model (ref configuration.rs:464-480
# — ~1us per syscall, applied in batches by parking the thread, which
# serializes managed syscalls into the deterministic event timeline)
# reads its values from Host.syscall_latency_ns / Host.max_unapplied_ns,
# set from experimental config.

# Channel-wait slice between waitpid fallback polls.  Child death is
# normally detected by the ChildWatcher thread closing the IPC block
# (child_watcher.py); this poll is only a safety net, so it can be
# long without costing latency.  The default; the effective value is
# the experimental.managed_death_poll knob (Host.death_poll_ns,
# surfaced in metrics.wall.ipc.death_poll_ns).
_DEATH_POLL_NS = 2_000_000_000

# Reserved native fd for the manager<->process transfer socket (native
# SCM_RIGHTS delivery), parked just under EMU_FD_BASE so it never
# collides with the kernel's lowest-free allocation in practice.
XFER_FD = 399

# pidfd_open(2) flag: a pidfd for one THREAD (Linux 6.9+), readable
# when the task exits — the event-driven replacement for /proc stat
# polling during thread teardown.
_PIDFD_THREAD = 0x80  # == O_EXCL


def _pidfd_wait(tid: int, flags: int, timeout_s: float):
    """Block until the process/thread exits (pidfd becomes readable).
    True = exited (or already gone); False = timed out; None = the
    kernel lacks pidfd support for this request (caller must fall back
    to polling).  Uses poll(2) — the manager can hold >1024 fds, which
    overflows select()'s fd_set."""
    import errno as _e
    import select as _select
    try:
        fd = os.pidfd_open(tid, flags)
    except OSError as e:
        if e.errno == _e.ESRCH:
            return True  # gone already
        return None      # EINVAL/ENOSYS: unsupported kernel/filter
    try:
        p = _select.poll()
        p.register(fd, _select.POLLIN)
        return bool(p.poll(timeout_s * 1000.0))
    finally:
        os.close(fd)

# personality(2) flag: children inherit it through fork+exec, so setting
# it in the spawning thread gives every managed process a non-randomized
# address space (ref: shadow.rs:429 disable_aslr).  Address-derived
# values otherwise leak real entropy into simulations — OpenSSL's DRBG
# nonce includes pthread_self(), a TCB address, which made TLS
# handshakes differ across byte-identical runs.  personality is a
# per-TASK (thread) attribute and posix_spawn forks from the calling
# thread, so this must run on every scheduler worker thread that
# spawns, not once per process.
_ADDR_NO_RANDOMIZE = 0x0040000
_aslr_tls = threading.local()


def _disable_aslr_once() -> None:
    if getattr(_aslr_tls, "done", False):
        return
    _aslr_tls.done = True
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        cur = libc.personality(0xFFFFFFFF)
        if cur < 0:
            raise OSError(ctypes.get_errno(), "personality query")
        if not (cur & _ADDR_NO_RANDOMIZE):
            if libc.personality(cur | _ADDR_NO_RANDOMIZE) < 0:
                raise OSError(ctypes.get_errno(), "personality")
    except Exception as exc:  # pragma: no cover - kernel-dependent
        import warnings
        warnings.warn(f"could not disable ASLR ({exc}); address-derived "
                      f"values in managed processes (e.g. OpenSSL DRBG "
                      f"nonces) may be nondeterministic")


class MemoryManager:
    """Zero-copy-ish access to managed-process memory via /proc/pid/mem
    (ref: memory_copier.rs; the remapping MemoryMapper optimization is
    future work, the aggregate accounting below its measured basis)."""

    # Aggregate copier accounting across all managed processes
    # (read in sim-stats and by scripts/measure_memcopy.py).
    total_read_bytes = 0
    total_read_ns = 0
    total_write_bytes = 0
    total_write_ns = 0
    total_calls = 0

    def __init__(self, pid: int):
        self.pid = pid
        # /proc/pid/mem takes the process's address space when it is
        # opened, so it is opened at first use, once the process runs
        # the shim.  posix_spawn's caller wakes inside the child's
        # execve before the new address space is installed, and an open
        # then can take the caller's own (the JAX package opens here:
        # reads then fail with EIO, about once in 30 runs of a 64-process
        # fleet on a loaded host).
        self._fd_open = None

    @property
    def _fd(self) -> int:
        if self._fd_open is None:
            self._fd_open = os.open(f"/proc/{self.pid}/mem", os.O_RDWR)
        return self._fd_open

    def read(self, addr: int, n: int) -> bytes:
        if n <= 0:
            return b""
        t0 = _walltime.perf_counter_ns()  # shadow-lint: allow[wall-clock] memcopy perf counters
        data = os.pread(self._fd, n, addr)
        cls = MemoryManager
        cls.total_read_ns += _walltime.perf_counter_ns() - t0  # shadow-lint: allow[wall-clock] memcopy perf counters
        cls.total_read_bytes += len(data)
        cls.total_calls += 1
        if len(data) != n:
            raise OSError(14, "short read from managed process memory")
        return data

    def try_read(self, addr: int, n: int) -> bytes | None:
        try:
            return self.read(addr, n)
        except OSError:
            return None

    def write(self, addr: int, data: bytes) -> None:
        if not data:
            return
        t0 = _walltime.perf_counter_ns()  # shadow-lint: allow[wall-clock] memcopy perf counters
        r = os.pwrite(self._fd, data, addr)
        cls = MemoryManager
        cls.total_write_ns += _walltime.perf_counter_ns() - t0  # shadow-lint: allow[wall-clock] memcopy perf counters
        cls.total_write_bytes += len(data)
        cls.total_calls += 1
        if r != len(data):
            raise OSError(14, "short write to managed process memory")

    def read_cstr(self, addr: int, limit: int = 4096) -> bytes:
        """NUL-terminated string; chunk reads may come back short when
        the string sits near the end of a mapping (argv/env strings
        live at the very top of the stack), so accept partial chunks
        and only fault if the NUL is genuinely unreachable."""
        out = bytearray()
        while len(out) < limit:
            chunk_len = min(256, limit - len(out))
            chunk = os.pread(self._fd, chunk_len, addr + len(out))
            nul = chunk.find(b"\0")
            if nul >= 0:
                out += chunk[:nul]
                return bytes(out)
            out += chunk
            if len(chunk) < chunk_len:
                raise OSError(14, "unterminated string at mapping end")
        return bytes(out)

    def close(self) -> None:
        if self._fd_open is not None and self._fd_open >= 0:
            os.close(self._fd_open)
        self._fd_open = -1


def _elf_missing_interp(path: str, _depth: int = 0) -> bool:
    """True when the preload shim cannot ride into `path`: a static
    64-bit ELF (no PT_INTERP), a 32-bit ELF (the shim is 64-bit; ld.so
    would skip it with only a warning and the process would run
    UN-interposed), or a shebang script whose interpreter fails the
    same check (the kernel loads the interpreter directly — there is no
    later execve to catch it).  The reference rejects the static case
    identically ('not a dynamically linked ELF', src/test/static-bin
    asserts that error).  Unreadable/corrupt files return False: the
    kernel's own ENOEXEC path produces the clearer error."""
    import struct as _struct
    try:
        with open(path, "rb") as f:
            hdr = f.read(64)
            if hdr[:2] == b"#!" and _depth < 4:
                line = (hdr + f.read(192)).split(b"\n", 1)[0][2:]
                interp = line.strip().split()
                if not interp:
                    return False
                return _elf_missing_interp(
                    interp[0].decode(errors="replace"), _depth + 1)
            if len(hdr) < 64 or hdr[:4] != b"\x7fELF":
                return False  # not an ELF; let the kernel decide
            if hdr[4] != 2:
                return True   # 32-bit: the 64-bit shim can't load
            phoff = _struct.unpack_from("<Q", hdr, 32)[0]
            phentsize = _struct.unpack_from("<H", hdr, 54)[0]
            phnum = _struct.unpack_from("<H", hdr, 56)[0]
            if phnum == 0 or phentsize < 56:
                return True
            f.seek(phoff)
            phdrs = f.read(phentsize * min(phnum, 128))
            PT_INTERP = 3
            for i in range(min(phnum, 128)):
                if (i + 1) * phentsize > len(phdrs):
                    break  # truncated program headers
                if _struct.unpack_from("<I", phdrs,
                                       i * phentsize)[0] == PT_INTERP:
                    return False
            return True
    except (OSError, _struct.error):
        return False


class ManagedProcess(Process):
    """A Process whose thread drives a real OS process.

    Reuses Process for pid/fd-table/final-state bookkeeping; `stdout`/
    `stderr` fill from the native redirect files at exit so internal and
    managed processes look identical to the manager.
    """

    def __init__(self, host, name, argv, env, expected_final_state="exited 0",
                 work_dir: str | None = None):
        super().__init__(host, name, argv, env, expected_final_state)
        self.work_dir = work_dir or "."
        self.native_pid: int | None = None
        self.mem: MemoryManager | None = None
        self.ipc_block: IpcBlock | None = None
        self.futex_table = FutexTable()
        self._stdout_path: str | None = None
        self._stderr_path: str | None = None

    def live_managed_threads(self) -> int:
        return sum(1 for t in self.threads if t.state != ST_EXITED)

    def _spawn_image(self, host, resolved: str, argv: list,
                     env: dict, truncate_output: bool) -> "ManagedThread":
        """Shared native-image spawn (process start AND execve
        replacement): build/locate the shim, create a fresh IPC block,
        wire LD_PRELOAD / SHADOWTPU_IPC / LD_BIND_NOW, posix_spawn with
        stdio redirected to the process's output files, and register
        the new main thread.  Raises RuntimeError (shim build) or
        OSError (spawn) without touching this process's live state."""
        from shadow_tpu_torch.native import ensure_shim_built
        shim = ensure_shim_built()
        self._exec_count = getattr(self, "_exec_count", 0) + 1
        ipc_path = (f"/dev/shm/shadowtpu-{os.getpid()}-"
                    f"{host.id}-{self.pid}-{self._exec_count}.ipc")
        ipc = IpcBlock(ipc_path)
        try:
            return self._spawn_image_with(host, ipc, ipc_path, shim,
                                          resolved, argv, env,
                                          truncate_output)
        except Exception:
            ipc.close()
            raise

    def _spawn_image_with(self, host, ipc, ipc_path, shim, resolved,
                          argv, env, truncate_output) -> "ManagedThread":
        _disable_aslr_once()
        ipc.set_sim_time(host.now())
        ipc.set_auxv_random(host.rng.next_u64(), host.rng.next_u64())
        ipc.set_self_path(ipc_path)
        if getattr(host, "svc_active", False):
            # Syscall service plane (IPC v8): tell the shim to spin
            # briefly before parking for responses — advisory only.
            from shadow_tpu_torch.host.shim_abi import SVC_ACTIVE
            ipc.set_svc_flags(SVC_ACTIVE)

        env = dict(env)
        # Prepend the shim exactly once (an exec'd app passes through
        # its environ, which already carries it).  The opt-in crypto
        # no-op lib (ref preload-openssl/crypto.c) rides after it.
        chain = [shim]
        crypto_noop = getattr(host, "crypto_noop", None)
        if crypto_noop:  # lib path, resolved once by the Manager
            chain.append(crypto_noop)
        extra = [p for p in env.get("LD_PRELOAD", "").split(":")
                 if p and p not in chain]
        preload = ":".join(chain + extra)
        env["LD_PRELOAD"] = preload
        env["SHADOWTPU_IPC"] = ipc_path
        # Per-process shim diagnostics (ref: .shimlog files).  Absolute:
        # the shim re-resolves the path per message, and the app may
        # chdir at any point.
        env["SHADOWTPU_SHIMLOG"] = os.path.abspath(os.path.join(
            self.work_dir, f"{self.name}.{self.pid}.shimlog"))
        if getattr(host, "preempt_native_ns", 0) > 0:
            env["SHADOWTPU_PREEMPT_NATIVE_US"] = \
                str(max(1, host.preempt_native_ns // 1000))
            env["SHADOWTPU_PREEMPT_SIM_NS"] = str(host.preempt_sim_ns)
        if getattr(host, "native_io_ns_per_kib", 0) > 0:
            env["SHADOWTPU_IO_NS_PER_KIB"] = \
                str(host.native_io_ns_per_kib)
        # Transfer socket for native-fd SCM_RIGHTS delivery: the child
        # gets one end dup2'd to a reserved fd just under EMU_FD_BASE;
        # the manager keeps the other to sendmsg real fds at delivery
        # time (the shim collects and patches the app's cmsg buffer).
        if getattr(self, "_xfer_child_end", None) is None:
            old = getattr(self, "_xfer_sock", None)
            if old is not None:
                old.close()
            mgr_end, child_end = _socket.socketpair(
                _socket.AF_UNIX, _socket.SOCK_DGRAM)
            self._xfer_sock = mgr_end
            self._xfer_child_end = child_end
        env["SHADOWTPU_XFER_FD"] = str(XFER_FD)
        # Eager relocation: keeps ld.so's lazy-binding syscalls out of
        # the simulated timeline.
        env.setdefault("LD_BIND_NOW", "1")
        # OpenSSL determinism (ref: src/lib/preload-openssl/rng.c).  The
        # shim interposes the RAND_* symbols for 1.1-style callers; for
        # OpenSSL 3's provider DRBG — which seeds itself from CPU
        # entropy when available — mask the RDRAND/RDSEED CPUID bits so
        # seeding falls back to the getrandom syscall, which seccomp
        # traps and the manager answers from the host's seeded RNG.
        env.setdefault("OPENSSL_ia32cap", "~0x4000000000000000:~0x40000")
        ipc.set_preload(preload)

        # Always O_APPEND: a fork child's exec'd image opens its own
        # file description on the shared output file, and only append
        # semantics keep concurrent writers from overwriting each other.
        # Process start truncates explicitly instead of O_TRUNC.
        if truncate_output:
            for p in (self._stdout_path, self._stderr_path):
                if p:
                    open(p, "wb").close()
        wflags = os.O_WRONLY | os.O_CREAT | os.O_APPEND
        file_actions = [(os.POSIX_SPAWN_OPEN, 0, "/dev/null",
                         os.O_RDONLY, 0)]
        if self._stdout_path:
            file_actions.append((os.POSIX_SPAWN_OPEN, 1,
                                 self._stdout_path, wflags, 0o644))
        if self._stderr_path:
            file_actions.append((os.POSIX_SPAWN_OPEN, 2,
                                 self._stderr_path, wflags, 0o644))
        # dup2 clears FD_CLOEXEC, so the transfer end survives the exec.
        file_actions.append((os.POSIX_SPAWN_DUP2,
                             self._xfer_child_end.fileno(), XFER_FD))
        argv = list(argv) if argv else [resolved]
        # Spawn-storm taming (svc/containment.py): wall-only stagger
        # between successive managed spawns, then bounded retry on
        # transient kernel pressure — EAGAIN (fork budget) and ENOMEM
        # ride a short backoff before the containment policy engages.
        from shadow_tpu_torch.svc.containment import (SPAWN_BACKOFF_S,
                                                SPAWN_GATE,
                                                SPAWN_RETRIES)
        import errno as _errno
        SPAWN_GATE.wait(getattr(host, "spawn_stagger_ns", 0))
        for attempt in range(SPAWN_RETRIES + 1):
            try:
                pid = os.posix_spawn(resolved, argv, env,
                                     file_actions=file_actions)
                break
            except OSError as e:
                if e.errno in (_errno.EAGAIN, _errno.ENOMEM) \
                        and attempt < SPAWN_RETRIES:
                    _walltime.sleep(SPAWN_BACKOFF_S * (1 << attempt))  # shadow-lint: allow[wall-clock] bounded posix_spawn retry backoff
                    continue
                ipc.close()
                raise
        # Commit: replace identity state only after the spawn succeeded.
        # The cached pidfd (native-fd SCM_RIGHTS pulls) refers to the
        # OLD native process — drop it or every post-exec pull fails.
        old_pidfd = getattr(self, "_pidfd", None)
        if old_pidfd is not None:
            self._pidfd = None
            try:
                os.close(old_pidfd)
            except OSError:
                pass
        self.native_pid = pid
        if self.mem is not None:
            self.mem.close()
        self.mem = MemoryManager(pid)
        self.ipc_block = ipc
        self.argv = argv
        self._preload = preload
        WATCHER.register(pid, ipc)
        thread = ManagedThread(self, ipc, ipc.channel(0), self._next_tid)
        self._next_tid += 1
        self.threads.append(thread)
        return thread

    def _spawn_failed(self, host, why: str) -> None:
        """Spawn failure (missing/static binary, posix_spawn error
        after the bounded retries): the run's plugin error (the
        `abort` policy; `quarantine` and `restart` are ROADMAP A7c)."""
        self.stderr += f"[shadow-tpu] {why}\n".encode()
        self.exited = True
        self.exit_code = 127

    def start_native(self, host, exe_path: str | None = None) -> None:
        exe = exe_path or (self.argv[0] if self.argv else None)
        resolved = shutil.which(exe) if exe and "/" not in exe else exe
        if not resolved or not os.path.exists(resolved):
            self._spawn_failed(host, f"no such binary: {exe!r}")
            return
        if _elf_missing_interp(resolved):
            self._spawn_failed(host, f"'{resolved}' is not a "
                                     f"dynamically linked ELF")
            return
        os.makedirs(self.work_dir, exist_ok=True)
        self._stdout_path = os.path.join(self.work_dir,
                                         f"{self.name}.{self.pid}.stdout")
        self._stderr_path = os.path.join(self.work_dir,
                                         f"{self.name}.{self.pid}.stderr")
        try:
            thread = self._spawn_image(host, resolved, self.argv,
                                       self.env, truncate_output=True)
        except (RuntimeError, OSError, ValueError) as e:
            # No toolchain / build / spawn failure / oversized preload:
            # a plugin error (or a contained one), not a sim crash —
            # the run completes and reports it.
            self._spawn_failed(host, str(e))
            return
        thread.resume(host)

    def collect_output(self) -> None:
        """Fold new file content into the owning process's buffers.
        Fork children share the parent's output files, so collection
        always happens on the root owner, incrementally — a child that
        outlives its parent still gets its late writes reported."""
        owner = getattr(self, "_output_owner", None) or self
        offsets = owner.__dict__.setdefault("_out_offsets", {})
        for path, buf_name in ((owner._stdout_path, "stdout"),
                               (owner._stderr_path, "stderr")):
            if path and os.path.exists(path):
                with open(path, "rb") as f:
                    f.seek(offsets.get(buf_name, 0))
                    data = f.read()
                offsets[buf_name] = offsets.get(buf_name, 0) + len(data)
                if data:
                    setattr(owner, buf_name,
                            getattr(owner, buf_name) + bytearray(data))

    # -- emulated signals (ref: process.rs signal ingest,
    #    shim/src/signals.rs) --------------------------------------------

    def raise_signal(self, host, sig: int, target_tid: int | None = None,
                     si_code: int = 0, si_pid: int = 0,
                     si_status: int = 0) -> None:
        """Queue `sig` for delivery (kill/tgkill/itimer/shutdown_signal).

        Delivery is deterministic: the chosen thread gets the signal at
        its next syscall response point, and a thread parked in an
        interruptible blocking syscall is woken through the event queue
        to take it (-EINTR / SA_RESTART protocol)."""
        if self.exited or sig <= 0 or sig >= sigmod.NSIG:
            return
        sigs = self.signals
        siginfo = (si_code, si_pid, si_status)
        if sig == sigmod.SIGKILL:
            self.terminate_by_signal(host, sig)
            return
        if sig == sigmod.SIGCONT:
            # The continue side-effect fires at generation time
            # regardless of disposition/blocking (kernel semantics);
            # a SIGCONT handler then delivers through the normal path.
            self.continue_process(host)
        elif self.stopped:
            # The stop shields everything but KILL/CONT until the
            # continue.  Defer the ENTIRE raise — thread targeting,
            # blocked-pending semantics, condition interrupts — to be
            # re-run by continue_process; re-implementing any slice of
            # it here would drop invariants (signalfd's blocked-stays-
            # pending, tgkill's per-thread pending set, EINTR wakes of
            # still-blocked threads).
            if sigs.disposition(sig) != "stop":  # already stopped
                self._stopped_sigs.append((sig, target_tid, si_code,
                                           si_pid, si_status))
            return
        elif sigs.disposition(sig) == "stop":
            # SIGSTOP is unblockable; TSTP/TTIN/TTOU with default
            # disposition stop too (a blocked TSTP would queue, but
            # stop-at-generation matches the kernel's wake-and-stop
            # behavior closely enough for a terminal-less sim).
            self.stop_process(host, sig)
            return
        live = [t for t in self.threads if t.state != ST_EXITED]
        if not live:
            return
        if target_tid is not None:
            target = next((t for t in live if t.tid == target_tid), None)
            if target is None:
                return
        else:
            unblocked = [t for t in live
                         if not (t.sig_mask & sigmod.bit(sig))]
            if not unblocked:
                # BLOCKED signals queue regardless of disposition
                # (kernel sig_ignored() is false for blocked signals) —
                # the sd-event pattern relies on a blocked, default-
                # ignored SIGCHLD staying pending for signalfd.
                self._queue_siginfo(sig, siginfo)
                sigs.pending_process.add(sig)
                self.refresh_signal_fds(host)
                return
            target = min(unblocked, key=lambda t: t.tid)
        if not (target.sig_mask & sigmod.bit(sig)) and \
                sigs.disposition(sig) == "ignore":
            return  # deliverable now and ignored: discarded
        self._queue_siginfo(sig, siginfo, target)
        target.sig_pending.add(sig)
        self.refresh_signal_fds(host)
        if target.sig_mask & sigmod.bit(sig):
            return  # stays pending until the thread unblocks it
        # A sigtimedwait-style waiter consumes the signal directly
        # (no handler runs).
        if getattr(target, "_sigwait_set", 0) & sigmod.bit(sig) and \
                target.state == ST_BLOCKED:
            target.sig_pending.discard(sig)
            self.refresh_signal_fds(host)
            target._sigwait_got = sig
            target._sigwait_info = sigs.take_info(sig)
            if target.last_condition is not None:
                target.last_condition.fire(host)
            return
        if sigs.disposition(sig) == "terminate":
            self.terminate_by_signal(host, sig)
            return
        if target.state == ST_BLOCKED:
            target._sig_interrupted = True
            cond = target.last_condition
            if cond is not None and getattr(cond, "_armed", False):
                cond.disarm()
                target.last_condition = None
                host.schedule_task_at(host.now(),
                                      TaskRef("signal-wake", target._wakeup))
            # else: the condition already fired and a wakeup task is
            # queued; that resume will deliver the signal first.
        # Runnable threads take it at their next response point.

    def _queue_siginfo(self, sig: int, info: tuple, target=None) -> None:
        """Kernel semantics for standard signals: one pending instance;
        the FIRST raiser's siginfo is kept until delivery consumes it —
        a second raise while pending is merged away."""
        pending = sig in self.signals.pending_process or \
            (target is not None and sig in target.sig_pending) or \
            any(sig in t.sig_pending for t in self.threads)
        if not pending:
            self.signals.info[sig] = info

    def terminate_by_signal(self, host, sig: int) -> None:
        """Default-action termination (uncaught fatal signal)."""
        if self.exited:
            return
        self.term_signal = sig
        if self.native_pid is not None:
            try:
                os.kill(self.native_pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            for t in self.threads:
                if isinstance(t, ManagedThread):
                    t._poll_death(host, blocking=True)
                    return
        self.exited = True
        self.exit_code = 128 + sig

    def kill_native(self) -> None:
        """Forced teardown (simulation shutdown with the process still
        running)."""
        if self.native_pid is not None and not self.exited:
            try:
                os.kill(self.native_pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            try:
                os.waitpid(self.native_pid, 0)
            except ChildProcessError:
                pass
        for t in self.threads:
            if isinstance(t, ManagedThread):
                t.teardown()


class ManagedThread:
    """Drives one native thread over its IPC channel
    (managed_thread.rs:190-333)."""

    def __init__(self, process: ManagedProcess, block: IpcBlock, chan,
                 tid: int):
        self.process = process
        self.block = block
        self.chan = chan
        self.tid = tid
        self.state = ST_RUNNABLE
        self.native_tid: int | None = None
        self.ctid_addr: int | None = None  # CLONE_CHILD_CLEARTID / set_tid_address
        self.futex_waiter = None           # outcome carrier for FUTEX_WAIT restarts
        self._released = False
        self._pending_response = None  # (kind, value) to send on re-entry
        self._pending_call = None      # (num, args) to re-dispatch
        self.last_condition = None
        self._unapplied_ns = 0
        self.cpu_total_ns = 0  # cumulative modeled CPU (getrusage)
        # Emulated signal state (ref thread.rs:533+ pending signals).
        self.sig_mask = 0              # blocked-signal bitmask
        self.sig_pending: set[int] = set()
        self._sig_interrupted = False  # a signal disarmed our condition
        self._post_handler = []        # continuations parked during handlers
        self._suspend_restore = None   # rt_sigsuspend saved mask
        self._sigwait_set = 0          # rt_sigtimedwait watch set
        self._sigwait_got = None
        self._sigwait_info = (0, 0, 0)
        # Syscall observatory: wall ns the manager spent blocked in
        # the IPC recv that delivered the event currently being
        # serviced (attributed to that syscall's round trip), the
        # snapshot taken at dispatch entry (nested sub-protocol recvs
        # accrue past it and are carved OUT of the resume leg so the
        # wait/dispatch/resume split stays disjoint), and the outcome
        # a handshake sub-protocol reports back to _service.
        self._sc_wait_ns = 0
        self._sc_pre_wait = 0
        self._sc_out = (0, 0)

    # -- latency model ------------------------------------------------

    def add_cpu_latency(self, ns: int) -> None:
        self._unapplied_ns += ns
        self.cpu_total_ns += ns

    # -- channel helpers ----------------------------------------------

    def _recv(self, host):
        """Next shim event, or None if the child died.

        Hang watchdog (svc/containment.py): with
        `experimental.managed_watchdog` set, a thread that produces no
        IPC event for that much WALL time while its native process is
        alive (userspace spin, a DO_NATIVE syscall that never returns)
        is killed; the death then resolves through the normal path at
        the DETERMINISTIC sim instant this host was servicing (a plugin
        error under the `abort` policy)."""
        sw = host.sc_wall
        t0 = sw.now() if sw is not None else 0
        cont = getattr(host, "containment", None)
        wd_ns = cont.watchdog_ns if cont is not None else 0
        wd_deadline = (_walltime.monotonic() + wd_ns / 1e9  # shadow-lint: allow[wall-clock] hang-watchdog deadline (wall-only knob)
                       if wd_ns > 0 else None)
        try:
            while True:
                slice_ns = getattr(host, "death_poll_ns",
                                   _DEATH_POLL_NS)
                if wd_deadline is not None:
                    left = wd_deadline - _walltime.monotonic()  # shadow-lint: allow[wall-clock] hang-watchdog deadline (wall-only knob)
                    if left <= 0 and not self._poll_death(host):
                        # Hung: kill the native process; the next
                        # iteration resolves the death (channel close
                        # or waitpid) and _finish engages containment.
                        wd_deadline = None
                        if cont is not None:
                            cont.hang_kill(host, self)
                        continue
                    if left > 0:
                        slice_ns = min(slice_ns,
                                       max(int(left * 1e9), 1_000_000))
                try:
                    ev = self.chan.recv_from_shim(
                        timeout_ns=slice_ns)
                    # Native-I/O latency the shim accrued since its last
                    # event; flows into the standard unapplied-CPU model.
                    ns = self.chan.take_unapplied_ns()
                    if ns:
                        self.add_cpu_latency(ns)
                    # Syscall observatory: locally-answered time reads
                    # the shim counted since its last event (SC_SHIM —
                    # no round trip; the slot protocol orders the read
                    # like take_unapplied_ns).  The drain point is a
                    # function of the event sequence alone, so the
                    # count — and any record — is deterministic.
                    n = self.chan.take_local_count()
                    if n:
                        host.sc_disp[trev.SC_SHIM] += n
                        log = host.sc_log
                        if log is not None:
                            t = host.now()
                            log.rec(t, t, host.id, self.process.pid,
                                    self.tid, -1, trev.RC_OK,
                                    trev.SC_SHIM, n)
                    return ev
                except ChannelTimeout:
                    if self._poll_death(host):
                        return None
                except ChannelClosed:
                    self._poll_death(host, blocking=True)
                    return None
        finally:
            if sw is not None:
                # Accumulate (don't assign): nested receives inside a
                # dispatch's sub-protocol (clone/fork handshakes, the
                # fd-transfer dance) fold into the trip that consumes
                # the accumulator, instead of clobbering the wait the
                # original syscall event already paid.
                self._sc_wait_ns += sw.now() - t0

    def _poll_death(self, host, blocking: bool = False) -> bool:
        pid = self.process.native_pid
        try:
            done, status = os.waitpid(pid, 0 if blocking else os.WNOHANG)
        except ChildProcessError:
            self._finish(host, 126)
            return True
        if done == 0:
            return False
        if os.WIFEXITED(status):
            code = os.WEXITSTATUS(status)
        else:
            code = 128 + os.WTERMSIG(status)
            if self.process.term_signal is None:
                # A NATIVE fatal signal (segfault etc.) is this
                # process's final state, same as an emulated one.
                self.process.term_signal = os.WTERMSIG(status)
        self._finish(host, code)
        return True

    # -- the resume loop ----------------------------------------------

    def resume(self, host) -> None:
        if self.state == ST_EXITED:
            return
        if self.process.stopped:
            # Job control: defer until SIGCONT (the native process
            # stays parked in its channel recv meanwhile).
            self.process._stopped_resumes.append(self.resume)
            return
        self.state = ST_RUNNABLE
        self.block.set_sim_time(host.now())

        if not self._released:
            ev = self._recv(host)
            if ev is None:
                return
            kind, num, _args = ev
            if kind != EV_START_REQ:
                self._protocol_error(host, f"expected StartReq, got {kind}")
                return
            self.native_tid = int(num)
            self.chan.send_to_shim(EV_START_RES)
            self._released = True

        # Emulated signal delivery at the resume boundary: a signal that
        # interrupted a blocked syscall, or arrived while parked for CPU
        # latency, is delivered (handler invoked shim-side) before the
        # owed response goes out.
        if self.process.signals.has_deliverable(self):
            interrupted, self._sig_interrupted = self._sig_interrupted, False
            if interrupted and self._pending_call is not None:
                r = self._deliver_signals(host, self._interrupted_cont)
            elif self._pending_response is not None:
                k, v = self._pending_response
                self._pending_response = None
                r = self._deliver_signals(host, ("resp", k, v, None))
                if r == "none":
                    # Every pending signal turned out ignorable (its
                    # disposition flipped while we were parked): the
                    # owed response must still go out below.
                    self._pending_response = (k, v)
            else:
                r = "none"  # no owed response: next response point takes it
            if r == "dead":
                return
        else:
            self._sig_interrupted = False

        if self.process.stopped:
            # A signal delivered above froze the process: everything
            # owed (response, call re-run, the pump) waits for SIGCONT.
            self.process._stopped_resumes.append(self.resume)
            return

        if self._pending_response is not None:
            kind, value = self._pending_response
            self._pending_response = None
            self.chan.send_to_shim(kind, value)

        if self._pending_call is not None:
            num, args = self._pending_call
            self._pending_call = None
            if not self._service(host, num, args, restarted=True):
                return

        self._pump(host)

    def _pump(self, host) -> None:
        while True:
            ev = self._recv(host)
            if ev is None:
                return
            kind, num, args = ev
            if kind == EV_SIGNAL_DONE:
                if not self._handler_returned(host):
                    return
                continue
            if kind != EV_SYSCALL:
                self._protocol_error(host, f"unexpected event kind {kind}")
                return
            if not self._service(host, num, args, restarted=False):
                return

    # -- emulated signal delivery -------------------------------------

    def _interrupted_cont(self, sig: int):
        """Continuation for the blocked syscall `sig` interrupted:
        SA_RESTART re-runs restartable calls, everything else -EINTR
        (handler/mod.rs restart protocol; man 7 signal)."""
        import errno as _errno
        num, args = self._pending_call
        self._pending_call = None
        self._sigwait_set = 0
        act = self.process.signals.action(sig)
        name = syscall_name(num)
        if (act.flags & sigmod.SA_RESTART) and name in sigmod.RESTARTABLE:
            return ("call", num, args)
        restore = None
        if name == "rt_sigsuspend":
            restore, self._suspend_restore = self._suspend_restore, None
        return ("resp", EV_SYSCALL_COMPLETE, -_errno.EINTR, restore)

    def _deliver_signals(self, host, cont):
        """Deliver the next deliverable pending signal; `cont` (a tuple,
        or a callable sig->tuple) is what to do once the handler
        returns.  Returns "sent" (EV_SIGNAL dispatched, cont parked),
        "dead" (default action terminated the process), or "none"
        (nothing deliverable — caller proceeds with cont itself)."""
        sigs = self.process.signals
        while True:
            sig = sigs.take_deliverable(self)
            if sig is None:
                return "none"
            self.process.refresh_signal_fds(host)
            disp = sigs.disposition(sig)
            if disp == "ignore":
                continue
            if disp == "stop":
                # A pending stop signal whose action reverted to
                # default: freeze the process and stop delivering —
                # the caller's response point parks the owed response
                # (_send_response_or_park) until SIGCONT.
                self.process.stop_process(host, sig)
                return "none"
            if disp == "terminate":
                self.process.terminate_by_signal(host, sig)
                return "dead"
            act = sigs.action(sig)
            saved_mask = self.sig_mask
            self.sig_mask |= act.mask
            if not (act.flags & sigmod.SA_NODEFER):
                self.sig_mask |= sigmod.bit(sig)
            if act.flags & sigmod.SA_RESETHAND:
                sigs.actions.pop(sig, None)
            resolved = cont(sig) if callable(cont) else cont
            self._post_handler.append((resolved, saved_mask))
            si_code, si_pid, si_status = sigs.take_info(sig)
            # The shim builds the handler's siginfo from args[2..4]
            # (si_code, si_pid, si_status) and its ucontext from the
            # live trap frame + args[5] = the emulated blocked mask at
            # delivery (what uc_sigmask restores after the handler —
            # Linux semantics; the native mask would be the shim's).
            mask_i64 = saved_mask - (1 << 64) \
                if saved_mask >= (1 << 63) else saved_mask
            self.chan.send_to_shim(EV_SIGNAL, sig,
                                   (act.handler, act.flags, si_code,
                                    si_pid, si_status, mask_i64))
            return "sent"

    def _handler_returned(self, host) -> bool:
        """EV_SIGNAL_DONE: restore the mask, deliver any further pending
        signal, then run the parked continuation.  Returns False when
        the pump must stop (process died / re-blocked)."""
        if not self._post_handler:
            self._protocol_error(host, "SIGNAL_DONE without handler")
            return False
        cont, saved_mask = self._post_handler.pop()
        self.sig_mask = saved_mask
        r = self._deliver_signals(host, cont)
        if r == "sent":
            return True
        if r == "dead":
            return False
        if cont[0] == "resp":
            _k, rk, rv, restore = cont
            if restore is not None:
                self.sig_mask = restore
            return self._send_response_or_park(host, rk, rv)
        if self.process.stopped:
            # Stop delivered above: defer the SA_RESTART re-dispatch.
            self._pending_call = (cont[1], tuple(cont[2]))
            self.process._stopped_resumes.append(self.resume)
            return False
        _k, num, args = cont  # ("call", ...) — SA_RESTART re-dispatch
        return self._service(host, num, args, restarted=False)

    def _park(self, host, condition, num: int, args) -> None:
        """Block this thread on `condition`, re-running (num, args) on
        wakeup — the single home of the blocking bookkeeping."""
        self._pending_call = (num, tuple(args))
        self.last_condition = condition
        self.state = ST_BLOCKED
        condition.arm(host, self._wakeup)

    def _sc_note(self, host, t_enter: int, num: int, disp: int,
                 rclass: int, t_exit: int | None = None) -> None:
        """Credit this dispatch its single SC_* disposition (always-on
        counters) and append the per-syscall record when the syscall
        observatory's sim channel is recording.  One call per dispatch
        — the conservation contract the `trace sys` report checks
        against strace line counts."""
        host.sc_disp[disp] += 1
        log = host.sc_log
        if log is not None:
            log.rec(t_enter,
                    t_exit if t_exit is not None else host.now(),
                    host.id, self.process.pid, self.tid, num, rclass,
                    disp)

    def _sc_trip(self, sw, num: int, w0: int, w1: int) -> None:
        """Feed the wall profile one round trip: the recv wait that
        delivered this event + dispatch + everything after dispatch
        (strace, signal delivery, response send).  Nested sub-protocol
        waits (clone/fork handshakes, the fd-transfer dance) accrued
        past the dispatch-entry snapshot sit inside [w1, now]; carve
        them out of the resume leg so the three legs stay disjoint.
        No-op when the observatory is off — the single guard for
        every branch."""
        if sw is None:
            return
        nested = self._sc_wait_ns - self._sc_pre_wait
        sw.trip(syscall_name(num), self._sc_wait_ns, w1 - w0,
                max(sw.now() - w1 - nested, 0))
        self._sc_wait_ns = 0

    def _service(self, host, num: int, args, restarted: bool) -> bool:
        """Dispatch one syscall; returns True to keep pumping events."""
        handler = host.syscall_handler_native
        host.count_syscall(syscall_name(num))
        process = self.process
        sc_t0 = host.now()
        sw = host.sc_wall
        w0 = w1 = 0
        if sw is not None:
            w0 = sw.now()
            self._sc_pre_wait = self._sc_wait_ns
        result = handler.dispatch(host, process, self, num, args, restarted)
        if sw is not None:
            w1 = sw.now()
        kind = result[0]

        if kind == "block":
            self._sc_note(host, sc_t0, num, trev.SC_PARKED,
                          trev.RC_NONE)
            self._sc_trip(sw, num, w0, w1)
            self._park(host, result[1], num, args)
            return False

        if kind in ("clone", "fork", "execve"):
            # The handshake sub-protocols report their real outcome
            # through _sc_out (set before each completion send); a
            # conversation that dies mid-dance keeps the SC_PROTO
            # default — the record is noted AFTER the dance, and the
            # trip too (its nested channel waits accumulated into
            # _sc_wait_ns and the dance is this round trip's resume
            # cost).
            self._sc_out = (trev.SC_PROTO, trev.RC_NONE)
            if kind == "clone":
                keep = self._do_clone(host, result[1], result[2])
            elif kind == "fork":
                keep = self._do_fork(host)
            else:
                keep = self._do_execve(host, result[1], result[2],
                                       result[3])
            self._sc_note(host, sc_t0, num, *self._sc_out)
            self._sc_trip(sw, num, w0, w1)
            return keep

        if kind == "thread_exit":
            # A secondary thread exiting (SYS_exit with siblings alive):
            # let the native thread die, then emulate the kernel's
            # CLONE_CHILD_CLEARTID contract against OUR futex table so a
            # pthread_join blocked in the emulated FUTEX_WAIT wakes.
            code = result[1]
            self._sc_note(host, sc_t0, num, trev.SC_NATIVE,
                          trev.RC_NATIVE)
            self._sc_trip(sw, num, w0, w1)
            self.chan.send_to_shim(EV_SYSCALL_DO_NATIVE)
            if not self._await_native_thread_gone():
                # Delivering the CLEARTID wake while ctid may still be
                # nonzero would let a joiner re-park forever; failing
                # the process loudly beats a silent deadlock.
                self._protocol_error(
                    host, f"native tid {self.native_tid} did not tear "
                          f"down within 5s of thread exit")
                return False
            self.state = ST_EXITED
            if self.last_condition is not None:
                self.last_condition.disarm()
                self.last_condition = None
            self.block.free_channel(self.chan.index)
            if self.ctid_addr:
                # The kernel already wrote 0 (we waited for thread
                # teardown above); deliver the wake to emulated waiters.
                self.process.futex_table.wake(host, self.ctid_addr, 1)
            # Record the exit code (a crashed helper thread must not be
            # masked by a clean main thread — process.py invariant).
            self.process.thread_exited(host, self, code)
            return False

        if kind == "exit":
            # Short-circuit (managed_thread.rs:268-282): let the native
            # exit_group run, then reap synchronously.  The wait is
            # event-driven (poll on the process pidfd), not a
            # wall-clock slice loop.
            self._sc_note(host, sc_t0, num, trev.SC_NATIVE,
                          trev.RC_NATIVE)
            self._sc_trip(sw, num, w0, w1)
            self.chan.send_to_shim(EV_SYSCALL_DO_NATIVE)
            if _pidfd_wait(self.process.native_pid, 0, 10.0) is None:
                # No pidfd support: fall back to the timed slice poll.
                deadline = _walltime.monotonic() + 10.0  # shadow-lint: allow[wall-clock] real-OS process-death wait
                while _walltime.monotonic() < deadline:  # shadow-lint: allow[wall-clock] real-OS process-death wait
                    if self._poll_death(host):
                        return False
                    _walltime.sleep(0.001)
            if self._poll_death(host):
                return False
            self._protocol_error(host, "child did not exit after exit_group")
            return False

        if kind == "done_fdxfer":
            # Native fds in an SCM_RIGHTS delivery: run the transfer
            # dance (sendmsg on the xfer socket + shim collection)
            # before the ordinary completion below.
            if not self._do_fdxfer(host, *result[2:]):
                # Receiver died mid-dance: the dispatch happened (and
                # strace logged it) but no response ever lands.
                self._sc_note(host, sc_t0, num, trev.SC_PROTO,
                              trev.RC_NONE)
                self._sc_trip(sw, num, w0, w1)
                return False
            kind, result = "done", ("done", result[1])

        if kind == "native":
            rv_kind, rv_val = EV_SYSCALL_DO_NATIVE, 0
            sc_disp, sc_rc = trev.SC_NATIVE, trev.RC_NATIVE
        elif kind == "done":
            rv_kind, rv_val = EV_SYSCALL_COMPLETE, int(result[1] or 0)
            sc_disp, sc_rc = trev.SC_SERVICED, trev.RC_OK
        elif kind == "error":
            err = result[1]
            rv_kind, rv_val = EV_SYSCALL_COMPLETE, -int(err.errno or 22)
            sc_disp, sc_rc = trev.SC_SERVICED, trev.RC_ERR
        else:  # pragma: no cover
            raise AssertionError(f"bad dispatch result {result!r}")

        # The dispatch may have terminated this very process (a
        # self-directed fatal signal): the channel is gone, stop pumping.
        if self.state == ST_EXITED or process.exited:
            self._sc_note(host, sc_t0, num, sc_disp, sc_rc)
            self._sc_trip(sw, num, w0, w1)
            return False

        # Response point: emulated signals are delivered before the
        # response reaches the app (the kernel's return-to-user check).
        if process.signals.has_deliverable(self):
            restore = None
            if syscall_name(num) == "rt_sigsuspend":
                restore, self._suspend_restore = self._suspend_restore, None
            r = self._deliver_signals(
                host, ("resp", rv_kind, rv_val, restore))
            if r in ("sent", "dead"):
                # The response rides the parked continuation (or never
                # lands at all): the dispatch itself is complete.
                self._sc_note(host, sc_t0, num, sc_disp, sc_rc)
                self._sc_trip(sw, num, w0, w1)
                return r == "sent"
            if restore is not None:
                # rt_sigsuspend with every pending signal consumed as
                # ignored (disposition flipped while blocked): no handler
                # ran, so the kernel would keep waiting with the
                # temporary mask — re-park instead of returning EINTR,
                # and keep the saved mask for the eventual real wakeup.
                from shadow_tpu_torch.core import simtime
                self._sc_note(host, sc_t0, num, trev.SC_PARKED,
                              trev.RC_NONE)
                self._sc_trip(sw, num, w0, w1)
                self._suspend_restore = restore
                self._park(host, SyscallCondition(
                    timeout_at=simtime.TIME_NEVER - 1), num, args)
                return False

        lat = host.syscall_latency_ns
        self.add_cpu_latency(lat)
        if host.cpu is not None:
            host.cpu.add_delay(lat)  # feeds the host CPU model (cpu.rs)
        if self._unapplied_ns >= host.max_unapplied_ns:
            # Apply accumulated CPU time: answer only after the event
            # queue reaches now + latency (possibly next round).
            self._pending_response = (rv_kind, rv_val)
            apply_at = host.now() + self._unapplied_ns
            self._unapplied_ns = 0
            # The response lands at apply_at, not now: the record's
            # exit stamp carries the deferred instant (deterministic —
            # both addends are simulated values).
            self._sc_note(host, sc_t0, num, sc_disp, sc_rc,
                          t_exit=apply_at)
            self._sc_trip(sw, num, w0, w1)
            host.schedule_task_at(apply_at,
                                  TaskRef("cpu-latency", self.resume))
            return False

        self._sc_note(host, sc_t0, num, sc_disp, sc_rc)
        keep = self._send_response_or_park(host, rv_kind, rv_val)
        # Trip AFTER the send so the resume leg includes the response
        # publish + futex wake.
        self._sc_trip(sw, num, w0, w1)
        return keep

    def _send_response_or_park(self, host, rv_kind, rv_val) -> bool:
        """Send a syscall response — unless the process stopped while
        servicing it (a self-directed SIGSTOP, or a stop delivered at
        this response point): the kernel returns from the interrupted
        syscall only after the continue, so park the owed response and
        re-arm through the deferred-resume list.  Returns True to keep
        pumping."""
        if self.process.stopped:
            self._pending_response = (rv_kind, rv_val)
            self.process._stopped_resumes.append(self.resume)
            return False
        self.chan.send_to_shim(rv_kind, rv_val)
        return True

    # -- clone protocol (managed_thread.rs:359 native_clone) ----------

    def _do_clone(self, host, flags: int, ctid: int) -> bool:
        """Three-way handshake: hand the shim a channel index, let it
        run the real clone (child parks immediately), register the new
        ManagedThread, and schedule its start through the event queue so
        thread birth is a deterministic simulation event."""
        idx = self.block.alloc_channel()
        if idx is None:
            self._sc_out = (trev.SC_SERVICED, trev.RC_ERR)
            self.chan.send_to_shim(EV_SYSCALL_COMPLETE, -11)  # EAGAIN
            return True
        self.chan.send_to_shim(EV_CLONE_RES, idx)
        ev = self._recv(host)
        if ev is None:
            return False
        kind, child_tid, _args = ev
        if kind != EV_CLONE_DONE:
            self._protocol_error(host, f"expected CloneDone, got {kind}")
            return False
        child_tid = int(child_tid)
        if child_tid < 0:
            self.block.free_channel(idx)
            self._sc_out = (trev.SC_SERVICED, trev.RC_ERR)
            self.chan.send_to_shim(EV_SYSCALL_COMPLETE, child_tid)
            return True
        process = self.process
        child = ManagedThread(process, self.block, self.block.channel(idx),
                              process._next_tid)
        process._next_tid += 1
        child.native_tid = child_tid
        _CLONE_CHILD_CLEARTID = 0x200000
        if flags & _CLONE_CHILD_CLEARTID:
            child.ctid_addr = ctid
        process.threads.append(child)
        host.schedule_task_at(host.now(), TaskRef("thread-start",
                                                  child.resume))
        self._sc_out = (trev.SC_SERVICED, trev.RC_OK)
        self.chan.send_to_shim(EV_SYSCALL_COMPLETE, child_tid)
        return True

    # -- fork / execve (ref: process.rs:297,944 spawn_mthread_for_exec,
    #    clone-handler fork path) -------------------------------------

    def _do_fdxfer(self, host, pairs, refs, msg_ptr, control_ptr,
                   emu_fds) -> bool:
        """Deliver native fds for an SCM_RIGHTS recvmsg: send the real
        fds (manager-held dups) over the process's transfer socket with
        their cmsg slot addresses as payload, tell the shim to collect
        and patch, and wait for EV_XFER_DONE.  On any failure the cmsg
        is rewritten to carry only the already-registered emulated fds
        (never a -1 hole) with MSG_CTRUNC — like Linux closing
        unclaimed fds.  Returns False if the process died mid-dance."""
        from shadow_tpu_torch.host.descriptor import _decref
        proc = self.process
        sock = getattr(proc, "_xfer_sock", None)
        status = -1
        if sock is not None:
            payload = b"".join(struct.pack("<Q", a) for a, _f in pairs)
            try:
                _socket.send_fds(sock, [payload],
                                 [f for _a, f in pairs])
            except OSError:
                sock = None
        if sock is not None:
            self.chan.send_to_shim(EV_SYSCALL_COMPLETE_FDXFER, len(pairs))
            ev = self._recv(host)
            if ev is None:
                # Receiver died before collecting: drain the queued
                # datagram via our handle on the child-side end, or a
                # fork sibling's next transfer would pop it (and patch
                # stale addresses).
                ce = getattr(proc, "_xfer_child_end", None)
                if ce is not None:
                    try:
                        ce.setblocking(False)
                        _msg, stale_fds, _fl, _ad = _socket.recv_fds(
                            ce, 4096, 64)
                        for f in stale_fds:
                            os.close(f)
                    except OSError:
                        pass
                for r in refs:
                    _decref(r, host)
                return False
            ev_kind, num, _args = ev
            if ev_kind != EV_XFER_DONE:
                for r in refs:
                    _decref(r, host)
                self._protocol_error(
                    host, f"expected XferDone, got {ev_kind}")
                return False
            status = int(num)
        for r in refs:
            _decref(r, host)
        if status != 0:
            # Rewrite the cmsg keeping the emulated fds the receiver
            # already owns; dropping them would orphan live table
            # entries the app could never close.
            MSG_CTRUNC = 0x8
            if emu_fds:
                cmsg = struct.pack("<QII", 16 + 4 * len(emu_fds), 1, 1)
                cmsg += b"".join(struct.pack("<i", f) for f in emu_fds)
                proc.mem.write(control_ptr, cmsg)
                proc.mem.write(msg_ptr + 40,
                               struct.pack("<Q", len(cmsg)))
            else:
                proc.mem.write(msg_ptr + 40, struct.pack("<Q", 0))
            proc.mem.write(msg_ptr + 48, struct.pack("<i", MSG_CTRUNC))
        return True

    def _do_fork(self, host) -> bool:
        """fork/vfork/fork-style clone: create the child ManagedProcess
        and its fresh IPC block, hand the path to the shim (EV_FORK_RES),
        let it run clone(SIGCHLD|CLONE_PARENT) — CLONE_PARENT so the
        manager stays the waitpid()-able parent of every native process
        — then register the child thread on our side."""
        parent = self.process
        child = ManagedProcess(
            host, f"{parent.name}.f", list(parent.argv), dict(parent.env),
            expected_final_state="any", work_dir=parent.work_dir)
        ipc_path = (f"/dev/shm/shadowtpu-{os.getpid()}-"
                    f"{host.id}-{child.pid}.ipc")
        try:
            ipc = IpcBlock(ipc_path)
        except OSError:
            host.processes.pop(child.pid, None)
            self._sc_out = (trev.SC_SERVICED, trev.RC_ERR)
            self.chan.send_to_shim(EV_SYSCALL_COMPLETE, -11)  # EAGAIN
            return True
        ipc.set_sim_time(host.now())
        ipc.set_auxv_random(host.rng.next_u64(), host.rng.next_u64())
        ipc.set_self_path(ipc_path)
        if getattr(host, "svc_active", False):
            from shadow_tpu_torch.host.shim_abi import SVC_ACTIVE
            ipc.set_svc_flags(SVC_ACTIVE)
        preload = getattr(parent, "_preload", "")
        if preload:
            ipc.set_preload(preload)
        child._preload = preload
        child.ipc_block = ipc

        def abort_fork():
            ipc.close()
            host.processes.pop(child.pid, None)

        self.block.set_fork_path(ipc_path)
        self.chan.send_to_shim(EV_FORK_RES)
        ev = self._recv(host)
        if ev is None:
            abort_fork()
            return False
        kind, native_pid, _args = ev
        if kind != EV_FORK_DONE:
            abort_fork()
            self._protocol_error(host, f"expected ForkDone, got {kind}")
            return False
        native_pid = int(native_pid)
        if native_pid < 0:
            abort_fork()
            self._sc_out = (trev.SC_SERVICED, trev.RC_ERR)
            self.chan.send_to_shim(EV_SYSCALL_COMPLETE, native_pid)
            return True

        child.native_pid = native_pid
        child.mem = MemoryManager(native_pid)
        WATCHER.register(native_pid, ipc)
        child.fds = parent.fds.fork_copy()
        plow = getattr(parent, "fds_low", None)
        if plow is not None:
            child.fds_low = plow.fork_copy()
        from shadow_tpu_torch.host.files import SignalFd
        for table in (child.fds, getattr(child, "fds_low", None)):
            if table is None:
                continue
            for cfd, f in table.items():
                if isinstance(f, SignalFd):
                    # Each SignalFd serves one process: the child gets
                    # its own view bound to itself (files.py scope
                    # model).
                    table.replace(cfd, f.clone_for(child))
        child.signals = parent.signals.clone()
        seg = child.signals.action(sigmod.SIGSEGV)
        if seg.handler:
            ipc.set_sigsegv_action(seg.handler, seg.flags)
        child.parent_pid = parent.pid
        child.pgid = parent.pgid  # fork inherits process group/session
        child.sid = parent.sid
        # The child shares the parent's native stdout/stderr fds; it
        # remembers the paths (an exec'd image re-opens them O_APPEND)
        # while collection folds incrementally into the root owner.
        child._stdout_path = parent._stdout_path
        child._stderr_path = parent._stderr_path
        child._output_owner = getattr(parent, "_output_owner",
                                      None) or parent
        # The forked child's fd 399 is the parent's transfer socket
        # (same open description); give the manager an independent
        # handle so each side's teardown closes only its own.
        pxfer = getattr(parent, "_xfer_sock", None)
        if pxfer is not None:
            child._xfer_sock = pxfer.dup()
        pxce = getattr(parent, "_xfer_child_end", None)
        if pxce is not None:
            child._xfer_child_end = pxce.dup()
        thread = ManagedThread(child, ipc, ipc.channel(0), child._next_tid)
        child._next_tid += 1
        thread.sig_mask = self.sig_mask  # fork inherits the caller's mask
        child.threads.append(thread)
        host.schedule_task_at(host.now(), TaskRef("fork-start",
                                                  thread.resume))
        self._sc_out = (trev.SC_SERVICED, trev.RC_OK)
        self.chan.send_to_shim(EV_SYSCALL_COMPLETE, child.pid)
        return True

    def _do_execve(self, host, path: str, argv: list, envp: list) -> bool:
        """execve replaces the native process outright: the inherited
        seccomp filter would SIGSYS-kill a fresh image before its shim
        constructor installs a handler, so (like the reference's
        spawn_mthread_for_exec) we posix_spawn the new image against a
        fresh IPC block, and only once that succeeds kill the old
        native process — spawn failures (ENOENT/EACCES/ENOEXEC) return
        to the caller like a failed execve should.  The emulated
        process identity (pid, fd table, parent) is preserved."""
        import errno as _errno
        process = self.process
        # /proc/self in the CALLER's context, not the manager's.
        if path == "/proc/self/exe":
            try:
                path = os.readlink(f"/proc/{process.native_pid}/exe")
            except OSError:
                pass
        elif path.startswith("/proc/self/"):
            path = f"/proc/{process.native_pid}/" + path[11:]
        if "/" not in path:
            # The kernel does not PATH-search execve (that's execvp's
            # userspace job).
            resolved = None
        elif not path.startswith("/"):
            # Relative to the CALLER's cwd (chdir runs natively in the
            # managed process, so the manager's cwd is unrelated).
            try:
                cwd = os.readlink(f"/proc/{process.native_pid}/cwd")
            except OSError:
                cwd = "/"
            resolved = os.path.normpath(os.path.join(cwd, path))
        else:
            resolved = path
        if not resolved or not os.path.exists(resolved):
            self._sc_out = (trev.SC_SERVICED, trev.RC_ERR)
            self.chan.send_to_shim(EV_SYSCALL_COMPLETE, -_errno.ENOENT)
            return True
        if not os.access(resolved, os.X_OK):
            self._sc_out = (trev.SC_SERVICED, trev.RC_ERR)
            self.chan.send_to_shim(EV_SYSCALL_COMPLETE, -_errno.EACCES)
            return True
        if _elf_missing_interp(resolved):
            # Static ELF: the shim cannot ride into it (see
            # _elf_missing_interp); refuse like a bad format.
            self._sc_out = (trev.SC_SERVICED, trev.RC_ERR)
            self.chan.send_to_shim(EV_SYSCALL_COMPLETE, -_errno.ENOEXEC)
            return True

        env = {}
        for item in envp:
            k, _sep, v = item.partition("=")
            env[k] = v
        old_pid = process.native_pid
        old_block = process.ipc_block
        try:
            new_thread = process._spawn_image(host, resolved,
                                              list(argv) or [resolved],
                                              env, truncate_output=False)
        except (RuntimeError, OSError, ValueError) as e:
            if isinstance(e, OSError) and e.errno:
                code = e.errno
            elif isinstance(e, ValueError):  # oversized env/preload
                code = _errno.E2BIG
            else:
                code = _errno.ENOEXEC
            self._sc_out = (trev.SC_SERVICED, trev.RC_ERR)
            self.chan.send_to_shim(EV_SYSCALL_COMPLETE, -code)
            return True

        # Point of no return: retire the old image.  All its threads
        # die on exec; no response is owed to it.
        for t in process.threads:
            if isinstance(t, ManagedThread) and t is not new_thread \
                    and t.state != ST_EXITED:
                if t.last_condition is not None:
                    t.last_condition.disarm()
                    t.last_condition = None
                t.state = ST_EXITED
        try:
            os.kill(old_pid, signal.SIGKILL)
        except (ProcessLookupError, TypeError):
            pass
        try:
            os.waitpid(old_pid, 0)
        except (ChildProcessError, OSError):
            pass
        WATCHER.unregister(old_pid)
        # Closed only after the kill: a live shim seeing CLOSED would
        # print a channel-teardown complaint into the shared stderr.
        old_block.mark_closed()
        old_block.close()

        # POSIX exec semantics on the emulated state.
        process.fds.close_cloexec(host)
        plow = getattr(process, "fds_low", None)
        if plow is not None:
            plow.close_cloexec(host)
        process.signals.actions = {
            s: a for s, a in process.signals.actions.items()
            if a.handler == 1}  # SIG_IGN survives, handlers reset
        seg = process.signals.action(sigmod.SIGSEGV)
        if seg.handler:
            process.ipc_block.set_sigsegv_action(seg.handler, seg.flags)
        process.futex_table = FutexTable()
        new_thread.sig_mask = self.sig_mask  # exec preserves the mask
        host.schedule_task_at(host.now(), TaskRef("exec-start",
                                                  new_thread.resume))
        self._sc_out = (trev.SC_SERVICED, trev.RC_OK)
        return False  # the old image's pump ends here

    def _await_native_thread_gone(self) -> bool:
        """Busy-poll until the kernel has fully torn the thread down —
        only then has CLONE_CHILD_CLEARTID been honored and the thread
        stack gone quiescent (a joiner may free it the moment it sees
        tid==0).  The thread-group leader's /proc task entry persists as
        a zombie until the whole process exits, so accept state Z/X
        there, not just disappearance.  False on timeout (the caller
        fails the process rather than risking a lost-wake deadlock)."""
        # Mostly event-driven: a thread pidfd (PIDFD_THREAD, Linux
        # 6.9+) becomes readable when the task exits — but a ZOMBIE
        # thread-group leader (main thread gone, workers alive) parks
        # in Z without signalling its pidfd, so interleave short pidfd
        # waits with /proc state checks instead of busy-polling.
        path = (f"/proc/{self.process.native_pid}/task/"
                f"{self.native_tid}/stat")
        deadline = _walltime.monotonic() + 5.0  # shadow-lint: allow[wall-clock] real-OS thread-death wait
        while _walltime.monotonic() < deadline:  # shadow-lint: allow[wall-clock] real-OS thread-death wait
            try:
                with open(path) as f:
                    stat = f.read()
            except OSError:
                return True  # task entry gone
            # State is the field after the parenthesized comm.
            state = stat.rpartition(")")[2].lstrip()[:1]
            if state in ("Z", "X", ""):
                return True
            waited = _pidfd_wait(self.native_tid, _PIDFD_THREAD, 0.05)
            if waited:
                return True
            if waited is None:
                # Pre-6.9 kernel (no PIDFD_THREAD): the /proc check
                # above is the only signal — keep the old short sleep
                # instead of spinning.
                _walltime.sleep(0.0002)
        return False

    def _wakeup(self, host) -> None:
        if self.state == ST_BLOCKED:
            self.resume(host)

    def _protocol_error(self, host, why: str) -> None:
        # Observatory note: dispositions are credited strictly at
        # dispatch level (exactly one per dispatch — the conservation
        # contract); a dispatch whose conversation dies mid-service is
        # credited SC_PROTO by its _service branch, and teardown here
        # adds nothing on top.
        self.process.stderr += (
            f"[shadow-tpu] managed IPC protocol error: {why}\n").encode()
        try:
            os.kill(self.process.native_pid, signal.SIGKILL)
        except (ProcessLookupError, TypeError):
            pass
        self._poll_death(host, blocking=True)

    def _finish(self, host, code: int) -> None:
        """The native *process* is gone (waitpid reaped it): every
        thread is dead, not just this one."""
        if self.state == ST_EXITED:
            return
        process = self.process
        if process.term_signal is not None:
            # Killed by an *emulated* fatal signal (the native reap saw
            # our SIGKILL; report the simulated signal instead).
            code = 128 + process.term_signal
        for t in process.threads:
            if isinstance(t, ManagedThread) and t.state != ST_EXITED:
                t.state = ST_EXITED
                if t.last_condition is not None:
                    t.last_condition.disarm()
                    t.last_condition = None
        self.teardown()
        if process.mem is not None:
            process.mem.close()
        process.collect_output()
        process.thread_exited(host, self, code)

    def teardown(self) -> None:
        """Close the whole process's IPC block (idempotent)."""
        WATCHER.unregister(self.process.native_pid)
        self.block.mark_closed()
        self.block.close()
        process = self.process
        for attr in ("_xfer_sock", "_xfer_child_end"):
            s = getattr(process, attr, None)
            if s is not None:
                setattr(process, attr, None)
                try:
                    s.close()
                except OSError:
                    pass
        pidfd = getattr(process, "_pidfd", None)
        if pidfd is not None:
            process._pidfd = None
            try:
                os.close(pidfd)
            except OSError:
                pass

    # Process.thread_exited checks thread.state via the same constants;
    # the generator-thread interface ends here.
    def _exit(self, host, code: int) -> None:
        """Forced exit (manager shutdown path), mirror of Thread._exit."""
        if self.state == ST_EXITED:
            return
        try:
            os.kill(self.process.native_pid, signal.SIGKILL)
        except (ProcessLookupError, TypeError):
            pass
        self._poll_death(host, blocking=True)
