"""Manager-side view of the shim IPC block (mirror of native/shim_ipc.h).

The manager maps the same file the shim maps and speaks the futex SPSC
protocol directly from Python via `ctypes` — x86-64's total store order
plus CPython's sequential execution give the release/acquire semantics
the two-word protocol needs, and the per-message futex syscalls dominate
the cost anyway.  (Ref: the simulator side of
src/lib/shadow-shim-helper-rs/src/ipc.rs.)

One block carries IPC_N_CHANS channel pairs: channel 0 is the process's
main thread, the rest are allocated as the process clones threads (the
reference shmallocs a fresh IPCData per ManagedThread,
managed_thread.rs:113).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import mmap
import os
import struct

# --- constants mirrored from native/shim_ipc.h ---------------------
MAGIC = 0x53545055
# v8: syscall service plane — svc_flags header word (OFF_SVC below)
# and the consumer-side FUTEX_WAKE dropped from both directions (the
# alternating protocol means no one ever waits for an EMPTY slot).
VERSION = 8
FILE_SIZE = 24576

N_CHANS = 64
CHANS_OFF = 576
CHAN_STRIDE = 320
CHAN_TO_SHADOW = 0
CHAN_TO_SHIM = 72
CHAN_UNAPPLIED = 2 * 72 + 8 * 16  # after clone_regs[15] + clone_chan_idx
# Shim-side SC_SHIM sequence counter (syscall observatory): locally-
# answered time syscalls since the last drain.  C twin: SC_CHAN_LOCAL_OFF
# in native/shim.c (static_assert-pinned to the struct; analysis pass 1
# diffs the two values).
CHAN_SC_LOCAL = 2 * 72 + 8 * 17
PATH_MAX = 160

SLOT_EMPTY = 0
SLOT_READY = 1
SLOT_CLOSED = 2

EV_NULL = 0
EV_START_REQ = 1
EV_SYSCALL = 2
EV_CLONE_DONE = 3
EV_SIGNAL_DONE = 4
EV_FORK_DONE = 5
EV_XFER_DONE = 6
EV_START_RES = 16
EV_SYSCALL_COMPLETE = 17
EV_SYSCALL_DO_NATIVE = 18
EV_CLONE_RES = 19
EV_SIGNAL = 20
EV_FORK_RES = 21
EV_SYSCALL_COMPLETE_FDXFER = 22

OFF_MAGIC = 0
OFF_VERSION = 4
OFF_SIM_TIME = 8
OFF_AUXV = 16
OFF_SIGSEGV = 32
OFF_SELF_PATH = 48
OFF_FORK_PATH = 48 + PATH_MAX
OFF_PRELOAD = 48 + 2 * PATH_MAX
# Syscall service plane (IPC v8): manager-written advisory flags the
# shim reads to pick spin-then-wait for responses.  C twin:
# SC_SVC_FLAGS_OFF in native/shim.c (static_assert-pinned to the
# struct; analysis pass 1 diffs the two values).
OFF_SVC = 48 + 3 * PATH_MAX
SVC_ACTIVE = 1  # SHIM_SVC_ACTIVE
SLOT_EV_OFF = 8
EV_STRUCT = struct.Struct("<II7q")  # kind, pad, num, args[6]

_SYS_futex = 202
FUTEX_WAIT = 0
FUTEX_WAKE = 1

_libc = ctypes.CDLL(None, use_errno=True)


class _Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


def _futex_wait(addr: int, expected: int, timeout_ns: int | None) -> int:
    """Returns 0 on wake/value-change, -1 with errno on timeout/EINTR."""
    if timeout_ns is None:
        ts = None
    else:
        ts = ctypes.byref(_Timespec(timeout_ns // 1_000_000_000,
                                    timeout_ns % 1_000_000_000))
    r = _libc.syscall(_SYS_futex, ctypes.c_void_p(addr), FUTEX_WAIT,
                      expected, ts, None, 0)
    return r


def _futex_wake(addr: int) -> None:
    _libc.syscall(_SYS_futex, ctypes.c_void_p(addr), FUTEX_WAKE, 1,
                  None, None, 0)


class ChannelClosed(Exception):
    """The peer marked the slot CLOSED (process died / torn down)."""


class ChannelTimeout(Exception):
    """recv timed out (used to poll for child death)."""


class Channel:
    """One thread's request/response slot pair inside an IpcBlock."""

    __slots__ = ("block", "index", "_to_shadow", "_to_shim", "_unapplied",
                 "_sc_local")

    def __init__(self, block: "IpcBlock", index: int):
        self.block = block
        self.index = index
        base = CHANS_OFF + index * CHAN_STRIDE
        self._to_shadow = base + CHAN_TO_SHADOW
        self._to_shim = base + CHAN_TO_SHIM
        self._unapplied = base + CHAN_UNAPPLIED
        self._sc_local = base + CHAN_SC_LOCAL

    def send_to_shim(self, kind: int, num: int = 0,
                     args: tuple = (0, 0, 0, 0, 0, 0)) -> None:
        blk = self.block
        off = self._to_shim
        # Slot must be EMPTY per the alternating protocol.
        EV_STRUCT.pack_into(blk._mm, off + SLOT_EV_OFF, kind, 0, num, *args)
        blk._store_u32(off, SLOT_READY)
        _futex_wake(blk._addr + off)

    def recv_from_shim(self, timeout_ns: int | None = None):
        """Block until the shim publishes an event; returns (kind, num,
        args).  Raises ChannelTimeout after `timeout_ns` so the caller
        can check for child death, ChannelClosed on CLOSED."""
        blk = self.block
        off = self._to_shadow
        while True:
            st = blk._load_u32(off)
            if st == SLOT_READY:
                kind, _pad, num, *args = EV_STRUCT.unpack_from(
                    blk._mm, off + SLOT_EV_OFF)
                # IPC v8: no wake after the EMPTY flip — the shim's
                # send asserts EMPTY instead of waiting for it, so the
                # wake was one wasted futex syscall per event.
                blk._store_u32(off, SLOT_EMPTY)
                return kind, num, args
            if st == SLOT_CLOSED:
                raise ChannelClosed
            r = _futex_wait(blk._addr + off, st, timeout_ns)
            if r != 0:
                err = ctypes.get_errno()
                import errno as _e
                if err == _e.ETIMEDOUT and timeout_ns is not None:
                    # Re-check once: the word may have flipped between
                    # the timeout and now.
                    if blk._load_u32(off) not in (SLOT_READY, SLOT_CLOSED):
                        raise ChannelTimeout
                # EAGAIN (value changed) / EINTR: loop and re-check.

    def take_unapplied_ns(self) -> int:
        """Drain the shim-accumulated native-I/O latency (safe while the
        shim is parked awaiting our response — the slot protocol orders
        the accesses)."""
        mm = self.block._mm
        (ns,) = struct.unpack_from("<Q", mm, self._unapplied)
        if ns:
            struct.pack_into("<Q", mm, self._unapplied, 0)
        return ns

    def take_local_count(self) -> int:
        """Drain the count of syscalls the shim answered locally (the
        time family; SC_SHIM disposition) since the last drain — same
        slot-protocol ordering argument as take_unapplied_ns."""
        mm = self.block._mm
        (n,) = struct.unpack_from("<Q", mm, self._sc_local)
        if n:
            struct.pack_into("<Q", mm, self._sc_local, 0)
        return n

    def mark_closed(self) -> None:
        """Wake the shim thread with CLOSED on both slots."""
        blk = self.block
        if blk.closed:
            return
        for off in (self._to_shadow, self._to_shim):
            blk._store_u32(off, SLOT_CLOSED)
            _futex_wake(blk._addr + off)


class IpcBlock:
    """One managed process's IPC block, backed by a /dev/shm file."""

    def __init__(self, path: str):
        self.path = path
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, FILE_SIZE)
            self._mm = mmap.mmap(fd, FILE_SIZE)
        finally:
            os.close(fd)
        self._addr = ctypes.addressof(
            ctypes.c_char.from_buffer(self._mm))
        struct.pack_into("<II", self._mm, 0, MAGIC, VERSION)
        self.closed = False
        self._chan_used = [False] * N_CHANS
        self._chan_used[0] = True  # main thread

    def channel(self, index: int) -> Channel:
        return Channel(self, index)

    def alloc_channel(self) -> int | None:
        """Reserve a channel index for a newly cloned thread."""
        for i, used in enumerate(self._chan_used):
            if not used:
                self._chan_used[i] = True
                return i
        return None

    def free_channel(self, index: int) -> None:
        self._chan_used[index] = False

    # -- raw words --------------------------------------------------

    def _load_u32(self, off: int) -> int:
        return struct.unpack_from("<I", self._mm, off)[0]

    def _store_u32(self, off: int, value: int) -> None:
        struct.pack_into("<I", self._mm, off, value)

    def set_sim_time(self, sim_ns: int) -> None:
        struct.pack_into("<Q", self._mm, OFF_SIM_TIME, sim_ns)

    def set_auxv_random(self, lo: int, hi: int) -> None:
        struct.pack_into("<QQ", self._mm, OFF_AUXV, lo, hi)

    def _write_cstr(self, off: int, value: str) -> None:
        data = value.encode()
        if len(data) >= PATH_MAX:
            raise ValueError(f"IPC path/value too long ({len(data)} >= "
                             f"{PATH_MAX}): {value!r}")
        self._mm[off:off + len(data) + 1] = data + b"\0"

    def set_self_path(self, path: str) -> None:
        self._write_cstr(OFF_SELF_PATH, path)

    def set_fork_path(self, path: str) -> None:
        self._write_cstr(OFF_FORK_PATH, path)

    def set_preload(self, value: str) -> None:
        self._write_cstr(OFF_PRELOAD, value)

    def set_sigsegv_action(self, handler: int, flags: int) -> None:
        """Publish the app's emulated SIGSEGV sigaction for the shim's
        chaining fault handler (the shim owns the native SIGSEGV slot
        for rdtsc emulation)."""
        struct.pack_into("<QQ", self._mm, OFF_SIGSEGV, handler, flags)

    def set_svc_flags(self, flags: int) -> None:
        """Advertise service-plane state to the shim (IPC v8): with
        SVC_ACTIVE set the shim spins briefly before parking in
        FUTEX_WAIT for a response.  Advisory only — byte identity
        never depends on it."""
        struct.pack_into("<I", self._mm, OFF_SVC, flags)

    # -- teardown ---------------------------------------------------

    def mark_closed(self) -> None:
        """Tear down: wake every thread with CLOSED on every slot."""
        for i in range(N_CHANS):
            self.channel(i).mark_closed()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        # The ctypes view that gave `_addr` was a temporary, freed by
        # its refcount at once: no collection is needed before the close
        # (the JAX package's gc.collect() here is one full collection a
        # process teardown, seconds over a 1,000-process fleet).
        self._addr = None
        try:
            self._mm.close()
        except BufferError:
            pass  # a ctypes view still alive somewhere; the OS cleans up
        try:
            os.unlink(self.path)
        except OSError:
            pass
