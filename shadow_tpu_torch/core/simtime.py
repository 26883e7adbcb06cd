"""Simulation time primitives.

Two clocks, as in the reference's shadow-shim-helper-rs
(src/lib/shadow-shim-helper-rs/src/simulation_time.rs and emulated_time.rs):

- *simulation time*: nanoseconds since the start of the simulation (t=0).
- *emulated time*: nanoseconds since the UNIX epoch as seen by managed
  code; the simulation starts at a fixed epoch so runs are reproducible
  regardless of the real wallclock.

Times are plain Python ints on the host path (arbitrary precision, cheap)
and int64 arrays on the device path. We deliberately do not wrap them in
classes: the event loop compares and adds times millions of times per
round and attribute indirection is pure overhead under CPython.
"""

NSEC_PER_USEC = 1_000
NSEC_PER_MSEC = 1_000_000
NSEC_PER_SEC = 1_000_000_000

# The simulated UNIX epoch at simulation time 0: 2000-01-01 00:00:00 UTC.
# A fixed, plausible-but-clearly-simulated date (same policy as the
# reference's EmulatedTime SIMULATION_START).
EMUTIME_SIMULATION_START = 946_684_800 * NSEC_PER_SEC

# Sentinel for "no event pending" / "never": must compare greater than any
# reachable time and fit in int64 for device-side min-reductions.
TIME_NEVER = (1 << 62)

SIMTIME_INVALID = -1


def emulated_from_sim(sim_ns: int) -> int:
    """Emulated (wall-looking) time for a simulation instant."""
    return EMUTIME_SIMULATION_START + sim_ns


def sim_from_emulated(emu_ns: int) -> int:
    return emu_ns - EMUTIME_SIMULATION_START


def fmt(sim_ns: int) -> str:
    """Human formatting for logs: seconds with ns precision."""
    if sim_ns >= TIME_NEVER:
        return "never"
    return f"{sim_ns // NSEC_PER_SEC}.{sim_ns % NSEC_PER_SEC:09d}s"
