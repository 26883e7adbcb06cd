"""Chrome trace-event JSON export (loads in Perfetto or about:tracing),
the port's copy of `shadow_tpu/trace/chrome.py`.

Sim-time channel: rounds and spans as nested slices on one track (a
span opens with "B" and closes with "E"; each round is a complete "X"
slice inside its span; device-span aborts are instants).  Timestamps
are simulated microseconds.

Sim-netstat, fabric and kernel channels: counter tracks ("C" events),
each on a process of its own: per connection (cwnd/ssthresh, srtt,
buffers, retransmits), per link (CoDel depth and head sojourn, bucket
balances, link packet counters) and per kernel stage (active lanes and
occupancy), the per-entity families capped at `top_n`.

Wall-time channel: per-phase slices on a second process with real
(relative) microseconds.

The syscall channel (`syscalls-sim.bin`) belongs to the managed
processes, which the port has not ported (ROADMAP A7b): a non-empty one
is refused.
"""

from __future__ import annotations

from shadow_tpu_torch.trace.events import (EL_NAMES, FAM_NAMES, FR_ROUND,
                                           FR_SPAN_ABORT, FR_SPAN_COMMIT,
                                           FR_SPAN_START, KS_EXCHANGE,
                                           KS_NAMES, iter_ks_records,
                                           iter_records)

PID_SIM = 1
PID_WALL = 2
PID_NETSTAT = 3
PID_SYSCALL = 4
PID_FABRIC = 5
PID_KERN = 6

# The per-entity counter-track cap; the CLI takes it from the
# experimental.chrome_top_n knob (one knob for every track family).
DEFAULT_TOP_N = 16

# Counter tracks per exported connection: (track suffix, args built from
# a TEL_REC tuple, trace/events.py's field order).
NETSTAT_TRACKS = (
    # ssthresh is left out while still at its pre-loss "infinite" value
    ("cwnd", lambda r: {"cwnd": r[6]}
     | ({"ssthresh": r[7]} if r[7] < (1 << 30) else {})),
    ("srtt-ms", lambda r: {"srtt": r[8] / 1e6}),
    ("buffers", lambda r: {"sndbuf": r[11], "rcvbuf": r[12]}),
    ("retransmits", lambda r: {"rtx": r[13], "sack-skips": r[14]}),
)


def netstat_events(tel_bytes: bytes, top_n: int = DEFAULT_TOP_N) -> list:
    """Per-connection counter events from telemetry-sim.bin, for the
    top_n connections by final retransmit count (the ranking `trace net`
    prints)."""
    from shadow_tpu_torch.net.graph import format_ip
    from shadow_tpu_torch.trace.netstat import (group_by_conn,
                                                top_by_retransmits)

    by_conn = group_by_conn(tel_bytes)
    ranked = top_by_retransmits(by_conn, top_n)
    ev: list = [_meta(PID_NETSTAT, 0, "process_name",
                      "sim-netstat (per-connection TCP)")]
    for key in ranked:
        host, lport, rport, rip = key
        name = f"h{host}:{lport}->{format_ip(rip)}:{rport}"
        for suffix, args_of in NETSTAT_TRACKS:
            for rec in by_conn[key]:
                ev.append({"ph": "C", "pid": PID_NETSTAT, "tid": 0,
                           "ts": rec[0] / 1e3,
                           "name": f"{name} {suffix}",
                           "args": args_of(rec)})
    return ev


def _meta(pid: int, tid: int, what: str, name: str) -> dict:
    return {"ph": "M", "pid": pid, "tid": tid, "name": what,
            "args": {"name": name}}


def fabric_events(fab_bytes: bytes, top_n: int = DEFAULT_TOP_N) -> list:
    """Per-link counter tracks from fabric-sim.bin's FB section, for the
    top_n hosts by peak sampled queue depth (the ranking `trace fabric`
    prints)."""
    from shadow_tpu_torch.trace.fabricstat import (group_by_host,
                                                   top_by_peak_depth)

    by_host = group_by_host(fab_bytes)
    ranked = top_by_peak_depth(by_host, top_n)
    ev: list = []
    if not ranked:
        return ev
    ev.append(_meta(PID_FABRIC, 0, "process_name",
                    f"fabric observatory (top {len(ranked)} of "
                    f"{len(by_host)} links)"))
    for host in ranked:
        for rec in by_host[host]:
            ts = rec[0] / 1e3
            ev.append({"ph": "C", "pid": PID_FABRIC, "tid": 0,
                       "ts": ts, "name": f"h{host} queue",
                       "args": {"depth": rec[3],
                                "sojourn-ms": rec[5] / 1e6}})
            ev.append({"ph": "C", "pid": PID_FABRIC, "tid": 0,
                       "ts": ts, "name": f"h{host} bucket",
                       "args": {"out-bal": max(rec[9], 0),
                                "in-bal": max(rec[11], 0)}})
            ev.append({"ph": "C", "pid": PID_FABRIC, "tid": 0,
                       "ts": ts, "name": f"h{host} link",
                       "args": {"pkts-out": rec[13],
                                "pkts-in": rec[15]}})
    return ev


def kern_events(ks_bytes: bytes) -> list:
    """Per-stage counter tracks from kernel-sim.bin: one "C" event per
    committed span per occupied stage, at the span's entry time, with
    its active lanes and occupancy in permille (one record a committed
    span, so no top-N cap)."""
    ev: list = []
    seen = False
    for t, family, hosts, _rounds, trips, fires, lanes in \
            iter_ks_records(ks_bytes):
        if not seen:
            ev.append(_meta(PID_KERN, 0, "process_name",
                            "device-kernel observatory (per-stage "
                            "lane occupancy)"))
            seen = True
        fam = FAM_NAMES[family] if 0 <= family < len(FAM_NAMES) \
            else str(family)
        ts = t / 1e3
        slots = max(hosts * trips, 1)
        for i, name in enumerate(KS_NAMES):
            if fires[i] == 0 and lanes[i] == 0:
                continue
            args = {"lanes": lanes[i]}
            if i != KS_EXCHANGE:
                # exchange is a per-round stage (lanes = packets staged)
                args["occupancy-permille"] = (lanes[i] * 1000) // slots
            ev.append({"ph": "C", "pid": PID_KERN, "tid": 0,
                       "ts": ts, "name": f"{fam} {name}",
                       "args": args})
    return ev


def chrome_trace(sim_bytes: bytes, wall: dict | None = None,
                 tel_bytes: bytes = b"", sc_bytes: bytes = b"",
                 fab_bytes: bytes = b"",
                 top_n: int = DEFAULT_TOP_N,
                 ks_bytes: bytes = b"") -> dict:
    """The trace-event JSON object from the raw channel data:
    `sim_bytes` flight-sim.bin, `wall` the parsed flight-wall.json (or
    None), `tel_bytes` telemetry-sim.bin, `fab_bytes` fabric-sim.bin's
    FB section, `ks_bytes` kernel-sim.bin.  `sc_bytes`
    (syscalls-sim.bin) must be empty: its tracks come with the managed
    processes.  `top_n` caps every per-entity track family."""
    if sc_bytes:
        raise NotImplementedError(
            "shadow_tpu_torch: the syscall channel's Chrome tracks need "
            "the managed processes, not yet ported (ROADMAP A7b)")
    ev: list[dict] = [
        _meta(PID_SIM, 0, "process_name", "sim-time (simulated µs)"),
        _meta(PID_SIM, 1, "thread_name", "rounds & spans"),
    ]
    open_spans = 0
    round_idx = 0
    span_rounds_seen = 0  # FR_ROUND records inside the open span
    for t, kind, a, b, c in iter_records(sim_bytes):
        us = t / 1e3
        if kind == FR_SPAN_START:
            fam = FAM_NAMES[a] if 0 <= a < len(FAM_NAMES) else str(a)
            ev.append({"ph": "B", "pid": PID_SIM, "tid": 1, "ts": us,
                       "name": f"span:{fam}",
                       "args": {"round": c}})
            open_spans += 1
            span_rounds_seen = 0
        elif kind == FR_SPAN_COMMIT:
            if open_spans:
                ev.append({"ph": "E", "pid": PID_SIM, "tid": 1,
                           "ts": us,
                           "args": {"rounds": c, "packets": b}})
                open_spans -= 1
            # Engine spans already advanced round_idx by their drained
            # per-round records; device spans carry none, so only the
            # uncovered remainder advances it here.
            round_idx += max(c - span_rounds_seen, 0)
            span_rounds_seen = 0
        elif kind == FR_SPAN_ABORT:
            fam = FAM_NAMES[a] if 0 <= a < len(FAM_NAMES) else str(a)
            ev.append({"ph": "i", "pid": PID_SIM, "tid": 1, "ts": us,
                       "s": "t", "name": f"abort:{fam}",
                       "args": {"code": b}})
        elif kind == FR_ROUND:
            reason = EL_NAMES[a] if 0 <= a < len(EL_NAMES) else str(a)
            start_us = c / 1e3
            ev.append({"ph": "X", "pid": PID_SIM, "tid": 1,
                       "ts": start_us,
                       "dur": max(us - start_us, 0.001),
                       "name": f"round {round_idx}",
                       "args": {"reason": reason, "packets": b}})
            round_idx += 1
            if open_spans:
                span_rounds_seen += 1
    # A trace cut mid-span gets synthetic closes, so no "B" dangles.
    last_us = ev[-1].get("ts", 0) if ev else 0
    for _ in range(open_spans):
        ev.append({"ph": "E", "pid": PID_SIM, "tid": 1, "ts": last_us})

    if tel_bytes:
        ev.extend(netstat_events(tel_bytes, top_n))

    if fab_bytes:
        ev.extend(fabric_events(fab_bytes, top_n))

    if ks_bytes:
        ev.extend(kern_events(ks_bytes))

    if wall and wall.get("events"):
        ev.append(_meta(PID_WALL, 0, "process_name",
                        "wall-time (profiling µs)"))
        ev.append(_meta(PID_WALL, 1, "thread_name", "phases"))
        for t0, dur, name in wall["events"]:
            ev.append({"ph": "X", "pid": PID_WALL, "tid": 1,
                       "ts": t0 / 1e3, "dur": max(dur / 1e3, 0.001),
                       "name": name})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}
