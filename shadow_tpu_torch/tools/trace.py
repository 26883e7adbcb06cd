"""The reports over a data directory: summarize, attribute, export.
The port's copy of `shadow_tpu/tools/trace.py`.

    python -m shadow_tpu_torch.tools.trace DATA_DIR            # summarize
    python -m shadow_tpu_torch.tools.trace DATA_DIR --chrome out.json
    python -m shadow_tpu_torch.tools.trace net DATA_DIR        # TCP report
    python -m shadow_tpu_torch.tools.trace fabric DATA_DIR     # queue report
    python -m shadow_tpu_torch.tools.trace fct DATA_DIR        # FCT table
    python -m shadow_tpu_torch.tools.trace kern DATA_DIR       # stage report
    python -m shadow_tpu_torch.tools.trace explain DATA_DIR    # remediation
    python -m shadow_tpu_torch.tools.trace --run sim.yaml      # run + summarize
    python -m shadow_tpu_torch.tools.trace --smoke [--hosts N] # smoke

The summary prints the sim-time channel's records (rounds, spans by
family, aborts), the eligibility report (one reason a conservative
round; the counts sum to the round total) and the wall-time phases, and
`--chrome` writes the Chrome trace-event JSON (trace/chrome.py).
`net` prints the drop attribution with its conservation verdict (the
wire causes sum to packets_dropped) and the top connections by
retransmits from telemetry-sim.bin; `fabric` the byte-conservation
verdict and the top links by peak queue depth from fabric-sim.bin;
`fct` the flow-completion-time percentiles per flow class; `kern` the
kernel observatory's per-stage table with the fires-vs-micro-iterations
conservation verdict and the stages that own each family's device
slope; `explain` maps the eligibility audit's top blockers to
remediation hints.  Each report reads only the directory's files and
returns its verdict, the subcommand's exit code; its text is the
reference's, character for character.

`--run` and `--smoke` run simulations: under `scheduler: tpu` on the
card unless `--device cpu` asks for the CPU (no silent CPU fallback).
`--smoke` runs the reference's two simulated legs: a 50-host traced TCP
stream (summary, drops, fabric, FCT, explain, Chrome tracks) and an
8-LP PHOLD with forced device spans and the kernel observatory on
(`kern` conserves, a per-stage counter track).  Its managed-process leg,
the `sys` report and `explain`'s join with the syscall channel need the
managed processes' syscall observability (ROADMAP A7b-2) and raise
NotImplementedError.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import yaml

from shadow_tpu_torch.net.graph import NetworkGraph, format_ip
from shadow_tpu_torch.trace.audit import render_report
from shadow_tpu_torch.trace.chrome import (DEFAULT_TOP_N, PID_FABRIC,
                                           PID_KERN, chrome_trace)
from shadow_tpu_torch.trace.events import (FLIGHT_REC_BYTES, FR_FAULT_KILL,
                                           FR_FAULT_QUARANTINE, FR_ROUND,
                                           FR_SPAN_ABORT, FR_SPAN_COMMIT,
                                           FR_SPAN_START, KS_REC_BYTES,
                                           TEL_NAMES, TEL_REC_BYTES,
                                           TEL_WIRE_N, iter_fb_records,
                                           iter_fct_records, iter_records,
                                           split_fabric)
from shadow_tpu_torch.trace.fabricstat import (fct_table, group_by_host,
                                               top_by_peak_depth)
from shadow_tpu_torch.trace.kernstat import (DISPATCH_KEYS, attribution,
                                             check_conservation,
                                             family_label, family_totals,
                                             family_warm_wall_s,
                                             low_occupancy_stages,
                                             render_table)
from shadow_tpu_torch.trace.netstat import group_by_conn, top_by_retransmits


def _load(data_dir: str):
    stats_path = os.path.join(data_dir, "sim-stats.json")
    if not os.path.exists(stats_path):
        raise FileNotFoundError(
            f"{stats_path} not found — not a simulation data dir?")
    with open(stats_path) as f:
        stats = json.load(f)
    sim_bytes = b""
    sim_path = os.path.join(data_dir, "flight-sim.bin")
    if os.path.exists(sim_path):
        with open(sim_path, "rb") as f:
            sim_bytes = f.read()
    wall = None
    wall_path = os.path.join(data_dir, "flight-wall.json")
    if os.path.exists(wall_path):
        with open(wall_path) as f:
            wall = json.load(f)
    tel_bytes = b""
    tel_path = os.path.join(data_dir, "telemetry-sim.bin")
    if os.path.exists(tel_path):
        with open(tel_path, "rb") as f:
            tel_bytes = f.read()
    sc_bytes = b""
    sc_path = os.path.join(data_dir, "syscalls-sim.bin")
    if os.path.exists(sc_path):
        with open(sc_path, "rb") as f:
            sc_bytes = f.read()
    fab_bytes = b""
    fab_path = os.path.join(data_dir, "fabric-sim.bin")
    if os.path.exists(fab_path):
        with open(fab_path, "rb") as f:
            fab_bytes = f.read()
    return stats, sim_bytes, wall, tel_bytes, sc_bytes, fab_bytes


def summarize(data_dir: str, chrome_out: str | None = None,
              out=None) -> bool:
    """Print the trace summary + eligibility report; write the Chrome
    export when asked.  Returns True when the eligibility counts
    account for 100% of rounds."""
    if out is None:
        out = sys.stdout  # resolved at call time (pytest capsys swaps it)

    stats, sim_bytes, wall, tel_bytes, sc_bytes, fab_bytes = \
        _load(data_dir)
    rounds = stats.get("rounds", 0)
    metrics = stats.get("metrics", {})
    elig = metrics.get("wall", {}).get("eligibility", {})

    print(f"trace summary for {data_dir}", file=out)
    print(f"  rounds {rounds}, packets {stats.get('packets_sent', 0)}, "
          f"events {stats.get('events', 0)}, sim end "
          f"{stats.get('end_time_ns', 0) / 1e9:.3f}s", file=out)

    if sim_bytes:
        kinds = {FR_ROUND: 0, FR_SPAN_START: 0, FR_SPAN_COMMIT: 0,
                 FR_SPAN_ABORT: 0}
        span_rounds = 0
        for _t, kind, _a, _b, c in iter_records(sim_bytes):
            kinds[kind] = kinds.get(kind, 0) + 1
            if kind == FR_SPAN_COMMIT:
                span_rounds += c
        n_recs = len(sim_bytes) // FLIGHT_REC_BYTES
        n_faults = sum(n for k, n in kinds.items()
                       if FR_FAULT_KILL <= k <= FR_FAULT_QUARANTINE)
        fault_s = f", {n_faults} fault injections" if n_faults else ""
        print(f"  sim-time channel: {n_recs} records "
              f"({kinds[FR_ROUND]} round, {kinds[FR_SPAN_COMMIT]} span "
              f"commits covering {span_rounds} rounds, "
              f"{kinds[FR_SPAN_ABORT]} aborts{fault_s})", file=out)
    else:
        print("  sim-time channel: absent (run with "
              "experimental.flight_recorder: on)", file=out)

    ok = bool(elig) and sum(elig.values()) == rounds
    if elig:
        print(render_report(elig, rounds), file=out)
    else:
        print("  (no eligibility block in sim-stats.json — pre-trace "
              "artifact?)", file=out)

    phases = metrics.get("wall", {}).get("phases")
    if phases:
        print("wall-time phases:", file=out)
        for name, ns in sorted(phases.items(), key=lambda kv: -kv[1]):
            print(f"  {name:<16} {ns / 1e9:10.3f}s", file=out)

    ks_bytes = _kern_bytes(data_dir)
    if ks_bytes:
        print(f"  device-kernel observatory: "
              f"{len(ks_bytes) // KS_REC_BYTES} committed-span "
              f"records (`trace kern` for the per-stage table)",
              file=out)

    if chrome_out is not None:
        fb = b""
        if fab_bytes:
            fb, _fct = split_fabric(fab_bytes)
        top_n = _chrome_top_n(data_dir)
        doc = chrome_trace(sim_bytes, wall, tel_bytes, sc_bytes, fb,
                           top_n, ks_bytes=ks_bytes)
        with open(chrome_out, "w") as f:
            json.dump(doc, f)
        print(f"chrome trace: {chrome_out} "
              f"({len(doc['traceEvents'])} events — load in Perfetto "
              f"or chrome://tracing)", file=out)
    return ok


def drop_report(stats: dict, out=None) -> bool:
    """The drop-attribution table + conservation check.  Returns True
    when every wire drop is attributed and the causes sum exactly to
    packets_dropped."""
    if out is None:
        out = sys.stdout

    drops = stats.get("metrics", {}).get("sim", {}).get(
        "netstat", {}).get("drops", {})
    total = stats.get("packets_dropped", 0)
    wire = set(TEL_NAMES[:TEL_WIRE_N])
    print("packet-drop attribution (one cause per drop):", file=out)
    wire_sum = 0
    width = max([len(k) for k in drops] + [16])
    for name, n in sorted(drops.items(), key=lambda kv: -kv[1]):
        kind = "wire" if name in wire else (
            "tcp-discard" if name != "unattributed" else "GAP")
        print(f"  {name:<{width}}  {n:>10}  [{kind}]", file=out)
        if name in wire:
            wire_sum += n
    ok = wire_sum == total and "unattributed" not in drops
    if ok:
        print(f"  {'total (wire)':<{width}}  {wire_sum:>10}  "
              f"== packets_dropped ({total}): conserved", file=out)
    else:
        print(f"  total (wire) {wire_sum} != packets_dropped {total} "
              f"— ATTRIBUTION GAP", file=out)
    return ok


def net_report(data_dir: str, top_n: int = 10, out=None) -> bool:
    """`trace net`: drop attribution + the top-N connection table
    from telemetry-sim.bin.  Returns the conservation verdict."""
    if out is None:
        out = sys.stdout

    stats, _sim, _wall, tel_bytes, _sc, _fab = _load(data_dir)
    ok = drop_report(stats, out=out)

    if not tel_bytes:
        print("sim-netstat channel: absent (run with "
              "experimental.sim_netstat: on)", file=out)
        return ok
    by_conn = group_by_conn(tel_bytes)
    n_recs = len(tel_bytes) // TEL_REC_BYTES
    print(f"sim-netstat: {n_recs} samples over {len(by_conn)} "
          f"connections", file=out)
    ranked = top_by_retransmits(by_conn, top_n)
    print(f"top {len(ranked)} connections by retransmits:", file=out)
    print(f"  {'connection':<32} {'rtx':>6} {'sack':>5} "
          f"{'marks':>6} {'srtt ms':>8} {'cwnd kB':>8} {'sndbuf':>8} "
          f"{'rcvbuf':>8}", file=out)
    for key in ranked:
        host, lport, rport, rip = key
        recs = by_conn[key]
        last = recs[-1]
        name = f"h{host}:{lport}->{format_ip(rip)}:{rport}"
        print(f"  {name:<32} {last[13]:>6} {last[14]:>5} "
              f"{last[15]:>6} "
              f"{last[8] / 1e6:>8.2f} {last[6] / 1024:>8.1f} "
              f"{max(r[11] for r in recs):>8} "
              f"{max(r[12] for r in recs):>8}", file=out)
    return ok


def _chrome_top_n(data_dir: str) -> int:
    """The experimental.chrome_top_n knob from the processed config
    (shared by every per-entity counter-track family)."""
    exp = _processed_config(data_dir).get("experimental") or {}
    try:
        return max(int(exp.get("chrome_top_n", DEFAULT_TOP_N)), 1)
    except (TypeError, ValueError):
        return DEFAULT_TOP_N


def fabric_report(data_dir: str, top_n: int = 10, out=None) -> bool:
    """`trace fabric`: per-link utilization + queue-depth table +
    the byte-conservation verdict.  Returns False on a conservation
    violation (the gate's exit code)."""
    if out is None:
        out = sys.stdout

    stats, _sim, _wall, _tel, _sc, fab_bytes = _load(data_dir)
    fab = stats.get("metrics", {}).get("sim", {}).get("fabric", {})
    viol = fab.get("violations")
    print("fabric observatory (per-interface byte conservation):",
          file=out)
    for key in ("enqueued_pkts", "delivered_pkts", "dropped_pkts",
                "queued_pkts", "enqueued_bytes", "delivered_bytes",
                "dropped_bytes", "queued_bytes", "peak_queue_depth",
                "refill_stalls", "marked_pkts"):
        if key in fab:
            print(f"  {key:<18} {fab[key]:>14}", file=out)
    marks = fab.get("marks") or {}
    for cause, n in sorted(marks.items()):
        print(f"    mark:{cause:<12} {n:>14}", file=out)
    ok = viol == 0
    if viol is None:
        print("  (no fabric block in sim-stats.json — pre-fabric "
              "artifact?)", file=out)
        ok = False
    elif ok:
        print("  conservation: enqueued == delivered + dropped + "
              "queued on every interface, drops reconciled against "
              "the TEL_* causes", file=out)
    else:
        print(f"  conservation: {viol} interface(s) VIOLATED — bytes "
              f"lost outside the attributed drop causes", file=out)

    if not fab_bytes:
        print("fabric channel: absent (run with "
              "experimental.sim_fabricstat: on)", file=out)
        return ok
    fb, _fct = split_fabric(fab_bytes)
    by_host = group_by_host(fb)
    n_recs = sum(len(v) for v in by_host.values())
    print(f"fabric channel: {n_recs} samples over {len(by_host)} "
          f"links", file=out)
    # sim duration for the utilization column (end of the last sample)
    end_ns = max((r[0] for r in iter_fb_records(fb)), default=0)
    ranked = top_by_peak_depth(by_host, top_n)
    print(f"top {len(ranked)} links by peak queue depth:", file=out)
    print(f"  {'link':<8} {'peak q':>7} {'max soj ms':>11} "
          f"{'drops':>7} {'marks':>7} {'stalls':>7} {'util %':>7}",
          file=out)
    cfg = _processed_config(data_dir)
    names = _host_names(cfg)
    bw_up = _host_bw_table(cfg, names)
    for host in ranked:
        recs = by_host[host]
        last = recs[-1]
        peak = max(r[3] for r in recs)
        soj = max(r[5] for r in recs) / 1e6
        stalls = last[10] + last[12]
        bw = bw_up[host] if 0 <= host < len(bw_up) else 0
        util = (f"{100.0 * last[14] * 8 / (bw * end_ns / 1e9):7.1f}"
                if end_ns and bw else f"{'-':>7}")
        label = names[host] if 0 <= host < len(names) else f"h{host}"
        print(f"  {label:<8.8} {peak:>7} {soj:>11.2f} "
              f"{last[7]:>7} {last[8]:>7} {stalls:>7} {util}",
              file=out)
    return ok


def _host_bw_table(cfg: dict, names: list) -> list:
    """Host-id -> uplink bits/s from the processed config: the
    per-host override when present, else the graph node's
    host_bandwidth_up (the common case — every canonical generator
    sets bandwidth in the GML).  One GML parse for the whole table;
    0 when unresolvable (the utilization column then reads '-')."""
    node_bw: dict = {}
    gspec = (cfg.get("network") or {}).get("graph") or {}
    inline = gspec.get("inline")
    if gspec.get("type") == "gml" and inline:
        try:
            g = NetworkGraph.from_gml(inline)
            node_bw = {gml_id: node.bandwidth_up_bits or 0
                       for gml_id, node in g.by_gml_id.items()}
        except Exception:  # noqa: BLE001 — report-only fallback
            node_bw = {}
    out = []
    hosts = cfg.get("hosts") or {}
    for name in names:
        h = hosts.get(name) or {}
        out.append(int(h.get("bandwidth_up")
                       or node_bw.get(h.get("network_node_id"), 0)))
    return out


def fct_report(data_dir: str, out=None) -> bool:
    """`trace fct`: the flow-completion-time percentile table per
    flow class (service port).  Returns True when flow records
    exist."""
    if out is None:
        out = sys.stdout

    _stats, _sim, _wall, _tel, _sc, fab_bytes = _load(data_dir)
    if not fab_bytes:
        print("fabric channel: absent (run with "
              "experimental.sim_fabricstat: on)", file=out)
        return False
    _fb, fct_bytes = split_fabric(fab_bytes)
    rows = list(iter_fct_records(fct_bytes))
    table = fct_table(rows)
    if not table:
        print("no flow records (no TCP payload moved)", file=out)
        return False
    print(f"flow completion times ({len(rows)} endpoint records):",
          file=out)
    print(f"  {'class':>6} {'flows':>6} {'done':>5} {'MB':>9} "
          f"{'marks':>7} {'mk/1k':>6} "
          f"{'p50 ms':>9} {'p99 ms':>9} {'p999 ms':>9}", file=out)
    for cls, ent in table.items():
        print(f"  {cls:>6} {ent['flows']:>6} {ent['complete']:>5} "
              f"{ent['bytes'] / 1e6:>9.2f} "
              f"{ent['marks']:>7} {ent['mark_permille']:>6} "
              f"{ent['p50_ns'] / 1e6:>9.2f} "
              f"{ent['p99_ns'] / 1e6:>9.2f} "
              f"{ent['p999_ns'] / 1e6:>9.2f}", file=out)
    return True


def _kern_bytes(data_dir: str) -> bytes:
    """kernel-sim.bin's content (b"" when the observatory was off)."""
    path = os.path.join(data_dir, "kernel-sim.bin")
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as f:
        return f.read()


def kern_report(data_dir: str, out=None) -> bool:
    """`trace kern`: the device-kernel observatory report — per-stage
    fires/lanes/occupancy table with the attributed share of each
    family's measured device slope, the fires-vs-micro_iters
    conservation verdict, and a crossover-attribution verdict.
    Everything derives from kernel-sim.bin + sim-stats.json alone.
    Returns the conservation verdict (the gate's exit code)."""
    if out is None:
        out = sys.stdout

    stats, _sim, _wall, _tel, _sc, _fab = _load(data_dir)
    ks_bytes = _kern_bytes(data_dir)
    if not ks_bytes:
        print("device-kernel observatory: no records (run with "
              "experimental.kernel_observatory: on and a device-"
              "routed workload — e.g. tpu_device_spans: force)",
              file=out)
        # Vacuously conserved: zero committed spans, zero records.
        return True
    dispatch = stats.get("metrics", {}).get("wall", {}).get(
        "dispatch", {})
    render_table(ks_bytes, dispatch, out=out)
    dropped = stats.get("metrics", {}).get("sim", {}).get(
        "kern", {}).get("dropped", 0)
    ok, problems = check_conservation(ks_bytes, dispatch, dropped)
    if ok:
        print("conservation: committed trips reconcile exactly "
              "against dispatch micro_iters", file=out)
    else:
        print("conservation: VIOLATED", file=out)
        for p in problems[:8]:
            print(f"  {p}", file=out)
    # Crossover-attribution verdict: which stages own the family's
    # measured device slope.
    for family, ent in sorted(family_totals(ks_bytes).items()):
        wall_s = family_warm_wall_s(dispatch, family)
        att = attribution(ent, wall_s)
        ranked = sorted(att.items(),
                        key=lambda kv: -kv[1]["share_permille"])[:3]
        if not ranked:
            continue
        hr = ent["hosts"] * ent["rounds"]
        slope = wall_s * 1e6 / hr if hr else 0.0
        tops = ", ".join(
            f"{sname} ({row['share_permille'] / 10:.0f}% ~ "
            f"{row['us_per_host_round']:.2f} us)"
            for sname, row in ranked)
        print(f"crossover attribution [{family_label(family)}]: "
              f"warm slope {slope:.2f} us/host/round; dominated by "
              f"{tops}", file=out)
        low = [sname for sname, _occ in low_occupancy_stages(ent)]
        if low:
            print(f"  low-occupancy stages (<5% of lane slots): "
                  f"{', '.join(low)} — vector width mostly burns "
                  f"masked-out lanes there", file=out)
    # Overlapped-pipeline report: per-family device-idle / host-idle
    # fractions over the speculative dispatch window.
    for key in sorted(dispatch):
        if not key.startswith("device_span_"):
            continue
        ov = (dispatch.get(key) or {}).get("overlap") or {}
        if not ov.get("windows"):
            continue
        fam = key[len("device_span_"):]
        print(f"overlap [{fam}]: {ov['windows']} speculative "
              f"window(s) dispatched, {ov.get('hits', 0)} landed, "
              f"{ov.get('refusals', 0)} refused "
              f"({ov.get('stale_refusals', 0)} stale); device idle "
              f"{100.0 * float(ov.get('device_idle_frac', 0.0)):.0f}%,"
              f" host idle "
              f"{100.0 * float(ov.get('host_idle_frac', 0.0)):.0f}% "
              f"of the {ov.get('pipe_wall_s', 0.0):.3f}s pipelined "
              f"wall", file=out)
    return ok


def _processed_config(data_dir: str) -> dict:
    """The processed-config.yaml next to sim-stats.json ({} when
    absent) — the ONE parse every report shares.  Parsed with libyaml's
    loader where PyYAML has it, and kept for the next report over the
    same file (path, mtime, size): a many-thousand-host config is
    megabytes of YAML.  Callers only read the dict."""
    cfg_path = os.path.join(data_dir, "processed-config.yaml")
    if not os.path.exists(cfg_path):
        return {}
    st = os.stat(cfg_path)
    return _parse_config(os.path.realpath(cfg_path), st.st_mtime_ns,
                         st.st_size)


@functools.lru_cache(maxsize=1)
def _parse_config(path: str, _mtime_ns: int, _size: int) -> dict:
    with open(path) as f:
        return yaml.load(f, Loader=getattr(yaml, "CSafeLoader",
                                           yaml.SafeLoader)) or {}


def _host_names(cfg: dict) -> list:
    """Host-id -> name mapping: host ids follow sorted-name order
    (core/manager.py builds hosts that way), so the processed config's
    sorted host keys ARE the id order."""
    return sorted((cfg.get("hosts") or {}).keys())


def sys_report(data_dir: str, top_n: int = 10, out=None) -> bool:
    """`trace sys`: the syscall-observatory report, which reads the
    managed processes' syscall channel (ROADMAP A7b-2)."""
    raise NotImplementedError(
        "shadow_tpu_torch: `trace sys` reads the syscall channel of the "
        "managed processes, not yet ported (ROADMAP A7b-2)")


# Eligibility-blocker remediation hints (`trace explain`), keyed by
# the EL_NAMES the audit reports.  {hosts} interpolates the offending
# host list where the processed config identifies one.
_EXPLAIN = {
    "object-path:pcap": (
        "pcap capture pins these hosts to the Python object path: "
        "{hosts}.  Disable pcap_enabled on them (or accept per-round "
        "spans capped at experimental.pcap_span_cap).",),
    "object-path:cpu-model": (
        "the host CPU model (experimental.host_cpu_threshold) forces "
        "the object path: {hosts}.  Unset it to let these hosts join "
        "engine/device spans.",),
    "object-path:py-task": (
        "engine hosts briefly carried Python-side work (process "
        "spawn/shutdown tasks); normal at sim start and end.",),
    "object-path:other": (
        "a host config (e.g. strace_logging_mode) keeps these hosts "
        "off the native plane: {hosts}.",),
    "engine-span:device-off": (
        "device spans are disabled (experimental.tpu_device_spans: "
        "off); set it to auto or force.",),
    "engine-span:ineligible-family": (
        "no device-span family fits this sim's shape — the PHOLD "
        "family needs pure udp-mesh/phold apps, the TCP family needs "
        "the tgen steady-stream tier (netgen.tcp_stream_yaml).",),
    "engine-span:transient": (
        "the sim was transiently outside the TCP family's modelled "
        "domain (handshake/close stretches); steady-state rounds "
        "still reach the device.",),
    "engine-span:abort-rollback": (
        "device spans aborted (capacity or domain); see dispatch."
        "device_span_*.aborts and grow the runner caps if persistent.",),
    "engine-span:cold-budget": (
        "the device compile budget was not yet earned (1% of wall); "
        "longer runs probe and route automatically.",),
    "engine-span:routed": (
        "the router measured the C++ span faster than the device at "
        "this scale — expected on small sims or CPU backends.",),
    "engine-span:py-limit": (
        "spans were capped before windows could touch an object-path "
        "host; reduce object-path hosts to lengthen spans.",),
    "per-round:forced-device": (
        "forced-device audit mode (tpu_min_device_batch <= 0) runs "
        "every round through the jitted kernel by design.",),
    "per-round:scheduler": (
        "this scheduler has no span path; use scheduler: tpu for "
        "engine/device spans.",),
    "per-round:outbox": (
        "object-path packets were pending in the propagator outbox at "
        "the round boundary; the fabric observatory names the hottest "
        "queue below when its channel was on.",),
    "per-round:callback-host": (
        "a host can fire Python callbacks mid-event (Python-owned "
        "sockets), which excludes the whole sim from C++ spans.",),
    "engine-span:managed-quiescent": (
        "the syscall service plane's quiescence gate served these "
        "rounds inside engine spans while every managed process sat "
        "parked — this is span COVERAGE, not a blocker.",),
}


def _managed_blockers(data_dir: str, sc_bytes: bytes, out,
                      elig: dict | None = None,
                      rounds: int = 0) -> None:
    """Join the eligibility audit with the syscall channel where managed
    processes keep rounds off the span path.  A run with no managed host
    prints nothing (as the reference); one with managed hosts needs the
    managed processes' syscall channel, not yet ported."""
    cfg = _processed_config(data_dir)
    for name in _host_names(cfg):
        h = (cfg.get("hosts") or {}).get(name) or {}
        for p in h.get("processes", []) or []:
            # Managed processes are configured by filesystem path.
            if "/" in str(p.get("path", "")):
                raise NotImplementedError(
                    "shadow_tpu_torch: `trace explain` on managed hosts "
                    "reads the managed processes' syscall channel, not "
                    "yet ported (ROADMAP A7b-2)")


def _hottest_queue(data_dir: str, fab_bytes: bytes, out) -> None:
    """Join the eligibility audit with the fabric channel: when rounds
    stall on outbox pressure, name the link whose router queue peaked
    hottest (depth and head sojourn) — the congestion point to debug
    first."""
    fb, _fct = split_fabric(fab_bytes)
    by_host = group_by_host(fb)
    ranked = top_by_peak_depth(by_host, 1)
    if not ranked:
        return
    host = ranked[0]
    recs = by_host[host]
    peak = max(r[3] for r in recs)
    soj = max(r[5] for r in recs) / 1e6
    names = _host_names(_processed_config(data_dir))
    label = names[host] if 0 <= host < len(names) else f"h{host}"
    print(f"  hottest queue: {label} (router inbound peaked at "
          f"{peak} packets, {soj:.2f} ms head sojourn)", file=out)


def _kern_hints(data_dir: str, stats: dict, out) -> None:
    """Device-kernel observatory joins for `trace explain`:

    - speculative-window waste — when the rollback ledger (aborted
      dispatch wall + forced re-exports) exceeds ~10% of a family's
      device dispatch wall, name the dominant abort kind and the
      remediation;
    - overlap stall — when the overlapped pipeline's measured
      device-idle fraction exceeds 25%, the double buffer is not
      hiding the host work: point at the svc plane drains and span
      codec wall that must fit inside the in-flight window;
    - low lane occupancy — on a device-routed run, name the stages
      whose occupancy sits under ~5% and the likeliest config
      remediation (tiny dev_span_K keeps spans short and lanes idle;
      a mixed-family fleet splits lanes across kernels)."""
    dispatch = stats.get("metrics", {}).get("wall", {}).get(
        "dispatch", {})
    for fam in DISPATCH_KEYS.values():
        d = dispatch.get(f"device_span_{fam}") or {}
        wall = float(d.get("dispatch_wall_s", 0.0))
        waste = float(d.get("rollback_wall_s", 0.0)) \
            + float(d.get("rollback_reexport_wall_s", 0.0))
        if wall > 0 and waste > 0.1 * wall:
            kinds = d.get("abort_kinds") or {}
            top = max(kinds, key=kinds.get) if kinds else "abort"
            label = {"struct": "AB_STRUCT (domain departure)",
                     "exchange-capacity": "AB_EXCH (exchange "
                     "capacity)"}.get(top, f"capacity ({top})")
            print(f"  speculative-window waste [{fam}]: "
                  f"{100.0 * waste / wall:.0f}% of the device "
                  f"dispatch wall rolled back unused "
                  f"({d.get('rolled_back_rounds', 0)} rounds; "
                  f"dominant abort: {label}).  Shrink the "
                  f"speculation pressure (smaller initial dev_span_K)"
                  f" or pre-size the aborting capacity "
                  f"(tpu_exchange_capacity / ring caps) so spans "
                  f"commit first try.", file=out)
        ov = d.get("overlap") or {}
        if ov.get("windows") and \
                float(ov.get("device_idle_frac", 0.0)) > 0.25:
            print(f"  overlap stall [{fam}]: device idle "
                  f"{100.0 * float(ov['device_idle_frac']):.0f}% of "
                  f"the pipelined wall — pipeline not overlapping — "
                  f"check svc plane workers / codec wall (the host-"
                  f"side drains and span codec conversion must fit "
                  f"inside the in-flight window), or raise "
                  f"dev_span_k_init so each window is long enough to "
                  f"hide the host work.", file=out)
    ks_bytes = _kern_bytes(data_dir)
    if not ks_bytes:
        return
    for family, ent in sorted(family_totals(ks_bytes).items()):
        low = low_occupancy_stages(ent)
        if not low:
            continue
        worst = min(low, key=lambda kv: kv[1])
        spans = max(ent["spans"], 1)
        fam = family_label(family)
        print(f"  low lane occupancy [{fam}]: stage "
              f"'{worst[0]}' ran at {worst[1] / 10:.1f}% of its "
              f"{ent['hosts']}-lane width "
              f"({len(low)} stage(s) under 5%).  Likeliest "
              f"remediations: larger spans amortize idle iterations "
              f"(rounds/span is {ent['rounds'] // spans} — a tiny "
              f"dev_span_K or frequent boundaries keeps it low), or "
              f"the fleet mixes families so each kernel sees only "
              f"part of the host axis.", file=out)


def explain_report(data_dir: str, out=None) -> bool:
    """`trace explain`: top eligibility blockers -> remediation."""
    if out is None:
        out = sys.stdout
    stats, _sim, _wall, _tel, sc_bytes, fab_bytes = _load(data_dir)
    elig = stats.get("metrics", {}).get("wall", {}).get(
        "eligibility", {})
    rounds = stats.get("rounds", 0)
    if not elig:
        print("no eligibility block in sim-stats.json (pre-trace "
              "artifact?)", file=out)
        return False

    # Offending hosts per object-path cause, from the processed
    # config written next to sim-stats.json.
    pcap_hosts, cpu_hosts, other_hosts = [], [], []
    cfg = _processed_config(data_dir)
    for name, h in sorted((cfg.get("hosts") or {}).items()):
        if (h or {}).get("pcap_enabled"):
            pcap_hosts.append(name)
    if (cfg.get("experimental") or {}).get("host_cpu_threshold"):
        cpu_hosts = _host_names(cfg)
    hosts_of = {"object-path:pcap": pcap_hosts,
                "object-path:cpu-model": cpu_hosts,
                "object-path:other": other_hosts}

    device = elig.get("device-span", 0)
    print(f"device-span coverage: {device}/{rounds} rounds; top "
          f"blockers and remediation:", file=out)
    shown = 0
    managed_shown = False
    for name, n in sorted(elig.items(), key=lambda kv: -kv[1]):
        if name == "device-span":
            continue
        hint = _EXPLAIN.get(name)
        hosts = ", ".join(hosts_of.get(name, [])[:8]) or "(see config)"
        text = (hint[0].format(hosts=hosts) if hint
                else "no registered remediation for this reason.")
        pct = 100.0 * n / rounds if rounds else 0.0
        print(f"  {name} — {n} rounds ({pct:.1f}%)", file=out)
        print(f"      {text}", file=out)
        if not managed_shown and name in (
                "object-path:other", "object-path:py-task",
                "per-round:callback-host", "per-round:scheduler",
                "engine-span:py-limit",
                "engine-span:managed-quiescent"):
            # These are the reasons managed processes cause: join the
            # audit with the syscall channel, print the quiescence
            # fraction and name the offenders.
            _managed_blockers(data_dir, sc_bytes, out, elig=elig,
                              rounds=rounds)
            managed_shown = True
        if name == "per-round:outbox" and fab_bytes:
            # Rounds stalled on outbox pressure: name the hottest
            # queue (audit join with the fabric channel).
            _hottest_queue(data_dir, fab_bytes, out)
        shown += 1
        if shown >= 6:
            break
    if not shown:
        print("  (every round ran on the device — nothing to "
              "remediate)", file=out)
    # Kernel-observatory joins: speculative-window waste and low lane
    # occupancy, from the dispatch block and kernel-sim.bin.
    _kern_hints(data_dir, stats, out)
    return True


def run_config(config_path: str, data_dir: str | None = None,
               device: str = "cuda") -> str:
    """Run a YAML config with the flight recorder on (under `scheduler:
    tpu` on `device`); returns the data directory."""
    from shadow_tpu_torch.core.config import ConfigOptions
    from shadow_tpu_torch.core.manager import run_simulation

    config = ConfigOptions.from_file(config_path)
    config.experimental.flight_recorder = "on"
    if data_dir is not None:
        config.general.data_directory = data_dir
    _manager, summary = run_simulation(config, device=device,
                                       write_data=True)
    if not summary.ok:
        for err in summary.plugin_errors:
            print(f"[trace] plugin error: {err}", file=sys.stderr)
    return config.general.data_directory


def smoke_managed() -> int:
    """The managed-process smoke leg: a real binary under the shim."""
    raise NotImplementedError(
        "shadow_tpu_torch: the managed-process smoke leg reads the "
        "syscall observability, not yet ported (ROADMAP A7b-2)")


def smoke_kern(device: str = "cuda") -> int:
    """The kernel observatory's smoke leg: an 8-LP PHOLD fleet with
    forced device spans and the observatory on — the per-stage counters
    must conserve against micro_iters (`trace kern` exits ok, with a
    non-empty table) and the Chrome export must carry a non-empty
    per-stage counter track."""
    import tempfile

    from shadow_tpu_torch.core.config import ConfigOptions
    from shadow_tpu_torch.core.manager import run_simulation
    from shadow_tpu_torch.tools.netgen import phold_yaml

    with tempfile.TemporaryDirectory() as td:
        base = os.path.join(td, "kern-smoke")
        text = phold_yaml(8, n_init=2, mean_delay_ns=20_000_000,
                          stop_time="1s", seed=13, scheduler="tpu",
                          device_spans="force")
        config = ConfigOptions.from_yaml_text(text)
        config.experimental.kernel_observatory = "on"
        config.experimental.flight_recorder = "on"
        config.general.data_directory = base
        _manager, summary = run_simulation(config, device=device,
                                           write_data=True)
        if not summary.ok:
            print(f"trace smoke: kern sim failed: "
                  f"{summary.plugin_errors}", file=sys.stderr)
            return 1
        ks = _kern_bytes(base)
        if not ks:
            print("trace smoke: kernel observatory recorded nothing "
                  "(device spans never committed?)", file=sys.stderr)
            return 1
        if not kern_report(base):
            print("trace smoke: kernel-channel conservation violated",
                  file=sys.stderr)
            return 1
        _stats, sim_bytes, wall, _tel, _sc, _fab = _load(base)
        doc = chrome_trace(sim_bytes, wall, ks_bytes=ks)
        counters = [e for e in doc["traceEvents"]
                    if e.get("ph") == "C" and e.get("pid") == PID_KERN]
        if not counters:
            print("trace smoke: chrome export has no per-stage kernel "
                  "counter track", file=sys.stderr)
            return 1
    print(f"trace smoke: kern leg ok (fires conserve, "
          f"{len(counters)} stage counter events)")
    return 0


def smoke(n_hosts: int, device: str = "cuda") -> int:
    """A traced tgen TCP tier of `n_hosts`: summary + eligibility must
    render and account for every round, the drop-cause counters must
    conserve, the fabric must conserve, and the Chrome export must carry
    slices, a per-connection and a per-link counter track.  Then the
    kernel observatory's leg (`smoke_kern`).  The last line gives the
    span kernels' launches in this process (0 on the CPU, where the
    plain loops run)."""
    import tempfile

    from shadow_tpu_torch.core.config import ConfigOptions
    from shadow_tpu_torch.core.manager import run_simulation
    from shadow_tpu_torch.ops.phold_span_kernel import PHOLD_SPAN
    from shadow_tpu_torch.ops.tcp_span_kernel import TCP_SPAN
    from shadow_tpu_torch.tools.netgen import tcp_stream_yaml

    with tempfile.TemporaryDirectory() as td:
        base = os.path.join(td, "trace-smoke")
        # The default nbytes keeps every client mid-stream at stop_time.
        text = tcp_stream_yaml(n_hosts, loss=0.005, stop_time="2s",
                               seed=11, scheduler="tpu")
        config = ConfigOptions.from_yaml_text(text)
        config.experimental.flight_recorder = "on"
        config.experimental.sim_netstat = "on"
        config.experimental.sim_fabricstat = "on"
        config.general.data_directory = base
        _manager, summary = run_simulation(config, device=device,
                                           write_data=True)
        if not summary.ok:
            print(f"trace smoke: sim failed: {summary.plugin_errors}",
                  file=sys.stderr)
            return 1
        chrome_out = os.path.join(base, "chrome-trace.json")
        ok = summarize(base, chrome_out=chrome_out)
        if not ok:
            print("trace smoke: eligibility report did not account "
                  "for all rounds", file=sys.stderr)
            return 1
        if not net_report(base):
            print("trace smoke: drop-cause counters do not conserve",
                  file=sys.stderr)
            return 1
        if not fabric_report(base):
            print("trace smoke: fabric byte-conservation violated",
                  file=sys.stderr)
            return 1
        fct_report(base)
        explain_report(base)
        with open(chrome_out) as f:
            doc = json.load(f)
        slices = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        if not slices:
            print("trace smoke: chrome export has no slices",
                  file=sys.stderr)
            return 1
        counters = [e for e in doc["traceEvents"]
                    if e.get("ph") == "C"]
        if not counters:
            print("trace smoke: chrome export has no sim-netstat "
                  "counter track", file=sys.stderr)
            return 1
        fab_counters = [e for e in doc["traceEvents"]
                        if e.get("ph") == "C"
                        and e.get("pid") == PID_FABRIC]
        if not fab_counters:
            print("trace smoke: chrome export has no per-link fabric "
                  "counter track", file=sys.stderr)
            return 1
    print(f"trace smoke: ok ({n_hosts} hosts, {summary.rounds} rounds "
          f"fully attributed, drops conserved, "
          f"{len(counters)} counter events)")
    rc = smoke_kern(device)
    if rc:
        return rc
    print("trace smoke: managed leg not run (it reads the syscall "
          "observability, ROADMAP A7b-2)")
    print("trace smoke: span kernel launches "
          + json.dumps({"stt_tcp_span": TCP_SPAN.launches,
                        "stt_phold_span": PHOLD_SPAN.launches}))
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in ("net", "explain", "sys", "fabric", "fct",
                            "kern"):
        # Subcommands: `trace net DATA_DIR [--top N]`,
        #              `trace sys DATA_DIR [--top N]`,
        #              `trace fabric DATA_DIR [--top N]`,
        #              `trace fct DATA_DIR`,
        #              `trace kern DATA_DIR`,
        #              `trace explain DATA_DIR`.
        sub = argparse.ArgumentParser(
            prog=f"shadow_tpu_torch.tools.trace {argv[0]}")
        sub.add_argument("data_dir")
        if argv[0] in ("net", "sys", "fabric"):
            sub.add_argument("--top", type=int, default=10,
                             help="rows in the report (default 10)")
        sargs = sub.parse_args(argv[1:])
        if argv[0] == "net":
            return 0 if net_report(sargs.data_dir,
                                   top_n=sargs.top) else 1
        if argv[0] == "sys":
            return 0 if sys_report(sargs.data_dir,
                                   top_n=sargs.top) else 1
        if argv[0] == "fabric":
            return 0 if fabric_report(sargs.data_dir,
                                      top_n=sargs.top) else 1
        if argv[0] == "fct":
            return 0 if fct_report(sargs.data_dir) else 1
        if argv[0] == "kern":
            return 0 if kern_report(sargs.data_dir) else 1
        return 0 if explain_report(sargs.data_dir) else 1

    ap = argparse.ArgumentParser(prog="shadow_tpu_torch.tools.trace",
                                 description=__doc__)
    ap.add_argument("data_dir", nargs="?",
                    help="data directory of a flight-recorded run")
    ap.add_argument("--run", metavar="CONFIG",
                    help="run this YAML config with the flight "
                         "recorder on, then summarize")
    ap.add_argument("--chrome", metavar="OUT",
                    help="write Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the 50-host traced smoke sim and exit "
                         "nonzero unless the report renders")
    ap.add_argument("--hosts", type=int, default=50,
                    help="host count for --smoke (default 50)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where --run and --smoke run the tpu "
                         "scheduler's device work (default: cuda)")
    args = ap.parse_args(argv)

    if args.smoke:
        return smoke(args.hosts, args.device)
    if args.run is not None:
        data_dir = run_config(args.run, args.data_dir, args.device)
    elif args.data_dir is not None:
        data_dir = args.data_dir
    else:
        ap.print_usage(sys.stderr)
        print("trace: a data directory, --run, or --smoke is required",
              file=sys.stderr)
        return 2
    ok = summarize(data_dir, chrome_out=args.chrome)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
