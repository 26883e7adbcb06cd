"""Deterministic workload config generation (the port's copy of the
TCP stream, incast, UDP mesh and PHOLD generators in
`shadow_tpu/tools/netgen.py`).

Everything is derived from the arguments with pure integer arithmetic,
so the port and the JAX package generate byte-identical YAML for the
same call (tests/test_torch_tcp_span.py and
tests/test_torch_phold_span.py pin it).
"""

from __future__ import annotations


def full_mesh_gml(n_nodes: int, bw: str = "100 Mbit",
                  base_latency_us: int = 2000, step_us: int = 500,
                  loss: float = 0.02) -> str:
    """Fully-connected GML graph with varied latencies and a sprinkling
    of lossy edges (every edge with (i+j) % 5 == 0), plus self-edges."""
    lines = ["graph [ directed 0"]
    for i in range(n_nodes):
        lines.append(f'  node [ id {i} host_bandwidth_down "{bw}" '
                     f'host_bandwidth_up "{bw}" ]')
    for i in range(n_nodes):
        lines.append(f'  edge [ source {i} target {i} latency "500 us" ]')
    for i in range(n_nodes):
        for j in range(i + 1, n_nodes):
            lat = base_latency_us + ((i * 7 + j * 13) % 17) * step_us
            lossy = f" packet_loss {loss}" if loss and (i + j) % 5 == 0 else ""
            lines.append(f'  edge [ source {i} target {j} '
                         f'latency "{lat} us"{lossy} ]')
    lines.append("]")
    return "\n".join(lines)


def _indent(text: str, pad: str) -> str:
    return "\n".join(pad + line for line in text.splitlines())


def _tcp_line(tcp: dict | None) -> str:
    """One per-host `tcp:` block line (or nothing): every TCP
    generator threads this through so any workload can run under
    either congestion controller — e.g. tcp={"cc": "dctcp",
    "ecn": "on"}."""
    if not tcp:
        return ""
    cc = tcp.get("cc", "reno")
    ecn = tcp.get("ecn", "off")
    if isinstance(ecn, bool):
        ecn = "on" if ecn else "off"
    return f"    tcp: {{ cc: {cc}, ecn: {ecn} }}\n"


def tcp_stream_yaml(n_hosts: int, n_servers: int | None = None,
                    nbytes: int = 50_000_000, loss: float = 0.01,
                    latency: str = "10 ms", bw_down: str = "50 Mbit",
                    bw_up: str = "50 Mbit", stop_time: str = "4s",
                    seed: int = 11, scheduler: str = "serial",
                    device_spans: str | None = None,
                    tcp: dict | None = None) -> str:
    """Fixed-connection TCP streaming tier: every client opens ONE
    connection (count=1, synchronized starts, no accept churn) and the
    transfer is sized to still be streaming at stop_time — so after the
    handshake prefix the whole sim is steady-state bulk transfer:
    cwnd/ssthresh dynamics, SACK, RTO and delack/persist timers on a
    lossy edge.  This is the TCP device-span family's workload
    (ops/tcp_span.py; the multichip dryrun and bench[tcp-dev] rungs).
    Buffer autotuning is off so windows — and with them the SoA ring
    caps — stay bounded."""
    if n_servers is None:
        n_servers = max(1, n_hosts // 8)
    names = [f"srv{i:03d}" for i in range(n_servers)]
    loss_s = f" packet_loss {loss}" if loss else ""
    gml = (f'graph [ node [ id 0 host_bandwidth_down "{bw_down}" '
           f'host_bandwidth_up "{bw_up}" ] '
           f'edge [ source 0 target 0 latency "{latency}"{loss_s} ] ]')
    tl = _tcp_line(tcp)
    blocks = []
    for name in names:
        blocks.append(
            f"  {name}:\n    network_node_id: 0\n{tl}    processes:\n"
            f'      - {{ path: tgen-server, args: ["8080"], '
            f"expected_final_state: running }}")
    for i in range(n_hosts - n_servers):
        server = names[i % n_servers]
        blocks.append(
            f"  cli{i:04d}:\n    network_node_id: 0\n{tl}    processes:\n"
            f'      - {{ path: tgen-client, '
            f'args: [{server}, "8080", "{nbytes}", "1"], '
            f"start_time: 100ms, expected_final_state: running }}")
    exp = [f"  scheduler: {scheduler}",
           "  socket_send_autotune: false",
           "  socket_recv_autotune: false"]
    if device_spans is not None:
        exp.append(f"  tpu_device_spans: {device_spans}")
    return (f"general: {{ stop_time: {stop_time}, seed: {seed} }}\n"
            f"network:\n  graph:\n    type: gml\n    inline: |\n"
            f"{_indent(gml, '      ')}\n"
            f"experimental:\n" + "\n".join(exp) + "\n"
            f"hosts:\n" + "\n".join(blocks) + "\n")


def udp_mesh_yaml(n_hosts: int, n_nodes: int = 8, floods_per_host: int = 3,
                  count: int = 6, size: int = 600, stop_time: str = "10s",
                  seed: int = 1, scheduler: str = "serial",
                  experimental_extra: dict | None = None,
                  gml: str | None = None, pcap_hosts: int = 0,
                  object_hosts: int = 0,
                  data_directory: str | None = None) -> str:
    """N-host UDP traffic mesh: every host runs one udp-sink (runs until
    sim end) and `floods_per_host` udp-flood senders at staggered starts.
    Final process states are loss-independent (floods always exit 0), so
    the byte-diff gate is the packet trace alone."""
    if gml is None:
        gml = full_mesh_gml(n_nodes)
    exp_lines = [f"  scheduler: {scheduler}"]
    for k, v in (experimental_extra or {}).items():
        exp_lines.append(f"  {k}: {v}")
    names = [f"host{i:05d}" for i in range(n_hosts)]
    base_offsets = (1, 5, 11, 23, 47, 95)
    if floods_per_host > len(base_offsets):
        raise ValueError(f"floods_per_host > {len(base_offsets)} "
                         f"not supported (got {floods_per_host})")
    offsets = base_offsets[:floods_per_host]
    host_blocks = []
    for i, name in enumerate(names):
        procs = [f'      - {{ path: udp-sink, args: ["9000"], '
                 f'expected_final_state: running }}']
        for k, off in enumerate(offsets):
            peer = names[(i + off) % n_hosts]
            start_ms = 1000 + ((i * 31 + k * 157) % 1000)
            procs.append(
                f'      - {{ path: udp-flood, '
                f'args: [{peer}, "9000", "{count}", "{size}"], '
                f'start_time: {start_ms} ms }}')
        extra_opts = ""
        if i < pcap_hosts:
            extra_opts += "    pcap_enabled: true\n"
        if i < object_hosts:
            extra_opts += "    native_dataplane: false\n"
        host_blocks.append(
            f"  {name}:\n    network_node_id: {i % n_nodes}\n"
            + extra_opts + f"    processes:\n" + "\n".join(procs))
    datadir = (f', data_directory: "{data_directory}"'
               if data_directory else "")
    return (f"general: {{ stop_time: {stop_time}, seed: {seed}{datadir} }}\n"
            f"network:\n  graph:\n    type: gml\n    inline: |\n"
            f"{_indent(gml, '      ')}\n"
            f"experimental:\n" + "\n".join(exp_lines) + "\n"
            f"hosts:\n" + "\n".join(host_blocks) + "\n")


def phold_args(i: int, names: list[str], n_init: int,
               mean_delay_ns: int,
               peers_per_host: int | None = None) -> list[str]:
    """One PHOLD LP's argv — the single source of the peer law
    (next-k ring neighbors, full mesh by default) and the phold arg
    layout, shared by phold_yaml and the bench dict builders."""
    n = len(names)
    if peers_per_host is not None:
        k = min(peers_per_host, n - 1)
        peers = [names[(i + 1 + j) % n] for j in range(k)]
    else:
        peers = [p for p in names if p != names[i]]
    return ["7000", str(i), str(n_init), str(mean_delay_ns)] + peers


def phold_yaml(n_hosts: int, n_init: int = 3,
               mean_delay_ns: int = 20_000_000, stop_time: str = "2s",
               seed: int = 13, scheduler: str = "serial",
               device_spans: str | None = None,
               bandwidth: str = "1 Gbit", latency: str = "5 ms",
               peers_per_host: int | None = None) -> str:
    """Classic PHOLD (ref: src/test/phold): every host one LP bouncing
    messages to pseudo-random peers after pseudo-exponential holds.
    peers_per_host bounds each LP's peer list to its next-k ring
    neighbors (full mesh by default) — above ~10k LPs a full n^2 peer
    matrix no longer fits anything."""
    names = [f"lp{i:04d}" for i in range(n_hosts)]
    blocks = []
    for i, name in enumerate(names):
        args = " ".join(phold_args(i, names, n_init, mean_delay_ns,
                                   peers_per_host))
        blocks.append(
            f"  {name}:\n    network_node_id: 0\n    processes:\n"
            f'      - {{ path: phold, args: "{args}", '
            f"start_time: 100ms, "
            f"expected_final_state: running }}")
    exp = [f"  scheduler: {scheduler}"]
    if device_spans is not None:
        exp.append(f"  tpu_device_spans: {device_spans}")
    gml = (f'graph [ node [ id 0 host_bandwidth_down "{bandwidth}" '
           f'host_bandwidth_up "{bandwidth}" ] '
           f'edge [ source 0 target 0 latency "{latency}" ] ]')
    return (f"general: {{ stop_time: {stop_time}, seed: {seed} }}\n"
            f"network:\n  graph:\n    type: gml\n    inline: |\n"
            f"{_indent(gml, '      ')}\n"
            f"experimental:\n" + "\n".join(exp) + "\n"
            f"hosts:\n" + "\n".join(blocks) + "\n")


def mesh_family_yaml(n_hosts: int, count: int = 30, size: int = 400,
                     bw_down: str = "1 Mbit", bw_up: str = "1 Mbit",
                     loss: float = 0.02, latency: str = "10 ms",
                     sbuf: str = "8 KiB", seed: int = 29,
                     stop_time: str = "30s", scheduler: str = "serial",
                     device_spans: str | None = None) -> str:
    """Paced udp-mesh: every host ONE udp-mesh process (main sink +
    sender thread over a shared bound socket), bandwidth-paced so the
    sim spans many windows — the device-span mesh-family workload
    (tests/test_phold_span.py and the multichip dryrun share it)."""
    names = [f"m{i:02d}" for i in range(n_hosts)]
    blocks = []
    for name in names:
        peers = " ".join(p for p in names if p != name)
        blocks.append(
            f"  {name}:\n    network_node_id: 0\n    processes:\n"
            f'      - {{ path: udp-mesh, args: "9000 {count} {size} '
            f'{peers}", start_time: 100ms, '
            f"expected_final_state: any }}")
    exp = [f"  scheduler: {scheduler}",
           f"  socket_send_buffer: {sbuf}"]
    if device_spans is not None:
        exp.append(f"  tpu_device_spans: {device_spans}")
    loss_s = f" packet_loss {loss}" if loss else ""
    gml = (f'graph [ node [ id 0 host_bandwidth_down "{bw_down}" '
           f'host_bandwidth_up "{bw_up}" ] '
           f'edge [ source 0 target 0 latency "{latency}"{loss_s} ] ]')
    return (f"general: {{ stop_time: {stop_time}, seed: {seed} }}\n"
            f"network:\n  graph:\n    type: gml\n    inline: |\n"
            f"{_indent(gml, '      ')}\n"
            f"experimental:\n" + "\n".join(exp) + "\n"
            f"hosts:\n" + "\n".join(blocks) + "\n")


# ---------------------------------------------------------------------
# The reference benchmark's ladder (bench.py), copied: the 3-tier graph,
# its constants and three of its configs as YAML.  tests/test_torch_
# propagate.py pins each against bench.py's dict.
# ---------------------------------------------------------------------

HOSTS_10K = 10_000
SIM_SECONDS_10K = 10
HOSTS_1K = 1000
SERVERS_1K = HOSTS_1K // 10
NBYTES_1K = 50_000
COUNT_1K = 5           # transfers per client
SIM_SECONDS_1K = 30
MESH_HOSTS = 100
MESH_COUNT = 30
MESH_SIZE = 200

THREE_TIER_GML = """
graph [ directed 0
  node [ id 0 host_bandwidth_down "10 Gbit" host_bandwidth_up "10 Gbit" ]
  node [ id 1 host_bandwidth_down "1 Gbit" host_bandwidth_up "1 Gbit" ]
  node [ id 2 host_bandwidth_down "100 Mbit" host_bandwidth_up "50 Mbit" ]
  edge [ source 0 target 0 latency "1 ms" ]
  edge [ source 0 target 1 latency "10 ms" packet_loss 0.002 ]
  edge [ source 1 target 1 latency "5 ms" packet_loss 0.001 ]
  edge [ source 1 target 2 latency "25 ms" packet_loss 0.005 ]
  edge [ source 2 target 2 latency "40 ms" packet_loss 0.01 ]
  edge [ source 0 target 2 latency "35 ms" packet_loss 0.008 ]
]"""

MESH_GML = """
graph [ node [ id 0 host_bandwidth_down "1 Gbit" host_bandwidth_up "1 Gbit" ]
  edge [ source 0 target 0 latency "10 ms" packet_loss 0.01 ] ]"""


def _q(v) -> str:
    """A YAML scalar: JSON's double-quoted strings and numbers are YAML."""
    import json
    return json.dumps(v)


def _proc(path: str, args: list[str], final: str,
          start: str | None = None) -> str:
    start_s = f", start_time: {_q(start)}" if start is not None else ""
    return (f"{{path: {path}, args: [{', '.join(_q(a) for a in args)}]"
            f"{start_s}, expected_final_state: {final}}}")


def _bench_yaml(stop_time: str, seed: int, gml: str, scheduler: str,
                experimental_extra: dict | None, hosts: list[str]) -> str:
    exp = {"scheduler": scheduler, **(experimental_extra or {})}
    return (f"general: {{stop_time: {stop_time}, seed: {seed}}}\n"
            f"network: {{graph: {{type: gml, inline: {_q(gml)}}}}}\n"
            f"experimental: {{"
            + ", ".join(f"{k}: {_q(v)}" for k, v in exp.items()) + "}\n"
            "hosts:\n" + "\n".join(hosts) + "\n")


def tier10k_yaml(scheduler: str = "tpu", stop_s: int = SIM_SECONDS_10K,
                 n_hosts: int = HOSTS_10K,
                 experimental_extra: dict | None = None,
                 extra_hosts: list[str] | None = None) -> str:
    """bench.py config_10k, BASELINE config 4: 10k hosts over the 3-tier
    graph, 500 tgen-server relays on node 0, 9,500 tgen-clients on nodes
    1-2 each doing 3 x 25,000 B, starts staggered 100-933 ms, seed 7.
    `n_hosts` shrinks the fleet (relays stay 1 in 20) for tests;
    `extra_hosts` are host lines appended (`pcap_clients`)."""
    relays = n_hosts // 20
    hosts = [f"  relay{i:04d}: {{network_node_id: 0, processes: ["
             + _proc("tgen-server", ["80"], "running") + "]}"
             for i in range(relays)]
    hosts += [f"  cli{i:05d}: {{network_node_id: {1 + (i % 2)}, "
              "processes: ["
              + _proc("tgen-client", [f"relay{i % relays:04d}", "80",
                                      "25000", "3"], "any",
                      f"{100 + (i % 50) * 17}ms") + "]}"
              for i in range(n_hosts - relays)]
    return _bench_yaml(f"{stop_s}s", 7, THREE_TIER_GML, scheduler,
                       experimental_extra, hosts + (extra_hosts or []))


def pcap_clients(n: int) -> list[str]:
    """bench.py mixed_pcap_rung's extra hosts, as tier10k_yaml host
    lines: `n` pcap'd object-path clients (per-host `native_dataplane:
    false`) `pcap00`.. on node 1, one 10,000 B transfer each from
    relay0000.. at 150 + 20 i ms."""
    return [f"  pcap{i:02d}: {{network_node_id: 1, pcap_enabled: true, "
            "native_dataplane: false, processes: ["
            + _proc("tgen-client", [f"relay{i:04d}", "80", "10000", "1"],
                    "any", f"{150 + i * 20}ms") + "]}"
            for i in range(n)]


def tier1k_yaml(scheduler: str = "tpu") -> str:
    """bench.py config3, BASELINE config 3: 1k hosts over the 3-tier
    graph, 100 tgen servers on node 0, 900 clients on nodes 1-2 each
    doing 5 x 50,000 B, starts staggered 100-803 ms, 30 s, seed 7."""
    hosts = [f"  srv{i:03d}: {{network_node_id: 0, processes: ["
             + _proc("tgen-server", ["80"], "running") + "]}"
             for i in range(SERVERS_1K)]
    hosts += [f"  cli{i:04d}: {{network_node_id: {1 + (i % 2)}, "
              "processes: ["
              + _proc("tgen-client", [f"srv{i % SERVERS_1K:03d}", "80",
                                      str(NBYTES_1K), str(COUNT_1K)],
                      "any", f"{100 + (i % 20) * 37}ms") + "]}"
              for i in range(HOSTS_1K - SERVERS_1K)]
    return _bench_yaml(f"{SIM_SECONDS_1K}s", 7, THREE_TIER_GML, scheduler,
                       None, hosts)


def mesh100_yaml(scheduler: str = "tpu") -> str:
    """bench.py mesh_config, BASELINE config 2: 100 hosts, each one
    udp-mesh sending 30 x 200 B to each of its 99 peers from 1 s, over
    one 10 ms node with 1% loss, 30 s, seed 3."""
    names = [f"h{i:03d}" for i in range(MESH_HOSTS)]
    hosts = [f"  {name}: {{network_node_id: 0, processes: ["
             + _proc("udp-mesh", ["9000", str(MESH_COUNT), str(MESH_SIZE)]
                     + [p for p in names if p != name], "any", "1s") + "]}"
             for name in names]
    return _bench_yaml("30s", 3, MESH_GML, scheduler, None, hosts)


def compile_echo_binaries(out_dir: str) -> dict | None:
    """Build the managed-fleet C plugins (udp echo server/client) into
    `out_dir`; returns {name: path} or None without a C toolchain.
    The JAX package's compile step, exactly: `cc -O1` over
    tests/plugins/udp_echo_{server,client}.c."""
    import os
    import shutil
    import subprocess
    if shutil.which("cc") is None:
        return None
    plug = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        "tests", "plugins")
    bins = {}
    for name in ("udp_echo_server", "udp_echo_client"):
        out = os.path.join(out_dir, name)
        subprocess.run(["cc", "-O1", "-o", out,
                        os.path.join(plug, name + ".c")], check=True)
        bins[name] = out
    return bins


def managed_fleet_yaml(server_bin: str, client_bin: str, n_procs: int,
                       stop_time: str = "30s", seed: int = 3) -> str:
    """N-process managed (real-binary) fleet: one C UDP echo server
    per 16 processes, the rest clients (the JAX package's generator of
    its managed-1k/10k bench rungs).  Servers get
    EXPLICIT ip_addr so clients can target them at any fleet size —
    the auto-assignment pool skips .0/.255 octets and is not
    arithmetic — and each server's echo budget counts exactly the
    clients its `i % n_servers` slot serves (an over-counted server
    would wait forever, an under-counted one would exit early and
    strand its last client)."""
    n_servers = max(1, n_procs // 16)
    n_clients = n_procs - n_servers
    blocks = []
    for i in range(n_servers):
        served = n_clients // n_servers + (1 if i < n_clients
                                           % n_servers else 0)
        blocks.append(f"""
  srv{i:04d}:
    network_node_id: 0
    ip_addr: 11.200.{i // 250}.{i % 250 + 1}
    processes:
      - path: {server_bin}
        args: "9000 {3 * served}"
        start_time: 1s""")
    for i in range(n_clients):
        s = i % n_servers
        blocks.append(f"""
  cli{i:05d}:
    network_node_id: 0
    processes:
      - path: {client_bin}
        args: "11.200.{s // 250}.{s % 250 + 1} 9000 3 64"
        start_time: 2s""")
    return f"""
general:
  stop_time: {stop_time}
  seed: {seed}
network:
  graph:
    type: gml
    inline: |
      graph [
        node [ id 0 host_bandwidth_down "1 Gbit" host_bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" ] ]
hosts:{''.join(blocks)}
"""


def incast_yaml(fan_in: int, nbytes: int = 500_000,
                server_bw: str = "20 Mbit", client_bw: str = "100 Mbit",
                latency: str = "2 ms", stop_time: str = "3s",
                seed: int = 17, scheduler: str = "serial",
                device_spans: str | None = None,
                tcp: dict | None = None) -> str:
    """Minimal N->1 fan-in (incast): ONE sink host runs `fan_in`
    tgen-client downloads — one from each of `fan_in` source servers —
    all opened at the SAME instant, with the sink's downlink as the
    shared bottleneck.  The N response streams converge on the sink's
    inbound router queue: the canonical queue-buildup smoke for the
    fabric observatory (CoDel depth climbs, head sojourn crosses the
    5 ms target, the control law drops, and every drop must reconcile
    in the byte-conservation sweep).  With tcp={"cc": "dctcp", "ecn":
    "on"} the sink's queue marks instead.  The JAX package's
    `shadow_tpu/tools/netgen.py` generator of the same name, copied."""
    gml_lines = ["graph [ directed 0",
                 f'  node [ id 0 host_bandwidth_down "{server_bw}" '
                 f'host_bandwidth_up "{server_bw}" ]',
                 f'  node [ id 1 host_bandwidth_down "{client_bw}" '
                 f'host_bandwidth_up "{client_bw}" ]',
                 f'  edge [ source 0 target 0 latency "{latency}" ]',
                 f'  edge [ source 1 target 1 latency "{latency}" ]',
                 f'  edge [ source 0 target 1 latency "{latency}" ]',
                 "]"]
    gml = "\n".join(gml_lines)
    sink_procs = []
    for i in range(fan_in):
        sink_procs.append(
            f'      - {{ path: tgen-client, '
            f'args: [src{i:03d}, "8080", "{nbytes}", "1"], '
            f"start_time: 100ms, expected_final_state: any }}")
    tl = _tcp_line(tcp)
    blocks = [f"  sink:\n    network_node_id: 0\n{tl}    processes:\n"
              + "\n".join(sink_procs)]
    for i in range(fan_in):
        blocks.append(
            f"  src{i:03d}:\n    network_node_id: 1\n{tl}    processes:\n"
            f'      - {{ path: tgen-server, args: ["8080"], '
            f"expected_final_state: running }}")
    exp = [f"  scheduler: {scheduler}",
           "  socket_send_autotune: false",
           "  socket_recv_autotune: false"]
    if device_spans is not None:
        exp.append(f"  tpu_device_spans: {device_spans}")
    return (f"general: {{ stop_time: {stop_time}, seed: {seed} }}\n"
            f"network:\n  graph:\n    type: gml\n    inline: |\n"
            f"{_indent(gml, '      ')}\n"
            f"experimental:\n" + "\n".join(exp) + "\n"
            f"hosts:\n" + "\n".join(blocks) + "\n")
