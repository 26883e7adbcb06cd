"""Deterministic workload config generation (the port's copy of the
TCP stream generator in `shadow_tpu/tools/netgen.py`).

Everything is derived from the arguments with pure integer arithmetic,
so the port and the JAX package generate byte-identical YAML for the
same call (tests/test_torch_tcp_span.py pins it).
"""

from __future__ import annotations


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
