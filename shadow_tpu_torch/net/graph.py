"""Network graph: GML topology, all-pairs routing, IP assignment.

The port's copy of `shadow_tpu/net/graph.py` (same parse, same routing
matrices), plus `routing_arrays`, which gives the latency and loss-
threshold matrices the engine and the device loop read.

Re-designs the reference's graph layer (src/main/network/graph/mod.rs and
the gml-parser lib) around a key TPU-first decision: routing is stored as
*dense node-by-node matrices* — int64 latency ns, float64 loss probability
— because the batched packet-propagation kernel gathers `L[src_node,
dst_node]` for a whole round's packets in one vectorized lookup
(ops/propagate.py). Graph nodes number in the thousands even for 100k-host
simulations (hosts attach to nodes), so dense V x V matrices are cheap.

Shortest paths: latency-weighted Dijkstra over all sources
(scipy.sparse.csgraph — replaces the reference's rayon-parallel petgraph
run, graph/mod.rs:183), with packet-loss accumulated *along the chosen
shortest path* via predecessor walking, matching the reference's
PathProperties combination (graph/mod.rs:298-352: latencies add; loss
combines as 1 - prod(1 - loss_i)).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from shadow_tpu_torch.utils import units


# ---------------------------------------------------------------------------
# GML parsing (format per docs/network_graph_spec.md in the reference)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r'"(?:[^"\\]|\\.)*"|\[|\]|[^\s\[\]]+')


def _tokenize_gml(text: str):
    for line in text.splitlines():
        # '#' comments run to end of line (outside quoted strings; GML
        # labels in network graphs don't contain '#').
        line = line.split("#", 1)[0]
        yield from _TOKEN_RE.findall(line)


def _parse_gml_value(tok: str):
    if tok.startswith('"'):
        return tok[1:-1]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


def parse_gml(text: str) -> dict:
    """Parse GML into nested dicts; lists of dicts for repeated keys.

    Returns {"graph": {..., "node": [...], "edge": [...]}}.
    """
    tokens = list(_tokenize_gml(text))
    pos = 0

    def parse_object():
        nonlocal pos
        obj: dict = {}
        while pos < len(tokens):
            key = tokens[pos]
            if key == "]":
                pos += 1
                return obj
            pos += 1
            if pos >= len(tokens):
                raise ValueError(f"GML: dangling key {key!r}")
            if tokens[pos] == "[":
                pos += 1
                value = parse_object()
            else:
                value = _parse_gml_value(tokens[pos])
                pos += 1
            if key in ("node", "edge"):
                obj.setdefault(key, []).append(value)
            else:
                obj[key] = value
        return obj

    root = parse_object()
    if "graph" not in root:
        raise ValueError("GML: no 'graph' object")
    return root


# ---------------------------------------------------------------------------
# Graph model
# ---------------------------------------------------------------------------

@dataclass
class GraphNode:
    gml_id: int
    index: int  # dense 0..V-1 index used by all matrices
    label: str = ""
    bandwidth_down_bits: int | None = None  # node-level host defaults
    bandwidth_up_bits: int | None = None


@dataclass
class GraphEdge:
    source: int  # dense index
    target: int
    latency_ns: int
    jitter_ns: int
    packet_loss: float


# A built-in one-node topology for quick configs (reference: the
# `1_gbit_switch` built-in graph, configuration.rs GraphSource).
BUILTIN_GRAPHS = {
    "1_gbit_switch": """graph [
  directed 0
  node [
    id 0
    label "switch"
    host_bandwidth_down "1 Gbit"
    host_bandwidth_up "1 Gbit"
  ]
  edge [
    source 0
    target 0
    latency "1 ms"
    packet_loss 0.0
  ]
]""",
}


class NetworkGraph:
    """Parsed topology + dense routing matrices.

    Attributes (after `compute_routing`):
      latency_ns:   (V, V) int64 — end-to-end latency, TIME_NEVER if no path
      packet_loss:  (V, V) float64 — end-to-end loss probability
    """

    def __init__(self, nodes: list[GraphNode], edges: list[GraphEdge],
                 directed: bool):
        self.nodes = nodes
        self.edges = edges
        self.directed = directed
        self.by_gml_id = {n.gml_id: n for n in nodes}
        self.latency_ns: np.ndarray | None = None
        self.packet_loss: np.ndarray | None = None
        self.gml_text: str = ""  # original source, for processed-config

    @classmethod
    def from_gml(cls, text: str) -> "NetworkGraph":
        graph = cls._from_gml_parsed(text)
        graph.gml_text = text
        return graph

    @classmethod
    def _from_gml_parsed(cls, text: str) -> "NetworkGraph":
        g = parse_gml(text)["graph"]
        directed = bool(g.get("directed", 0))
        nodes = []
        for i, n in enumerate(g.get("node", [])):
            if "id" not in n:
                raise ValueError("GML node missing 'id'")
            bw_down = n.get("host_bandwidth_down")
            bw_up = n.get("host_bandwidth_up")
            nodes.append(GraphNode(
                gml_id=n["id"], index=i, label=str(n.get("label", "")),
                bandwidth_down_bits=(units.parse_bandwidth_bits(bw_down)
                                     if bw_down is not None else None),
                bandwidth_up_bits=(units.parse_bandwidth_bits(bw_up)
                                   if bw_up is not None else None)))
        by_gml = {n.gml_id: n.index for n in nodes}
        edges = []
        for e in g.get("edge", []):
            if "latency" not in e:
                raise ValueError("GML edge missing 'latency'")
            latency = units.parse_time_ns(e["latency"])
            if latency <= 0:
                raise ValueError("edge latency must be positive (runahead "
                                 "depends on a nonzero minimum latency)")
            edges.append(GraphEdge(
                source=by_gml[e["source"]], target=by_gml[e["target"]],
                latency_ns=latency,
                jitter_ns=units.parse_time_ns(e.get("jitter", 0)),
                packet_loss=float(e.get("packet_loss", 0.0))))
        return cls(nodes, edges, directed)

    @classmethod
    def named(cls, name: str) -> "NetworkGraph":
        return cls.from_gml(BUILTIN_GRAPHS[name])

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    def compute_routing(self, use_shortest_path: bool = True) -> None:
        from shadow_tpu_torch.core.simtime import TIME_NEVER

        V = self.num_nodes
        lat = np.full((V, V), np.inf)
        loss_neglog = np.zeros((V, V))
        edge_loss = np.zeros((V, V))
        for e in self.edges:
            pairs = [(e.source, e.target)]
            if not self.directed and e.source != e.target:
                pairs.append((e.target, e.source))
            for s, t in pairs:
                if e.latency_ns < lat[s, t]:
                    lat[s, t] = e.latency_ns
                    edge_loss[s, t] = e.packet_loss

        if use_shortest_path:
            from scipy.sparse import csr_matrix
            from scipy.sparse.csgraph import dijkstra

            w = np.where(np.isinf(lat), 0.0, lat)
            graph = csr_matrix(w)
            dist, pred = dijkstra(graph, directed=True,
                                  return_predecessors=True)
            # Self-paths: a node's self-loop edge if present, else 0-latency
            # local delivery (dijkstra reports dist[i,i]=0 regardless).
            # Accumulate loss along each chosen path by walking predecessors
            # in increasing-distance order (each step's predecessor is
            # already finalized).
            loss = np.zeros((V, V))
            for src in range(V):
                order = np.argsort(dist[src], kind="stable")
                keep = np.ones(V)  # P(not dropped) along path
                for dst in order:
                    p = pred[src, dst]
                    if dst == src or p < 0:
                        continue
                    keep[dst] = keep[p] * (1.0 - edge_loss[p, dst])
                loss[src] = 1.0 - keep
            final_lat = dist
        else:
            # Direct-path mode (graph/mod.rs:230): only explicit edges.
            final_lat = lat
            loss = edge_loss.copy()

        # Self-paths (applied uniformly in both routing modes): prefer an
        # explicit self-loop edge; otherwise use the node's minimum
        # outgoing edge latency as the local-delivery cost. That keeps
        # min_latency_ns() — and with it the runahead window — equal to a
        # *real* edge latency instead of an arbitrary tiny constant, and
        # a truly isolated node's diagonal stays unreachable.
        for i in range(V):
            if np.isfinite(lat[i, i]) and lat[i, i] > 0:
                final_lat[i, i] = lat[i, i]
                loss[i, i] = edge_loss[i, i]
            else:
                out_edges = np.concatenate([lat[i, :i], lat[i, i + 1:]])
                finite = out_edges[np.isfinite(out_edges)]
                final_lat[i, i] = finite.min() if finite.size else np.inf
                loss[i, i] = 0.0

        out = np.where(np.isfinite(final_lat), final_lat, TIME_NEVER)
        self.latency_ns = out.astype(np.int64)
        self.packet_loss = loss
        # Pairwise reachability check happens lazily: send_packet errors on
        # TIME_NEVER entries.

    def min_latency_ns(self) -> int:
        """Smallest possible inter-arrival latency — the runahead floor
        (reference: Runahead min possible latency, runahead.rs:44-116)."""
        assert self.latency_ns is not None
        finite = self.latency_ns[self.latency_ns > 0]
        from shadow_tpu_torch.core.simtime import TIME_NEVER
        finite = finite[finite < TIME_NEVER]
        if finite.size == 0:
            raise ValueError("graph has no usable paths")
        return int(finite.min())


# ---------------------------------------------------------------------------
# IP assignment (reference: src/main/network/graph/mod.rs:354 IpAssignment)
# ---------------------------------------------------------------------------

class IpAssignment:
    """Maps host IPs <-> graph-node indices, auto-assigning from 11.0.0.0/8
    (a public-but-unrouted block, same choice as the reference)."""

    _AUTO_BASE = (11 << 24) + 1

    def __init__(self):
        self._ip_to_node: dict[int, int] = {}
        self._next_auto = self._AUTO_BASE

    def assign(self, node_index: int, ip: int | None = None) -> int:
        if ip is None:
            ip = self._next_auto
            while ip in self._ip_to_node or (ip & 0xFF) in (0, 255):
                ip += 1
            self._next_auto = ip + 1
        elif ip in self._ip_to_node:
            raise ValueError(f"duplicate IP {format_ip(ip)}")
        self._ip_to_node[ip] = node_index
        return ip

    def node_for_ip(self, ip: int) -> int | None:
        return self._ip_to_node.get(ip)


def parse_ip(text: str) -> int:
    parts = [int(p) for p in text.split(".")]
    if len(parts) != 4 or any(not 0 <= p <= 255 for p in parts):
        raise ValueError(f"bad IPv4 address: {text!r}")
    return (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]


def format_ip(ip: int) -> str:
    return f"{ip >> 24 & 255}.{ip >> 16 & 255}.{ip >> 8 & 255}.{ip & 255}"


LOCALHOST_IP = parse_ip("127.0.0.1")


def loss_thresholds(packet_loss: np.ndarray) -> np.ndarray:
    """(V, V) int64 `drop iff bits < threshold` matrix: one float->int
    conversion at build time, shared verbatim by the engine's scalar
    twin and the device loop."""
    from shadow_tpu_torch.core.rng import loss_threshold_u32
    thr = np.zeros(packet_loss.shape, dtype=np.int64)
    nz = packet_loss > 0
    if nz.any():
        thr[nz] = [loss_threshold_u32(p) for p in packet_loss[nz]]
    return thr


def routing_arrays(graph: NetworkGraph, use_shortest_path: bool = True):
    """(latency_ns, thresholds): contiguous int64 (V, V) matrices for
    the engine's set_routing and the device loop's propagate."""
    if graph.latency_ns is None:
        graph.compute_routing(use_shortest_path)
    lat = np.ascontiguousarray(graph.latency_ns, dtype=np.int64)
    return lat, np.ascontiguousarray(loss_thresholds(graph.packet_loss))
