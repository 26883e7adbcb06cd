"""Scalar (CPU) cross-host packet propagation: the port's copy of
`shadow_tpu/core/propagate_scalar.py`, and the mixed-plane delivery
both propagators share.

The serial and threaded schedulers propagate each object-path send as
it happens: resolve the destination, draw the event seq, the loss
decision, the latency lookup, and clamp the delivery into the next
round.  Every decision is integer math on the same matrices and the
same counter-based RNG as the per-round kernel (ops/propagate.py), so
the two give byte-identical traces.  Engine hosts' sends batch
engine-side; at the round's end the engine's bit-identical C++
propagation twin delivers them into the engine inboxes and exports the
packets bound for object-path hosts.  Nothing here touches torch or a
card: this is the CPU baseline.
"""

from __future__ import annotations

import threading

from shadow_tpu_torch.core.event import Event, KIND_PACKET
from shadow_tpu_torch.core.rng import (STREAM_PACKET_LOSS, mix_key,
                                       threefry2x32_py)
from shadow_tpu_torch.core.simtime import TIME_NEVER
from shadow_tpu_torch.net import packet as pktmod


def _export_native_packet(plane, pkt_id: int):
    """An engine packet as a Python Packet (delivery to an object-path
    host); the engine's slot is freed."""
    (src_host, seq, proto, src_ip, sport, dst_ip, dport, payload,
     ecn, tcp) = plane.engine.packet_fields(pkt_id)
    hdr = None
    if tcp is not None:
        tseq, ack, flags, window, wscale, mss, sacks, ts_val, \
            ts_ecr = tcp
        hdr = pktmod.TcpHeader(
            seq=tseq, ack=ack, flags=flags, window=window,
            window_scale=None if wscale < 0 else wscale,
            mss=None if mss < 0 else mss, sack_blocks=tuple(sacks),
            timestamp=ts_val, timestamp_echo=ts_ecr)
    p = pktmod.Packet(src_host, seq, proto, src_ip, sport, dst_ip, dport,
                      payload=payload, tcp=hdr)
    p.priority = seq
    p.ecn = ecn  # ECT/CE survives the cross-plane seam
    plane.engine.free_packet(pkt_id)
    return p


def _intern_python_packet(plane, p) -> int:
    """An object-path packet delivered to an engine host becomes an
    entry of the engine's packet store."""
    tcp = None
    if p.tcp is not None:
        h = p.tcp
        tcp = (h.seq, h.ack, h.flags, h.window,
               -1 if h.window_scale is None else h.window_scale,
               -1 if h.mss is None else h.mss, tuple(h.sack_blocks),
               h.timestamp or 0, h.timestamp_echo or 0)
    return plane.engine.intern_packet(
        p.src_host_id, p.seq, p.protocol, p.src_ip, p.src_port, p.dst_ip,
        p.dst_port, p.payload, p.ecn, tcp)


def deliver_to_host(dst_host, t: int, src_id: int, seq: int, pkt) -> None:
    """Deliver a kept object-path packet to its destination on either
    plane: an engine host gets it interned and pushed into its engine
    inbox, an object-path host a packet event."""
    if dst_host.plane is not None:
        pid = _intern_python_packet(dst_host.plane, pkt)
        dst_host.plane.engine.push_inbox(dst_host.id, t, src_id, seq, pid)
    else:
        pkt.arrival_time = t
        dst_host.deliver_packet_event(Event(t, KIND_PACKET, src_id, seq,
                                            pkt))


def deliver_engine_exports(hosts, exports) -> None:
    """Engine-origin packets bound for object-path hosts (mixed sims):
    materialized and delivered as packet events."""
    for pkt_id, dst, evt_seq, t, src in exports:
        p = _export_native_packet(hosts[src].plane, pkt_id)
        p.arrival_time = t
        hosts[dst].deliver_packet_event(Event(t, KIND_PACKET, src,
                                              evt_seq, p))


class ScalarPropagator:
    def __init__(self, hosts, dns, latency_ns, loss_thresholds, seed: int,
                 bootstrap_end_ns: int, threaded: bool = False,
                 runahead=None):
        self.hosts = hosts
        self.dns = dns
        self.latency = latency_ns          # (V, V) int64 ndarray
        self.thresholds = loss_thresholds  # (V, V) int64 in [0, 2^32]
        self.k0, self.k1 = mix_key(seed, STREAM_PACKET_LOSS)
        self.bootstrap_end = bootstrap_end_ns
        self.window_end = 0
        self.min_inflight = None
        self.runahead = runahead  # dynamic-runahead feedback
        self._threaded = threaded
        self.engine = None  # the native plane's engine (set by the Manager)
        if threaded:
            self._min_lock = threading.Lock()

    def begin_round(self, window_start: int, window_end: int) -> None:
        self.window_end = window_end
        self.min_inflight = None

    def finish_round(self):
        """Propagate the round's engine-batched sends through the C++
        twin; returns the least in-flight delivery time of the round
        (None when nothing is in flight)."""
        m = self.min_inflight
        eng = self.engine
        if eng is not None and eng.round_size():
            _nf, md, ml, exports = eng.finish_round(self.window_end)
            if exports is not None:
                deliver_engine_exports(self.hosts, exports)
            if self.runahead is not None and ml < TIME_NEVER:
                self.runahead.update_lowest_used_latency(ml)
            if md < TIME_NEVER and (m is None or md < m):
                m = md
        return m

    def send(self, src_host, packet) -> None:
        now = src_host.now()
        dst_id = self.dns.host_id_for_ip(packet.dst_ip)
        if dst_id is None:
            src_host.trace_drop(packet, "no-route")
            return
        dst_host = self.hosts[dst_id]

        # The event seq is drawn before the reachability and loss
        # decisions, so the numbering is the batched path's (where both
        # are decided later, in one round).
        seq = src_host.next_event_seq()

        latency = int(self.latency[src_host.node_index, dst_host.node_index])
        if latency >= TIME_NEVER:
            src_host.trace_drop(packet, "unreachable")
            return

        threshold = int(self.thresholds[src_host.node_index,
                                        dst_host.node_index])
        if threshold > 0 and now >= self.bootstrap_end \
                and not packet.is_empty_control():
            bits, _ = threefry2x32_py(self.k0, self.k1,
                                      packet.src_host_id & 0xFFFFFFFF,
                                      packet.seq & 0xFFFFFFFF)
            if bits < threshold:
                packet.record(pktmod.ST_INET_DROPPED)
                src_host.trace_drop(packet, "inet-loss")
                return

        # The conservative clamp: a delivery never lands inside the
        # current window (the destination may already have run past
        # now + latency).
        deliver = now + latency
        if deliver < self.window_end:
            deliver = self.window_end
        deliver_to_host(dst_host, deliver, src_host.id, seq, packet)

        if self._threaded:
            with self._min_lock:
                if self.min_inflight is None or deliver < self.min_inflight:
                    self.min_inflight = deliver
                if self.runahead is not None:
                    self.runahead.update_lowest_used_latency(latency)
        else:
            if self.min_inflight is None or deliver < self.min_inflight:
                self.min_inflight = deliver
            if self.runahead is not None:
                self.runahead.update_lowest_used_latency(latency)

    def close(self) -> None:
        """Nothing runs in the background."""
