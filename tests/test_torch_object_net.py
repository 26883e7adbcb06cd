"""The object path's event queue and network devices against the JAX
package's: the port's copies of `core/event.py`, `net/packet.py`,
`net/token_bucket.py`, `net/codel.py`, `net/router.py`, `net/relay.py`,
`net/interface.py`, `net/dns_wire.py` and `host/cpu.py`.

Each test drives both packages' object with the same numpy-seeded
sequence of operations and holds every output and every state field
equal after each step.  The devices that talk to a host get a small
recording host (the same class for both packages), so the calls they
make on it are compared too.
"""

import heapq

import numpy as np
import pytest

from shadow_tpu.core import event as j_event
from shadow_tpu.host import cpu as j_cpu
from shadow_tpu.net import codel as j_codel
from shadow_tpu.net import dns_wire as j_dns
from shadow_tpu.net import interface as j_iface
from shadow_tpu.net import packet as j_pkt
from shadow_tpu.net import relay as j_relay
from shadow_tpu.net import router as j_router
from shadow_tpu.net import token_bucket as j_tb
from shadow_tpu_torch.core import event as p_event
from shadow_tpu_torch.host import cpu as p_cpu
from shadow_tpu_torch.net import codel as p_codel
from shadow_tpu_torch.net import dns_wire as p_dns
from shadow_tpu_torch.net import interface as p_iface
from shadow_tpu_torch.net import packet as p_pkt
from shadow_tpu_torch.net import relay as p_relay
from shadow_tpu_torch.net import router as p_router
from shadow_tpu_torch.net import token_bucket as p_tb

SEEDS = (1, 2, 3)


def _slots(obj) -> dict:
    """Every slot's value, packets reduced to their identity."""
    out = {}
    for cls in type(obj).__mro__:
        for name in getattr(cls, "__slots__", ()):
            if hasattr(obj, name):
                out[name] = _plain(getattr(obj, name))
    return out


def _plain(v):
    """A value with packets as (src_host_id, seq, ecn) and containers
    walked, so two packages' states compare with ==."""
    if hasattr(v, "src_host_id") and hasattr(v, "payload"):
        return ("pkt", v.src_host_id, v.seq, v.ecn, v.statuses)
    if isinstance(v, (list, tuple)) or type(v).__name__ == "deque":
        return [_plain(x) for x in v]
    if callable(v):
        return "<fn>"
    if hasattr(v, "__slots__") and not isinstance(v, (int, str, bytes)):
        return _slots(v)
    return v


def _packets(mod, rng, n: int, tcp_share: float = 0.5) -> list:
    """n packets from a seeded generator: sizes, ports, protocols, ECN."""
    out = []
    for i in range(n):
        tcp = rng.random() < tcp_share
        payload = b"p" * int(rng.integers(0, 1400))
        hdr = None
        if tcp:
            hdr = mod.TcpHeader(seq=int(rng.integers(0, 1 << 32)),
                                ack=int(rng.integers(0, 1 << 32)),
                                flags=int(rng.integers(0, 256)),
                                window=int(rng.integers(0, 1 << 16)))
        p = mod.Packet(int(rng.integers(0, 8)), i,
                       mod.PROTO_TCP if tcp else mod.PROTO_UDP,
                       int(rng.integers(1, 1 << 32)),
                       int(rng.integers(1, 1 << 16)),
                       int(rng.integers(1, 1 << 32)),
                       int(rng.integers(1, 1 << 16)), payload=payload,
                       tcp=hdr)
        p.ecn = int(rng.choice([0, mod.ECN_ECT0]))
        out.append(p)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_event_total_order(seed):
    """The same events, pushed in a seeded order, pop in the same order
    from both queues; the port's order is (time, kind, src, seq)."""
    rng = np.random.default_rng(seed)
    keys = {(int(rng.integers(0, 50)), int(rng.integers(0, 2)),
             int(rng.integers(0, 6)), int(rng.integers(0, 1000)))
            for _ in range(300)}
    keys = list(keys)
    rng.shuffle(keys)
    out = []
    for mod in (j_event, p_event):
        q = mod.EventQueue()
        for k in keys:
            q.push(mod.Event(*k, data=k))
        got = []
        while q:
            assert q.peek_time() == q._heap[0][0]
            got.append(q.pop().data)
        out.append(got)
    assert out[0] == out[1] == sorted(keys)
    assert (p_event.KIND_PACKET, p_event.KIND_LOCAL) == \
        (j_event.KIND_PACKET, j_event.KIND_LOCAL)
    q = p_event.EventQueue()
    q.push(p_event.Event(50, p_event.KIND_LOCAL, 0, 0, None))
    q.pop()
    q.push(p_event.Event(10, p_event.KIND_LOCAL, 0, 1, None))
    with pytest.raises(AssertionError):
        q.pop()  # time never moves backwards
    calls = []
    p_event.TaskRef("t", lambda h, x: calls.append((h, x)), 7).execute("H")
    assert calls == [("H", 7)]


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_packet_fields(seed):
    jp = _packets(j_pkt, np.random.default_rng(seed), 200)
    pp = _packets(p_pkt, np.random.default_rng(seed), 200)
    for a, b in zip(jp, pp):
        assert (a.total_size(), a.header_size(), a.is_empty_control()) == \
            (b.total_size(), b.header_size(), b.is_empty_control())
        assert repr(a) == repr(b)
        assert repr(a.tcp) == repr(b.tcp)
    j_pkt.set_status_tracing(True)
    p_pkt.set_status_tracing(True)
    try:
        a = _packets(j_pkt, np.random.default_rng(seed), 1)[0]
        b = _packets(p_pkt, np.random.default_rng(seed), 1)[0]
        for st in ("ST_SENT_TO_ROUTER", "ST_RELAY_CACHED",
                   "ST_RCV_DELIVERED"):
            a.record(getattr(j_pkt, st))
            b.record(getattr(p_pkt, st))
        assert a.statuses == b.statuses
    finally:
        j_pkt.set_status_tracing(False)
        p_pkt.set_status_tracing(False)


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_token_bucket_law(seed):
    rng = np.random.default_rng(seed)
    bw = int(rng.choice([1_000_000, 20_000_000, 1_000_000_000]))
    buckets = [m.TokenBucket.for_bandwidth(bw, 1500) for m in (j_tb, p_tb)]
    now = 0
    for _ in range(2000):
        now += int(rng.integers(0, 400_000))
        size = int(rng.integers(40, 1540))
        peeks = [b.peek_balance(now) for b in buckets]
        outs = [b.try_remove(size, now) for b in buckets]
        assert outs[0] == outs[1] and peeks[0] == peeks[1]
        assert _slots(buckets[0]) == _slots(buckets[1])
        assert buckets[0].balance_at(now) == buckets[1].balance_at(now)


class _Host:
    """A recording stand-in for the host a device calls back into."""

    def __init__(self, pkt_mod):
        self.pkt = pkt_mod
        self.t = 0
        self.calls: list = []
        self.dctcp_k_pkts = 4
        self.dctcp_k_bytes = 3_000
        self.devices: dict = {}

    def now(self):
        return self.t

    def trace_drop(self, p, reason, at_time=None):
        self.calls.append(("drop", p.src_host_id, p.seq, reason, at_time))

    def count_mark(self, cause):
        self.calls.append(("mark", cause))

    def notify_router_has_packets(self):
        self.calls.append(("router-has",))

    def notify_interface_has_packets(self, iface):
        self.calls.append(("iface-has", iface.name))

    def schedule_task_at(self, t, task):
        self.calls.append(("task", t, task.name))
        self.task = task

    def get_packet_device(self, dst_ip):
        return self.devices.setdefault("sink", _Sink(self))

    def trace_snd(self, p):
        self.calls.append(("snd", p.src_host_id, p.seq, self.t))

    def trace_rcv(self, p):
        self.calls.append(("rcv", p.src_host_id, p.seq, self.t))

    def send_packet(self, p):
        self.calls.append(("send", p.src_host_id, p.seq))


class _Sink:
    def __init__(self, host):
        self.host = host

    def push(self, host, p):
        host.calls.append(("push", p.src_host_id, p.seq, host.t))


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_codel_law(seed):
    """Seeded bursts into the CoDel queue and pops at seeded instants:
    the same packets out, the same drops and marks, the same state."""
    rng = np.random.default_rng(seed)
    pkts = [_packets(m, np.random.default_rng(seed + 100), 3000, 0.7)
            for m in (j_pkt, p_pkt)]
    qs = [j_codel.CoDelQueue(), p_codel.CoDelQueue()]
    hosts = [_Host(j_pkt), _Host(p_pkt)]
    now, i = 0, 0
    while i < 3000:
        now += int(rng.integers(0, 3_000_000))
        burst = int(rng.integers(0, 60))
        for q, ps, h in zip(qs, pkts, hosts):
            for k in range(i, min(i + burst, 3000)):
                q.push(ps[k], now,
                       lambda p, h=h: h.trace_drop(p, "rtr-limit"),
                       h.count_mark, k_pkts=h.dctcp_k_pkts,
                       k_bytes=h.dctcp_k_bytes)
        i += burst
        pops = int(rng.integers(0, 24))
        outs = [[], []]
        for q, h, o in zip(qs, hosts, outs):
            for _ in range(pops):
                p = q.pop(now, lambda p, h=h: h.trace_drop(p, "codel"))
                o.append(None if p is None else (p.src_host_id, p.seq,
                                                 p.ecn))
        assert outs[0] == outs[1]
        assert hosts[0].calls == hosts[1].calls
        assert _slots(qs[0]) == _slots(qs[1])
    assert qs[0].dropped_count > 0 and qs[0].marked_count > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_router(seed):
    rng = np.random.default_rng(seed)
    pkts = [_packets(m, np.random.default_rng(seed), 1500, 0.8)
            for m in (j_pkt, p_pkt)]
    routers = [j_router.Router(), p_router.Router()]
    hosts = [_Host(j_pkt), _Host(p_pkt)]
    k = 0
    while k < 1500:
        t = int(rng.integers(0, 2_000_000))
        n = int(rng.integers(1, 60))
        pops = int(rng.integers(0, 40))
        for r, h, ps in zip(routers, hosts, pkts):
            h.t += t
            for p in ps[k:k + n]:
                r.route_incoming_packet(h, p)
            for _ in range(pops):
                r.pop_inbound(h, h.t)
            r.route_outgoing_packet(h, ps[k])
            h.calls.append((r.has_inbound(), r.inbound_dropped))
        k += n
        assert hosts[0].calls == hosts[1].calls
        assert _slots(routers[0]._inbound) == _slots(routers[1]._inbound)


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_relay(seed):
    """A rate-limited relay over a seeded packet source: the same
    forwards, parks and refill wakeups, the same counters."""
    rng = np.random.default_rng(seed)
    srcs = [list(_packets(m, np.random.default_rng(seed), 800))
            for m in (j_pkt, p_pkt)]
    hosts = [_Host(j_pkt), _Host(p_pkt)]
    relays = []
    for mod, tb, h, src in zip((j_relay, p_relay), (j_tb, p_tb), hosts,
                               srcs):
        relays.append(mod.Relay(
            "inet-out", lambda host, now, src=src: src.pop(0) if src
            else None, tb.TokenBucket.for_bandwidth(10_000_000, 1500)))
    for _ in range(600):
        step = int(rng.integers(0, 2_000_000))
        for r, h in zip(relays, hosts):
            h.t += step
            task = getattr(h, "task", None)
            if task is not None and h.calls and h.calls[-1][0] == "task" \
                    and h.calls[-1][1] <= h.t:
                h.t = h.calls[-1][1]
                task.execute(h)
            else:
                r.notify(h)
        assert hosts[0].calls == hosts[1].calls
        assert _slots(relays[0]) == _slots(relays[1])
    assert relays[0].stalls > 0 and relays[0].forwarded_pkts > 0


class _Sock:
    """A stand-in socket with a queue of outgoing packets."""

    def __init__(self, packets):
        self.out = list(packets)
        self.got = []

    def peek_next_packet_priority(self, iface):
        return self.out[0].priority if self.out else None

    def pull_out_packet(self, host, iface):
        return self.out.pop(0) if self.out else None

    def push_in_packet(self, host, p):
        self.got.append((p.src_host_id, p.seq))
        return len(self.got) % 5 != 0


@pytest.mark.parametrize("qdisc", ["fifo", "round_robin"])
@pytest.mark.parametrize("seed", SEEDS)
def test_torch_interface(seed, qdisc):
    """Associations, the send queue's order under both qdiscs, and the
    receive demux (a 4-tuple first, then the wildcard, else no-socket)
    over seeded traffic."""
    rng = np.random.default_rng(seed)
    runs = []
    for mod, pk in ((j_iface, j_pkt), (p_iface, p_pkt)):
        pkts = _packets(pk, np.random.default_rng(seed), 600)
        for i, p in enumerate(pkts):
            p.priority = i
        r = np.random.default_rng(seed + 7)
        iface = mod.NetworkInterface(0x0A000001, "eth0", qdisc)
        host = _Host(pk)
        socks = []
        for s in range(6):
            sock = _Sock(pkts[s::6])
            socks.append(sock)
            iface.associate(sock, pk.PROTO_UDP, 1000 + s)
            iface.associate(sock, pk.PROTO_TCP, 1000 + s,
                            int(r.integers(1, 4)), 80)
        try:
            iface.associate(socks[0], pk.PROTO_UDP, 1000)
        except OSError as e:
            host.calls.append(("bind", e.errno))
        iface.disassociate(pk.PROTO_UDP, 1005)
        host.calls.append((iface.port_in_use(pk.PROTO_UDP, 1005),
                           iface.port_in_use(pk.PROTO_TCP, 1005),
                           len(list(iface.associated_sockets()))))
        for sock in socks:
            iface.notify_socket_has_packets(host, sock)
        while True:
            host.t += int(r.integers(0, 1000))
            p = iface.pop_packet(host, host.t)
            if p is None:
                break
            p.dst_port = 1000 + int(r.integers(0, 7))
            p.protocol = pk.PROTO_UDP if r.random() < 0.5 else pk.PROTO_TCP
            p.src_ip = int(r.integers(1, 4))
            p.src_port = int(r.choice([80, 81]))
            iface.push(host, p)
        runs.append((host.calls, [s.got for s in socks],
                     iface.packets_sent, iface.bytes_sent,
                     iface.packets_received, iface.bytes_received))
    assert runs[0] == runs[1]
    assert runs[0][2] == 600


def test_torch_dns_wire():
    rng = np.random.default_rng(5)
    names = {"alpha": 0x0A000001, "bravo.example": 0x0A000002}

    def query(qid, name, qtype, flags=0x0100, qclass=1):
        q = j_dns.struct.pack(">6H", qid, flags, 1, 0, 0, 0)
        for label in name.split("."):
            q += bytes([len(label)]) + label.encode()
        return q + b"\0" + j_dns.struct.pack(">2H", qtype, qclass)

    cases = [query(int(rng.integers(0, 1 << 16)), n, t)
             for n in ("alpha", "Bravo.Example", "nope") for t in (1, 28)]
    cases += [query(1, "alpha", 1, flags=0x8000), query(2, "alpha", 1,
                                                         qclass=3),
              b"\0" * 5, bytes(rng.integers(0, 256, 40, dtype=np.uint8))]
    for q in cases:
        assert p_dns.answer_query(q, names.get) == \
            j_dns.answer_query(q, names.get)
        assert p_dns.parse_qname(q, 12) == j_dns.parse_qname(q, 12)


@pytest.mark.parametrize("precision", [None, 1000])
def test_torch_cpu_model(precision):
    rng = np.random.default_rng(11)
    cpus = [m.Cpu(threshold=10_000, precision=precision)
            for m in (j_cpu, p_cpu)]
    now = 0
    for _ in range(3000):
        now += int(rng.integers(0, 50_000))
        for c in cpus:
            c.update_time(now)
        assert cpus[0].delay() == cpus[1].delay()
        cost = int(rng.integers(0, 30_000))
        for c in cpus:
            c.add_delay(cost)
        assert _slots(cpus[0]) == _slots(cpus[1])


def test_torch_heap_entries_are_the_engine_keys():
    """Engine hosts merge the Python heap with the engine's events by the
    heap head's (time, kind, src, seq): the entry's first four fields."""
    q = p_event.EventQueue()
    ev = p_event.Event(5, p_event.KIND_LOCAL, 3, 9, "x")
    q.push(ev)
    assert q._heap[0][:4] == (5, p_event.KIND_LOCAL, 3, 9)
    assert heapq.heappop(q._heap)[4] is ev
