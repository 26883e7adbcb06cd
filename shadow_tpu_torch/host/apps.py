"""Internal application registry.

The reference points host configs at real binaries (tgen, iperf, tor);
until the interposition backend lands, configs name *internal apps* —
Python generators driven through the same syscall seam (process.py).
`path: udp-sink` in YAML resolves here.

Apps yield syscall tuples and receive results; OSErrors raise at the
yield point. They are deliberately written like the C apps they stand in
for: sockets, blocking calls, no access to simulator internals.

The port's copy of `shadow_tpu/host/apps.py`.
"""

from __future__ import annotations

APP_REGISTRY: dict = {}


def app(name: str):
    def register(fn):
        APP_REGISTRY[name] = fn
        return fn
    return register


def lookup(path: str):
    return APP_REGISTRY.get(path)


# ---------------------------------------------------------------------------
# UDP workloads (tgen-style file transfer / flood / sink)
# ---------------------------------------------------------------------------

@app("udp-flood")
def udp_flood(process, argv):
    """udp-flood <dst> <port> <count> <size> [interval_ns]"""
    dst, port, count, size = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    interval = int(argv[4]) if len(argv) > 4 else 0
    fd = yield ("socket", "udp")
    dst_ip = yield ("resolve", dst)
    payload = b"x" * size
    sent = 0
    for i in range(count):
        yield ("sendto", fd, payload, (dst_ip, port))
        sent += size
        if interval > 0:
            yield ("nanosleep", interval)
    yield ("write", 1, f"sent {count} datagrams {sent} bytes\n")
    yield ("close", fd)
    return 0


@app("udp-sink")
def udp_sink(process, argv):
    """udp-sink <port> [expected_bytes] — exits 0 once expected bytes seen;
    runs forever without the argument (stopped by sim end)."""
    port = int(argv[0])
    expect = int(argv[1]) if len(argv) > 1 else None
    fd = yield ("socket", "udp")
    yield ("bind", fd, (0, port))
    got = 0
    n = 0
    while expect is None or got < expect:
        data, src = yield ("recvfrom", fd, 65536)
        got += len(data)
        n += 1
    t = yield ("sim_time",)
    yield ("write", 1, f"received {n} datagrams {got} bytes t={t}\n")
    yield ("close", fd)
    return 0


@app("udp-echo-server")
def udp_echo_server(process, argv):
    port = int(argv[0])
    fd = yield ("socket", "udp")
    yield ("bind", fd, (0, port))
    while True:
        data, src = yield ("recvfrom", fd, 65536)
        yield ("sendto", fd, data, src)


@app("udp-pinger")
def udp_pinger(process, argv):
    """udp-pinger <dst> <port> <count> — RTT measurement over UDP echo."""
    dst, port, count = argv[0], int(argv[1]), int(argv[2])
    fd = yield ("socket", "udp")
    dst_ip = yield ("resolve", dst)
    for i in range(count):
        t0 = yield ("sim_time",)
        yield ("sendto", fd, b"ping%d" % i, (dst_ip, port))
        data, src = yield ("recvfrom", fd, 65536)
        t1 = yield ("sim_time",)
        yield ("write", 1, f"rtt={t1 - t0}\n")
    yield ("close", fd)
    return 0


@app("tgen-server")
def tgen_server(process, argv):
    """tgen-server <port> — serves: each connection sends a line
    'GET <nbytes>', receives that many bytes back, then EOF. The
    tgen-equivalent file-transfer server (reference test workloads use
    the real tgen binary the same way)."""
    port = int(argv[0])
    fd = yield ("socket", "tcp")
    yield ("bind", fd, (0, port))
    yield ("listen", fd, 64)

    def serve(conn_fd):
        def handler():
            req = b""
            while not req.endswith(b"\n"):
                chunk = yield ("recv", conn_fd, 4096)
                if chunk == b"":
                    yield ("close", conn_fd)
                    return
                req += chunk
            n = int(req.decode().split()[1])
            payload = b"D" * 65536
            sent = 0
            while sent < n:
                take = min(65536, n - sent)
                sent += yield ("send", conn_fd, payload[:take])
            yield ("shutdown", conn_fd, "wr")
            # Drain until the client closes, then release the fd.
            while (yield ("recv", conn_fd, 4096)) != b"":
                pass
            yield ("close", conn_fd)
        return handler

    while True:
        conn_fd, peer = yield ("accept", fd)
        yield ("spawn_thread", serve(conn_fd))


@app("tgen-client")
def tgen_client(process, argv):
    """tgen-client <server> <port> <nbytes> [count] — performs `count`
    sequential downloads of nbytes each and reports completion times."""
    server, port, nbytes = argv[0], int(argv[1]), int(argv[2])
    count = int(argv[3]) if len(argv) > 3 else 1
    ip = yield ("resolve", server)
    for i in range(count):
        t0 = yield ("sim_time",)
        fd = yield ("socket", "tcp")
        yield ("connect", fd, (ip, port))
        yield ("send", fd, f"GET {nbytes}\n".encode())
        got = 0
        while got < nbytes:
            chunk = yield ("recv", fd, 1 << 16)
            if chunk == b"":
                break
            got += len(chunk)
        yield ("close", fd)
        t1 = yield ("sim_time",)
        ok = "ok" if got == nbytes else f"SHORT {got}"
        yield ("write", 1, f"transfer {i} {ok} bytes={got} ns={t1 - t0}\n")
    return 0


@app("phold")
def phold(process, argv):
    """phold <port> <my_index> <n_init> <mean_delay_ns> <peer...> — the
    classic PHOLD PDES benchmark (ref: src/test/phold): each host seeds
    `n_init` messages; every received message triggers one new message
    to a pseudo-random peer after a pseudo-exponential delay.  Runs
    until the simulation ends (expected_final_state: running).  All
    randomness is a per-host deterministic LCG, so traces are
    byte-identical across schedulers and runs."""
    port, my_index, n_init = int(argv[0]), int(argv[1]), int(argv[2])
    mean_delay = int(argv[3])
    peers = argv[4:]
    if not peers:
        yield ("write", 2, "phold: no peers configured\n")
        return 1

    state = [(my_index * 2654435761 + 12345) & 0xFFFFFFFF]

    def rnd() -> int:
        state[0] = (state[0] * 1664525 + 1013904223) & 0xFFFFFFFF
        return state[0]

    def exp_delay() -> int:
        # Pseudo-exponential via summed uniforms (integer-only).
        u = (rnd() % 1000) + (rnd() % 1000) + 1
        return max(1, (u * mean_delay) // 1000)

    fd = yield ("socket", "udp")
    yield ("bind", fd, (0, port))
    ips = []
    for peer in peers:
        ip = yield ("resolve", peer)
        ips.append(ip)

    def fire():
        yield ("nanosleep", exp_delay())
        yield ("sendto", fd, b"phold", (ips[rnd() % len(ips)], port))

    def seeder():
        for _ in range(n_init):
            yield from fire()

    yield ("spawn_thread", seeder)
    n = 0
    while True:
        _data, _src = yield ("recvfrom", fd, 64)
        n += 1
        yield from fire()


@app("udp-mesh")
def udp_mesh(process, argv):
    """udp-mesh <port> <count> <size> <peer1> <peer2> ... — every host
    floods every peer while sinking its own port; the 100-host benchmark
    workload (BASELINE config 2)."""
    port, count, size = int(argv[0]), int(argv[1]), int(argv[2])
    peers = argv[3:]
    fd = yield ("socket", "udp")
    yield ("bind", fd, (0, port))

    def sender():
        payload = b"m" * size
        ips = []
        for peer in peers:
            ip = yield ("resolve", peer)
            ips.append(ip)
        for i in range(count):
            for ip in ips:
                yield ("sendto", fd, payload, (ip, port))
        yield ("write", 1, f"mesh sent {count * len(peers)}\n")

    yield ("spawn_thread", sender)
    expect = count * len(peers) * size
    got = 0
    while got < expect:
        data, src = yield ("recvfrom", fd, 65536)
        got += len(data)
    yield ("write", 1, f"mesh received {got} bytes\n")
    return 0


@app("http-server")
def http_server(process, argv):
    """http-server <port> [nbytes] — minimal HTTP/1.1 server for the
    real-app gating tests (ref: examples/apps/{curl,wget2} run real
    clients against an in-sim server the same way).  Serves a fixed
    'X'*nbytes body with Content-Length and closes the connection."""
    port = int(argv[0])
    nbytes = int(argv[1]) if len(argv) > 1 else 1024
    fd = yield ("socket", "tcp")
    yield ("bind", fd, (0, port))
    yield ("listen", fd, 64)

    def serve(conn_fd):
        def handler():
            req = b""
            while b"\r\n\r\n" not in req and b"\n\n" not in req:
                chunk = yield ("recv", conn_fd, 4096)
                if chunk == b"":
                    yield ("close", conn_fd)
                    return
                req += chunk
            line = req.split(b"\r\n", 1)[0].decode(errors="replace")
            yield ("write", 1, f"request: {line}\n")
            body = b"X" * nbytes
            head = (f"HTTP/1.1 200 OK\r\n"
                    f"Content-Type: text/plain\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    f"Connection: close\r\n\r\n").encode()
            data = head + body
            sent = 0
            while sent < len(data):
                sent += yield ("send", conn_fd, data[sent:sent + 65536])
            yield ("shutdown", conn_fd, "wr")
            while (yield ("recv", conn_fd, 4096)) != b"":
                pass
            yield ("close", conn_fd)
        return handler

    while True:
        conn_fd, peer = yield ("accept", fd)
        yield ("spawn_thread", serve(conn_fd))
