"""The port's sans-I/O TCP (`shadow_tpu_torch/tcp/connection.py`) against
the JAX package's, on the scenarios of tests/test_tcp_unit.py.

That file's scenarios (handshake, bulk transfer and close, RTO, fast
retransmit, out-of-order reassembly, flow control, RST, sequence
wraparound, simultaneous close and open, option negotiation, SACK,
delayed ACK, Nagle and TCP_NODELAY, the zero-window persist probe, SACK
reneging, the timestamp RTT samples) are loaded twice: once as written,
over the JAX package's `tcp`, and once over the port's.  Each scenario
runs in both with its own assertions, and every segment its wire moves
(direction, clock, header fields and a digest of the payload) is
logged: the two segment streams must be equal, and so must both
connections' final state.
"""

import hashlib
import os
import types

import pytest

_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "test_tcp_unit.py")


def _load(pkg: str):
    """tests/test_tcp_unit.py with its `tcp` imports taken from `pkg`,
    its wire logging every segment it moves."""
    with open(_REF) as f:
        src = f.read()
    if pkg != "shadow_tpu":
        src = src.replace("from shadow_tpu.tcp", f"from {pkg}.tcp")
    mod = types.ModuleType(f"_tcp_scenarios_{pkg}")
    mod.__file__ = _REF
    exec(compile(src, _REF, "exec"), mod.__dict__)
    assert mod.TcpConnection.__module__ == f"{pkg}.tcp.connection"
    mod.LOG = []
    deliver = mod.Wire._deliver

    def logged_deliver(self, src, dst, direction):
        for hdr, payload in src.outbox:
            mod.LOG.append((direction, self.now, hdr.seq, hdr.ack,
                            hdr.flags, hdr.window, hdr.window_scale,
                            hdr.mss, tuple(hdr.sack_blocks),
                            hdr.timestamp, hdr.timestamp_echo, len(payload),
                            hashlib.sha1(bytes(payload)).hexdigest()))
        return deliver(self, src, dst, direction)

    mod.Wire._deliver = logged_deliver
    init = mod.Wire.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        mod.WIRES.append(self)

    mod.Wire.__init__ = recording_init
    mod.WIRES = []
    return mod


REF = _load("shadow_tpu")
PORT = _load("shadow_tpu_torch")
SCENARIOS = sorted(n for n in dir(REF) if n.startswith("test_"))


def _conn_state(c) -> tuple:
    return (c.state, c.snd_una, c.snd_nxt, c.rcv_nxt, c.cong.cwnd,
            c.cong.ssthresh, c.srtt, c.rto, c.retransmit_count,
            c.sacked_skip_count, c.segments_sent, c.segments_received,
            c.send_buf_len, c.recv_buf_len)


@pytest.mark.parametrize("name", SCENARIOS)
def test_torch_tcp_scenario_segment_streams(name):
    runs = []
    for mod in (REF, PORT):
        mod.LOG.clear()
        mod.WIRES.clear()
        getattr(mod, name)()
        runs.append((list(mod.LOG),
                     [(_conn_state(w.a), _conn_state(w.b))
                      for w in mod.WIRES]))
    assert runs[0][1] == runs[1][1], f"{name}: final states differ"
    assert runs[0][0] == runs[1][0], f"{name}: segment streams differ"
    if name not in ("test_seq_arithmetic",):
        assert runs[0][0] or runs[0][1], name


def test_torch_tcp_scenarios_cover_the_reference_file():
    """Every scenario of the reference file runs here (the list is read
    from it), the issue's named ones among them."""
    for want in ("test_handshake", "test_rto_retransmission_recovers_total_"
                 "loss", "test_fast_retransmit_on_dupacks",
                 "test_sack_reduces_retransmits_on_burst_loss",
                 "test_delayed_ack_halves_pure_acks",
                 "test_nagle_coalesces_small_writes",
                 "test_zero_window_persist_probe", "test_simultaneous_open",
                 "test_simultaneous_close", "test_sequence_wraparound"):
        assert want in SCENARIOS
