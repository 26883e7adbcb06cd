"""The TCP device-span runner's rtx/reassembly ring caps (ROADMAP C1).

The port's TcpSpanRunner takes them as its `ring_cap` argument, 512 by
default (ops/tcp_span.py says why); the reference's are 256.  The caps
go to the engine's span_export_tcp, which refuses a state whose rings
are over half full, so they decide which span boundaries the device
gets.  The stream here (16 hosts, 2% loss, 1 s) is the smallest of those
tried where they bite: with the C++ path serving every round, the 256
export refuses at boundaries where the 512 one takes the state.  With
forced device spans at the reference's 256, the port's span records
equal the JAX package's: spans, device rounds, export verdicts, aborts
by kind, and the trace.
"""

import pytest
import torch

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import Manager as JManager
from shadow_tpu.ops.tcp_span import TcpSpanRunner as JRunner
from shadow_tpu.tools.netgen import tcp_stream_yaml as j_yaml
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import Manager
from shadow_tpu_torch.ops.tcp_span import TcpSpanRunner
from shadow_tpu_torch.tools.netgen import tcp_stream_yaml

STREAM = dict(nbytes=50_000_000, loss=0.02, stop_time="1s", seed=11,
              scheduler="tpu", device_spans="force")
N_HOSTS = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Verdicts:
    """Engine proxy counting span_export_tcp's verdicts: "ok" for an
    export, the int code of a refusal, "none" out of the family."""

    def __init__(self, eng):
        self._eng = eng
        self.seen = {}

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def span_export_tcp(self, *caps):
        d = self._eng.span_export_tcp(*caps)
        k = "ok" if isinstance(d, dict) else "none" if d is None else int(d)
        self.seen[k] = self.seen.get(k, 0) + 1
        return d


def _records(r, verdicts):
    return {"spans": r.spans, "rounds": int(r.rounds),
            "aborts": r.aborts, "abort_kinds": dict(r.abort_kind_counts()),
            "ineligible": r.ineligible, "over_caps": r.over_caps,
            "verdicts": dict(verdicts.seen)}


def _port(ring_cap):
    mgr = Manager(ConfigOptions.from_yaml_text(tcp_stream_yaml(N_HOSTS,
                                                               **STREAM)),
                  device="cpu")
    r = mgr._dev_span_tcp = TcpSpanRunner(*mgr._span_runner_args(),
                                          tracing=True, device="cpu",
                                          ring_cap=ring_cap)
    r.overlap = mgr._span_overlap_on()
    rec = r.engine = Verdicts(r.engine)
    summary = mgr.run()
    assert summary.ok
    return _records(r, rec), mgr.trace_lines()


def test_torch_tcp_ring_cap_is_a_runner_argument():
    """The default is 512 on both rings; `ring_cap` sets both, and the
    export is asked with them."""
    args = (None, [[0]], [[0]], [0], [1], 1, 0)
    assert TcpSpanRunner(*args, tracing=False,
                         device="cpu")._caps()[3:5] == (512, 512)
    r = TcpSpanRunner(*args, tracing=False, device="cpu",
                      ring_cap=JRunner.CAP_RT)
    assert r._caps()[3:5] == (JRunner.CAP_RT, JRunner.CAP_RA) == (256, 256)
    assert TcpSpanRunner.CAP_RT == 512  # the class default is untouched


def test_torch_tcp_ring_caps_refuse_on_this_stream():
    """The caps bite on this stream: with the C++ path serving every round
    (each span declined after its export is asked for), the 256 export
    refuses at span boundaries where the 512 export takes the same state
    (a connection's rtx queue or reassembly over 128 segments)."""
    mgr = Manager(ConfigOptions.from_yaml_text(tcp_stream_yaml(N_HOSTS,
                                                               **STREAM)),
                  device="cpu")
    eng = mgr.plane.engine
    caps = TcpSpanRunner(*mgr._span_runner_args(), tracing=False,
                         device="cpu", ring_cap=JRunner.CAP_RT)._caps()
    wide = caps[:3] + (512, 512) + caps[5:]
    bitten = []

    class NotPhold:
        ineligible = 1

    class Declines:
        ineligible = 0
        last_transient = True
        last_was_cold = False

        def try_span(self, start, *args, **kwargs):
            if not isinstance(eng.span_export_tcp(*caps), dict) \
                    and isinstance(eng.span_export_tcp(*wide), dict):
                bitten.append(start)
            return None

    mgr._dev_span, mgr._dev_span_tcp = NotPhold(), Declines()
    assert mgr.run().ok
    assert bitten


def test_torch_tcp_span_records_at_reference_caps_equal_jax():
    """Forced device spans on the stream, the JAX runner and the port's at
    256: the same spans, device rounds, export verdicts, aborts and
    trace.  (On the device trajectory a clean span's output stays
    resident, so the export is asked only where the stream enters the
    domain; there the 256 export refuses once, in the handshake.)"""
    jm = JManager(JConfig.from_yaml_text(j_yaml(N_HOSTS, **STREAM)))
    jr = jm._dev_span_tcp = jm.make_tcp_span_runner()
    jrec = jr.engine = Verdicts(jr.engine)
    assert jm.run().ok
    want = _records(jr, jrec)
    got, lines = _port(JRunner.CAP_RT)
    assert got == want
    assert lines == jm.trace_lines()
    assert want["spans"] > 0 and want["rounds"] > 0
    assert want["verdicts"].get(1, 0) > 0 and want["verdicts"]["ok"] > 0
