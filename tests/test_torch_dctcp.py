"""DCTCP and ECN through the port, against the JAX package.

The reference's cross-scheduler leg (tests/test_dctcp.py `_run_incast`):
`incast_yaml(8, nbytes=300_000, stop_time="1500ms")` with sim-netstat
and the fabric observatory on, `tcp: {cc: dctcp, ecn: on}` (and the
reno + ECN case of its `test_reno_ecn_marks_and_conserves`).  The JAX
package runs it on its serial object path; the port runs it under
`serial`, under `tpu` with spans forced through the plain loop (the
eager span loop, what the port runs on the CPU) and under `tpu` with
spans forced through the host build of `stt_tcp_span`
(csrc/tcp_round_end.cuh and tcp_lane.cuh built with the system C++
compiler, tests/test_torch_channels.py `libs`: the kernel's marking,
ECE/CWR echo and alpha law).  packet-trace.txt, fabric-sim.bin and
telemetry-sim.bin must be byte-identical to the JAX package's, and the
conservation ledger (`fabric_conservation()`) and bench.py's fabric
block (`fabric_summary(stop_time_ns)`) equal to the reference Manager's,
with marks, and no violation.  Tolerance: exact.

`-m slow` adds the reference's forced-device differential
(tests/test_dctcp.py `test_dctcp_forced_device_differential`): the 2 MB
incast to 2 s through the port's plain loop against the JAX package's
serial run, most rounds on the device.
"""

import os

import pytest
import torch

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import Manager
from shadow_tpu_torch.tools.netgen import incast_yaml
from shadow_tpu_torch.trace import events as trev
from test_torch_channels import libs, port_run  # noqa: F401

CCS = {"dctcp": {"cc": "dctcp", "ecn": "on"},
       "reno-ecn": {"cc": "reno", "ecn": "on"}}
FILES = ("packet-trace.txt", "fabric-sim.bin", "telemetry-sim.bin")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The eager loop runs thousands of small ops: one intra-op thread
    keeps the test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def incast(scheduler: str, cc: str, nbytes: int = 300_000,
           stop: str = "1500ms") -> str:
    spans = "force" if scheduler == "tpu" else None
    return incast_yaml(8, nbytes=nbytes, stop_time=stop,
                       scheduler=scheduler, device_spans=spans,
                       tcp=CCS[cc]).replace(
        "experimental:",
        "experimental:\n  sim_netstat: \"on\"\n  sim_fabricstat: \"on\"")


def read_files(data: str) -> dict:
    out = {}
    for f in FILES:
        with open(os.path.join(data, f), "rb") as fh:
            out[f] = fh.read()
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's serial run of each controller: its files, its
    conservation ledger and its fabric block."""
    out = {}
    for cc in CCS:
        data = str(tmp_path_factory.mktemp(f"jax-{cc}"))
        cfg = JConfig.from_yaml_text(incast("serial", cc))
        cfg.general.parallelism = 1
        cfg.general.data_directory = data
        m, s = jrun(cfg, write_data=True)
        assert s.ok, s.plugin_errors
        out[cc] = (read_files(data), m.fabric_conservation(),
                   m.fabric_summary(cfg.general.stop_time_ns))
    return out


# (controller, the port's route): serial, tpu through the plain loop,
# tpu through the host build of stt_tcp_span.
CASES = [("dctcp", "serial"), ("dctcp", "tpu-plain"),
         ("dctcp", "tpu-kernel"), ("reno-ecn", "serial"),
         ("reno-ecn", "tpu-kernel")]


@pytest.mark.parametrize("cc,route", CASES,
                         ids=[f"{c}-{r}" for c, r in CASES])
def test_torch_dctcp_incast_matches_jax_package(tmp_path, request, jax_runs,
                                                cc, route):
    ref_files, ref_cons, ref_summary = jax_runs[cc]
    sched = "serial" if route == "serial" else "tpu"
    text = incast(sched, cc)
    data = str(tmp_path / "port")
    m, _ = port_run(
        text, data, scheduler=sched, team=8,
        libs=request.getfixturevalue("libs") if route == "tpu-kernel"
        else None)
    files = read_files(data)
    for f in FILES:
        assert files[f] == ref_files[f], f"{cc} {route}: {f} differs"
    assert trev.split_fabric(files["fabric-sim.bin"])[0]
    assert files["telemetry-sim.bin"]
    cons = m.fabric_conservation()
    assert cons == ref_cons
    assert cons["marked_pkts"] > 0 and cons["violations"] == 0
    stop_ns = JConfig.from_yaml_text(text).general.stop_time_ns
    assert m.fabric_summary(stop_ns) == ref_summary
    assert ref_summary["marked_pkts"] > 0 and ref_summary["fct"]["flows"]
    if sched == "tpu":
        # The TCP family's spans ran: the marking was decided inside
        # them for part of the run.
        r = m._dev_span_tcp
        assert r is not None and r.spans > 0 and r.rounds > 0
        assert m._dev_span is None or m._dev_span.rounds == 0


@pytest.mark.slow
def test_torch_dctcp_forced_device_differential(tmp_path):
    """The 2 MB incast to 2 s with spans forced through the port's plain
    loop: the JAX package's serial trace and ledger, nonzero marks, and
    at least half the rounds on the device."""
    def cfg(cls, sched):
        c = cls.from_yaml_text(incast_yaml(
            8, nbytes=2_000_000, stop_time="2s", seed=17, scheduler=sched,
            device_spans="force" if sched == "tpu" else None,
            tcp=CCS["dctcp"]))
        c.general.parallelism = 1
        return c

    m_ser, s_ser = jrun(cfg(JConfig, "serial"))
    assert s_ser.ok, s_ser.plugin_errors
    mgr = Manager(cfg(ConfigOptions, "tpu"), device="cpu")
    s_dev = mgr.run()
    assert s_dev.ok, s_dev.plugin_errors
    r = mgr._dev_span_tcp
    assert r is not None and r.spans > 0, (r and r.aborts, r and r.over_caps)
    assert r.rounds * 2 >= s_dev.rounds, \
        f"only {r.rounds}/{s_dev.rounds} rounds on device"
    assert m_ser.trace_lines() == mgr.trace_lines()
    cons = mgr.fabric_conservation()
    assert cons == m_ser.fabric_conservation()
    assert cons["marked_pkts"] > 0
