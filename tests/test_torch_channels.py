"""The sim-time channels and engine pcap, the port against the JAX package.

The same YAML, every channel on (`flight_recorder`, `sim_netstat`,
`sim_fabricstat`, `kernel_observatory`), through the port's
`run_simulation(cfg, device="cpu", write_data=True)` under `scheduler:
tpu` with forced device spans and through the JAX package's run: every
file of the two data directories byte-identical under the determinism
gate's `collect` rules (tests/test_determinism.py), which covers
`flight-sim.bin`, `telemetry-sim.bin`, `fabric-sim.bin`,
`kernel-sim.bin`, every `.pcap` and sim-stats.json's `metrics.sim`.
Tolerance: exact.

Each shape runs once (module-scoped) and every assertion reads that run:

- 8-LP PHOLD through the port's plain loop (the eager span loop), and
  the 8-host udp-mesh and the 10-host CoDel mesh through the host build
  of `stt_phold_span` (csrc/phold_round_end.cuh, the kernel's phases in
  turn), each against the JAX package's forced-span run;
- the 8-host TCP stream at 2% loss to 1 s through the host build of
  `stt_tcp_span`: its connection and queue samples against the JAX
  package's engine `thread_per_core` run and the port's own, whose
  `kernel-sim.bin` is empty (no device span);
- `incast_yaml(12)`: the fabric file and its conservation under CoDel
  drops against the JAX package's engine run;
- the 8-host stream with pcap on one host (the engine keeps such a sim
  off device spans, as the reference's does) against the JAX package's
  forced run, every file;
- with the channels off, no channel file is written.

Each run holds the kernel channel's conservation law: per family, the
committed records' trips sum to the runner's `micro_iters`.  `-m slow`
adds the stream through the port's plain TCP loop against the JAX
package's forced TCP spans, every file.
"""

import ctypes
import json
import os
import shutil
import subprocess

import pytest
import torch

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu.trace.fabricstat import fct_table as jax_fct_table
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import Manager
from shadow_tpu_torch.ops import phold_span_kernel as pk
from shadow_tpu_torch.ops import tcp_span_kernel as tsk
from shadow_tpu_torch.tools.netgen import incast_yaml, tcp_stream_yaml
from shadow_tpu_torch.trace import events as trev
from shadow_tpu_torch.trace.fabricstat import fct_table
from shadow_tpu_torch.trace.kernstat import family_trips
from test_determinism import collect
from test_torch_phold_span import codel_yaml, mesh_yaml, phold_yaml
from test_torch_phold_span_kernel import SHIM as PHOLD_SHIM
from test_torch_tcp_span_kernel import SHIM as TCP_SHIM

CHANNELS = ("experimental:\n  flight_recorder: on\n  sim_netstat: on\n"
            "  sim_fabricstat: on\n  kernel_observatory: on\n")
FILES = ("flight-sim.bin", "telemetry-sim.bin", "fabric-sim.bin",
         "kernel-sim.bin")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The eager loop runs thousands of small ops: one intra-op thread
    keeps the test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def channels_on(text: str) -> str:
    return text.replace("experimental:\n", CHANNELS, 1)


def stream(pcap: bool = False) -> str:
    text = channels_on(tcp_stream_yaml(
        8, nbytes=50_000_000, loss=0.02, stop_time="1s", seed=11,
        scheduler="tpu", device_spans="force")).replace(
        "experimental:\n", "experimental:\n  native_dataplane: on\n", 1)
    if pcap:
        text = text.replace("network_node_id: 0\n",
                            "network_node_id: 0\n    pcap_enabled: true\n",
                            1)
    return text


def _build(tmp, name: str, shim: str, declare):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (tmp / f"{name}.cpp").write_text(shim)
    csrc = os.path.join(os.path.dirname(pk.__file__), "..", "csrc")
    lib_path = str(tmp / f"lib{name}.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    csrc, "-o", lib_path, str(tmp / f"{name}.cpp")],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    declare(lib)
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both span kernels' round-end headers built for the host with the
    system C++ compiler (the test files' shims of the kernels' entry
    points: the phases in turn, a team of ranks run in turn)."""
    tmp = tmp_path_factory.mktemp("channel_libs")
    tcp = _build(tmp, "tcp_span", TCP_SHIM, tsk._declare)
    tcp.stt_tcp_span_team.argtypes = [ctypes.c_int]
    return {"phold": _build(tmp, "phold_span", PHOLD_SHIM, pk._declare),
            "tcp": tcp}


class HostSpan:
    """A span build's span step through a host build: the kernel's own
    operand table (with its sample rows), the phases in turn, one read
    of the block."""

    def __init__(self, lib, table, launch):
        self.lib, self.table, self.launch = lib, table, launch

    def __call__(self, st, *args):
        *pay, start, stop, limit, runahead, max_rounds = args
        self.table.begin(st, *pay, min(64, max_rounds))
        ptrs, words = self.table.fill(st, start=start, stop=stop,
                                      limit=limit, runahead=runahead,
                                      max_rounds=max_rounds)
        assert self.launch(ptrs, words) == 0
        return dict(self.table.read(), span_ms=0.0)


def phold_factory(lib, team):
    return lambda shape, params: HostSpan(
        lib, pk.SpanTable(lib, shape, params),
        lambda p, w: lib.stt_phold_span(p, w, team, 0, None))


def tcp_factory(lib, team):
    def make(shape, params):
        lib.stt_tcp_span_team(team)
        return HostSpan(lib, tsk.TcpSpanTable(lib, shape, params),
                        lambda p, w: lib.stt_tcp_span(p, w, 0, None))
    return make


def port_run(text: str, data: str, scheduler="tpu", libs=None, team=1):
    """The port's run of `text` into `data`; with `libs`, every device
    span of either family is stepped by the host build."""
    cfg = ConfigOptions.from_yaml_text(text)
    cfg.general.parallelism = 1
    cfg.general.data_directory = data
    cfg.experimental.scheduler = scheduler
    m = Manager(cfg, device="cpu" if scheduler == "tpu" else None)
    if libs is not None:
        m._dev_span = m.make_dev_span_runner()
        m._dev_span.span_factory = phold_factory(libs["phold"], team)
        m._dev_span_tcp = m.make_tcp_span_runner()
        m._dev_span_tcp.span_factory = tcp_factory(libs["tcp"], team)
    s = m.run()
    assert s.ok, s.plugin_errors
    m.write_data_dir(s)
    return m, collect(data)


def jax_run(text: str, data: str, scheduler="tpu"):
    cfg = JConfig.from_yaml_text(text)
    cfg.general.parallelism = 1
    cfg.general.data_directory = data
    cfg.experimental.scheduler = scheduler
    _m, s = jrun(cfg, write_data=True)
    assert s.ok, s.plugin_errors
    return collect(data)


def assert_same(port: dict, ref: dict, what: str, keys=None) -> None:
    if keys is None:
        assert sorted(port) == sorted(ref), f"{what}: file sets differ"
        keys = port
    for rel in keys:
        assert port[rel] == ref[rel], f"{what}: {rel} differs"


def assert_conserved(m, files: dict) -> dict:
    """The kernel channel's law (per family, the committed spans' trips
    sum to micro_iters) and the drop and fabric ledgers' (the wire
    causes sum to packets_dropped; no fabric violation)."""
    trips = family_trips(files["kernel-sim.bin"])
    for fam, r in ((trev.FAM_PHOLD, m._dev_span),
                   (trev.FAM_TCP, m._dev_span_tcp)):
        assert trips.get(fam, 0) == (r.micro_iters if r else 0)
    stats = json.loads(files["sim-stats.json"])
    sim = stats["metrics"]["sim"]
    drops = sim.get("netstat", {}).get("drops", {})
    assert "unattributed" not in drops
    assert sum(drops.get(n, 0) for n in trev.TEL_NAMES[:trev.TEL_WIRE_N]) \
        == stats["packets_dropped"]
    assert sim["fabric"]["violations"] == 0
    assert sim["kern"]["records"] == len(files["kernel-sim.bin"]) \
        // trev.KS_REC_BYTES
    return stats


# name -> (YAML, the port runs it through the host build?, team)
PHOLD_CASES = {
    "phold-8": (lambda: channels_on(phold_yaml("tpu", spans="force")),
                False, 1),
    "mesh-8": (lambda: channels_on(mesh_yaml("tpu", spans="force")),
               True, 1),
    "codel-mesh-10": (lambda: channels_on(codel_yaml("tpu", spans="force")),
                      True, 8),
}


@pytest.fixture(scope="module")
def phold_runs(tmp_path_factory, libs):
    out = {}
    for name, (make, host, team) in PHOLD_CASES.items():
        d = tmp_path_factory.mktemp(name)
        m, port = port_run(make(), str(d / "port"),
                           libs=libs if host else None, team=team)
        out[name] = (m, port, jax_run(make(), str(d / "jax")))
    return out


@pytest.mark.parametrize("name", list(PHOLD_CASES))
def test_torch_channels_phold_family_match_jax_package(phold_runs, name):
    m, port, ref = phold_runs[name]
    assert_same(port, ref, name)
    for f in FILES:
        assert f in port
    for f in ("flight-sim.bin", "kernel-sim.bin"):
        assert port[f], f"{name}: {f} is empty"
    fb, _fct = trev.split_fabric(port["fabric-sim.bin"])
    assert fb, f"{name}: no queue sample"
    # The PHOLD family samples no TCP connection.
    assert port["telemetry-sim.bin"] == b""
    assert m._dev_span.spans > 0
    stats = assert_conserved(m, port)
    if name == "codel-mesh-10":
        assert stats["metrics"]["sim"]["netstat"]["drops"]["codel"] > 0
        depth = [r[3] for r in trev.iter_fb_records(fb)]
        assert max(depth) > 0


@pytest.fixture(scope="module")
def stream_runs(tmp_path_factory, libs):
    d = tmp_path_factory.mktemp("stream")
    tpu, port = port_run(stream(), str(d / "tpu"), libs=libs, team=32)
    tpc, port_tpc = port_run(stream(), str(d / "tpc"),
                             scheduler="thread_per_core")
    ref = jax_run(stream(), str(d / "jax"), scheduler="thread_per_core")
    return tpu, port, port_tpc, ref


def test_torch_channels_tcp_stream_samples_match(stream_runs):
    """Through the TCP span kernel's host build, the connection and queue
    samples equal the JAX package's engine run and the port's own engine
    run, byte for byte; only device spans write kernel records."""
    tpu, port, port_tpc, ref = stream_runs
    assert tpu._dev_span_tcp.spans > 0
    assert port["telemetry-sim.bin"] and port["kernel-sim.bin"]
    for f in ("telemetry-sim.bin", "fabric-sim.bin"):
        assert port[f] == ref[f], f
        assert port_tpc[f] == port[f], f
    assert port_tpc["kernel-sim.bin"] == b""
    assert ref["kernel-sim.bin"] == b""
    assert_conserved(tpu, port)
    rec = next(trev.iter_ks_records(port["kernel-sim.bin"]))
    assert rec[1] == trev.FAM_TCP and rec[2] == len(tpu.hosts)


def test_torch_channels_engine_baseline_matches_jax_package(stream_runs):
    """The port's engine thread_per_core run writes every channel's
    file as the JAX package's does."""
    _tpu, _port, port_tpc, ref = stream_runs
    assert_same(port_tpc, ref, "thread_per_core")


def test_torch_channels_incast_fabric_conserved(tmp_path, libs):
    """Twelve streams into one sink: CoDel drops at the sink's queue,
    every byte reconciled, and the queue samples and flow records equal
    the JAX package's engine run."""
    text = channels_on(incast_yaml(12, scheduler="tpu",
                                   device_spans="force")).replace(
        "experimental:\n", "experimental:\n  native_dataplane: on\n", 1)
    m, port = port_run(text, str(tmp_path / "port"), libs=libs, team=32)
    ref = jax_run(text, str(tmp_path / "jax"), scheduler="thread_per_core")
    for f in ("telemetry-sim.bin", "fabric-sim.bin"):
        assert port[f] == ref[f], f
    stats = assert_conserved(m, port)
    fab = stats["metrics"]["sim"]["fabric"]
    assert fab["dropped_pkts"] > 0 and stats["metrics"]["sim"][
        "fabric"]["records"] > 0
    fb, fct = trev.split_fabric(port["fabric-sim.bin"])
    assert fb and fct
    # The flow-completion table over the flow records, as the JAX
    # package's reports compute it.
    rows = [trev.FCT_REC.unpack_from(fct, k)
            for k in range(0, len(fct), trev.FCT_REC_BYTES)]
    assert fct_table(rows) == jax_fct_table(rows)
    assert fct_table(rows)[8080]["flows"] == 12


def test_torch_channels_pcap_matches_jax_package(tmp_path):
    """Engine pcap: the capture host keeps the sim off device spans (the
    engine refuses the export, as the reference's does), every span is
    a C++ span capped at pcap_span_cap rounds, and every file, the pcaps
    among them, equals the JAX package's forced run."""
    m, port = port_run(stream(pcap=True), str(tmp_path / "port"))
    ref = jax_run(stream(pcap=True), str(tmp_path / "jax"))
    assert_same(port, ref, "pcap")
    pcaps = [k for k in port if k.endswith(".pcap")]
    assert len(pcaps) == 2 and any(len(port[k]) > 24 for k in pcaps)
    assert m.audit.device_rounds() == 0
    assert port["kernel-sim.bin"] == b""
    dispatch = json.loads(open(tmp_path / "port" / "sim-stats.json").read())[
        "metrics"]["wall"]["dispatch"]
    assert dispatch["pcap_span_cap"] == 64


def test_torch_channels_off_write_no_file(tmp_path):
    text = phold_yaml("tpu", n_hosts=4, stop="300ms", spans="force")
    _m, port = port_run(text, str(tmp_path / "port"))
    assert not any(k in port for k in FILES + ("flight-wall.json",))
    assert not any(k.endswith(".pcap") for k in port)


@pytest.mark.slow
def test_torch_channels_tcp_plain_loop_matches_jax_spans(tmp_path):
    """The stream through the port's plain TCP loop against the JAX
    package's forced TCP spans: every file, flight and kernel records
    among them."""
    m, port = port_run(stream(), str(tmp_path / "port"))
    ref = jax_run(stream(), str(tmp_path / "jax"))
    assert_same(port, ref, "stream")
    assert m._dev_span_tcp.spans > 0
    assert_conserved(m, port)
