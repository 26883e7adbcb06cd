"""The reports over a data directory (`shadow_tpu_torch/tools/trace.py`,
`trace/chrome.py`), the port against the JAX package.

Directories, every channel on (`flight_recorder`, `sim_netstat`,
`sim_fabricstat`, `kernel_observatory`):

- written by the port on the CPU (tests/test_torch_channels.py
  `port_run`): the 16-host stream at 2% loss to 500 ms and the DCTCP
  incast (`incast_yaml(8, nbytes=300_000)`, `cc: dctcp, ecn: on`) with
  TCP spans forced through the host build of `stt_tcp_span`, the 10-host
  CoDel mesh cut to 3 s with PHOLD-family spans forced through the host
  build of `stt_phold_span` (its `chrome_top_n` set to 5), and the 8-LP
  PHOLD with spans forced through the port's plain loop;
- written by the JAX package: the reference's own kernel smoke shape
  (`smoke_kern`: `phold_yaml(8, n_init=2, ...)`, spans forced).

On each, the JAX package's report functions and the port's, each into
its own `io.StringIO`, print the same text byte for byte and return the
same verdicts; `chrome_trace` of both gives the same JSON under
`json.dumps(..., sort_keys=True)`; `main` gives the same exit code and
text for every subcommand.  Then the reference's report gates
(tests/test_trace.py, test_netstat.py, test_fabricstat.py,
test_kernstat.py) on the port's directories, the A7b refusals, and the
port's `--smoke` on the CPU.  Tolerance: exact.
"""

import contextlib
import io
import json
import os
import shutil

import pytest
import torch
import yaml

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu.tools import trace as jtrace
from shadow_tpu.trace import chrome as jchrome
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import run_simulation
from shadow_tpu_torch.tools import netgen
from shadow_tpu_torch.tools import trace as ptrace
from shadow_tpu_torch.trace import chrome as pchrome
from shadow_tpu_torch.trace import events as trev
from test_torch_channels import channels_on, libs, port_run  # noqa: F401
from test_torch_phold_span import codel_yaml, phold_yaml


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The eager loop runs thousands of small ops: one intra-op thread
    keeps the test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stream():
    return channels_on(netgen.tcp_stream_yaml(
        16, nbytes=50_000_000, loss=0.02, stop_time="500ms", seed=11,
        scheduler="tpu", device_spans="force"))


def _codel():
    return channels_on(codel_yaml("tpu", spans="force")).replace(
        "stop_time: 60s", "stop_time: 3s").replace(
        "experimental:\n", "experimental:\n  chrome_top_n: 5\n", 1)


def _incast():
    return channels_on(netgen.incast_yaml(
        8, nbytes=300_000, stop_time="1500ms", scheduler="tpu",
        device_spans="force", tcp={"cc": "dctcp", "ecn": "on"}))


# name -> (YAML, spans through the host builds?)
PORT_DIRS = {
    "tcp-stream-16": (_stream, True),
    "mesh-codel-10": (_codel, True),
    "phold-8": (lambda: channels_on(phold_yaml("tpu", spans="force")),
                False),
    "dctcp-incast-8": (_incast, True),
}
SHAPES = list(PORT_DIRS) + ["jax-kern-8"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory, libs):
    out = {}
    for name, (make, host) in PORT_DIRS.items():
        d = str(tmp_path_factory.mktemp(name) / "data")
        port_run(make(), d, libs=libs if host else None, team=8)
        out[name] = d
    # The JAX package's directory: tools/trace.py smoke_kern's shape.
    d = str(tmp_path_factory.mktemp("jax-kern-8") / "data")
    cfg = JConfig.from_yaml_text(netgen.phold_yaml(
        8, n_init=2, mean_delay_ns=20_000_000, stop_time="1s", seed=13,
        scheduler="tpu", device_spans="force"))
    cfg.experimental.kernel_observatory = "on"
    cfg.experimental.flight_recorder = "on"
    cfg.general.parallelism = 1
    cfg.general.data_directory = d
    _m, s = jrun(cfg, write_data=True)
    assert s.ok, s.plugin_errors
    out["jax-kern-8"] = d
    return out


REPORTS = ("summarize", "net_report", "fabric_report", "fct_report",
           "kern_report", "explain_report")


@pytest.mark.parametrize("report", REPORTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_torch_report_matches_jax_package(dirs, tmp_path, shape, report):
    """The same text and the same verdict; summarize's Chrome export the
    same JSON."""
    d = dirs[shape]
    kw = {}
    if report == "summarize":
        kw["chrome_out"] = str(tmp_path / "chrome.json")
    texts, verdicts, docs = [], [], []
    for mod in (ptrace, jtrace):
        buf = io.StringIO()
        verdicts.append(getattr(mod, report)(d, out=buf, **kw))
        texts.append(buf.getvalue())
        if kw:
            with open(kw["chrome_out"]) as f:
                docs.append(json.load(f))
    assert texts[0] == texts[1]
    assert verdicts[0] == verdicts[1]
    assert texts[0]
    if report in ("summarize", "net_report", "fabric_report",
                  "kern_report", "explain_report"):
        assert verdicts[0] is True, texts[0]
    if docs:
        assert json.dumps(docs[0], sort_keys=True) == \
            json.dumps(docs[1], sort_keys=True)
        assert docs[0]["traceEvents"]


def _channels(d: str) -> tuple:
    _stats, sim, wall, tel, _sc, fab = ptrace._load(d)
    fb = trev.split_fabric(fab)[0] if fab else b""
    return sim, wall, tel, fb, ptrace._kern_bytes(d)


@pytest.mark.parametrize("top_n", [3, pchrome.DEFAULT_TOP_N])
@pytest.mark.parametrize("shape", SHAPES)
def test_torch_chrome_trace_matches_jax_package(dirs, shape, top_n):
    sim, wall, tel, fb, ks = _channels(dirs[shape])
    port = pchrome.chrome_trace(sim, wall, tel, b"", fb, top_n,
                                ks_bytes=ks)
    ref = jchrome.chrome_trace(sim, wall, tel, b"", fb, top_n, ks_bytes=ks)
    assert json.dumps(port, sort_keys=True) == \
        json.dumps(ref, sort_keys=True)


SUBCOMMANDS = ([], ["net"], ["net", "--top", "3"], ["fabric"],
               ["fabric", "--top", "2"], ["fct"], ["kern"], ["explain"])


@pytest.mark.parametrize("argv", SUBCOMMANDS,
                         ids=["summary"] + [" ".join(a)
                                            for a in SUBCOMMANDS[1:]])
@pytest.mark.parametrize("shape", ["tcp-stream-16", "phold-8",
                                   "jax-kern-8"])
def test_torch_trace_cli_matches_jax_package(dirs, shape, argv):
    """`main`'s exit code and printed text for each subcommand."""
    d = dirs[shape]
    outs, rcs = [], []
    for mod in (ptrace, jtrace):
        args = [argv[0], d] + argv[1:] if argv else [d]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rcs.append(mod.main(args))
        outs.append(buf.getvalue())
    assert rcs[0] == rcs[1]
    assert outs[0] == outs[1]


def _managed_dir(d: str, tmp_path) -> str:
    """A copy of `d` whose processed config lists a managed process (a
    process given by filesystem path)."""
    dst = str(tmp_path / "managed")
    shutil.copytree(d, dst)
    path = os.path.join(dst, "processed-config.yaml")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    host = sorted(cfg["hosts"])[0]
    cfg["hosts"][host]["processes"][0]["path"] = "/usr/bin/true"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return dst


def _syscall_dir(d: str, tmp_path) -> str:
    dst = str(tmp_path / "syscalls")
    shutil.copytree(d, dst)
    with open(os.path.join(dst, "syscalls-sim.bin"), "wb") as f:
        f.write(b"\0" * 40)
    return dst


# Each refusal: what it runs on a directory (the 16-host stream's).
A7B = {
    "sys-subcommand": lambda d, tmp: ptrace.main(["sys", d]),
    "sys-report": lambda d, tmp: ptrace.sys_report(d),
    "chrome-syscall-channel": lambda d, tmp: pchrome.chrome_trace(
        b"", None, b"", b"\0" * 40),
    "summarize-syscall-channel": lambda d, tmp: ptrace.summarize(
        _syscall_dir(d, tmp), chrome_out=str(tmp / "c.json"),
        out=io.StringIO()),
    "explain-managed-hosts": lambda d, tmp: ptrace.explain_report(
        _managed_dir(d, tmp), out=io.StringIO()),
    "smoke-managed": lambda d, tmp: ptrace.smoke_managed(),
}


@pytest.mark.parametrize("case", list(A7B))
def test_torch_trace_a7b_parts_refused(dirs, tmp_path, case):
    with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
        A7B[case](dirs["tcp-stream-16"], tmp_path)


def test_torch_trace_smoke_on_cpu(capsys):
    """The port's --smoke at 8 hosts on the CPU: both simulated legs
    pass; the managed leg is named as not run; no span kernel launches
    on the CPU."""
    assert ptrace.main(["--smoke", "--hosts", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "trace smoke: ok (8 hosts" in out
    assert "trace smoke: kern leg ok" in out
    assert "managed leg not run" in out and "A7b" in out
    assert 'span kernel launches {"stt_tcp_span": 0, "stt_phold_span": 0}' \
        in out


def test_torch_trace_run_on_cpu(tmp_path, capsys):
    """`--run CONFIG --device cpu` runs the config with the flight
    recorder on and summarizes its directory."""
    cfg = tmp_path / "sim.yaml"
    cfg.write_text(netgen.phold_yaml(4, stop_time="300ms", scheduler="tpu"))
    d = str(tmp_path / "data")
    assert ptrace.main(["--run", str(cfg), d, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "all rounds accounted" in out
    assert os.path.exists(os.path.join(d, "flight-sim.bin"))


# ---------------------------------------------------------------------
# The reference's report gates on the port's directories
# ---------------------------------------------------------------------

# (shape, subcommand, substrings the printed text must hold): the gates
# of tests/test_trace.py (summarize), test_netstat.py (net, explain),
# test_fabricstat.py (fabric, fct) and test_kernstat.py (kern).
GATES = [
    ("tcp-stream-16", [], ("all rounds accounted", "sim-time channel")),
    ("mesh-codel-10", [], ("all rounds accounted", "sim-time channel")),
    ("tcp-stream-16", ["net"], ("conserved", "top", "retransmits")),
    ("dctcp-incast-8", ["net"], ("conserved", "top", "retransmits")),
    ("tcp-stream-16", ["explain"], ("remediation",)),
    ("dctcp-incast-8", ["fabric"], ("conservation", "peak queue depth",
                                    "sink", "mark:")),
    ("mesh-codel-10", ["fabric"], ("conservation", "peak queue depth")),
    ("dctcp-incast-8", ["fct"], ("p99", "8080")),
    ("phold-8", ["kern"], ("conservation", "pop",
                           "crossover attribution")),
    ("dctcp-incast-8", ["kern"], ("conservation", "pop",
                                  "crossover attribution")),
    ("phold-8", ["explain"], ("remediation",)),
]


@pytest.mark.parametrize("shape,argv,want", GATES,
                         ids=[f"{s}-{' '.join(a) or 'summary'}"
                              for s, a, _w in GATES])
def test_torch_report_gates(dirs, capsys, shape, argv, want):
    d = dirs[shape]
    assert ptrace.main([argv[0], d] + argv[1:] if argv else [d]) == 0
    out = capsys.readouterr().out
    for w in want:
        assert w in out, (w, out)


@pytest.mark.parametrize("shape", list(PORT_DIRS))
def test_torch_chrome_export_valid_nested(dirs, shape):
    """tests/test_trace.py's Chrome gate: valid JSON, round slices with
    their reason, spans bracketing rounds with every B closed, the wall
    phases on their own process; the counter tracks of every channel
    that has rows, with numeric args."""
    sim, wall, tel, fb, ks = _channels(dirs[shape])
    doc = json.loads(json.dumps(pchrome.chrome_trace(
        sim, wall, tel, b"", fb, ks_bytes=ks)))
    ev = doc["traceEvents"]
    phs = {e["ph"] for e in ev}
    rounds = [e for e in ev if e["ph"] == "X" and e["pid"] == pchrome.PID_SIM]
    assert rounds and all("reason" in e["args"] for e in rounds)
    assert "B" in phs and "E" in phs
    assert sum(e["ph"] == "B" for e in ev) == sum(e["ph"] == "E" for e in ev)
    assert any(e["pid"] == pchrome.PID_WALL and e["ph"] == "X" for e in ev)
    for pid, data in ((pchrome.PID_NETSTAT, tel), (pchrome.PID_FABRIC, fb),
                      (pchrome.PID_KERN, ks)):
        counters = [e for e in ev if e["ph"] == "C" and e["pid"] == pid]
        assert bool(counters) == bool(data), pid
        for e in counters[:50]:
            assert e["args"] and all(isinstance(v, (int, float))
                                     for v in e["args"].values())
    if ks:
        assert any("pop" in e["name"] for e in ev
                   if e["ph"] == "C" and e["pid"] == pchrome.PID_KERN)


def test_torch_chrome_top_n_caps_links_and_round_trips(dirs):
    """tests/test_fabricstat.py's top-N gates: the per-link tracks obey
    the cap, and experimental.chrome_top_n reaches the processed config
    and the CLI reads it back."""
    _sim, _wall, _tel, fb, _ks = _channels(dirs["dctcp-incast-8"])
    doc = pchrome.chrome_trace(b"", None, b"", b"", fb, top_n=3)
    links = {e["name"].split()[0] for e in doc["traceEvents"]
             if e["ph"] == "C" and e["pid"] == pchrome.PID_FABRIC}
    assert 0 < len(links) <= 3
    assert ptrace._chrome_top_n(dirs["mesh-codel-10"]) == 5
    assert ptrace._chrome_top_n(dirs["tcp-stream-16"]) == \
        pchrome.DEFAULT_TOP_N
    assert ConfigOptions.from_yaml_text(_codel()).experimental \
        .chrome_top_n == 5


def test_torch_explain_names_hottest_queue(dirs):
    """tests/test_fabricstat.py's gate on `_hottest_queue`: the incast's
    sink is named."""
    d = dirs["dctcp-incast-8"]
    _s, _sim, _w, _tel, _sc, fab = ptrace._load(d)
    out = io.StringIO()
    ptrace._hottest_queue(d, fab, out)
    assert "hottest queue" in out.getvalue() and "sink" in out.getvalue()


def test_torch_flight_off_leaves_no_artifacts(tmp_path):
    """tests/test_trace.py's gate: with the recorder off no flight file
    is written, and the eligibility block still sums to the rounds."""
    cfg = ConfigOptions.from_yaml_text(netgen.phold_yaml(
        4, stop_time="300ms", scheduler="tpu"))
    cfg.general.data_directory = d = str(tmp_path / "off")
    _m, s = run_simulation(cfg, device="cpu", write_data=True)
    assert s.ok
    assert not os.path.exists(os.path.join(d, "flight-sim.bin"))
    assert not os.path.exists(os.path.join(d, "flight-wall.json"))
    with open(os.path.join(d, "sim-stats.json")) as f:
        stats = json.load(f)
    elig = stats["metrics"]["wall"]["eligibility"]
    assert sum(elig.values()) == stats["rounds"]
    assert "flight" not in stats["metrics"]["sim"]
    assert ptrace.summarize(d, out=io.StringIO()) is True
