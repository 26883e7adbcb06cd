"""`python -m shadow_tpu_torch`: the reference CLI's flags the port
serves, the data directory it always writes, the heartbeat, and
processed-config.yaml.

The runs use the engine `thread_per_core` baseline (no device, a few
hundred ms of wall) unless a test is about `tpu`, which runs with
`--device cpu`.
"""

import io
import os
import re
import subprocess
import sys
import time

import pytest
import torch
import yaml

import shadow_tpu_torch
from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import Manager as JManager
from shadow_tpu_torch.__main__ import main
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import Manager
from test_determinism import collect
from test_torch_data_dir import assert_same_dirs, stream_yaml
from test_torch_phold_span import phold_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _config(tmp_path, text: str) -> str:
    path = tmp_path / "sim.yaml"
    path.write_text(text)
    return str(path)


def _stream(tmp_path, stop="300ms") -> str:
    """The 16-host stream YAML (engine plane on), stopped early."""
    return _config(tmp_path, stream_yaml("tpu").replace(
        "stop_time: 500ms", f"stop_time: {stop}"))


def _phold(tmp_path) -> str:
    text = phold_yaml("thread_per_core", stop="1s").replace(
        "experimental:\n", "experimental:\n  native_dataplane: on\n", 1)
    return _config(tmp_path, text)


def _progress_free(files: dict) -> dict:
    """The gate's normalized directory, with processed-config.yaml's
    `progress:` line (the one value `--progress` sets) normalized too."""
    out = dict(files)
    out["processed-config.yaml"] = re.sub(
        rb"progress: .*", b"progress: <normalized>",
        files["processed-config.yaml"])
    return out


def test_torch_cli_show_build_info_needs_no_config(capsys):
    assert main(["--show-build-info"]) == 0
    assert capsys.readouterr().out.strip() == \
        f"shadow-tpu-torch {shadow_tpu_torch.__version__}"
    assert main([]) == 2
    assert "config argument is required" in capsys.readouterr().err


def test_torch_cli_data_directory_tree(tmp_path, capsys):
    data = tmp_path / "out"
    rc = main([_stream(tmp_path), "--scheduler", "thread_per_core",
               "--data-directory", str(data), "--parallelism", "1"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "[shadow-tpu-torch] done: simulated 0.300s" in err
    assert "[shadow-tpu-torch] dispatch: " in err
    files = sorted(os.path.relpath(os.path.join(d, f), data)
                   for d, _s, fs in os.walk(data) for f in fs)
    cfg = ConfigOptions.from_yaml_text(stream_yaml("tpu"))
    want = ["hosts.txt", "packet-trace.txt", "processed-config.yaml",
            "sim-stats.json"]
    for name in sorted(cfg.hosts):
        for i, p in enumerate(cfg.hosts[name].processes):
            for ext in ("stdout", "stderr"):
                want.append(f"hosts/{name}/{p.path}.{i}.1000.{ext}")
    assert files == sorted(want)
    processed = yaml.safe_load((data / "processed-config.yaml").read_text())
    assert processed["general"]["data_directory"] == str(data)
    assert processed["general"]["parallelism"] == 1
    assert processed["experimental"]["scheduler"] == "thread_per_core"


def test_torch_cli_flags_override_the_config(tmp_path, capsys):
    data = tmp_path / "out"
    rc = main([_phold(tmp_path), "--seed", "5", "--stop-time", "400ms",
               "--data-directory", str(data), "--parallelism", "2"])
    assert rc == 0
    capsys.readouterr()
    processed = yaml.safe_load((data / "processed-config.yaml").read_text())
    assert processed["general"]["seed"] == 5
    assert processed["general"]["stop_time"] == "400000000 ns"
    assert processed["general"]["parallelism"] == 2


def test_torch_cli_tpu_on_the_cpu_writes_the_baselines_directory(
        tmp_path, capsys):
    """`--scheduler tpu --device cpu` against `--scheduler
    thread_per_core` on one YAML: identical normalized directories."""
    cfg = _stream(tmp_path)
    assert main([cfg, "--scheduler", "tpu", "--device", "cpu",
                 "--parallelism", "1",
                 "--data-directory", str(tmp_path / "tpu")]) == 0
    assert main([cfg, "--scheduler", "thread_per_core",
                 "--parallelism", "1",
                 "--data-directory", str(tmp_path / "tpc")]) == 0
    capsys.readouterr()
    assert_same_dirs(collect(str(tmp_path / "tpu")),
                     collect(str(tmp_path / "tpc")), "tpu vs baseline")


@pytest.mark.parametrize("sched", ["serial", "thread_per_host",
                                   "thread_per_core"])
def test_torch_cli_unserved_scheduler_exits_1(tmp_path, capsys, sched):
    """The object path's schedulers, once refused, are served: the CLI
    with `--scheduler` serial, thread_per_host and (with
    `native_dataplane: off`) thread_per_core writes the directory the
    JAX package's CLI writes for the same YAML."""
    from shadow_tpu.__main__ import main as jmain
    from test_parity_tpu import MULTI_NODE
    cfg = _config(tmp_path, MULTI_NODE.format(scheduler="tpu", seed=5)
                  .replace("experimental: { scheduler: tpu }",
                           "experimental: { scheduler: tpu, "
                           "native_dataplane: off }"))
    for cli, d in ((main, "port"), (jmain, "jax")):
        assert cli([cfg, "--scheduler", sched, "--parallelism", "2",
                    "--stop-time", "8s",
                    "--data-directory", str(tmp_path / d)]) == 0
    capsys.readouterr()
    port, ref = collect(str(tmp_path / "port")), \
        collect(str(tmp_path / "jax"))
    assert_same_dirs(port, ref, f"{sched} CLI")
    assert port["packet-trace.txt"]


def test_torch_cli_refused_config_exits_1(tmp_path, capsys):
    text = stream_yaml("tpu").replace("experimental:\n",
                                      "experimental:\n  tpu_shards: 2\n")
    assert main([_config(tmp_path, text)]) == 1
    assert "ROADMAP A5" in capsys.readouterr().err


def test_torch_cli_progress_on_and_off_same_directory(tmp_path, capsys):
    """`--progress` prints heartbeats (stderr is no TTY here) and
    changes nothing else: the heartbeat caps span limits without moving
    a window."""
    cfg = _stream(tmp_path, stop="300ms")
    text = open(cfg).read().replace(
        "general: {", "general: { heartbeat_interval: 50ms,", 1)
    with open(cfg, "w") as f:
        f.write(text)
    args = [cfg, "--scheduler", "tpu", "--device", "cpu",
            "--parallelism", "1"]
    assert main(args + ["--data-directory", str(tmp_path / "off")]) == 0
    quiet = capsys.readouterr().err
    assert main(args + ["--progress",
                        "--data-directory", str(tmp_path / "on")]) == 0
    loud = capsys.readouterr().err
    assert "heartbeat" not in quiet
    beats = [ln for ln in loud.splitlines() if " heartbeat: " in ln]
    assert len(beats) >= 4, loud[-2000:]
    assert_same_dirs(_progress_free(collect(str(tmp_path / "off"))),
                     _progress_free(collect(str(tmp_path / "on"))),
                     "progress")


def _shape(line: str) -> str:
    """A heartbeat line with its numbers and its meminfo object
    blanked."""
    line = re.sub(r"\{.*\}", "{...}", line)
    return re.sub(r"\d+(\.\d+)?", "N", line)


def test_torch_heartbeat_keeps_the_references_lines(tmp_path):
    """The heartbeat line after the port's prefix, and the two
    tornettools resource lines word for word, against the JAX package's
    `_log_heartbeat` on the same config."""
    text = open(_stream(tmp_path)).read().replace(
        "  scheduler: tpu", "  scheduler: thread_per_core")
    out, ref = io.StringIO(), io.StringIO()
    Manager(ConfigOptions.from_yaml_text(text))._log_heartbeat(
        250_000_000, 500_000_000, time.perf_counter() - 1.0, out)
    JManager(JConfig.from_yaml_text(text))._log_heartbeat(
        250_000_000, 500_000_000, time.perf_counter() - 1.0, ref)
    got, want = out.getvalue().splitlines(), ref.getvalue().splitlines()
    assert len(got) == len(want) == 3
    assert got[0].startswith("[shadow-tpu-torch] heartbeat: sim 0.250s / "
                             "0.500s (50.0%), ")
    assert _shape(got[0]).replace("[shadow-tpu-torch]", "") == \
        _shape(want[0]).replace("[shadow-tpu]", "")
    assert got[1].startswith("Process resource usage at simtime "
                             "250000000 reported by getrusage(): ")
    assert got[2].startswith("System memory usage in bytes at simtime "
                             "250000000 ns reported by /proc/meminfo: {")
    for g, w in zip(got[1:], want[1:]):
        assert _shape(g) == _shape(w)


@pytest.mark.parametrize("make", ["stream", "phold"])
def test_torch_processed_config_round_trips_and_matches_jax(tmp_path,
                                                            capsys, make):
    cfg = _stream(tmp_path) if make == "stream" else _phold(tmp_path)
    data = tmp_path / "out"
    assert main([cfg, "--scheduler", "thread_per_core",
                 "--data-directory", str(data)]) == 0
    capsys.readouterr()
    written = (data / "processed-config.yaml").read_text()
    # Reloads through the port's loader, and gives the same file again.
    again = yaml.safe_dump(
        ConfigOptions.from_yaml_text(written).to_processed_dict(),
        sort_keys=False, default_flow_style=False)
    assert again == written
    # The JAX package's file for the same input and overrides.
    jcfg = JConfig.from_yaml_text(open(cfg).read())
    jcfg.general.data_directory = str(data)
    jcfg.experimental.scheduler = "thread_per_core"
    assert yaml.safe_dump(jcfg.to_processed_dict(), sort_keys=False,
                          default_flow_style=False) == written


def test_torch_processed_config_carries_every_reference_key():
    """Keys the port only carries (managed-process timing, sharded
    sizing, host options, process environment) keep their values."""
    text = stream_yaml("tpu").replace(
        "experimental:\n",
        "experimental:\n  unblocked_syscall_latency: 2 us\n"
        "  tpu_exchange_capacity: 512\n  syscall_service_plane: off\n"
        "  chrome_top_n: 4\n", 1).replace(
        "general: {", "general: { template_directory: tmpl, "
        "log_level: debug, progress: true,", 1)
    text = text.replace("path: tgen-server,",
                        "path: tgen-server, environment: {A: 1},", 1)
    port = ConfigOptions.from_yaml_text(text).to_processed_dict()
    ref = JConfig.from_yaml_text(text).to_processed_dict()
    assert yaml.safe_dump(port, sort_keys=False) == \
        yaml.safe_dump(ref, sort_keys=False)
    assert port["general"]["progress"] is True
    assert any(p.get("environment") == {"A": "1"}
               for h in port["hosts"].values() for p in h["processes"])


def test_torch_cli_runs_as_a_module(tmp_path):
    """`python -m shadow_tpu_torch` in a child process: exit 0 and the
    data directory written."""
    data = tmp_path / "out"
    p = subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch", _stream(tmp_path),
         "--scheduler", "thread_per_core", "--parallelism", "1",
         "--data-directory", str(data)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert (data / "sim-stats.json").exists()
