"""The syscall service plane and the quiescence gate on the port.

- `flight-sim.bin` and the packet trace of an 8-host managed sim at
  parallelism 4 are byte-identical across `serial`, `thread_per_core`
  and `tpu`, with the service plane on and off, and equal to the JAX
  package's: the plane runs managed hosts concurrently without touching
  any host's event order.
- The reference's quiescence shape (6-LP PHOLD beside one managed
  `sleep_time` host) under `tpu`: the rounds where every managed process
  sits parked land in C++ spans under `engine-span:managed-quiescent`,
  the audit counts equal the JAX package's and sum to the rounds, and
  the trace equals the `serial` run's.
"""

import functools
import os
import shutil
import subprocess

import pytest

torch = pytest.importorskip("torch")

from shadow_tpu.core.config import ConfigOptions as JConfig  # noqa: E402
from shadow_tpu.core.manager import run_simulation as jrun  # noqa: E402
from shadow_tpu_torch.core.config import ConfigOptions  # noqa: E402
from shadow_tpu_torch.core.manager import run_simulation  # noqa: E402
from shadow_tpu_torch.tools.netgen import phold_yaml  # noqa: E402

PLUGIN_DIR = os.path.join(os.path.dirname(__file__), "plugins")

pytestmark = pytest.mark.skipif(shutil.which("cc") is None,
                                reason="no C toolchain for the shim")


@pytest.fixture(scope="module")
def sleep_bin(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("plugins") / "sleep_time")
    subprocess.run(["cc", "-O1", "-o", out,
                    os.path.join(PLUGIN_DIR, "sleep_time.c")], check=True)
    return out


def _managed_dict(sleep_bin, datadir, scheduler, svc, n_hosts=8):
    return {
        "general": {"stop_time": "6s", "seed": 21, "parallelism": 4,
                    "data_directory": str(datadir)},
        "network": {"graph": {"type": "gml", "inline": """
graph [ node [ id 0 host_bandwidth_down "1 Gbit" host_bandwidth_up "1 Gbit" ]
  edge [ source 0 target 0 latency "10 ms" ] ]"""}},
        "experimental": {"scheduler": scheduler,
                         "native_dataplane": "off",
                         "flight_recorder": "on",
                         "syscall_service_plane": svc},
        "hosts": {f"h{i:02d}": {"network_node_id": 0, "processes": [
            {"path": sleep_bin, "start_time": f"{1 + i % 3}s"}]}
            for i in range(n_hosts)}}


def _outputs(m, d):
    with open(os.path.join(d, "flight-sim.bin"), "rb") as f:
        return f.read(), m.trace_lines()


@functools.lru_cache(maxsize=None)
def _jax_managed(sleep_bin, d):
    m, s = jrun(JConfig.from_dict(_managed_dict(sleep_bin, d, "serial",
                                                "off")), write_data=True)
    assert s.ok, s.plugin_errors[:3]
    return _outputs(m, d)


@pytest.mark.parametrize("scheduler,svc", [
    ("serial", "off"), ("serial", "on"), ("thread_per_core", "off"),
    ("thread_per_core", "on"), ("tpu", "off"), ("tpu", "on")])
def test_torch_service_plane_byte_identity(sleep_bin, tmp_path_factory,
                                           scheduler, svc):
    torch.set_num_threads(1)
    ref = _jax_managed(sleep_bin,
                       str(tmp_path_factory.getbasetemp() / "jax"))
    assert ref[0] and ref[1] == [], "the sim sends no packet"
    d = str(tmp_path_factory.mktemp(f"{scheduler}-{svc}"))
    m, s = run_simulation(ConfigOptions.from_dict(
        _managed_dict(sleep_bin, d, scheduler, svc)), device="cpu",
        write_data=True)
    assert s.ok, s.plugin_errors[:3]
    assert (m.svc is not None) == (svc == "on")
    if m.svc is not None:
        assert m.svc.workers == 4 and m.svc.hosts_serviced > 0
    assert _outputs(m, d) == ref


def _quiescence_text(sleep_bin, scheduler):
    text = phold_yaml(6, stop_time="3500ms", seed=17, scheduler=scheduler)
    return text + (f"  mgd00:\n    network_node_id: 0\n    processes:\n"
                   f"      - {{ path: {sleep_bin}, start_time: 500ms }}\n")


def test_torch_quiescence_gate_mixed_sim(sleep_bin, tmp_path):
    torch.set_num_threads(1)

    def port(scheduler):
        cfg = ConfigOptions.from_yaml_text(
            _quiescence_text(sleep_bin, scheduler))
        cfg.general.data_directory = str(tmp_path / scheduler)
        return run_simulation(cfg, device="cpu")

    jcfg = JConfig.from_yaml_text(_quiescence_text(sleep_bin, "tpu"))
    jcfg.general.data_directory = str(tmp_path / "jax")
    jm, js = jrun(jcfg)
    assert js.ok, js.plugin_errors[:3]
    m, s = port("tpu")
    assert s.ok, s.plugin_errors[:3]
    counts = m.audit.as_dict()
    assert m.audit.total() == s.rounds, counts
    assert counts.get("engine-span:managed-quiescent", 0) > 0, counts
    assert s.span_rounds > 0
    assert counts == jm.audit.as_dict()
    assert s.rounds == js.rounds
    assert m.trace_lines() == jm.trace_lines()
    m2, s2 = port("serial")
    assert s2.ok
    assert m.trace_lines() == m2.trace_lines()
