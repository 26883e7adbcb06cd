"""The port's data directory against the JAX package's.

The same YAML through `shadow_tpu_torch.core.manager.run_simulation(cfg,
device="cpu", write_data=True)` under `scheduler: tpu` and through the
JAX package's `run_simulation(cfg, write_data=True)`: every file of the
two data directories byte-identical under the determinism gate's
`collect` rules (tests/test_determinism.py: `metrics.wall` stripped;
the data_directory, scheduler and parallelism lines of
processed-config.yaml normalized).  That covers packet-trace.txt, the
hosts' stdout and stderr, hosts.txt, processed-config.yaml and
sim-stats.json's summary, `metrics.sim`, `objects` and `hosts`.

Shapes: the 8-LP PHOLD and the 8-host udp-mesh with forced device
spans, the 10-host CoDel mesh (so `netstat.drops` and the fabric's
drop side are not empty), the 200-host tier with every round through
the per-round kernel (`tpu_min_device_batch: 0`), and the 16-host
stream at 2% loss with forced device spans (against the JAX package's
engine `thread_per_core` run, which compiles no JAX span).  The PHOLD
run's spans go through the port's plain loop; the meshes' and the
stream's through the host builds of the span kernels
(tests/test_torch_channels.py `libs`: the kernels' phases in turn),
which step the same states in a fraction of the eager loop's time.
Each run also holds the conservation contract: the wire causes sum to
`packets_dropped`, and `fabric.violations` is 0.
"""

import json
import os

import pytest
import torch

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import Manager, run_simulation
from shadow_tpu_torch.tools.netgen import tcp_stream_yaml, tier10k_yaml
from shadow_tpu_torch.trace.events import (EL_ROUND_FORCED, TEL_NAMES,
                                           TEL_WIRE_N)
from test_determinism import collect
from test_torch_channels import libs, phold_factory, tcp_factory  # noqa: F401
from test_torch_phold_span import codel_yaml, mesh_yaml, phold_yaml


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The eager loop runs thousands of small ops: one intra-op thread
    keeps the test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def stream_yaml(scheduler):
    """The 16-host stream at 2% loss to 500 ms, spans forced, with the
    engine plane asked for by name (the thread_per_core baseline
    needs it; tpu builds it either way)."""
    return tcp_stream_yaml(16, nbytes=50_000_000, loss=0.02,
                           stop_time="500ms", seed=11, scheduler=scheduler,
                           device_spans="force").replace(
        "experimental:\n", "experimental:\n  native_dataplane: on\n", 1)


def tier_yaml(scheduler):
    return tier10k_yaml(scheduler=scheduler, stop_s=2, n_hosts=200,
                        experimental_extra={"tpu_min_device_batch": 0})


# name -> (YAML for a scheduler, the JAX package's scheduler, the span
# kernels' host builds step the port's spans)
CASES = {
    "phold-8": (lambda s: phold_yaml(s, spans="force"), "tpu", False),
    "mesh-8": (lambda s: mesh_yaml(s, spans="force"), "tpu", True),
    "codel-mesh-10": (lambda s: codel_yaml(s, spans="force"), "tpu", True),
    "tier-200": (tier_yaml, "tpu", False),
    "tcp-stream-16": (stream_yaml, "thread_per_core", True),
}


def port_dir(text: str, data: str, scheduler="tpu", libs=None):
    """The port's run into `data`; with `libs`, the span kernels' host
    builds step every device span (a team of 8 ranks)."""
    cfg = ConfigOptions.from_yaml_text(text)
    cfg.general.parallelism = 1
    cfg.general.data_directory = data
    cfg.experimental.scheduler = scheduler
    if libs is None:
        device = "cpu" if scheduler == "tpu" else None
        m, s = run_simulation(cfg, device=device, write_data=True)
    else:
        m = Manager(cfg, device="cpu")
        m._dev_span = m.make_dev_span_runner()
        m._dev_span.span_factory = phold_factory(libs["phold"], 8)
        m._dev_span_tcp = m.make_tcp_span_runner()
        m._dev_span_tcp.span_factory = tcp_factory(libs["tcp"], 8)
        s = m.run()
        m.write_data_dir(s)
    assert s.ok, s.plugin_errors
    return m, s


def jax_dir(text: str, data: str):
    cfg = JConfig.from_yaml_text(text)
    cfg.general.parallelism = 1
    cfg.general.data_directory = data
    m, s = jrun(cfg, write_data=True)
    assert s.ok, s.plugin_errors
    return m, s


def assert_same_dirs(a: dict, b: dict, what: str) -> None:
    assert sorted(a) == sorted(b), f"{what}: file sets differ"
    for rel in a:
        assert a[rel] == b[rel], f"{what}: {rel} differs"


def assert_conserved(data: str) -> dict:
    """The conservation contract of sim-stats.json's sim channel."""
    with open(os.path.join(data, "sim-stats.json")) as f:
        stats = json.load(f)
    sim = stats["metrics"]["sim"]
    drops = sim.get("netstat", {}).get("drops", {})
    assert "unattributed" not in drops
    wire = sum(drops.get(n, 0) for n in TEL_NAMES[:TEL_WIRE_N])
    assert wire == stats["packets_dropped"]
    assert sim["fabric"]["violations"] == 0
    return stats


@pytest.mark.parametrize("name", list(CASES))
def test_torch_data_dir_matches_jax_package(tmp_path, request, name):
    make, jsched, host = CASES[name]
    m, s = port_dir(make("tpu"), str(tmp_path / "port"),
                    libs=request.getfixturevalue("libs") if host else None)
    jax_dir(make(jsched), str(tmp_path / "jax"))
    port, ref = collect(str(tmp_path / "port")), \
        collect(str(tmp_path / "jax"))
    assert_same_dirs(port, ref, name)
    stats = assert_conserved(str(tmp_path / "port"))
    # The run really took the device paths it names.
    if name == "tier-200":
        # every round forced; every round with packets on the kernel
        assert m.audit.counts[EL_ROUND_FORCED] == s.rounds
        prop = m.propagator
        assert prop.rounds_device == prop.rounds_dispatched > 0
    else:
        assert m.audit.device_rounds() > 0
    assert "packet-trace.txt" in port and port["packet-trace.txt"]
    if name == "codel-mesh-10":
        drops = stats["metrics"]["sim"]["netstat"]["drops"]
        assert drops.get("codel", 0) > 0
        assert stats["metrics"]["sim"]["fabric"]["dropped_pkts"] > 0
    if name == "tcp-stream-16":
        assert stats["metrics"]["sim"]["netstat"]["drops"]["loss-edge"] > 0
