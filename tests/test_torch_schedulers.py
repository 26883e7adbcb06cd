"""The port's two schedulers: `tpu` and the engine `thread_per_core`
baseline (`native_dataplane: on`).

1. The baseline against the port's `tpu` run and against the JAX
   package's engine `thread_per_core` run on the same YAML: identical
   data directories under the determinism gate's `collect` rules, and
   `packets_sent` and `busy_end_ns` equal (bench.py's cross-scheduler
   gate).
2. The eligibility audit: every round of a `thread_per_core` run is
   `per-round:scheduler`, and every run's audit sums to its rounds.
3. The baseline builds no torch device: with CUDA absent and no
   `device` argument it runs, where `tpu` raises.
4. The object path's schedulers (`serial`, `thread_per_host`,
   `thread_per_core` without `native_dataplane: on`), once refused
   naming ROADMAP A2b, are served: the YAML and an override build a
   Manager with no engine and the scalar propagator, and `tpu` with
   `native_dataplane: off` one with no engine and the per-round kernel's
   propagator (tests/test_torch_object_path.py runs them against the
   JAX package).

Each cell's `tpu` run is made once (module-scoped) and read by every
test that needs it.
"""

import pytest
import torch

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu.trace.audit import render_report as ref_render_report
from shadow_tpu_torch.core import manager as port_manager
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import Manager, run_simulation
from shadow_tpu_torch.core.propagate_scalar import ScalarPropagator
from shadow_tpu_torch.tools.netgen import tier10k_yaml
from shadow_tpu_torch.trace.audit import render_report
from shadow_tpu_torch.trace.events import EL_NAMES, EL_ROUND_SCHED
from test_determinism import collect
from test_torch_data_dir import (assert_conserved, assert_same_dirs,
                                 port_dir, stream_yaml)
from test_torch_phold_span import phold_yaml


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _with_plane(text: str) -> str:
    if "native_dataplane" in text:
        return text
    return text.replace("experimental:\n",
                        "experimental:\n  native_dataplane: on\n", 1)


CELLS = {
    "phold-8": lambda s: _with_plane(phold_yaml(s, spans="force")),
    "tier-200": lambda s: tier10k_yaml(
        scheduler=s, stop_s=2, n_hosts=200,
        experimental_extra={"tpu_min_device_batch": 0,
                            "native_dataplane": "on"}),
    "tcp-stream-16": stream_yaml,
}


@pytest.fixture(scope="module")
def tpu_runs(tmp_path_factory):
    """Each cell's `tpu` run, made once for every test that reads it:
    name -> (manager, summary, data directory)."""
    made = {}

    def get(name):
        if name not in made:
            d = str(tmp_path_factory.mktemp(f"{name}-tpu"))
            made[name] = port_dir(CELLS[name]("tpu"), d, "tpu") + (d,)
        return made[name]
    return get


@pytest.mark.parametrize("name", list(CELLS))
def test_torch_baseline_matches_tpu_and_jax_baseline(tmp_path, tpu_runs,
                                                      name):
    text = CELLS[name]("tpu")
    mb, sb = port_dir(text, str(tmp_path / "tpc"), "thread_per_core")
    mt, st, tpu_dir = tpu_runs(name)
    jcfg = JConfig.from_yaml_text(CELLS[name]("thread_per_core"))
    jcfg.general.parallelism = 1
    jcfg.general.data_directory = str(tmp_path / "jax")
    _jm, sj = jrun(jcfg, write_data=True)
    base = collect(str(tmp_path / "tpc"))
    assert_same_dirs(base, collect(tpu_dir), f"{name} tpu")
    assert_same_dirs(base, collect(str(tmp_path / "jax")), f"{name} jax")
    assert_conserved(str(tmp_path / "tpc"))
    # bench.py's cross-scheduler gate
    for s in (st, sj):
        assert (s.packets_sent, s.busy_end_ns) == \
            (sb.packets_sent, sb.busy_end_ns)
    # The audit: one reason a round; the baseline's all per-round.
    assert mb.audit.counts[EL_ROUND_SCHED] == sb.rounds > 0
    assert mb.audit.total() == sb.rounds
    assert mt.audit.total() == st.rounds
    assert mb.device is None and isinstance(mb.propagator,
                                            ScalarPropagator)
    assert mb._dev_span is None and mb._dev_span_tcp is None
    assert sb.span_rounds == 0


def test_torch_audit_sums_to_rounds_on_every_route(tpu_runs):
    """The C++-span, device-span and per-round routes of one `tpu` run
    (the stream's handshake is out of the device domain) each credit
    their own reasons, and the reasons sum to the rounds."""
    m, s, _d = tpu_runs("tcp-stream-16")
    counts = m.audit.as_dict()
    assert sum(counts.values()) == s.rounds
    assert counts["device-span"] == m._dev_span_tcp.rounds > 0
    assert set(counts) <= set(EL_NAMES)
    assert m.audit.span_rounds() == s.span_rounds
    # The attribution table, the JAX package's text for the same counts.
    report = render_report(counts, s.rounds)
    assert report == ref_render_report(counts, s.rounds)
    assert "(all rounds accounted)" in report


def test_torch_baseline_builds_no_torch_device(monkeypatch, tmp_path):
    """With CUDA absent and no `device` argument the baseline runs and
    never resolves a device; `tpu` raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_device(device=None):
        raise AssertionError("the baseline resolved a torch device")

    text = stream_yaml("thread_per_core")
    cfg = ConfigOptions.from_yaml_text(text)
    cfg.general.parallelism = 1
    cfg.general.stop_time_ns = 300_000_000
    with monkeypatch.context() as mp:
        mp.setattr(port_manager, "resolve_device", no_device)
        m, s = run_simulation(cfg)
    assert m.device is None and s.ok and s.packets_sent > 0
    with pytest.raises(RuntimeError, match="CUDA"):
        Manager(ConfigOptions.from_yaml_text(stream_yaml("tpu")))


@pytest.mark.parametrize("sched,plane", [
    ("serial", "on"), ("thread_per_host", "on"),
    ("thread_per_core", None), ("thread_per_core", "auto"),
    ("thread_per_core", "off")])
def test_torch_unserved_schedulers_name_a2b(sched, plane):
    text = stream_yaml(sched).replace("  native_dataplane: on\n", "")
    if plane is not None:
        text = text.replace("experimental:\n", "experimental:\n  "
                            f"native_dataplane: {plane}\n", 1)
    cfgs = [ConfigOptions.from_yaml_text(text)]
    # The same scheduler by an override of a tpu config.
    cfg = ConfigOptions.from_yaml_text(stream_yaml("tpu").replace(
        "  native_dataplane: on\n", "" if plane is None
        else f"  native_dataplane: {plane}\n"))
    cfg.experimental.scheduler = sched
    cfgs.append(cfg)
    for cfg in cfgs:
        m = Manager(cfg, device="cpu")
        assert m.plane is None and m.device is None
        assert isinstance(m.propagator, ScalarPropagator)
        assert all(h.plane is None for h in m.hosts)
        assert (m._pool is None) == (sched == "serial")
        if m._pool is not None:
            m._pool.shutdown()
    # tpu with the engine off: every host on the object path, the
    # per-round kernel's propagator.
    cfg = ConfigOptions.from_yaml_text(stream_yaml("tpu").replace(
        "  native_dataplane: on\n", "  native_dataplane: off\n"))
    m = Manager(cfg, device="cpu")
    assert m.plane is None and not isinstance(m.propagator,
                                              ScalarPropagator)
