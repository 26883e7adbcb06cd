"""Whole simulations on the port's object path against the JAX package.

Each YAML runs once through the JAX package's `serial` scheduler (the
reference trace) and through the port under every scheduler that
serves it, on the CPU: `serial`, the pure-Python `thread_per_core`,
`thread_per_host`, and `tpu` with `native_dataplane: off` on both
propagation routes (the route model's choice, which keeps these small
rounds on the law's numpy twin, and `tpu_min_device_batch: 0`, every
outbox chunk through the kernel's wrapper, whose plain version
`propagate_ref` runs on CPU tensors).  Every trace must be
byte-identical to the reference's, and so must every process's stdout.

Configs: tests/test_parity_tpu.py's MULTI_NODE (UDP over lossy edges),
tests/test_e2e_tcp.py's 1 MB and lossy transfers, an `http-server` host
fetched by a tgen client, the CPU model of tests/test_cpu_model.py,
`use_perf_timers`, and a `tpu_max_packets_per_round` small enough to
chunk every round's outbox.  Then the mixed tier: 200 engine hosts of
bench.py's config_10k beside 2 pcap'd object-path clients (per-host
`native_dataplane: false`), whose whole data directory (pcaps
included) must equal the JAX package's under the determinism gate's
rules, with the same eligibility audit (its `object-path:*` reasons
among them), under `tpu` and under the engine `thread_per_core`.
"""

import functools
import os

import pytest

from shadow_tpu.core.config import ConfigOptions as JConfig
from shadow_tpu.core.manager import run_simulation as jrun
from shadow_tpu_torch.core.config import ConfigOptions
from shadow_tpu_torch.core.manager import run_simulation
from shadow_tpu_torch.core.propagate_scalar import ScalarPropagator
from shadow_tpu_torch.ops.propagate import TpuPropagator
from shadow_tpu_torch.tools.netgen import pcap_clients, tier10k_yaml
from test_determinism import collect
from test_e2e_tcp import CFG as TCP_CFG
from test_parity_tpu import MULTI_NODE
from test_torch_data_dir import assert_conserved, assert_same_dirs

# name -> (scheduler, experimental overrides)
ROUTES = {
    "serial": ("serial", {}),
    "thread_per_core": ("thread_per_core", {}),
    "thread_per_host": ("thread_per_host", {}),
    "tpu-auto": ("tpu", {"native_dataplane": "off"}),
    "tpu-forced": ("tpu", {"native_dataplane": "off",
                           "tpu_min_device_batch": 0}),
}

HTTP = """
general: { stop_time: 8s, seed: 31 }
network:
  graph:
    type: gml
    inline: |
      graph [ node [ id 0 host_bandwidth_down "1 Gbit" host_bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "5 ms" ] ]
experimental: { scheduler: serial }
hosts:
  web:
    network_node_id: 0
    processes:
      - { path: udp-sink, args: ["9000", "1000"], start_time: 50ms }
      - { path: http-server, args: ["8080", "5000"], start_time: 60ms,
          expected_final_state: running }
  flooder:
    network_node_id: 0
    processes:
      - { path: udp-flood, args: ["web", "9000", "5", "200"],
          start_time: 100ms }
  fetcher:
    network_node_id: 0
    processes:
      - { path: tgen-client, args: ["web", "8080", "1", "1"],
          start_time: 200ms, expected_final_state: any }
"""

CPU_MODEL = """
general: { stop_time: 10s, seed: 1 }
experimental:
  scheduler: serial
  host_cpu_threshold: 10 us
  host_cpu_event_cost: 300 us
network:
  graph:
    type: gml
    inline: |
      graph [
        node [ id 0 host_bandwidth_down "1 Gbit" host_bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" ]
      ]
hosts:
  echo:
    network_node_id: 0
    processes:
      - { path: udp-echo-server, args: ["7000"],
          expected_final_state: running }
      - { path: udp-sink, args: ["7100"], expected_final_state: running }
  pinger:
    network_node_id: 0
    processes:
      - { path: udp-pinger, args: ["echo", "7000", "20"],
          start_time: 1s, expected_final_state: any }
  flooder:
    network_node_id: 0
    processes:
      - { path: udp-flood, args: ["echo", "7100", "2000", "200"],
          start_time: 1s, expected_final_state: any }
"""


def _tcp(nbytes, loss, seed):
    return TCP_CFG.format(scheduler="serial", nbytes=nbytes, count=1,
                          loss=loss, latency="10 ms", seed=seed,
                          stop="60s")


CONFIGS = {
    "multi-node": MULTI_NODE.format(scheduler="serial", seed=11),
    "tcp-1mb": _tcp(1_000_000, 0.0, 1),
    "tcp-lossy": _tcp(300_000, 0.02, 7),
    "http-server": HTTP,
    "cpu-model": CPU_MODEL,
}


def _stdouts(m) -> dict:
    return {(h.name, p.name): bytes(p.stdout) + bytes(p.stderr)
            for h in m.hosts for p in h.processes.values()}


@functools.lru_cache(maxsize=None)
def reference(name: str, **exp):
    """The JAX package's serial run: (trace lines, stdouts, summary)."""
    cfg = JConfig.from_yaml_text(CONFIGS[name])
    for k, v in exp.items():
        setattr(cfg.experimental, k, v)
    m, s = jrun(cfg)
    assert s.ok, s.plugin_errors
    return m.trace_lines(), _stdouts(m), s


def port_run(name: str, route: str, **exp):
    sched, over = ROUTES[route]
    cfg = ConfigOptions.from_yaml_text(CONFIGS[name])
    cfg.experimental.scheduler = sched
    cfg.general.parallelism = 2
    for k, v in {**over, **exp}.items():
        setattr(cfg.experimental, k, v)
    m, s = run_simulation(cfg, device="cpu" if sched == "tpu" else None)
    assert s.ok, s.plugin_errors
    return m, s


def assert_same_run(name: str, route: str, **exp):
    lines, outs, js = reference(name)
    m, s = port_run(name, route, **exp)
    assert len(lines) > 20
    assert m.trace_lines() == lines, f"{name} under {route}: traces differ"
    assert _stdouts(m) == outs
    assert (s.rounds, s.events, s.packets_sent, s.packets_recv,
            s.packets_dropped, s.syscalls) == \
        (js.rounds, js.events, js.packets_sent, js.packets_recv,
         js.packets_dropped, js.syscalls)
    assert m.plane is None
    prop = m.propagator
    if ROUTES[route][0] == "tpu":
        assert isinstance(prop, TpuPropagator)
        if "tpu_min_device_batch" in ROUTES[route][1]:
            # every chunk through the kernel's wrapper
            assert prop.rounds_device == prop.rounds_dispatched > 0
            assert prop.rounds_device_object == prop.rounds_device
        else:
            assert prop.rounds_device == 0 and prop.rounds_dispatched > 0
    else:
        assert isinstance(prop, ScalarPropagator)
    return m, s


@pytest.mark.parametrize("route", list(ROUTES))
def test_torch_object_path_multi_node(route):
    m, _s = assert_same_run("multi-node", route)
    assert any("inet-loss" in ln for ln in m.trace_lines())


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", ["tcp-1mb", "tcp-lossy"])
def test_torch_object_path_tcp_transfers(name, route):
    m, _s = assert_same_run(name, route)
    out = _stdouts(m)[("client", "tgen-client.0")].decode()
    want = 1_000_000 if name == "tcp-1mb" else 300_000
    assert f"transfer 0 ok bytes={want}" in out


@pytest.mark.parametrize("route", ["serial", "thread_per_core",
                                   "tpu-forced"])
def test_torch_object_path_http_server(route):
    m, _s = assert_same_run("http-server", route)
    # The fetcher's connection reached the server's listener: its
    # request segment and the server's acks are in the trace.
    lines = m.trace_lines()
    assert any(" web RCV tcp " in ln and ":8080 len=" in ln
               and " len=0 " not in ln for ln in lines)
    assert any(" fetcher RCV tcp " in ln and ":8080>" in ln
               for ln in lines)


@pytest.mark.parametrize("route", ["serial", "tpu-auto", "tpu-forced"])
def test_torch_object_path_cpu_model(route):
    m, _s = assert_same_run("cpu-model", route)
    echo = next(h for h in m.hosts if h.name == "echo")
    assert echo.cpu is not None and echo.cpu_event_cost_ns == 300_000


@pytest.mark.parametrize("route", ["serial", "thread_per_core",
                                   "tpu-auto"])
def test_torch_object_path_perf_timers(route):
    m, _s = assert_same_run("multi-node", route, use_perf_timers=True)
    assert m._pool is None  # perf timers run the hosts serially
    assert sum(h.perf_exec_ns for h in m.hosts) > 0


@pytest.mark.parametrize("route", ["tpu-auto", "tpu-forced"])
def test_torch_object_path_chunked_outbox(route):
    """A round's outbox in chunks of at most 2 packets: one dispatch a
    chunk, the same trace."""
    m, _s = assert_same_run("multi-node", route,
                            tpu_max_packets_per_round=2)
    prop = m.propagator
    assert prop.rounds_dispatched > prop.packets_batched // 2 - 1
    assert max(prop.chunk_sizes) == 2


def _mixed(scheduler: str) -> str:
    return tier10k_yaml(scheduler, stop_s=2, n_hosts=200,
                        extra_hosts=pcap_clients(2))


def _mixed_dir(pkg: str, scheduler: str, data: str, **exp):
    cfg = (JConfig if pkg == "jax" else ConfigOptions).from_yaml_text(
        _mixed(scheduler))
    cfg.general.parallelism = 1
    cfg.general.data_directory = data
    for k, v in exp.items():
        setattr(cfg.experimental, k, v)
    if pkg == "jax":
        m, s = jrun(cfg, write_data=True)
    else:
        m, s = run_simulation(cfg, write_data=True,
                              device="cpu" if scheduler == "tpu" else None)
    assert s.ok, s.plugin_errors
    return m, s


@pytest.mark.parametrize("scheduler", ["tpu", "thread_per_core"])
def test_torch_mixed_tier_pcap_data_dir(tmp_path, scheduler):
    exp = {} if scheduler == "tpu" else {"native_dataplane": "on"}
    m, s = _mixed_dir("port", scheduler, str(tmp_path / "port"), **exp)
    jm, js = _mixed_dir("jax", scheduler, str(tmp_path / "jax"), **exp)
    port, ref = collect(str(tmp_path / "port")), \
        collect(str(tmp_path / "jax"))
    assert_same_dirs(port, ref, f"mixed tier under {scheduler}")
    assert_conserved(str(tmp_path / "port"))
    pcaps = sorted(k for k in port if k.endswith(".pcap"))
    assert pcaps == [os.path.join("hosts", f"pcap{i:02d}", f"{n}.pcap")
                     for i in range(2) for n in ("eth0", "lo")]
    assert all(len(port[k]) > 24 for k in pcaps if k.endswith("eth0.pcap"))
    # Two planes: the pcap'd clients on the object path, the rest on the
    # engine, packets crossing both ways.
    obj = [h for h in m.hosts if h.plane is None]
    assert sorted(h.name for h in obj) == ["pcap00", "pcap01"]
    assert all(h.counters["packets_recv"] > 0 for h in obj)
    assert m.audit.as_dict() == jm.audit.as_dict()
    if scheduler == "tpu":
        audit = m.audit.as_dict()
        assert audit.get("object-path:pcap", 0) > 0
        assert audit.get("engine-span:py-limit", 0) > 0
        assert s.span_rounds * 2 >= s.rounds


def test_torch_pool_pinning_order_matches_reference():
    """`use_cpu_pinning`'s CPU order for the Python host pool: the
    reference's topology walk on this machine's CPUs, and a permutation
    of them."""
    import os

    from shadow_tpu.core.manager import _topology_cpu_order as ref_order
    from shadow_tpu_torch.core.manager import _make_pinner, \
        _topology_cpu_order
    cpus = sorted(os.sched_getaffinity(0))
    assert _topology_cpu_order(cpus) == ref_order(cpus)
    assert sorted(_topology_cpu_order(cpus)) == cpus
    assert _topology_cpu_order([10_000, 10_001]) == [10_000, 10_001]
    assert callable(_make_pinner())


CHANNELS = {"flight_recorder": "on", "sim_netstat": "on",
            "sim_fabricstat": "on", "kernel_observatory": "on",
            "netstat_interval_ns": 0, "fabricstat_interval_ns": 0}


@pytest.mark.parametrize("route", ["serial", "tpu-auto"])
def test_torch_object_path_channels_data_dir(tmp_path, route):
    """Every sim-time channel on, every round sampled, over the lossy TCP
    transfer on the object path: the whole data directory (flight,
    telemetry, fabric and kernel files among it) equals the JAX
    package's for the same scheduler and plane."""
    sched, over = ROUTES[route]
    dirs = {}
    for pkg, conf in (("port", ConfigOptions), ("jax", JConfig)):
        cfg = conf.from_yaml_text(CONFIGS["tcp-lossy"])
        cfg.experimental.scheduler = sched
        cfg.general.data_directory = str(tmp_path / pkg)
        for k, v in {**over, **CHANNELS}.items():
            setattr(cfg.experimental, k, v)
        if pkg == "port":
            m, s = run_simulation(cfg, write_data=True,
                                  device="cpu" if sched == "tpu" else None)
        else:
            m, s = jrun(cfg, write_data=True)
        assert s.ok, s.plugin_errors
        dirs[pkg] = collect(str(tmp_path / pkg))
    assert_same_dirs(dirs["port"], dirs["jax"], f"channels under {route}")
    files = dirs["port"]
    for name in ("flight-sim.bin", "telemetry-sim.bin", "fabric-sim.bin"):
        assert len(files[name]) > 64, name
