"""Managed processes on the port: real binaries (tests/plugins/*.c,
compiled once per module with `cc`) under the shim, run through the JAX
package's `run_simulation` and the port's on the same config.

Each case runs once through the JAX package (`serial`, the object path)
and through the port under `serial`, `tpu` with `native_dataplane: off`
(the object path, the per-round propagation's plain law on the CPU),
`tpu` with the engine (the managed hosts' sockets through
host/socket_native.py) and the engine `thread_per_core` baseline.  Every gate holds the whole data directory
equal: the packet trace, each process's stdout and stderr, sim-stats.json
(its `metrics.wall` block aside) and the fault ledger; the processed
config differs only in the scheduler knobs.
"""

import ctypes.util
import functools
import json
import os
import re
import shutil
import subprocess

import pytest

torch = pytest.importorskip("torch")

from shadow_tpu.core.config import ConfigOptions as JConfig  # noqa: E402
from shadow_tpu.core.manager import run_simulation as jrun  # noqa: E402
from shadow_tpu_torch.core.config import ConfigOptions  # noqa: E402
from shadow_tpu_torch.core.manager import run_simulation  # noqa: E402

PLUGIN_DIR = os.path.join(os.path.dirname(__file__), "plugins")

pytestmark = pytest.mark.skipif(shutil.which("cc") is None,
                                reason="no C toolchain for the shim")


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("plugins")
    out = {}
    for name in ("sleep_time", "pipe_self", "epoll_server", "tcp_server",
                 "tcp_client", "udp_echo_server", "udp_echo_client",
                 "fork_exec", "signal_self", "signalfd_loop",
                 "unix_socket", "scm_rights", "pthread_threads",
                 "signal_shutdown"):
        exe = str(out_dir / name)
        subprocess.run(["cc", "-O1", "-pthread", "-o", exe,
                        os.path.join(PLUGIN_DIR, name + ".c")],
                       check=True)
        out[name] = exe
    return out


GML = """graph [
        node [ id 0 host_bandwidth_down "100 Mbit" host_bandwidth_up "100 Mbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]
      ]"""


def _yaml(hosts: str, stop: str, extra_exp: str = "") -> str:
    return f"""
general:
  stop_time: {stop}
  seed: 1
network:
  graph:
    type: gml
    inline: |
      {GML}
experimental:
  scheduler: serial{extra_exp}
hosts:
{hosts}"""


def _one(binary: str, args=(), extra: str = "") -> str:
    return f"""  alpha:
    network_node_id: 0
    processes:
      - path: {{{binary}}}
        args: {list(args)!r}
        start_time: 1s{extra}
"""


def _two(client, cargs, server, sargs) -> str:
    return f"""  client:
    network_node_id: 0
    ip_addr: 11.0.0.1
    processes:
      - path: {{{client}}}
        args: {list(cargs)!r}
        start_time: 2s
  server:
    network_node_id: 0
    ip_addr: 11.0.0.2
    processes:
      - path: {{{server}}}
        args: {list(sargs)!r}
        start_time: 1s
"""


# name -> (hosts block with {plugin} placeholders, stop time, what the
# run's outputs must show)
CASES = {
    "sleep_time": (_one("sleep_time"), "10s",
                   ("alpha", b"elapsed_ns=2500000000")),
    "pipe_self": (_one("pipe_self"), "10s", ("alpha", b"")),
    "epoll_server": (_two("udp_echo_client", ["11.0.0.2", "9000", "15",
                                              "1000"],
                          "epoll_server", ["9000", "15"]), "30s",
                     ("server", b"epoll server echoed 15")),
    "tcp": (_two("tcp_client", ["11.0.0.2", "8080", "200000"],
                 "tcp_server", ["8080"]), "60s",
            ("server", b"received 200000 bytes total")),
    "udp_echo": (_two("udp_echo_client", ["11.0.0.2", "9000", "20",
                                          "1000"],
                      "udp_echo_server", ["9000", "20"]), "30s",
                 ("client", b"completed 20 echoes")),
    "fork_exec": (_one("fork_exec"), "10s", ("alpha", b"fork_exec_ok")),
    "signal_self": (_one("signal_self"), "10s",
                    ("alpha", b"alarm_dt_ns=2000000000")),
    "signalfd_loop": (_one("signalfd_loop"), "10s", ("alpha", b"")),
    "unix_socket": (_one("unix_socket"), "10s", ("alpha", b"dgram_ok")),
    "scm_rights": (_one("scm_rights"), "10s", ("alpha", b"scm_ok")),
    "pthread_threads": (_one("pthread_threads"), "30s",
                        ("alpha", b"counter=4000 sum=60")),
    # shutdown_time: the handler's graceful exit, and the default
    # disposition's `signaled` final state.
    "shutdown_handled": (_one("signal_shutdown", ["handle"],
                              "\n        shutdown_time: 5s"), "10s",
                         ("alpha", b"graceful_exit_at_s=")),
    "shutdown_default": (_one("signal_shutdown", ["default"],
                              "\n        shutdown_time: 5s"
                              "\n        expected_final_state: "
                              "signaled SIGTERM"), "10s", ("alpha", b"")),
}

# route -> experimental lines the port's run adds
ROUTES = {
    "serial": "",
    "tpu-object": "\n  scheduler: tpu\n  native_dataplane: off",
    "tpu-engine": "\n  scheduler: tpu",
    "thread_per_core-engine": ("\n  scheduler: thread_per_core"
                               "\n  native_dataplane: on"),
}


def collect(d: str) -> dict:
    """A data directory as the determinism gate compares it: the wall
    channel stripped, the processed config's scheduler knobs and output
    path normalized; the shim's own diagnostics log left out."""
    out = {}
    for root, _dirs, files in os.walk(d):
        for fn in files:
            p = os.path.join(root, fn)
            if fn.endswith(".shimlog"):
                continue
            with open(p, "rb") as f:
                data = f.read()
            if fn == "sim-stats.json":
                stats = json.loads(data)
                stats.get("metrics", {}).pop("wall", None)
                data = json.dumps(stats, indent=2, sort_keys=True).encode()
            if fn == "processed-config.yaml":
                for key in (rb"data_directory", rb"scheduler",
                            rb"native_dataplane", rb"parallelism"):
                    data = re.sub(key + rb": .*", key + b": <n>", data)
            out[os.path.relpath(p, d)] = data
    return out


def _text(name: str, bins: dict, extra_exp: str = "") -> str:
    hosts, stop, _want = CASES[name]
    return _yaml(hosts.format(**bins), stop, extra_exp)


@functools.lru_cache(maxsize=None)
def _reference(name: str, text: str, d: str) -> dict:
    cfg = JConfig.from_yaml_text(text)
    cfg.general.data_directory = d
    _m, s = jrun(cfg, write_data=True)
    assert s.ok, s.plugin_errors
    return collect(d)


def run_port(text: str, d: str):
    cfg = ConfigOptions.from_yaml_text(text)
    cfg.general.data_directory = d
    return run_simulation(cfg, device="cpu", write_data=True)


def assert_same_dirs(ref: dict, got: dict) -> None:
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k] == ref[k], k


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", list(CASES))
def test_torch_managed_plugin(bins, tmp_path_factory, name, route):
    torch.set_num_threads(1)
    base = tmp_path_factory.getbasetemp()
    ref = _reference(name, _text(name, bins), str(base / f"jax-{name}"))
    d = str(tmp_path_factory.mktemp(f"{name}-{route}"))
    m, s = run_port(_text(name, bins, ROUTES[route]), d)
    assert s.ok, s.plugin_errors
    assert (m.plane is not None) == route.endswith("-engine")
    assert_same_dirs(ref, collect(d))
    host, want = CASES[name][2]
    out = b"".join(bytes(p.stdout) for h in m.hosts if h.name == host
                   for p in h.processes.values())
    assert want in out
    assert sum(m.sc_disposition_totals().values()) > 0


def test_torch_managed_final_states(bins, tmp_path):
    """shutdown_time's default disposition ends in `signaled SIGTERM`;
    an expectation of another state is the run's plugin error."""
    m, s = run_port(_text("shutdown_default", bins), str(tmp_path / "a"))
    assert s.ok
    proc = next(iter(m.hosts[0].processes.values()))
    assert proc.exited and proc.term_signal == 15
    text = _text("shutdown_default", bins).replace(
        "signaled SIGTERM", "exited 0")
    _m, s = run_port(text, str(tmp_path / "b"))
    assert s.plugin_errors and "expected 'exited 0'" in s.plugin_errors[0]


HTTP_ENGINE = """
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
      - { path: http-server, args: ["8080", "5000"], start_time: 60ms,
          expected_final_state: running }
      - { path: udp-sink, args: ["9000", "1000", "7"], start_time: 50ms,
          expected_final_state: any }
  fetcher:
    network_node_id: 0
    processes:
      - { path: tgen-client, args: ["web", "8080", "1", "1"],
          start_time: 200ms, expected_final_state: any }
"""


def test_torch_internal_apps_on_engine_hosts(tmp_path):
    """An internal app with no engine twin (http-server, and udp-sink in
    a shape the engine does not take) runs on an engine host over the
    engine's sockets (host/socket_native.py): the data directory equals
    the JAX package's run of the same config.  (The tgen-client is an
    engine app there, whose syscalls sim-stats counts apart, so the
    serial run's counts differ.)"""
    torch.set_num_threads(1)
    text = HTTP_ENGINE.replace("{ scheduler: serial }",
                               "{ scheduler: tpu }")
    ref = _reference("http-engine", text, str(tmp_path / "jax"))
    m, s = run_port(text, str(tmp_path / "port"))
    assert s.ok, s.plugin_errors
    assert m.plane is not None and all(h.plane is not None
                                       for h in m.hosts)
    assert_same_dirs(ref, collect(str(tmp_path / "port")))


def test_torch_crypto_noop_preload(tmp_path):
    """`openssl_crypto_noop`: the no-op preload rides after the shim and
    AES becomes the identity; without it AES stays real."""
    name = ctypes.util.find_library("crypto")
    if not name:
        pytest.skip("no libcrypto runtime found")
    exe = str(tmp_path / "probe")
    r = subprocess.run(["cc", "-O1", "-o", exe,
                        os.path.join(PLUGIN_DIR, "crypto_noop_probe.c"),
                        f"-l:{name}"], capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip("libcrypto not linkable: " + r.stderr[-200:])
    hosts = _one("exe").format(exe=exe)

    def run(extra):
        m, s = run_port(_yaml(hosts, "10s", extra),
                        str(tmp_path / f"d{len(extra)}"))
        assert s.ok, s.plugin_errors
        return bytes(next(iter(m.hosts[0].processes.values())).stdout)

    assert b"aes=real" in run("")
    assert b"aes=noop" in run("\n  openssl_crypto_noop: true")


@pytest.mark.parametrize("key,item", [
    ("  strace_logging_mode: standard\n", "ROADMAP A7b-2"),
    ("  syscall_observatory: on\n", "ROADMAP A7b-2"),
    ("  syscall_observatory: wall\n", "ROADMAP A7b-2"),
])
def test_torch_managed_config_still_refused(key, item):
    text = _yaml("  a:\n    network_node_id: 0\n", "1s") \
        .replace("experimental:\n", "experimental:\n" + key)
    with pytest.raises(NotImplementedError, match=item):
        ConfigOptions.from_yaml_text(text)


@pytest.mark.parametrize("policy", ["quarantine", "restart"])
def test_torch_managed_on_failure_refused(policy):
    text = _yaml(_one("b").format(b="/bin/true")
                 .replace("start_time: 1s",
                          f"start_time: 1s\n        on_failure: {policy}"),
                 "1s")
    with pytest.raises(NotImplementedError, match="ROADMAP A7c"):
        ConfigOptions.from_yaml_text(text)


@pytest.mark.parametrize("extra", [
    "",  # a binary by path
    "\n        shutdown_time: 2s\n        shutdown_signal: SIGINT",
    "\n        expected_final_state: signaled SIGKILL",
    "\n        expected_final_state: signaled 9",
])
def test_torch_managed_config_parses(extra):
    text = _yaml(_one("b", ["x"], extra).format(b="/bin/true"), "5s",
                 "\n  openssl_crypto_noop: true")
    cfg = ConfigOptions.from_yaml_text(text)
    p = cfg.hosts["alpha"].processes[0]
    assert p.path == "/bin/true"
    assert cfg.experimental.openssl_crypto_noop
    if "shutdown_time" in extra:
        assert p.shutdown_time_ns == 2_000_000_000
        assert p.shutdown_signal == "SIGINT"
    jcfg = JConfig.from_yaml_text(text)
    assert cfg.to_processed_dict() == jcfg.to_processed_dict()


def test_torch_managed_config_rejects_bad_values():
    with pytest.raises(ValueError, match="expected_final_state"):
        ConfigOptions.from_yaml_text(_yaml(_one(
            "b", (), "\n        expected_final_state: signaled SIGNOPE")
            .format(b="/bin/true"), "5s"))
    with pytest.raises(ValueError, match="managed_watchdog"):
        ConfigOptions.from_yaml_text(_yaml(
            "  a:\n    network_node_id: 0\n", "1s",
            "\n  managed_watchdog: 10 ms"))


def test_torch_managed_preflight(monkeypatch):
    """A fleet that does not fit the fd table fails before its first
    spawn, naming the limit; one that fits passes."""
    import resource

    from shadow_tpu_torch.svc.containment import preflight_managed
    preflight_managed(4)
    monkeypatch.setattr(resource, "getrlimit", lambda _r: (100, 100))
    with pytest.raises(RuntimeError, match="RLIMIT_NOFILE soft limit is "
                                           "100 but 1000 managed"):
        preflight_managed(1000)


def test_torch_shim_build_without_tsc_trap(bins, tmp_path_factory,
                                          monkeypatch):
    """On a kernel that refuses PR_SET_TSC (gVisor) the shim is built
    without its rdtsc trap and vDSO patch, into a library of its own; a
    managed run under it equals the JAX package's."""
    from shadow_tpu_torch import native
    monkeypatch.setattr(native, "tsc_trap_supported", lambda: False)
    assert native.ensure_shim_built() == native.SHIM_GVISOR_SO
    ref = _reference("fork_exec", _text("fork_exec", bins),
                     str(tmp_path_factory.getbasetemp() / "jax-fork_exec"))
    d = str(tmp_path_factory.mktemp("gvisor"))
    with pytest.warns(UserWarning, match="rdtsc trap"):
        m, s = run_port(_text("fork_exec", bins), d)
    assert s.ok, s.plugin_errors
    assert m.shim_build == "gvisor"
    with open(os.path.join(d, "sim-stats.json")) as f:
        assert json.load(f)["metrics"]["wall"]["shim_build"] == "gvisor"
    assert_same_dirs(ref, collect(d))
