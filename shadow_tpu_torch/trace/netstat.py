"""Sim-netstat: the per-connection TCP telemetry channel
(`telemetry-sim.bin`), the port's copy of `shadow_tpu/trace/netstat.py`.

At every sampled round boundary (trace/recorder.grid_sampled) each live
TCP connection gives one TEL_REC, in (host, local port, peer port, peer
IP) order.  The engine's ring samples its hosts' connections (C++ spans
and per-round rounds), and the TCP device span samples its conns on the
card and emits the rows after its import (ops/tcp_span.py).  Every host
of the port is an engine host: the object-path walkers below keep the
reference's signatures and do nothing over an empty list of object
hosts.  No wall clock is read here.
"""

from __future__ import annotations

from shadow_tpu_torch.trace.events import TEL_REC_BYTES
from shadow_tpu_torch.trace.recorder import FixedRecordChannel, grid_sampled

sampled = grid_sampled


class NetstatChannel(FixedRecordChannel):
    """The per-connection sample stream."""

    FILE = "telemetry-sim.bin"
    REC_SIZE = TEL_REC_BYTES

    def sample_object_hosts(self, hosts, t: int) -> None:
        """Sample the object-path hosts' live TCP connections.  Every
        host of the port is an engine host, which the engine's ring
        samples, until ROADMAP A2b brings object-path hosts."""
        del hosts, t


def iter_host_tcp_sockets(host):
    """Every TCP socket associated on an object-path host (none before
    ROADMAP A2b: an engine host's sockets live engine-side)."""
    del host
    return ()
