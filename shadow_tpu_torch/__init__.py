"""shadow_tpu_torch: the PyTorch/CUDA port of the shadow-tpu simulator.

The JAX package (`shadow_tpu/`) stays the reference; this package runs
the same simulations with its device work in PyTorch on an NVIDIA card,
its Pallas queue-scan kernels and its per-round propagation program as
hand-written CUDA (`csrc/`).  It imports nothing of `shadow_tpu` and nothing of
JAX: the constants and framework-free layers it needs are its own
copies, pinned to the reference values by the tier-1 tests.

Layering (the JAX package's layout, cut to the ported slice):
  core/    config, simtime, rng, events, the Manager, the scalar
           propagator
  net/     GML graph + routing matrices, DNS, the object path's
           packets, interfaces, router, CoDel, relays and token buckets
  native/  loader for the shared C++ engine (native/netplane.cpp)
  host/    hosts (engine-resident or the object path), internal apps,
           processes, syscalls, UDP and TCP sockets, the CPU model
  tcp/     the object path's sans-I/O TCP
  ops/     device code: queue-scan and relay kernels, the TCP and
           PHOLD/udp-mesh device-span loops, per-round propagation
  tools/   config generators
  utils/   device resolution, unit parsing

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
