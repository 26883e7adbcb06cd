"""Dispatch bookkeeping shared by the device-span runners, the TCP
family's and the PHOLD/udp-mesh family's (the unsharded half of
`shadow_tpu/ops/span_mesh.py`).

What the port carries over: the canonical abort bits, the built-fn
cache with its build credit (each runner keys it on its own shape: the
PHOLD runner on its peer width P), the abort-kind ledger, and
`_span_call`'s attribution — here with CUDA-event walls, since PyTorch
has no counterpart of XLA's cost analysis — beside the codec's bytes
and the host wall of the engine's export and import calls.  Residency,
speculative overlap and the sharded exchange are not ported yet
(ROADMAP A1 and A5).
"""

from __future__ import annotations

import time

import numpy as np
import torch

# Abort reason bits: trace/outbox overflows are capacity problems the
# runner fixes by growing the buffer and retrying; AB_STRUCT means the
# state left the modelled domain (the C++ path re-runs those rounds);
# AB_EXCH is the sharded exchange's capacity bit (unused unsharded).
AB_TRACE = 1
AB_OUT = 2
AB_STRUCT = 4
AB_EXCH = 8


class SpanMeshMixin:
    """Runner bookkeeping: the concrete runner provides `device`,
    `MAX_ROUNDS` and the routing arrays (`_lat`, `_thr`, `_node`,
    `_ips_sorted`, `_ips_perm`)."""

    fn_cache_hits = 0        # the fn cache served an already-built fn
    fn_cache_misses = 0      # a fresh build
    fn_cache_build_ns = 0    # wall of each missed fn's FIRST dispatch
    device_wall_ns = 0       # host wall of every span dispatch
    device_ms = 0.0          # CUDA-event time of every span dispatch
    rollback_wall_ns = 0     # wall of dispatches that aborted
    rolled_back_rounds = 0   # rounds stepped then discarded by aborts
    export_bytes = 0         # codec bytes engine -> host, cumulative
    import_bytes = 0         # codec bytes host -> engine, cumulative
    export_wall_ns = 0       # host wall of the engine's export calls
    #                          (an ineligible sim's is its probe)
    import_wall_ns = 0       # host wall of codec + engine import calls

    _statics = None  # the routing arrays as tensors on the device

    def _statics_on_device(self) -> dict:
        """Routing inputs of the loop, put on the device once."""
        if self._statics is None:
            def t(a):
                return torch.tensor(a.astype(np.int64), device=self.device)
            self._statics = {
                "_lat": t(self._lat), "_thr": t(self._thr),
                "_node": t(self._node), "_ips_sorted": t(self._ips_sorted),
                "_ips_perm": t(self._ips_perm)}
        return self._statics

    def _clamp_mr(self, mr: int | None) -> int:
        return self.MAX_ROUNDS if mr is None else min(mr, self.MAX_ROUNDS)

    def _cache_fn(self, cache: dict, key, build):
        """The built-fn cache with explicit hit/miss accounting; a miss's
        first dispatch is credited as its build wall."""
        fn = cache.get(key)
        if fn is None:
            fn = cache[key] = build()
            self.fn_cache_misses += 1
            self.__dict__.setdefault("_built_fns", set()).add(id(fn))
        else:
            self.fn_cache_hits += 1
        return fn

    def _credit_build(self, fn, dt_ns: int) -> None:
        if id(fn) in self.__dict__.get("_built_fns", ()):
            self.fn_cache_build_ns += dt_ns

    def abort_kind_counts(self) -> dict:
        """{kind: count} of abort codes seen by this runner."""
        return self.__dict__.setdefault("_abort_kinds", {})

    def _note_abort_kind(self, code: int) -> None:
        """Classify one aborted dispatch as exactly ONE kind — priority
        struct > exchange-capacity > capacity."""
        kinds = self.abort_kind_counts()
        if code & AB_STRUCT:
            kind = "struct"
        elif code & AB_EXCH:
            kind = "exchange-capacity"
        else:
            kind = "capacity"
        kinds[kind] = kinds.get(kind, 0) + 1

    def _span_call(self, fn, *args):
        """Dispatch the built span fn; returns (out, host wall ns).  On
        the card the dispatch is also bracketed by CUDA events, so
        `device_ms` holds device time beside the host wall."""
        cuda = self.device.type == "cuda"
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        t0 = time.perf_counter_ns()
        out = fn(*args)
        if cuda:
            ev1.record()
            ev1.synchronize()
            self.device_ms += ev0.elapsed_time(ev1)
        dt = time.perf_counter_ns() - t0
        self.device_wall_ns += dt
        return out, dt
