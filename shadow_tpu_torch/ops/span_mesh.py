"""Dispatch bookkeeping shared by the device-span runners (the unsharded
half of `shadow_tpu/ops/span_mesh.py`).

What the port carries over: the canonical abort bits, the built-fn
cache with its build credit, the abort-kind ledger, and `_span_call`'s
attribution — here with CUDA-event walls, since PyTorch has no
counterpart of XLA's cost analysis.  Residency, speculative overlap and
the sharded exchange are not ported yet (ROADMAP A1 and A5).
"""

from __future__ import annotations

import time

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
    """Runner bookkeeping: the concrete runner provides `device`."""

    fn_cache_hits = 0        # the fn cache served an already-built fn
    fn_cache_misses = 0      # a fresh build
    fn_cache_build_ns = 0    # wall of each missed fn's FIRST dispatch
    device_wall_ns = 0       # host wall of every span dispatch
    device_ms = 0.0          # CUDA-event time of every span dispatch
    rollback_wall_ns = 0     # wall of dispatches that aborted
    rolled_back_rounds = 0   # rounds stepped then discarded by aborts
    export_bytes = 0         # codec bytes engine -> host, cumulative
    import_bytes = 0         # codec bytes host -> engine, cumulative

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
