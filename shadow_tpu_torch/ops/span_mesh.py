"""Dispatch protocol shared by the device-span runners, the TCP family's
and the PHOLD/udp-mesh family's (the unsharded half of
`shadow_tpu/ops/span_mesh.py`, with the dispatch both reference runners
spell out in their own `try_span` written here once).

What the port carries over: the canonical abort bits, the built-fn
cache with its build credit (each runner keys it on its own shape: the
PHOLD runner on its peer width P), the abort-kind ledger, and
`_span_call`'s attribution (CUDA-event walls, since PyTorch has no
counterpart of XLA's cost analysis) beside the codec's bytes and the
host wall of the engine's export and import calls.

Residency: while the engine's `state_epoch` has not moved since a
clean span's import, that span's output on the card is the next span's
input and the engine export is skipped.  Each runner classifies its
codec columns (`RESIDENT_STATIC` / `RESIDENT_DERIVED` /
`RESIDENT_CARRIED`) and gives the law that re-derives the DERIVED ones
(`_derive`); everything else is here.  The loop and the relay kernels
update the span state in place, so a resident dispatch consumes its
carry: an abort re-exports from the engine, which the per-span imports
keep authoritative.

The speculative overlap: after a clean commit, window K+1 is
dispatched on a worker thread with its own CUDA stream while the host
imports window K.  Its input is a clone of K's CARRIED columns (the
STATIC ones are shared read-only), so neither the import nor the
resident carry a refused window falls back on is touched by it.  The
next `try_span` lands the window only when its params match and the
epoch is the one stamped after K's import; otherwise it is discarded
unimported.  A window's counters are credited on landing only, except
the per-dispatch launch counts (`fires_all`, `calls_all`,
`windows_all`): its kernels did launch, on the worker's stream (a
window or span kernel's wrapper launches on the current stream).  The
sharded exchange is not ported yet (ROADMAP A5).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from shadow_tpu_torch.ops.window_table import SAMPLE_ROWS_MAX

# Abort reason bits: trace/outbox overflows are capacity problems the
# runner fixes by growing the buffer and retrying; AB_STRUCT means the
# state left the modelled domain (the C++ path re-runs those rounds);
# AB_EXCH is the sharded exchange's capacity bit (unused unsharded).
AB_TRACE = 1
AB_OUT = 2
AB_STRUCT = 4
AB_EXCH = 8

# Keys of a span's output that are span-local (abort bits, trace and
# outbox buffers, stage counters, the channels' sample rows; the loops
# make them anew on entry): never carried into the next span.
SPAN_LOCAL = ("abort_", "tr_", "ks_", "out_", "tel_", "fab_")
# The channels' sample rows of a span's output.
SAMPLE_ROWS = ("tel_", "fab_")
# Per-stage counters credited when a span commits.
COMMIT_COUNTS = ("ks_fires", "ks_lanes", "ks_wall_s", "ks_calls",
                 "ks_windows", "ks_window_ms", "ks_spans", "ks_span_ms")


def snapshot(st: dict, keys, stream=None) -> dict:
    """Clone `st[k]` for every k in `keys` on the card (on the caller's
    stream).  With `stream`, each clone is also marked as used there, so
    the caching allocator does not hand its memory out again before the
    work queued on `stream` is done with it."""
    out = {}
    for k in keys:
        c = st[k].clone()
        if stream is not None:
            c.record_stream(stream)
        out[k] = c
    return out


class SpecWindow:
    """One speculative window: `work()` on a worker thread, on `stream`
    (None on the CPU).  The stream first waits for an event recorded
    now on the caller's stream, after the input's clone.  `join()`
    returns what `work()` returned, or raises what it raised."""

    def __init__(self, work, stream=None):
        self.out = None
        self.err = None
        self.t_done = 0
        self._stream = stream
        ready = None
        if stream is not None:
            ready = torch.cuda.Event()
            ready.record()
        self.t_disp = time.perf_counter_ns()
        self._thread = threading.Thread(
            target=self._run, args=(work, ready, torch.get_num_threads()),
            name="span-window", daemon=True)
        self._thread.start()

    def _run(self, work, ready, n_threads):
        # The caller's intra-op thread count, which a new thread does
        # not inherit.
        torch.set_num_threads(n_threads)
        try:
            if self._stream is None:
                self.out = work()
            else:
                with torch.cuda.stream(self._stream):
                    self._stream.wait_event(ready)
                    self.out = work()
                self._stream.synchronize()
        except Exception as e:  # handed to the caller by join()
            self.err = e
        finally:
            self.t_done = time.perf_counter_ns()

    def join(self):
        self._thread.join()
        if self._stream is not None:
            torch.cuda.current_stream(self._stream.device).wait_stream(
                self._stream)
        if self.err is not None:
            raise self.err
        return self.out


class SpanMeshMixin:
    """The dispatch protocol.  The concrete runner provides `device`,
    `engine`, `MAX_ROUNDS`, the routing arrays (`_lat`, `_thr`, `_node`,
    `_ips_sorted`, `_ips_perm`), the RESIDENT_* tables, the counters
    (`spans`, `rounds`, `micro_iters`, `aborts`, `ineligible`,
    `over_caps`, `ks_*`, `fires_all`, `cap_tr`, `cap_out`) and:

    - `export_state()`: a fresh engine export as device state (calling
      `_cache_statics` on it), or the export's None (ineligible) / int
      (over caps) verdict;
    - `_derive(st)`: set the DERIVED columns as a fresh export would;
    - `_fn_for(st)`: the built loop for this input;
    - `_fn_args(start, stop, limit, runahead, mr)`: the loop's
      arguments after the state;
    - `_host_copy(st_out)`: the output's codec columns and traces on
      the host, as `_engine_import(state, traces)` takes them (which
      also counts `import_bytes`).
    """

    fn_cache_hits = 0        # the fn cache served an already-built fn
    fn_cache_misses = 0      # a fresh build
    fn_cache_build_ns = 0    # wall of each missed fn's FIRST dispatch
    device_wall_ns = 0       # host wall of every span dispatch (for a
    #                          landed window: the wait to join it)
    device_ms = 0.0          # CUDA-event time of every committed or
    #                          aborted dispatch (not a refused window's)
    rollback_wall_ns = 0     # wall of dispatches that aborted
    rolled_back_rounds = 0   # rounds stepped then discarded by aborts
    export_bytes = 0         # codec bytes engine -> host, cumulative
    import_bytes = 0         # codec bytes host -> engine, cumulative
    export_wall_ns = 0       # host wall of the engine's export calls
    #                          (an ineligible sim's is its probe)
    import_wall_ns = 0       # host wall of codec + engine import calls

    # Residency.
    resident_hits = 0        # dispatches served without an export
    stale_drops = 0          # resident carries dropped: epoch moved
    _res_st = None           # the last clean span's output
    _res_token = None        # the engine epoch it is valid at
    _static_cols = None      # STATIC columns of the last export

    # Speculative overlap (set from experimental.span_overlap).
    overlap = False
    _inflight = None         # the committed window's record, or None
    _spec_stream = None      # the worker's CUDA stream
    overlap_windows = 0      # speculative windows dispatched
    overlap_hits = 0         # ...landed and consumed
    overlap_refusals = 0     # ...refused (params or epoch drift)
    overlap_stale = 0        # refusals caused by state_epoch drift
    overlap_wait_ns = 0      # HOST idle: wall blocked joining a landed
    #                          window (the card was still running it)
    overlap_idle_ns = 0      # DEVICE idle: from a landed window's own
    #                          finish to its landing
    overlap_pipe_ns = 0      # dispatch -> landing wall of landed windows
    clone_bytes = 0          # bytes the windows' input clones copied
    clone_ms = 0.0           # their time (CUDA events on the card)

    # The sim-time channels (the Manager sets those that are on): the
    # sample rows a span buffers for sim-netstat (the TCP family's) and
    # the fabric observatory, at most TEL_ROWS / FAB_ROWS a span (a span
    # that records is clamped to that many rounds, so no sampled round
    # is ever skipped), appended to the channels after the import; the
    # kernel observatory's record of each committed span; the flight
    # recorder's wall phases.
    netstat = None
    fabric = None
    kern = None
    wall = None
    TEL_ROWS = FAB_ROWS = SAMPLE_ROWS_MAX
    FAMILY = 0  # the FAM_* code of the runner's records

    # Whether an over-caps export is a transient refusal the router
    # re-probes soon (the TCP family's handshake/close stretches).
    OVER_CAPS_TRANSIENT = False
    last_transient = False

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
        mr = self.MAX_ROUNDS if mr is None else min(mr, self.MAX_ROUNDS)
        if self.netstat is not None:
            mr = min(mr, self.TEL_ROWS)
        if self.fabric is not None:
            mr = min(mr, self.FAB_ROWS)
        return mr

    def _sample_ivs(self) -> tuple:
        """(netstat, fabric) sampling intervals of the loop, 0 for a
        channel that is off (a build's constants)."""
        def iv(ch):
            return 0 if ch is None else max(int(ch.interval_ns), 1)
        return iv(self.netstat), iv(self.fabric)

    def _emit_netstat(self, rows: dict) -> None:
        """Append the span's connection rows to sim-netstat (the TCP
        family's)."""

    def _emit(self, st_out: dict, start: int, rounds: int,
              span_iters: int) -> None:
        """A committed span's channel records, after its import: the
        sample rows (on the host already when the span kernel's one read
        brought them) and the kernel observatory's record."""
        rows = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in st_out.items() if k.startswith(SAMPLE_ROWS)}
        if self.netstat is not None:
            self._emit_netstat(rows)
        if self.fabric is not None:
            from shadow_tpu_torch.trace.fabricstat import emit_device_rows
            emit_device_rows(self.fabric, rows, self._H)
        if self.kern is not None:
            self.kern.record_span(start, self.FAMILY, self._H, rounds,
                                  span_iters, st_out["ks_fires"],
                                  st_out["ks_lanes"])

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

    # ------------------------------------------------------------------
    # One dispatch
    # ------------------------------------------------------------------

    def _timed_call(self, fn, st, *args):
        """fn(st, *args) -> (out, host wall ns, device ms).  On the card
        the call is bracketed by CUDA events on the current stream (the
        worker's, for a speculative window)."""
        cuda = self.device.type == "cuda"
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        t0 = time.perf_counter_ns()
        out = fn(st, *args)
        dev_ms = 0.0
        if cuda:
            ev1.record()
            ev1.synchronize()
            dev_ms = ev0.elapsed_time(ev1)
        return out, time.perf_counter_ns() - t0, dev_ms

    def _note_dispatch(self, st_out) -> None:
        """Launch counts of every dispatch, whatever its fate: stage
        fires (one relay-kernel launch each on the TCP eager window) and,
        where the loop counts them, the law calls, the windows a kernel
        stepped and the span-kernel launches."""
        self.fires_all += st_out["ks_fires"]
        if "ks_calls" in st_out:
            self.calls_all += st_out["ks_calls"]
        if "ks_windows" in st_out:
            self.windows_all += st_out["ks_windows"]
        if "ks_spans" in st_out:
            self.spans_all += st_out["ks_spans"]

    def _span_call(self, fn, st, *args):
        """Dispatch the built span fn; returns (out, host wall ns) and
        credits the wall, the CUDA-event time and the launch counts."""
        out, dt, dev_ms = self._timed_call(fn, st, *args)
        self.device_wall_ns += dt
        self.device_ms += dev_ms
        self._note_dispatch(out[0])
        return out, dt

    # ------------------------------------------------------------------
    # Residency
    # ------------------------------------------------------------------

    def _cache_statics(self, st: dict) -> None:
        """At export: keep the STATIC columns on the card for every later
        dispatch, fresh or resident."""
        self._static_cols = {k: st[k] for k in self.RESIDENT_STATIC}

    def _resident_input(self, carry: dict, clone: bool = False) -> dict:
        """The span input rebuilt from a clean span's output: span-local
        buffers dropped, STATIC columns reattached from the export's
        cache, DERIVED ones re-derived by the law a fresh export
        applies (they hold their derived value at every clean span
        boundary).  With `clone`, the CARRIED columns are copies, so the
        dispatch leaves `carry` as it was."""
        st = {k: v for k, v in carry.items()
              if not k.startswith(SPAN_LOCAL)}
        if clone:
            st.update(snapshot(carry, self.RESIDENT_CARRIED,
                               self._spec_stream))
        st.update(self._static_cols)
        self._derive(st)
        return st

    def _keep_resident(self, st_out) -> None:
        """Record AFTER any import's own epoch bump: the carry is valid
        exactly until anything else touches the engine."""
        self._res_st = st_out
        self._res_token = self.engine.state_epoch()

    def _span_input(self):
        """The dispatch's input: the resident carry while the engine's
        epoch is unchanged (consumed by this dispatch), else a fresh
        export (or its None / int verdict)."""
        if self._res_st is not None:
            carry, self._res_st = self._res_st, None
            if self._res_token == self.engine.state_epoch():
                self.resident_hits += 1
                return self._resident_input(carry)
            self.stale_drops += 1
        return self.export_state()

    def _refused(self, verdict) -> None:
        """An export that did not give a state: None is structural (the
        sim is not this family's: permanent), an int is over the ring
        caps (retried later)."""
        if verdict is None:
            self.ineligible += 1
        else:
            self.over_caps += 1
            self.last_transient = self.OVER_CAPS_TRANSIENT
        return None

    # ------------------------------------------------------------------
    # Speculative overlap
    # ------------------------------------------------------------------

    def _speculate_record(self, job, params) -> dict:
        """The in-flight record: the window's job and what the landing
        check needs.  `epoch` is stamped at `_commit_spec`, after the
        committed window's import."""
        return {"job": job, "params": params, "epoch": None}

    def _speculate(self, carry: dict, params: tuple) -> dict:
        """Dispatch window K+1 (`params`: start, stop, limit, runahead,
        dynamic, max rounds) on the worker from a clone of K's carry."""
        cuda = self.device.type == "cuda"
        if cuda and self._spec_stream is None:
            self._spec_stream = torch.cuda.Stream(self.device)
        t0 = time.perf_counter_ns()
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        st = self._resident_input(carry, clone=True)
        clone = (ev0, ev1) if cuda else time.perf_counter_ns() - t0
        if cuda:
            ev1.record()
        self.clone_bytes += sum(
            st[k].numel() * st[k].element_size()
            for k in self.RESIDENT_CARRIED)
        start, stop, limit, runahead, _dynamic, mr = params
        fn = self._fn
        job = SpecWindow(
            lambda: self._timed_call(fn, st, *self._fn_args(
                start, stop, limit, runahead, mr)),
            self._spec_stream)
        self.overlap_windows += 1
        rec = self._speculate_record(job, params)
        rec["clone"] = clone
        return rec

    def _commit_spec(self, spec: dict) -> None:
        """Commit point: stamp the engine epoch (every host-side step of
        the committed window has run) and publish the record."""
        spec["epoch"] = self.engine.state_epoch()
        self._inflight = spec

    def _join_window(self, spec: dict):
        """Join the window's worker and credit what every dispatch
        credits whatever its fate: the launch counts and the clone."""
        t0 = time.perf_counter_ns()
        out = spec["job"].join()
        spec["wait_ns"] = time.perf_counter_ns() - t0
        clone = spec.pop("clone", 0)
        if isinstance(clone, tuple):
            self.clone_ms += clone[0].elapsed_time(clone[1])
        else:
            self.clone_ms += clone / 1e6
        self._note_dispatch(out[0][0])
        return out

    def _take_inflight(self, params):
        """Land (or refuse) the in-flight window for this try_span call.
        Returns the record, with the window's (out, wall, device ms)
        under "result", on a hit; None otherwise.  Always joins the
        worker and clears `_inflight`: a refused window is discarded
        unimported, and the resident carry still serves."""
        spec, self._inflight = self._inflight, None
        if spec is None:
            return None
        spec["result"] = self._join_window(spec)
        if spec["params"] != params:
            self.overlap_refusals += 1
            return None
        if self.engine.state_epoch() != spec["epoch"]:
            self.overlap_refusals += 1
            self.overlap_stale += 1
            return None
        self.overlap_hits += 1
        # A landed window was served from the resident output, with no
        # export: the residency counter keeps meaning "dispatches
        # served without an engine export".
        self.resident_hits += 1
        # Host idle: the join's wait; device idle: from the window's own
        # finish to the join (nothing else ran on the card meanwhile).
        now = time.perf_counter_ns()
        wait, job = spec["wait_ns"], spec["job"]
        self.overlap_wait_ns += wait
        self.device_wall_ns += wait
        self.overlap_pipe_ns += now - job.t_disp
        self.overlap_idle_ns += max(0, now - wait - job.t_done)
        return spec

    def drop_inflight(self) -> None:
        """Join and discard a window nothing will land (the run ended
        first)."""
        spec, self._inflight = self._inflight, None
        if spec is not None:
            self._join_window(spec)
            self.overlap_refusals += 1

    def overlap_summary(self) -> dict:
        """The per-family `overlap` block of the dispatch summary."""
        pipe = max(self.overlap_pipe_ns, 1)
        return {
            "windows": self.overlap_windows,
            "hits": self.overlap_hits,
            "refusals": self.overlap_refusals,
            "stale_refusals": self.overlap_stale,
            "host_idle_wall_s": round(self.overlap_wait_ns / 1e9, 3),
            "device_idle_wall_s": round(self.overlap_idle_ns / 1e9, 3),
            "pipe_wall_s": round(self.overlap_pipe_ns / 1e9, 3),
            "host_idle_frac": round(self.overlap_wait_ns / pipe, 4),
            "device_idle_frac": round(self.overlap_idle_ns / pipe, 4),
        }

    # ------------------------------------------------------------------
    # The dispatch: landed window -> resident carry -> fresh export
    # ------------------------------------------------------------------

    def try_span(self, start: int, stop: int, limit: int, runahead: int,
                 dynamic: bool, max_rounds: int | None = None,
                 spec_mr: int = 0):
        """Export (or reuse) -> device span -> import.  Returns (rounds,
        busy_rounds, packets, next_start, busy_end, runahead) or None
        when ineligible / over the ring caps / aborted.

        With `spec_mr > 0` and `overlap` on, a clean commit dispatches
        window K+1 (at most `spec_mr` rounds) before the engine import
        of window K runs; the next call lands it through
        `_take_inflight` when its params and the epoch match."""
        self.last_transient = False
        mr = self._clamp_mr(max_rounds)
        params = (int(start), int(stop), int(limit), int(runahead),
                  bool(dynamic), mr)
        landed = self._take_inflight(params)
        if landed is None:
            st = self._span_input()
            if not isinstance(st, dict):
                return self._refused(st)
        for _grow in range(4):
            if landed is not None:
                out, _dt, dev_ms = landed["result"]
                dt = landed["wait_ns"]
                self.device_ms += dev_ms
                landed = None
            else:
                self._fn = self._fn_for(st)
                fresh_fn = not self.compiled
                out, dt = self._span_call(
                    self._fn, st, *self._fn_args(*params[:4], mr))
                if fresh_fn:
                    self._credit_build(self._fn, dt)
            (st_out, next_start, ra, rounds, busy_rounds, packets,
             busy_end, span_iters) = out
            code = int(st_out["abort_code"])
            if code == 0:
                break
            self.rollback_wall_ns += dt
            self.rolled_back_rounds += rounds
            self._note_abort_kind(code)
            if code & AB_STRUCT:
                self.last_abort_code = code
                self.aborts += 1
                return None
            # The aborted dispatch ran in place on its input (a resident
            # carry, a landed window's clone or an export alike), so the
            # retry re-exports: the engine is authoritative until the
            # import.  Trace/outbox overflow is a capacity problem, not
            # a domain problem: grow the buffer and re-run the span.
            st = self.export_state()
            if not isinstance(st, dict):
                return self._refused(st)
            if code & AB_TRACE:
                self.cap_tr *= 4
            if code & AB_OUT:
                self.cap_out *= 4
        else:
            self.last_abort_code = code
            self.aborts += 1
            return None
        if rounds == 0:
            # Zero progress (start at the limit): the untouched carry
            # stays resident.
            self._keep_resident(st_out)
            return (0, 0, 0, int(start), int(start), int(runahead))
        ra_out = int(ra) if dynamic else int(runahead)
        # Window K's codec columns come to the host first, so that the
        # card is left to window K+1 while the engine imports K.
        t0 = time.perf_counter_ns()
        host = self._host_copy(st_out)
        t_copy = time.perf_counter_ns() - t0
        spec = None
        if self.overlap and spec_mr > 0 and next_start < stop \
                and next_start < limit:
            spec = self._speculate(st_out, (
                int(next_start), int(stop), int(limit), ra_out,
                bool(dynamic), self._clamp_mr(spec_mr)))
        t0 = time.perf_counter_ns()
        self._engine_import(*host)
        self._emit(st_out, int(start), rounds, span_iters)
        t1 = time.perf_counter_ns()
        self.import_wall_ns += t_copy + t1 - t0
        if self.wall is not None:
            self.wall.add("execute", dt)
            self.wall.add("import", t_copy + t1 - t0, t0)
        self._keep_resident(st_out)
        self.last_was_cold = not self.compiled
        self.compiled = True
        self.spans += 1
        self.rounds += rounds
        self.micro_iters += span_iters
        for k in COMMIT_COUNTS:
            if k in st_out:
                setattr(self, k, getattr(self, k) + st_out[k])
        if spec is not None:
            self._commit_spec(spec)
        return (rounds, busy_rounds, packets, int(next_start),
                int(busy_end), ra_out)
