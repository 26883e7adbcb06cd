"""Exported PHOLD/udp-mesh span states and the comparison of two window
steps on them: what the window kernel (ops/phold_window.py) is held
against its plain version with, in the tier-1 tests (through a host
build of its lane law) and in `chip_smoke.py` (on the card).

- `capture_export(mgr, nth)` runs a Manager until its `nth` in-domain
  PHOLD export and returns it as the runner's numpy state with the
  span's arguments; the earlier exports decline as a transient miss, so
  the C++ path serves those rounds, and the run stops at the capture.
- `device_state(runner, st_np)` is that state on the runner's device
  (`tools/relay_cases.clone_state` copies one).
- `window_mismatch(a, b)` names what differs between two span states
  after the same window(s): every tensor column, and the outbox and the
  trace up to their counts in canonical order (the order no consumer
  sees: the round end's inbox merge sorts, and so does the trace).
"""

from __future__ import annotations

import numpy as np
import torch

from shadow_tpu_torch.ops.phold_span import (OUT_KEYS, TR_KEYS,
                                             state_from_numpy)


class _Captured(Exception):
    pass


def capture_export(mgr, nth: int, caps: dict | None = None):
    """Run `mgr` until its `nth` in-domain PHOLD export (with `caps`,
    runner attributes such as CAP_C, set before any export).  Returns
    (runner, numpy state, (start, stop, limit, runahead))."""
    runner = mgr.make_dev_span_runner()
    for k, v in (caps or {}).items():
        setattr(runner, k, v)
    eng = mgr.plane.engine
    got = {}

    class Stub:
        ineligible = 0
        last_transient = True
        last_was_cold = False
        seen = 0

        def try_span(self, start, stop, limit, runahead, dynamic,
                     max_rounds, spec_mr=0):
            d = eng.span_export_phold(*runner._caps())
            if isinstance(d, dict):
                self.seen += 1
                if self.seen == nth:
                    got["st"] = runner._to_arrays(d)
                    got["args"] = (int(start), int(stop), int(limit),
                                   int(runahead))
                    raise _Captured
            return None

    mgr._dev_span = Stub()
    try:
        mgr.run()
    except _Captured:
        pass
    if not got:
        raise AssertionError(f"fewer than {nth} in-domain PHOLD exports")
    return runner, got["st"], got["args"]


def device_state(runner, st_np: dict) -> dict:
    st = state_from_numpy(st_np, runner.device)
    st.update(runner._statics_on_device())
    return st


def canon(st: dict, prefix: str, keys, count: str) -> np.ndarray:
    """The first st[count] rows of the flat buffer `prefix`, one column
    per key, sorted on every column."""
    n = int(st[count])
    cols = np.stack([st[f"{prefix}{k}"][:n].cpu().numpy() for k in keys])
    return cols[:, np.lexsort(cols[::-1])] if n else cols


def window_mismatch(a: dict, b: dict) -> list:
    """The names of what differs between two span states: tensor
    columns, then "outbox" / "trace" (counts and canonical rows)."""
    bad = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        if k.startswith(("out_", "tr_")) \
                or not isinstance(a[k], torch.Tensor):
            continue
        if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
            bad.append(k)
    for name, prefix, keys in (("outbox", "out_", OUT_KEYS),
                               ("trace", "tr_", TR_KEYS)):
        count = f"{prefix}n"
        if count not in a:
            continue
        if int(a[count]) != int(b[count]) or not np.array_equal(
                canon(a, prefix, keys, count), canon(b, prefix, keys, count)):
            bad.append(name)
    return sorted(bad)
