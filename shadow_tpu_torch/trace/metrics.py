"""Metrics registry: counters / gauges / histograms in two channels.

The port's copy of `shadow_tpu/trace/metrics.py`.  Every metric
declares its channel:

- ``sim``  — deterministic given the config: the determinism gate
  byte-diffs these (two identical runs must agree, and so must the
  schedulers and the port against the JAX package).
- ``wall`` — scheduler/routing/profiling telemetry (dispatch splits,
  eligibility histograms): the gate strips the whole subtree.

Dotted names nest in the output: ``dispatch.span_rounds`` renders as
``{"dispatch": {"span_rounds": ...}}`` under the metric's channel in
``sim-stats.json``'s ``metrics`` block.
"""

from __future__ import annotations

CHANNELS = ("sim", "wall")


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def add(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Keyed histogram (bucket label -> count)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: dict = {}

    def observe(self, key: str, n: int = 1) -> None:
        self.value[key] = self.value.get(key, 0) + n


class MetricsRegistry:
    def __init__(self):
        # name -> (channel, metric)
        self._metrics: dict[str, tuple] = {}

    def _get(self, name: str, channel: str, factory):
        if channel not in CHANNELS:
            raise ValueError(f"unknown metrics channel {channel!r}")
        ent = self._metrics.get(name)
        if ent is None:
            ent = (channel, factory())
            self._metrics[name] = ent
        elif ent[0] != channel:
            raise ValueError(f"metric {name!r} re-registered on channel "
                             f"{channel!r} (was {ent[0]!r})")
        return ent[1]

    def counter(self, name: str, channel: str = "wall") -> Counter:
        return self._get(name, channel, Counter)

    def gauge(self, name: str, channel: str = "wall") -> Gauge:
        return self._get(name, channel, Gauge)

    def histogram(self, name: str, channel: str = "wall") -> Histogram:
        return self._get(name, channel, Histogram)

    def ingest(self, prefix: str, mapping: dict,
               channel: str = "wall") -> None:
        """Bulk-set gauges from a (possibly nested) dict."""
        for key, val in mapping.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(val, dict):
                self.ingest(name, val, channel)
            else:
                self.gauge(name, channel).set(val)

    def as_stats(self) -> dict:
        """The `metrics` block for sim-stats.json: one nested dict per
        channel (dotted names split into sub-dicts)."""
        out: dict = {ch: {} for ch in CHANNELS}
        for name, (channel, metric) in sorted(self._metrics.items()):
            node = out[channel]
            parts = name.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = metric.value
        return out
