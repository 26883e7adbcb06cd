"""SI-unit value parsing for config files.

Accepts the same value syntax as the reference's config layer
(src/main/utility/units.rs): a number plus an optional unit with decimal
(K/M/G/T) or binary (Ki/Mi/Gi/Ti) prefixes, e.g. "10 ms", "1 Gbit",
"16 MiB". Times normalize to nanoseconds, bandwidths to bits/sec,
sizes to bytes.
"""

from __future__ import annotations

import re

_DECIMAL = {"": 1, "k": 10**3, "K": 10**3, "M": 10**6, "G": 10**9, "T": 10**12}
_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40}

_TIME_UNITS = {
    "ns": 1, "nanosecond": 1, "nanoseconds": 1,
    "us": 10**3, "μs": 10**3, "microsecond": 10**3, "microseconds": 10**3,
    "ms": 10**6, "millisecond": 10**6, "milliseconds": 10**6,
    "s": 10**9, "sec": 10**9, "second": 10**9, "seconds": 10**9,
    "min": 60 * 10**9, "minute": 60 * 10**9, "minutes": 60 * 10**9,
    "h": 3600 * 10**9, "hour": 3600 * 10**9, "hours": 3600 * 10**9,
}

_VALUE_RE = re.compile(r"^\s*([0-9]+(?:\.[0-9]+)?)\s*([A-Za-zμ]*)\s*$")


def _split(value: str):
    m = _VALUE_RE.match(value)
    if not m:
        raise ValueError(f"cannot parse unit value: {value!r}")
    num = float(m.group(1)) if "." in m.group(1) else int(m.group(1))
    return num, m.group(2)


def parse_time_ns(value) -> int:
    """'10 ms' / '1s' / bare int (seconds, matching the config spec) -> ns."""
    if isinstance(value, (int, float)):
        return int(value * 10**9)
    num, unit = _split(value)
    if unit == "":
        return int(num * 10**9)
    if unit not in _TIME_UNITS:
        raise ValueError(f"unknown time unit {unit!r} in {value!r}")
    return int(num * _TIME_UNITS[unit])


def _parse_prefixed(value: str, suffixes: tuple[str, ...], what: str) -> int:
    num, unit = _split(value)
    for suffix in sorted(suffixes, key=len, reverse=True):
        if unit.endswith(suffix):
            prefix = unit[: len(unit) - len(suffix)]
            if prefix in _BINARY:
                return int(num * _BINARY[prefix])
            if prefix in _DECIMAL:
                return int(num * _DECIMAL[prefix])
    raise ValueError(f"cannot parse {what} value: {value!r}")


def parse_bandwidth_bits(value) -> int:
    """'1 Gbit' / '100 Mbit' -> bits per second."""
    if isinstance(value, int):
        return value
    return _parse_prefixed(value, ("bit", "bits", "bps"), "bandwidth")


def parse_bytes(value) -> int:
    """'16 MiB' / '131072 B' / bare int (bytes) -> bytes."""
    if isinstance(value, int):
        return value
    return _parse_prefixed(value, ("B", "byte", "bytes"), "byte-size")
