"""Percentiles: linear interpolation between order statistics (numpy's
default, which ``repro_torch/serve/metrics.py`` uses)."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 50.0)
