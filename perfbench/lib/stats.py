"""Percentiles and spreads, in plain Python.

``percentile`` interpolates linearly between order statistics (numpy's
default); a value of ``inf`` (a request that failed or never came) sorts
last, so a tail that reaches it reads ``inf``.  ``spread`` is the distance
between the first and third quartiles as ``statistics.quantiles(values,
n=4)`` gives them, as a share of the median: how the bounds of
``BENCHMARK.json`` were set.
"""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    if not values:
        raise ValueError("percentile of no values")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile {q} outside [0, 100]")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    if frac == 0.0 or xs[lo] == xs[hi]:
        return xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def spread(values: Sequence[float]) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
