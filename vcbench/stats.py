"""Percentiles, rates and spreads, as the benchmark computes them.

A percentile is the nearest-rank one (no interpolation between samples);
a request that failed counts as an infinite latency.
"""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    k = max(int(math.ceil(q / 100.0 * len(xs))), 1)
    return xs[k - 1]


def median(values) -> float:
    return statistics.median(values)


