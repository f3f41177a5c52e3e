"""Percentiles and rates over all samples of a window."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest rank: the smallest value with at least q% of the samples at
    or below it (an unanswered request is +inf and counts)."""
    s = sorted(values)
    if not s:
        raise ValueError('no samples')
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[k - 1])


def rate(done_times: Sequence[float], t0: float, t1: float) -> float:
    """Completions inside [t0, t1] per second of the window."""
    return sum(1 for t in done_times if t0 <= t <= t1) / (t1 - t0)
