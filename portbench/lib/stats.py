"""Percentiles, the same arithmetic in every cell."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least q% of the values at or below it. None for no values."""
    if not values:
        return None
    s = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[rank - 1])
