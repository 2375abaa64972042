"""The bytes of K1 (``param_stats_kernel``, the distribution upload)
for one round: every client's every parameter read once, and two fp32
statistics a client and leaf written once."""
from __future__ import annotations

import math


def bytes_moved(shapes, itemsize: int = 4) -> int:
    """``shapes``: the client-stacked leaves' shapes, (N, ...) each."""
    n = shapes[0][0]
    return sum(math.prod(s) * itemsize for s in shapes) + n * len(shapes) * 2 * 4
