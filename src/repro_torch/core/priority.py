"""The port's own copy of ``repro.core.priority``.

Priority metric H (Eq. 7).

    H_j = (Y' − Y) / (x_j^{s_j} − x_j^{s_j'})

computation cost added per unit of communication improvement when growing
communication j's resources.  Smaller H = more profitable to tune next.
A non-positive denominator (communication got slower) means j is already
at its optimum (Sec. 3.3).
"""
from __future__ import annotations

import math

H_INIT = 0.01    # Algorithm 1 line 2


def metric_h(y_before: float, y_after: float,
             x_before: float, x_after: float) -> float:
    denom = x_before - x_after          # communication improvement
    if denom <= 0.0:
        return math.inf                 # already optimal — never re-selected
    return (y_after - y_before) / denom
