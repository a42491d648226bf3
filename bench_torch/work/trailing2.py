"""The work of one pass over the two trailing axes of a complex problem
(the fused 2-D kernel's pass): one read and one write of every point, and
5 log2(n1 n2) flops a point."""
from __future__ import annotations

import math

from ..problem import Problem


def work(problem: Problem, dtype: str):
    if problem.kind != "c2c" or len(problem.sizes) < 2:
        raise ValueError(f"no trailing axis pair in {problem.text!r}")
    rb = 4 if dtype == "complex64" else 8
    plane = problem.sizes[-1] * problem.sizes[-2]
    return (5.0 * problem.points * math.log2(plane),
            float(2 * rb * 2 * problem.points))
