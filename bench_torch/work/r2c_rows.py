"""The work of the last-axis r2c pass of a real problem (K4's): each real
point read once, each point of the half spectrum (n // 2 + 1 bins a row of
n) written once as two real planes, and FFTW's 2.5 n log2 n flops a row."""
from __future__ import annotations

import math

from ..problem import Problem

_REAL_BYTES = {"float32": 4, "float64": 8}


def work(problem: Problem, dtype: str):
    if problem.kind not in ("r2c", "c2r"):
        raise ValueError(f"no real axis in {problem.text!r}")
    rb = _REAL_BYTES[dtype]
    n = problem.sizes[-1]
    rows = problem.points // n
    return (2.5 * rows * n * math.log2(n),
            float(rb * problem.points + 2 * rb * rows * (n // 2 + 1)))
