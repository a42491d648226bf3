"""The work of FFT filtering's two passes over axis -2 of the half
spectrum (K2's, the r2c's forward and the c2r's backward): each pass reads
and writes every point of the half spectrum as two real planes and makes
5 log2 m flops a point, m the length of axis -2."""
from __future__ import annotations

import math

from ..problem import Problem
from .r2c_rows import _REAL_BYTES

PASSES = 2


def work(problem: Problem, dtype: str):
    if problem.kind not in ("r2c", "c2r") or len(problem.sizes) < 2:
        raise ValueError(f"no axis -2 of a real problem in {problem.text!r}")
    rb = _REAL_BYTES[dtype]
    n, m = problem.sizes[-1], problem.sizes[-2]
    half = problem.points // n * (n // 2 + 1)
    return (PASSES * 5.0 * half * math.log2(m),
            float(PASSES * 2 * 2 * rb * half))
