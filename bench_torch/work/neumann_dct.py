"""The work of a Neumann Poisson solve's DCT passes (``entries/
neumann_solve``): a DCT-II along every axis, then a DCT-III along every
axis, six passes of a 3-D grid.  Each pass reads every real point once and
writes it once, and costs FFTW's 2.5 n log2 n flops a row of its axis, at
the physical n of the axis (not FFTW's logical 2n of a REDFT10)."""
from __future__ import annotations

import math

from ..problem import Problem

_REAL_BYTES = {"float32": 4, "float64": 8}


def work(problem: Problem, dtype: str):
    if problem.kind != "r2r" or set(problem.r2r) != {"e10"}:
        raise ValueError(f"no DCT-II/DCT-III solve in {problem.text!r}")
    rb = _REAL_BYTES[dtype]
    passes = 2 * len(problem.sizes)
    flops = 2 * sum(2.5 * problem.points * math.log2(n)
                    for n in problem.sizes)
    return flops, float(passes * 2 * rb * problem.points)
