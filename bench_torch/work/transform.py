"""The work of a whole transform: each input point read once, each output
point written once, and FFTW's normalised flops (``libbench2/mflops.c``:
5 N log2 N for a complex transform, 2.5 N log2 N for a real or r2r one,
N the logical points of one transform, times the batch)."""
from __future__ import annotations

import math

from ..problem import Problem

_REAL_BYTES = {"float32": 4, "float64": 8, "complex64": 4, "complex128": 8}


def work(problem: Problem, dtype: str):
    """(flops, bytes) of one call on `problem` in `dtype`."""
    rb = _REAL_BYTES[dtype]
    n = problem.logical_n
    flops = (5.0 if problem.kind == "c2c" else 2.5) * problem.nbatch \
        * n * math.log2(n) if n > 1 else 0.0
    half = problem.points // problem.sizes[-1] * (problem.sizes[-1] // 2 + 1)
    points_in, points_out = {
        "c2c": (2 * problem.points, 2 * problem.points),
        "r2c": (problem.points, 2 * half),
        "c2r": (2 * half, problem.points),
        "r2r": (problem.points, problem.points)}[problem.kind]
    return flops, float(rb * (points_in + points_out))
