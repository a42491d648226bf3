"""The work of a Navier-Stokes RK2 step's transforms: 12 real 2-D
transforms of the batch (per evaluation of the advection term, four
inverse and one forward; one forward and one inverse around the step),
each reading its input once and writing its output once, 4 B a real point
and 8 B a half-spectrum point, with FFTW's 2.5 N log2 N flops: 12 times
one r2c's work."""
from __future__ import annotations

from ..problem import Problem
from . import transform

TRANSFORMS = 12


def work(problem: Problem, dtype: str):
    if problem.kind != "r2c" or len(problem.sizes) != 2:
        raise ValueError(f"no 2-D real problem in {problem.text!r}")
    flops, nbytes = transform.work(problem, dtype)
    return TRANSFORMS * flops, TRANSFORMS * nbytes
