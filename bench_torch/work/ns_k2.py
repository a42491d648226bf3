"""The work of a Navier-Stokes RK2 step's K2 passes (``entries/ns_step``):
each of the step's 12 real 2-D transforms of the batch makes one pass over
axis -2 of its half spectrum (the r2c's after K4, the c2r's ahead of K6;
the stacked c2r's four count four), reading and writing every point as two
real planes with 5 log2 m flops a point: six times FFT filtering's two
passes (``conv_k2``)."""
from __future__ import annotations

from ..problem import Problem
from . import conv_k2

PASSES = 12


def work(problem: Problem, dtype: str):
    flops, nbytes = conv_k2.work(problem, dtype)
    scale = PASSES / conv_k2.PASSES
    return scale * flops, scale * nbytes
