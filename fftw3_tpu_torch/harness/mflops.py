"""Normalized mflops conventions (``fftw/libbench2/mflops.c`` analog; the
port of ``fftw3_tpu/harness/mflops.py``):
complex transforms score ``5 N log2(N) / t``; real-input/real-output and
r2r transforms ``2.5 N log2(N) / t``; N is the *logical* transform size
(so DCT-I of length n counts N = 2(n-1), etc.) times the batch count.
"""
from __future__ import annotations

import math

from .problem import BenchProblem


def mflops(prob: BenchProblem, seconds: float) -> float:
    n = prob.logical_n
    v = prob.nbatch
    if n <= 1 or seconds <= 0:
        return 0.0
    coef = 5.0 if prob.kind == "c2c" else 2.5
    return coef * v * n * math.log2(n) / (seconds * 1e6)
