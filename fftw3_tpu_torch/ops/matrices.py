"""Host-side transform-matrix and twiddle-factor construction.

The port's copy of ``fftw3_tpu/ops/matrices.py``: every
trigonometric constant is computed on the host in float64 and only then cast
to the compute dtype.  Exponent arguments are reduced exactly with integer
modular arithmetic before the float evaluation, so the same formula gives
bit-identical constants in both packages.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def dft_matrix(n: int, sign: int) -> np.ndarray:
    """(n, n) complex128 DFT matrix W[j,k] = exp(sign*2*pi*i*j*k/n).

    Exact integer reduction of j*k mod n keeps large-n matrices accurate.
    """
    j = np.arange(n, dtype=np.int64)
    e = np.mod(np.outer(j, j), n)
    return np.exp(sign * 2j * np.pi * e / n)


@lru_cache(maxsize=None)
def twiddle_2d(p: int, q: int, sign: int) -> np.ndarray:
    """(p, q) four-step twiddle W[c,b] = exp(sign*2*pi*i*c*b/(p*q))."""
    n = p * q
    e = np.mod(np.outer(np.arange(p, dtype=np.int64),
                        np.arange(q, dtype=np.int64)), n)
    return np.exp(sign * 2j * np.pi * e / n)


@lru_cache(maxsize=None)
def chirp(n: int, sign: int) -> np.ndarray:
    """Bluestein chirp c[j] = exp(sign*i*pi*j^2/n), j=0..n-1.

    j^2 is reduced mod 2n exactly (the chirp has period 2n in j^2)."""
    j = np.arange(n, dtype=np.int64)
    e = np.mod(j * j, 2 * n)
    return np.exp(sign * 1j * np.pi * e / n)


@lru_cache(maxsize=None)
def roots(n: int, sign: int) -> np.ndarray:
    """(n,) complex128 root table r[e] = exp(sign*2*pi*i*e/n), e=0..n-1.

    Evaluated by the same expression as :func:`dft_matrix`, so
    ``roots(n, s)[(j*k) % n]`` equals ``dft_matrix(n, s)[j, k]`` bit for
    bit: a kernel that indexes this table reproduces the dense matrix."""
    e = np.arange(n, dtype=np.int64)
    return np.exp(sign * 2j * np.pi * e / n)


# ---------------------------------------------------------------------------
# Dense r2r transform matrices, used by the O(n^2) ``r2r_matmul`` solver and
# as the double-precision oracle of the tests.  Definitions follow FFTW's
# "What FFTW Really Computes" (all unnormalized).
# ---------------------------------------------------------------------------

def _jk(n: int) -> np.ndarray:
    return np.arange(n, dtype=np.float64)


@lru_cache(maxsize=None)
def r2r_matrix(kind_name: str, n: int) -> np.ndarray:
    """(n, n) float64 matrix M with out = x @ M for the given r2r kind."""
    j = _jk(n)[:, None]   # input index
    k = _jk(n)[None, :]   # output index
    if kind_name == "dht":
        a = 2 * np.pi * np.mod(np.outer(np.arange(n, dtype=np.int64),
                                        np.arange(n, dtype=np.int64)), n) / n
        return np.cos(a) + np.sin(a)
    if kind_name == "redft00":  # DCT-I: x0 + (-1)^k x_{n-1} + 2 sum_{1..n-2}
        m = 2 * np.cos(np.pi * j * k / (n - 1))
        m[0, :] = 1.0
        m[n - 1, :] = (-1.0) ** np.arange(n)
        return m
    if kind_name == "redft10":  # DCT-II
        return 2 * np.cos(np.pi * (j + 0.5) * k / n)
    if kind_name == "redft01":  # DCT-III
        m = 2 * np.cos(np.pi * j * (k + 0.5) / n)
        m[0, :] = 1.0
        return m
    if kind_name == "redft11":  # DCT-IV
        return 2 * np.cos(np.pi * (j + 0.5) * (k + 0.5) / n)
    if kind_name == "rodft00":  # DST-I
        return 2 * np.sin(np.pi * (j + 1) * (k + 1) / (n + 1))
    if kind_name == "rodft10":  # DST-II
        return 2 * np.sin(np.pi * (j + 0.5) * (k + 1) / n)
    if kind_name == "rodft01":  # DST-III
        m = 2 * np.sin(np.pi * (j + 1) * (k + 0.5) / n)
        m[n - 1, :] = (-1.0) ** np.arange(n)
        return m
    if kind_name == "rodft11":  # DST-IV
        return 2 * np.sin(np.pi * (j + 0.5) * (k + 0.5) / n)
    if kind_name == "r2hc":
        # columns 0..n//2 are cos rows of the forward DFT; columns n-k are
        # Im(X[k]) = -sin rows (halfcomplex layout, FFTW manual 4.8)
        full = dft_matrix(n, -1)
        m = np.empty((n, n))
        for kk in range(n // 2 + 1):
            m[:, kk] = full[:, kk].real
        for kk in range(1, (n + 1) // 2):
            m[:, n - kk] = full[:, kk].imag
        return m
    if kind_name == "hc2r":
        # inverse of r2hc, unnormalized: hc2r(r2hc(x)) = n*x
        return np.linalg.inv(r2r_matrix("r2hc", n)) * n
    raise ValueError(f"unknown r2r kind {kind_name}")
