"""Real-input / real-output DFT solvers (rdft2 format) — the port
of ``fftw3_tpu/ops/real.py``.

``r2c`` maps real ``(..., n)`` to the half spectrum ``(..., n//2+1)``
(FFTW's rdft2 layout); ``c2r`` is the unnormalized inverse
(``c2r(r2c(x)) = n*x``), with the imaginary parts of the DC and Nyquist
bins dropped, as numpy and FFTW drop them.

The core representation is split, as for c2c: :func:`build_r2c_split`
gives ``x -> (yr, yi)`` and :func:`build_c2r_split` gives
``(xr, xi) -> y`` on real tensors, so that multi-axis plans keep the planes
split between passes; :func:`build_r2c` and :func:`build_c2r` wrap them for
complex tensors.  Solvers:

* ``pallas_r2c`` / ``pallas_c2r`` — the real Stockham kernels K4 and K6
  (``ops/real_stockham.py``);
* ``r2c_dense`` / ``c2r_dense`` — dense cos/sin matrices through
  ``torch.matmul`` at full precision (``dense.exact_matmul``);
* ``r2c_pack`` / ``c2r_pack`` — even n via a half-size complex DFT over the
  packed even/odd samples plus an untangling twiddle pass;
* ``r2c_via_c2c`` / ``c2r_via_c2c`` — any n by complex embedding /
  Hermitian extension.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from . import c2c as c2c_ops
from . import matrices
from .dense import exact_matmul

SplitR2C = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
SplitC2R = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

#: the algs of r2c and c2r descriptors
ALGS = frozenset(a for kind in ("r2c", "c2r")
                 for a in (f"pallas_{kind}", f"{kind}_dense", f"{kind}_pack",
                           f"{kind}_via_c2c"))


def full_spectrum(xr: torch.Tensor, xi: torch.Tensor, n: int):
    """Reconstruct the length-n Hermitian spectrum from its n//2+1 half,
    on split planes."""
    h = (n + 1) // 2
    return (torch.cat([xr, xr[..., 1:h].flip(-1)], -1),
            torch.cat([xi, -xi[..., 1:h].flip(-1)], -1))


@lru_cache(maxsize=None)
def _roots_half(n: int, sign: int, rdtype, device):
    """(re, im) of exp(sign*2*pi*i*k/n), k = 0..n/2, host f64 rounded once
    to the plan's real dtype (the reference rounds its complex constant),
    made once per device."""
    w = matrices.roots(n, sign)[:n // 2 + 1]
    return (c2c_ops._const(w.real, rdtype, device),
            c2c_ops._const(w.imag, rdtype, device))


def untangle(zr, zi, wr, wi, dim: int = -1):
    """The r2c half of the rdft2 pack: X[k] = A[k] + w[k] B[k], k = 0..m,
    from Z = DFT_m(x_even + i x_odd) along `dim`, where A = (Z[k] + conj
    Z[m-k]) / 2, B = -i (Z[k] - conj Z[m-k]) / 2, indices of Z mod m and w
    from :func:`_roots_half`.  ``r2c_pack`` and the twins of K4 and K5 run
    it; the kernels do the same arithmetic, term for term."""
    fr = torch.cat([zr, zr.narrow(dim, 0, 1)], dim)     # Z[k mod m]
    fi = torch.cat([zi, zi.narrow(dim, 0, 1)], dim)
    rr, ri = fr.flip(dim), fi.flip(dim)                 # Z[(m - k) mod m]
    ur, ui = 0.5 * (fr + rr), 0.5 * (fi - ri)
    vr, vi = 0.5 * (fi + ri), 0.5 * (rr - fr)
    return ur + wr * vr - wi * vi, ui + wr * vi + wi * vr


def tangle(xr, xi, vr, vi):
    """The c2r half of the rdft2 pack: Z[k] = E[k] + i O[k], k = 0..m-1,
    from the half spectrum X (..., m+1), where E = (X[k] + conj X[m-k]) / 2
    and O = (X[k] - conj X[m-k]) v[k] / 2 with v the sign +1 roots of
    :func:`_roots_half`.  Im X[0] and Im X[m] are dropped first, as numpy,
    FFTW's hc format and every other c2r solver here drop them: the
    even/odd untangle would otherwise leak them into y.  ``c2r_pack`` and
    the twin of K6 run it; the kernel does the same arithmetic."""
    m = xr.shape[-1] - 1
    zero = torch.zeros_like(xi[..., :1])
    xi = torch.cat([zero, xi[..., 1:m], zero], -1)
    rr, ri = xr.flip(-1), xi.flip(-1)                   # X[m - k]
    er, ei = 0.5 * (xr + rr), 0.5 * (xi - ri)
    dr, di = 0.5 * (xr - rr), 0.5 * (xi + ri)
    orr, oi = dr * vr - di * vi, dr * vi + di * vr
    return (er - oi)[..., :m], (ei + orr)[..., :m]


def build_r2c_split(desc: Dict, rdtype, device) -> SplitR2C:
    """Real (..., n) -> (yr, yi) of (..., n//2+1) for an r2c descriptor."""
    alg = desc["alg"]
    n = desc["n"]
    device = torch.device(device)

    if alg == "pallas_r2c":
        from . import real_stockham
        return real_stockham.build_pallas_r2c(desc, rdtype, device)

    if alg == "r2c_dense":
        m = n // 2 + 1
        j = np.arange(n, dtype=np.int64)[:, None]
        k = np.arange(m, dtype=np.int64)[None, :]
        e = 2.0 * np.pi * np.mod(j * k, n) / n
        Cr = c2c_ops._const(np.cos(e), rdtype, device)
        Ci = c2c_ops._const(-np.sin(e), rdtype, device)
        return lambda x: (exact_matmul(x, Cr), exact_matmul(x, Ci))

    if alg == "r2c_via_c2c":
        child = c2c_ops.build_c2c_split(desc["child"], -1, rdtype, device)

        def apply_via(x):
            yr, yi = child(x, torch.zeros_like(x))
            return yr[..., :n // 2 + 1], yi[..., :n // 2 + 1]
        return apply_via

    if alg == "r2c_pack":
        if n % 2:
            raise ValueError(f"r2c_pack needs an even n, got {n}")
        child = c2c_ops.build_c2c_split(desc["child"], -1, rdtype, device)
        wr, wi = _roots_half(n, -1, rdtype, device)

        return lambda x: untangle(*child(x[..., 0::2], x[..., 1::2]), wr, wi)

    raise ValueError(f"unknown r2c algorithm {alg!r}")


def build_c2r_split(desc: Dict, rdtype, device) -> SplitC2R:
    """(xr, xi) of (..., n//2+1) -> real (..., n) for a c2r descriptor."""
    alg = desc["alg"]
    n = desc["n"]
    device = torch.device(device)

    if alg == "pallas_c2r":
        from . import real_stockham
        return real_stockham.build_pallas_c2r(desc, rdtype, device)

    if alg == "c2r_dense":
        m = n // 2 + 1
        k = np.arange(m, dtype=np.int64)[:, None]
        t = np.arange(n, dtype=np.int64)[None, :]
        e = 2.0 * np.pi * np.mod(k * t, n) / n
        w = np.full((m, 1), 2.0)
        w[0] = 1.0
        if n % 2 == 0:
            w[-1] = 1.0
        Br = c2c_ops._const(w * np.cos(e), rdtype, device)
        Bi = c2c_ops._const(-w * np.sin(e), rdtype, device)
        return lambda xr, xi: exact_matmul(xr, Br) + exact_matmul(xi, Bi)

    if alg == "c2r_via_c2c":
        child = c2c_ops.build_c2c_split(desc["child"], +1, rdtype, device)
        return lambda xr, xi: child(*full_spectrum(xr, xi, n))[0]

    if alg == "c2r_pack":
        if n % 2:
            raise ValueError(f"c2r_pack needs an even n, got {n}")
        child = c2c_ops.build_c2c_split(desc["child"], +1, rdtype, device)
        vr, vi = _roots_half(n, +1, rdtype, device)

        def apply_pack(xr, xi):
            zr, zi = child(*tangle(xr, xi, vr, vi))
            return torch.stack([2.0 * zr, 2.0 * zi], -1).reshape(
                *zr.shape[:-1], n)
        return apply_pack

    raise ValueError(f"unknown c2r algorithm {alg!r}")


def build_r2c(desc: Dict, rdtype, device) -> Callable:
    """Real in, complex half spectrum out."""
    split = build_r2c_split(desc, rdtype, device)
    return lambda x: torch.complex(*split(x))


def build_c2r(desc: Dict, rdtype, device) -> Callable:
    """Complex half spectrum in, real out."""
    split = build_c2r_split(desc, rdtype, device)
    return lambda X: split(X.real, X.imag)


def r2c_opcount(desc: Dict) -> Dict[str, float]:
    """(add, mul, fma) per transform, equal to the reference's."""
    n = desc["n"]
    if desc["alg"] in ("r2c_dense", "c2r_dense"):
        mac = 2.0 * n * (n // 2 + 1)
        return {"add": mac, "mul": 0.0, "fma": mac}
    if desc["alg"] in ("pallas_r2c", "pallas_c2r"):
        m = n // 2
        total = {"add": 4.0 * n, "mul": 4.0 * n, "fma": 0.0}
        rest = m
        for p in desc["radices"]:
            q = rest // p
            batch = m // rest
            total["add"] += 3.0 * p * p * q * batch
            total["fma"] += 3.0 * p * p * q * batch
            if q > 1:
                total["mul"] += 6.0 * rest * batch
            rest = q
        return total
    child = c2c_ops.c2c_opcount(desc["child"])
    extra = 6.0 * (n // 2 + 1)
    return {"add": child["add"] + extra, "mul": child["mul"] + extra,
            "fma": child["fma"]}


c2r_opcount = r2c_opcount
