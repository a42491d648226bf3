"""Plain reference of the Neumann Poisson solve.

``lap(u) = f`` with homogeneous Neumann boundaries on a cell-centred grid,
solved as ``fftw3_tpu/models/poisson.py``'s ``solve_neumann`` writes it
(Schumann & Sweet, J. Comput. Phys. 75, 1988): a DCT-II (FFTW's REDFT10)
along every axis, a division by the sum of the second-order
finite-difference eigenvalues (2 cos(pi k / n) - 2) / h^2 with the mean
mode's divisor set to 1 and the mean mode then set to 0, a DCT-III
(REDFT01) along every axis, and a scale of 1 / prod(2 n).  The spacing
is the configuration's, h = 1/n on every axis: the unit cube.

``reference`` computes in float64.  ``control`` is the same solve in
float32 with every axis pass's output rounded to bfloat16, the precision
below the configuration's float32.  Plain PyTorch; nothing of the program
is imported.

Where this departs from the JAX source: the precision (float64, where the
source runs in its input's), and each DCT is a product with its dense
(n, n) matrix by the definition in place of an FFT, so the reference
shares no route with the program.  Each cosine's angle is reduced exactly,
as the integer k (2 j + 1) mod 4 n, before the cosine is taken; the
products run along one axis at a time, in blocks of the other axes, so
that a 512^3 grid fits.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: elements of one block of an axis pass's products
BLOCK = 1 << 24


def dct_matrix(n: int, kind: int, dtype=torch.float64,
               device=None) -> torch.Tensor:
    """FFTW's unnormalised DCT-II (`kind` 2: Y[k] = 2 sum_j x[j] cos(pi k
    (2j + 1) / (2n))) or DCT-III (`kind` 3: Y[k] = x[0] + 2 sum_{j >= 1}
    x[j] cos(pi j (2k + 1) / (2n))) as an (n, n) matrix M, Y = M x,
    computed in float64 and rounded once to `dtype`."""
    if kind not in (2, 3):
        raise ValueError(f"no DCT of type {kind} here")
    k = torch.arange(n, dtype=torch.int64)[:, None]
    j = torch.arange(n, dtype=torch.int64)[None, :]
    m = (k * (2 * j + 1) if kind == 2 else j * (2 * k + 1)) % (4 * n)
    w = torch.full((1, n), 2.0, dtype=torch.float64)
    if kind == 3:
        w[0, 0] = 1.0
    M = w * torch.cos(m.to(torch.float64) * (math.pi / (2 * n)))
    return M.to(dtype=dtype, device=device)


def along(x: torch.Tensor, M: torch.Tensor, axis: int) -> torch.Tensor:
    """M applied along `axis` of x (y[.., k, ..] = sum_j M[k, j] x[.., j,
    ..]), in blocks of the other axes."""
    xm = x.movedim(axis, -1)
    if xm.dim() == 1:
        return M @ xm
    out = torch.empty(xm.shape, dtype=x.dtype, device=x.device)
    step = max(1, BLOCK // max(1, xm[0].numel()))
    Mt = M.T
    for s in range(0, xm.shape[0], step):
        out[s:s + step] = torch.matmul(xm[s:s + step], Mt)
    return out.movedim(-1, axis)


def eigenvalues(shape: Sequence[int], spacing: Sequence[float],
                dtype=torch.float64, device=None) -> torch.Tensor:
    """The sum over the axes of (2 cos(pi k / n) - 2) / h^2, k = 0 .. n - 1,
    in float64, its mean mode set to 1, rounded once to `dtype`."""
    nd = len(shape)
    lam = torch.zeros((), dtype=torch.float64, device=device)
    for a, (n, h) in enumerate(zip(shape, spacing)):
        k = torch.arange(n, dtype=torch.float64, device=device)
        sh = [1] * nd
        sh[a] = n
        lam = lam + ((2.0 * torch.cos(math.pi * k / n) - 2.0)
                     / (h * h)).reshape(sh)
    lam[(0,) * nd] = 1.0
    return lam.to(dtype)


def solve(f: torch.Tensor, axes: Sequence[int],
          spacing: Optional[Sequence[float]] = None,
          rounding: Callable = lambda t: t) -> torch.Tensor:
    """The Neumann solve of f over its trailing `axes` (the others a
    batch) in f's dtype, each axis pass's output passed through
    `rounding`; the spacing 1/n on each axis unless given."""
    shape = [f.shape[a] for a in axes]
    spacing = [1.0 / n for n in shape] if spacing is None else spacing
    U = f
    for a in axes:
        U = rounding(along(U, dct_matrix(U.shape[a], 2, f.dtype, f.device),
                           a))
    U = U / eigenvalues(shape, spacing, f.dtype, f.device)
    index = [slice(None)] * f.dim()
    for a in axes:
        index[a] = 0
    U[tuple(index)] = 0.0
    for a in axes:
        U = rounding(along(U, dct_matrix(U.shape[a], 3, f.dtype, f.device),
                           a))
    return U / math.prod(2.0 * n for n in shape)


def reference(x: torch.Tensor, axes: Sequence[int], sign: int) -> torch.Tensor:
    """The solve of x's real part over `axes` in float64, h = 1/n."""
    return solve(x.real.to(torch.float64), axes)


def _bf16(z: torch.Tensor) -> torch.Tensor:
    return z.to(torch.bfloat16).to(z.dtype)


def control(x: torch.Tensor, axes: Sequence[int], sign: int) -> torch.Tensor:
    """The solve in float32, every axis pass's output rounded to
    bfloat16: float32 out."""
    return solve(x.real.to(torch.float32), axes, rounding=_bf16)
