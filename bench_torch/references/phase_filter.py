"""Plain reference of FFT filtering with a phase-only matched filter.

A batch of real fields goes through the forward 2-D DFT, a product with
a fixed filter's spectrum H, and the unnormalised backward DFT: the core
of FFT convolution, correlation and filtering.  H is the phase-only
matched filter of a fixed real template t (Horner & Gianino, "Phase-only
matched filtering", Applied Optics 23(6), 1984): H = conj(T) / |T|, T the
DFT of t, so |H| = 1 in every bin and an error in any bin of the forward
pass reaches the output at full weight.  A caller keeps H's half spectrum
(the r2c layout, the last axis cut to n // 2 + 1 bins), as FFTW's users
keep a known filter's spectrum.

``reference`` computes in float64 by the definition (the DFT matrices of
``dft_c2c``, angles reduced mod n, rows in blocks): the full DFT of the
real part of its input, the product with H extended to the full spectrum
by its Hermitian symmetry, the full inverse DFT, and its real part.
``control`` is the same computation in TF32, the precision below the
configuration's float32: the DFTs' operands rounded to TF32, their sums in
float32.  Plain PyTorch; nothing of the program is imported.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import dft_c2c

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the generator seed the template is drawn from, the same in every run
TEMPLATE_SEED = 20240501


def template(shape: Sequence[int]) -> torch.Tensor:
    """The real template, uniform in [-0.5, 0.5), float64 on the CPU, drawn
    from :data:`TEMPLATE_SEED`."""
    g = torch.Generator().manual_seed(TEMPLATE_SEED)
    return torch.rand(tuple(shape), generator=g, dtype=torch.float64) - 0.5


def _flip(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """x at the negated indices, mod each size, along `dims`."""
    dims = tuple(dims)
    return torch.roll(x.flip(dims), (1,) * len(dims), dims)


def filter_half(shape: Sequence[int], device="cpu") -> torch.Tensor:
    """The half spectrum of H = conj(T) / |T| over a field of `shape`
    (complex128, the last axis cut to n // 2 + 1 bins).  T is the DFT of
    :func:`template` by the definition, made exactly Hermitian by
    averaging it with its conjugate mirror (so H is too, bit for bit); a
    bin where |T| = 0 takes H = 1."""
    shape = tuple(shape)
    axes = tuple(range(len(shape)))
    t = template(shape).to(device)
    T = dft_c2c.reference(t, axes, -1)
    T = 0.5 * (T + _flip(T, axes).conj())
    mag = T.abs()
    nonzero = mag > 0
    one, zero = torch.ones_like(mag), torch.zeros_like(mag)
    safe = torch.where(nonzero, mag, one)
    h = torch.complex(torch.where(nonzero, T.real / safe, one),
                      torch.where(nonzero, -T.imag / safe, zero))
    return h[..., :shape[-1] // 2 + 1].contiguous()


def hermitian_extend(half: torch.Tensor, n: int) -> torch.Tensor:
    """The full spectrum, last axis of `n` bins, whose first n // 2 + 1
    bins are `half` (every axis of `half` a transform axis): the rest from
    X[k] = conj(X[-k]), indices mod each size."""
    tail = half[..., 1:n - n // 2].flip(-1)
    return torch.cat([half, _flip(tail, range(half.dim() - 1)).conj()], -1)


def filtered(x: torch.Tensor, half: torch.Tensor, axes: Sequence[int],
             sign: int) -> torch.Tensor:
    """The real part of the unnormalised inverse DFT (sign -`sign`) of the
    DFT (sign `sign`) of x's real part over `axes` times the spectrum whose
    half is `half`, in float64."""
    X = dft_c2c.reference(x.real, axes, sign)
    X = X * hermitian_extend(half.to(X.device), x.shape[axes[-1]])
    return dft_c2c.reference(X, axes, -sign).real


def _sizes(x: torch.Tensor, axes: Sequence[int]):
    return [x.shape[a] for a in axes]


def reference(x: torch.Tensor, axes: Sequence[int], sign: int) -> torch.Tensor:
    """FFT filtering of x's real part by the phase-only filter over `axes`
    (the trailing ones), float64."""
    return filtered(x, filter_half(_sizes(x, axes), x.device), axes, sign)


def control(x: torch.Tensor, axes: Sequence[int], sign: int) -> torch.Tensor:
    """The same filtering in TF32: float32 out."""
    h = hermitian_extend(filter_half(_sizes(x, axes), x.device),
                         x.shape[axes[-1]]).to(torch.complex64)
    X = dft_c2c.control(x.real, axes, sign) * h
    return dft_c2c.control(X, axes, -sign).real
