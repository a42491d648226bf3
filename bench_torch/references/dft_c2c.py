"""Plain reference of a complex DFT: the definition, one axis at a time,
as a product with the DFT matrix.

``reference`` computes in float64 (complex128): the oracle every output
of a run is compared with.  ``control`` is the same product in TF32, the
precision below the configurations' float32 that a faster program could
slip into: operands rounded to TF32's 10-bit mantissa, sums in float32.
The rounding is explicit, so the control reads the same on the card and
on the CPU.  Plain PyTorch; nothing of the program is imported.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

#: points a block of rows holds, so that no temporary exceeds a few GiB
BLOCK_POINTS = 1 << 24


def dft_matrix(n: int, sign: int, device, dtype=torch.complex128):
    """W[j, k] = exp(sign 2 pi i jk / n), the angle reduced mod n first."""
    j = torch.arange(n, device=device, dtype=torch.int64)
    angle = (torch.outer(j, j) % n).to(torch.float64) * (sign * 2 * math.pi / n)
    w = torch.polar(torch.ones_like(angle), angle)
    return w.to(dtype)


def _last_axis(x: torch.Tensor, fn) -> torch.Tensor:
    """fn over the rows of the last axis, in blocks of rows."""
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    out = torch.empty_like(rows)
    step = max(1, BLOCK_POINTS // n)
    for r in range(0, rows.shape[0], step):
        out[r:r + step] = fn(rows[r:r + step])
    return out.reshape(x.shape)


def _axes(x: torch.Tensor, axes: Sequence[int], fn_of_n) -> torch.Tensor:
    for axis in axes:
        fn = fn_of_n(x.shape[axis])
        x = _last_axis(x.movedim(axis, -1), fn).movedim(-1, axis)
    return x


def reference(x: torch.Tensor, axes: Sequence[int], sign: int) -> torch.Tensor:
    """The unnormalised DFT of `x` over `axes`, in complex128."""
    def fn_of_n(n):
        w = dft_matrix(n, sign, x.device)
        return lambda rows: rows @ w
    return _axes(x.to(torch.complex128), axes, fn_of_n)


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), to nearest even."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def control(x: torch.Tensor, axes: Sequence[int], sign: int) -> torch.Tensor:
    """The same DFT in TF32: complex64 out."""
    def fn_of_n(n):
        w = dft_matrix(n, sign, x.device, torch.complex64)
        wr, wi = to_tf32(w.real), to_tf32(w.imag)

        def fn(rows):
            xr, xi = to_tf32(rows.real), to_tf32(rows.imag)
            return torch.complex(xr @ wr - xi @ wi, xr @ wi + xi @ wr)
        return fn
    return _axes(x.to(torch.complex64), axes, fn_of_n)
