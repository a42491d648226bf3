"""Plain reference of one RK2 step of pseudo-spectral 2-D Navier-Stokes.

The vorticity equation on the periodic square [0, 2 pi)^2,

    dw/dt = -(u . grad) w + nu lap(w),   u = rot(psi),  lap(psi) = -w,

stepped as ``fftw3_tpu/models/navier_stokes.py``'s ``step_fn`` writes it:
integer wavenumbers (kx from ``fftfreq(nx)[: nx // 2 + 1]``, its last entry
-nx/2), psi = W / k^2 with 0 at k = 0, the four fields u = irfft2(i ky
psi), v = irfft2(-i kx psi), wx = irfft2(i kx W), wy = irfft2(i ky W) by
four separate inverse transforms, the advection u wx + v wy transformed
back and dealiased by the 2/3 rule on integer mode numbers (|my| <= ny //
3 and |mx| <= nx // 3), and Heun's RK2 with the exact viscous factor e =
exp(-nu k^2 dt):

    W1 = (W + dt N(W)) e,   W' = W e + dt/2 (N(W) e + N(W1)).

``reference`` computes in float64 with ``torch.fft.rfft2``/``irfft2``.
``control`` is the same step in float32 with every transform's output
rounded to bfloat16, the precision below the configuration's float32.
Plain PyTorch; nothing of the program is imported.

Where this departs from the JAX source: the precision alone (float64,
and the operators in float64, where the source builds them in float32).
The source's half-step factor exp(-nu k^2 dt / 2) is built there and
never used; it is not built here.  The derivative spectra i ky psi and i
kx W are not Hermitian in the DC and Nyquist columns (kx = 0 and kx =
-nx/2); ``irfft2`` reads there, as numpy's does, the real part of those
columns' transform along axis -2 (on the CPU and in cuFFT alike), and so
does the port's c2r.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the time step of the configuration ns2048x2048: CFL 0.5 on the first
#: field of seed 0's draw at 2048^2, 0.5 (2 pi / 2048) / max |u|, rounded
#: down to two digits
DT = 0.41
#: the viscosity: the integrating factor halves the last mode the 2/3 rule
#: keeps at 2048^2 (k = 682) in one step, ln 2 / (682^2 DT)
NU = math.log(2.0) / (682 ** 2 * DT)


def operators(ny: int, nx: int, nu: float, dt: float, device,
              dtype=torch.float64):
    """(kx, ky, inverse Laplacian, dealias mask, viscous factor) on the
    half spectrum (ny, nx // 2 + 1), in `dtype`."""
    ky = torch.fft.fftfreq(ny, 1.0 / ny, dtype=torch.float64)[:, None]
    kx = torch.fft.fftfreq(nx, 1.0 / nx,
                           dtype=torch.float64)[None, : nx // 2 + 1]
    k2 = kx * kx + ky * ky
    inv_k2 = torch.where(k2 == 0, 0.0, 1.0 / torch.where(k2 == 0, 1.0, k2))
    dealias = ((ky.abs() <= ny // 3) & (kx.abs() <= nx // 3)).to(
        torch.float64)
    e_full = torch.exp(-nu * k2 * dt)
    return tuple(t.to(device=device, dtype=dtype)
                 for t in (kx, ky, inv_k2, dealias, e_full))


def _irfft2(X: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    return torch.fft.irfft2(X, s=(ny, nx))


def step(w: torch.Tensor, nu: float, dt: float, rfft2=torch.fft.rfft2,
         irfft2=_irfft2) -> torch.Tensor:
    """One RK2 step of the real fields `w` (..., ny, nx), in `w`'s
    precision (each transform passed through `rfft2` and `irfft2`)."""
    ny, nx = w.shape[-2:]
    kx, ky, inv_k2, dealias, e_full = operators(ny, nx, nu, dt, w.device,
                                                w.dtype)

    def nonlinear(W):
        psi = W * inv_k2
        u = irfft2(1j * ky * psi, ny, nx)
        v = irfft2(-1j * kx * psi, ny, nx)
        wx = irfft2(1j * kx * W, ny, nx)
        wy = irfft2(1j * ky * W, ny, nx)
        return -dealias * rfft2(u * wx + v * wy)

    W = rfft2(w)
    n1 = nonlinear(W)
    W1 = (W + dt * n1) * e_full
    n2 = nonlinear(W1)
    return irfft2(W * e_full + (dt / 2.0) * (n1 * e_full + n2), ny, nx)


def reference(x: torch.Tensor, axes: Sequence[int], sign: int) -> torch.Tensor:
    """One step of x's real part (every axis but the trailing two a
    batch), float64, at the configuration's NU and DT."""
    return step(x.real.to(torch.float64), NU, DT)


def _bf16(z: torch.Tensor) -> torch.Tensor:
    """z with its real and imaginary parts (or its values) rounded to
    bfloat16, in z's dtype."""
    if z.is_complex():
        r = torch.view_as_real(z)
        return torch.view_as_complex(r.to(torch.bfloat16).to(r.dtype))
    return z.to(torch.bfloat16).to(z.dtype)


def control_step(w: torch.Tensor, nu: float, dt: float) -> torch.Tensor:
    """The step in float32, every transform's output rounded to
    bfloat16: float32 out."""
    return step(w.to(torch.float32), nu, dt,
                rfft2=lambda a: _bf16(torch.fft.rfft2(a)),
                irfft2=lambda a, ny, nx: _bf16(_irfft2(a, ny, nx)))


def control(x: torch.Tensor, axes: Sequence[int], sign: int) -> torch.Tensor:
    """:func:`control_step` of x's real part at the configuration's NU and
    DT."""
    return control_step(x.real, NU, DT)
