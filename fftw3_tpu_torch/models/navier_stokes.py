"""Pseudo-spectral 2-D incompressible Navier-Stokes (vorticity form) — the
port of ``fftw3_tpu/models/navier_stokes.py``.

Vorticity equation on the periodic square, solved spectrally::

    dw/dt = -(u . grad) w + nu lap(w),   u = rot(psi),  lap(psi) = -w

* spatial derivatives and the Poisson inversion are exact in Fourier space
* the quadratic advection term is evaluated pseudo-spectrally with 2/3-rule
  dealiasing (Orszag)
* time stepping: RK2 (Heun) with an exact integrating factor for the
  viscous term — unconditionally stable diffusion

:func:`step_fn` transforms with the functional ``api.rfftn``/``irfftn``
over the two trailing axes, so every plan comes from the functional API's
cache: a step makes six plan calls, the forward transform of w, twice the
four velocity and gradient fields through one stacked inverse transform
and the forward transform of their product, and the inverse transform of
the new spectrum.  The arithmetic is the reference's, term for term, in
float32/complex64.  The distributed step waits for the port's distributed
tier.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import api, trace


def _wavenumbers(n: int) -> np.ndarray:
    # domain [0, 2pi): mode m <-> exp(i m x), so wavenumbers are integers
    return np.fft.fftfreq(n, 1.0 / n)


def _spectral_operators(ny: int, nx: int):
    """(kx, ky on the rfft2 grid; k^2; inverse Laplacian; 2/3 dealias mask),
    float32 numpy arrays, as the reference builds them."""
    ky = _wavenumbers(ny)[:, None]                    # (ny, 1)
    kx = _wavenumbers(nx)[None, : nx // 2 + 1]        # (1, nx//2+1)
    k2 = kx * kx + ky * ky
    inv_k2 = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))
    # 2/3 rule on INTEGER mode numbers
    my = np.fft.fftfreq(ny, 1.0 / ny)[:, None]
    mx = np.fft.fftfreq(nx, 1.0 / nx)[None, : nx // 2 + 1]
    dealias = ((np.abs(my) <= ny // 3) & (np.abs(mx) <= nx // 3))
    return (kx.astype(np.float32), ky.astype(np.float32),
            k2.astype(np.float32), inv_k2.astype(np.float32),
            dealias.astype(np.float32))


class _Operators(NamedTuple):
    """The step's operators on one device: the derivative factors i ky,
    -i kx, i kx (complex64), the inverse Laplacian, the negated dealias
    mask and the viscous factor exp(-nu k^2 dt) (float32)."""
    iky: torch.Tensor
    neg_ikx: torch.Tensor
    ikx: torch.Tensor
    inv_k2: torch.Tensor
    neg_dealias: torch.Tensor
    e_full: torch.Tensor


def _operators(ny: int, nx: int, nu: float, dt: float, device) -> _Operators:
    kx, ky, k2, inv_k2, dealias = _spectral_operators(ny, nx)
    # exact viscous integrating factors; the reference builds the half-step
    # factor too and never uses it
    e_full = np.exp(-nu * k2 * dt).astype(np.float32)
    c64 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a.astype(np.complex64))).to(device)
    f32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(device)
    return _Operators(c64(1j * ky), c64(-1j * kx), c64(1j * kx),
                      f32(inv_k2), f32(-dealias), f32(e_full))


def step_fn(ny: int, nx: int, nu: float, dt: float):
    """RK2 step ``w -> w`` for real float32 vorticity fields (..., ny, nx)
    (leading batch dims broadcast).  The operators are built once, on the
    device of the first call."""
    op = None

    def rfft2(x):
        return api.rfftn(x, axes=(-2, -1))

    def irfft2(X):
        return api.irfftn(X, s=(ny, nx), axes=(-2, -1))

    def nonlinear(W):
        """N(W) = -dealias(FFT[(u.grad) w]) from spectral vorticity W: the
        four spectra i ky psi, -i kx psi, i kx W, i ky W written into one
        stacked buffer and inverted by one plan call.  Each temporary is
        dropped once used: the buffer and its transform hold four fields
        each (1 GiB a buffer at 16 x 2048^2)."""
        with trace.model("fftw.model.ns.nonlinear"):
            psi = W * op.inv_k2              # lap(psi) = -w -> psi = w/k2
            S = torch.empty((4,) + tuple(W.shape), dtype=W.dtype,
                            device=W.device)
            torch.mul(op.iky, psi, out=S[0])       # u =  d(psi)/dy
            torch.mul(op.neg_ikx, psi, out=S[1])   # v = -d(psi)/dx
            torch.mul(op.ikx, W, out=S[2])         # wx
            torch.mul(op.iky, W, out=S[3])         # wy
            del psi
            u, v, wx, wy = irfft2(S)
            del S
            prod = u * wx + v * wy
            del u, v, wx, wy
            return op.neg_dealias * rfft2(prod)

    def step(w):
        nonlocal op
        if op is None:
            op = _operators(ny, nx, nu, dt, w.device)
        with trace.model("fftw.model.ns_step"):
            W = rfft2(w)
            n1 = nonlinear(W)
            W1 = (W + dt * n1) * op.e_full          # Euler predictor
            n2 = nonlinear(W1)
            del W1
            # Heun corrector with integrating-factor weighting
            Wn = W * op.e_full + (dt / 2.0) * (n1 * op.e_full + n2)
            del W, n1, n2
            return irfft2(Wn)

    return step


def taylor_green_vorticity(ny: int, nx: int, kappa: int = 1) -> np.ndarray:
    """Taylor-Green vortex initial vorticity: w = 2 kappa^2 cos(kx) cos(ky)
    (decays analytically as exp(-2 nu kappa^2 t) — the standard spectral
    NS validation)."""
    y = np.arange(ny) * (2.0 * np.pi / ny)
    x = np.arange(nx) * (2.0 * np.pi / nx)
    return (2.0 * kappa * kappa
            * np.cos(kappa * y)[:, None] * np.cos(kappa * x)[None, :]
            ).astype(np.float32)


def distributed_step_fn(ny: int, nx: int, nu: float, dt: float, mesh,
                        axis_name: str = "x",
                        transpose_method: str = "all_to_all"):
    """The RK2 step with the field sharded over its y axis, on distributed
    r2c/c2r plans: not available until the distributed tier is ported."""
    raise NotImplementedError(
        "navier_stokes.distributed_step_fn: the distributed tier "
        "(fftw3_tpu/parallel/) is not yet ported to fftw3_tpu_torch; "
        "step a field on one device with step_fn")
