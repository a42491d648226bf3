"""Spectral Poisson solvers — the port of ``fftw3_tpu/models/poisson.py``.

Solve ``lap(u) = f`` on regular grids with second-order finite-difference
eigenvalues (so the solver is the exact inverse of the 2nd-order stencil):

* periodic boundaries      -> FFT diagonalization (r2c / c2r)
* homogeneous Dirichlet    -> DST-I diagonalization (RODFT00)
* homogeneous Neumann      -> DCT-II/III diagonalization (REDFT10/01)

The mean/nullspace mode is projected out where the operator is singular
(periodic, Neumann).  Each solver transforms through the functional API
(``api.rfftn``/``irfftn``, ``api.dst``, ``api.dct``), so its plans come
from the functional cache: a Neumann solve over three axes draws six r2r
plans, a DCT-II and a DCT-III along each axis.  The arithmetic is the
reference's, step for step, in the input's precision.  A Neumann solve
runs in the model span ``fftw.model.neumann_solve`` (``trace.model``).

Where this departs from the JAX source:

* the eigenvalue array is summed in float64 on the field's device, in
  the source's order, and rounded once to the field's real dtype, as
  ``jnp.asarray(lam, U.dtype)`` rounds it (the source builds it on the
  host, at 512^3 a 1 GiB float64 array and a 512 MiB copy a solve);
* :func:`solve_neumann_fn` builds a solve that keeps its eigenvalues, as
  ``navier_stokes.step_fn`` keeps its operators: built once, on the
  device of the first call, for a caller that solves once a time step;
* ``spacing`` may name fewer axes than the field has: the solve then runs
  over the trailing ``len(spacing)`` axes and the leading ones are a
  batch.  With ``spacing`` None or of the field's rank every axis is
  solved, as in the source (which raises on a shorter ``spacing``).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import api, trace


def _eig_periodic(n, h):
    k = np.arange(n)
    return (2.0 * np.cos(2.0 * np.pi * k / n) - 2.0) / (h * h)


def _eig_dirichlet(n, h):
    k = np.arange(1, n + 1)
    return (2.0 * np.cos(np.pi * k / (n + 1)) - 2.0) / (h * h)


def _eig_neumann(n, h):
    k = np.arange(n)
    return (2.0 * np.cos(np.pi * k / n) - 2.0) / (h * h)


_EIGENVALUES = {"periodic": _eig_periodic, "dirichlet": _eig_dirichlet,
                "neumann": _eig_neumann}


def _divisor(solver: str, shape: Tuple[int, ...],
             spacing: Tuple[float, ...], dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """The sum of `solver`'s per-axis eigenvalues over the spectrum of a
    grid of `shape` (the periodic solver's last axis cut to n // 2 + 1),
    summed in float64 on `device` and rounded once to `dtype`, with the
    mean mode set to 1 where the operator is singular."""
    nd = len(shape)
    lam = torch.zeros((), dtype=torch.float64, device=device)
    for a, (n, h) in enumerate(zip(shape, spacing)):
        e = _EIGENVALUES[solver](n, h)
        if solver == "periodic" and a == nd - 1:
            e = e[: n // 2 + 1]
        sh = [1] * nd
        sh[a] = len(e)
        lam = lam + torch.from_numpy(e).to(device).reshape(sh)
    if solver != "dirichlet":
        lam[(0,) * nd] = 1.0                   # nullspace: mean mode
    return lam.to(dtype)


def _grid(f, spacing):
    """(f as a real tensor, the solved axes, the grid's shape on them,
    their spacings): every axis where `spacing` is None, else the trailing
    ``len(spacing)``."""
    f = api._as_real(f)
    nd = f.dim() if spacing is None else len(spacing)
    if not 1 <= nd <= f.dim():
        raise ValueError(f"spacing names {nd} axes of a {f.dim()}-D field")
    spacing = (1.0,) * nd if spacing is None else tuple(map(float, spacing))
    axes = tuple(range(f.dim() - nd, f.dim()))
    return f, axes, tuple(f.shape[a] for a in axes), spacing


def solve_periodic(f, spacing: Sequence[float] = None) -> torch.Tensor:
    """Periodic Poisson: real f -> real u with zero mean."""
    f, axes, shape, spacing = _grid(f, spacing)
    F = api.rfftn(f, axes=axes)
    U = F / _divisor("periodic", shape, spacing, f.dtype, f.device)
    U[(...,) + (0,) * len(axes)] = 0.0
    return api.irfftn(U, s=shape, axes=axes)   # numpy-norm: includes 1/N


def solve_dirichlet(f, spacing: Sequence[float] = None) -> torch.Tensor:
    """Homogeneous Dirichlet Poisson via DST-I along every axis."""
    f, axes, shape, spacing = _grid(f, spacing)
    U = f
    for a in axes:
        U = api.dst(U, type=1, axis=a)
    U = U / _divisor("dirichlet", shape, spacing, U.dtype, U.device)
    for a in axes:
        U = api.dst(U, type=1, axis=a)
    return U / math.prod(2.0 * (n + 1) for n in shape)


def _neumann(f, axes, shape, lam):
    U = f
    for a in axes:
        U = api.dct(U, type=2, axis=a)
    U = U / lam
    U[(...,) + (0,) * len(axes)] = 0.0
    for a in axes:
        U = api.dct(U, type=3, axis=a)
    return U / math.prod(2.0 * n for n in shape)


def solve_neumann(f, spacing: Sequence[float] = None) -> torch.Tensor:
    """Homogeneous Neumann Poisson via DCT-II/III; zero-mean solution."""
    with trace.model("fftw.model.neumann_solve"):
        f, axes, shape, spacing = _grid(f, spacing)
        lam = _divisor("neumann", shape, spacing, f.dtype, f.device)
        return _neumann(f, axes, shape, lam)


def solve_neumann_fn(spacing: Sequence[float] = None):
    """:func:`solve_neumann` as a solve ``f -> u`` that keeps its
    eigenvalues: built once, for the grid, dtype and device of the first
    call, which every later call shares."""
    lam = None

    def solve(f):
        nonlocal lam
        with trace.model("fftw.model.neumann_solve"):
            f, axes, shape, h = _grid(f, spacing)
            if lam is None:
                lam = _divisor("neumann", shape, h, f.dtype, f.device)
            return _neumann(f, axes, shape, lam)

    return solve


def laplacian_periodic(u, spacing: Sequence[float] = None) -> torch.Tensor:
    """The matching 2nd-order periodic stencil (for verification)."""
    u, axes, _, spacing = _grid(u, spacing)
    out = torch.zeros_like(u)
    for a, h in zip(axes, spacing):
        out = out + (torch.roll(u, 1, a) - 2 * u
                     + torch.roll(u, -1, a)) / h ** 2
    return out
