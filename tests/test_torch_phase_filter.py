"""FFT filtering of real fields through the port's real plans, against the
plain float64 reference the benchmark uses (``bench_torch/references/
phase_filter.py``): the port's r2c, an in-place product with the
phase-only filter's half spectrum H and the port's c2r, on seeded inputs
with the kernel solvers' twins offered; the reference itself against a
direct circular cross-correlation sum; H's unit magnitude and Hermitian
symmetry.  This file imports no JAX.
"""
import math

import numpy as np
import pytest
import torch

import fftw3_tpu_torch as ft
from bench_torch.references import phase_filter as pf
from fftw3_tpu_torch import config

#: max |y - ref| / max |ref| the port may reach: the port holds float32
#: transforms within about 1e-5 of float64 (PERF.md § 2); its readings
#: here are 2-5e-7.  The TF32 control reads about 4e-4, so it fails.
TOL = 1e-5
#: the reference against sums in float64 with no rounding but theirs
TOL_F64 = 1e-12


@pytest.fixture
def cpu_plans(monkeypatch):
    """Plans on the CPU, the kernel solvers' twins offered."""
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(ft.the_planner, "wisdom", {})


def _field(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) - 0.5


def _err(y, ref):
    return ((y.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("shape, algs", [
    ((2, 64, 64), None),
    ((3, 32, 128), None),
    ((1, 128, 32), None),
    # K4, K2 over the odd-width half spectrum and K6, as on the card
    ((2, 128, 1024), {"pallas_r2c", "pallas", "pallas_c2r"}),
])
def test_port_filtering_matches_the_reference(cpu_plans, shape, algs):
    n, howmany = shape[1:], shape[0]
    r2c = ft.plan_many_dft_r2c(n, howmany)
    c2r = ft.plan_many_dft_c2r(n, howmany)
    h = pf.filter_half(n).to(torch.complex64)
    x = _field(shape, seed=sum(shape))
    X = r2c.execute(x)
    X.mul_(h)
    y = c2r.execute(X)
    axes = (1, 2)
    ref = pf.reference(x, axes, ft.FORWARD)
    assert y.dtype == torch.float32 and y.shape == ref.shape
    assert _err(y, ref) <= TOL
    assert _err(pf.control(x, axes, ft.FORWARD), ref) > 10 * TOL
    if algs is not None:
        used = {d["alg"] for p in (r2c.plan, c2r.plan)
                for d in p.descriptors.values()}
        assert used == algs


def _correlate(x, w):
    """N times the circular cross-correlation of each field of x with w,
    y[m] = N sum_l x[l + m] w[l], by the direct sum (indices mod the
    sizes, N the points of a field)."""
    n0, n1 = w.shape
    y = np.zeros(x.shape)
    for m0 in range(n0):
        for m1 in range(n1):
            shifted = np.roll(x, (-m0, -m1), axis=(-2, -1))
            y[..., m0, m1] = (shifted * w).sum(axis=(-2, -1))
    return n0 * n1 * y


def test_reference_is_a_circular_cross_correlation():
    """The phase-only filter H = conj(T) / |T| is the spectrum of the
    whitened template w, so filtering is N times the correlation with w
    (w from numpy's inverse DFT of T / |T|, the sum direct)."""
    shape = (8, 8)
    t = pf.template(shape).numpy()
    T = np.fft.fft2(t)
    w = np.fft.ifft2(T / np.abs(T)).real
    x = _field((2, *shape), seed=3).double()
    y = pf.reference(x, (1, 2), ft.FORWARD)
    direct = _correlate(x.numpy(), w)
    assert np.abs(y.numpy() - direct).max() <= TOL_F64 * np.abs(direct).max()


@pytest.mark.parametrize("shape, at", [((8, 8), (3, 5)), ((6, 9), (4, 7))])
def test_a_point_template_shifts_the_field(shape, at):
    """A template that is one point at p has T[k] = exp(-2 pi i k.p / n)
    in closed form, so |T| = 1 and filtering by conj(T) gives N x[m + p]:
    no DFT on this side."""
    k = [torch.arange(n, dtype=torch.float64) for n in shape]
    angle = -2 * math.pi * (k[0][:, None] * at[0] / shape[0]
                            + k[1][None, :] * at[1] / shape[1])
    half = torch.polar(torch.ones_like(angle), -angle)[:, :shape[1] // 2 + 1]
    x = _field((3, *shape), seed=5).double()
    y = pf.filtered(x, half, (1, 2), ft.FORWARD)
    want = math.prod(shape) * torch.roll(x, (-at[0], -at[1]), (1, 2))
    assert (y - want).abs().max() <= TOL_F64 * want.abs().max()


@pytest.mark.parametrize("shape", [(8, 8), (6, 9), (64, 32), (32, 128)])
def test_filter_is_phase_only_and_hermitian(shape):
    n0, n1 = shape
    h = pf.filter_half(shape)
    assert h.shape == (n0, n1 // 2 + 1) and h.dtype == torch.complex128
    assert (h.abs() - 1).abs().max() <= 1e-15
    neg = (-torch.arange(n0)) % n0
    # columns 0 and n/2 are their own mirrors: Hermitian down the column
    cols = [0] + ([n1 // 2] if n1 % 2 == 0 else [])
    for c in cols:
        assert torch.equal(h[:, c], h[neg, c].conj())
    full = pf.hermitian_extend(h, n1)
    assert full.shape == shape
    assert torch.equal(full, pf._flip(full, (0, 1)).conj())
    assert torch.equal(pf.filter_half(shape), h)     # the same every time
