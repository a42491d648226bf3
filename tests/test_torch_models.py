"""The port's pseudo-spectral 2-D Navier-Stokes step
(``fftw3_tpu_torch/models/navier_stokes.py``) on the CPU: against the
plain float64 reference the benchmark uses
(``bench_torch/references/navier_stokes.py``) on white-noise fields,
against the JAX package's ``step_fn`` on the same input, the Taylor-Green
vortex's analytic decay, the stacked inverse transform against four
separate ones, the plans drawn from the functional cache, and the
distributed step's refusal.  The kernel solvers' twins are offered, as on
the card the kernels run.
"""
import math

import jax
import numpy as np
import pytest
import torch

import fftw3_tpu_torch as ft
from bench_torch.references import navier_stokes as ref
from fftw3_tpu import models as jax_models
from fftw3_tpu.models import navier_stokes as jax_ns
from fftw3_tpu_torch import api, config, models
from fftw3_tpu_torch.models import navier_stokes as ns

#: max |y - ref| / max |ref| the port's step may reach against float64:
#: the port holds float32 transforms within about 1e-5 of float64
#: (PERF.md § 2), and a step is 12 of them and the algebra between; its
#: readings here are 4.8e-7 to 9.1e-7.  The control (every transform's
#: output rounded to bfloat16) reads about 3.7e-3, so it fails.
TOL = 1e-5
#: the port against the JAX package's step on the same float32 input:
#: both are float32 transforms, each within TOL of float64 (the JAX step
#: under the tests' x64 promotes its derivative spectra to complex128);
#: readings 6.0e-7 and 7.7e-7
TOL_JAX = 2 * TOL


@pytest.fixture
def cpu_plans(monkeypatch):
    """Plans on the CPU, the kernel solvers' twins offered, the planner's
    own choices, an empty functional cache."""
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(ft.the_planner, "wisdom", {})
    api._cached_plan.cache_clear()
    yield
    api._cached_plan.cache_clear()


def _field(shape, seed):
    """White-noise vorticity, uniform in [-0.5, 0.5), as the cell draws."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) - 0.5


def _constants(nx):
    """(nu, dt) by the cell's rule at a width of nx: CFL 0.5 at max |u| =
    0.1, the viscous factor halving the last mode the 2/3 rule keeps."""
    dt = 0.5 * (2 * math.pi / nx) / 0.1
    return math.log(2) / ((nx // 3) ** 2 * dt), dt


def _err(y, want):
    y, want = np.asarray(y, np.float64), np.asarray(want, np.float64)
    return np.abs(y - want).max() / np.abs(want).max()


def _step_plans(batch, ny, nx):
    """The three plans a step on (*batch, ny, nx) draws from the cache:
    the r2c, the c2r of the four stacked spectra, the last c2r."""
    real = torch.zeros(()).expand(*batch, ny, nx)
    half = torch.zeros((), dtype=torch.complex64).expand(*batch, ny,
                                                          nx // 2 + 1)
    stacked = half.expand(4, *half.shape)
    return (api._plan_for("r2c", real, (-2, -1), ft.FORWARD, "float32"),
            api._plan_for("c2r", stacked, (-2, -1), ft.BACKWARD, "float32",
                          shape=(4, *batch, ny, nx)),
            api._plan_for("c2r", half, (-2, -1), ft.BACKWARD, "float32",
                          shape=(*batch, ny, nx)))


@pytest.mark.parametrize("shape, algs", [
    ((2, 64, 64), None),
    ((3, 64, 128), None),
    # K4, K2 over the odd-width half spectrum and K6, as on the card
    ((2, 128, 1024), {"pallas_r2c", "pallas", "pallas_c2r"}),
])
def test_step_matches_the_reference(cpu_plans, shape, algs):
    ny, nx = shape[1:]
    nu, dt = _constants(nx)
    w = _field(shape, seed=sum(shape))
    y = models.navier_stokes_step(ny, nx, nu, dt)(w)
    want = ref.step(w.double(), nu, dt)
    assert y.dtype == torch.float32 and y.shape == w.shape
    assert _err(y, want) <= TOL
    assert _err(ref.control_step(w, nu, dt), want) > 10 * TOL
    # the advection is a large share of the step: leaving it out fails
    e = ref.operators(ny, nx, nu, dt, "cpu")[-1]
    viscous = torch.fft.irfft2(torch.fft.rfft2(w.double()) * e, s=(ny, nx))
    assert _err(viscous, want) > 100 * TOL
    if algs is not None:
        used = {d["alg"] for p in _step_plans(shape[:1], ny, nx)
                for d in p.descriptors.values()}
        assert used == algs


@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 64, 128)])
def test_step_matches_the_jax_step(cpu_plans, shape):
    ny, nx = shape[1:]
    nu, dt = _constants(nx)
    w = _field(shape, seed=7 + sum(shape))
    y = models.navier_stokes_step(ny, nx, nu, dt)(w)
    want = jax.jit(jax_models.navier_stokes_step(ny, nx, nu, dt))(
        w.numpy())
    assert _err(y, want) <= TOL_JAX


def test_operators_are_the_jax_packages():
    for ny, nx in [(64, 64), (48, 96), (30, 45)]:
        for mine, theirs in zip(ns._spectral_operators(ny, nx),
                                jax_ns._spectral_operators(ny, nx)):
            assert mine.dtype == theirs.dtype == np.float32
            assert np.array_equal(mine, theirs)
    kx = ns._spectral_operators(64, 64)[0]
    assert kx[0, -1] == -32                 # fftfreq's last entry, -nx/2


def test_taylor_green_decay(cpu_plans):
    """The nonlinear term vanishes exactly for this flow, so it decays as
    exp(-2 nu kappa^2 t), within the JAX package's own test's 2e-3."""
    ny = nx = 64
    nu, dt, kappa, steps = 0.05, 0.01, 2, 50
    step = models.navier_stokes_step(ny, nx, nu, dt)
    w0 = models.taylor_green_vorticity(ny, nx, kappa=kappa)
    assert np.array_equal(w0, jax_models.taylor_green_vorticity(ny, nx, 2))
    w = torch.from_numpy(w0)
    for _ in range(steps):
        w = step(w)
    expect = w0 * np.exp(-2.0 * nu * kappa ** 2 * steps * dt)
    assert _err(w, expect) < 2e-3


@pytest.mark.parametrize("shape", [(2, 64, 33), (3, 64, 65),
                                   (2, 128, 513)])
def test_stacked_inverse_is_four_inverses(cpu_plans, shape):
    """One irfftn of the four stacked spectra gives what four calls give,
    bit for bit."""
    ny, nx = shape[1], 2 * (shape[2] - 1)
    g = torch.Generator().manual_seed(sum(shape))
    S = torch.randn((4, *shape), generator=g, dtype=torch.complex64)
    one = ft.irfftn(S, s=(ny, nx), axes=(-2, -1))
    four = torch.stack([ft.irfftn(S[i], s=(ny, nx), axes=(-2, -1))
                        for i in range(4)])
    assert one.shape == (4, shape[0], ny, nx)
    assert torch.equal(one, four)


def test_plans_come_from_the_functional_cache(cpu_plans, monkeypatch):
    """A step plans three transforms once (at its first call) and then
    draws each from the cache: six plan calls a step; the operators are
    built once."""
    built = []
    operators = ns._operators
    monkeypatch.setattr(ns, "_operators",
                        lambda *a: built.append(a) or operators(*a))
    step = models.navier_stokes_step(32, 64, *_constants(64))
    w = _field((2, 32, 64), seed=3)
    assert built == []
    step(w)
    first = api._cached_plan.cache_info()
    assert (first.misses, first.hits) == (3, 3)
    for _ in range(2):
        w = step(w)
    info = api._cached_plan.cache_info()
    assert (info.misses, info.hits) == (3, 3 + 2 * 6)
    assert len(built) == 1 and built[0][-1] == torch.device("cpu")
    before = api._cached_plan.cache_info()
    _step_plans((2,), 32, 64)
    assert api._cached_plan.cache_info().misses == before.misses


@pytest.mark.parametrize("batch", [(), (2, 3)])
def test_leading_dims_broadcast(cpu_plans, monkeypatch, batch):
    """A step over leading batch dims steps each field as it would alone;
    the operators are built once, at the first call, on its device."""
    built = []
    operators = ns._operators
    monkeypatch.setattr(ns, "_operators",
                        lambda *a: built.append(a) or operators(*a))
    step = models.navier_stokes_step(32, 32, *_constants(32))
    w = _field((*batch, 32, 32), seed=4 + len(batch))
    y = step(w)
    alone = [step(f) for f in w.reshape(-1, 32, 32)]
    assert y.shape == w.shape
    assert len(built) == 1 and built[0][-1] == torch.device("cpu")
    for got, want in zip(y.reshape(-1, 32, 32), alone):
        assert _err(got, want) <= 1e-6


def test_exports_match_the_jax_package():
    assert models.navier_stokes_step is ns.step_fn
    assert models.taylor_green_vorticity is ns.taylor_green_vorticity
    assert models.distributed_step_fn is ns.distributed_step_fn
    for name in ("navier_stokes_step", "taylor_green_vorticity",
                 "distributed_step_fn"):
        assert hasattr(jax_models, name)


def test_distributed_step_raises():
    with pytest.raises(NotImplementedError, match="distributed tier"):
        models.distributed_step_fn(32, 32, 0.01, 0.01, mesh=None)
