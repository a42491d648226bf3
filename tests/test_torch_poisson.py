"""The port's Poisson solvers (``fftw3_tpu_torch/models/poisson.py``) on
the CPU: ``solve_neumann`` against the plain float64 reference the
benchmark uses (``bench_torch/references/neumann_poisson.py``) on
white-noise fields, on ESTIMATE's route and on the DCT reductions pinned
(the card's route, ``redft10_half`` / ``redft01_half``), along the first
axis as well as the last; each of the four solvers against the JAX
package's on the same input; the Neumann stencil's residual; the
eigenvalues kept by ``solve_neumann_fn`` and the plans drawn from the
functional cache; leading batch dims; the control and a wrong operator
failing.  The kernel solvers' twins are offered, as on the card the
kernels run.
"""
import types

import numpy as np
import pytest
import torch

import fftw3_tpu_torch as ft
from bench_torch.references import neumann_poisson as ref
from fftw3_tpu import models as jax_models
from fftw3_tpu_torch import api, config, models, planner
from fftw3_tpu_torch.models import poisson

#: max |u - ref| / max |ref| the port's float32 solve may reach against
#: float64: the port holds float32 transforms within about 1e-5 of float64
#: (PERF.md § 2) and a solve is six r2r passes and a division, whose
#: readings here are 1.6e-7 to 7.2e-7.  The control (the solve in float32,
#: each pass's output rounded to bfloat16) reads 2.3e-3 to 5.1e-3, so it
#: fails by more than 200 times.
TOL = 1e-5
#: the port against the JAX package's solvers on the same float32 input:
#: both run float32 transforms, each within TOL of float64 (the JAX
#: Neumann and Dirichlet solves return float64 under the tests' x64, their
#: scale a float64 scalar); readings 1.9e-7 to 4.6e-7, the stencil 0
TOL_JAX = 2 * TOL
#: the stencil's residual against f - mean(f), over max |f|, in float64:
#: the solve inverts the stencil exactly, so what is left is float64
#: rounding times the stencil's gain 4 nd / h^2 (at most 1.2e3 here);
#: readings 2.0e-15 to 3.7e-13.  FFTW's double-precision tolerance.
TOL_RESIDUAL = 1e-10

#: the r2r descriptor algs a solve's plans use on each route: ESTIMATE on
#: the CPU takes the dense kind matrix below n = 512 and the DCT
#: reductions at 512 (the card's route); "half" pins the reductions
ROUTES = {"estimate": None, "half": {"redft10_half", "redft01_half"}}


@pytest.fixture
def cpu_plans(monkeypatch):
    """Plans on the CPU, the kernel solvers' twins offered, the planner's
    own choices, an empty functional cache."""
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(ft.the_planner, "wisdom", {})
    api._cached_plan.cache_clear()
    yield monkeypatch
    api._cached_plan.cache_clear()


def _route(monkeypatch, route):
    """Pin the DCT reductions: without the dense kind matrix (and the
    real children's dense form) among the candidates, ESTIMATE takes
    ``redft10_half`` and ``redft01_half`` at every n."""
    if route == "half":
        monkeypatch.setattr(planner, "R2R_GENERIC_MAX", 0)


def _field(shape, seed, dtype=torch.float32):
    """A right-hand side as the cell draws it: uniform in [-0.5, 0.5),
    its mean not removed."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g, dtype=torch.float64)
            - 0.5).to(dtype)


def _err(y, want):
    y, want = np.asarray(y, np.float64), np.asarray(want, np.float64)
    return np.abs(y - want).max() / np.abs(want).max()


def _solve_plans(shape, dtype="float32"):
    """The six plans a Neumann solve over every axis of `shape` draws from
    the functional cache: a DCT-II along each axis, then a DCT-III."""
    field = torch.zeros((), dtype=getattr(torch, dtype)).expand(shape)
    return [api._plan_for("r2r", field, (a,), ft.FORWARD, dtype,
                          (kind.value,))
            for kind in (ft.Kind.REDFT10, ft.Kind.REDFT01)
            for a in range(len(shape))]


def _algs(shape):
    return {d["alg"] for p in _solve_plans(shape)
            for d in p.descriptors.values()}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("shape", [(16,), (12, 9), (8, 12, 16),
                                   (9, 15, 16)])
def test_neumann_matches_the_reference(cpu_plans, shape, route):
    _route(cpu_plans, route)
    f = _field(shape, seed=sum(shape))
    spacing = [1.0 / n for n in shape]
    u = models.solve_neumann(f, spacing)
    want = ref.solve(f.double(), tuple(range(len(shape))), spacing)
    assert u.dtype == torch.float32 and u.shape == f.shape
    assert _err(u, want) <= TOL
    assert _algs(shape) == (ROUTES[route] or {"r2r_matmul"})


@pytest.mark.parametrize("shape", [(512, 4, 4), (4, 4, 512)])
def test_neumann_on_the_cards_route(cpu_plans, shape):
    """At n = 512 ESTIMATE itself takes the reductions the card runs, on
    axis 0 (behind a ``movedim`` and a strided gather) as on the last."""
    f = _field(shape, seed=sum(shape) + 1)
    u = models.solve_neumann(f)
    want = ref.solve(f.double(), (0, 1, 2), [1.0] * 3)
    assert _err(u, want) <= TOL
    long = shape.index(512)
    for p in _solve_plans(shape):
        (axis,) = p.problem.axes
        alg = p.descriptors[axis]["alg"]
        if axis == long:
            assert alg in ROUTES["half"]
            assert p.descriptors[axis]["child"]["alg"] in ("r2c_pack",
                                                           "c2r_pack")
        else:
            assert alg == "r2r_matmul"


@pytest.mark.parametrize("name", ["solve_neumann", "solve_periodic",
                                  "solve_dirichlet", "laplacian_periodic"])
@pytest.mark.parametrize("shape, spacing", [((8, 12, 16), None),
                                            ((12, 10), (0.1, 0.2)),
                                            ((9, 15, 16), (0.1, 0.2, 0.3))])
def test_matches_the_jax_package(cpu_plans, name, shape, spacing):
    f = _field(shape, seed=3 + sum(shape))
    u = getattr(models, name)(f, spacing)
    want = getattr(jax_models, name)(f.numpy(), spacing)
    assert u.dtype == torch.float32 and tuple(u.shape) == want.shape
    assert _err(u, want) <= TOL_JAX


def _neumann_stencil(u, spacing):
    """The 7-point (in 3-D) second-order Laplacian with homogeneous Neumann
    boundaries on a cell-centred grid: each ghost cell mirrors the cell
    inside it, u[-1] = u[0] and u[n] = u[n - 1]."""
    out = torch.zeros_like(u)
    for a, h in enumerate(spacing):
        n = u.shape[a]
        below = torch.cat([u.narrow(a, 0, 1), u.narrow(a, 0, n - 1)], a)
        above = torch.cat([u.narrow(a, 1, n - 1), u.narrow(a, n - 1, 1)], a)
        out = out + (below - 2 * u + above) / h ** 2
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("shape", [(16,), (12, 9), (8, 12, 16),
                                   (9, 15, 16)])
def test_neumann_stencil_of_the_solution_is_the_rhs(cpu_plans, shape,
                                                     route):
    """The solve is the exact inverse of the stencil on the mean-free
    fields: the stencil applied to u gives f - mean(f)."""
    _route(cpu_plans, route)
    f = _field(shape, seed=11 + sum(shape), dtype=torch.float64)
    spacing = [1.0 / n for n in shape]
    u = models.solve_neumann(f, spacing)
    assert u.dtype == torch.float64
    residual = _neumann_stencil(u, spacing) - (f - f.mean())
    assert residual.abs().max() <= TOL_RESIDUAL * f.abs().max()
    assert abs(u.mean()) <= TOL_RESIDUAL * u.abs().max()


def test_eigenvalues_built_once_and_plans_cached(cpu_plans, monkeypatch):
    """A solve from ``solve_neumann_fn`` builds its eigenvalues at its
    first call and keeps them; ``solve_neumann`` builds them at every
    call, as the source does.  Both plan the six r2r transforms once: each
    later solve draws all six from the cache."""
    built = []
    divisor = poisson._divisor

    def counted(*args):
        built.append(args[1:3])
        return divisor(*args)
    monkeypatch.setattr(poisson, "_divisor", counted)
    f = _field((8, 12, 16), seed=2)
    solve = models.solve_neumann_fn()
    assert built == []
    u = solve(f)
    assert built == [((8, 12, 16), (1.0, 1.0, 1.0))]
    first = api._cached_plan.cache_info()
    assert (first.misses, first.hits) == (6, 0)
    for _ in range(2):
        assert torch.equal(solve(f), u)
    info = api._cached_plan.cache_info()
    assert (info.misses, info.hits) == (6, 2 * 6)
    assert len(built) == 1
    before = api._cached_plan.cache_info()
    _solve_plans((8, 12, 16))
    assert api._cached_plan.cache_info().misses == before.misses
    # the functional solve: the same answer, its eigenvalues anew
    assert torch.equal(models.solve_neumann(f), u)
    assert len(built) == 2
    # a spacing of its own
    half = models.solve_neumann_fn((0.5, 0.5, 0.5))
    assert torch.equal(half(f), models.solve_neumann(f, (0.5, 0.5, 0.5)))
    assert built[2:] == [((8, 12, 16), (0.5, 0.5, 0.5))] * 2
    lam = divisor("neumann", (8, 12, 16), (1.0, 1.0, 1.0), torch.float32,
                  torch.device("cpu"))
    assert lam.dtype == torch.float32 and lam[0, 0, 0] == 1.0


@pytest.mark.parametrize("name", ["solve_neumann", "solve_periodic",
                                  "solve_dirichlet"])
@pytest.mark.parametrize("batch", [(2,), (2, 3)])
def test_leading_dims_broadcast(cpu_plans, name, batch):
    """With a spacing of the grid's rank, the leading dims are a batch:
    each field is solved as it would be alone."""
    grid = (8, 12, 16)
    spacing = [1.0 / n for n in grid]
    f = _field((*batch, *grid), seed=4 + len(batch))
    u = getattr(models, name)(f, spacing)
    assert u.shape == f.shape
    for got, field in zip(u.reshape(-1, *grid), f.reshape(-1, *grid)):
        assert _err(got, getattr(models, name)(field, spacing)) <= 1e-6


def test_spacing_names_no_more_axes_than_the_field(cpu_plans):
    with pytest.raises(ValueError, match="spacing names 3 axes"):
        models.solve_neumann(torch.zeros(8, 8), (1.0, 1.0, 1.0))


def test_control_and_a_wrong_operator_fail(cpu_plans):
    """The control and the solve with one axis's eigenvalues left out each
    fail the tolerance by far: it catches a lower precision and a wrong
    operator."""
    from bench_torch.tests.test_neumann import drop_axis_eigenvalues
    shape = (8, 12, 16)
    spacing = tuple(1.0 / n for n in shape)
    f = _field(shape, seed=9)
    want = ref.solve(f.double(), (0, 1, 2), spacing)
    assert _err(ref.solve(f, (0, 1, 2), spacing, rounding=ref._bf16),
                want) > 100 * TOL

    faulty = types.SimpleNamespace(spacing=spacing)
    drop_axis_eigenvalues(faulty)
    assert _err(faulty.solve(f), want) > 1e4 * TOL


def test_exports_match_the_jax_package():
    for name in ("solve_neumann", "solve_periodic", "solve_dirichlet",
                 "laplacian_periodic"):
        assert getattr(models, name) is getattr(poisson, name)
        assert hasattr(jax_models, name)
    assert models.solve_neumann_fn is poisson.solve_neumann_fn
