"""The Neumann Poisson cell's files on the CPU at a tiny size: a real r2r
problem through the ``neumann_solve`` entry (the port's solve on the
functional API's r2r plans) is ``correct`` for the port, and not for the
control, for any fault planted in the solve's last DCT-III, or for the
solve with one axis's eigenvalues left out; the reference against
scipy's DCTs in float64; the configuration's numbers; the work that
``gflops`` counts."""
import json
import math
import shutil

import numpy as np
import pytest
import torch

from bench_torch import core, faults, problem
from bench_torch.entries import neumann_solve
from bench_torch.references import neumann_poisson as ref
from bench_torch.work import transform

REAL = "neumann512x512x512-v1.solve"
TINY = "t.neumann"
TINY_PROBLEM = "k16e10x12e10x8e10"
NEW = ("neumann.launches_per_solve",)


@pytest.fixture
def neumann_bench(tmp_path):
    """The real benchmark's data files with a tiny r2r configuration and a
    ``neumann_solve`` mix of two grids a call beside them, held to the real
    cell's limit."""
    real = core.load()
    data = tmp_path / core.HERE.name
    for sub in ("metrics", "kernels", "peaks"):
        shutil.copytree(real.data / sub, data / sub)
    for sub in ("configs", "traffic", "limits"):
        (data / sub).mkdir()
    (data / "configs" / "n16.json").write_text(json.dumps(
        {"name": "n16", "problem": TINY_PROBLEM, "dtype": "float32",
         "reference": "neumann_poisson"}))
    (data / "traffic" / "v2-solve.json").write_text(json.dumps(
        {"batch": 2, "entry": "neumann_solve", "loop": "stream",
         "flags": "estimate", "inputs": 2, "warmup_calls": 2,
         "checked_calls": 2, "trace_seconds": 0.1}))
    shutil.copy(real.data / "limits" / f"{REAL}.json",
                data / "limits" / f"{TINY}.json")
    spec = json.loads(json.dumps(real.spec))
    spec["configs"].append({"name": "n16", "source": "test",
                            "file": f"{data.name}/configs/n16.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": TINY, "config": "n16",
                              "traffic": "v2-solve", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(TINY)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return core.load(tmp_path)


def run(bench, traced=False, **kw):
    return core.run_cell(bench, TINY, 2 ** 33 + 11, 0.3, traced, "cpu",
                         log=lambda *_: None, **kw)


def drop_axis_eigenvalues(plan):
    """A physics fault for ``core.run_cell``'s hook: the solve divides by
    eigenvalues that leave out the first solved axis's, the zero divisors
    that leaves on that axis's modes set to 1 as the mean mode's is, so
    the output stays finite and wrong by the operator alone."""
    import fftw3_tpu_torch as ft
    from fftw3_tpu_torch.models import poisson
    spacing = plan.spacing

    def solve(f):
        nd = len(spacing)
        axes = range(f.dim() - nd, f.dim())
        shape = tuple(f.shape[-nd:])
        U = f
        for a in axes:
            U = ft.dct(U, type=2, axis=a)
        e0 = torch.from_numpy(poisson._eig_neumann(shape[0], spacing[0]))
        lam = poisson._divisor("neumann", shape, tuple(spacing), U.dtype,
                               U.device) \
            - e0.to(U).reshape((-1,) + (1,) * (nd - 1))
        U = U / torch.where(lam == 0, 1.0, lam)
        U[(...,) + (0,) * nd] = 0.0
        for a in axes:
            U = ft.dct(U, type=3, axis=a)
        return U / math.prod(2.0 * n for n in shape)
    plan.solve = solve


@pytest.mark.parametrize("traced", [False, True])
def test_port_is_correct(neumann_bench, cpu_port, traced):
    line = run(neumann_bench, traced)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in neumann_bench.metrics(
        neumann_bench.cell(TINY), traced)}
    assert set(NEW) <= want if traced else not set(NEW) & want
    # on the CPU the solve runs, under the span, no kernel of the port's
    assert set(line["metrics"]) == want
    if traced:
        assert line["metrics"]["neumann.launches_per_solve"]["value"] == 0.0
    check = line["checks"]["max_err"]
    assert check["value"] < check["limit"] / 10
    json.dumps(line, allow_nan=False)


def test_control_fails(neumann_bench, cpu_port):
    line = run(neumann_bench, system="control")
    assert line["correct"] is False
    assert line["checks"]["max_err"]["value"] > 10 * \
        line["checks"]["max_err"]["limit"]


@pytest.mark.parametrize("fault", faults.applicable(
    problem.parse(TINY_PROBLEM).with_batch(2)))
def test_fault_fails(neumann_bench, cpu_port, fault):
    """Each fault, planted in the DCT-III plan that the solve runs last,
    changes the output the comparison sees."""
    line = run(neumann_bench, hook=faults.hook(fault))
    assert line["correct"] is False


def test_solve_without_one_axis_eigenvalues_fails(neumann_bench, cpu_port):
    line = run(neumann_bench, hook=drop_axis_eigenvalues)
    assert line["correct"] is False
    value = line["checks"]["max_err"]["value"]
    assert value is not None and value > 100 * \
        line["checks"]["max_err"]["limit"]


def test_entry_at_a_tiny_size(cpu_port):
    """The entry's plan is the solve with the spacing 1/n, its ``_plan``
    the functional cache's DCT-III plan along the last axis, which the
    solve then draws; args and output as the harness takes them."""
    prob = problem.parse(TINY_PROBLEM).with_batch(2)
    solving = neumann_solve.plan(cpu_port, prob, "float32", cpu_port.ESTIMATE,
                                 torch.device("cpu"))
    assert solving.spacing == (1 / 16, 1 / 12, 1 / 8)
    assert solving._plan.problem.r2r_kinds == (cpu_port.Kind.REDFT01,)
    assert solving._plan.problem.axes == (3,)
    g = torch.Generator().manual_seed(5)
    x = torch.view_as_complex(torch.rand(*prob.shape, 2, generator=g) - 0.5)
    (f,) = neumann_solve.args(x)
    assert f.dtype == torch.float32 and f.is_contiguous()
    assert torch.equal(f, x.real)
    before = cpu_port.api._cached_plan.cache_info()
    y = neumann_solve.output(neumann_solve.bind(cpu_port, solving)(f))
    after = cpu_port.api._cached_plan.cache_info()
    assert after.misses - before.misses == 5     # the last one was planned
    want = ref.reference(x, prob.axes, prob.sign)
    assert y.shape == want.shape
    assert (y.double() - want).abs().max() <= 1e-5 * want.abs().max()
    with pytest.raises(ValueError):
        neumann_solve.plan(cpu_port, problem.parse("rf16x16"), "float32",
                           cpu_port.ESTIMATE, torch.device("cpu"))


@pytest.mark.parametrize("shape, axes", [((16,), (0,)), ((12, 9), (0, 1)),
                                         ((8, 12, 16), (0, 1, 2)),
                                         ((2, 9, 15, 16), (1, 2, 3))])
def test_reference_is_scipys_dcts(shape, axes):
    """The dense products by the definition agree with scipy's DCT-II and
    inverse DCT-II in float64 (idct of type 2 is the DCT-III over 2n)."""
    sfft = pytest.importorskip("scipy.fft")
    g = torch.Generator().manual_seed(sum(shape))
    f = torch.rand(shape, generator=g, dtype=torch.float64) - 0.5
    y = ref.solve(f, axes)
    sizes = [shape[a] for a in axes]
    U = sfft.dctn(f.numpy(), type=2, axes=axes)
    U = U / ref.eigenvalues(sizes, [1.0 / n for n in sizes]).numpy()
    U[(...,) + (0,) * len(axes)] = 0.0
    want = sfft.idctn(U, type=2, axes=axes)
    assert y.dtype == torch.float64 and y.shape == f.shape
    assert np.abs(y.numpy() - want).max() <= 1e-13 * np.abs(want).max()


def test_configuration_states_its_problem():
    cfg = core.load().config("neumann512x512x512")
    prob = problem.parse(cfg["problem"])
    assert prob.kind == "r2r" and prob.sizes == (512, 512, 512)
    assert prob.r2r == ("e10",) * 3 and cfg["dtype"] == "float32"
    assumed = {a["name"]: a["value"] for a in cfg["assumed"]}
    assert assumed == {"grid": 512, "spacing": 1 / 512,
                       "rhs_half_width": 0.5, "grids": 1}
    assert prob.sizes == (assumed["grid"],) * 3
    mix = core.load().file("traffic", "v1-solve")
    assert (mix["batch"], mix["entry"], mix["inputs"]) == (
        1, "neumann_solve", 2)
    # the limit lies between the port's readings and the control's
    lim = core.load().file("limits", REAL)["max_err"]
    if "lower" in lim:
        assert 20 * lim["lower"] <= lim["limit"] < lim["upper"]


CELL = problem.parse("k512e10x512e10x512e10")


def test_solve_transforms_work():
    """``gflops`` counts the forward 3-D DCT-II of 512^3: 2.5 N log2 N with
    FFTW's logical N = 1024^3 (8.05e10 flops), 4 B a point read and
    written (1.07e9 B)."""
    flops, nbytes = transform.work(CELL, "float32")
    assert flops == 2.5 * 1024 ** 3 * 30 == pytest.approx(8.05e10, rel=1e-3)
    assert nbytes == 8 * 512 ** 3 == pytest.approx(1.07e9, rel=1e-2)
