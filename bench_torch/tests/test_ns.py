"""The Navier-Stokes cell's files on the CPU at a tiny size: a real problem
through the ``ns_step`` entry (one RK2 step of the port's model on the
functional API's plans) is ``correct`` for the port, and not for the
control, for any fault planted in the step's last c2r, or for the step
with its advection left out; the reference against a full-spectrum
float64 DFT of the same step, which pins the inverse transforms' DC and
Nyquist columns; the configuration's numbers; the work of the step's
transforms and of its K2 passes."""
import json
import math
import shutil

import pytest
import torch

from bench_torch import core, faults, problem
from bench_torch.references import dft_c2c
from bench_torch.references import navier_stokes as ns
from bench_torch.work import conv_k2, ns_k2, ns_transforms, transform

REAL = "ns2048x2048-v16.rk2"
TINY = "t.ns"
NEW = ("ns.transforms_roofline", "ns.spectral_ms", "ns.launches_per_step",
       "ns.k2_roofline")


@pytest.fixture
def ns_bench(tmp_path):
    """The real benchmark's data files with a tiny real configuration and
    its ``ns_step`` mix beside them, held to the real cell's limit."""
    real = core.load()
    data = tmp_path / core.HERE.name
    for sub in ("metrics", "kernels", "peaks"):
        shutil.copytree(real.data / sub, data / sub)
    for sub in ("configs", "traffic", "limits"):
        (data / sub).mkdir()
    (data / "configs" / "ns32x64.json").write_text(json.dumps(
        {"name": "ns32x64", "problem": "rf32x64", "dtype": "float32",
         "reference": "navier_stokes"}))
    (data / "traffic" / "v2-rk2.json").write_text(json.dumps(
        {"batch": 2, "entry": "ns_step", "loop": "stream",
         "flags": "estimate", "inputs": 2, "warmup_calls": 2,
         "checked_calls": 2, "trace_seconds": 0.1}))
    shutil.copy(real.data / "limits" / f"{REAL}.json",
                data / "limits" / f"{TINY}.json")
    spec = json.loads(json.dumps(real.spec))
    spec["configs"].append({"name": "ns32x64", "source": "test",
                            "file": f"{data.name}/configs/ns32x64.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": TINY, "config": "ns32x64",
                              "traffic": "v2-rk2", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(TINY)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return core.load(tmp_path)


def run(bench, traced=False, **kw):
    return core.run_cell(bench, TINY, 2 ** 33 + 7, 0.3, traced, "cpu",
                         log=lambda *_: None, **kw)


@pytest.mark.parametrize("traced", [False, True])
def test_port_is_correct(ns_bench, cpu_port, traced):
    line = run(ns_bench, traced)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in ns_bench.metrics(ns_bench.cell(TINY), traced)}
    assert set(NEW) <= want if traced else not set(NEW) & want
    # on the CPU: no peaks for the rooflines; the twins launch no kernel,
    # so the device time outside the port's kernels and the launches a
    # step are both 0
    assert set(line["metrics"]) == want - {"ns.transforms_roofline",
                                           "ns.k2_roofline"}
    if traced:
        assert line["metrics"]["ns.launches_per_step"]["value"] == 0.0
        assert line["metrics"]["ns.spectral_ms"]["value"] == 0.0
    check = line["checks"]["max_err"]
    assert check["value"] < check["limit"] / 10
    json.dumps(line, allow_nan=False)


def test_control_fails(ns_bench, cpu_port):
    line = run(ns_bench, system="control")
    assert line["correct"] is False
    assert line["checks"]["max_err"]["value"] > 10 * \
        line["checks"]["max_err"]["limit"]


@pytest.mark.parametrize("fault", faults.applicable(
    problem.parse("rf32x64").with_batch(2)))
def test_fault_fails(ns_bench, cpu_port, fault):
    """Each fault, planted in the c2r plan that the step runs last, changes
    the output the comparison sees."""
    line = run(ns_bench, hook=faults.hook(fault))
    assert line["correct"] is False


def test_step_without_advection_fails(ns_bench, cpu_port):
    """The step with its nonlinear term zeroed (the viscous factor alone)
    fails by far more than the limit."""
    def linear(plan):
        def step(w):
            ny, nx = w.shape[-2:]
            e = ns.operators(ny, nx, ns.NU, ns.DT, w.device,
                             torch.float32)[-1]
            return cpu_port.irfftn(cpu_port.rfftn(w, axes=(-2, -1)) * e,
                                   s=(ny, nx), axes=(-2, -1))
        plan.step = step
    line = run(ns_bench, hook=linear)
    assert line["correct"] is False
    assert line["checks"]["max_err"]["value"] > 100 * \
        line["checks"]["max_err"]["limit"]


def _full_rfft2(x):
    """The 2-D DFT of x by the definition, cut to the half spectrum."""
    X = dft_c2c.reference(x.to(torch.complex128), (-2, -1), -1)
    return X[..., : x.shape[-1] // 2 + 1]


def _full_irfft2(X, ny, nx):
    """The real part of the unnormalised inverse DFT, by the definition, of
    the full spectrum whose columns 0 .. nx // 2 are X and whose others
    are conj(X[-ky, nx - kx]), over N: an inverse real transform that
    reads only the real part of the DC and Nyquist columns' axis -2
    transform."""
    tail = X[..., 1:nx - nx // 2].flip(-1)
    tail = torch.roll(tail.flip(-2), 1, -2).conj()
    full = torch.cat([X, tail], -1)
    return dft_c2c.reference(full, (-2, -1), 1).real / (ny * nx)


@pytest.mark.parametrize("shape", [(2, 8, 12), (3, 6, 10), (1, 8, 9)])
def test_reference_is_the_step_by_the_definition(shape):
    g = torch.Generator().manual_seed(sum(shape))
    w = torch.rand(shape, generator=g, dtype=torch.float64) - 0.5
    nu, dt = 0.01, 1.0
    ref = ns.step(w, nu, dt)
    direct = ns.step(w, nu, dt, rfft2=_full_rfft2, irfft2=_full_irfft2)
    assert ref.dtype == torch.float64 and ref.shape == w.shape
    assert (ref - direct).abs().max() <= 1e-12 * direct.abs().max()
    # the step is not the viscous factor alone: the advection shows
    e = ns.operators(*shape[1:], nu, dt, "cpu")[-1]
    viscous = torch.fft.irfft2(torch.fft.rfft2(w) * e, s=shape[1:])
    assert (ref - viscous).abs().max() > 1e-2 * ref.abs().max()


def test_the_derivative_spectra_are_not_hermitian_at_the_edges():
    """i ky W has a Nyquist row that is its own mirror: purely imaginary
    in the DC column, so the step's inverse transforms read those columns
    by their real part alone, which the check by the definition pins."""
    w = torch.rand(1, 8, 8, dtype=torch.float64) - 0.5
    W = torch.fft.rfft2(w)
    ky = torch.fft.fftfreq(8, 1 / 8, dtype=torch.float64)[:, None]
    D = 1j * ky * W
    assert D[0, 4, 0].real == 0 and D[0, 4, 0].imag != 0
    y = ns._irfft2(D, 8, 8)
    assert torch.allclose(y, _full_irfft2(D, 8, 8), rtol=0, atol=1e-15)


def test_configuration_states_the_constants():
    cfg = core.load().config("ns2048x2048")
    assumed = {a["name"]: a["value"] for a in cfg["assumed"]}
    assert assumed["fields"] == 16 and assumed["initial_half_width"] == 0.5
    assert assumed["dt"] == ns.DT and assumed["nu"] == ns.NU
    assert ns.NU == math.log(2) / (682 ** 2 * ns.DT)
    # the integrating factor halves the 2/3 rule's last mode in one step
    kx, ky, _, dealias, e = ns.operators(2048, 2048, ns.NU, ns.DT, "cpu")
    assert 2048 // 3 == 682 and dealias[0, 682] == 1 and dealias[0, 683] == 0
    assert e[0, 682].item() == pytest.approx(0.5, rel=1e-12)
    assert kx[0, -1] == -1024


CELL = problem.parse("rf2048x2048").with_batch(16)


def test_step_transforms_work():
    """12 real 2-D transforms of 16 fields: each reads 4 B a real point and
    writes 8 B a half-spectrum point (or the reverse), 2.5 N log2 N flops
    a field of N = 2048^2."""
    flops, nbytes = ns_transforms.work(CELL, "float32")
    points, half = 16 * 2048 * 2048, 16 * 2048 * 1025
    assert flops == 12 * 2.5 * points * 22
    assert nbytes == 12 * (4 * points + 8 * half)
    assert (flops, nbytes) == tuple(12 * v for v in
                                    transform.work(CELL, "float32"))
    with pytest.raises(ValueError):
        ns_transforms.work(problem.parse("cf1024").with_batch(4),
                           "complex64")


def test_step_k2_work():
    """12 K2 passes over the (16, 2048, 1025) half spectrum, 16 B a point
    each (two real planes read and written) and 5 log2 2048 flops a point:
    six times conv's two passes."""
    flops, nbytes = ns_k2.work(CELL, "float32")
    half = 16 * 2048 * 1025
    assert flops == 12 * 5 * half * 11
    assert nbytes == 12 * 16 * half
    assert (flops, nbytes) == tuple(6 * v for v in
                                    conv_k2.work(CELL, "float32"))
    with pytest.raises(ValueError):
        ns_k2.work(problem.parse("cf1024").with_batch(4), "complex64")
