"""The port's functional API and ``fftw3.h`` shims against the reference.

The numpy-style functions (``fft`` ... ``irfftn`` with ``n``/``s``,
``axes`` and every ``norm``), ``dct``/``idct``/``dst``/``idst``/``dht``,
``estimate_cost``, the wisdom I/O forms, the plan cache keyed by device,
the functional flags and the ``fftw3.h`` symbol surface.  The same seeded
numpy inputs go through ``fftw3_tpu`` (Pallas in interpret mode) and
``fftw3_tpu_torch`` on the CPU (kernel twins, the planner on the
reference's hardware constants); outputs agree within 2e-5 (float32) /
1e-12 (float64) of max |reference|, and with numpy/scipy in float64.
"""
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sfft
import torch

import fftw3_tpu as ref_ft
from fftw3_tpu import api as ref_api
from fftw3_tpu import config as ref_config
from fftw3_tpu import planner as ref_planner

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import api, config
from fftw3_tpu_torch.planner import HardwareModel

@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    """Kernels on in both packages (the port's twins on the CPU), the
    port's planner on the reference's hardware constants, both planners
    without wisdom and both plan caches empty; plans of the port on the
    CPU."""
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(ft.the_planner, "hw", HardwareModel(
        **dataclasses.asdict(ref_planner.HW)))
    monkeypatch.setattr(ft.the_planner, "wisdom", {})
    monkeypatch.setattr(ref_planner.the_planner, "wisdom", {})
    api._cached_plan.cache_clear()
    ref_api._cached_plan.cache_clear()
    yield
    api._cached_plan.cache_clear()
    ref_api._cached_plan.cache_clear()


def _relerr(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _input(kind, shape, dtype, axes=None, seed=0):
    """'c': complex, 'r': real, 'h': the half spectrum (over `axes`) of a
    real array of logical `shape`, so c2r inputs are Hermitian-valid."""
    rng = np.random.default_rng(seed)
    real = np.float32 if dtype == "32" else np.float64
    cplx = np.complex64 if dtype == "32" else np.complex128
    if kind == "r":
        return rng.standard_normal(shape).astype(real)
    if kind == "c":
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(cplx)
    return np.fft.rfftn(rng.standard_normal(shape), axes=axes).astype(cplx)


# (function, input kind, shape, kwargs, axes of the half spectrum for 'h')
NUMPY_CASES = [
    ("fft", "c", (3, 16), {}),
    ("fft", "c", (3, 16), {"n": 12}),
    ("fft", "r", (10, 4), {"n": 20, "axis": 0}),
    ("fft", "c", (4, 128), {}),                   # K1's twin
    ("ifft", "c", (3, 16), {}),
    ("ifft", "c", (3, 16), {"n": 24}),
    ("fft2", "c", (2, 8, 12), {}),
    ("fft2", "r", (5, 7), {"s": (4, 8)}),
    ("ifft2", "c", (2, 8, 12), {"axes": (0, 2)}),
    ("fftn", "c", (4, 6, 8), {}),
    ("fftn", "c", (10, 12), {"s": (8, 16), "axes": (0, 1)}),
    ("fftn", "c", (4, 6, 8), {"axes": (0, 2)}),
    ("ifftn", "c", (4, 6, 8), {"s": (5, 6, 10), "axes": (0, 1, 2)}),
    ("rfft", "r", (3, 16), {}),
    ("rfft", "r", (3, 16), {"n": 30}),
    ("rfft", "r", (12, 3), {"axis": 0}),
    ("rfft", "r", (4, 256), {}),                  # K4's twin
    ("irfft", "h", (3, 16), {}, (1,)),
    ("irfft", "h", (3, 17), {"n": 17}, (1,)),
    ("irfft", "h", (4, 256), {}, (1,)),           # K6's twin
    ("rfft2", "r", (2, 8, 12), {}),
    ("irfft2", "h", (2, 8, 12), {}, (1, 2)),
    ("rfftn", "r", (6, 10), {"s": (8, 8), "axes": (0, 1)}),
    ("rfftn", "r", (4, 6, 8), {"axes": (0, 1)}),
    ("irfftn", "h", (4, 6, 8), {}, (0, 1, 2)),
    ("irfftn", "h", (4, 6, 9), {"s": (4, 6, 9), "axes": (0, 1, 2)},
     (0, 1, 2)),
]
NORMS = [None, "backward", "ortho", "forward"]


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("case", NUMPY_CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[2]))}-{i}"
                              for i, c in enumerate(NUMPY_CASES)])
def test_numpy_style_matches_reference_and_numpy(case, norm):
    name, kind, shape, kw = case[:4]
    x = _input(kind, shape, "32", case[4] if len(case) > 4 else None)
    got = _np(getattr(ft, name)(torch.from_numpy(x), norm=norm, **kw))
    ref = np.asarray(getattr(ref_ft, name)(x, norm=norm, **kw))
    want = getattr(np.fft, name)(x.astype(np.complex128 if x.dtype.kind
                                          == "c" else np.float64),
                                 norm=norm, **kw)
    assert got.shape == ref.shape == want.shape
    assert got.dtype == ref.dtype
    assert _relerr(got, ref) <= 2e-5
    assert _relerr(got, want) <= 2e-5


@pytest.mark.parametrize("name,kind,shape,kw", [
    ("fft", "c", (3, 16), {"norm": "ortho"}),
    ("ifftn", "c", (4, 6, 8), {"s": (5, 6, 10), "axes": (0, 1, 2)}),
    ("rfftn", "r", (6, 10), {"s": (8, 8), "axes": (0, 1),
                             "norm": "forward"}),
    ("irfft", "h", (3, 17), {"n": 17}),
])
def test_numpy_style_float64(name, kind, shape, kw):
    x = _input(kind, shape, "64", (1,))
    got = _np(getattr(ft, name)(torch.from_numpy(x), **kw))
    ref = np.asarray(getattr(ref_ft, name)(x, **kw))
    want = getattr(np.fft, name)(x, **kw)
    assert got.dtype == ref.dtype
    assert _relerr(got, ref) <= 1e-12
    assert _relerr(got, want) <= 1e-12


def test_numpy_array_goes_to_config_device(monkeypatch):
    """An array-like runs on config.device; with "cuda" and no card it
    raises (nothing falls back to the CPU); a tensor runs on its own
    device whatever config.device says."""
    x = _input("c", (2, 16), "32")
    assert ft.fft(x).device.type == "cpu"
    monkeypatch.setattr(config, "device", "cuda")
    if not torch.cuda.is_available():
        # a CPU build of torch raises AssertionError, a CUDA build without
        # a card RuntimeError
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            ft.fft(x)
    assert ft.fft(torch.from_numpy(x)).device.type == "cpu"


def test_plan_cache_keyed_by_device():
    """The second call of a shape plans nothing; the device is part of the
    key, with "cuda" and "cuda:<current>" one key."""
    x = torch.from_numpy(_input("c", (4, 96), "32"))
    ft.fft(x)
    nplan = ft.the_planner.stats["nplan"]
    hits = api._cached_plan.cache_info().hits
    ft.fft(x)
    assert ft.the_planner.stats["nplan"] == nplan
    assert api._cached_plan.cache_info().hits == hits + 1
    assert api._device_key(torch.device("cuda")) \
        == api._device_key(torch.device("cuda", 0)) == "cuda:0"
    assert api._device_key(torch.device("cpu")) == "cpu"
    if not torch.cuda.is_available():
        # a key for the card never serves the CPU plan: it builds anew
        with pytest.raises(RuntimeError, match="CUDA"):
            api._cached_plan("c2c", (4, 96), (1,), ft.FORWARD, "complex64",
                             "cuda:0")


def test_functional_flags_replan():
    x = torch.from_numpy(_input("c", (4, 256), "32"))
    try:
        ft.set_functional_flags(ft.MEASURE)
        assert ft.get_functional_flags() == ft.MEASURE
        ft.fft(x)
        st = ft.the_planner.stats
        assert st["nmeasure"] + st["nmeasure_failed"] > 0
    finally:
        ft.set_functional_flags(ft.ESTIMATE)
    assert ft.get_functional_flags() == ft.ESTIMATE


DCT_CASES = [(f, t, norm) for f in ("dct", "idct", "dst", "idst")
             for t in (1, 2, 3, 4) for norm in (None, "ortho")]


@pytest.mark.parametrize("fn,type_,norm", DCT_CASES)
def test_trig_transforms_match_reference(fn, type_, norm):
    x = _input("r", (3, 12), "32", seed=type_)
    got = _np(getattr(ft, fn)(torch.from_numpy(x), type=type_, norm=norm))
    ref = np.asarray(getattr(ref_ft, fn)(x, type=type_, norm=norm))
    assert _relerr(got, ref) <= 2e-5
    if norm == "ortho":
        want = getattr(sfft, fn)(x.astype(np.float64), type=type_,
                                 norm="ortho")
        assert _relerr(got, want) <= 2e-5


@pytest.mark.parametrize("axis", [-1, 0])
def test_dht_and_axis(axis):
    x = _input("r", (6, 10), "64", seed=3)
    got = _np(ft.dht(torch.from_numpy(x), axis=axis))
    ref = np.asarray(ref_ft.dht(x, axis=axis))
    X = np.fft.fft(x, axis=axis)
    assert _relerr(got, ref) <= 1e-12
    assert _relerr(got, X.real - X.imag) <= 1e-12
    assert _relerr(_np(ft.dct(torch.from_numpy(x), 2, axis)),
                   np.asarray(ref_ft.dct(x, 2, axis))) <= 1e-12


def test_gradient_through_fft_is_conj_of_jax():
    """ROADMAP queue 3's convention: a torch complex gradient is the
    conjugate of jax.grad's."""
    x = _input("c", (3, 128), "32", seed=5)
    c = _input("c", (3, 128), "32", seed=6)
    g_ref = np.asarray(jax.grad(
        lambda a: jnp.sum(jnp.real(ref_ft.fft(a, norm="ortho") * c)))(
            jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (ft.fft(xt, norm="ortho") * torch.from_numpy(c)).real.sum().backward()
    assert _relerr(_np(xt.grad), np.conj(g_ref)) <= 2e-5


ESTIMATE_CASES = [
    ((64,), None, "c2c", "complex64", ()),
    ((4096,), None, "c2c", "complex64", ()),
    ((8, 96), (1,), "c2c", "complex64", ()),
    ((16, 1000), None, "c2c", "complex64", ()),
    ((128, 128), None, "c2c", "complex128", ()),
    ((4, 256), (1,), "r2c", "float32", ()),
    ((32, 30), None, "c2r", "float32", ()),
    ((8, 64), (1,), "r2r", "float32", ("redft10",)),
    ((8, 64), None, "r2r", "float64", ("dht", "rodft11")),
]


@pytest.mark.parametrize("shape,axes,kind,dtype,kinds", ESTIMATE_CASES)
def test_estimate_cost_equals_reference(shape, axes, kind, dtype, kinds):
    got = ft.estimate_cost(shape, axes, kind, dtype, kinds, device="cpu")
    want = ref_ft.estimate_cost(shape, axes, kind, dtype, kinds)
    assert got > 0
    assert abs(got - want) <= 1e-12 * want


def test_wisdom_filename_file_and_callback(tmp_path):
    ft.plan_dft_1d(64, device="cpu")
    path = tmp_path / "w.json"
    assert ft.export_wisdom_to_filename(str(path))
    assert json.loads(path.read_text())["format"] \
        == "fftw3-tpu-torch-wisdom-1"
    ft.forget_wisdom()
    assert ft.the_planner.wisdom == {}
    assert ft.import_wisdom_from_filename(str(path))
    hits = ft.the_planner.stats["nwisdom_hit"]
    ft.plan_dft_1d(64, device="cpu")
    assert ft.the_planner.stats["nwisdom_hit"] == hits + 1
    assert not ft.import_wisdom_from_filename(str(tmp_path / "missing"))
    assert not ft.export_wisdom_to_filename(str(tmp_path))   # a directory
    buf = io.StringIO()
    assert ft.export_wisdom_to_file(buf)
    ft.forget_wisdom()
    buf.seek(0)
    assert ft.import_wisdom_from_file(buf) and ft.the_planner.wisdom
    assert not ft.export_wisdom_to_file(object())
    assert not ft.import_wisdom_from_file(object())
    chunks = []
    ft.export_wisdom(chunks.append)
    ft.forget_wisdom()
    assert ft.import_wisdom(lambda: "".join(chunks))
    assert any(k.startswith("c2c:64:") for k in ft.the_planner.wisdom)
    # the reference's format is not this package's
    ref_ft.plan_dft_1d(64)
    assert not ft.import_wisdom_from_string(ref_ft.export_wisdom_to_string())


def test_system_wisdom(tmp_path, monkeypatch):
    ft.plan_dft_1d(64, device="cpu")
    sysw = tmp_path / "system.json"
    sysw.write_text(ft.export_wisdom_to_string())
    monkeypatch.setenv("FFTW3_TPU_TORCH_SYSTEM_WISDOM", str(sysw))
    ft.forget_wisdom()
    assert ft.import_system_wisdom() and ft.the_planner.wisdom
    monkeypatch.delenv("FFTW3_TPU_TORCH_SYSTEM_WISDOM")
    monkeypatch.setattr(api, "SYSTEM_WISDOM_PATH", str(tmp_path / "none"))
    assert not ft.import_system_wisdom()
    assert api.SYSTEM_WISDOM_ENV == "FFTW3_TPU_TORCH_SYSTEM_WISDOM"


def test_cleanup_drops_plans_and_wisdom():
    ft.fft(torch.from_numpy(_input("c", (2, 32), "32")))
    assert ft.the_planner.wisdom and api._cached_plan.cache_info().currsize
    ft.cleanup()
    assert not ft.the_planner.wisdom
    assert api._cached_plan.cache_info().currsize == 0


#: the reference's fftw3.h symbol list (tests/test_api_parity.py) less the
#: four threads names, which come with the threads tier
FFTW3_H = [
    "alignment_of", "alloc_complex", "alloc_real", "cc", "cleanup",
    "cost", "destroy_plan", "estimate_cost",
    "execute", "execute_dft", "execute_dft_c2r", "execute_dft_r2c",
    "execute_r2r", "execute_split_dft", "execute_split_dft_c2r",
    "execute_split_dft_r2c", "export_wisdom", "export_wisdom_to_file",
    "export_wisdom_to_filename", "export_wisdom_to_string", "flops",
    "forget_wisdom", "fprint_plan", "free", "import_system_wisdom",
    "import_wisdom", "import_wisdom_from_file",
    "import_wisdom_from_filename", "import_wisdom_from_string",
    "iodim", "iodim64",
    "malloc", "plan_dft", "plan_dft_1d", "plan_dft_2d", "plan_dft_3d",
    "plan_dft_c2r", "plan_dft_c2r_1d", "plan_dft_c2r_2d",
    "plan_dft_c2r_3d", "plan_dft_r2c", "plan_dft_r2c_1d",
    "plan_dft_r2c_2d", "plan_dft_r2c_3d", "plan_guru64_dft",
    "plan_guru64_dft_c2r", "plan_guru64_dft_r2c", "plan_guru64_r2r",
    "plan_guru64_split_dft", "plan_guru64_split_dft_c2r",
    "plan_guru64_split_dft_r2c", "plan_guru_dft", "plan_guru_dft_c2r",
    "plan_guru_dft_r2c", "plan_guru_r2r", "plan_guru_split_dft",
    "plan_guru_split_dft_c2r", "plan_guru_split_dft_r2c",
    "plan_many_dft", "plan_many_dft_c2r", "plan_many_dft_r2c",
    "plan_many_r2r", "plan_r2r", "plan_r2r_1d", "plan_r2r_2d",
    "plan_r2r_3d", "print_plan", "r2r_kind",
    "set_timelimit", "sprint_plan", "version",
]
THREADS = ["cleanup_threads", "init_threads", "make_planner_thread_safe",
           "plan_with_nthreads"]


def test_fftw3_h_symbol_surface():
    for name in FFTW3_H:
        assert hasattr(ref_ft, name), name
        assert hasattr(ft, name), f"fftw3.h analog missing: {name}"
    # the reference's own exports, less the threads tier and the
    # distributed tier's package
    ref_names = {n for n in dir(ref_ft) if not n.startswith("_")}
    missing = ref_names - set(dir(ft)) - set(THREADS) \
        - {"planner_nthreads", "parallel", "threads", "native", "models",
           "toolchain_probe", "utils", "ops"}
    assert not missing, sorted(missing)


def test_shims_and_split_execute_family():
    rng = np.random.default_rng(7)
    p = ft.plan_dft_r2c((4, 64), axes=(1,), device="cpu")
    x = rng.standard_normal((4, 64)).astype(np.float32)
    yr, yi = ft.execute_split_dft_r2c(p, x)
    ref = np.fft.rfft(x.astype(np.float64), axis=1)
    assert _relerr(_np(yr) + 1j * _np(yi), ref) < 1e-5
    pc = ft.plan_dft_c2r((4, 64), axes=(1,), device="cpu")
    y = ft.execute_split_dft_c2r(pc, yr, yi)
    assert np.max(np.abs(_np(y) / 64 - x)) < 1e-5
    pr = ft.plan_r2r((2, 32), [5], axes=(1,), device="cpu")  # FFTW_REDFT10
    assert "redft10" in ft.sprint_plan(pr)
    buf = io.StringIO()
    ft.fprint_plan(pr, buf)
    assert "plan" in buf.getvalue()
    ft.destroy_plan(p)
    ft.free(ft.malloc(64))
    a = ft.alloc_real(10, "float64")
    b = ft.alloc_complex(6)
    assert (a.dtype, a.shape, a.device.type) == (torch.float64, (10,), "cpu")
    assert (b.dtype, b.shape) == (torch.complex64, (6,))
    assert not bool(b.abs().sum()) and ft.alignment_of(b) == 0
    for s in (ft.version, ft.cc, ft.codelet_optim):
        assert isinstance(s, str) and "TPU" not in s
    assert "fftw3_tpu_torch" in ft.version


def test_fft_helpers_are_torch_fft():
    assert ft.fftfreq is torch.fft.fftfreq
    assert np.allclose(_np(ft.fftfreq(8, 0.5)), np.fft.fftfreq(8, 0.5))
    assert np.allclose(_np(ft.rfftfreq(9)), np.fft.rfftfreq(9))
    x = torch.arange(10.0).reshape(2, 5)
    assert np.array_equal(_np(ft.fftshift(x)), np.fft.fftshift(_np(x)))
    assert np.array_equal(_np(ft.ifftshift(ft.fftshift(x))), _np(x))
