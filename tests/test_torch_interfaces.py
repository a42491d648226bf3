"""``fftw3_tpu_torch.interfaces`` (numpy.fft and scipy.fft mirrors) against
the reference's interfaces and against numpy/scipy in float64.

The same seeded numpy inputs go through ``fftw3_tpu.interfaces`` (Pallas in
interpret mode) and the port on the CPU (kernel twins, the planner on the
reference's hardware constants): ``hfft``/``ihfft`` with every norm, the
scipy DCT/DST I-IV with every norm and ``orthogonalize`` value (the cases
of ``tests/test_scipy_parity.py``), the n-dimensional variants and the
``n=`` crop/pad.  Within 2e-5 (float32) / 1e-12 (float64) of max |ref|.
"""
import dataclasses

import numpy as np
import pytest
import scipy.fft as sfft
import torch

from fftw3_tpu import api as ref_api
from fftw3_tpu import config as ref_config
from fftw3_tpu import planner as ref_planner
from fftw3_tpu.interfaces import numpy_fft as ref_nf
from fftw3_tpu.interfaces import scipy_fft as ref_sf

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import api, config
from fftw3_tpu_torch.interfaces import numpy_fft as nf
from fftw3_tpu_torch.interfaces import scipy_fft as sf
from fftw3_tpu_torch.planner import HardwareModel


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    """Kernels on in both packages, the port's planner on the reference's
    hardware constants, no wisdom, empty plan caches, the port on the
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
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _check(port_out, ref_out, want, tol=2e-5):
    got = _np(port_out)
    assert got.shape == np.shape(want)
    assert _relerr(got, ref_out) <= tol
    assert _relerr(got, want) <= tol


def test_numpy_fft_names_are_the_api():
    for name in ("fft", "ifft", "fft2", "ifft2", "fftn", "ifftn", "rfft",
                 "irfft", "rfft2", "irfft2", "rfftn", "irfftn", "fftfreq",
                 "rfftfreq", "fftshift", "ifftshift"):
        assert getattr(nf, name) is getattr(ft, name)
        assert getattr(sf, name) is getattr(ft, name)
    assert sf.hfft is nf.hfft and sf.ihfft is nf.ihfft


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
@pytest.mark.parametrize("n", [None, 32, 33])
def test_hfft_ihfft(norm, n):
    rng = np.random.default_rng(1)
    xc = (rng.standard_normal((3, 17))
          + 1j * rng.standard_normal((3, 17))).astype(np.complex64)
    xc[:, 0] = xc[:, 0].real                 # Hermitian-representable
    if n in (None, 32):
        xc[:, -1] = xc[:, -1].real
    _check(nf.hfft(torch.from_numpy(xc), n, -1, norm),
           ref_nf.hfft(xc, n, -1, norm),
           np.fft.hfft(xc.astype(np.complex128), n, -1, norm))
    xr = rng.standard_normal((3, 32)).astype(np.float32)
    m = None if n is None else n - 1
    _check(nf.ihfft(torch.from_numpy(xr), m, -1, norm),
           ref_nf.ihfft(xr, m, -1, norm),
           np.fft.ihfft(xr.astype(np.float64), m, -1, norm))


@pytest.mark.parametrize("fn", ["dct", "dst"])
@pytest.mark.parametrize("tp", [1, 2, 3, 4])
@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
@pytest.mark.parametrize("n", [8, 9, 16])
def test_dct_dst_match_reference_and_scipy(fn, tp, norm, n):
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    _check(getattr(sf, fn)(torch.from_numpy(x), type=tp, norm=norm),
           getattr(ref_sf, fn)(x, type=tp, norm=norm),
           getattr(sfft, fn)(x.astype(np.float64), type=tp, norm=norm))


@pytest.mark.parametrize("tp", [1, 2, 3, 4])
@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
@pytest.mark.parametrize("og", [False, True])
def test_orthogonalize_matches_reference_and_scipy(tp, norm, og):
    x = np.random.default_rng(tp).standard_normal((2, 9)).astype(np.float32)
    for fn in ("dct", "dst", "idct", "idst"):
        _check(getattr(sf, fn)(torch.from_numpy(x), type=tp, norm=norm,
                               orthogonalize=og),
               getattr(ref_sf, fn)(x, type=tp, norm=norm, orthogonalize=og),
               getattr(sfft, fn)(x.astype(np.float64), type=tp, norm=norm,
                                 orthogonalize=og))


@pytest.mark.parametrize("tp", [2, 3])
def test_axis_and_n(tp):
    x = np.random.default_rng(2).standard_normal((6, 10)).astype(np.float32)
    t = torch.from_numpy(x)
    _check(sf.dct(t, type=tp, axis=0), ref_sf.dct(x, type=tp, axis=0),
           sfft.dct(x.astype(np.float64), type=tp, axis=0))
    for n in (6, 14):
        _check(sf.dct(t, type=tp, n=n, norm="ortho"),
               ref_sf.dct(x, type=tp, n=n, norm="ortho"),
               sfft.dct(x.astype(np.float64), type=tp, n=n, norm="ortho"))
        _check(sf.idst(t, type=tp, n=n, axis=0),
               ref_sf.idst(x, type=tp, n=n, axis=0),
               sfft.idst(x.astype(np.float64), type=tp, n=n, axis=0))


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
@pytest.mark.parametrize("fn", ["dctn", "idctn", "dstn", "idstn"])
def test_nd_variants(fn, norm):
    x = np.random.default_rng(4).standard_normal((6, 8, 5))
    for dt, tol in ((np.float32, 2e-5), (np.float64, 1e-12)):
        xd = x.astype(dt)
        _check(getattr(sf, fn)(torch.from_numpy(xd), norm=norm),
               getattr(ref_sf, fn)(xd, norm=norm),
               getattr(sfft, fn)(x, norm=norm), tol)
    _check(getattr(sf, fn)(torch.from_numpy(x), 3, axes=(0, 2),
                           norm=norm),
           getattr(ref_sf, fn)(x, 3, axes=(0, 2), norm=norm),
           getattr(sfft, fn)(x, 3, axes=(0, 2), norm=norm), 1e-12)


def test_workers_overwrite_and_roundtrip():
    x = np.random.default_rng(5).standard_normal((2, 8)).astype(np.float32)
    t = torch.from_numpy(x)
    _check(sf.dct(t, workers=4, overwrite_x=True), ref_sf.dct(x),
           sfft.dct(x.astype(np.float64)))
    _check(sf.dctn(t, workers=2), ref_sf.dctn(x, workers=2),
           sfft.dctn(x.astype(np.float64)))
    y = sf.idctn(sf.dctn(t, norm="ortho"), norm="ortho")
    assert np.max(np.abs(_np(y) - x)) < 2e-6
    with pytest.raises(ValueError):
        sf.dct(t, type=5)
    with pytest.raises(ValueError):
        sf.dct(t, norm="bogus")


def test_api_dct_ortho_is_the_scipy_layer():
    x = np.random.default_rng(6).standard_normal((4, 32)).astype(np.float32)
    t = torch.from_numpy(x)
    for typ in (1, 2, 3, 4):
        assert torch.equal(ft.dct(t, typ, norm="ortho"),
                           sf.dct(t, typ, norm="ortho"))
        back = ft.idct(ft.dct(t, typ, norm="ortho"), typ, norm="ortho")
        assert np.max(np.abs(_np(back) - x)) < 1e-5


def test_factor_vectors_cached_per_device_and_dtype():
    """The orthogonalize pre/post vectors are built once per (type, N,
    norm, dtype, device) and live on the tensor's device."""
    sf._factors.cache_clear()
    x = torch.randn(3, 16)
    sf.dct(x, 2, norm="ortho")
    sf.dct(x, 2, norm="ortho")
    info = sf._factors.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    pre, post = sf._factors(2, 16, True, True, "ortho", torch.float32, "cpu")
    assert pre is None and post.device.type == "cpu"
    assert post.dtype == torch.float32
    sf.dct(x.double(), 2, norm="ortho")
    assert sf._factors.cache_info().misses == 2
