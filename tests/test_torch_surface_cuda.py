"""The user surface on the card: the functional API, the guru layouts and
the harness on CUDA tensors, against float64 (numpy on the host) and the
same calls on the CPU (the kernels' twins), with the kernels' launch
counts.  Every test needs a CUDA card and skips without one; this file
imports no JAX.
"""
import numpy as np
import pytest
import torch

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import api, guru
from fftw3_tpu_torch.interfaces import scipy_fft as sf
from fftw3_tpu_torch.ops import fused2d, inner
from fftw3_tpu_torch.ops import real_stockham as RS
from fftw3_tpu_torch.ops import stockham as S

TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    api._cached_plan.cache_clear()
    yield torch.device("cuda")
    api._cached_plan.cache_clear()


def _relerr(got, want) -> float:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _counts():
    return (S.launches, inner.launches, fused2d.launches, RS.r2c_launches,
            RS.c2r_launches)


def _delta(before):
    return tuple(a - b for a, b in zip(_counts(), before))


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,kw,launches", [
    ("fft", (64, 1024), {}, (1, 0, 0, 0, 0)),
    ("ifft", (64, 1024), {"norm": "ortho"}, (1, 0, 0, 0, 0)),
    ("fft2", (4, 512, 512), {}, (0, 0, 1, 0, 0)),
    ("fftn", (128, 128, 128), {}, (0, 1, 1, 0, 0)),
    ("rfft", (64, 1024), {}, (0, 0, 0, 1, 0)),
    ("rfftn", (2, 512, 1024), {"axes": (1, 2)}, (0, 1, 0, 1, 0)),
])
def test_functional_on_card(cuda_device, name, shape, kw, launches):
    """At sizes where the functional ESTIMATE keeps every axis on a
    kernel (n = 256 and the real n = 512 go to `mixed` and `r2c_pack`)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape)
    if name not in ("rfft", "rfftn"):
        x = x + 1j * rng.standard_normal(shape)
    xt = torch.from_numpy(x.astype(np.complex64 if x.dtype.kind == "c"
                                   else np.float32)).to(cuda_device)
    before = _counts()
    y = getattr(ft, name)(xt, **kw)
    torch.cuda.synchronize()
    assert _delta(before) == launches
    assert y.device.type == "cuda"
    want = getattr(np.fft, name)(x, **kw)
    assert _relerr(y, want) <= TOL
    nplan = ft.the_planner.stats["nplan"]
    getattr(ft, name)(xt, **kw)
    assert ft.the_planner.stats["nplan"] == nplan       # the plan cache
    cpu = getattr(ft, name)(xt.cpu(), **kw)              # its own plan
    assert cpu.device.type == "cpu" and _relerr(cpu, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 1024), (3, 2, 512, 1024)])
def test_irfft_on_card(cuda_device, shape):
    rng = np.random.default_rng(1)
    real = rng.standard_normal(shape)
    axes = (-1,) if len(shape) == 2 else (-2, -1)
    X = np.fft.rfftn(real, axes=axes)
    Xt = torch.from_numpy(X.astype(np.complex64)).to(cuda_device)
    before = RS.c2r_launches
    y = ft.irfft(Xt) if len(shape) == 2 else ft.irfftn(Xt, axes=axes)
    torch.cuda.synchronize()
    assert RS.c2r_launches == before + 1
    assert _relerr(y, real) <= TOL


@pytest.mark.cuda
def test_trig_on_card(cuda_device):
    import scipy.fft as sfft
    x = np.random.default_rng(2).standard_normal((64, 32, 16))
    xt = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    for t in (1, 2, 3, 4):
        y = ft.dct(xt, t, norm="ortho")
        assert y.device.type == "cuda"
        assert _relerr(y, sfft.dct(x, t, norm="ortho")) <= TOL
        assert _relerr(sf.idst(xt, t, norm="forward"),
                       sfft.idst(x, t, norm="forward")) <= TOL
    assert _relerr(sf.dctn(xt, norm="ortho"), sfft.dctn(x, norm="ortho")) \
        <= TOL
    assert _relerr(ft.dht(xt), np.fft.fft(x).real - np.fft.fft(x).imag) \
        <= TOL


@pytest.mark.cuda
def test_split_guru_on_card(cuda_device):
    rng = np.random.default_rng(3)
    xr, xi = (torch.from_numpy(rng.standard_normal((256, 1024))
                               .astype(np.float32)).to(cuda_device)
              for _ in range(2))
    sp = ft.plan_guru_split_dft([1024], [256], device="cuda")
    before = S.launches
    yr, yi = ft.execute_split_dft(sp, xr, xi)
    torch.cuda.synchronize()
    assert S.launches == before + 1
    want = np.fft.fft(xr.cpu().double().numpy()
                      + 1j * xi.cpu().double().numpy(), axis=-1)
    assert _relerr(torch.complex(yr, yi), want) <= TOL


@pytest.mark.cuda
def test_strided_guru_on_card(cuda_device):
    """n = 128 at input stride 2 and output stride 3, 64 transforms,
    from an offset, into a caller's CUDA buffer: the card and the CPU plan
    agree, the buffer outside the layout is untouched."""
    rng = np.random.default_rng(4)
    n, b, off = 128, 64, 5
    dims, hm = [guru.iodim(n, 2, 3)], [guru.iodim(b, 2 * n, 3 * n)]
    flat = (rng.standard_normal(off + 2 * n * b)
            + 1j * rng.standard_normal(off + 2 * n * b)).astype(np.complex64)
    p = ft.plan_guru_dft(dims, hm, device="cuda")
    pc = ft.plan_guru_dft(dims, hm, device="cpu")
    size = off + 3 * n * b
    assert p.out_size == 3 * n * b - 2
    out = torch.full((size,), 2.0 + 0j, dtype=torch.complex64,
                     device=cuda_device)
    got = p.execute(torch.from_numpy(flat).to(cuda_device), off, out)
    assert got is out
    want = pc.execute(flat, off, torch.full((size,), 2.0 + 0j,
                                            dtype=torch.complex64))
    assert _relerr(got, want.numpy()) <= TOL
    x = flat[off:off + 2 * n * b].reshape(b, n, 2)[..., 0]
    y = got.cpu().numpy()[off:].reshape(b, n, 3)
    assert _relerr(y[..., 0], np.fft.fft(x.astype(np.complex128), axis=-1)) \
        <= TOL
    assert np.all(y[..., 1:] == 2.0) and np.all(got.cpu().numpy()[:off]
                                                == 2.0)


@pytest.mark.cuda
def test_many_embed_on_card(cuda_device):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((512, 1040))
         + 1j * rng.standard_normal((512, 1040))).astype(np.complex64)
    p = guru.plan_many_dft([1024], 512, inembed=[1040], onembed=[1040],
                           device="cuda")
    before = S.launches
    y = p.execute(torch.from_numpy(x).to(cuda_device))
    torch.cuda.synchronize()
    assert S.launches == before + 1 and tuple(y.shape) == (512, 1040)
    assert _relerr(y[:, :1024], np.fft.fft(x[:, :1024].astype(
        np.complex128), axis=-1)) <= TOL
    assert not bool(y[:, 1024:].abs().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("pstring", ["c1024v64", "r1024v16", "rb1024v16",
                                     "k512e10v32", "c64x128x128",
                                     "r256x256v2", "c1000v8", "c97v4"])
def test_harness_verify_on_card(cuda_device, pstring):
    res = ft.harness.verify_problem(pstring, rounds=2, device="cuda")
    assert res.max_err < 1e-3
