"""fftw3_tpu_torch.ops.inner (K2, c2c along axis -2) against the reference.

The same numpy inputs go through ``fftw3_tpu``'s
``build_pallas_c2c_split_inner`` (Pallas in interpret mode on the CPU) and
through the port's plain twin.  Errors are max-abs error over max-abs:
2e-5 between the packages (the reference's stage arithmetic is bf16x3, the
twin's full f32), 1e-5 for each against numpy in float64.  The kernel runs
only on a card: the tests that launch it are marked ``cuda``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fftw3_tpu import config as ref_config
from fftw3_tpu.ops import pallas_stockham as PS

from fftw3_tpu_torch import config
from fftw3_tpu_torch.ops import inner
from fftw3_tpu_torch.ops import stockham as S

TOL_PKG = 2e-5
TOL_F64 = 1e-5


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    monkeypatch.setattr(config, "kernel_mode", "on")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


def _relerr(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _oracle(xr, xi, sign):
    x = xr.astype(np.float64) + 1j * xi
    n = x.shape[-2]
    return np.fft.fft(x, axis=-2) if sign < 0 \
        else np.fft.ifft(x, axis=-2) * n


CASES = [  # (n, radices, sign, shape)
    (128, [128], -1, (2, 128, 130)),         # masked edge tile
    (128, [128], +1, (3, 128, 1)),           # one column
    (512, [32, 16], -1, (1, 512, 130)),
    (1000, [50, 20], +1, (2, 1000, 3)),
    (32, [32], -1, (5, 32, 128)),            # the four-step's p pass
    (256, [256], +1, (2, 3, 256, 20)),       # two leading dims
]


@pytest.mark.parametrize("n,radices,sign,shape", CASES)
def test_twin_matches_reference(n, radices, sign, shape):
    xr, xi = _planes(n + shape[-1], shape)
    desc = {"alg": "pallas", "n": n, "radices": radices}
    ref = PS.build_pallas_c2c_split_inner(desc, sign, np.float32)
    wr, wi = jax.jit(ref)(jnp.asarray(xr), jnp.asarray(xi))
    want = np.asarray(wr) + 1j * np.asarray(wi)
    split = inner.build_pallas_c2c_split_inner(desc, sign, np.float32, "cpu")
    before = inner.launches
    yr, yi = split(torch.from_numpy(xr), torch.from_numpy(xi))
    assert inner.launches == before              # the twin ran
    got = yr.numpy() + 1j * yi.numpy()
    oracle = _oracle(xr, xi, sign)
    assert got.shape == want.shape == shape
    assert _relerr(got, want) <= TOL_PKG
    assert _relerr(got, oracle) <= TOL_F64
    assert _relerr(want, oracle) <= TOL_F64


def test_split_grads_equal_jax_vjp():
    desc = {"alg": "pallas", "n": 128, "radices": [128]}
    xr, xi = _planes(5, (2, 128, 130))
    gr, gi = _planes(6, (2, 128, 130))
    ref = PS.build_pallas_c2c_split_inner(desc, -1, np.float32)
    _, vjp = jax.vjp(ref, jnp.asarray(xr), jnp.asarray(xi))
    wr, wi = (np.asarray(g) for g in vjp((jnp.asarray(gr), jnp.asarray(gi))))
    split = inner.build_pallas_c2c_split_inner(desc, -1, np.float32, "cpu")
    tr = torch.from_numpy(xr).requires_grad_()
    ti = torch.from_numpy(xi).requires_grad_()
    yr, yi = split(tr, ti)
    torch.autograd.backward([yr, yi], [torch.from_numpy(gr),
                                       torch.from_numpy(gi)])
    assert _relerr(tr.grad.numpy(), wr) <= TOL_PKG
    assert _relerr(ti.grad.numpy(), wi) <= TOL_PKG


@pytest.mark.parametrize("n,L,tl", [(2048, 4096, 4), (512, 262144, 16),
                                    (32, 128, 128), (8, 4096, 1024),
                                    (1000, 37, 8), (128, 1, 1),
                                    (128, 37, 64), (2048, 1025, 4)])
def test_tile_width(n, L, tl):
    """Tiles fill the kernel's 8192-point group up to the columns L needs;
    no column cap (the butterfly levels need one buffer, and a wider tile
    only lengthens a row segment)."""
    assert inner.tile_width(n, L) == tl
    assert n * tl <= inner.TILE_POINTS


@pytest.mark.parametrize("n,L,pre,gp", [(32, 128, 4096, 2), (32, 128, 1, 1),
                                        (512, 262144, 1, 1),
                                        (128, 37, 5, 1), (8, 37, 5, 5),
                                        (2048, 1025, 8, 1), (128, 1, 3, 3)])
def test_planes_per_group(n, L, pre, gp):
    """More than one plane a group only when one tile holds a whole plane
    (the four-step's (B, 32, 128) p pass: two)."""
    assert inner.planes_per_group(n, L, pre) == gp
    assert gp * n * inner.tile_width(n, L) <= inner.TILE_POINTS


def test_kernel_wrapper_refuses_cpu_tensors():
    n, radices = 128, [128]
    x = torch.ones(2, n, 3)
    table = torch.from_numpy(S.kernel_table(n, radices, -1))
    with pytest.raises(ValueError, match="CUDA"):
        inner.inner_c2c_cuda(x, x, radices, table)
    split = inner.build_pallas_c2c_split_inner(
        {"alg": "pallas", "n": n, "radices": radices}, -1, np.float32, "cpu")
    with pytest.raises(ValueError, match="shape"):
        split(torch.ones(2, n + 1, 3), torch.ones(2, n + 1, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("n,radices", [(8, [8]), (32, [32]), (128, [128]),
                                       (512, [32, 16]), (1000, [50, 20]),
                                       (2048, [128, 16])])
@pytest.mark.parametrize("L", [1, 37, 130])
@pytest.mark.parametrize("sign", [-1, +1])
def test_kernel_matches_twin_on_card(cuda_device, n, radices, L, sign):
    xr, xi = (torch.from_numpy(a).to(cuda_device)
              for a in _planes(n + L, (3, n, L)))
    table = S.device_table(n, tuple(radices), sign, cuda_device)
    before = inner.launches
    kr, ki = inner.inner_c2c_cuda(xr, xi, radices, table)
    torch.cuda.synchronize()
    assert inner.launches == before + 1
    tr, ti = inner.inner_c2c_torch(xr, xi, radices, sign)
    got = (kr + 1j * ki).cpu().numpy()
    twin = (tr + 1j * ti).cpu().numpy()
    assert _relerr(got, twin) <= TOL_F64
    assert _relerr(got, _oracle(xr.cpu().numpy(), xi.cpu().numpy(),
                                sign)) <= TOL_F64


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [-1, +1])
def test_kernel_on_real_path_half_spectrum(cuda_device, sign):
    """The axis -2 pass of the full-width 2-D r2c (sign -1) and c2r (sign
    +1): (8, 2048, 1025) half-spectrum planes, 256 full tiles of 4 columns
    and a masked 1-column edge tile per plane."""
    pre, n, L = 8, 2048, 1025
    radices = S.choose_radices(n)
    xr, xi = (torch.from_numpy(a).to(cuda_device)
              for a in _planes(L + sign, (pre, n, L)))
    table = S.device_table(n, tuple(radices), sign, cuda_device)
    before = inner.launches
    kr, ki = inner.inner_c2c_cuda(xr, xi, radices, table)
    torch.cuda.synchronize()
    assert inner.launches == before + 1
    tr, ti = inner.inner_c2c_torch(xr, xi, radices, sign)
    got = (kr + 1j * ki).cpu().numpy()
    assert _relerr(got, (tr + 1j * ti).cpu().numpy()) <= TOL_F64
    assert _relerr(got, _oracle(xr.cpu().numpy(), xi.cpu().numpy(),
                                sign)) <= TOL_F64
