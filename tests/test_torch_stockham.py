"""fftw3_tpu_torch.ops.stockham against the reference Pallas kernel.

The same numpy inputs go through ``fftw3_tpu``'s ``build_pallas_c2c_split``
(Pallas in interpret mode on the CPU, as the reference's own tests run it)
and through the port's plain PyTorch twin.  Errors are max-abs error over
max-abs of the reference.  Tolerances: 2e-5 between the packages (the
reference's stage arithmetic is bf16x3, about 5e-6; the twin is full f32),
1e-5 for each against numpy in float64.  The kernel itself runs only on a
card: ``test_kernel_matches_twin_on_card`` is marked ``cuda``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fftw3_tpu import config as ref_config
from fftw3_tpu import plan_many_dft as ref_plan_many_dft
from fftw3_tpu import planner as ref_planner
from fftw3_tpu.ops import pallas_stockham as PS

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import config
from fftw3_tpu_torch.ops import stockham as S

TOL_PKG = 2e-5
TOL_F64 = 1e-5


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    """Kernels on in both packages, and both global planners without
    wisdom, so that no plan made by another test under other modes is
    served from it."""
    old = ref_config.pallas_mode, config.kernel_mode
    ref_config.pallas_mode = "interpret"
    config.kernel_mode = "on"
    monkeypatch.setattr(ref_planner.the_planner, "wisdom", {})
    monkeypatch.setattr(ft.the_planner, "wisdom", {})
    yield
    ref_config.pallas_mode, config.kernel_mode = old


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


def _relerr(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _ref_split(desc, sign, xr, xi):
    fn = PS.build_pallas_c2c_split(desc, sign, np.float32)
    yr, yi = jax.jit(fn)(jnp.asarray(xr), jnp.asarray(xi))
    return np.asarray(yr) + 1j * np.asarray(yi)


def _oracle(x, sign):
    n = x.shape[-1]
    return np.fft.fft(x, axis=-1) if sign < 0 else np.fft.ifft(x, axis=-1) * n


CASES = [  # (n, radices, sign, batch shape, vpu)
    (128, [128], -1, (5,), None),
    (256, [256], +1, (1,), None),
    (512, [32, 16], -1, (130,), None),       # ragged against 128-row tiles
    (1000, [50, 20], +1, (5,), None),
    (1024, [64, 16], -1, (5,), None),
    (1024, [32, 32], +1, (5,), None),        # alternative schedule
    (2048, [128, 16], -1, (1,), None),
    (2048, [64, 32], +1, (5,), None),        # alternative schedule
    (1024, [64, 16], -1, (5,), True),
    (1024, [32, 32], +1, (5,), "all"),
    (1000, [50, 20], -1, (5,), "all"),       # radix-5 butterflies
    (512, [32, 16], +1, (3, 5), True),       # leading multi-dim batch
    (4096, [64, 64], -1, (3,), "all"),       # the MEASURE-only schedule
    (4096, [64, 64], +1, (2,), "all"),       # above MAX_N (K1's wide form)
]


@pytest.mark.parametrize("n,radices,sign,bshape,vpu", CASES)
def test_twin_matches_reference(n, radices, sign, bshape, vpu):
    assert S.choose_radices(n) == PS.choose_radices(n)
    rng = np.random.default_rng(n + len(bshape))
    x = (rng.standard_normal(bshape + (n,))
         + 1j * rng.standard_normal(bshape + (n,)))
    xr = x.real.astype(np.float32)
    xi = x.imag.astype(np.float32)
    desc = {"alg": "pallas", "n": n, "radices": radices}
    if vpu is not None:
        desc["vpu"] = vpu
    want = _ref_split(desc, sign, xr, xi)
    split = S.build_pallas_c2c_split(desc, sign, np.float32, "cpu")
    yr, yi = split(torch.from_numpy(xr), torch.from_numpy(xi))
    got = yr.numpy() + 1j * yi.numpy()
    oracle = _oracle(xr.astype(np.float64) + 1j * xi, sign)
    assert got.shape == want.shape == x.shape
    assert _relerr(got, want) <= TOL_PKG
    assert _relerr(got, oracle) <= TOL_F64
    assert _relerr(want, oracle) <= TOL_F64


@pytest.mark.parametrize("n,radices", [(256, [256]), (1024, [64, 16]),
                                       (1000, [50, 20]), (2048, [128, 16])])
@pytest.mark.parametrize("sign", [-1, +1])
def test_stage_constants_bit_equal(n, radices, sign):
    mine = S._stage_consts(n, radices, sign)
    ref = PS._stage_consts(n, radices, sign, 0, presplit=False)
    assert len(mine) == len(ref)
    for a_stage, b_stage in zip(mine, ref):
        assert len(a_stage) == len(b_stage)
        for a, b in zip(a_stage, b_stage):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    # the kernel's first root table is column 1 of the reference's F_p
    # (F[j, 1] = r_p[j]), stored in the stacked G as [[Fr], [Fi]]
    tab = S.kernel_table(n, radices, sign)
    assert tab.size == S.table_len(n, radices)
    p = radices[0]
    assert np.array_equal(tab[:2 * p], ref[0][0][:, 1])


def test_split_grads_equal_jax_vjp():
    n, radices, sign = 256, [256], -1
    rng = np.random.default_rng(7)
    xr, xi, gr, gi = (rng.standard_normal((3, n)).astype(np.float32)
                      for _ in range(4))
    desc = {"alg": "pallas", "n": n, "radices": radices}
    ref = PS.build_pallas_c2c_split(desc, sign, np.float32)
    _, vjp = jax.vjp(ref, jnp.asarray(xr), jnp.asarray(xi))
    wr, wi = (np.asarray(g) for g in vjp((jnp.asarray(gr), jnp.asarray(gi))))
    split = S.build_pallas_c2c_split(desc, sign, np.float32, "cpu")
    tr = torch.from_numpy(xr).requires_grad_()
    ti = torch.from_numpy(xi).requires_grad_()
    yr, yi = split(tr, ti)
    torch.autograd.backward([yr, yi], [torch.from_numpy(gr),
                                       torch.from_numpy(gi)])
    assert _relerr(tr.grad.numpy(), wr) <= TOL_PKG
    assert _relerr(ti.grad.numpy(), wi) <= TOL_PKG


def test_complex_grads_are_conj_of_jax():
    """Through Plan.execute on a complex tensor torch's autograd gives the
    conjugate of JAX's gradient (ROADMAP queue 3)."""
    n, b = 1024, 2
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((b, n))
         + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    w = (rng.standard_normal((b, n))
         + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    ref = ref_plan_many_dft([n], howmany=b)
    g_jax = np.asarray(jax.grad(
        lambda z: jnp.sum(jnp.real(ref.apply(z) * w)))(jnp.asarray(x)))
    plan = ft.plan_many_dft([n], howmany=b, device="cpu")
    assert plan.descriptors == ref.descriptors
    xt = torch.from_numpy(x).requires_grad_()
    (plan.execute(xt) * torch.from_numpy(w)).real.sum().backward()
    assert _relerr(xt.grad.numpy(), np.conj(g_jax)) <= TOL_PKG


def test_cuda_plan_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this torch build sees a CUDA device")
    config.kernel_mode = "auto"
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.plan_many_dft([1024], howmany=4, device="cuda")


def test_cpu_tensor_runs_twin_and_kernel_wrapper_refuses_it():
    """Under 'on' a CPU tensor runs the twin (no launch); the kernel's own
    wrapper refuses anything that is not a CUDA tensor."""
    config.kernel_mode = "on"
    n, radices = 512, [32, 16]
    split = S.build_pallas_c2c_split({"alg": "pallas", "n": n,
                                      "radices": radices}, -1, np.float32,
                                     "cpu")
    before = S.launches
    x = torch.ones(2, n)
    yr, _ = split(x, torch.zeros(2, n))
    assert S.launches == before
    assert float(yr[0, 0]) == n
    table = torch.from_numpy(S.kernel_table(n, radices, -1))
    with pytest.raises(ValueError, match="CUDA"):
        S.stockham_c2c_cuda(x, x, radices, table)
    with pytest.raises(ValueError):
        split(torch.ones(2, n + 1), torch.ones(2, n + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n,radices", [(128, [128]), (256, [256]),
                                       (1000, [50, 20]), (1024, [64, 16]),
                                       (1024, [32, 32]), (2048, [128, 16])])
@pytest.mark.parametrize("sign", [-1, +1])
def test_kernel_matches_twin_on_card(cuda_device, n, radices, sign):
    rng = np.random.default_rng(n)
    xr, xi = (torch.from_numpy(rng.standard_normal((37, n)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    table = S.device_table(n, tuple(radices), sign, cuda_device)
    before = S.launches
    kr, ki = S.stockham_c2c_cuda(xr, xi, radices, table)
    torch.cuda.synchronize()
    assert S.launches == before + 1
    tr, ti = S.stockham_c2c_torch(xr, xi, radices, sign)
    got = (kr + 1j * ki).cpu().numpy()
    twin = (tr + 1j * ti).cpu().numpy()
    oracle = _oracle(xr.cpu().numpy().astype(np.float64)
                     + 1j * xi.cpu().numpy(), sign)
    assert _relerr(got, twin) <= TOL_F64
    assert _relerr(got, oracle) <= TOL_F64


@pytest.mark.cuda
def test_kernel_on_swapped_route_rows(cuda_device):
    """The last-axis pass of the swapped 2-D r2c: 8 * 1025 rows of 2048
    points, more rows than the card holds blocks at once."""
    B, n = 8 * 1025, 2048
    radices = S.choose_radices(n)
    rng = np.random.default_rng(B)
    xr, xi = (torch.from_numpy(rng.standard_normal((B, n)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    table = S.device_table(n, tuple(radices), -1, cuda_device)
    kr, ki = S.stockham_c2c_cuda(xr, xi, radices, table)
    tr, ti = S.stockham_c2c_torch(xr, xi, radices, -1)
    got = (kr + 1j * ki).cpu().numpy()
    assert _relerr(got, (tr + 1j * ti).cpu().numpy()) <= TOL_F64
    oracle = _oracle(xr.cpu().numpy().astype(np.float64)
                     + 1j * xi.cpu().numpy(), -1)
    assert _relerr(got, oracle) <= TOL_F64


@pytest.mark.cuda
def test_kernel_shared_memory_sizes_interleave(cuda_device):
    """Launch geometry is cached per shared-memory size: a small schedule
    between two launches of the largest one must leave both launchable."""
    rng = np.random.default_rng(3)
    for n, radices in [(2048, [128, 16]), (128, [128]), (2048, [128, 16]),
                       (256, [256])]:
        xr, xi = (torch.from_numpy(rng.standard_normal((5, n)).astype(
            np.float32)).to(cuda_device) for _ in range(2))
        table = S.device_table(n, tuple(radices), -1, cuda_device)
        kr, ki = S.stockham_c2c_cuda(xr, xi, radices, table)
        tr, ti = S.stockham_c2c_torch(xr, xi, radices, -1)
        assert _relerr((kr + 1j * ki).cpu().numpy(),
                       (tr + 1j * ti).cpu().numpy()) <= TOL_F64


@pytest.mark.cuda
def test_kernel_sets_and_restores_the_device(cuda_device, monkeypatch):
    """When the current device is not the tensors' one, the wrapper makes
    it current for the launch only (forced here on one card by hiding the
    current device)."""
    n, radices = 1024, [64, 16]
    rng = np.random.default_rng(4)
    xr, xi = (torch.from_numpy(rng.standard_normal((7, n)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    table = S.device_table(n, tuple(radices), +1, cuda_device)
    before = torch.cuda.current_device()
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    kr, ki = S.stockham_c2c_cuda(xr, xi, radices, table)
    monkeypatch.undo()
    assert torch.cuda.current_device() == before
    tr, ti = S.stockham_c2c_torch(xr, xi, radices, +1)
    assert _relerr((kr + 1j * ki).cpu().numpy(),
                   (tr + 1j * ti).cpu().numpy()) <= TOL_F64
