"""fftw3_tpu_torch's real kernels (K4, K5, K6) and real solvers against the
reference.

The same numpy inputs go through ``fftw3_tpu``'s ``build_pallas_r2c``,
``build_pallas_c2r`` and ``build_pallas_r2c_inner`` (Pallas in interpret
mode on the CPU, as the reference's own tests run them) and through the
port's plain twins, and through every solver of both packages'
``ops/real.py``.  Errors are max-abs error over max-abs: 2e-5 between the
packages (the reference's stage arithmetic is bf16x3, the twins' full f32),
1e-5 for each against numpy in float64.  The kernels run only on a card:
the tests that launch them are marked ``cuda``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fftw3_tpu import config as ref_config
from fftw3_tpu import planner as ref_planner
from fftw3_tpu.ops import pallas_stockham as PS
from fftw3_tpu.ops import real as ref_real

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import config
from fftw3_tpu_torch.ops import real as real_ops
from fftw3_tpu_torch.ops import real_stockham as RS
from fftw3_tpu_torch.ops import stockham as S

TOL_PKG = 2e-5
TOL_F64 = 1e-5


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    """Kernels on in both packages, and both global planners without
    wisdom (the real kernels' backward plans through them)."""
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(ref_planner.the_planner, "wisdom", {})
    monkeypatch.setattr(ft.the_planner, "wisdom", {})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


def _relerr(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _real(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _half(seed, shape, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _desc(alg, n, radices, vpu):
    d = {"alg": alg, "n": n}
    if radices is not None:
        d["radices"] = radices
    if vpu is not None:
        d["vpu"] = vpu
    return d


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


CASES = [  # (n, radices of the m-point transform, batch, twin's vpu)
    (256, None, 37, None),
    (512, [16, 16], 130, None),              # two stages, ragged batch
    (1024, None, 1, None),
    (512, None, 37, True),                   # butterfly last stage
    (1024, [32, 16], 130, "all"),            # butterflies everywhere
]


@pytest.mark.parametrize("n,radices,b,vpu", CASES)
def test_r2c_twin_matches_reference(n, radices, b, vpu):
    x = _real(n + b, (b, n))
    desc = _desc("pallas_r2c", n, radices, vpu)
    want = np.asarray(jax.jit(PS.build_pallas_r2c(desc, np.float32))(x))
    before = RS.r2c_launches
    yr, yi = RS.build_pallas_r2c(desc, np.float32, "cpu")(_t(x))
    assert RS.r2c_launches == before                    # the twin ran
    got = yr.numpy() + 1j * yi.numpy()
    oracle = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert got.shape == want.shape == (b, n // 2 + 1)
    assert _relerr(got, want) <= TOL_PKG
    assert _relerr(got, oracle) <= TOL_F64
    assert _relerr(want, oracle) <= TOL_F64


@pytest.mark.parametrize("n,radices,b,vpu", CASES)
def test_c2r_twin_matches_reference(n, radices, b, vpu):
    X = _half(n + b, (b, n // 2 + 1))           # DC/Nyquist imag nonzero
    desc = _desc("pallas_c2r", n, radices, vpu)
    want = np.asarray(jax.jit(PS.build_pallas_c2r(desc, np.float32))(X))
    before = RS.c2r_launches
    y = RS.build_pallas_c2r(desc, np.float32, "cpu")(_t(X.real), _t(X.imag))
    assert RS.c2r_launches == before
    got = y.numpy()
    oracle = np.fft.irfft(X.astype(np.complex128), n, axis=-1) * n
    assert got.shape == want.shape == (b, n)
    assert _relerr(got, want) <= TOL_PKG
    assert _relerr(got, oracle) <= TOL_F64
    assert _relerr(want, oracle) <= TOL_F64


def test_r2c_inner_twin_matches_reference():
    x = _real(3, (3, 256, 384))
    want = jax.jit(PS.build_pallas_r2c_inner(
        {"alg": "pallas_r2c_inner", "n": 256}, np.float32))(x)
    want = np.asarray(want[0]) + 1j * np.asarray(want[1])
    yr, yi = RS.build_pallas_r2c_inner({"alg": "pallas_r2c", "n": 256},
                                       np.float32, "cpu")(_t(x))
    got = yr.numpy() + 1j * yi.numpy()
    oracle = np.fft.rfft(x.astype(np.float64), axis=-2)
    assert got.shape == want.shape == (3, 129, 384)
    assert _relerr(got, want) <= TOL_PKG
    assert _relerr(got, oracle) <= TOL_F64


@pytest.mark.parametrize("shape", [(2, 512, 37), (2, 3, 256, 1)])
def test_r2c_inner_twin_unaligned_columns(shape):
    """L not a multiple of the lane tile, and extra leading dims."""
    x = _real(4, shape)
    n = shape[-2]
    yr, yi = RS.build_pallas_r2c_inner({"alg": "pallas_r2c", "n": n},
                                       np.float32, "cpu")(_t(x))
    oracle = np.fft.rfft(x.astype(np.float64), axis=-2)
    assert _relerr(yr.numpy() + 1j * yi.numpy(), oracle) <= TOL_F64


def test_r2c_inner_has_no_gradient():
    """K5 is forward-only, as the reference's build_pallas_r2c_inner."""
    fn = RS.build_pallas_r2c_inner({"alg": "pallas_r2c", "n": 256},
                                   np.float32, "cpu")
    x = torch.randn(1, 256, 128, requires_grad=True)
    yr, yi = fn(x)
    with pytest.raises(NotImplementedError, match="forward-only"):
        (yr.sum() + yi.sum()).backward()


@pytest.mark.parametrize("n,trail", [(256, 128), (512, 384), (4096, 256),
                                     (8192, 128), (254, 128), (256, 130),
                                     (130, 128), (1000, 256), (2, 128)])
def test_gates_equal_reference(n, trail):
    assert RS.r2c_applicable(n, np.float32, "cpu") == \
        PS.r2c_applicable(n, np.float32)
    assert RS.r2c_inner_applicable(n, trail, np.float32, "cpu") == \
        PS.r2c_inner_applicable(n, trail, np.float32)
    assert not RS.r2c_applicable(n, np.float64, "cpu")


def test_real_tables_match_reference_constants():
    """The kernels' w and v tables are the reference kernels' constants,
    bit for bit, and the stage tables are the c2c kernel's."""
    n, radices = 1024, [32, 16]
    m = n // 2
    for sign in (-1, +1):
        tab = RS._real_table(n, radices, sign)
        assert tab.size == RS.table_len(n, radices)
        stage = S.kernel_table(m, radices, sign)
        assert np.array_equal(tab[:stage.size], stage)
        w = np.exp(sign * 2j * np.pi * np.arange(m + 1, dtype=np.int64) / n)
        assert np.array_equal(tab[stage.size:stage.size + m + 1],
                              w.real.astype(np.float32))
        assert np.array_equal(tab[stage.size + m + 1:],
                              w.imag.astype(np.float32))


def test_kernel_wrappers_refuse_cpu_tensors():
    n, radices = 256, [128]
    x = torch.ones(2, n)
    h = torch.ones(2, n // 2 + 1)
    for sign, call in ((-1, lambda t: RS.r2c_cuda(x, radices, t)),
                       (+1, lambda t: RS.c2r_cuda(h, h, radices, t)),
                       (-1, lambda t: RS.r2c_inner_cuda(x[None], radices,
                                                        t))):
        with pytest.raises(ValueError, match="CUDA"):
            call(_t(RS._real_table(n, radices, sign)))
    fn = RS.build_pallas_r2c({"alg": "pallas_r2c", "n": n}, np.float32,
                             "cpu")
    with pytest.raises(ValueError, match="shape"):
        fn(torch.ones(2, n + 2))
    with pytest.raises(ValueError, match="does not fit"):
        RS.build_pallas_r2c({"alg": "pallas_r2c", "n": n,
                             "radices": [16, 16]}, np.float32, "cpu")


def test_r2c_grads_equal_jax_and_torch():
    """K4's backward on split planes, for the real loss
    L(x) = sum Re(r2c(x) * w): equal to JAX's gradient through the
    reference's custom VJP (a real input has one gradient in both
    conventions) and to torch.fft.rfft's autograd."""
    n, b = 512, 3
    x = _real(11, (b, n))
    w = _half(12, (b, n // 2 + 1))
    ref = PS.build_pallas_r2c({"alg": "pallas_r2c", "n": n}, np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.real(ref(a) * w)))(
        jnp.asarray(x)))
    fn = RS.build_pallas_r2c({"alg": "pallas_r2c", "n": n}, np.float32,
                             "cpu")
    xt = _t(x).requires_grad_()
    yr, yi = fn(xt)
    (yr * _t(w.real) - yi * _t(w.imag)).sum().backward()
    assert _relerr(xt.grad.numpy(), want) <= TOL_PKG
    xt2 = _t(x).requires_grad_()
    (torch.fft.rfft(xt2) * _t(w)).real.sum().backward()
    assert _relerr(xt.grad.numpy(), xt2.grad.numpy()) <= TOL_F64


def test_c2r_grads_are_conj_of_jax_and_equal_torch():
    """K6's backward on split planes, for the real loss
    L(X) = sum c2r(X) * g: the complex gradient Xr.grad + i Xi.grad is the
    conjugate of JAX's through the reference's custom VJP (torch's
    convention), equals torch.fft.irfft's autograd (times n), and has zero
    imaginary parts at the DC and Nyquist bins."""
    n, b = 512, 3
    X = _half(13, (b, n // 2 + 1))
    g = _real(14, (b, n))
    ref = PS.build_pallas_c2r({"alg": "pallas_c2r", "n": n}, np.float32)
    want = np.asarray(jax.grad(lambda z: jnp.sum(ref(z) * g))(
        jnp.asarray(X)))
    fn = RS.build_pallas_c2r({"alg": "pallas_c2r", "n": n}, np.float32,
                             "cpu")
    xr = _t(X.real).requires_grad_()
    xi = _t(X.imag).requires_grad_()
    (fn(xr, xi) * _t(g)).sum().backward()
    got = xr.grad.numpy() + 1j * xi.grad.numpy()
    assert _relerr(got, np.conj(want)) <= TOL_PKG
    Xt = _t(X).requires_grad_()
    (torch.fft.irfft(Xt, n) * n * _t(g)).sum().backward()
    assert _relerr(got, Xt.grad.numpy()) <= TOL_F64
    assert not got.imag[:, [0, -1]].any()


SOLVERS = [  # (kind, descriptor without child, child size or None)
    ("r2c", {"alg": "pallas_r2c", "n": 256, "radices": [128]}, None),
    ("r2c", {"alg": "r2c_dense", "n": 96}, None),
    ("r2c", {"alg": "r2c_pack", "n": 96}, 48),
    ("r2c", {"alg": "r2c_via_c2c", "n": 45}, 45),
    ("c2r", {"alg": "pallas_c2r", "n": 256, "radices": [128]}, None),
    ("c2r", {"alg": "c2r_dense", "n": 96}, None),
    ("c2r", {"alg": "c2r_dense", "n": 45}, None),
    ("c2r", {"alg": "c2r_pack", "n": 96}, 48),
    ("c2r", {"alg": "c2r_via_c2c", "n": 45}, 45),
    ("c2r", {"alg": "c2r_via_c2c", "n": 96}, 96),
]


@pytest.mark.parametrize(
    "kind,desc,child,dtype,strict",
    [s + (dt, st) for s in SOLVERS for dt in (np.float32, np.float64)
     for st in ((True, False) if dt == np.float64 else (True,))
     if dt == np.float32 or not s[1]["alg"].startswith("pallas")],
    ids=lambda v: v["alg"] + f"-{v['n']}" if isinstance(v, dict) else None)
def test_solvers_match_reference(kind, desc, child, dtype, strict,
                                 monkeypatch):
    """Every solver of ops/real.py against the reference's on the same
    descriptor: same output, same op counts, and float64 stays float64 (the
    real kernels are float32 only).  The reference's float64 children are
    its true-f64 solvers under ``strict_f64`` and its double-float ``df32``
    solvers without it."""
    monkeypatch.setattr(ref_config, "strict_f64", strict)
    desc = dict(desc)
    if child is not None:
        desc["child"] = ref_planner.the_planner.plan_c2c(child, dtype, 0, 8)
    n = desc["n"]
    tol = TOL_PKG if dtype == np.float32 else 1e-10
    if kind == "r2c":
        x = _real(n, (8, n), dtype)
        want = np.asarray(jax.jit(ref_real.build_r2c(desc, dtype))(x))
        got = real_ops.build_r2c(desc, dtype, "cpu")(_t(x)).numpy()
        assert got.dtype == (np.complex64 if dtype == np.float32
                             else np.complex128)
        oracle = np.fft.rfft(x.astype(np.float64), axis=-1)
        assert _relerr(got, oracle) <= (TOL_F64 if dtype == np.float32
                                        else 1e-12)
        assert real_ops.r2c_opcount(desc) == ref_real.r2c_opcount(desc)
    else:
        ctype = np.complex64 if dtype == np.float32 else np.complex128
        X = _half(n, (8, n // 2 + 1), ctype)
        want = np.asarray(jax.jit(ref_real.build_c2r(desc, dtype))(X))
        got = real_ops.build_c2r(desc, dtype, "cpu")(_t(X)).numpy()
        assert got.dtype == dtype
        oracle = np.fft.irfft(X.astype(np.complex128), n, axis=-1) * n
        assert _relerr(got, oracle) <= (TOL_F64 if dtype == np.float32
                                        else 1e-12)
        assert real_ops.c2r_opcount(desc) == ref_real.c2r_opcount(desc)
    assert _relerr(got, want) <= tol


def test_full_spectrum_matches_reference():
    for n in (8, 9):
        X = _half(n, (3, n // 2 + 1), np.complex128)
        want = np.asarray(ref_real.full_spectrum(jnp.asarray(X), n))
        got = torch.complex(*real_ops.full_spectrum(
            _t(X.real), _t(X.imag), n)).numpy()
        assert got.shape == (3, n) and np.array_equal(got, want)


@pytest.mark.parametrize("n,dim", [(16, -1), (96, -2)])
def test_untangle_along_either_axis(n, dim):
    """The r2c half of the rdft2 pack (``r2c_pack`` and the K4/K5 twins):
    the m-point DFT of x_even + i x_odd, untangled along `dim`, is the half
    spectrum, in float64."""
    x = _real(n, (3, n, 5) if dim == -2 else (3, n), np.float64)
    ev = x[:, 0::2] + 1j * x[:, 1::2]
    z = np.fft.fft(ev, axis=dim)
    wr, wi = real_ops._roots_half(n, -1, np.float64, "cpu")
    if dim == -2:
        wr, wi = wr[:, None], wi[:, None]
    yr, yi = real_ops.untangle(_t(z.real), _t(z.imag), wr, wi, dim)
    assert _relerr(yr.numpy() + 1j * yi.numpy(),
                   np.fft.rfft(x, axis=dim)) <= 1e-12


@pytest.mark.parametrize("n", [16, 96])
def test_tangle_inverts_to_real_rows(n):
    """The c2r half of the pack (``c2r_pack`` and the K6 twin): the
    unnormalized inverse m-point DFT of tangle(X), doubled and interleaved,
    is n x for X = rfft(x), and the imaginary parts of the DC and Nyquist
    bins do not reach it."""
    x = _real(n, (3, n), np.float64)
    X = np.fft.rfft(x, axis=-1)
    X[:, [0, -1]] += 7j
    vr, vi = real_ops._roots_half(n, +1, np.float64, "cpu")
    zr, zi = real_ops.tangle(_t(X.real), _t(X.imag), vr, vi)
    z = np.fft.ifft(zr.numpy() + 1j * zi.numpy(), axis=-1) * (n // 2)
    y = np.stack([2 * z.real, 2 * z.imag], -1).reshape(3, n)
    assert _relerr(y, n * x) <= 1e-12


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_twin_is_the_pack_over_the_c2c_twin(kind):
    """A K4 (K6) twin and the ``r2c_pack`` (``c2r_pack``) solver over a
    ``pallas`` child of the same m-point schedule run one algebra: their
    outputs are equal bit for bit."""
    n, radices = 512, [16, 16]
    child = {"alg": "pallas", "n": n // 2, "radices": radices}
    pack = {"alg": f"{kind}_pack", "n": n, "child": child}
    if kind == "r2c":
        x = _t(_real(31, (5, n)))
        got = RS.r2c_torch(x, radices)
        want = real_ops.build_r2c_split(pack, np.float32, "cpu")(x)
    else:
        X = _half(32, (5, n // 2 + 1))
        xr, xi = _t(X.real), _t(X.imag)
        got = (RS.c2r_torch(xr, xi, radices),)
        want = (real_ops.build_c2r_split(pack, np.float32, "cpu")(xr, xi),)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("b", [1, 37, 130])
def test_kernels_match_twins_on_card(cuda_device, n, b):
    """K4 and K6 against their twins and float64, on the card."""
    radices = S.choose_radices(n // 2)
    x = _t(_real(n + b, (b, n))).to(cuda_device)
    before = RS.r2c_launches, RS.c2r_launches
    kr, ki = RS.r2c_cuda(x, radices, RS.device_table(
        n, tuple(radices), -1, cuda_device))
    tr, ti = RS.r2c_torch(x, radices)
    X = np.fft.rfft(x.cpu().numpy().astype(np.float64), axis=-1)
    got = (kr + 1j * ki).cpu().numpy()
    assert _relerr(got, (tr + 1j * ti).cpu().numpy()) <= TOL_F64
    assert _relerr(got, X) <= TOL_F64
    y = RS.c2r_cuda(kr, ki, radices, RS.device_table(
        n, tuple(radices), +1, cuda_device))
    torch.cuda.synchronize()
    assert (RS.r2c_launches, RS.c2r_launches) == (before[0] + 1,
                                                  before[1] + 1)
    ty = RS.c2r_torch(kr, ki, radices)
    assert _relerr(y.cpu().numpy(), ty.cpu().numpy()) <= TOL_F64
    assert _relerr(y.cpu().numpy(), n * x.cpu().numpy()) <= TOL_F64


K6_CASES = [(1024, [32, 16]), (2048, [64, 16]), (1000, [25, 20]),
            (1792, [56, 16]), (1792, [16, 56]), (4096, [128, 16]),
            (512, [256])]


@pytest.mark.cuda
@pytest.mark.parametrize("n,radices", K6_CASES)
@pytest.mark.parametrize("b", [1, 37, 130])
def test_k6_matches_both_twins_and_float64(cuda_device, n, radices, b):
    """K6 on its register butterfly levels (a dense stage first or last,
    radix-5 levels, one row a group, the DCT-III's [256]) over ragged row
    groups, on random half spectra (Im X[0] and Im X[m] nonzero), against
    the dense twin, the butterfly twin and float64."""
    X = _half(n + b, (b, n // 2 + 1))
    xr, xi = (_t(a.astype(np.float32)).to(cuda_device)
              for a in (X.real, X.imag))
    before = RS.c2r_launches
    y = RS.c2r_cuda(xr, xi, radices, RS.device_table(
        n, tuple(radices), +1, cuda_device))
    torch.cuda.synchronize()
    assert RS.c2r_launches == before + 1
    got = y.cpu().numpy()
    for vpu in (None, "all"):
        twin = RS.c2r_torch(xr, xi, radices, vpu).cpu().numpy()
        assert _relerr(got, twin) <= TOL_F64, vpu
    oracle = np.fft.irfft(X.astype(np.complex128), n, axis=-1) * n
    assert _relerr(got, oracle) <= TOL_F64


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1024, 4096])
@pytest.mark.parametrize("pre,L", [(1, 1), (3, 37), (2, 1025)])
def test_r2c_inner_kernel_matches_twin_on_card(cuda_device, n, pre, L):
    radices = S.choose_radices(n // 2)
    x = _t(_real(n + L, (pre, n, L))).to(cuda_device)
    before = RS.r2c_inner_launches
    kr, ki = RS.r2c_inner_cuda(x, radices, RS.device_table(
        n, tuple(radices), -1, cuda_device))
    torch.cuda.synchronize()
    assert RS.r2c_inner_launches == before + 1
    tr, ti = RS.r2c_inner_torch(x, radices)
    got = (kr + 1j * ki).cpu().numpy()
    assert _relerr(got, (tr + 1j * ti).cpu().numpy()) <= TOL_F64
    assert _relerr(got, np.fft.rfft(x.cpu().numpy().astype(np.float64),
                                    axis=-2)) <= TOL_F64
