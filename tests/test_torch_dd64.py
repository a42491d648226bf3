"""fftw3_tpu_torch's dd64 (double-double) tier against the reference's.

The oracle problem is the reference's (``tests/test_dd64.py``): numpy's
complex128 FFT is 14 orders too coarse for a ~1e-30 transform, so results
are rebuilt as hi + lo in mpmath and compared there, against the
reference's ``apply_dd`` on the same planes and against a 50-digit mpmath
DFT, both within 1e-28 (max-abs over max-abs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftw3_tpu as ref_ft

import fftw3_tpu_torch as ft
from fftw3_tpu_torch.ops import dd64

mpmath = pytest.importorskip("mpmath")

TOL = 1e-28


def _planes(seed, shape):
    """Four f64 planes of a genuine dd input: lo planes with bits set."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) * s for s in (1.0, 1e-17, 1.0, 1e-17)]


def _mp(planes):
    """hi + lo of every point, exactly, as mpmath (re, im) pairs."""
    rh, rl, ih, il = (np.asarray(p).reshape(-1) for p in planes)
    return [(mpmath.mpf(float(a)) + mpmath.mpf(float(b)),
             mpmath.mpf(float(c)) + mpmath.mpf(float(d)))
            for a, b, c, d in zip(rh, rl, ih, il)]


def _err(got, want):
    num = max(abs(g[0] - w[0]) + abs(g[1] - w[1]) for g, w in zip(got, want))
    return float(num / max(abs(w[0]) + abs(w[1]) for w in want))


def _mp_dft(z, sign):
    """50-digit DFT of one row of mpmath (re, im) pairs."""
    n = len(z)
    roots = [(mpmath.cospi(mpmath.mpf(2 * e) / n),
              mpmath.sinpi(mpmath.mpf(2 * e) / n) * sign) for e in range(n)]
    out = []
    for k in range(n):
        sr = si = mpmath.mpf(0)
        for j, (xr, xi) in enumerate(z):
            c, s = roots[(j * k) % n]
            sr += xr * c - xi * s
            si += xr * s + xi * c
        out.append((sr, si))
    return out


def _ref_dd(apply_dd, planes):
    """The reference's ``apply_dd`` op by op: each primitive is compiled
    once per shape in the process, so the two signs of one n share that
    cost, where a compile of the whole unrolled graph costs each case
    more than running it."""
    with jax.disable_jit():
        return [np.asarray(v) for v in apply_dd(*planes)]


def _port(plan, planes):
    return [v.numpy() for v in
            plan.apply_dd(*(torch.from_numpy(p) for p in planes))]


@pytest.mark.parametrize("n", [16, 30, 64])
@pytest.mark.parametrize("sign", [-1, +1])
def test_dd_plan_matches_reference_and_mpmath(n, sign):
    mpmath.mp.dps = 50
    planes = _planes(n, (2, n))
    mine = _port(ft.plan_dft_1d_q(n, sign, device="cpu"), planes)
    ref = _ref_dd(ref_ft.plan_dft_1d_q(n, sign).apply_dd, planes)
    assert all(v.dtype == np.float64 and v.shape == (2, n) for v in mine)
    assert _err(_mp(mine), _mp(ref)) <= TOL
    z = _mp(planes)
    oracle = _mp_dft(z[:n], sign) + _mp_dft(z[n:], sign)
    assert _err(_mp(mine), oracle) <= TOL


def test_dd_plan_nd_matches_reference():
    """Rank 3 over axes (1, 2) with a leading batch axis, and rank 2 over
    every axis through ``execute`` on clongdouble."""
    mpmath.mp.dps = 50
    planes = _planes(3, (2, 12, 10))
    mine = _port(ft.plan_dft_q((2, 12, 10), axes=(1, 2), device="cpu"),
                 planes)
    ref = _ref_dd(ref_ft.plan_dft_q((2, 12, 10), axes=(1, 2)).apply_dd,
                  planes)
    assert _err(_mp(mine), _mp(ref)) <= TOL
    x = (np.random.default_rng(4).standard_normal((12, 16))
         + 1j * np.random.default_rng(5).standard_normal((12, 16))
         ).astype(np.clongdouble)
    x += x * np.longdouble(1e-17)
    got = ft.plan_dft_l((12, 16), device="cpu").execute(x)
    want = ref_ft.plan_dft_l((12, 16)).execute(x)
    assert got.dtype == np.clongdouble
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-18


def test_execute_clongdouble_matches_reference():
    n = 48
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
         ).astype(np.clongdouble)
    x += x * np.longdouble(1e-17)             # bits below float64
    got = ft.plan_dft_1d_l(n, device="cpu").execute(x)
    want = ref_ft.plan_dft_1d_l(n).execute(x)
    assert got.dtype == np.clongdouble and got.shape == (2, n)
    # the container's eps (x86 80-bit: 1.1e-19) bounds what both return
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-18
    ref = np.fft.fft(x.astype(np.complex128))
    assert np.max(np.abs(got.astype(np.complex128) - ref)) \
        / np.max(np.abs(ref)) < 1e-13


def test_adjoint_matches_reference():
    """The backward is the opposite-sign dd transform of the four cotangent
    planes, as the reference's custom VJP: equal gradients on real planes."""
    n = 16
    planes = _planes(8, (n,))
    g = _planes(9, (n,))
    ref = ref_ft.plan_dft_1d_q(n)
    _, vjp = jax.vjp(ref.apply_dd, *(jnp.asarray(p) for p in planes))
    want = [np.asarray(v) for v in vjp(tuple(jnp.asarray(v) for v in g))]
    mine = ft.plan_dft_1d_q(n, device="cpu")
    xs = [torch.from_numpy(p).requires_grad_() for p in planes]
    torch.autograd.backward(list(mine.apply_dd(*xs)),
                            [torch.from_numpy(v) for v in g])
    assert _err(_mp([x.grad.numpy() for x in xs]), _mp(want)) <= TOL
    # a loss on one output plane: the other cotangents are zeros
    x0 = torch.from_numpy(planes[0]).requires_grad_()
    mine.apply_dd(x0, *(torch.zeros(n, dtype=torch.float64)
                        for _ in range(3)))[0].sum().backward()
    j, k = np.arange(n)[:, None], np.arange(n)[None, :]
    np.testing.assert_allclose(x0.grad.numpy(),
                               np.cos(2 * np.pi * j * k / n).sum(axis=1),
                               atol=1e-12)


def test_batch_dims_and_gates():
    p = ft.plan_dft_1d_q(16, device="cpu")
    planes = [torch.from_numpy(v) for v in _planes(10, (3, 2, 16))]
    out = p.apply_dd(*planes)
    assert all(v.shape == (3, 2, 16) for v in out)
    one = p.apply_dd(*(v[1, 0] for v in planes))
    assert torch.equal(out[0][1, 0], one[0])
    with pytest.raises(ValueError, match="2-3-5-smooth"):
        ft.plan_dft_1d_q(14, device="cpu")
    assert not dd64.dd64_applicable(1) and dd64.dd64_applicable(720)
    assert ft.DdPlan(16, device="cpu").flops() == \
        ref_ft.DdPlan(16).flops()
    assert repr(ft.plan_dft_1d_l(16, device="cpu")) == \
        repr(ref_ft.plan_dft_1d_l(16))
    assert isinstance(ft.plan_dft_l((4, 6), device="cpu"), ft.DdPlanNd)


def test_cuda_plan_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card here")
    with pytest.raises(RuntimeError, match="no CUDA"):
        ft.plan_dft_1d_q(16, device="cuda")


@pytest.mark.cuda
def test_dd_plan_on_card_equals_cpu():
    """apply_dd on CUDA tensors gives the CPU plan's planes (the same f64
    operations in the same order), within 1e-28 in mpmath."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    mpmath.mp.dps = 50
    planes = _planes(11, (4, 64))
    cpu = _port(ft.plan_dft_1d_q(64, device="cpu"), planes)
    card = [v.cpu().numpy() for v in ft.plan_dft_1d_q(64, device="cuda")
            .apply_dd(*(torch.from_numpy(p).cuda() for p in planes))]
    assert _err(_mp(card), _mp(cpu)) <= TOL
