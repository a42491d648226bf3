"""``fftw3_tpu_torch.guru`` (guru, guru64, split and advanced "many"
layouts) against ``fftw3_tpu.guru``.

The cases of ``tests/test_api_parity.py`` and ``tests/test_round2_fixes.py``
(iodim strides on both sides, the element offset, ``out=``), run through
both packages on the same seeded numpy inputs (the reference with Pallas
in interpret mode, the port on the CPU with its kernel twins and the
planner on the reference's hardware constants): within 2e-5 of max |ref|,
and against numpy in float64.  The port reads and writes flat buffers
through ``as_strided`` views and writes a caller's ``out=`` in place;
where the reference's functional scatter silently drops what falls outside
a caller's buffer, the port raises.
"""
import dataclasses

import numpy as np
import pytest
import torch

import fftw3_tpu as ref_ft
from fftw3_tpu import config as ref_config
from fftw3_tpu import guru as ref_guru
from fftw3_tpu import planner as ref_planner
from fftw3_tpu.ops import matrices as ref_matrices

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import config, guru
from fftw3_tpu_torch.planner import HardwareModel

TOL = 2e-5


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    """Kernels on in both packages, the port's planner on the reference's
    hardware constants, no wisdom, the port on the CPU."""
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(ft.the_planner, "hw", HardwareModel(
        **dataclasses.asdict(ref_planner.HW)))
    monkeypatch.setattr(ft.the_planner, "wisdom", {})
    monkeypatch.setattr(ref_planner.the_planner, "wisdom", {})


def _relerr(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _randc(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _check(got, ref, want):
    got = _np(got)
    assert got.shape == np.shape(ref) == np.shape(want)
    assert _relerr(got, ref) <= TOL
    assert _relerr(got, want) <= TOL


def test_guru_dft_iodims():
    rng = np.random.default_rng(0)
    x = _randc(rng, (3, 16, 8))
    dims, hm = [(16,), (8,)], [(3,)]
    p = ft.plan_guru_dft([guru.iodim(*d) for d in dims],
                         [guru.iodim(*d) for d in hm])
    r = ref_ft.plan_guru_dft([ref_guru.iodim(*d) for d in dims],
                             [ref_guru.iodim(*d) for d in hm])
    assert isinstance(p, ft.Plan) and p.problem == ft.Problem(
        (3, 16, 8), (1, 2), "c2c")
    _check(p.execute(x), r.execute(x), np.fft.fft2(x, axes=(1, 2)))


@pytest.mark.parametrize("n", [32, 256])
def test_guru_r2c_c2r_r2r(n):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, n)).astype(np.float32)
    pf, pb = ft.plan_guru_dft_r2c([n], [4]), ft.plan_guru_dft_c2r([n], [4])
    rf, rb = ref_ft.plan_guru_dft_r2c([n], [4]), \
        ref_ft.plan_guru_dft_c2r([n], [4])
    X = pf.execute(x)
    _check(X, rf.execute(x), np.fft.rfft(x.astype(np.float64), axis=-1))
    _check(pb.execute(X), rb.execute(np.asarray(rf.execute(x))),
           n * x.astype(np.float64))
    p = ft.plan_guru_r2r([n], ["redft10"], [2])
    r = ref_ft.plan_guru_r2r([n], ["redft10"], [2])
    _check(p.execute(x[:2]), r.execute(x[:2]),
           x[:2].astype(np.float64) @ ref_matrices.r2r_matrix("redft10", n))


def test_guru64_aliases():
    assert ft.plan_guru64_dft is ft.plan_guru_dft
    assert ft.plan_guru64_split_dft is ft.plan_guru_split_dft
    assert ft.plan_guru64_split_dft_r2c is ft.plan_guru_split_dft_r2c
    assert ft.iodim64 is ft.iodim


@pytest.mark.parametrize("sign", [ft.FORWARD, ft.BACKWARD])
def test_split_guru(sign):
    rng = np.random.default_rng(2)
    xr = rng.standard_normal((2, 128)).astype(np.float32)
    xi = rng.standard_normal((2, 128)).astype(np.float32)
    sp = ft.plan_guru_split_dft([128], [2], sign)
    rp = ref_ft.plan_guru_split_dft([128], [2], sign)
    yr, yi = sp.execute(xr, xi)
    rr, ri = rp.execute(xr, xi)
    x = xr + 1j * xi.astype(np.float64)
    want = np.fft.fft(x, axis=-1) if sign < 0 \
        else np.fft.ifft(x, axis=-1) * 128
    _check(torch.complex(yr, yi), np.asarray(rr) + 1j * np.asarray(ri),
           want)
    with pytest.raises(ValueError, match="shape"):
        sp.execute(xr[:1], xi[:1])


def test_split_execute_runs_apply_split_alone(monkeypatch):
    """execute_split_dft and the split plans call ``apply_split`` only:
    the complex entry point (and its conversion passes) never runs."""
    rng = np.random.default_rng(3)
    xr = rng.standard_normal((4, 64)).astype(np.float32)
    xi = rng.standard_normal((4, 64)).astype(np.float32)
    pc = ft.plan_dft((4, 64), axes=(1,))

    def boom(x):
        raise AssertionError("the complex entry point ran")
    monkeypatch.setattr(pc, "_apply", boom)
    yr, yi = ft.execute_split_dft(pc, xr, xi)
    rr, ri = ref_ft.execute_split_dft(ref_ft.plan_dft((4, 64), axes=(1,)),
                                      xr, xi)
    _check(torch.complex(yr, yi), np.asarray(rr) + 1j * np.asarray(ri),
           np.fft.fft(xr + 1j * xi.astype(np.float64), axis=-1))
    sp = ft.plan_guru_split_dft([64], [4])
    monkeypatch.setattr(sp._plan, "_apply", boom)
    yr2, yi2 = ft.execute_split_dft(sp, xr, xi)
    assert torch.equal(yr2, yr) and torch.equal(yi2, yi)


def test_guru_split_r2c_c2r():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    yr, yi = ft.plan_guru_split_dft_r2c([32], [3]).execute(x)
    rr, ri = ref_ft.plan_guru_split_dft_r2c([32], [3]).execute(x)
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    _check(torch.complex(yr, yi), np.asarray(rr) + 1j * np.asarray(ri),
           want)
    y = ft.plan_guru_split_dft_c2r([32], [3]).execute(yr, yi)
    r = ref_ft.plan_guru_split_dft_c2r([32], [3]).execute(
        np.asarray(rr), np.asarray(ri))
    _check(y, r, 32 * x.astype(np.float64))


class TestMany:
    def test_inembed(self):
        rng = np.random.default_rng(5)
        x = _randc(rng, (3, 20))
        p = guru.plan_many_dft([16], howmany=3, inembed=[20])
        r = ref_guru.plan_many_dft([16], howmany=3, inembed=[20])
        assert p.in_shape == r.in_shape == (3, 20)
        _check(p.execute(x), r.execute(x),
               np.fft.fft(x[:, :16].astype(np.complex128), axis=-1))
        ar, ai = p.apply_split(torch.from_numpy(x.real.copy()),
                               torch.from_numpy(x.imag.copy()))
        _check(torch.complex(ar, ai), r.execute(x),
               np.fft.fft(x[:, :16].astype(np.complex128), axis=-1))

    def test_onembed_zero_outside(self):
        rng = np.random.default_rng(6)
        x = _randc(rng, (2, 128))
        p = guru.plan_many_dft([128], howmany=2, onembed=[140])
        r = ref_guru.plan_many_dft([128], howmany=2, onembed=[140])
        y, ry = _np(p.execute(x)), np.asarray(r.execute(x))
        assert y.shape == ry.shape == (2, 140)
        _check(y[:, :128], ry[:, :128],
               np.fft.fft(x.astype(np.complex128), axis=-1))
        assert np.all(y[:, 128:] == 0)

    def test_many_r2c_c2r_r2r(self):
        rng = np.random.default_rng(7)
        x = rng.standard_normal((5, 36)).astype(np.float32)
        p = ft.plan_many_dft_r2c([32], howmany=5, inembed=[36],
                                 onembed=[20])
        r = ref_ft.plan_many_dft_r2c([32], howmany=5, inembed=[36],
                                     onembed=[20])
        y = _np(p.execute(x))
        assert y.shape == (5, 20) and np.all(y[:, 17:] == 0)
        _check(y[:, :17], np.asarray(r.execute(x))[:, :17],
               np.fft.rfft(x[:, :32].astype(np.float64), axis=-1))
        X = y[:, :17].astype(np.complex64)
        pb = ft.plan_many_dft_c2r([32], howmany=5)
        rb = ref_ft.plan_many_dft_c2r([32], howmany=5)
        _check(pb.execute(X), rb.execute(X), 32 * x[:, :32].astype(
            np.float64))
        p = ft.plan_many_r2r([16], howmany=3, kinds=["dht"])
        r = ref_ft.plan_many_r2r([16], howmany=3, kinds=["dht"])
        _check(p.execute(x[:3, :16]), r.execute(x[:3, :16]),
               x[:3, :16].astype(np.float64)
               @ ref_matrices.r2r_matrix("dht", 16))

    def test_bad_embed(self):
        with pytest.raises(ValueError):
            guru.plan_many_dft([16], howmany=1, inembed=[8])
        with pytest.raises(ValueError):
            guru.plan_many_dft([16], howmany=1, onembed=[8])
        p = guru.plan_many_dft([16], howmany=2, inembed=[20])
        with pytest.raises(ValueError):
            p.execute(np.zeros((2, 16), np.complex64))


def test_execute_kind_checks():
    rng = np.random.default_rng(8)
    pc, pr = ft.plan_dft_1d(16), ft.plan_dft_r2c_1d(16)
    x = _randc(rng, (16,))
    assert ft.execute_dft(pc, x).shape == (16,)
    for fn, plan, args in [
            (ft.execute_dft, pr, (rng.standard_normal(16),)),
            (ft.execute_dft_r2c, pc, (x,)),
            (ft.execute_dft_c2r, pc, (x,)),
            (ft.execute_r2r, pc, (x,)),
            (ft.execute_split_dft, pr, (x.real, x.imag)),
            (ft.execute_split_dft_r2c, pc, (x.real,)),
            (ft.execute_split_dft_c2r, pr, (x.real, x.imag))]:
        with pytest.raises(ValueError, match="requires"):
            fn(plan, *args)


def test_strided_input_flat_buffer():
    rng = np.random.default_rng(9)
    n, stride = 16, 3
    flat = _randc(rng, n * stride)
    p = ft.plan_guru_dft([guru.iodim(n, stride)])
    r = ref_ft.plan_guru_dft([ref_guru.iodim(n, stride)])
    assert isinstance(p, guru.StridedGuruPlan)
    _check(p.execute(flat), r.execute(flat),
           np.fft.fft(flat[::stride][:n].astype(np.complex128)))
    # batched: 4 transforms at distance 1, elements at stride 4
    flat2 = _randc(rng, n * 4)
    p2 = ft.plan_guru_dft([guru.iodim(n, 4)], [guru.iodim(4, 1)])
    r2 = ref_ft.plan_guru_dft([ref_guru.iodim(n, 4)], [ref_guru.iodim(4, 1)])
    _check(p2.execute(flat2), r2.execute(flat2),
           np.fft.fft(flat2.reshape(n, 4).T.astype(np.complex128), axis=-1))


class TestOutputStrides:
    def test_scatter_into_fresh_buffer(self):
        rng = np.random.default_rng(10)
        n, b = 8, 3
        p = ft.plan_guru_dft([guru.iodim(n, 0, 2)], [guru.iodim(b, 0, 16)])
        r = ref_guru.plan_guru_dft([ref_guru.iodim(n, 0, 2)],
                                   [ref_guru.iodim(b, 0, 16)])
        x = _randc(rng, (b, n))
        y, ry = _np(p.execute(x.reshape(-1))), np.asarray(r.execute(
            x.reshape(-1)))
        assert p.out_size == r.out_size == y.size == 47
        idx = 16 * np.arange(b)[:, None] + 2 * np.arange(n)[None, :]
        _check(y[idx], ry[idx], np.fft.fft(x.astype(np.complex128), axis=1))
        mask = np.ones(47, bool)
        mask[idx.ravel()] = False
        assert np.all(y[mask] == 0) and np.all(ry[mask] == 0)

    def test_into_callers_buffer_in_place(self):
        rng = np.random.default_rng(11)
        n = 8
        p = ft.plan_guru_dft([guru.iodim(n, 0, 3)])
        r = ref_guru.plan_guru_dft([ref_guru.iodim(n, 0, 3)])
        x = _randc(rng, n)
        sentinel = np.full(p.out_size, 7.0 + 0j, np.complex64)
        ry = np.asarray(r.execute(x, out=sentinel.copy()))
        got = p.execute(x, out=sentinel)
        # written in place: the numpy buffer itself holds the result
        assert np.shares_memory(_np(got), sentinel)
        np.testing.assert_array_equal(sentinel[1::3], 7.0)
        _check(sentinel[0::3], ry[0::3],
               np.fft.fft(x.astype(np.complex128)))
        np.testing.assert_array_equal(np.delete(sentinel, np.s_[0::3]),
                                      np.delete(ry, np.s_[0::3]))
        t = torch.full((p.out_size,), 5.0 + 0j, dtype=torch.complex64)
        assert p.execute(x, out=t) is t

    def test_input_strides_still_work(self):
        rng = np.random.default_rng(12)
        n = 16
        p = ft.plan_guru_dft([guru.iodim(n, 2, 0)])
        r = ref_guru.plan_guru_dft([ref_guru.iodim(n, 2, 0)])
        buf = _randc(rng, 2 * n)
        _check(p.execute(buf), r.execute(buf),
               np.fft.fft(buf[0::2].astype(np.complex128)))

    def test_offset_fresh_buffer_ignores_it(self):
        """The reference's rule: a fresh output buffer has no surrounding
        context, so the offset moves the input only."""
        rng = np.random.default_rng(13)
        p = ft.plan_guru_dft([guru.iodim(4, 1, 2)])
        r = ref_guru.plan_guru_dft([ref_guru.iodim(4, 1, 2)])
        x = _randc(rng, 5)
        y, ry = _np(p.execute(x, offset=1)), np.asarray(
            r.execute(x, offset=1))
        assert y.shape == ry.shape == (7,)
        _check(y[0::2], ry[0::2], np.fft.fft(x[1:5].astype(np.complex128)))

    def test_offset_into_callers_buffer(self):
        rng = np.random.default_rng(14)
        p = ft.plan_guru_dft([guru.iodim(4, 1, 2)], [guru.iodim(2, 4, 8)])
        r = ref_guru.plan_guru_dft([ref_guru.iodim(4, 1, 2)],
                                   [ref_guru.iodim(2, 4, 8)])
        x = _randc(rng, 12)
        out = np.full(20, 3.0 + 0j, np.complex64)
        ry = np.asarray(r.execute(x, offset=2, out=out.copy()))
        y = _np(p.execute(x, offset=2, out=out))
        want = np.fft.fft(x[2:10].reshape(2, 4).astype(np.complex128),
                          axis=-1)
        idx = 2 + 8 * np.arange(2)[:, None] + 2 * np.arange(4)[None, :]
        _check(y[idx], ry[idx], want)
        np.testing.assert_array_equal(np.delete(y, idx.ravel()),
                                      np.delete(ry, idx.ravel()))

    def test_buffer_edges_raise(self):
        """Past a buffer's end the reference's scatter drops elements and
        its gather clamps; the port raises."""
        p = ft.plan_guru_dft([guru.iodim(4, 1, 2)])
        x = np.zeros(5, np.complex64)
        with pytest.raises(ValueError, match="too small"):
            p.execute(x, offset=2)                # reads x[2:6]
        with pytest.raises(ValueError, match="too small"):
            p.execute(x, offset=1, out=np.zeros(7, np.complex64))
        p.execute(x, offset=1, out=np.zeros(8, np.complex64))
        with pytest.raises(ValueError, match="complex64"):
            p.execute(x, out=np.zeros(7, np.complex128))
        with pytest.raises(ValueError, match="negative"):
            ft.plan_guru_dft([guru.iodim(4, -1)])
