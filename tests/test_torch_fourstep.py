"""fftw3_tpu_torch's four-step (``pallas4``: K2 over p, then K1 with the
fused pre-twiddle and, at p = 128, the transposed store) against the
reference.

The same numpy inputs go through ``fftw3_tpu``'s
``build_pallas_c2c_split_fourstep`` and ``_make_call`` (Pallas in
interpret mode on the CPU) and through the port's twins.  Errors are
max-abs error over max-abs: 2e-5 between the packages, 1e-5 for each
against numpy in float64.  Kernel launches are marked ``cuda``.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fftw3_tpu import config as ref_config
from fftw3_tpu import planner as ref_planner
from fftw3_tpu.ops import c2c as ref_c2c
from fftw3_tpu.ops import pallas_stockham as PS

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import config, planner
from fftw3_tpu_torch.ops import c2c, fourstep, inner
from fftw3_tpu_torch.ops import stockham as S

TOL_PKG = 2e-5
TOL_F64 = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    """Kernels on in both packages, and both global planners without
    wisdom that other tests left."""
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


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _oracle(xr, xi, sign):
    x = xr.astype(np.float64) + 1j * xi
    n = x.shape[-1]
    return np.fft.fft(x, axis=-1) if sign < 0 else np.fft.ifft(x, axis=-1) * n


@pytest.mark.parametrize("n,p,q,B", [(4096, 32, 128, 1), (4096, 32, 128, 3),
                                     (16384, 128, 128, 1)])
@pytest.mark.parametrize("sign", [-1, +1])
def test_twin_matches_reference(n, p, q, B, sign):
    assert S.choose_fourstep(n) == PS.choose_fourstep(n) == (p, q)
    desc = {"alg": "pallas4", "n": n, "p": p, "q": q}
    xr, xi = _planes(n + B, (B, n))
    ref = PS.build_pallas_c2c_split_fourstep(desc, sign, np.float32)
    wr, wi = jax.jit(ref)(jnp.asarray(xr), jnp.asarray(xi))
    want = np.asarray(wr) + 1j * np.asarray(wi)
    split = c2c.build_c2c_split(desc, sign, np.float32, "cpu")
    yr, yi = split(torch.from_numpy(xr), torch.from_numpy(xi))
    got = yr.numpy() + 1j * yi.numpy()
    oracle = _oracle(xr, xi, sign)
    assert got.shape == want.shape == (B, n)
    assert _relerr(got, want) <= TOL_PKG
    assert _relerr(got, oracle) <= TOL_F64
    assert _relerr(want, oracle) <= TOL_F64


@pytest.mark.parametrize("n,radices,p,store", [(128, [128], 32, False),
                                               (128, [128], 128, True),
                                               (256, [256], 8, False)])
@pytest.mark.parametrize("sign", [-1, +1])
def test_k1_options_match_reference(n, radices, p, store, sign):
    """K1's pre-twiddle and transposed store against the reference's
    ``_make_call`` options on 256 rows (two of its 128-row tiles)."""
    xr, xi = _planes(n + p, (256, n))
    call = PS._make_call(n, radices, sign, 128, True, pretwiddle_p=p,
                         store_transposed=store)
    wr, wi = jax.jit(call)(jnp.asarray(xr), jnp.asarray(xi))
    want = np.asarray(wr) + 1j * np.asarray(wi)
    yr, yi = S.stockham_c2c_torch(torch.from_numpy(xr), torch.from_numpy(xi),
                                  radices, sign, pretwiddle_p=p,
                                  store_transposed=store)
    got = yr.numpy() + 1j * yi.numpy()
    assert got.shape == want.shape == ((256 // p, n, p) if store
                                       else (256, n))
    assert _relerr(got, want) <= TOL_PKG
    # the pre-twiddle constant is the reference's, bit for bit
    w = S.device_pretwiddle(p, n, sign, torch.device("cpu")).numpy()
    e = np.mod(np.outer(np.arange(p), np.arange(n)), p * n)
    ref_w = np.exp(sign * 2j * np.pi * e / (p * n))
    assert np.array_equal(w[0], ref_w.real.astype(np.float32))
    assert np.array_equal(w[1], ref_w.imag.astype(np.float32))


def test_split_grads_equal_jax_vjp():
    desc = {"alg": "pallas4", "n": 4096, "p": 32, "q": 128}
    xr, xi = _planes(11, (2, 4096))
    gr, gi = _planes(12, (2, 4096))
    ref = PS.build_pallas_c2c_split_fourstep(desc, -1, np.float32)
    _, vjp = jax.vjp(ref, jnp.asarray(xr), jnp.asarray(xi))
    wr, wi = (np.asarray(g) for g in vjp((jnp.asarray(gr), jnp.asarray(gi))))
    split = c2c.build_c2c_split(desc, -1, np.float32, "cpu")
    tr = torch.from_numpy(xr).requires_grad_()
    ti = torch.from_numpy(xi).requires_grad_()
    yr, yi = split(tr, ti)
    torch.autograd.backward([yr, yi], [torch.from_numpy(gr),
                                       torch.from_numpy(gi)])
    assert _relerr(tr.grad.numpy(), wr) <= TOL_PKG
    assert _relerr(ti.grad.numpy(), wi) <= TOL_PKG


@pytest.mark.parametrize("n", [2048, 2560, 3072, 4096, 6144, 8192, 12288,
                               16384, 65536, 262144, 524288, 1 << 20, 4099])
def test_gates_equal_reference(n):
    assert S.choose_fourstep(n) == PS.choose_fourstep(n)
    assert S.fourstep_applicable(n, np.float32, "cpu") == \
        PS.fourstep_applicable(n, np.float32)


@pytest.mark.parametrize("n", [4096, 16384, 262144])
def test_opcount_cost_and_print_equal_reference(n):
    p, q = S.choose_fourstep(n)
    desc = {"alg": "pallas4", "n": n, "p": p, "q": q}
    assert c2c.c2c_opcount(desc) == ref_c2c.c2c_opcount(desc)
    assert planner._c2c_cost(desc, planner.HardwareModel(
        **vars(ref_planner.HW))) == ref_planner._c2c_cost(desc)
    assert planner.sprint_desc(desc) == ref_planner.sprint_desc(desc)
    assert planner.validate_desc("c2c", n, desc)
    assert ref_planner.validate_desc("c2c", n, desc)


@pytest.mark.parametrize("desc", [
    {"alg": "pallas4", "n": 4096, "p": 32, "q": 64},
    {"alg": "pallas4", "n": 4096, "p": 32, "q": 128, "radices": [16, 16]},
    {"alg": "pallas4", "n": 4096, "p": 1, "q": 4096},
    {"alg": "pallas4", "n": 8192, "p": 2, "q": 4096},
    {"alg": "pallas4", "n": 4096, "p": "32", "q": 128}])
def test_validate_refuses_what_cannot_be_built(desc):
    assert not planner.validate_desc("c2c", desc["n"], desc)
    with pytest.raises(ValueError):
        c2c.build_c2c_split(desc, -1, np.float32, "cpu")


def test_fused_store_only_at_the_row_tile():
    """The transposed store runs at p = 128 (and at p = tile_b), the
    separate swap elsewhere: both give the same transform."""
    xr, xi = _planes(13, (1, 16384))
    outs = []
    for tile_b in (None, 256):
        desc = {"alg": "pallas4", "n": 16384, "p": 128, "q": 128}
        if tile_b:
            desc["tile_b"] = tile_b
        split = fourstep.build_pallas_c2c_split_fourstep(desc, -1,
                                                         np.float32, "cpu")
        yr, yi = split(torch.from_numpy(xr), torch.from_numpy(xi))
        outs.append(yr.numpy() + 1j * yi.numpy())
    oracle = _oracle(xr, xi, -1)
    assert all(_relerr(o, oracle) <= TOL_F64 for o in outs)


def _smoke_literal():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke.REFERENCE_WISDOM


def test_chip_smoke_wisdom_literal_is_the_reference_export():
    """The reference-format wisdom that ``chip_smoke.py`` imports equals
    ``fftw3_tpu``'s own export for plan_many_dft([4096], howmany=4096), up
    to the device signature in its key."""
    ref = ref_planner.Planner()
    ref.plan_c2c(4096, np.float32, 0, 4096)
    want = json.loads(ref.export_wisdom())
    got = json.loads(_smoke_literal())
    assert got["format"] == want["format"] == planner.REFERENCE_WISDOM_FORMAT

    def unsigned(entries):
        out = {}
        for key, value in entries.items():
            kind, n, dt, _, bucket = key.split(":")
            out[f"{kind}:{n}:{dt}:{bucket}"] = value
        return out
    assert unsigned(got["entries"]) == unsigned(want["entries"])
    # and the port plans pallas4 from it, ESTIMATE or not
    mine = planner.Planner()
    assert mine.import_reference_wisdom(_smoke_literal(), device="cpu")
    assert mine.plan_c2c(4096, np.float32, 0, 4096, "cpu") == \
        {"alg": "pallas4", "n": 4096, "p": 32, "q": 128}
    assert mine.stats["nplan"] == 0


def test_plan_execute_matches_reference():
    """plan_many_dft([4096], howmany=3) on the reference's hardware
    constants: both packages plan pallas4-32x128 and agree."""
    import fftw3_tpu as ref_ft
    old = ft.the_planner.hw
    ft.the_planner.hw = planner.HardwareModel(**vars(ref_planner.HW))
    try:
        ref = ref_ft.plan_many_dft([4096], howmany=3)
        mine = ft.plan_many_dft([4096], howmany=3, device="cpu")
    finally:
        ft.the_planner.hw = old
    assert mine.descriptors == ref.descriptors == {
        1: {"alg": "pallas4", "n": 4096, "p": 32, "q": 128}}
    assert mine.flops() == ref.flops()
    rng = np.random.default_rng(14)
    x = (rng.standard_normal((3, 4096))
         + 1j * rng.standard_normal((3, 4096))).astype(np.complex64)
    got = mine.execute(x).numpy()
    assert _relerr(got, np.asarray(ref.execute(x))) <= TOL_PKG
    assert _relerr(got, np.fft.fft(x.astype(np.complex128))) <= TOL_F64


@pytest.mark.cuda
@pytest.mark.parametrize("n,radices,p,store", [(128, [128], 32, False),
                                               (128, [128], 128, True),
                                               (1024, [64, 16], 8, False),
                                               (2048, [128, 16], 64, True)])
@pytest.mark.parametrize("sign", [-1, +1])
def test_k1_options_on_card(cuda_device, n, radices, p, store, sign):
    xr, xi = (torch.from_numpy(a).to(cuda_device)
              for a in _planes(n + p, (3 * p, n)))
    before = S.fourstep_launches
    kr, ki = S.stockham_c2c_cuda(
        xr, xi, radices, S.device_table(n, tuple(radices), sign,
                                        cuda_device),
        pretwiddle=S.device_pretwiddle(p, n, sign, cuda_device),
        store_transposed=store)
    torch.cuda.synchronize()
    assert S.fourstep_launches == before + 1
    tr, ti = S.stockham_c2c_torch(xr, xi, radices, sign, pretwiddle_p=p,
                                  store_transposed=store)
    assert kr.shape == tr.shape
    assert _relerr((kr + 1j * ki).cpu().numpy(),
                   (tr + 1j * ti).cpu().numpy()) <= TOL_F64


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(4096, 5), (16384, 2)])
def test_fourstep_on_card(cuda_device, n, B):
    p, q = S.choose_fourstep(n)
    desc = {"alg": "pallas4", "n": n, "p": p, "q": q}
    xr, xi = (torch.from_numpy(a).to(cuda_device)
              for a in _planes(n, (B, n)))
    split = c2c.build_c2c_split(desc, -1, np.float32, cuda_device)
    k1, k2 = S.fourstep_launches, inner.launches
    yr, yi = split(xr, xi)
    torch.cuda.synchronize()
    assert (S.fourstep_launches, inner.launches) == (k1 + 1, k2 + 1)
    got = (yr + 1j * yi).cpu().numpy()
    assert _relerr(got, _oracle(xr.cpu().numpy(), xi.cpu().numpy(),
                                -1)) <= TOL_F64
