"""The slice as a whole: fftw3_tpu_torch plans against fftw3_tpu plans.

Both packages plan and run the same problems on the same numpy input — the
reference with Pallas in interpret mode, the port with its plain twins on
the CPU.  Same descriptors, equal ``flops()``, outputs within 2e-5
(max-abs error over max-abs of the reference), through ``apply_split`` and
through ``execute``.  Multi-axis and four-step plans also take the same
route per axis in both packages (the kernel builders are spied on), and
their complex gradients are the conjugate of JAX's.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftw3_tpu as ref_ft
from fftw3_tpu import config as ref_config
from fftw3_tpu import planner as ref_planner
from fftw3_tpu.ops import pallas_stockham as PS

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import config
from fftw3_tpu_torch.ops import fourstep, fused2d, inner
from fftw3_tpu_torch.ops import stockham as S
from fftw3_tpu_torch.planner import HardwareModel

TOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    """Kernels on in both packages, the port's global planner on the
    reference's hardware constants, so that both search alike, and both
    global planners without wisdom that other tests left."""
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(ft.the_planner, "hw", HardwareModel(
        **dataclasses.asdict(ref_planner.HW)))
    monkeypatch.setattr(ft.the_planner, "wisdom", {})
    monkeypatch.setattr(ref_planner.the_planner, "wisdom", {})


def _relerr(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


MULTI = {  # name -> (maker, route of each kernel builder call, number of
    #          axes lifted by movedim)
    # axis 0 through K2 (trail 256), axis 1 direct behind movedim, axis 2
    # through K1
    "3d_128x2x128": (lambda m, sign: m.plan_dft((128, 2, 128), sign=sign),
                     [("inner", 128), ("last", 128)], 1),
    # the trailing pair through K3
    "many_2d_128x256": (lambda m, sign: m.plan_many_dft([128, 256],
                                                        howmany=2,
                                                        sign=sign),
                        [("2d", 128, 256)], 0),
    # axis 0 through K2 with a masked edge tile (L = 130)
    "axis0_128x130": (lambda m, sign: m.plan_dft((128, 130), axes=(0,),
                                                 sign=sign),
                      [("inner", 128)], 0),
    # the four-step
    "many_4096x3": (lambda m, sign: m.plan_many_dft([4096], howmany=3,
                                                    sign=sign),
                    [("four", 4096)], 0),
}


@pytest.mark.parametrize("make", [
    lambda m, sign: m.plan_many_dft([1024], howmany=64, sign=sign),
    lambda m, sign: m.plan_dft_2d(64, 256, sign=sign),
] + [v[0] for v in MULTI.values()],
    ids=["many_1024x64", "2d_64x256"] + list(MULTI))
@pytest.mark.parametrize("sign", [-1, +1])
def test_plan_matches_reference(make, sign):
    ref = make(ref_ft, sign)
    mine = make(_OnCpu(ft), sign)
    assert mine.descriptors == ref.descriptors
    assert repr(mine) == repr(ref)
    assert mine.flops() == ref.flops()
    assert mine.cost() == ref.cost()
    rng = np.random.default_rng(abs(sign) + 1)
    shape = ref.in_shape
    xr = rng.standard_normal(shape).astype(np.float32)
    xi = rng.standard_normal(shape).astype(np.float32)
    wr, wi = jax.jit(ref.apply_split)(jnp.asarray(xr), jnp.asarray(xi))
    want = np.asarray(wr) + 1j * np.asarray(wi)
    yr, yi = mine.apply_split(torch.from_numpy(xr), torch.from_numpy(xi))
    assert _relerr(yr.numpy() + 1j * yi.numpy(), want) <= TOL
    x = (xr + 1j * xi).astype(np.complex64)
    y = mine.execute(x)
    assert y.dtype == torch.complex64 and tuple(y.shape) == shape
    assert _relerr(y.numpy(), np.asarray(ref.execute(x))) <= TOL
    axes = tuple(mine.problem.axes)
    oracle = np.fft.fftn(x.astype(np.complex128), axes=axes) if sign < 0 \
        else np.fft.ifftn(x.astype(np.complex128), axes=axes) \
        * np.prod([shape[a] for a in axes])
    assert _relerr(y.numpy(), oracle) <= 1e-5


class _OnCpu:
    """The port's API with ``device="cpu"`` bound, so one lambda builds a
    plan in either package."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        fn = getattr(self._mod, name)
        return lambda *a, **k: fn(*a, device="cpu", **k)


def test_wrong_shape_raises():
    p = ft.plan_many_dft([256], howmany=4, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        p.execute(torch.zeros(4, 128, dtype=torch.complex64))
    with pytest.raises(ValueError, match="shape"):
        p.execute(np.zeros((5, 256), np.complex64))
    with pytest.raises(ValueError, match="shape"):
        p.apply_split(torch.zeros(4, 128), torch.zeros(4, 128))


def test_leading_batch_dims_through_apply():
    p = ft.plan_many_dft([512], howmany=2, device="cpu")
    x = torch.randn(3, 2, 512, dtype=torch.complex64)
    y = p.apply(x)
    want = np.fft.fft(x.numpy().astype(np.complex128), axis=-1)
    assert _relerr(y.numpy(), want) <= 1e-5


def test_import_leaves_jax_out():
    code = ("import sys, fftw3_tpu_torch, fftw3_tpu_torch.ops._build, "
            "fftw3_tpu_torch.guru, fftw3_tpu_torch.harness.cli, "
            "fftw3_tpu_torch.harness.fuzz, fftw3_tpu_torch.harness.accuracy, "
            "fftw3_tpu_torch.harness.paranoid, "
            "fftw3_tpu_torch.interfaces.numpy_fft, "
            "fftw3_tpu_torch.interfaces.scipy_fft, "
            "fftw3_tpu_torch.tools.wisdom, "
            "fftw3_tpu_torch.tools.wisdom_to_conf; "
            "bad = [m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'fftw3_tpu.'))"
            " or m == 'fftw3_tpu']; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _spy(monkeypatch, calls):
    """Record each kernel builder call of both packages as a route tuple,
    keyed by package."""
    def wrap(mod, name, pkg, route):
        real = getattr(mod, name)

        def spy(*a, **k):
            calls[pkg].append(route(*a, **k))
            return real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    for pkg, m_in, m_2d, m_last, m_four in (
            ("ref", PS, PS, PS, PS),
            ("port", inner, fused2d, S, fourstep)):
        wrap(m_in, "build_pallas_c2c_split_inner", pkg,
             lambda desc, *a, **k: ("inner", desc["n"]))
        wrap(m_2d, "build_pallas_c2c_split_2d", pkg,
             lambda n1, n2, *a, **k: ("2d", n1, n2))
        wrap(m_last, "build_pallas_c2c_split", pkg,
             lambda desc, *a, **k: ("last", desc["n"]))
        wrap(m_four, "build_pallas_c2c_split_fourstep", pkg,
             lambda desc, *a, **k: ("four", desc["n"]))


@pytest.mark.parametrize("name", list(MULTI))
def test_routes_equal_reference(name, monkeypatch):
    """Each axis takes the same kernel route in both packages, and a
    movedim lift appears only where the reference has one."""
    make, route, lifts = MULTI[name]
    calls = {"ref": [], "port": []}
    _spy(monkeypatch, calls)
    ref = make(ref_ft, -1)
    mine = make(_OnCpu(ft), -1)
    assert mine.descriptors == ref.descriptors
    assert calls["port"] == calls["ref"] == route
    moved = []
    real_movedim = torch.Tensor.movedim
    monkeypatch.setattr(torch.Tensor, "movedim", lambda t, *a: (
        moved.append(a), real_movedim(t, *a))[1])
    shape = ref.in_shape
    mine.apply_split(torch.zeros(shape), torch.zeros(shape))
    assert len(moved) == 4 * lifts          # two planes, there and back


@pytest.mark.parametrize("name", ["3d_128x2x128", "many_2d_128x256",
                                  "many_4096x3"])
def test_complex_grads_are_conj_of_jax(name):
    make = MULTI[name][0]
    ref = make(ref_ft, -1)
    mine = make(_OnCpu(ft), -1)
    shape = ref.in_shape
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    w = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    g_jax = np.asarray(jax.grad(
        lambda z: jnp.sum(jnp.real(ref.apply(z) * w)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (mine.execute(xt) * torch.from_numpy(w)).real.sum().backward()
    assert _relerr(xt.grad.numpy(), np.conj(g_jax)) <= TOL


def test_leading_batch_dims_through_multiaxis_routes():
    """Right-relative axes: extra leading dims pass through K2 and K3."""
    config.kernel_mode = "on"
    for p in (ft.plan_dft((128, 2, 128), device="cpu"),
              ft.plan_many_dft([128, 256], howmany=1, device="cpu")):
        x = torch.randn((2,) + p.in_shape, dtype=torch.complex64)
        y = p.apply(x)
        axes = tuple(a + 1 for a in p.problem.axes)
        want = np.fft.fftn(x.numpy().astype(np.complex128), axes=axes)
        assert _relerr(y.numpy(), want) <= 1e-5
