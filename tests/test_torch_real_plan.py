"""The real-transform slice as a whole: fftw3_tpu_torch's r2c/c2r planner
and plans against fftw3_tpu's.

Both packages plan and run the same problems on the same numpy input — the
reference with Pallas in interpret mode, the port with its plain twins on
the CPU and the port's global planner on the reference's hardware
constants.  Same descriptors, the same kernel route per axis (each call
that builds a kernel apply is recorded in both packages), equal ``flops()``, outputs within 2e-5
(max-abs error over max-abs) of the reference and 1e-5 of numpy in float64;
the swapped option too; gradients equal to JAX's for r2c and the
conjugate of JAX's for c2r.
"""
import dataclasses
import json

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
from fftw3_tpu_torch import config, kinds, planner
from fftw3_tpu_torch.ops import inner, real_stockham
from fftw3_tpu_torch.ops import stockham as S

TOL = 2e-5


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    """Kernels on in both packages, the port's global planner on the
    reference's hardware constants, both global planners without wisdom,
    both packages' real options off (the port has only ``r2c_swapped``)
    and their double-float tiers on (``strict_f64`` off)."""
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    for cfg in (config, ref_config):
        monkeypatch.setattr(cfg, "strict_f64", False)
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(ft.the_planner, "hw", _ref_hw())
    monkeypatch.setattr(ft.the_planner, "wisdom", {})
    monkeypatch.setattr(ref_planner.the_planner, "wisdom", {})
    monkeypatch.setattr(ref_config, "r2c_dc_nyquist_pack", False)
    for cfg in (config, ref_config):
        monkeypatch.setattr(cfg, "r2c_swapped", False)


def _ref_hw():
    return planner.HardwareModel(**dataclasses.asdict(ref_planner.HW))


def _relerr(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the planner ----------------------------------------------------------

@pytest.mark.parametrize("port_mode,ref_mode", [("on", "interpret"),
                                                ("auto", "auto")])
def test_estimate_descriptors_equal_reference(port_mode, ref_mode):
    config.kernel_mode = port_mode
    ref_config.pallas_mode = ref_mode
    mine = planner.Planner(_ref_hw())
    ref = ref_planner.Planner()
    for n in range(2, 4097):
        for kind in ("r2c", "c2r"):
            want = ref._plan(kind, n, np.float32, 0, 64)
            got = mine._plan(kind, n, np.float32, 0, 64, "cpu")
            assert got == want, (kind, n)
    assert planner.sprint_desc(got) == ref_planner.sprint_desc(want)


#: the port's own H100 model (planner.HardwareModel()) with kernels offered
PORT_DEFAULT = {
    256: "{kind}_dense",
    512: "{kind}_pack",            # mixed-16 child: no real kernel at 512
    1024: "pallas_{kind}",
    2048: "pallas_{kind}",
    4096: "pallas_{kind}",
}


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_port_default_choices(kind):
    """ESTIMATE on the port's default constants: K4/K6 at n = 1024-4096,
    and no real kernel at 512 (the half-size pack over ``mixed-16``) or
    256 (dense)."""
    pl = planner.Planner()
    for n, alg in PORT_DEFAULT.items():
        d = pl._plan(kind, n, np.float32, 0, 8 * 2048, "cpu")
        assert d["alg"] == alg.format(kind=kind), (n, d)
        if d["alg"].startswith("pallas"):
            assert d["radices"] == S.choose_radices(n // 2)
    assert pl.plan_r2c(512, np.float32, 0, 64, "cpu")["child"]["alg"] == \
        "mixed"
    config.kernel_mode = "auto"
    d = planner.Planner().plan_r2c(1024, np.float32, 0, 64, "cpu")
    assert d["alg"] == "r2c_pack"          # kernels left out on the CPU


@pytest.mark.parametrize("kind,n,desc,ok", [
    ("r2c", 1024, {"alg": "pallas_r2c", "n": 1024, "radices": [32, 16]},
     True),
    ("c2r", 4096, {"alg": "pallas_c2r", "n": 4096, "radices": [128, 16]},
     True),
    ("r2c", 1024, {"alg": "pallas_c2r", "n": 1024, "radices": [32, 16]},
     False),
    ("r2c", 1024, {"alg": "pallas_r2c", "n": 1024, "radices": [64, 16]},
     False),
    ("r2c", 8192, {"alg": "pallas_r2c", "n": 8192, "radices": [256, 16]},
     False),
    ("c2r", 45, {"alg": "c2r_dense", "n": 45}, True),
    ("r2c", 96, {"alg": "r2c_pack", "n": 96,
                 "child": {"alg": "direct", "n": 48}}, True),
    ("r2c", 95, {"alg": "r2c_pack", "n": 95,
                 "child": {"alg": "direct", "n": 47}}, False),
    ("c2r", 96, {"alg": "c2r_pack", "n": 96,
                 "child": {"alg": "direct", "n": 96}}, False),
    ("c2r", 45, {"alg": "c2r_via_c2c", "n": 45,
                 "child": {"alg": "direct", "n": 45}}, True),
    ("c2r", 45, {"alg": "r2c_via_c2c", "n": 45,
                 "child": {"alg": "direct", "n": 45}}, False),
    ("r2c", 64, {"alg": "r2c_dense", "n": 63}, False),
    ("dht", 64, {"alg": "r2r_matmul", "n": 63, "kind": "dht"}, False),
])
def test_validate_desc(kind, n, desc, ok):
    assert planner.validate_desc(kind, n, desc) is ok


def test_sprint_desc_equals_reference():
    ref = ref_planner.Planner()
    for n in (45, 96, 256, 1024):
        for kind in ("r2c", "c2r"):
            d = ref._plan(kind, n, np.float32, 0, 64)
            assert planner.sprint_desc(d) == ref_planner.sprint_desc(d)


def test_import_reference_wisdom_carries_real_entries():
    """A reference export with r2c and c2r entries pins the same
    descriptors in the port (the TPU-only ``merge`` key stripped), served
    from wisdom with no new search."""
    ref = ref_planner.Planner()
    for n in (96, 1024):
        ref.plan_r2c(n, np.float32, 0, 64)
        ref.plan_c2r(n, np.float32, 0, 64)
    data = json.loads(ref.export_wisdom())
    key = next(k for k in data["entries"] if k.startswith("r2c:1024:"))
    data["entries"][key]["desc"]["merge"] = True
    mine = planner.Planner(_ref_hw())
    assert mine.import_reference_wisdom(json.dumps(data), device="cpu")
    assert {"r2c", "c2r"} <= {k.split(":")[0] for k in mine.wisdom}
    for n in (96, 1024):
        for kind in ("r2c", "c2r"):
            got = mine._plan(kind, n, np.float32, 0, 64, "cpu")
            assert got == ref._plan(kind, n, np.float32, 0, 64)
            assert "merge" not in got
    assert mine.stats["nplan"] == 0


def test_measure_times_real_candidates_on_cpu():
    config.measure_points = 1 << 11
    pl = planner.Planner(_ref_hw())
    for kind in ("r2c", "c2r"):
        d = pl._plan(kind, 256, np.float32, kinds.PATIENCE_MEASURE, 4, "cpu")
        assert planner.validate_desc(kind, 256, d)
    assert pl.stats["nmeasure"] >= 8 and pl.stats["nmeasure_failed"] == 0


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_measure_failure_raises_on_cuda(kind, monkeypatch):
    """A real candidate that fails to build re-raises on a CUDA device: a
    CUDA plan never falls back to a plain solver unnoticed."""
    def broken(*args):
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(planner, "_measure_fn", broken)
    cands = [{"alg": f"pallas_{kind}", "n": 1024, "radices": [32, 16]},
             {"alg": f"{kind}_dense", "n": 1024}]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        planner.Planner()._measure_best(kind, 1024, np.float32, cands, 64,
                                        torch.device("cuda"))


# -- plans -----------------------------------------------------------------

PLANS = {  # name -> (shape, axes, kernel routes of the r2c plan at build)
    "1d_37x1024": ((37, 1024), (1,), [("r2c", 1024)]),
    "2d_8x256x512": ((8, 256, 512), (1, 2), [("inner", 256)]),
    "2d_4x128x256": ((4, 128, 256), (1, 2), [("r2c", 256), ("inner", 128)]),
    "3d_4x128x256": ((4, 128, 256), (0, 1, 2),
                     [("r2c", 256), ("inner", 128)]),
    "axis0_256x6": ((256, 6), (0,), [("r2c", 256)]),
    "1d_130": ((130,), (0,), []),
}


def _spy(monkeypatch, calls):
    """Record each call that builds a kernel apply, in both packages, as a
    route tuple."""
    def wrap(mod, name, pkg, route):
        real = getattr(mod, name)

        def spy(desc, *a, **k):
            calls[pkg].append((route, desc["n"]))
            return real(desc, *a, **k)
        monkeypatch.setattr(mod, name, spy)
    for pkg, m_real, m_inner, m_last in (("ref", PS, PS, PS),
                                         ("port", real_stockham, inner, S)):
        wrap(m_real, "build_pallas_r2c", pkg, "r2c")
        wrap(m_real, "build_pallas_c2r", pkg, "c2r")
        wrap(m_real, "build_pallas_r2c_inner", pkg, "r2c_inner")
        wrap(m_inner, "build_pallas_c2c_split_inner", pkg, "inner")
        wrap(m_last, "build_pallas_c2c_split", pkg, "last")


@pytest.mark.parametrize("name", list(PLANS))
def test_plans_match_reference(name, monkeypatch):
    shape, axes, route = PLANS[name]
    calls = {"ref": [], "port": []}
    _spy(monkeypatch, calls)
    ref = ref_ft.plan_dft_r2c(shape, axes=axes)
    mine = ft.plan_dft_r2c(shape, axes=axes, device="cpu")
    assert calls["port"] == calls["ref"] == route
    ref_b = ref_ft.plan_dft_c2r(shape, axes=axes)
    mine_b = ft.plan_dft_c2r(shape, axes=axes, device="cpu")
    # the inverse runs the same axes backwards, with K6 in K4's place
    assert sorted(calls["port"]) == sorted(calls["ref"])
    for p, r in ((mine, ref), (mine_b, ref_b)):
        assert p.descriptors == r.descriptors and repr(p) == repr(r)
        assert p.flops() == r.flops() and p.cost() == r.cost()
        assert (p.in_shape, p.out_shape) == (r.in_shape, tuple(r.out_shape))
    x = np.random.default_rng(len(shape)).standard_normal(shape) \
        .astype(np.float32)
    y = mine.execute(x)
    assert y.dtype == torch.complex64 and tuple(y.shape) == mine.out_shape
    want = np.asarray(jax.jit(ref.apply)(jnp.asarray(x)))
    oracle = np.fft.rfftn(x.astype(np.float64), axes=mine.problem.axes)
    assert _relerr(y.numpy(), want) <= TOL
    assert _relerr(y.numpy(), oracle) <= 1e-5
    Y = y.numpy()
    z = mine_b.execute(Y)
    assert z.dtype == torch.float32 and tuple(z.shape) == shape
    assert _relerr(z.numpy(), np.asarray(jax.jit(ref_b.apply)(
        jnp.asarray(Y)))) <= TOL
    npts = np.prod([shape[a] for a in mine.problem.axes])
    assert _relerr(z.numpy(), npts * x) <= 1e-5       # c2r(r2c(x)) = N x


def test_api_shapes_and_dtypes():
    p = ft.plan_dft_r2c_2d(128, 256, device="cpu")
    assert (p.in_shape, p.out_shape) == ((128, 256), (128, 129))
    assert (p.in_dtype, p.out_dtype) == (torch.float32, torch.complex64)
    q = ft.plan_dft_c2r_3d(4, 8, 256, device="cpu")
    assert (q.in_shape, q.out_shape) == ((4, 8, 129), (4, 8, 256))
    assert (q.in_dtype, q.out_dtype) == (torch.complex64, torch.float32)
    for make in (ft.plan_dft_r2c_1d, ft.plan_dft_c2r_1d):
        assert make(1024, device="cpu").descriptors[0]["alg"] in (
            "pallas_r2c", "pallas_c2r")
    x = torch.randn(128, 256)
    y = ft.plan_dft_r2c_2d(128, 256, device="cpu").execute(x)
    assert _relerr(y.numpy(), np.fft.rfft2(x.double().numpy())) <= 1e-5


def test_wrong_shapes_raise():
    p = ft.plan_dft_r2c((4, 256), axes=(1,), device="cpu")
    q = ft.plan_dft_c2r((4, 256), axes=(1,), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        p.execute(np.zeros((4, 128), np.float32))
    with pytest.raises(ValueError, match="shape"):
        p.apply_split(torch.zeros(4, 258))
    with pytest.raises(ValueError, match="shape"):
        q.execute(np.zeros((4, 256), np.complex64))      # not the half
    with pytest.raises(ValueError, match="shape"):
        q.apply_split(torch.zeros(4, 129), torch.zeros(4, 128))


def test_leading_batch_dims_through_apply():
    """Right-relative axes: extra leading dims pass through K4, K2, K6."""
    shape, axes = (4, 128, 256), (1, 2)
    p = ft.plan_dft_r2c(shape, axes=axes, device="cpu")
    q = ft.plan_dft_c2r(shape, axes=axes, device="cpu")
    x = torch.randn((2,) + shape)
    y = p.apply(x)
    want = np.fft.rfftn(x.double().numpy(), axes=(2, 3))
    assert _relerr(y.numpy(), want) <= 1e-5
    z = q.apply(y)
    assert _relerr(z.numpy(), 128 * 256 * x.numpy()) <= 1e-5


@pytest.mark.parametrize("option,shape,routes", [
    ("r2c_swapped", (2, 256, 384), [("r2c_inner", 256), ("last", 384)]),
])
def test_real_options_match_reference(option, shape, routes, monkeypatch):
    """The reference's r2c option that the port carries, on in both
    packages: the same descriptors and routes, and both within tolerance of
    numpy.  (The reference's DC/Nyquist pack is not carried over: it lost
    on the H100, PERF.md.)"""
    monkeypatch.setattr(config, option, True)
    monkeypatch.setattr(ref_config, option, True)
    calls = {"ref": [], "port": []}
    _spy(monkeypatch, calls)
    ref = ref_ft.plan_dft_r2c(shape, axes=(1, 2))
    mine = ft.plan_dft_r2c(shape, axes=(1, 2), device="cpu")
    assert calls["port"] == calls["ref"] == routes
    assert mine.descriptors == ref.descriptors
    x = np.random.default_rng(5).standard_normal((2,) + shape) \
        .astype(np.float32)                   # plus a leading batch dim
    y = mine.apply(_t(x)).numpy()
    assert y.shape == (2,) + mine.out_shape
    assert _relerr(y, np.asarray(jax.jit(ref.apply)(jnp.asarray(x)))) <= TOL
    assert _relerr(y, np.fft.rfftn(x.astype(np.float64),
                                   axes=(2, 3))) <= 1e-5


def test_swapped_route_has_no_gradient(monkeypatch):
    monkeypatch.setattr(config, "r2c_swapped", True)
    p = ft.plan_dft_r2c((256, 384), device="cpu")
    assert p.descriptors[0]["alg"] == "pallas_r2c_inner"
    x = torch.randn(256, 384, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        p.apply(x).real.sum().backward()


@pytest.mark.parametrize("shape,axes", [((3, 1024), (1,)),
                                        ((4, 128, 256), (1, 2))])
def test_plan_grads(shape, axes):
    """r2c: the gradient of a real loss equals JAX's and torch.fft's; c2r:
    it is the conjugate of JAX's and equals torch.fft's (times N)."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal(shape).astype(np.float32)
    ref = ref_ft.plan_dft_r2c(shape, axes=axes)
    mine = ft.plan_dft_r2c(shape, axes=axes, device="cpu")
    out = mine.out_shape
    w = (rng.standard_normal(out) + 1j * rng.standard_normal(out)) \
        .astype(np.complex64)
    g_jax = np.asarray(jax.grad(
        lambda a: jnp.sum(jnp.real(ref.apply(a) * w)))(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    (mine.execute(xt) * _t(w)).real.sum().backward()
    assert _relerr(xt.grad.numpy(), g_jax) <= TOL
    xt2 = _t(x).requires_grad_()
    (torch.fft.rfftn(xt2, dim=axes) * _t(w)).real.sum().backward()
    assert _relerr(xt.grad.numpy(), xt2.grad.numpy()) <= 1e-5

    X = (rng.standard_normal(out) + 1j * rng.standard_normal(out)) \
        .astype(np.complex64)
    g = rng.standard_normal(shape).astype(np.float32)
    ref_b = ref_ft.plan_dft_c2r(shape, axes=axes)
    mine_b = ft.plan_dft_c2r(shape, axes=axes, device="cpu")
    gc_jax = np.asarray(jax.grad(
        lambda z: jnp.sum(ref_b.apply(z) * g))(jnp.asarray(X)))
    Xt = _t(X).requires_grad_()
    (mine_b.execute(Xt) * _t(g)).sum().backward()
    assert _relerr(Xt.grad.numpy(), np.conj(gc_jax)) <= TOL
    Xt2 = _t(X).requires_grad_()
    npts = float(np.prod([shape[a] for a in axes]))
    (torch.fft.irfftn(Xt2, s=[shape[a] for a in axes], dim=axes) * npts
     * _t(g)).sum().backward()
    assert _relerr(Xt.grad.numpy(), Xt2.grad.numpy()) <= 1e-5


@pytest.mark.parametrize("n", [96, 1024])
def test_float64_plans_stay_float64(n):
    """Complex128/float64 plans never reach the f32 kernels: they stay on
    the dense, pack or via-c2c solvers (over df32 children), in float64 end
    to end."""
    shape = (3, n)
    p = ft.plan_dft_r2c(shape, axes=(1,), dtype="float64", device="cpu")
    q = ft.plan_dft_c2r(shape, axes=(1,), dtype="float64", device="cpu")
    assert p.descriptors == ref_ft.plan_dft_r2c(
        shape, axes=(1,), dtype="float64").descriptors
    assert q.descriptors == ref_ft.plan_dft_c2r(
        shape, axes=(1,), dtype="float64").descriptors
    for d in (p.descriptors[1], q.descriptors[1]):
        assert d["alg"].split("_")[-1] in ("dense", "pack", "c2c")
    x = np.random.default_rng(n).standard_normal(shape)
    y = p.execute(x)
    assert y.dtype == torch.complex128
    assert _relerr(y.numpy(), np.fft.rfft(x)) <= 1e-12
    z = q.execute(y)
    assert z.dtype == torch.float64
    assert _relerr(z.numpy(), n * x) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axes,launches", [
    ((64, 1024), (1,), {"r2c": 1, "inner": 0}),
    ((4, 2048, 2048), (1, 2), {"r2c": 1, "inner": 1}),
])
def test_plans_on_card(shape, axes, launches):
    """On the card, with the port's own constants: the r2c plan launches
    K4 (and K2), the c2r plan K2 and K6, and both agree with torch.fft."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    ft.the_planner.hw = planner.HardwareModel()
    config.kernel_mode = "auto"
    p = ft.plan_dft_r2c(shape, axes=axes, device="cuda")
    q = ft.plan_dft_c2r(shape, axes=axes, device="cuda")
    x = torch.randn(shape, device="cuda")
    before = (real_stockham.r2c_launches, real_stockham.c2r_launches,
              inner.launches)
    y = p.execute(x)
    z = q.execute(y)
    torch.cuda.synchronize()
    after = (real_stockham.r2c_launches, real_stockham.c2r_launches,
             inner.launches)
    assert after[0] - before[0] == launches["r2c"]
    assert after[1] - before[1] == launches["r2c"]
    assert after[2] - before[2] == 2 * launches["inner"]
    want = torch.fft.rfftn(x.double(), dim=axes)
    assert float((y - want).abs().max() / want.abs().max()) <= 1e-5
    npts = float(np.prod([shape[a] for a in axes]))
    assert float((z - npts * x).abs().max() / (npts * x).abs().max()) <= 1e-5
