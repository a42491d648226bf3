"""The pass contract at a plan's complex edges: every axis pass takes and
gives split planes or one complex tensor and converts only where its
kernel cannot (``ops/passes.py``), so a c2c plan's first pass reads the
caller's complex64 tensor itself and its last pass writes the complex
output itself where their kernels can (K1 on the last axis and K2 both,
K3 the output), and every other edge converts in its span.  A multi-axis
r2c's last K2 pass writes its complex output and a multi-axis c2r's first
K2 pass reads its complex input, so neither converts.

The CPU tests run the plans as on the card (the ``forced`` fixture: the
kernel passes take their kernel branch, with CPU stand-ins of K1, K2 and
K3 that check the layouts the kernels take): the spans a call records,
its output bit for bit against the split-planes path, the plans that
convert as before (CPU, complex128, ``pallas4``, 1-D r2c and c2r), the
input decision (:func:`passes.kernel_input`), the passes' complex layouts
through the twins and autograd, and an empty batch.  The card tests
(``cuda`` marker) hold ``Plan.execute`` bit for bit against the
split-planes path, and K2's complex64 output against its planes, and skip
without a card.  This file imports no JAX.
"""
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import config
from fftw3_tpu_torch import kinds as K
from fftw3_tpu_torch import plan as plan_mod
from fftw3_tpu_torch import planner as planner_mod
from fftw3_tpu_torch import trace
from fftw3_tpu_torch.ops import c2c as c2c_ops
from fftw3_tpu_torch.ops import df32, fused2d, inner, passes
from fftw3_tpu_torch.ops import stockham as S

CPU = torch.device("cpu")
CUDA = torch.device("cuda")
SPLIT, COMBINE = "fftw.convert.split", "fftw.convert.combine"
CONVERT = (SPLIT, COMBINE)


def _complex(shape, seed=0, device=CPU, dtype=torch.complex64):
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, dtype=dtype, device=device, generator=g)


def _split_path(plan, x):
    """The split-planes path: split planes, ``apply_split``, combine."""
    return torch.complex(*plan.apply_split(x.real.contiguous(),
                                           x.imag.contiguous()))


def _traced(fn):
    """`fn()` under the profiler, and the record's snapshot; its
    ``converts`` count the conversion spans the call ran, wherever they
    opened (at a plan's edge or inside a pass)."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    converts = Counter(r.name for r in trace.records() if r.name in CONVERT)
    snap = trace.snapshot(reset=True)
    snap["converts"] = converts
    return out, snap


@pytest.fixture
def cpu_plans(monkeypatch):
    """Plans on the CPU, the kernel solvers' twins offered, the planner's
    own choices (no wisdom), an empty record."""
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(ft.the_planner, "wisdom", {})
    trace.reset()
    yield
    trace.reset()


def _sign(table, tables):
    """The sign s whose root tables ``tables(s)`` `table` is."""
    return next(s for s in (-1, 1) if torch.equal(table, tables(s)))


def _operands(name, xr, xi):
    """What a kernel checks of its operands (``passes.check_planes`` but
    the device), and its input as planes for the twin."""
    if xi is None:
        if xr.dtype != torch.complex64 or not xr.is_contiguous() \
                or xr.is_conj() or xr.is_neg():
            raise ValueError(f"{name} takes contiguous complex64 with no "
                             f"lazy conjugate or negative bit")
        return xr.real, xr.imag
    if xr.dtype != torch.float32 or xi.dtype != torch.float32 \
            or not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError(f"{name} takes contiguous float32 planes")
    return xr, xi


def _k1(xr, xi, radices, table, complex_out=False):
    n = xr.shape[-1]
    s = _sign(table, lambda s: S.device_table(n, tuple(radices), s, CPU))
    y = S.stockham_c2c_torch(*_operands("K1", xr, xi), radices, s)
    return torch.complex(*y) if complex_out else y


#: the layouts K2's stand-in was called with: (complex in, complex out)
K2_CALLS = []


def _k2(xr, xi, radices, table, complex_out=False):
    n = xr.shape[-2]
    s = _sign(table, lambda s: S.device_table(n, tuple(radices), s, CPU))
    K2_CALLS.append((xi is None, complex_out))
    y = inner.inner_c2c_torch(*_operands("K2", xr, xi), radices, s)
    return torch.complex(*y) if complex_out else y


def _k3(xr, xi, rad1, rad2, table, complex_out=False):
    if xi is None:
        raise ValueError("K3 takes split input planes")
    n1, n2 = xr.shape[-2:]
    s = _sign(table, lambda s: fused2d.device_table_2d(
        n1, tuple(rad1), n2, tuple(rad2), s, CPU))
    y = fused2d.c2c_2d_torch(*_operands("K3", xr, xi), rad1, rad2, s)
    return torch.complex(*y) if complex_out else y


def _force(monkeypatch):
    """Kernel passes take the kernel branch (``passes.on_twin`` false),
    where CPU stand-ins of K1, K2 and K3 take and give the layouts the
    kernels do and refuse the rest."""
    monkeypatch.setattr(passes, "on_twin", lambda x: False)
    monkeypatch.setattr(S, "stockham_c2c_cuda", _k1)
    monkeypatch.setattr(inner, "inner_c2c_cuda", _k2)
    monkeypatch.setattr(fused2d, "c2c_2d_cuda", _k3)
    K2_CALLS.clear()


@pytest.fixture
def forced(cpu_plans, monkeypatch):
    """CPU plans run as on the card (:func:`_force`)."""
    _force(monkeypatch)


def _pinned(shape, axes, desc, dtype="complex64"):
    """A CPU plan whose transform axes run `desc`, pinned in a planner of
    its own."""
    pl = planner_mod.Planner()
    rdtype = np.float32 if dtype == "complex64" else np.float64
    total = int(np.prod(shape))
    for a in axes:
        pl.wisdom[pl._key("c2c", shape[a], rdtype, total // shape[a], CPU)] \
            = {"desc": desc, "cost": 0.0, "patience": K.PATIENCE_EXHAUSTIVE}
    return plan_mod.make_plan(plan_mod.Problem(
        shape, axes, "c2c", K.FORWARD, rdtype=np.dtype(rdtype).name),
        K.ESTIMATE, planner=pl, device=CPU)


def _route(plan):
    return [s.name[len("fftw.stage."):] for s in plan.stages]


# -- the edges a call converts ------------------------------------------------

def _kernel_apply(kernel):
    """A pass on `kernel` and an input of its shape (K4: an r2c plan on a
    real input, whose exit combines)."""
    desc = {"alg": "pallas", "n": 128, "radices": [128]}
    if kernel == "k1":
        return S.build_pallas_c2c_split(desc, K.FORWARD, np.float32,
                                        CPU), (2, 4, 128)
    if kernel == "k2":
        return inner.build_pallas_c2c_split_inner(desc, K.FORWARD,
                                                  np.float32, CPU), (2, 128, 8)
    if kernel == "k3":
        return fused2d.build_pallas_c2c_split_2d(
            128, 128, K.FORWARD, np.float32, desc, desc, CPU), (2, 128, 128)
    if kernel == "k4":
        plan = ft.plan_dft_r2c((4, 1024), axes=(1,))
        assert plan.descriptors[1]["alg"] == "pallas_r2c"
        return plan, (4, 1024)
    return c2c_ops.build_c2c_split({"alg": "mixed", "n": 64, "p": 8,
                                    "child": {"alg": "direct", "n": 8}},
                                   K.FORWARD, np.float32, CPU), (3, 64)


@pytest.mark.parametrize("kernel,device,converts", [
    ("k1", "cuda", ()), ("k2", "cuda", ()),
    ("k3", "cuda", (SPLIT,)), ("k4", "cuda", (COMBINE,)),
    ("mixed", "cuda", CONVERT), ("k1", "cpu", CONVERT),
    ("k2", "cpu", CONVERT), ("k3", "cpu", CONVERT),
])
def test_edge_forms_by_kernel_and_device(cpu_plans, monkeypatch, kernel,
                                         device, converts):
    """A pass on `kernel` given a complex64 input and asked for the
    complex output, on the card (the stand-ins) or on the CPU (the twins):
    the conversions it runs are those of the layouts its kernel does not
    take or give (K1 and K2 none, K3 the split, others both), and its
    output is the split-planes path's bit for bit."""
    if device == "cuda":
        _force(monkeypatch)
    fn, shape = _kernel_apply(kernel)
    if kernel == "k4":
        x = torch.randn(shape)
        got, snap = _traced(lambda: fn.execute(x))
        want = torch.complex(*fn.apply_split(x))
    else:
        x = _complex(shape, seed=1)
        got, snap = _traced(lambda: fn(x, None, True))
        want = torch.complex(*fn(x.real.contiguous(), x.imag.contiguous()))
    assert torch.equal(got, want)
    assert snap["converts"] == Counter(converts)


def _x(shape, view="plain", dtype=torch.complex64, device=CPU):
    """A complex input of `shape`: plain, a lazy conjugate, a lazy
    negative, or a strided view."""
    if view == "strided":
        return _complex(shape[:-1] + (2 * shape[-1],), seed=2,
                        device=device, dtype=dtype)[..., ::2]
    x = _complex(shape, seed=2, device=device, dtype=dtype)
    if view == "conj":
        return x.conj()
    return torch._neg_view(x) if view == "neg" else x


@pytest.mark.parametrize("shape,axes,route,view,converts", [
    ((4, 1024), (1,), ["k1"], "plain", ()),
    ((128, 128, 128), (0, 1, 2), ["k2", "k3"], "plain", ()),
    ((128, 4, 128), (0, 2), ["k2", "k1"], "plain", ()),
    ((3, 128, 128), (1, 2), ["k3"], "plain", (SPLIT,)),
    ((128, 8, 16), (0,), ["k2"], "plain", ()),
    ((16, 1024), (0, 1), ["direct", "k1"], "plain", (SPLIT,)),
    ((128, 2, 64), (0, 2), ["k2", "direct"], "plain", (COMBINE,)),
    ((8, 64), (1,), ["direct"], "plain", CONVERT),
    ((4, 8), (), [], "plain", CONVERT),
    ((4, 1024), (1,), ["k1"], "cpu", CONVERT),
    ((4, 1024), (1,), ["k1"], "strided", (SPLIT,)),
    ((4, 1024), (1,), ["k1"], "conj", (SPLIT,)),
    ((128, 128, 128), (0, 1, 2), ["k2", "k3"], "neg", (SPLIT,)),
    ((128, 128, 128), (0, 1, 2), ["k2", "k3"], "strided", (SPLIT,)),
])
def test_complex_edges_decision(forced, monkeypatch, shape, axes, route,
                                view, converts):
    """The conversions of a call on the card by its route and its input:
    none where the first pass reads the input (K1 on the last axis, K2)
    and the last writes the output (K1, K2, K3); a split where the first
    cannot read it, or the input is a lazy conjugate, a lazy negative or
    strided (one complex copy), a combine where the last cannot write it;
    both on the CPU.  The output is the split-planes path's bit for
    bit."""
    if view == "cpu":
        monkeypatch.undo()
        monkeypatch.setattr(config, "kernel_mode", "on")
        monkeypatch.setattr(ft.the_planner, "wisdom", {})
    plan = ft.plan_dft(shape, axes=axes, dtype="complex64", device="cpu")
    assert _route(plan) == route
    x = _x(shape, "plain" if view == "cpu" else view)
    got, snap = _traced(lambda: plan.execute(x))
    assert torch.equal(got, _split_path(plan, x))
    assert snap["converts"] == Counter(converts)
    assert snap["calls"] == 1


def test_complex128_is_split_for_k1(forced):
    """A complex128 tensor is no input K1 reads: its pass splits it, and
    the kernel refuses the float64 planes (``Plan.execute`` casts to the
    plan's complex64 first)."""
    plan = ft.plan_many_dft([1024], 4, dtype="complex64")
    x = _complex((4, 1024), dtype=torch.complex128)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="float32"):
            plan.apply(x)
    assert [r.name for r in trace.records() if r.name in CONVERT] == [SPLIT]
    trace.reset()
    assert torch.equal(plan.execute(x), _split_path(plan, x.to(
        torch.complex64)))


@pytest.mark.parametrize("make,route,converts", [
    (lambda: ft.plan_many_dft([1024], 8, dtype="complex64"), ["k1"], ()),
    (lambda: ft.plan_dft((128, 128, 128), axes=(0, 1, 2), dtype="complex64"),
     ["k2", "k3"], ()),
    (lambda: ft.plan_dft((128, 4, 128), axes=(0, 2), dtype="complex64"),
     ["k2", "k1"], ()),
    # K1 lifted onto a non-last axis (a movedim): it runs on planes
    (lambda: ft.plan_dft((128, 8), axes=(0,), dtype="complex64"), ["k1"],
     CONVERT),
    (lambda: ft.plan_many_dft([64], 8, dtype="complex64"), ["direct"],
     CONVERT),
])
def test_routes_get_the_forms_of_their_kernels(forced, make, route,
                                               converts):
    plan = make()
    assert _route(plan) == route
    x = _complex(plan.problem.shape, seed=3)
    got, snap = _traced(lambda: plan.execute(x))
    assert torch.equal(got, _split_path(plan, x))
    assert snap["converts"] == Counter(converts)


def test_cpu_plans_have_no_forms(cpu_plans):
    """A CPU input runs the twins, which take no complex form: each call
    splits at its entry and combines at its exit, once, as before."""
    for plan in (ft.plan_many_dft([1024], 8, dtype="complex64"),
                 ft.plan_dft((128, 128, 128), axes=(0, 1, 2),
                             dtype="complex64")):
        x = _complex(plan.problem.shape, seed=6)
        got, snap = _traced(lambda: plan.execute(x))
        assert torch.equal(got, _split_path(plan, x))
        assert snap["converts"] == Counter(CONVERT)


def test_complex128_and_pallas4_passes_have_no_forms(forced):
    """A complex128 plan's pass (``df32``) and a ``pallas4`` pass run on
    planes: a call splits and combines, with the split-planes path's
    output."""
    plan = ft.plan_many_dft([1024], 4, dtype="complex128")
    four = _pinned((2, 4096), (1,), {"alg": "pallas4", "n": 4096, "p": 32,
                                     "q": 128})
    assert (_route(plan), _route(four)) == (["df32"], ["pallas4"])
    for p, dtype in ((plan, torch.complex128), (four, torch.complex64)):
        x = _complex(p.problem.shape, seed=4, dtype=dtype)
        got, snap = _traced(lambda: p.execute(x))
        assert torch.equal(got, _split_path(p, x))
        assert snap["converts"] == Counter(CONVERT)


@pytest.mark.parametrize("kind", ["r2c", "c2r", "c2c128"])
def test_other_complex_sides_convert_as_before(forced, kind):
    """A 1-D r2c combines at the exit (K4 writes planes), a 1-D c2r splits
    at the entry (K6 reads planes), complex128 does both."""
    if kind == "r2c":
        plan = ft.plan_dft_r2c((4, 1024), axes=(1,))
        x = torch.randn(4, 1024)
        want = ("fftw.convert.combine",)
    elif kind == "c2r":
        plan = ft.plan_dft_c2r((4, 1024), axes=(1,))
        x = _complex((4, 513))
        want = ("fftw.convert.split",)
    else:
        plan = ft.plan_many_dft([1024], 4, dtype="complex128")
        x = _complex((4, 1024), dtype=torch.complex128)
        want = CONVERT
    plain = plan.execute(x)
    traced, snap = _traced(lambda: plan.execute(x))
    assert torch.equal(plain, traced)
    assert snap["converts"] == Counter(want)


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
@pytest.mark.parametrize("shape,axes,k2", [
    ((2, 128, 1024), (1, 2), 1),        # K4 or K6 on the last axis
    ((128, 128, 256), (0, 1, 2), 2),    # the dense real solvers last
    ((3, 128, 64), (1, 2), 0),          # 64 columns: K1 lifted by movedim
])
def test_multi_axis_real_plans_cross_k2_unconverted(forced, kind, shape,
                                                    axes, k2):
    """A multi-axis r2c whose last c2c pass is K2 has K2 write its complex
    output, and a c2r whose first is K2 has K2 read the caller's complex
    input: no ``fftw.convert.*`` span, the other K2 passes on planes.  With
    no K2 pass at that edge the r2c combines and the c2r splits, as
    before.  Either way the output is the conversion path's bit for bit
    (``torch.complex(*apply_split(x))``, ``apply_split(X.real, X.imag)``)
    and the input is untouched."""
    if kind == "r2c":
        plan = ft.plan_dft_r2c(shape, axes=axes)
        x = torch.randn(shape, generator=torch.Generator().manual_seed(8))
        want = torch.complex(*plan.apply_split(x))
        edge = [(False, False)] * (k2 - 1) + [(False, True)] * (k2 > 0)
        converts = () if k2 else (COMBINE,)
    else:
        plan = ft.plan_dft_c2r(shape, axes=axes)
        x = _complex(plan.in_shape, seed=8)
        want = plan.apply_split(x.real, x.imag)
        edge = [(True, False)] * (k2 > 0) + [(False, False)] * (k2 - 1)
        converts = () if k2 else (SPLIT,)
    x0 = x.clone()
    K2_CALLS.clear()
    got, snap = _traced(lambda: plan.execute(x))
    assert torch.equal(got, want) and torch.equal(x, x0)
    assert K2_CALLS == edge
    assert snap["spans"].get("fftw.stage.k2", {}).get("count", 0) == k2
    assert snap["converts"] == Counter(converts)


@pytest.mark.parametrize("kind", ["rfftn", "irfftn"])
def test_real_2d_gradient_matches_the_conversion_path(forced, kind):
    """The gradient through a 2-D ``rfftn`` (K2 writing the complex
    output) and ``irfftn`` (K2 reading the complex input) equals the
    conversion path's, the plan's ``apply_split`` (and irfftn's 1/N)."""
    shape, half = (2, 128, 1024), (2, 128, 513)
    gen = torch.Generator().manual_seed(9)
    if kind == "rfftn":
        x = torch.randn(shape, generator=gen).requires_grad_()
        g = _complex(half, seed=10)
        got, = torch.autograd.grad(ft.rfftn(x, axes=(1, 2)), x, g)
        plan = ft.plan_dft_r2c(shape, axes=(1, 2))
        want, = torch.autograd.grad(torch.complex(*plan.apply_split(x)), x,
                                    g)
    else:
        x = _complex(half, seed=9).requires_grad_()
        g = torch.randn(shape, generator=gen)
        got, = torch.autograd.grad(ft.irfftn(x, s=shape[1:], axes=(1, 2)),
                                   x, g)
        plan = ft.plan_dft_c2r(shape, axes=(1, 2))
        want, = torch.autograd.grad(plan.apply_split(x.real, x.imag)
                                    * (1.0 / np.prod(shape[1:])), x, g)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("pre", [0, 2])
@pytest.mark.parametrize("cin,cout", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_k2_wrapper_layouts_and_counters(monkeypatch, pre, cin, cout):
    """K2's wrapper hands the launch the layout bits of its input and of
    the output asked for, and the output's pointers: two new planes, or
    with `complex_out` one new complex64 tensor and no second pointer.  It
    counts each launch in ``inner.launches`` and, where it writes
    complex64, in ``inner.cout_launches``; an empty batch launches nothing
    and gives the layout asked for (the device checks and the launch
    stubbed, so that it runs on the CPU)."""
    launched = []
    monkeypatch.setattr(passes, "check_planes", lambda *a: None)
    monkeypatch.setattr(passes, "launch",
                        lambda kernel, device, smem, work, args, what:
                        launched.append((kernel, args)))
    n, L = 2048, 1025
    radices = S.choose_radices(n)
    table = torch.zeros(S.table_len(n, radices))
    if cin:
        x = (torch.zeros(pre, n, L, dtype=torch.complex64), None)
    else:
        x = (torch.zeros(pre, n, L), torch.zeros(pre, n, L))
    before = inner.launches, inner.cout_launches
    y = inner.inner_c2c_cuda(*x, radices, table, complex_out=cout)
    assert (inner.launches - before[0], inner.cout_launches - before[1]) \
        == (int(pre > 0), int(pre > 0 and cout))
    if cout:
        assert isinstance(y, torch.Tensor) and y.dtype == torch.complex64
        assert tuple(y.shape) == (pre, n, L)
        out = (y.data_ptr(), None)
    else:
        assert len(y) == 2 and all(t.dtype == torch.float32 for t in y)
        assert all(tuple(t.shape) == (pre, n, L) for t in y)
        out = (y[0].data_ptr(), y[1].data_ptr())
    if pre == 0:
        assert launched == []
        return
    (kernel, args), = launched
    assert kernel == "inner_c2c"
    assert args[:4] == passes.pointers(*x) + out
    assert args[-1] == (passes.IN_COMPLEX if cin else 0) \
        | (passes.OUT_COMPLEX if cout else 0)


@pytest.mark.parametrize("route,view", [
    ("k1", "plain"), ("k2-k3", "plain"), ("k3", "plain"), ("pallas4", "plain"),
    ("df32p", "plain"), ("k1", "conj"), ("k1", "strided"), ("cpu", "plain"),
])
def test_a_call_converts_only_where_its_route_cannot(forced, monkeypatch,
                                                     route, view):
    """A c2c call records ``fftw.convert.split`` exactly where its route's
    first pass cannot read the caller's tensor as it is (a lazy conjugate
    and a strided view are copied once into a complex64 tensor K1 reads),
    and ``fftw.convert.combine`` exactly where its last pass cannot write
    the complex output; the output is the split-planes path's bit for
    bit."""
    if route == "cpu":
        monkeypatch.setattr(passes, "on_twin", lambda x: x.device.type ==
                            "cpu")
    dtype = "complex64"
    if route in ("k1", "cpu"):
        plan = ft.plan_many_dft([1024], 4, dtype=dtype)
    elif route == "k2-k3":
        plan = ft.plan_dft((128, 128, 128), axes=(0, 1, 2), dtype=dtype)
    elif route == "k3":
        plan = ft.plan_dft((3, 128, 128), axes=(1, 2), dtype=dtype)
    elif route == "pallas4":
        plan = _pinned((2, 4096), (1,), {"alg": "pallas4", "n": 4096,
                                         "p": 32, "q": 128})
    else:
        dtype = "complex128"
        plan = _pinned((4, 1024), (1,), {"alg": "df32p", "n": 1024,
                                         "radices": df32.df32p_radices(1024)},
                       dtype)
    stages = _route(plan)
    first, last = stages[0], stages[-1]
    split = route == "cpu" or view != "plain" or first not in ("k1", "k2")
    combine = route == "cpu" or last not in ("k1", "k2", "k3")
    x = _x(plan.problem.shape, view, getattr(torch, dtype))
    got, snap = _traced(lambda: plan.execute(x))
    assert torch.equal(got, _split_path(plan, x))
    assert snap["converts"] == Counter([SPLIT] * split + [COMBINE] * combine)


@pytest.mark.parametrize("view", ["plain", "conj", "neg", "strided"])
@pytest.mark.parametrize("reads", [True, False])
def test_kernel_input_decision(view, reads):
    """What a kernel gets of a complex input: a complex64 tensor itself
    where it reads one, copied once (in ``fftw.convert.split``) where it
    is a lazy conjugate, a lazy negative or strided; else two contiguous
    planes, in the same span.  Planes pass as they are."""
    x = _x((4, 8), view)
    pr, pi = torch.randn(4, 8), torch.randn(4, 8)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        xr, xi = passes.kernel_input(x, None, reads)
        planes = passes.kernel_input(pr, pi, reads)
    spans = [r.name for r in trace.records()]
    trace.reset()
    assert planes[0] is pr and planes[1] is pi
    if reads:
        assert xi is None and xr.dtype == torch.complex64
        assert xr.is_contiguous() and not (xr.is_conj() or xr.is_neg())
        assert (xr is x) == (view == "plain")
        assert torch.equal(xr, x.resolve_conj().resolve_neg())
        assert spans == ([] if view == "plain" else [SPLIT])
    else:
        assert xr.dtype == xi.dtype == torch.float32
        assert torch.equal(torch.complex(xr, xi),
                           x.resolve_conj().resolve_neg())
        assert spans == [SPLIT]


# -- the passes' complex layouts on the CPU route ------------------------------

@pytest.mark.parametrize("shape,axes,sign,converts", [
    ((6, 1024), (1,), K.FORWARD, ()),
    ((5, 1000), (1,), K.BACKWARD, ()),
    ((128, 128, 128), (0, 1, 2), K.FORWARD, ()),
    ((128, 4, 128), (0, 2), K.BACKWARD, ()),
    ((3, 128, 128), (1, 2), K.FORWARD, (SPLIT,)),
    ((3, 128, 256), (1, 2), K.FORWARD, (COMBINE,)),
])
def test_forced_edges_match_the_conversion_path(forced, shape, axes, sign,
                                                converts):
    """The edges taken on the card's route: the same output bit for bit,
    the input untouched, a conversion span only at an edge the route's
    kernels do not take (K3 reads no complex input; K2 then ``mixed``
    write none)."""
    plan = ft.plan_dft(shape, axes=axes, sign=sign, dtype="complex64")
    x = _complex(shape, seed=1)
    x0 = x.clone()
    want = _split_path(plan, x)
    got, snap = _traced(lambda: plan.execute(x))
    assert torch.equal(got, want) and got.dtype == torch.complex64
    assert torch.equal(x, x0)
    assert snap["converts"] == Counter(converts)
    assert snap["calls"] == 1


@pytest.mark.parametrize("shape,axes", [((4, 1024), (1,)),
                                        ((128, 128, 128), (0, 1, 2))])
def test_forced_edges_gradient_matches_the_conversion_path(forced, shape,
                                                           axes):
    """The passes' autograd on the complex tensors: the gradient of a
    complex leaf through ``execute`` equals the conversion path's."""
    plan = ft.plan_dft(shape, axes=axes, dtype="complex64")
    x = _complex(shape, seed=2).requires_grad_()
    g = _complex(shape, seed=3)
    got, = torch.autograd.grad(plan.execute(x), x, g)
    want, = torch.autograd.grad(_split_path(plan, x), x, g)
    assert got.dtype == torch.complex64
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k2-card"])
@pytest.mark.parametrize("cin,cout", [(True, False), (False, True),
                                      (True, True)])
def test_a_pass_takes_and_gives_every_layout(cpu_plans, monkeypatch, kernel,
                                             cin, cout):
    """Each of K1's, K2's and K3's applies takes the complex tensor itself
    (xi None) and gives the complex output (cout), converting where its
    kernel has no form, with the planes' values; its backward gives the
    gradient in the input's layout.  ``k2-card`` runs K2's pass on the
    card's branch (:func:`_force`), where K2 is handed the layouts as they
    are, both ways, and no conversion runs."""
    desc = {"alg": "pallas", "n": 128, "radices": [128]}
    if kernel == "k2-card":
        _force(monkeypatch)
    if kernel == "k1":
        apply = S.build_pallas_c2c_split(desc, K.FORWARD, np.float32, CPU)
    elif kernel.startswith("k2"):
        apply = inner.build_pallas_c2c_split_inner(desc, K.FORWARD,
                                                   np.float32, CPU)
    else:
        apply = fused2d.build_pallas_c2c_split_2d(128, 128, K.FORWARD,
                                                  np.float32, desc, desc, CPU)
    x = _complex((2, 128, 128), seed=4).requires_grad_()
    want = torch.complex(*apply(x.real, x.imag))
    K2_CALLS.clear()
    got, snap = _traced(lambda: apply(x, None, cout) if cin
                        else apply(x.real, x.imag, cout))
    got_c = got if cout else torch.complex(*got)
    assert torch.equal(got_c, want)
    if kernel == "k2-card":
        assert K2_CALLS == [(cin, cout)]
        assert snap["converts"] == Counter()
    g = _complex((2, 128, 128), seed=5)
    d_got, = torch.autograd.grad(got_c, x, g)
    d_want, = torch.autograd.grad(want, x, g)
    assert torch.equal(d_got, d_want)


def test_in_pass_conversions_are_traced(cpu_plans):
    """A conversion inside a pass (here the twin's) runs in the
    ``fftw.convert.*`` spans, opened in the pass's span."""
    plan = ft.plan_many_dft([1024], 4, dtype="complex64")
    x = _complex((4, 1024), seed=7)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = plan.execute(x)
    recs = [r for r in trace.records() if r.name in CONVERT]
    trace.reset()
    assert torch.equal(got, _split_path(plan, x))
    assert sorted(r.name for r in recs) == sorted(CONVERT)
    assert {r.parent.name for r in recs} == {"fftw.stage.k1"}


@pytest.mark.parametrize("n,radices", [(1024, [64, 16]), (4096, [64, 64])])
@pytest.mark.parametrize("cin,cout", [(False, False), (True, False),
                                      (True, True)])
def test_empty_batch_gives_the_layout_asked_for(monkeypatch, n, radices,
                                                cin, cout):
    """K1's wrapper on an empty batch launches nothing and returns the
    layout asked for: planes, or one complex tensor with `complex_out`
    (the device checks skipped, so that it runs on the CPU)."""
    monkeypatch.setattr(passes, "check_planes", lambda *a: None)
    table = torch.zeros(S.table_len(n, radices))
    if cin:
        args = (torch.empty(0, n, dtype=torch.complex64), None)
    else:
        args = (torch.empty(0, n), torch.empty(0, n))
    before = (S.launches, S.wide_launches)
    y = S.stockham_c2c_cuda(*args, radices, table, complex_out=cout)
    assert (S.launches, S.wide_launches) == before
    if cout:
        assert isinstance(y, torch.Tensor) and y.dtype == torch.complex64
        assert tuple(passes.shaped(y, (0, n)).shape) == (0, n)
    else:
        assert len(y) == 2 and all(t.dtype == torch.float32 for t in y)
        assert all(tuple(t.shape) == (0, n) for t in y)


@pytest.mark.parametrize("args", [[], ["--peak"]])
def test_edge_layouts_tool_needs_a_card(monkeypatch, capsys, args):
    """The layout timer exits 2 with a message, and times nothing, where
    torch sees no card."""
    from fftw3_tpu_torch.tools import edge_layouts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert edge_layouts.main(args) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


@pytest.mark.parametrize("offset", [1, 2])
def test_edge_layouts_offset_input(offset):
    """The timer's offset inputs hold the aligned input's values, starting
    `offset` complex elements (8 bytes each) into their allocation."""
    from fftw3_tpu_torch.tools import edge_layouts
    x = edge_layouts._complex(torch, (4, 8), CPU)
    xo = edge_layouts._at_offset(torch, x, offset)
    assert xo.is_contiguous() and torch.equal(xo, x)
    assert xo.data_ptr() - xo.untyped_storage().data_ptr() == 8 * offset


@pytest.mark.parametrize("hold", [0, 1, 3])
def test_edge_layouts_hold_keeps_the_last_outputs(hold):
    """``--hold N`` keeps an arm's last N outputs alive and no more."""
    from fftw3_tpu_torch.tools import edge_layouts
    calls = iter(range(10))
    run, kept = edge_layouts._holding(lambda: next(calls), hold)
    outs = [run() for _ in range(5)]
    if hold:
        assert outs == [None] * 5 and list(kept) == list(range(5))[-hold:]
    else:
        assert outs == list(range(5)) and kept is None


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    trace.reset()
    yield CUDA
    trace.reset()


#: K1's schedules pinned where ESTIMATE on the card may leave the kernels
#: (``mixed`` at n = 256 and 4096), so that each case runs its route; n =
#: 4096 is K1's wide form
PINS = {n: {"alg": "pallas", "n": n, "radices": r}
        for n, r in ((256, [16, 16]), (512, [32, 16]), (1000, [50, 20]),
                     (1024, [64, 16]))}
PINS[4096] = {"alg": "pallas", "n": 4096, "radices": [64, 64], "vpu": "all"}


def _card_plan(shape, axes, sign):
    """The plan on the card, each transform axis of a size in PINS pinned
    to its K1 schedule in a planner of its own, the rest ESTIMATE's."""
    pl = planner_mod.Planner()
    total = int(np.prod(shape))
    for a in axes:
        if shape[a] in PINS:
            key = pl._key("c2c", shape[a], np.float32, total // shape[a],
                          CUDA)
            pl.wisdom[key] = {"desc": PINS[shape[a]], "cost": 0.0,
                              "patience": K.PATIENCE_EXHAUSTIVE}
    return plan_mod.make_plan(plan_mod.Problem(shape, axes, "c2c", sign),
                              K.ESTIMATE, planner=pl, device=CUDA)


def _launches():
    return (S.launches, S.wide_launches, inner.launches, fused2d.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axes,sign,route,edges,launches", [
    ((65536, 1024), (1,), K.FORWARD, ["k1"], (1, 1), (1, 0, 0, 0)),
    ((65536, 1024), (1,), K.BACKWARD, ["k1"], (1, 1), (1, 0, 0, 0)),
    ((1023, 1024), (1,), K.FORWARD, ["k1"], (1, 1), (1, 0, 0, 0)),
    ((1023, 1000), (1,), K.FORWARD, ["k1"], (1, 1), (1, 0, 0, 0)),
    ((1023, 1000), (1,), K.BACKWARD, ["k1"], (1, 1), (1, 0, 0, 0)),
    ((64, 4096), (1,), K.FORWARD, ["k1"], (1, 1), (0, 1, 0, 0)),
    ((64, 4096), (1,), K.BACKWARD, ["k1"], (1, 1), (0, 1, 0, 0)),
    ((128, 128, 128), (0, 1, 2), K.FORWARD, ["k2", "k3"], (1, 1),
     (0, 0, 1, 1)),
    ((256, 128, 256), (0, 1, 2), K.BACKWARD, ["k2", "k3"], (1, 1),
     (0, 0, 1, 1)),
    # axes 0 and 1 below K2's window of 128 points (and 64 off K3's
    # multiples of 128): K1 last, writing the output
    ((16, 64, 512), (0, 1, 2), K.FORWARD, [None, None, "k1"], (0, 1),
     (1, 0, 0, 0)),
    # axis 0 below K2's window: K3 last, writing the output
    ((8, 256, 256), (0, 1, 2), K.FORWARD, [None, "k3"], (0, 1),
     (0, 0, 0, 1)),
    ((8, 256, 256), (1, 2), K.FORWARD, ["k3"], (0, 1), (0, 0, 0, 1)),
])
def test_card_execute_is_the_conversion_path(card, shape, axes, sign, route,
                                             edges, launches):
    """``Plan.execute`` bit for bit as the split-planes path, the input
    untouched, a conversion span only at an edge its route's kernels do
    not take, one launch a kernel pass, K3's on the ring."""
    plan = _card_plan(shape, axes, sign)
    assert [{"fftw.stage.k1": "k1", "fftw.stage.k2": "k2",
             "fftw.stage.k3": "k3"}.get(s.name) for s in plan.stages] \
        == route
    x = _complex(shape, seed=11, device=card)
    x0 = x.clone()
    want = _split_path(plan, x)
    before = _launches(), fused2d.ring_launches
    got = plan.execute(x)
    assert tuple(a - b for a, b in zip(_launches(), before[0])) == launches
    # K3 reads the planes K2 or the entry made, aligned: it takes the ring
    assert fused2d.ring_launches - before[1] == launches[3]
    assert torch.equal(got, want) and got.is_contiguous()
    assert torch.equal(x, x0)
    traced, snap = _traced(lambda: plan.execute(x))
    torch.cuda.synchronize()
    assert torch.equal(traced, want)
    assert snap["converts"] == Counter([SPLIT] * (1 - edges[0])
                                       + [COMBINE] * (1 - edges[1]))


def _neg(x):
    return torch._neg_view(x)


@pytest.mark.cuda
@pytest.mark.parametrize("view,edge_in", [
    ("conj", 0), ("neg", 0), ("strided", 0), ("offset", 1),
])
@pytest.mark.parametrize("shape,axes", [((64, 1024), (1,)),
                                        ((128, 128, 128), (0, 1, 2))])
def test_card_fallbacks_give_the_same(card, view, edge_in, shape, axes):
    """A lazy conjugate, a lazy negative, a non-contiguous view and a
    storage offset that breaks 16-byte alignment: the same result as the
    split-planes path.  The first three are copied once at the entry; the
    offset tensor is read by the kernel itself, 8 bytes a point."""
    plan = _card_plan(shape, axes, K.FORWARD)
    n = int(np.prod(shape))
    if view == "conj":
        x = _complex(shape, seed=12, device=card).conj()
    elif view == "neg":
        x = _neg(_complex(shape, seed=12, device=card))
    elif view == "strided":
        x = _complex(shape[:-1] + (2 * shape[-1],), seed=12,
                     device=card)[..., ::2]
    else:
        x = _complex((n + 1,), seed=12, device=card)[1:].view(shape)
        assert x.data_ptr() % 16 == 8
    want = _split_path(plan, x)
    assert torch.equal(want, _split_path(plan, x.resolve_conj()
                                         .resolve_neg().contiguous()))
    ring = fused2d.ring_launches
    got, snap = _traced(lambda: plan.execute(x))
    assert torch.equal(got, want)
    assert torch.equal(plan.execute(x), want)
    assert fused2d.ring_launches - ring == 2 * (len(shape) == 3)
    assert snap["converts"] == Counter([SPLIT] * (1 - edge_in))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axes", [((256, 1024), (1,)),
                                        ((128, 128, 128), (0, 1, 2))])
def test_card_gradient_matches_the_conversion_path(card, shape, axes):
    plan = _card_plan(shape, axes, K.FORWARD)
    x = _complex(shape, seed=13, device=card).requires_grad_()
    g = _complex(shape, seed=14, device=card)
    got, = torch.autograd.grad(plan.execute(x), x, g)
    want, = torch.autograd.grad(_split_path(plan, x), x, g)
    assert got.dtype == torch.complex64
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["apply", "execute"])
@pytest.mark.parametrize("shape,axes", [
    ((1024,), (0,)), ((4096,), (0,)), ((128, 128, 128), (0, 1, 2)),
])
def test_card_empty_batch(card, entry, shape, axes):
    """An empty leading batch (K1, K1's wide form, K2 then K3), through
    ``Plan.apply`` on the transform's plan and through ``Plan.execute``
    on a plan of the empty batch: an empty complex64 output, as the
    conversion path gives, and no launch."""
    if entry == "apply":
        plan = _card_plan(shape, axes, K.FORWARD)
    else:
        plan = _card_plan((0,) + shape, tuple(a + 1 for a in axes),
                          K.FORWARD)
    assert [s.name for s in plan.stages] in (
        ["fftw.stage.k1"], ["fftw.stage.k2", "fftw.stage.k3"])
    x = torch.empty((0,) + shape, dtype=torch.complex64, device=card)
    before = _launches()
    got = plan.apply(x) if entry == "apply" else plan.execute(x)
    assert _launches() == before
    want = _split_path(plan, x)
    assert got.dtype == torch.complex64 and tuple(got.shape) == x.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["conj", "neg", "strided"])
@pytest.mark.parametrize("shape,axes,allocations", [
    ((64, 1024), (1,), 2), ((128, 128, 128), (0, 1, 2), 4)])
def test_card_lazy_and_strided_inputs_make_one_copy(card, view, shape, axes,
                                                    allocations):
    """A lazy conjugate, a lazy negative and a strided complex64 input to
    a K1- or K2-first plan: one complex copy in ``fftw.convert.split``
    (K1's call allocates that copy and its output; K2 then K3 the copy,
    K2's two planes and K3's output), and the output of the split-planes
    path bit for bit."""
    plan = _card_plan(shape, axes, K.FORWARD)
    x = _x(shape, view, device=card)
    want = _split_path(plan, x.resolve_conj().resolve_neg().contiguous())
    torch.cuda.synchronize()
    count = torch.cuda.memory_stats(card)["allocation.all.allocated"]
    got = plan.execute(x)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(card)["allocation.all.allocated"] \
        - count == allocations
    assert torch.equal(got, want)
    traced, snap = _traced(lambda: plan.execute(x))
    assert torch.equal(traced, want)
    assert snap["converts"] == Counter([SPLIT])


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [False, True])
@pytest.mark.parametrize("sign", [K.FORWARD, K.BACKWARD])
@pytest.mark.parametrize("n,radices,pre,L", [
    # the half spectra of conv (8 fields) and ns (16, and the stacked 4 x
    # 16): 256 full tiles of 4 columns and a masked 1-column edge tile a
    # plane
    (2048, [128, 16], 8, 1025), (2048, [128, 16], 16, 1025),
    (2048, [128, 16], 64, 1025),
    # one column, three planes a block; a dense last level (radix 7)
    (2048, [128, 16], 3, 1), (112, [16, 7], 5, 130),
])
def test_card_k2_complex_out_is_its_planes(card, n, radices, pre, L, sign,
                                           cin):
    """K2 writing complex64, from planes or from complex64, is
    ``torch.complex`` of its planar output bit for bit, and counts one
    launch in ``inner.launches`` and in ``inner.cout_launches``."""
    table = S.device_table(n, tuple(radices), sign, card)
    x = _complex((pre, n, L), seed=pre + L, device=card)
    xs = (x, None) if cin else (x.real.contiguous(), x.imag.contiguous())
    planes = inner.inner_c2c_cuda(*xs, radices, table)
    before = inner.launches, inner.cout_launches
    got = inner.inner_c2c_cuda(*xs, radices, table, complex_out=True)
    torch.cuda.synchronize()
    assert (inner.launches - before[0], inner.cout_launches - before[1]) \
        == (1, 1)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    assert torch.equal(got, torch.complex(*planes))


def _real_plans(entry, shape, card):
    """The r2c and c2r plans of real fields of `shape` over their two
    trailing axes: as conv's ``plan_many_dft_r2c``/``_c2r`` make them for
    ``execute``, else as ``plan_dft_r2c``/``_c2r`` of the whole shape."""
    if entry == "execute":
        n, howmany = list(shape[-2:]), int(np.prod(shape[:-2]))
        return (ft.plan_many_dft_r2c(n, howmany, device=card),
                ft.plan_many_dft_c2r(n, howmany, device=card))
    axes = (len(shape) - 2, len(shape) - 1)
    return (ft.plan_dft_r2c(shape, axes=axes, device=card),
            ft.plan_dft_c2r(shape, axes=axes, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("entry,shape", [
    ("execute", (8, 2048, 2048)),       # conv's plans
    ("api", (16, 2048, 2048)),          # ns's rfftn and irfftn
    ("api", (4, 16, 2048, 2048)),       # ns's stacked irfftn
])
def test_card_real_2d_is_the_conversion_path(card, entry, shape):
    """``Plan.execute`` of conv's plans and ``rfftn``/``irfftn`` of ns's
    shapes: bit for bit the conversion path (``torch.complex(*r2c.
    apply_split(x))``, ``c2r.apply_split(X.real, X.imag)``, irfftn's 1/N
    after it), no ``fftw.convert.*`` span, one K2 launch a call, which
    writes complex64 in the r2c and reads it in the c2r."""
    r2c, c2r = _real_plans(entry, shape, card)
    x = torch.rand(shape, generator=torch.Generator(card).manual_seed(15),
                   device=card) - 0.5
    scale = 1.0
    if entry == "execute":
        fwd, inv = r2c.execute, c2r.execute
    else:
        fwd = lambda a: ft.rfftn(a, axes=(-2, -1))                # noqa
        inv = lambda a: ft.irfftn(a, s=shape[-2:], axes=(-2, -1))  # noqa
        scale = 1.0 / np.prod(shape[-2:])
    want = torch.complex(*r2c.apply_split(x))
    for run, arg, check in ((fwd, x, want),
                            (inv, want, c2r.apply_split(want.real, want.imag)
                             * scale)):
        before = inner.launches, inner.cout_launches
        got, snap = _traced(lambda: run(arg))
        torch.cuda.synchronize()
        assert torch.equal(got, check)
        assert (inner.launches - before[0], inner.cout_launches - before[1]) \
            == (1, int(run is fwd))
        assert snap["converts"] == Counter()
    del want, check


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axes,cout", [
    ((512, 512, 512), (0, 1, 2), 0),     # K2 first, reading, then K3
    ((256, 8, 16), (0,), 1),             # K2 alone, reading and writing
])
def test_card_k2_writes_complex_only_where_it_is_last(card, shape, axes,
                                                      cout):
    """A c2c plan's K2 pass writes complex64 only where it is the route's
    last pass: never in the 512^3 route (K2, then K3), once a call where
    it is alone; the output is the split-planes path's bit for bit."""
    plan = _card_plan(shape, axes, K.FORWARD)
    x = _complex(shape, seed=16, device=card)
    want = _split_path(plan, x)
    before = inner.launches, inner.cout_launches
    got = plan.execute(x)
    torch.cuda.synchronize()
    assert (inner.launches - before[0], inner.cout_launches - before[1]) \
        == (1, cout)
    assert torch.equal(got, want)
