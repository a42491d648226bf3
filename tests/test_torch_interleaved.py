"""The complex entry's edges in the kernels: a c2c plan's first pass reads
the caller's complex64 tensor itself and its last pass writes the complex
output itself where their kernels can (K1 on the last axis both, K2 the
input, K3 the output), and every other edge converts as before.

The CPU tests hold the decision (the forms each kernel's apply declares,
``plan.complex_edges``), the routes that get the forms, the plans that
convert as before (CPU, complex128, ``pallas4``, r2c, c2r), the passes'
complex layouts through the twins and autograd, the conversions' spans,
an empty batch, and the edge counters of ``trace.py``.  The card tests (``cuda`` marker) hold ``Plan.execute``
bit for bit against the conversion path and skip without a card.  This
file imports no JAX.
"""
from types import SimpleNamespace

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
from fftw3_tpu_torch.ops import fused2d, inner
from fftw3_tpu_torch.ops import real as real_ops
from fftw3_tpu_torch.ops import stockham as S

CPU = torch.device("cpu")
CUDA = torch.device("cuda")
CONVERT = ("fftw.convert.split", "fftw.convert.combine")


def _complex(shape, seed=0, device=CPU, dtype=torch.complex64):
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, dtype=dtype, device=device, generator=g)


def _split_path(plan, x):
    """The conversion path: split planes, ``apply_split``, combine."""
    return torch.complex(*plan.apply_split(x.real.contiguous(),
                                           x.imag.contiguous()))


def _traced(fn):
    """`fn()` under the profiler, and the record's snapshot; its
    ``plan_converts`` are the names of the conversion spans a plan's
    entry or exit ran (those opened in the call's root, not in a pass)."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    plan_converts = {r.name for r in trace.records() if r.name in CONVERT
                     and r.parent is not None and r.parent.root}
    snap = trace.snapshot(reset=True)
    snap["plan_converts"] = plan_converts
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


@pytest.fixture
def forced(cpu_plans, monkeypatch):
    """CPU plans and a decision that takes their passes' forms on the CPU
    too: the twins then run the complex layouts (converting inside each
    pass) on the CUDA route's logic."""
    monkeypatch.setattr(
        plan_mod, "complex_edges",
        lambda x, stages: (bool(stages) and stages[0].reads,
                           bool(stages) and stages[-1].writes))


# -- the decision -------------------------------------------------------------

def _kernel_apply(kernel):
    """The apply of a pass on `kernel`, built on the CPU (the forms it
    declares do not depend on the device)."""
    desc = {"alg": "pallas", "n": 128, "radices": [128]}
    if kernel == "k1":
        return S.build_pallas_c2c_split(desc, K.FORWARD, np.float32, CPU)
    if kernel == "k2":
        return inner.build_pallas_c2c_split_inner(desc, K.FORWARD,
                                                  np.float32, CPU)
    if kernel == "k3":
        return fused2d.build_pallas_c2c_split_2d(128, 128, K.FORWARD,
                                                 np.float32, desc, desc, CPU)
    if kernel == "k4":
        return real_ops.build_r2c_split(
            {"alg": "pallas_r2c", "n": 256, "radices": [16, 8]},
            np.float32, CPU)
    return c2c_ops.build_c2c_split({"alg": "mixed", "n": 64, "p": 8,
                                    "child": {"alg": "direct", "n": 8}},
                                   K.FORWARD, np.float32, CPU)


@pytest.mark.parametrize("kernel,device,forms", [
    ("k1", "cuda", (True, True)), ("k2", "cuda", (True, False)),
    ("k3", "cuda", (False, True)), ("k4", "cuda", (False, False)),
    ("mixed", "cuda", (False, False)), ("k1", "cpu", (False, False)),
    ("k2", "cpu", (False, False)), ("k3", "cpu", (False, False)),
])
def test_edge_forms_by_kernel_and_device(kernel, device, forms):
    """The edges a one-pass route on `kernel` takes for a complex64 input
    on `device`: the forms the kernel's apply declares (K1 both, K2 the
    input, K3 the output, others none), on a CUDA input only."""
    fn = _kernel_apply(kernel)
    stage = plan_mod._kernel_stage("fftw.stage.x", fn, fn)
    assert plan_mod.complex_edges(_x(device), [stage]) == forms


def _x(device="cuda", dtype=torch.complex64, contiguous=True, conj=False,
       neg=False):
    """A stand-in for the input: what the decision reads of a tensor."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           is_contiguous=lambda: contiguous,
                           is_conj=lambda: conj, is_neg=lambda: neg)


def _route(*forms):
    return [plan_mod._Stage(f"fftw.stage.{i}", None, r, w)
            for i, (r, w) in enumerate(forms)]


K1 = (True, True)
K2 = (True, False)
K3 = (False, True)
OTHER = (False, False)


@pytest.mark.parametrize("x,route,edges", [
    (_x(), [K1], (True, True)),
    (_x(), [K2, K3], (True, True)),
    (_x(), [K2, K1], (True, True)),
    (_x(), [K3], (False, True)),
    (_x(), [K2], (True, False)),
    (_x(), [OTHER, K1], (False, True)),
    (_x(), [K2, OTHER], (True, False)),
    (_x(), [OTHER], (False, False)),
    (_x(), [], (False, False)),
    (_x(device="cpu"), [K1], (False, False)),
    (_x(dtype=torch.complex128), [K1], (False, False)),
    (_x(contiguous=False), [K1], (False, True)),
    (_x(conj=True), [K1], (False, True)),
    (_x(neg=True), [K2, K3], (False, True)),
])
def test_complex_edges_decision(x, route, edges):
    assert plan_mod.complex_edges(x, _route(*route)) == edges


def _forms(plan):
    return [(s.name, s.reads, s.writes) for s in plan.stages]


@pytest.mark.parametrize("make,forms", [
    (lambda: ft.plan_many_dft([1024], 8, dtype="complex64"),
     [("fftw.stage.k1", True, True)]),
    (lambda: ft.plan_dft((128, 128, 128), axes=(0, 1, 2), dtype="complex64"),
     [("fftw.stage.k2", True, False), ("fftw.stage.k3", False, True)]),
    (lambda: ft.plan_dft((128, 4, 128), axes=(0, 2), dtype="complex64"),
     [("fftw.stage.k2", True, False), ("fftw.stage.k1", True, True)]),
    # K1 lifted onto a non-last axis (a movedim): no form
    (lambda: ft.plan_dft((128, 8), axes=(0,), dtype="complex64"),
     [("fftw.stage.k1", False, False)]),
    (lambda: ft.plan_many_dft([64], 8, dtype="complex64"),
     [("fftw.stage.direct", False, False)]),
])
def test_routes_get_the_forms_of_their_kernels(forced, make, forms):
    assert _forms(make()) == forms


def test_cpu_plans_have_no_forms(cpu_plans):
    """A CPU plan's passes declare their kernels' forms, but a CPU input
    takes none of them: its entry splits and its exit combines, as
    before."""
    for plan in (ft.plan_many_dft([1024], 8, dtype="complex64"),
                 ft.plan_dft((128, 128, 128), axes=(0, 1, 2),
                             dtype="complex64")):
        assert plan.stages[0].reads and plan.stages[-1].writes
        x = _complex(plan.problem.shape, seed=6)
        assert plan_mod.complex_edges(x, plan.stages) == (False, False)
        got, snap = _traced(lambda: plan.execute(x))
        assert torch.equal(got, _split_path(plan, x))
        assert snap["plan_converts"] == set(CONVERT)
        assert snap["marks"] == {"edge.in": 0, "edge.out": 0, "k3.ring": 0}


def test_complex128_and_pallas4_passes_have_no_forms(forced):
    plan = ft.plan_many_dft([1024], 4, dtype="complex128")
    assert [(s.reads, s.writes) for s in plan.stages] == [(False, False)]
    four = plan_mod._c2c_stage({"alg": "pallas4", "n": 4096, "p": 32,
                                "q": 128}, K.FORWARD, np.float32, 1,
                               (2, 4096), CPU)
    assert (four.name, four.reads, four.writes) == \
        ("fftw.stage.pallas4", False, False)


@pytest.mark.parametrize("kind", ["r2c", "c2r", "c2c128"])
def test_other_complex_sides_convert_as_before(forced, kind):
    """r2c combines at the exit, c2r splits at the entry, complex128
    does both: their records hold the conversions and no edge."""
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
    assert {n for n in snap["spans"] if n in CONVERT} == set(want)
    assert snap["marks"] == {"edge.in": 0, "edge.out": 0, "k3.ring": 0}


# -- the passes' complex layouts on the CPU route ------------------------------

@pytest.mark.parametrize("shape,axes,sign", [
    ((6, 1024), (1,), K.FORWARD),
    ((5, 1000), (1,), K.BACKWARD),
    ((128, 128, 128), (0, 1, 2), K.FORWARD),
    ((128, 4, 128), (0, 2), K.BACKWARD),
    ((3, 128, 128), (1, 2), K.FORWARD),
    ((3, 128, 256), (1, 2), K.FORWARD),
])
def test_forced_edges_match_the_conversion_path(forced, shape, axes, sign):
    """The edges taken (twins converting inside the passes): the same
    output bit for bit, the input untouched, a conversion span only at an
    edge the route's kernels do not take, one mark of each edge they take
    a call."""
    plan = ft.plan_dft(shape, axes=axes, sign=sign, dtype="complex64")
    x = _complex(shape, seed=1)
    x0 = x.clone()
    want = _split_path(plan, x)
    got, snap = _traced(lambda: plan.execute(x))
    assert torch.equal(got, want) and got.dtype == torch.complex64
    assert torch.equal(x, x0)
    read, write = plan.stages[0].reads, plan.stages[-1].writes
    assert ("fftw.convert.split" in snap["plan_converts"]) == (not read)
    assert ("fftw.convert.combine" in snap["plan_converts"]) == (not write)
    assert snap["marks"] == {"edge.in": int(read), "edge.out": int(write),
                             "k3.ring": 0}
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


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3"])
@pytest.mark.parametrize("cin,cout", [(True, False), (False, True),
                                      (True, True)])
def test_a_pass_takes_and_gives_every_layout(cpu_plans, kernel, cin, cout):
    """Each of K1's, K2's and K3's applies takes the complex tensor itself
    (xi None) and gives the complex output (cout), converting where its
    kernel has no form, with the planes' values; its backward gives the
    gradient in the input's layout."""
    desc = {"alg": "pallas", "n": 128, "radices": [128]}
    if kernel == "k1":
        apply = S.build_pallas_c2c_split(desc, K.FORWARD, np.float32, CPU)
    elif kernel == "k2":
        apply = inner.build_pallas_c2c_split_inner(desc, K.FORWARD,
                                                   np.float32, CPU)
    else:
        apply = fused2d.build_pallas_c2c_split_2d(128, 128, K.FORWARD,
                                                  np.float32, desc, desc, CPU)
    x = _complex((2, 128, 128), seed=4).requires_grad_()
    want = torch.complex(*apply(x.real, x.imag))
    got = apply(x, None, cout) if cin else apply(x.real, x.imag, cout)
    got_c = got if cout else torch.complex(*got)
    assert torch.equal(got_c, want)
    g = _complex((2, 128, 128), seed=5)
    d_got, = torch.autograd.grad(got_c, x, g)
    d_want, = torch.autograd.grad(want, x, g)
    assert torch.equal(d_got, d_want)


def test_in_pass_conversions_are_traced(forced):
    """A conversion inside a pass (a twin's, or a kernel's adjoint with no
    such form) runs in the same ``fftw.convert.*`` spans as the plan's
    edges, opened in the pass's span."""
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
    monkeypatch.setattr(S, "check_planes", lambda *a: None)
    table = torch.zeros(S._table_len(n, radices))
    if cin:
        args = (torch.empty(0, n, dtype=torch.complex64), None)
    else:
        args = (torch.empty(0, n), torch.empty(0, n))
    before = (S.launches, S.wide_launches)
    y = S.stockham_c2c_cuda(*args, radices, table, complex_out=cout)
    assert (S.launches, S.wide_launches) == before
    if cout:
        assert isinstance(y, torch.Tensor) and y.dtype == torch.complex64
        assert tuple(S.shaped(y, (0, n)).shape) == (0, n)
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


# -- the counters ---------------------------------------------------------------

def test_edge_marks_count_per_call_in_the_window(forced):
    plan = ft.plan_many_dft([1024], 4, dtype="complex64")
    x = _complex((4, 1024))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            plan.execute(x)
        trace.edges(True, True)          # outside any call: no mark
    snap = trace.snapshot()
    assert snap["calls"] == 3
    assert snap["marks"] == {"edge.in": 3, "edge.out": 3, "k3.ring": 0}
    roots = [r for r in trace.records() if r.root]
    assert [r.marks for r in roots] == [("edge.in", "edge.out")] * 3
    last = roots[-1]
    within = trace.snapshot(within=(last.start_ns, last.end_ns))
    assert within["marks"] == {"edge.in": 1, "edge.out": 1, "k3.ring": 0}


class _NoLock:
    def __enter__(self):
        raise AssertionError("the untraced path took the trace lock")

    def __exit__(self, *exc):
        return False


def test_edge_marks_off_touch_nothing(forced, monkeypatch):
    """Tracing off, the marks cost nothing: no lock, no counter, no
    record, on the mark itself and on a call that takes both edges."""
    assert not torch.autograd.profiler._is_profiler_enabled
    plan = ft.plan_many_dft([1024], 4, dtype="complex64")
    x = _complex((4, 1024))
    want = _split_path(plan, x)
    trace.reset()

    def no_add(*a, **k):
        raise AssertionError("the untraced path added to a counter")
    monkeypatch.setattr(trace, "_lock", _NoLock())
    monkeypatch.setattr(trace, "add", no_add)
    trace.edges(True, True)
    assert torch.equal(plan.execute(x), want)
    monkeypatch.undo()
    assert trace.records() == []
    assert trace.snapshot()["marks"] == {"edge.in": 0, "edge.out": 0,
                                         "k3.ring": 0}


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
    """``Plan.execute`` bit for bit as the conversion path, the input
    untouched, the edges its route has marked once a traced call, no
    conversion span where both edges are the kernels', one launch a
    kernel pass."""
    plan = _card_plan(shape, axes, sign)
    assert [{"fftw.stage.k1": "k1", "fftw.stage.k2": "k2",
             "fftw.stage.k3": "k3"}.get(s.name) for s in plan.stages] \
        == route
    x = _complex(shape, seed=11, device=card)
    x0 = x.clone()
    want = _split_path(plan, x)
    before = _launches()
    got = plan.execute(x)
    assert tuple(a - b for a, b in zip(_launches(), before)) == launches
    assert torch.equal(got, want) and got.is_contiguous()
    assert torch.equal(x, x0)
    traced, snap = _traced(lambda: plan.execute(x))
    torch.cuda.synchronize()
    assert torch.equal(traced, want)
    # K3 reads the planes K2 or the entry made, aligned: it takes the ring
    assert snap["marks"] == {"edge.in": edges[0], "edge.out": edges[1],
                             "k3.ring": launches[3]}
    assert ("fftw.convert.split" in snap["spans"]) == (not edges[0])
    assert ("fftw.convert.combine" in snap["spans"]) == (not edges[1])


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
    conversion path.  The first three convert at the entry; the offset
    tensor is read by the kernel itself, 8 bytes a point."""
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
    got, snap = _traced(lambda: plan.execute(x))
    assert torch.equal(got, want)
    assert torch.equal(plan.execute(x), want)
    assert snap["marks"] == {"edge.in": edge_in, "edge.out": 1,
                             "k3.ring": int(len(shape) == 3)}
    assert ("fftw.convert.split" in snap["spans"]) == (not edge_in)


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
    assert plan.stages[0].reads and plan.stages[-1].writes
    x = torch.empty((0,) + shape, dtype=torch.complex64, device=card)
    before = _launches()
    got = plan.apply(x) if entry == "apply" else plan.execute(x)
    assert _launches() == before
    want = _split_path(plan, x)
    assert got.dtype == torch.complex64 and tuple(got.shape) == x.shape
    assert torch.equal(got, want)
