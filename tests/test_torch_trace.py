"""The port's spans and counters (``fftw3_tpu_torch/trace.py``): nothing
recorded with the profiler off, the call path's spans nested under one
call id with it on, on the profiler's own clock, outputs unchanged by it,
the set-up counters, the record's cap and sessions; a model's step
spans beside the plans' roots, which stay as they are; and the one namespace
of the port's kernels in ``csrc/``.  The tests marked ``cuda`` need a
card and skip without one; this file imports no JAX.
"""
import itertools
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import api, config, models, trace
from fftw3_tpu_torch.ops import fused2d

CSRC = Path(ft.__file__).parent / "csrc"
KERNEL_MAPS = Path(__file__).resolve().parents[1] / "bench_torch" / "kernels"
CPU = torch.device("cpu")


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


def _complex(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape)).to(
                                torch.complex64)


def _traced(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, prof


# -- off ----------------------------------------------------------------------

def test_off_is_one_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    a = trace.span("fftw.stage.k1", torch.device("cuda"))
    assert a is trace.span("x") is trace.call("fftw.execute", CPU)
    with a as got:
        assert got is None


def test_off_records_nothing(cpu_plans):
    plan = ft.plan_many_dft([256], 4, dtype="complex64", device="cpu")
    plan.execute(_complex((4, 256)))
    ft.execute_split_dft(plan, torch.ones(4, 256), torch.zeros(4, 256))
    assert trace.records() == []
    assert trace.snapshot()["calls"] == 0


class _Event:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.stream = None

    def record(self, stream=None):
        self.stream = stream

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 0.25


@pytest.mark.parametrize("on", [False, True])
def test_cuda_events_only_while_profiling(monkeypatch, on):
    """A span given a CUDA device, inside a root on one, takes a pair of
    events on its current stream while the profiler runs, and none
    otherwise; the root and a span given no device take none.  A snapshot
    keeps the events' time and drops them."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: ("s", d))
    monkeypatch.setattr(_Event, "made", 0)
    monkeypatch.setattr(trace, "EVENT_EVERY", 1)
    trace.reset()
    dev = torch.device("cuda", 0)

    def run():
        with trace.call("fftw.execute", dev):
            with trace.span("fftw.convert.split", dev):
                pass
            with trace.span("fftw.launch.k"):
                pass
    if on:
        _traced(run)
    else:
        run()
    recs = trace.records()
    assert _Event.made == (2 if on else 0)
    assert len(recs) == (3 if on else 0)
    if on:
        assert recs[0].events is None and recs[2].events is None
        assert [e.stream for e in recs[1].events] == [("s", dev)] * 2
        snap = trace.snapshot(reset=True)
        assert snap["calls"] == snap["timed_calls"] == 1
        assert snap["spans"]["fftw.convert.split"]["device_ms"] == 0.25
        assert snap["spans"]["fftw.execute"]["device_ms"] is None
        assert snap["spans"]["fftw.launch.k"]["device_ms"] is None
        assert recs[1].events is None and recs[1].device_ms == 0.25


def test_every_few_calls_take_events(monkeypatch):
    """Only the spans of every ``EVENT_EVERY``-th call on a CUDA device
    take events, each of that call's spans given one."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: ("s", d))
    monkeypatch.setattr(trace, "EVENT_EVERY", 4)
    trace.reset()
    dev = torch.device("cuda", 0)

    def calls():
        for _ in range(8):
            with trace.call("fftw.execute", dev):
                with trace.span("fftw.convert.split", dev):
                    pass
        for _ in range(4):
            with trace.call("fftw.execute", CPU):
                with trace.span("fftw.convert.split", dev):
                    pass
    _traced(calls)
    snap = trace.snapshot(reset=True)
    assert snap["calls"] == 12 and snap["timed_calls"] == 2
    split = snap["spans"]["fftw.convert.split"]
    assert split["count"] == 12 and split["timed"] == 2
    assert split["device_ms"] == 0.5


def test_each_plan_samples_its_own_calls(cpu_plans, monkeypatch):
    """An r2c plan and a c2r plan called in turn, as FFT filtering calls
    them, each get every ``EVENT_EVERY``-th of their own calls timed, and
    so both conversions take events (a count by call id would time one
    plan alone).  The device is made to read as a card, so that the
    sampling, not the device, decides."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: ("s", d))
    monkeypatch.setattr(trace, "_cuda", lambda d: d is not None)
    monkeypatch.setattr(trace, "EVENT_EVERY", 4)
    r2c = ft.plan_many_dft_r2c([64], 2, device="cpu")
    c2r = ft.plan_many_dft_c2r([64], 2, device="cpu")
    x = torch.ones(2, 64)

    def calls():
        for _ in range(8):
            c2r.execute(r2c.execute(x))
    _traced(calls)
    roots = [r for r in trace.records() if r.root]     # r2c, c2r, r2c, ...
    timed = [k for r, k in zip(roots, ["r2c", "c2r"] * 8) if r.timed]
    assert len(roots) == 16 and timed == ["r2c", "c2r"] * 2
    snap = trace.snapshot(reset=True)
    assert snap["calls"] == 16 and snap["timed_calls"] == 4
    assert snap["spans"]["fftw.convert.combine"]["timed"] == 2
    assert snap["spans"]["fftw.convert.split"]["timed"] == 2


def test_one_plan_samples_as_by_call_id(cpu_plans, monkeypatch):
    """A plan called alone in a process times the calls it timed when the
    count was the call id: those whose id is a multiple of
    ``EVENT_EVERY``."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: ("s", d))
    monkeypatch.setattr(trace, "_cuda", lambda d: d is not None)
    monkeypatch.setattr(trace, "EVENT_EVERY", 4)
    monkeypatch.setattr(trace, "_calls", itertools.count(1))
    plan = ft.plan_many_dft([64], 2, dtype="complex64", device="cpu")
    x = _complex((2, 64))

    def calls():
        for _ in range(12):
            plan.execute(x)
    _traced(calls)
    roots = [r for r in trace.records() if r.root]
    assert [r.call for r in roots] == list(range(1, 13))
    assert [r.call for r in roots if r.timed] == [
        c for c in range(1, 13) if c % trace.EVENT_EVERY == 0]


# -- on -----------------------------------------------------------------------

def _names(recs):
    return [r.name for r in recs]


def test_c2c_spans_nest_under_one_call(cpu_plans):
    plan = ft.plan_dft((8, 16, 128), axes=(0, 1, 2), dtype="complex64",
                       device="cpu")
    _traced(plan.execute, _complex((8, 16, 128)))
    recs = trace.records()
    root = recs[0]
    assert root.name == "fftw.execute" and root.root and root.parent is None
    stages = [r for r in recs if r.parent is root]
    assert _names(stages) == ["fftw.stage.direct", "fftw.stage.direct",
                              "fftw.stage.k1"]
    # the first pass splits the complex input, the last combines its
    # output: each conversion runs inside the pass that needs it
    split, combine = recs[2], recs[-1]
    assert (split.name, split.parent) == ("fftw.convert.split", stages[0])
    assert (combine.name, combine.parent) == ("fftw.convert.combine",
                                              stages[-1])
    assert len(recs) == 6
    for r in recs[1:]:
        assert r.call == root.call and not r.root
        assert r.parent.start_ns <= r.start_ns <= r.end_ns \
            <= r.parent.end_ns
    snap = trace.snapshot()
    assert snap["calls"] == 1 and snap["dropped"] == 0
    assert snap["spans"]["fftw.convert.split"]["count"] == 1
    assert snap["spans"]["fftw.execute"]["device_ms"] is None


def test_calls_count_roots_and_ids_differ(cpu_plans):
    plan = ft.plan_many_dft([128], 2, dtype="complex64", device="cpu")
    x = _complex((2, 128))

    def twice():
        plan.execute(x)
        plan.apply(x)
    _traced(twice)
    roots = [r for r in trace.records() if r.root]
    assert _names(roots) == ["fftw.execute"] * 2
    assert roots[0].call != roots[1].call
    assert trace.snapshot()["calls"] == 2


@pytest.mark.parametrize("shape, axes, stages", [
    ((4, 128, 128), (0, 1, 2), ["direct", "k3"]),
    ((128, 8, 16), (0,), ["k2"]),
    ((8, 16, 128), (0, 1, 2), ["direct", "direct", "k1"]),
    ((2, 64, 256), (2,), ["mixed"]),
])
def test_stage_names_say_what_runs(cpu_plans, shape, axes, stages):
    """K1 on the last axis, K2 on a non-last axis behind a reshape, K3 on
    a fused trailing pair; a pass on no port kernel is named by its alg
    (the plans' descriptors on the CPU twins, in the planner's
    defaults)."""
    plan = ft.plan_dft(shape, axes=axes, dtype="complex64", device="cpu")
    _traced(plan.execute, _complex(shape))
    got = [r.name for r in trace.records() if r.name.startswith("fftw.stage")]
    assert got == [f"fftw.stage.{s}" for s in stages], repr(plan)


def test_k3_twin_takes_no_ring(cpu_plans):
    """A fused trailing pair on the CPU runs K3's twin: no launch, no
    ring, no compiled-in levels."""
    plan = ft.plan_dft((4, 128, 128), axes=(0, 1, 2), dtype="complex64",
                       device="cpu")
    before = (fused2d.launches, fused2d.ring_launches,
              fused2d.fixed_launches)
    _traced(plan.execute, _complex((4, 128, 128)))
    assert "fftw.stage.k3" in trace.snapshot()["spans"]
    assert (fused2d.launches, fused2d.ring_launches,
            fused2d.fixed_launches) == before


def test_spans_are_profiler_events_on_its_clock(cpu_plans):
    """Each span is a range event of the profiler, and its in-memory
    interval lies inside that event's: one clock."""
    plan = ft.plan_many_dft([256], 8, dtype="complex64", device="cpu")
    x = _complex((8, 256))
    _, prof = _traced(lambda: [plan.execute(x) for _ in range(3)])
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("fftw.") and e.device_type() == DeviceType.CPU:
            events.setdefault(e.name(), []).append(e)
    recs = trace.records()
    assert {r.name for r in recs} == set(events)
    for name, evs in events.items():
        mine = sorted((r for r in recs if r.name == name),
                      key=lambda r: r.start_ns)
        evs.sort(key=lambda e: e.start_ns())
        assert len(mine) == len(evs)
        for r, e in zip(mine, evs):
            assert e.start_ns() <= r.start_ns <= r.end_ns <= e.end_ns()
    lo, hi = min(r.start_ns for r in recs), max(r.end_ns for r in recs)
    assert trace.snapshot(within=(lo, hi))["calls"] == 3
    assert trace.snapshot(within=(hi, hi + 1))["calls"] == 0


def test_split_entry_has_no_conversion(cpu_plans):
    plan = ft.plan_guru_split_dft([256], [4], dtype="float32", device="cpu")
    xr, xi = torch.randn(4, 256), torch.randn(4, 256)
    _traced(ft.execute_split_dft, plan, xr, xi)
    _traced(plan.execute, xr, xi)
    recs = trace.records()
    assert [r.name for r in recs if r.root] == ["fftw.execute_split"] * 2
    assert not any(r.name.startswith("fftw.convert") for r in recs)
    assert any(r.name.startswith("fftw.stage.") for r in recs)


@pytest.mark.parametrize("kind", ["c2c", "r2c", "c2r"])
def test_outputs_bit_identical_with_profiler(cpu_plans, kind):
    shape = (4, 32, 64)
    if kind == "c2c":
        plan = ft.plan_dft(shape, axes=(1, 2), dtype="complex64",
                           device="cpu")
        x = _complex(shape)
    elif kind == "r2c":
        plan = ft.plan_dft_r2c(shape, axes=(1, 2), dtype="float32",
                               device="cpu")
        x = torch.randn(shape)
    else:
        plan = ft.plan_dft_c2r(shape, axes=(1, 2), dtype="float32",
                               device="cpu")
        x = _complex((4, 32, 33))
    plain = plan.execute(x)
    traced, _ = _traced(plan.execute, x)
    assert torch.equal(plain, traced)
    names = {r.name for r in trace.records()}
    assert ("fftw.convert.split" in names) == (kind == "c2r" or kind == "c2c")
    assert ("fftw.convert.combine" in names) == (kind != "c2r")


@pytest.mark.parametrize("on", [False, True])
def test_split_planes_freed_after_the_first_pass(cpu_plans, monkeypatch, on):
    """A complex entry's two planes live only until its first pass has
    run, as the copies the passes made themselves did: at the second
    pass of a 3-D plan no reference to them is left."""
    import weakref
    plan = ft.plan_dft((8, 16, 128), axes=(0, 1, 2), dtype="complex64",
                       device="cpu")
    x = _complex((8, 16, 128))
    planes, stages, alive = [], [], []
    contiguous, span = torch.Tensor.contiguous, trace.span

    def recording_contiguous(t, *a, **k):
        out = contiguous(t, *a, **k)
        if out is not t and len(planes) < 2:
            planes.append(weakref.ref(out))
        return out

    def watching_span(name, device=None):
        if name.startswith("fftw.stage."):
            stages.append(name)
            if len(stages) == 2:
                alive.extend(r() is not None for r in planes)
        return span(name, device)
    monkeypatch.setattr(torch.Tensor, "contiguous", recording_contiguous)
    monkeypatch.setattr(trace, "span", watching_span)
    want = plan.execute(x) if not on else None
    planes.clear(), stages.clear(), alive.clear()
    got = _traced(plan.execute, x)[0] if on else plan.execute(x)
    assert len(planes) == 2 and len(stages) == 3
    assert alive == [False, False]
    if want is not None:
        assert torch.equal(got, want)


def test_r2r_spans(cpu_plans):
    plan = ft.plan_r2r((4, 64), ["REDFT10"], axes=(1,), dtype="float32",
                       device="cpu")
    _traced(plan.execute, torch.randn(4, 64))
    recs = trace.records()
    assert recs[0].name == "fftw.execute"
    assert len(recs) == 2 and recs[1].name == \
        f"fftw.stage.{plan.descriptors[1]['alg']}"


def test_the_cap_counts_dropped_records(cpu_plans, monkeypatch):
    """The record keeps the latest ``CAP`` spans."""
    monkeypatch.setattr(trace, "CAP", 2)
    plan = ft.plan_many_dft([128], 2, dtype="complex64", device="cpu")
    _traced(plan.execute, _complex((2, 128)))
    recs = trace.records()
    # the pass converts inside its span: root, pass, split, combine
    assert [r.name for r in recs] == ["fftw.convert.split",
                                      "fftw.convert.combine"]
    snap = trace.snapshot(reset=True)
    assert snap["dropped"] == 2          # the root and the pass
    assert snap["calls"] == 0
    assert trace.records() == [] and trace.snapshot()["dropped"] == 0


def test_each_profiler_session_has_its_own_record(cpu_plans):
    """A read of the record after the profiler stopped, or a call while it
    is off, ends the session: the next one's snapshot holds its own calls
    alone."""
    plan = ft.plan_many_dft([128], 2, dtype="complex64", device="cpu")
    x = _complex((2, 128))
    _traced(plan.execute, x)
    assert trace.snapshot()["calls"] == 1
    _traced(lambda: [plan.execute(x) for _ in range(2)])
    assert trace.snapshot()["calls"] == 2
    assert len({r.call for r in trace.records()}) == 2
    _traced(lambda: [plan.execute(x) for _ in range(3)])
    plan.execute(x)
    _traced(plan.execute, x)
    snap = trace.snapshot()
    assert snap["calls"] == 1 and snap["dropped"] == 0
    assert len({r.call for r in trace.records()}) == 1


# -- counters -----------------------------------------------------------------

def test_counters_are_the_set_up_counters():
    c = trace.counters()
    assert set(c) == {"setup.library_s", "setup.plan_s"}
    assert trace.snapshot()["counters"] == c


def test_set_up_counter_grows_with_a_plan(cpu_plans):
    before = trace.counters()["setup.plan_s"]
    ft.plan_many_dft([512], 3, dtype="complex64", device="cpu")
    assert trace.counters()["setup.plan_s"] > before > -1


def test_functional_calls_share_the_cached_plan(cpu_plans):
    """The functional API's repeated call is a root of its own on the
    cached plan (``api._cached_plan`` counts the hit)."""
    api._cached_plan.cache_clear()
    x = _complex((3, 40))
    _traced(lambda: (ft.fft(x), ft.fft(x)))
    roots = [r for r in trace.records() if r.root]
    assert [r.name for r in roots] == ["fftw.execute"] * 2
    info = api._cached_plan.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    api._cached_plan.cache_clear()


def test_functional_call_is_one_root(cpu_plans):
    x = _complex((3, 128))
    _traced(ft.fft, x)
    assert [r.name for r in trace.records() if r.root] == ["fftw.execute"]
    api._cached_plan.cache_clear()


# -- models -------------------------------------------------------------------

def _ranges(prof):
    """The profiler's host ranges, in the order they opened."""
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    return sorted(events, key=lambda e: e.start_ns())


def test_model_off_records_nothing(cpu_plans):
    """With the profiler off a model span is the shared no-op and a step
    records nothing."""
    assert trace.model("fftw.model.ns_step") is trace.span("x")
    step = models.navier_stokes_step(32, 64, 0.01, 0.01)
    step(torch.rand(2, 32, 64) - 0.5)
    assert trace.records() == [] and trace.snapshot()["calls"] == 0
    api._cached_plan.cache_clear()


def test_model_step_spans(cpu_plans):
    """A step opens one ``fftw.model.ns_step`` range, two ``nonlinear``
    ranges and the ``fftw.execute`` roots of its six plan calls, each a
    root of its own inside the step's range; the model's ranges append
    nothing to the record."""
    api._cached_plan.cache_clear()
    step = models.navier_stokes_step(32, 64, 0.01, 0.01)
    w = torch.rand(2, 32, 64) - 0.5
    step(w)                              # plans outside the profiler
    _, prof = _traced(step, w)
    recs = trace.records()
    assert not any(r.name.startswith("fftw.model.") for r in recs)
    roots = [r for r in recs if r.root]
    assert [r.name for r in roots] == ["fftw.execute"] * 6
    assert len({r.call for r in roots}) == 6
    assert trace.snapshot()["calls"] == 6
    ranges = _ranges(prof)
    names = [e.name() for e in ranges]
    assert names.count("fftw.model.ns_step") == 1
    assert names.count("fftw.model.ns.nonlinear") == 2
    assert names.count("fftw.execute") == 6
    (head,) = [e for e in ranges if e.name() == "fftw.model.ns_step"]
    for e in ranges:
        if e.name() in ("fftw.execute", "fftw.model.ns.nonlinear"):
            assert head.start_ns() <= e.start_ns() <= e.end_ns() \
                <= head.end_ns()
    api._cached_plan.cache_clear()


def _shape_of(recs):
    index = {id(r): i for i, r in enumerate(recs)}
    return [(r.name, r.root, None if r.parent is None
             else index[id(r.parent)]) for r in recs]


@pytest.mark.parametrize("kind", ["r2c", "c2r", "c2c"])
def test_plan_roots_inside_a_model_step_are_unchanged(cpu_plans, kind):
    """A plan called inside a model's step records what it records alone:
    the same root, the same spans under it."""
    if kind == "c2c":
        plan = ft.plan_dft((4, 32, 64), axes=(1, 2), device="cpu")
        x = _complex((4, 32, 64))
    elif kind == "r2c":
        plan = ft.plan_dft_r2c((4, 32, 64), axes=(1, 2), device="cpu")
        x = torch.randn(4, 32, 64)
    else:
        plan = ft.plan_dft_c2r((4, 32, 64), axes=(1, 2), device="cpu")
        x = _complex((4, 32, 33))
    alone, _ = _traced(plan.execute, x)
    plain = _shape_of(trace.records())
    trace.reset()

    def inside():
        with trace.model("fftw.model.ns_step"):
            return plan.execute(x)
    got, _ = _traced(inside)
    recs = trace.records()
    assert _shape_of(recs) == plain
    assert recs[0].root and recs[0].parent is None
    assert torch.equal(got, alone)


@pytest.mark.parametrize("name", ["fftw.model.ns_step",
                                  "fftw.model.ns.nonlinear"])
def test_model_span_is_a_range_alone(monkeypatch, name):
    """A model span, even around a timed call on a CUDA device, is one
    profiler range: no record, no events, and the call's root keeps its
    place and its sampling."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: ("s", d))
    monkeypatch.setattr(trace, "EVENT_EVERY", 1)
    trace.reset()
    dev = torch.device("cuda", 0)
    made = _Event.made

    def inside():
        with trace.model(name):
            with trace.call("fftw.execute", dev):
                with trace.span("fftw.convert.split", dev):
                    pass
    _, prof = _traced(inside)
    assert [r.name for r in trace.records()] == ["fftw.execute",
                                                 "fftw.convert.split"]
    assert trace.records()[0].root and trace.records()[0].timed
    assert _Event.made == made + 2
    assert [e.name() for e in _ranges(prof)
            if e.name().startswith("fftw.")] == [
        name, "fftw.execute", "fftw.convert.split"]
    trace.reset()


def test_neumann_solve_spans(cpu_plans, monkeypatch):
    """A Neumann solve opens one ``fftw.model.neumann_solve`` range, and
    inside it the roots of its six plan calls, each with its one stage
    span: ``redft10_half`` along the three axes, then ``redft01_half`` (the
    card's reductions, pinned here by leaving the dense kind matrix out)."""
    monkeypatch.setattr(ft.planner, "R2R_GENERIC_MAX", 0)
    api._cached_plan.cache_clear()
    f = torch.rand(8, 12, 16) - 0.5
    models.solve_neumann(f)              # plans outside the profiler
    _, prof = _traced(models.solve_neumann, f)
    recs = trace.records()
    assert not any(r.name.startswith("fftw.model.") for r in recs)
    roots = [r for r in recs if r.root]
    assert [r.name for r in roots] == ["fftw.execute"] * 6
    stages = [r for r in recs if r.name.startswith("fftw.stage.")]
    assert [r.name for r in stages] == ["fftw.stage.redft10_half"] * 3 + [
        "fftw.stage.redft01_half"] * 3
    assert [r.parent for r in stages] == roots
    ranges = _ranges(prof)
    names = [e.name() for e in ranges]
    assert names.count("fftw.model.neumann_solve") == 1
    (head,) = [e for e in ranges if e.name() == "fftw.model.neumann_solve"]
    inner = [e for e in ranges if e.name() == "fftw.execute"
             or e.name().startswith("fftw.stage.")]
    assert len(inner) == 12
    for e in inner:
        assert head.start_ns() <= e.start_ns() <= e.end_ns() <= head.end_ns()
    api._cached_plan.cache_clear()


def test_neumann_solve_off_records_nothing(cpu_plans):
    """With the profiler off the solve's span is the shared no-op, a solve
    records nothing, and its output is the traced solve's bit for bit."""
    assert trace.model("fftw.model.neumann_solve") is trace.span("x")
    f = torch.rand(8, 12, 16) - 0.5
    u = models.solve_neumann(f)
    assert trace.records() == [] and trace.snapshot()["calls"] == 0
    traced, _ = _traced(models.solve_neumann, f)
    assert torch.equal(traced, u)
    api._cached_plan.cache_clear()


# -- one namespace for the kernels -----------------------------------------

_TOKENS = re.compile(r"namespace\s+(\w+)\s*\{|namespace\s*\{|\{|\}|__global__")


def _strip(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    src = re.sub(r"//[^\n]*", " ", src)
    return re.sub(r'"(?:\\.|[^"\\])*"', '""', src)


def _global_scopes(src: str):
    """For each ``__global__`` of a source, the names of the namespaces
    around it, outermost first (None for an unnamed one)."""
    stack, out = [], []
    for m in _TOKENS.finditer(_strip(src)):
        tok = m.group(0)
        if tok == "__global__":
            out.append([s[1] for s in stack if s[0] == "ns"])
        elif tok == "}":
            stack.pop()
        elif tok == "{":
            stack.append(("brace", None))
        else:
            stack.append(("ns", m.group(1)))
    assert not stack
    return out


def test_every_kernel_is_in_the_port_namespace():
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    found = 0
    for path in sources:
        for scopes in _global_scopes(path.read_text()):
            found += 1
            assert scopes and scopes[0] == "fftw3_tpu_torch", \
                f"a __global__ of {path.name} lies in {scopes}"
    assert found >= 17


def test_kernel_maps_match_the_namespaced_names():
    names = set()
    for path in sorted(CSRC.glob("*.cu*")):
        names |= set(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(",
                                _strip(path.read_text()), flags=re.S))
    for path in sorted(KERNEL_MAPS.glob("*.json")):
        for pattern in json.loads(path.read_text())["patterns"]:
            ident = pattern.replace(r"\b", "")
            assert ident in names, f"{path.name}: {pattern} names no kernel"
            for shown in (f"fftw3_tpu_torch::(anonymous namespace)::{ident}",
                          f"void fftw3_tpu_torch::(anonymous namespace)::"
                          f"{ident}<0, 256>(float const*, int)",
                          f"void fftw3_tpu_torch::k1mma::{ident}<1>(int)"):
                assert re.search(pattern, shown), (pattern, shown)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    trace.reset()
    yield torch.device("cuda")
    trace.reset()


def _profile_card(fn):
    """`fn` under the profiler, after a millisecond of device work of its
    own: the device trace may miss the launches just after the profiler
    starts (seen on an H100: the first of four K1 calls at 64 x 1024 with
    the conversions ahead of K1, all four without them)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
    return out, prof


@pytest.mark.cuda
def test_card_spans_events_and_launches(card, monkeypatch):
    from fftw3_tpu_torch.ops import _build
    _build.library()
    assert trace.counters()["setup.library_s"] > 0
    monkeypatch.setattr(trace, "EVENT_EVERY", 1)
    plan = ft.plan_many_dft([1024], 64, dtype="complex64", device=card)
    x = _complex((64, 1024)).to(card)
    plain = plan.execute(x)
    traced, prof = _profile_card(lambda: [plan.execute(x) for _ in range(4)])
    assert all(torch.equal(plain, y) for y in traced)
    snap = trace.snapshot()
    spans = snap["spans"]
    assert snap["calls"] == snap["timed_calls"] == 4
    for name in ("fftw.execute", "fftw.stage.k1",
                 "fftw.launch.stockham_c2c"):
        assert spans[name]["count"] == 4 and spans[name]["device_ms"] is None
    # K1 reads the complex input and writes the complex output itself
    assert not any(name.startswith("fftw.convert.") for name in spans)
    recs = trace.records()
    for name in ("fftw.execute", "fftw.launch.stockham_c2c"):
        evs = sorted((e for e in prof.profiler.kineto_results.events()
                      if e.name() == name
                      and e.device_type() == DeviceType.CPU),
                     key=lambda e: e.start_ns())
        mine = sorted((r for r in recs if r.name == name),
                      key=lambda r: r.start_ns)
        assert len(evs) == len(mine) == 4
        for r, e in zip(mine, evs):
            assert e.start_ns() <= r.start_ns <= r.end_ns <= e.end_ns()
    # the spans count the launches (4, above); the device trace may miss
    # one just after the profiler starts (seen on an H100: 3 of 4)
    kernels = [e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and "stockham_c2c_kernel" in e.name()]
    assert 1 <= len(kernels) <= 4
    assert all("fftw3_tpu_torch::" in k for k in kernels)
    # the conversions, timed, on routes that still convert: a strided
    # input's one complex copy ahead of K1, an r2c plan's combine after K4
    strided = _complex((64, 2048)).to(card)[:, ::2]
    rplan = ft.plan_dft_r2c((64, 1024), axes=(1,), device=card)
    real = torch.randn(64, 1024, device=card)
    trace.reset()
    _profile_card(lambda: [(plan.execute(strided), rplan.execute(real))
                           for _ in range(2)])
    snap = trace.snapshot()
    for name in ("fftw.convert.split", "fftw.convert.combine"):
        spans = snap["spans"]
        assert spans[name]["count"] == spans[name]["timed"] == 2
        assert spans[name]["device_ms"] > 0


@pytest.mark.cuda
def test_card_3d_launches_and_names(card):
    plan = ft.plan_dft((128, 128, 128), axes=(0, 1, 2), dtype="complex64",
                       device=card)
    x = _complex((128, 128, 128)).to(card)
    plan.execute(x)
    ring = fused2d.ring_launches
    _, prof = _profile_card(lambda: [plan.execute(x) for _ in range(4)])
    snap = trace.snapshot()
    spans = snap["spans"]
    # K3 reads K2's planes, aligned: every call's launch took the ring
    assert fused2d.ring_launches - ring == 4
    launches = {k: v["count"] for k, v in spans.items()
                if k.startswith("fftw.launch.")}
    assert launches == {"fftw.launch.inner_c2c": 4, "fftw.launch.c2c_2d": 4}
    assert {"fftw.stage.k2", "fftw.stage.k3"} <= set(spans)
    # the device trace may miss a launch just after the profiler starts
    # (seen on an H100: one of the two kernels of a single profiled call),
    # so each kernel is looked for in four calls
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA
             and re.search(r"\b(inner_c2c|c2c_2d)_kernel\b", e.name())]
    assert {re.search(r"\b(inner_c2c|c2c_2d)_kernel\b", n).group(1)
            for n in names} == {"inner_c2c", "c2c_2d"}
    assert all("fftw3_tpu_torch::" in n for n in names)
