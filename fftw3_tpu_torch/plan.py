"""Problem and Plan — the port of ``fftw3_tpu/plan.py``.

A :class:`Problem` is a logical transform spec (shape, axes, kind, sign,
r2r kinds, precision); strides and vector ranks are expressed by the tensor shape.  A
:class:`Plan` is a composed function of tensors on one device plus
introspection (op counts, printable tree), built from planner descriptors.

Multidimensional transforms compose 1-D axis passes, as the reference
does:

* the trailing axis pair goes through the fused 2-D kernel (K3,
  ``ops/fused2d.py``) in one pass when ``stockham.applicable_2d`` admits it
  and both axes' descriptors are ``pallas`` (c2c only);
* a non-last axis with a ``pallas`` descriptor whose trailing-dims product
  reaches ``stockham.INNER_TILE_L`` goes through the axis -2 kernel (K2,
  ``ops/inner.py``), the trailing dims its columns, with no copy;
* every other axis runs its last-axis solver behind a ``movedim`` lift.

Every axis pass takes and gives split planes or one complex tensor, and
converts only where its kernel cannot (the pass contract of
``ops/passes.py``).  A c2c plan runs its route: the first pass gets what
the caller passed, the planes stay split between passes, and at the
complex entry (``Plan.execute``, ``Plan.apply``) the last pass is asked for
the complex output.  So K1 reads and writes the complex tensor itself, K2
reads it and K3 writes it, and every other edge converts in its span
(``fftw.convert.split``, ``fftw.convert.combine``).

Real transforms (the last transform axis is the real one): r2c runs its
last axis first (K4 for a ``pallas_r2c`` descriptor), then c2c passes over
the half spectrum; c2r runs the c2c passes first and its last axis last
(K6).  Their complex side converts: r2c combines its planes at the exit,
c2r splits its input at the entry.  One option of the reference, off by
default: ``config.r2c_swapped`` (rank-2 r2c as K5 over axis -2, then the
last-axis c2c, then a Hermitian rebuild).  The reference's other r2c option,
the DC/Nyquist column pack, is not carried over: on the H100 it computes
right but loses (PERF.md, ROADMAP queue 3).

Real-to-real transforms (``ops/r2r.py``) run one 1-D r2r pass per axis, in
the order of the axes, each with its own kind, the last axis as it is and
every other one behind a ``movedim`` lift, as the reference composes them.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import config
from . import kinds as K
from . import planner as planner_mod
from . import trace
from .ops import c2c as c2c_ops
from .ops import fused2d, inner, passes, real_stockham, stockham
from .ops import r2r as r2r_ops
from .ops import real as real_ops


#: the port kernel that a kernel-served descriptor's pass runs
_KERNEL_OF = {"pallas": "k1", "pallas_r2c": "k4", "pallas_r2c_inner": "k5",
              "pallas_c2r": "k6", "df32p": "k7", "fused_redft10": "k8",
              "fused_redft01": "k8"}


def _stage_span(desc: Dict) -> str:
    """The span of an axis pass: ``fftw.stage.`` and the kernel it runs,
    else the descriptor's alg (a pass on no single port kernel)."""
    return "fftw.stage." + _KERNEL_OF.get(desc["alg"], desc["alg"])


class _Stage(NamedTuple):
    """One axis pass: its span, and its apply in the pass contract,
    ``run(xr, xi=None, cout=False)`` (``ops/passes.py``)."""
    name: str
    run: Callable


def _run_passes(stages: List[_Stage], xr, xi=None, cout: bool = False):
    """The passes in order, each in its span: the first on what the caller
    passed (split planes, or with `xi` None the complex tensor `xr`), the
    last asked for the complex output where `cout`."""
    y = (xr, xi)
    for i, st in enumerate(stages):
        with trace.span(st.name):
            y = st.run(*y, cout and i == len(stages) - 1)
    return y if stages else passes.as_output(passes.as_planes(*y), cout)


def _along_axis(fn: Callable, axis: int) -> Callable:
    """Lift a last-axis real transform to an arbitrary axis."""
    def apply(x):
        if axis in (-1, x.dim() - 1):
            return fn(x)
        return fn(x.movedim(axis, -1)).movedim(-1, axis)
    return apply


def _along_axis_split(fn: Callable, axis: int) -> Callable:
    """Lift a split-complex last-axis transform to the non-last axis
    `axis` (right-relative, < -1)."""
    def apply(xr, xi):
        yr, yi = fn(xr.movedim(axis, -1), xi.movedim(axis, -1))
        return yr.movedim(-1, axis), yi.movedim(-1, axis)
    return apply


def _c2c_stage(desc: Dict, sign: int, rdtype, axis: int,
               shape: Tuple[int, ...], device) -> _Stage:
    """One c2c axis pass and its span.  A non-last axis whose trailing-dims
    product is at least one lane tile takes the axis -2 kernel, the
    trailing dims its columns (no ``movedim`` copies); everything else
    lifts the last-axis transform with ``movedim``, on split planes.  Axes
    are applied right-relative, so extra *leading* batch dims at call time
    work."""
    neg = axis - len(shape)                  # right-relative axis (< 0)
    if neg != -1 and stockham.inner_applicable(
            desc, math.prod(shape[axis + 1:])):
        return _Stage("fftw.stage.k2", inner.build_pallas_c2c_split_inner(
            desc, sign, rdtype, device, columns=-neg - 1))
    fn = c2c_ops.build_c2c_split(desc, sign, rdtype, device)
    if neg != -1:
        fn = passes.split_pass(_along_axis_split(fn, neg))
    return _Stage(_stage_span(desc), fn)


def _r2c_along_axis(fn: Callable, axis: int) -> Callable:
    """Lift a last-axis r2c (real -> split planes) to an arbitrary axis."""
    def apply(x):
        if axis in (-1, x.dim() - 1):
            return fn(x)
        yr, yi = fn(x.movedim(axis, -1))
        return yr.movedim(-1, axis), yi.movedim(-1, axis)
    return apply


def _c2r_along_axis(fn: Callable, axis: int) -> Callable:
    """Lift a last-axis c2r (split planes -> real) to an arbitrary axis."""
    def apply(xr, xi):
        if axis in (-1, xr.dim() - 1):
            return fn(xr, xi)
        return fn(xr.movedim(axis, -1), xi.movedim(axis, -1)).movedim(-1, axis)
    return apply


def _r2c_swapped(problem: "Problem", pl: planner_mod.Planner, patience: int,
                 rdtype, vec: Callable, device):
    """The swapped rank-2 r2c composition (``config.r2c_swapped``): r2c
    over axis -2 first (K5, no transposes), then the last-axis c2c over the
    (n_a/2+1)-row half spectrum, then a Hermitian rebuild back to the
    contract layout (half spectrum on the last axis).  The transforms
    commute, and real input gives X[u, v] = conj X[n_a-u, (n_l-v) % n_l], so
    the missing rows u > n_a/2 are a gather of the computed ones.  The
    rebuild is plain torch and copies (the reference measured this route
    as the loser on the TPU).

    Returns (descriptors, split apply), or None when it does not apply and
    the normal last-axis-first composition runs."""
    shape, axes = problem.shape, problem.axes
    nd = len(shape)
    if not (config.r2c_swapped and axes == (nd - 2, nd - 1)):
        return None
    n_a, n_l = shape[-2:]
    if not real_stockham.r2c_inner_applicable(n_a, n_l, rdtype, device):
        return None
    rdesc = pl.plan_r2c(n_a, rdtype, patience, batch=vec(nd - 2),
                        device=device)
    if rdesc.get("alg") != "pallas_r2c":
        return None             # the planner chose a non-kernel path
    idesc = dict(rdesc, alg="pallas_r2c_inner")
    r2c = real_stockham.build_pallas_r2c_inner(idesc, rdtype, device)
    cdesc = pl.plan_c2c(n_l, rdtype, patience, batch=vec(nd - 1),
                        device=device)
    m_a, m_l = n_a // 2, n_l // 2
    c2c = _c2c_stage(cdesc, K.FORWARD, rdtype, nd - 1,
                     shape[:-2] + (m_a + 1, n_l), device)
    # rows m_a-1 .. 1 and columns (n_l - v) % n_l, v = 0..m_l, of the
    # computed half give the rows m_a+1 .. n_a-1 of the output (conjugated)
    rows = torch.arange(m_a - 1, 0, -1, device=device)
    cols = torch.tensor([(n_l - v) % n_l for v in range(m_l + 1)],
                        device=device)

    def apply(x):
        with trace.span("fftw.stage.k5"):
            cr, ci = r2c(x)
        with trace.span(c2c.name):
            cr, ci = c2c.run(cr, ci)
        br = cr.index_select(-2, rows).index_select(-1, cols)
        bi = ci.index_select(-2, rows).index_select(-1, cols)
        return (torch.cat([cr[..., :m_l + 1], br], -2),
                torch.cat([ci[..., :m_l + 1], -bi], -2))
    return {nd - 2: idesc, nd - 1: cdesc}, apply


@dataclass(frozen=True)
class Problem:
    """Logical transform specification (problem ADT analog).  For c2r,
    ``shape`` is the logical real (output) shape, as in FFTW."""
    shape: Tuple[int, ...]
    axes: Tuple[int, ...]
    kind: str                      # 'c2c' | 'r2c' | 'c2r' | 'r2r'
    sign: int = K.FORWARD          # c2c only
    r2r_kinds: Tuple[K.Kind, ...] = ()   # per axis, r2r only
    rdtype: str = "float32"        # base real precision

    def __post_init__(self):
        ax = tuple(a % len(self.shape) for a in self.axes)
        object.__setattr__(self, "axes", ax)
        if self.kind == "r2r" and len(self.r2r_kinds) != len(ax):
            raise ValueError("need one r2r kind per transform axis")


class Plan:
    """Executable plan: composed axis transforms on one device."""

    def __init__(self, problem: Problem, descriptors: Dict[int, Dict],
                 apply_fn: Callable, in_shape: Tuple[int, ...],
                 out_shape: Tuple[int, ...], in_dtype: torch.dtype,
                 out_dtype: torch.dtype, device: torch.device,
                 apply_split: Optional[Callable] = None,
                 stages: Tuple[_Stage, ...] = ()):
        self.problem = problem
        self.descriptors = descriptors          # axis -> planner descriptor
        self._apply = apply_fn
        self.in_shape = in_shape
        self.out_shape = out_shape
        self.in_dtype = in_dtype
        self.out_dtype = out_dtype
        self.device = device
        #: the entry point on real tensors, differentiable; the form the
        #: kernels take: (xr, xi) -> (yr, yi) for c2c, x -> (yr, yi) for
        #: r2c, (xr, xi) -> y for c2r, x -> y for r2r
        self.apply_split = apply_split
        #: a c2c plan's axis passes in order: its route
        self.stages = stages

    # -- execution (fftw_execute + new-array execute) ----------------------
    def __call__(self, x) -> torch.Tensor:
        return self.execute(x)

    def execute(self, x) -> torch.Tensor:
        """Transform `x` (a tensor or array of ``in_shape``), moved to the
        plan's device and input dtype first: complex for c2c and c2r, real
        for r2c and r2r."""
        with trace.call("fftw.execute", self.device, self):
            x = torch.as_tensor(x, device=self.device)
            if tuple(x.shape) != self.in_shape:
                raise ValueError(f"plan expects shape {self.in_shape}, got "
                                 f"{tuple(x.shape)}")
            return self._apply(x.to(self.in_dtype))

    @property
    def apply(self) -> Callable:
        """The raw function on tensors of the plan's dtypes, with no shape
        check: leading batch dims beyond the plan's shape work.  It runs in
        the span ``fftw.execute``, as :meth:`execute` does."""
        return self._apply_traced

    def _apply_traced(self, x):
        with trace.call("fftw.execute", self.device, self):
            return self._apply(x)

    # -- introspection (fftw_flops/fftw_cost) --------------------------------
    def flops(self) -> Tuple[float, float, float]:
        """(add, mul, fma) counts for one full execution."""
        total = {"add": 0.0, "mul": 0.0, "fma": 0.0}
        shape = list(self.problem.shape)
        for axis, desc in self.descriptors.items():
            n = shape[axis]
            batch = math.prod(shape) // max(n, 1)
            ops = _opcount_of(desc)
            for k in total:
                total[k] += batch * ops[k]
        return (total["add"], total["mul"], total["fma"])

    def cost(self) -> float:
        a, m, f = self.flops()
        return a + m + 2 * f

    def __repr__(self) -> str:
        inner = " ".join(
            f"[axis {a}: {planner_mod.sprint_desc(d)}]"
            for a, d in sorted(self.descriptors.items()))
        return (f"(plan {self.problem.kind} {self.problem.shape} "
                f"axes={self.problem.axes} {inner})")

    def print_plan(self) -> None:
        print(repr(self))


def _opcount_of(desc: Dict) -> Dict[str, float]:
    """Op counts of one axis pass, by the descriptor's kind: the r2r
    solvers', the real solvers' (the last axis of r2c/c2r, and K5 in the
    swapped route), else c2c's."""
    if desc["alg"] in r2r_ops.ALGS:
        return r2r_ops.r2r_opcount(desc)
    if desc["alg"] == "pallas_r2c_inner":
        return real_ops.r2c_opcount(dict(desc, alg="pallas_r2c"))
    if desc["alg"] in real_ops.ALGS:
        return real_ops.r2c_opcount(desc)
    return c2c_ops.c2c_opcount(desc)


# ---------------------------------------------------------------------------
# plan construction (fftw_mkapiplan analog)
# ---------------------------------------------------------------------------

def make_plan(problem: Problem, flags: int = K.ESTIMATE,
              planner: Optional[planner_mod.Planner] = None,
              device=None) -> Plan:
    """Plan `problem` for `device` (default ``config.device``).  A CUDA
    device without CUDA raises: nothing carries on on the CPU."""
    device = torch.device(config.device if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"cannot build a plan for device {device}: this "
                           f"torch build sees no CUDA device")
    pl = planner or planner_mod.the_planner
    patience = K.patience_of_flags(flags)
    if flags & K.WISDOM_ONLY:
        # FFTW_WISDOM_ONLY: plan only from existing wisdom, else fail
        pl.wisdom_only = True
        try:
            return _make_plan_inner(problem, pl, patience, device)
        finally:
            pl.wisdom_only = False
    return _make_plan_inner(problem, pl, patience, device)


def _make_plan_inner(problem: Problem, pl: planner_mod.Planner,
                     patience: int, device: torch.device) -> Plan:
    build = {"c2c": _plan_c2c, "r2c": _plan_r2c, "c2r": _plan_c2r,
             "r2r": _plan_r2r}.get(problem.kind)
    if build is None:
        raise ValueError(f"unknown problem kind {problem.kind!r}")
    rdtype = np.dtype(problem.rdtype)
    npoints = math.prod(problem.shape)

    def vec(a):
        # vector size seen by the axis-a pass: everything except axis a
        return max(1, npoints // max(problem.shape[a], 1))
    # planning and building, the root tables' move to the device included,
    # are the port's set-up (``trace.py``'s counter ``setup.plan_s``)
    t0 = time.perf_counter()
    try:
        return build(problem, pl, patience, device, rdtype, vec)
    finally:
        trace.add("setup.plan_s", time.perf_counter() - t0)


def _check_trailing(shape, *planes) -> None:
    """Raise unless every plane ends in `shape` (leading dims are free)."""
    for t in planes:
        if tuple(t.shape[t.dim() - len(shape):]) != tuple(shape) \
                or t.shape != planes[0].shape:
            raise ValueError(
                f"plan expects {len(planes)} tensor(s) of shape (..., "
                f"{', '.join(map(str, shape))}), got "
                f"{' and '.join(str(tuple(p.shape)) for p in planes)}")


def _plan_c2c(problem, pl, patience, device, rdtype, vec) -> Plan:
    shape = problem.shape
    descriptors: Dict[int, Dict] = {
        a: pl.plan_c2c(shape[a], rdtype, patience, batch=vec(a),
                       device=device) for a in problem.axes}
    rest_axes = list(problem.axes)
    nd = len(shape)
    # fuse the trailing axis pair into ONE kernel pass when both axes are
    # kernel-served anyway (2 HBM passes -> 1)
    fuse = (len(rest_axes) >= 2 and rest_axes[-2:] == [nd - 2, nd - 1]
            and stockham.applicable_2d(shape[nd - 2], shape[nd - 1], rdtype,
                                       device)
            and descriptors[nd - 2].get("alg") == "pallas"
            and descriptors[nd - 1].get("alg") == "pallas")
    if fuse:
        rest_axes = rest_axes[:-2]
    split_stages = [_c2c_stage(descriptors[a], problem.sign, rdtype, a,
                               shape, device) for a in rest_axes]
    if fuse:
        fn = fused2d.build_pallas_c2c_split_2d(
            shape[nd - 2], shape[nd - 1], problem.sign, rdtype,
            desc1=descriptors[nd - 2], desc2=descriptors[nd - 1],
            device=device)
        split_stages.append(_Stage("fftw.stage.k3", fn))

    def apply_split(xr, xi):
        _check_trailing(shape, xr, xi)
        return _run_passes(split_stages, xr, xi)

    def apply_c2c(x):
        _check_trailing(shape, x)
        return _run_passes(split_stages, x, None, True)

    ctype = c2c_ops.complex_dtype(rdtype)
    return Plan(problem, descriptors, apply_c2c, shape, shape, ctype, ctype,
                device, apply_split=apply_split, stages=tuple(split_stages))


def _plan_r2c(problem, pl, patience, device, rdtype, vec) -> Plan:
    shape, axes = problem.shape, problem.axes
    nd = len(shape)
    last = axes[-1]
    n_last = shape[last]
    out = list(shape)
    out[last] = n_last // 2 + 1
    swapped = _r2c_swapped(problem, pl, patience, rdtype, vec, device)
    if swapped is not None:
        descriptors, split = swapped
    else:
        desc = pl.plan_r2c(n_last, rdtype, patience, batch=vec(last),
                           device=device)
        descriptors = {last: desc}
        first_span = _stage_span(desc)
        first = _r2c_along_axis(
            real_ops.build_r2c_split(desc, rdtype, device), last - nd)
        # the non-last axes run on the half spectrum (K2 where the trailing
        # layout allows), the last of them asked for the complex output
        # where the caller wants one
        stages: List[_Stage] = []
        for a in axes[:-1]:
            d = pl.plan_c2c(shape[a], rdtype, patience, batch=vec(a),
                            device=device)
            descriptors[a] = d
            stages.append(_c2c_stage(d, K.FORWARD, rdtype, a, tuple(out),
                                     device))

        def split(x, cout=False):
            with trace.span(first_span):
                yr, yi = first(x)
            return _run_passes(stages, yr, yi, cout)

    def apply_split(x):
        _check_trailing(shape, x)
        return split(x)

    def apply_r2c(x):
        if swapped is not None:
            return passes.as_output(apply_split(x), True)
        _check_trailing(shape, x)
        return split(x, True)

    return Plan(problem, descriptors, apply_r2c, shape, tuple(out),
                _real_dtype(rdtype), c2c_ops.complex_dtype(rdtype), device,
                apply_split=apply_split)


def _plan_c2r(problem, pl, patience, device, rdtype, vec) -> Plan:
    # problem.shape is the logical real shape; the input is the half
    # spectrum, used as it is (numpy and the reference take whatever columns
    # 0 and n/2 hold, Hermitian-valid or not)
    shape, axes = problem.shape, problem.axes
    nd = len(shape)
    last = axes[-1]
    n_last = shape[last]
    ins = list(shape)
    ins[last] = n_last // 2 + 1
    ins = tuple(ins)
    descriptors: Dict[int, Dict] = {}
    stages: List[_Stage] = []
    for a in axes[:-1]:
        d = pl.plan_c2c(shape[a], rdtype, patience, batch=vec(a),
                        device=device)
        descriptors[a] = d
        stages.append(_c2c_stage(d, K.BACKWARD, rdtype, a, ins, device))
    desc = pl.plan_c2r(n_last, rdtype, patience, batch=vec(last),
                       device=device)
    descriptors[last] = desc
    final_span = _stage_span(desc)
    final = _c2r_along_axis(real_ops.build_c2r_split(desc, rdtype, device),
                            last - nd)

    def run(xr, xi=None):
        # the first non-last axis pass takes the caller's tensor (K2 reads
        # complex64 itself); K6 takes planes
        xr, xi = _run_passes(stages, xr, xi)
        with trace.span(final_span):
            return final(xr, xi)

    def apply_split(xr, xi):
        _check_trailing(ins, xr, xi)
        return run(xr, xi)

    def apply_c2r(X):
        _check_trailing(ins, X)
        return run(X)

    return Plan(problem, descriptors, apply_c2r, ins, shape,
                c2c_ops.complex_dtype(rdtype), _real_dtype(rdtype), device,
                apply_split=apply_split)


def _plan_r2r(problem, pl, patience, device, rdtype, vec) -> Plan:
    # one r2r pass per axis, each planned at its own vector size
    shape = problem.shape
    nd = len(shape)
    descriptors: Dict[int, Dict] = {}
    stages: List[Tuple[str, Callable]] = []
    for a, kind in zip(problem.axes, problem.r2r_kinds):
        desc = pl.plan_r2r(kind, shape[a], rdtype, patience, batch=vec(a),
                           device=device)
        descriptors[a] = desc
        stages.append((_stage_span(desc), _along_axis(
            r2r_ops.build_r2r(desc, rdtype, device), a - nd)))

    def apply_r2r(x):
        _check_trailing(shape, x)
        for name, s in stages:
            with trace.span(name):
                x = s(x)
        return x

    rt = _real_dtype(rdtype)
    return Plan(problem, descriptors, apply_r2r, shape, shape, rt, rt,
                device, apply_split=apply_r2r)


def _real_dtype(rdtype) -> torch.dtype:
    return torch.float32 if np.dtype(rdtype) == np.float32 \
        else torch.float64
