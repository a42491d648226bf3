"""Problem and Plan — the c2c part of ``fftw3_tpu/plan.py``.

A :class:`Problem` is a logical transform spec (shape, axes, kind, sign,
precision); strides and vector ranks are expressed by the tensor shape.  A
:class:`Plan` is a composed function of tensors on one device plus
introspection (op counts, printable tree), built from planner descriptors.

Multidimensional transforms compose 1-D axis passes, as the reference
does:

* the trailing axis pair goes through the fused 2-D kernel (K3,
  ``ops/fused2d.py``) in one pass when ``stockham.applicable_2d`` admits it
  and both axes' descriptors are ``pallas``;
* a non-last axis with a ``pallas`` descriptor whose trailing-dims product
  reaches ``stockham.INNER_TILE_L`` goes through the axis -2 kernel (K2,
  ``ops/inner.py``) behind a reshape, with no copy;
* every other axis runs its last-axis solver behind a ``movedim`` lift.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import config
from . import kinds as K
from . import planner as planner_mod
from .ops import c2c as c2c_ops
from .ops import fused2d, inner, stockham


def _along_axis_split(fn: Callable, axis: int) -> Callable:
    """Lift a split-complex last-axis transform to an arbitrary axis."""
    def apply(xr, xi):
        if axis in (-1, xr.dim() - 1):
            return fn(xr, xi)
        yr, yi = fn(xr.movedim(axis, -1), xi.movedim(axis, -1))
        return yr.movedim(-1, axis), yi.movedim(-1, axis)
    return apply


def _c2c_stage(desc: Dict, sign: int, rdtype, axis: int,
               shape: Tuple[int, ...], device) -> Callable:
    """One c2c axis pass.  A non-last axis whose trailing-dims product is at
    least one lane tile takes the axis -2 kernel behind a reshape (the
    trailing dims become its columns: no ``movedim`` copies); everything
    else lifts the last-axis transform with ``movedim``.  Axes are applied
    right-relative, so extra *leading* batch dims at call time work."""
    neg = axis - len(shape)                  # right-relative axis (< 0)
    trail = math.prod(shape[axis + 1:])
    if neg != -1 and stockham.inner_applicable(desc, trail):
        fn = inner.build_pallas_c2c_split_inner(desc, sign, rdtype, device)

        def apply_inner(xr, xi):
            s = xr.shape
            cut = xr.dim() + neg + 1         # runtime position after axis
            yr, yi = fn(xr.reshape(*s[:cut], trail),
                        xi.reshape(*s[:cut], trail))
            return yr.reshape(s), yi.reshape(s)
        return apply_inner
    fn = c2c_ops.build_c2c_split(desc, sign, rdtype, device)
    return _along_axis_split(fn, neg)


@dataclass(frozen=True)
class Problem:
    """Logical transform specification (problem ADT analog)."""
    shape: Tuple[int, ...]
    axes: Tuple[int, ...]
    kind: str                      # only 'c2c' has a solver so far
    sign: int = K.FORWARD
    rdtype: str = "float32"        # base real precision

    def __post_init__(self):
        ax = tuple(a % len(self.shape) for a in self.axes)
        object.__setattr__(self, "axes", ax)


class Plan:
    """Executable plan: composed axis transforms on one device."""

    def __init__(self, problem: Problem, descriptors: Dict[int, Dict],
                 apply_fn: Callable, in_shape: Tuple[int, ...],
                 out_shape: Tuple[int, ...], out_dtype: torch.dtype,
                 device: torch.device,
                 apply_split: Optional[Callable] = None):
        self.problem = problem
        self.descriptors = descriptors          # axis -> planner descriptor
        self._apply = apply_fn
        self.in_shape = in_shape
        self.out_shape = out_shape
        self.out_dtype = out_dtype
        self.device = device
        #: split-complex entry point (c2c): (xr, xi) -> (yr, yi) on real
        #: tensors, differentiable; the form the kernels take
        self.apply_split = apply_split

    # -- execution (fftw_execute + new-array execute) ----------------------
    def __call__(self, x) -> torch.Tensor:
        return self.execute(x)

    def execute(self, x) -> torch.Tensor:
        """Transform `x` (a tensor or array of ``in_shape``), moved to the
        plan's device and complex dtype first."""
        x = torch.as_tensor(x, device=self.device)
        if tuple(x.shape) != self.in_shape:
            raise ValueError(
                f"plan expects shape {self.in_shape}, got {tuple(x.shape)}")
        return self._apply(x.to(self.out_dtype))

    @property
    def apply(self) -> Callable:
        """The raw complex function, with no shape check: leading batch
        dims beyond the plan's shape work."""
        return self._apply

    # -- introspection (fftw_flops/fftw_cost) --------------------------------
    def flops(self) -> Tuple[float, float, float]:
        """(add, mul, fma) counts for one full execution."""
        total = {"add": 0.0, "mul": 0.0, "fma": 0.0}
        shape = list(self.problem.shape)
        for axis, desc in self.descriptors.items():
            n = shape[axis]
            batch = math.prod(shape) // max(n, 1)
            ops = c2c_ops.c2c_opcount(desc)
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
    if problem.kind != "c2c":
        raise NotImplementedError(
            f"{problem.kind} plans are not ported yet (ROADMAP queue 1)")
    rdtype = np.dtype(problem.rdtype)
    shape = problem.shape
    npoints = math.prod(shape)

    def _vec(a):
        # vector size seen by the axis-a pass: everything except axis a
        return max(1, npoints // max(shape[a], 1))

    # split-complex through the whole multi-axis pipeline: one real/imag
    # split at entry, one combine at exit
    descriptors: Dict[int, Dict] = {
        a: pl.plan_c2c(shape[a], rdtype, patience, batch=_vec(a),
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
        split_stages.append(fused2d.build_pallas_c2c_split_2d(
            shape[nd - 2], shape[nd - 1], problem.sign, rdtype,
            desc1=descriptors[nd - 2], desc2=descriptors[nd - 1],
            device=device))

    def apply_split(xr, xi):
        if tuple(xr.shape[xr.dim() - len(shape):]) != shape \
                or xi.shape != xr.shape:
            raise ValueError(f"plan expects split planes of shape (..., "
                             f"{', '.join(map(str, shape))}), got "
                             f"{tuple(xr.shape)} and {tuple(xi.shape)}")
        for s in split_stages:
            xr, xi = s(xr, xi)
        return xr, xi

    def apply_c2c(x):
        return torch.complex(*apply_split(x.real, x.imag))

    return Plan(problem, descriptors, apply_c2c, shape, shape,
                c2c_ops.complex_dtype(rdtype), device,
                apply_split=apply_split)
