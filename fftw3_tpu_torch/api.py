"""Public planned API — the planned part of ``fftw3_tpu/api.py``.

FFTW-style: ``plan_dft*``, ``plan_many_dft``, ``plan_dft_r2c*``,
``plan_dft_c2r*`` and ``plan_r2r*`` build a :class:`Plan` for a device (``device=``, default
``config.device``), ``execute`` runs it, and wisdom moves to and from
strings.  Transforms are unnormalized, like FFTW's.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import plan as plan_mod
from . import planner as planner_mod
from . import kinds as K
from .kinds import ESTIMATE, FORWARD, Kind

Plan = plan_mod.Plan
Problem = plan_mod.Problem

_lock = threading.Lock()


def _rdtype_of(dtype) -> str:
    dt = np.dtype(dtype)
    if dt in (np.complex64, np.float32):
        return "float32"
    if dt in (np.complex128, np.float64):
        return "float64"
    raise ValueError(f"unsupported dtype {dtype}")


def _axes_tuple(shape, axes) -> Tuple[int, ...]:
    if axes is None:
        return tuple(range(len(shape)))
    if isinstance(axes, int):
        return (axes,)
    return tuple(axes)


def plan_dft(shape: Sequence[int], axes=None, sign: int = FORWARD,
             flags: int = ESTIMATE, dtype="complex64", device=None) -> Plan:
    """Complex DFT plan over `axes` of tensors of `shape` (plan_dft
    analog), built for `device`."""
    shape = tuple(shape)
    prob = Problem(shape=shape, axes=_axes_tuple(shape, axes), kind="c2c",
                   sign=sign, rdtype=_rdtype_of(dtype))
    with _lock:
        return plan_mod.make_plan(prob, flags, device=device)


def plan_dft_1d(n: int, sign: int = FORWARD, flags: int = ESTIMATE,
                dtype="complex64", device=None) -> Plan:
    return plan_dft((n,), (0,), sign, flags, dtype, device)


def plan_dft_2d(n0: int, n1: int, sign: int = FORWARD, flags: int = ESTIMATE,
                dtype="complex64", device=None) -> Plan:
    return plan_dft((n0, n1), (0, 1), sign, flags, dtype, device)


def plan_dft_3d(n0: int, n1: int, n2: int, sign: int = FORWARD,
                flags: int = ESTIMATE, dtype="complex64",
                device=None) -> Plan:
    return plan_dft((n0, n1, n2), (0, 1, 2), sign, flags, dtype, device)


def plan_many_dft(n: Sequence[int], howmany: int, sign: int = FORWARD,
                  flags: int = ESTIMATE, dtype="complex64",
                  device=None) -> Plan:
    """Batched DFT (advanced 'many' API analog): the batch is a leading
    vector dimension."""
    n = tuple(n)
    shape = (howmany,) + n
    axes = tuple(range(1, len(n) + 1))
    return plan_dft(shape, axes, sign, flags, dtype, device)


def plan_dft_r2c(shape: Sequence[int], axes=None, flags: int = ESTIMATE,
                 dtype="float32", device=None) -> Plan:
    """Real-input DFT plan over `axes` of real tensors of `shape`: the last
    transform axis keeps n//2+1 bins (FFTW's rdft2 layout)."""
    shape = tuple(shape)
    prob = Problem(shape=shape, axes=_axes_tuple(shape, axes), kind="r2c",
                   rdtype=_rdtype_of(dtype))
    with _lock:
        return plan_mod.make_plan(prob, flags, device=device)


def plan_dft_r2c_1d(n: int, flags: int = ESTIMATE, dtype="float32",
                    device=None) -> Plan:
    return plan_dft_r2c((n,), (0,), flags, dtype, device)


def plan_dft_r2c_2d(n0: int, n1: int, flags: int = ESTIMATE,
                    dtype="float32", device=None) -> Plan:
    return plan_dft_r2c((n0, n1), (0, 1), flags, dtype, device)


def plan_dft_r2c_3d(n0: int, n1: int, n2: int, flags: int = ESTIMATE,
                    dtype="float32", device=None) -> Plan:
    return plan_dft_r2c((n0, n1, n2), (0, 1, 2), flags, dtype, device)


def plan_dft_c2r(shape: Sequence[int], axes=None, flags: int = ESTIMATE,
                 dtype="float32", device=None) -> Plan:
    """Real-output inverse of :func:`plan_dft_r2c`, unnormalized.  `shape`
    is the *logical real output* shape (FFTW convention)."""
    shape = tuple(shape)
    prob = Problem(shape=shape, axes=_axes_tuple(shape, axes), kind="c2r",
                   rdtype=_rdtype_of(dtype))
    with _lock:
        return plan_mod.make_plan(prob, flags, device=device)


def plan_dft_c2r_1d(n: int, flags: int = ESTIMATE, dtype="float32",
                    device=None) -> Plan:
    return plan_dft_c2r((n,), (0,), flags, dtype, device)


def plan_dft_c2r_2d(n0: int, n1: int, flags: int = ESTIMATE,
                    dtype="float32", device=None) -> Plan:
    return plan_dft_c2r((n0, n1), (0, 1), flags, dtype, device)


def plan_dft_c2r_3d(n0: int, n1: int, n2: int, flags: int = ESTIMATE,
                    dtype="float32", device=None) -> Plan:
    return plan_dft_c2r((n0, n1, n2), (0, 1, 2), flags, dtype, device)


def plan_r2r(shape: Sequence[int], kinds, axes=None, flags: int = ESTIMATE,
             dtype="float32", device=None) -> Plan:
    """Real-to-real plan over `axes` of real tensors of `shape`, one kind
    per axis (or one kind for all of them): a :class:`Kind`, its name or
    its fftw3.h integer.  Unnormalized, like FFTW's r2r."""
    shape = tuple(shape)
    axes = _axes_tuple(shape, axes)
    ks = tuple(K.kind_from_name(k)
               for k in (kinds if isinstance(kinds, (list, tuple))
                         else [kinds] * len(axes)))
    prob = Problem(shape=shape, axes=axes, kind="r2r", r2r_kinds=ks,
                   rdtype=_rdtype_of(dtype))
    with _lock:
        return plan_mod.make_plan(prob, flags, device=device)


def plan_r2r_1d(n: int, kind: Union[Kind, str, int], flags: int = ESTIMATE,
                dtype="float32", device=None) -> Plan:
    return plan_r2r((n,), [kind], (0,), flags, dtype, device)


def plan_r2r_2d(n0: int, n1: int, kind0, kind1, flags: int = ESTIMATE,
                dtype="float32", device=None) -> Plan:
    return plan_r2r((n0, n1), [kind0, kind1], (0, 1), flags, dtype, device)


def plan_r2r_3d(n0: int, n1: int, n2: int, kind0, kind1, kind2,
                flags: int = ESTIMATE, dtype="float32", device=None) -> Plan:
    return plan_r2r((n0, n1, n2), [kind0, kind1, kind2], (0, 1, 2), flags,
                    dtype, device)


def execute(plan: Plan, x) -> torch.Tensor:
    """fftw_execute analog (new-array execute: tensors are arguments)."""
    return plan.execute(x)


def flops(plan: Plan) -> Tuple[float, float, float]:
    return plan.flops()


def cost(plan: Plan) -> float:
    return plan.cost()


def print_plan(plan: Plan) -> None:
    plan.print_plan()


def sprint_plan(plan: Plan) -> str:
    return repr(plan)


def set_timelimit(t: Optional[float]) -> None:
    """Bound MEASURE-mode planning time in seconds (fftw_set_timelimit)."""
    planner_mod.the_planner.timelimit = None if t is None or t < 0 else t


def export_wisdom_to_string() -> str:
    return planner_mod.the_planner.export_wisdom()


def import_wisdom_from_string(s: str) -> bool:
    return planner_mod.the_planner.import_wisdom(s)


def import_reference_wisdom(s: str, device=None) -> bool:
    """Carry a ``fftw3_tpu`` wisdom export into the global planner (see
    :meth:`Planner.import_reference_wisdom`)."""
    return planner_mod.the_planner.import_reference_wisdom(s, device)


def forget_wisdom() -> None:
    planner_mod.the_planner.forget_wisdom()
