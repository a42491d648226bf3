"""Guru / guru64 / advanced ("many") API surface — the port of
``fftw3_tpu/guru.py``.

FFTW's three planner tiers (basic / advanced / guru) differ only in how
much memory-layout freedom they expose: embedded supersets (``inembed``/
``onembed``), strides, distances, split re/im arrays, and arbitrary
transform/vector rank mixes.  Here layout freedom maps onto tensor shapes,
axes and strided views:

* ``iodim(n, is, os)``  -> an entry of ``dims``/``howmany_dims``; explicit
  strides make a :class:`StridedGuruPlan` over a flat buffer, which reads
  and writes through ``torch.as_strided`` views (no index tensor);
* split arrays          -> :class:`SplitPlan` and friends, straight on the
  plans' ``apply_split``, the form the kernels take (no conversion pass);
* guru64                -> the same functions (Python ints are unbounded).

Every plan is built for a device (``device=``, default ``config.device``);
the execute functions move their arguments there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import api
from . import kinds as K
from . import trace


@dataclass(frozen=True)
class iodim:
    """fftw_iodim analog: size + input/output strides in ELEMENTS.

    Strides are element strides; 0 means "contiguous row-major default"
    (the dwim rule of the bench harness).
    """
    n: int
    is_: int = 0
    os_: int = 0


iodim64 = iodim   # guru64: same type, Python ints are unbounded


def _dims_to_shape(dims: Sequence) -> Tuple[int, ...]:
    return tuple(d.n if isinstance(d, iodim) else int(d) for d in dims)


def _has_strides(dims) -> bool:
    return any(isinstance(d, iodim) and (d.is_ != 0 or d.os_ != 0)
               for d in dims)


def _strides(all_dims, use_output: bool) -> List[int]:
    """Element strides of an iodim layout (dwim rule: stride 0 means
    contiguous row-major from the right)."""
    strides = []
    default = 1
    for d in reversed(all_dims):
        st = (d.os_ if use_output else d.is_) or default
        if st < 0:
            raise ValueError("negative iodim strides are not supported")
        strides.append(st)
        default = st * d.n
    return strides[::-1]


def _span(shape, strides) -> int:
    """Elements from the first to one past the last of a strided layout."""
    return 1 + sum((n - 1) * st for n, st in zip(shape, strides))


def _flat_view(buf: torch.Tensor, shape, strides, offset: int,
               what: str) -> torch.Tensor:
    """The strided view of a flat buffer at an element offset, checked
    against the buffer's extent (``as_strided`` works on the storage)."""
    if buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError(f"{what} must be a flat contiguous buffer, got "
                         f"shape {tuple(buf.shape)}")
    need = offset + _span(shape, strides)
    if offset < 0 or need > buf.numel():
        raise ValueError(f"{what} of {buf.numel()} elements is too small "
                         f"for this layout at offset {offset} (needs "
                         f"{need})")
    return buf.as_strided(shape, strides, buf.storage_offset() + offset)


class StridedGuruPlan:
    """Guru plan over FLAT buffers with explicit iodim strides — FFTW's
    guru memory model, both sides:

    * input: the plan reads the strided view of the flat input buffer (plus
      an optional element offset);
    * output: with explicit ``os`` strides the result is stored into a flat
      output buffer at the strided positions: a fresh zeroed buffer of
      ``out_size`` elements, or the caller's ``out=`` written in place and
      returned, its other positions untouched (FFTW's semantics).  A fresh
      buffer has no surrounding context, so the element offset applies to
      it on the input side only, as in the reference.

    Without ``os`` strides the result comes back in contiguous logical
    layout.
    """

    def __init__(self, plan, dims, howmany_dims):
        self._plan = plan
        all_dims = tuple(howmany_dims) + tuple(dims)
        self.in_shape = tuple(d.n for d in all_dims)
        self._in_strides = _strides(all_dims, use_output=False)
        self._has_os = any(d.os_ for d in all_dims)
        self._out_strides = _strides(all_dims, use_output=True) \
            if self._has_os else None
        self.out_size = _span(self.in_shape, self._out_strides) \
            if self._has_os else None
        self.out_shape = plan.out_shape
        self.problem = plan.problem
        self.device = plan.device

    @property
    def apply(self):
        """fn(flat, offset=0, out=None) on tensors of the plan's dtype and
        device."""
        return self._run

    def _run(self, flat, offset: int = 0, out=None):
        x = _flat_view(flat, self.in_shape, self._in_strides, offset,
                       "the input buffer")
        y = self._plan.apply(x)
        if not self._has_os:
            return y
        if out is None:
            out, offset = y.new_zeros(self.out_size), 0
        _flat_view(out, self.in_shape, self._out_strides, offset,
                   "out").copy_(y)
        return out

    def execute(self, flat, offset: int = 0, out=None):
        """Transform the flat buffer `flat` (moved to the plan's device and
        dtype).  `out`, a flat tensor of the output dtype on the plan's
        device (or a numpy array, for a CPU plan), is written in place."""
        plan = self._plan
        flat = torch.as_tensor(flat, device=plan.device) \
            .to(plan.in_dtype).contiguous()
        if out is not None:
            out = torch.as_tensor(out)
            if (api._device_key(out.device) != api._device_key(plan.device)
                    or out.dtype != plan.out_dtype):
                raise ValueError(
                    f"out must be a {plan.out_dtype} buffer on "
                    f"{plan.device}, got {out.dtype} on {out.device}")
        return self._run(flat, offset, out)

    __call__ = execute

    def __repr__(self):
        return f"(strided-guru{'-os' if self._has_os else ''} " \
               f"{self._plan!r})"


def plan_guru_dft(dims: Sequence, howmany_dims: Sequence = (),
                  sign: int = K.FORWARD, flags: int = K.ESTIMATE,
                  dtype="complex64", device=None):
    """fftw_plan_guru_dft analog: rank = len(dims) transform over tensors
    of shape howmany_dims + dims (vector dims leading, row-major).

    With explicit iodim strides, returns a :class:`StridedGuruPlan`
    operating on a flat buffer (FFTW's guru memory model); otherwise a
    regular shape-indexed Plan."""
    shape = _dims_to_shape(howmany_dims) + _dims_to_shape(dims)
    axes = tuple(range(len(howmany_dims), len(shape)))
    plan = api.plan_dft(shape, axes, sign, flags, dtype, device)
    if _has_strides(tuple(howmany_dims) + tuple(dims)):
        nd = [d if isinstance(d, iodim) else iodim(int(d)) for d in dims]
        nh = [d if isinstance(d, iodim) else iodim(int(d))
              for d in howmany_dims]
        return StridedGuruPlan(plan, nd, nh)
    return plan


def plan_guru_dft_r2c(dims: Sequence, howmany_dims: Sequence = (),
                      flags: int = K.ESTIMATE, dtype="float32", device=None):
    shape = _dims_to_shape(howmany_dims) + _dims_to_shape(dims)
    axes = tuple(range(len(howmany_dims), len(shape)))
    return api.plan_dft_r2c(shape, axes, flags, dtype, device)


def plan_guru_dft_c2r(dims: Sequence, howmany_dims: Sequence = (),
                      flags: int = K.ESTIMATE, dtype="float32", device=None):
    shape = _dims_to_shape(howmany_dims) + _dims_to_shape(dims)
    axes = tuple(range(len(howmany_dims), len(shape)))
    return api.plan_dft_c2r(shape, axes, flags, dtype, device)


def plan_guru_r2r(dims: Sequence, kinds: Sequence[Union[K.Kind, str]],
                  howmany_dims: Sequence = (), flags: int = K.ESTIMATE,
                  dtype="float32", device=None):
    shape = _dims_to_shape(howmany_dims) + _dims_to_shape(dims)
    axes = tuple(range(len(howmany_dims), len(shape)))
    return api.plan_r2r(shape, list(kinds), axes, flags, dtype, device)


# guru64 aliases (fftw_plan_guru64_*): identical semantics in Python
plan_guru64_dft = plan_guru_dft
plan_guru64_dft_r2c = plan_guru_dft_r2c
plan_guru64_dft_c2r = plan_guru_dft_c2r
plan_guru64_r2r = plan_guru_r2r


def _planes(plan, *parts) -> Tuple[torch.Tensor, ...]:
    """Real tensors on the plan's device in its real dtype (no copy for a
    tensor that already is one)."""
    rt = torch.float32 if plan.problem.rdtype == "float32" \
        else torch.float64
    return tuple(torch.as_tensor(p, device=plan.device).to(rt)
                 for p in parts)


class SplitPlan:
    """Split re/im plan (fftw_plan_guru_split_dft analog): FFTW's split
    format keeps real and imaginary parts in separate arrays, which is the
    form every kernel of this package takes, so the split guru API runs
    ``apply_split`` with no conversion pass."""

    def __init__(self, plan):
        self._plan = plan
        self.in_shape = plan.in_shape
        self.out_shape = plan.out_shape
        self.problem = plan.problem
        self.device = plan.device

    @property
    def apply(self):
        return self._plan.apply_split

    apply_split = apply

    def execute(self, ri, ii):
        with trace.call("fftw.execute_split", self.device, self):
            ri, ii = _planes(self._plan, ri, ii)
            if tuple(ri.shape) != self.in_shape:
                raise ValueError(f"plan expects shape {self.in_shape}, "
                                 f"got {tuple(ri.shape)}")
            return self._plan.apply_split(ri, ii)

    def __call__(self, ri, ii):
        return self.execute(ri, ii)

    def __repr__(self):
        return "(split " + repr(self._plan) + ")"


def plan_guru_split_dft(dims: Sequence, howmany_dims: Sequence = (),
                        sign: int = K.FORWARD, flags: int = K.ESTIMATE,
                        dtype="float32", device=None) -> SplitPlan:
    cdt = "complex64" if np.dtype(dtype) == np.float32 else "complex128"
    return SplitPlan(plan_guru_dft(dims, howmany_dims, sign, flags, cdt,
                                   device))


plan_guru64_split_dft = plan_guru_split_dft


# ---------------------------------------------------------------------------
# Advanced "many" API with embed semantics (fftw_plan_many_dft)
# ---------------------------------------------------------------------------

class ManyPlan:
    """A plan over FFTW advanced-layout buffers.

    The caller passes the *physical* tensor of shape ``(howmany,) +
    inembed`` (row-major, ``idist`` = product of inembed); the plan
    transforms the embedded block ``[..., :n_k]`` (a view, no copy) and
    embeds the result into ``(howmany,) + onembed``, zero outside the
    block.
    """

    def __init__(self, n, howmany, sign, flags, dtype, kind,
                 inembed, onembed, r2r_kinds=None, device=None):
        self.n = tuple(n)
        self.howmany = howmany
        self.inembed = tuple(inembed) if inembed else self.n
        self.onembed = tuple(onembed) if onembed else None
        for e, t in zip(self.inembed, self.n):
            if e < t:
                raise ValueError("inembed must be >= n")
        shape = (howmany,) + self.n
        axes = tuple(range(1, len(self.n) + 1))
        if kind == "c2c":
            self.plan = api.plan_dft(shape, axes, sign, flags, dtype, device)
        elif kind == "r2c":
            self.plan = api.plan_dft_r2c(shape, axes, flags, dtype, device)
        elif kind == "c2r":
            self.plan = api.plan_dft_c2r(shape, axes, flags, dtype, device)
        else:
            self.plan = api.plan_r2r(shape, r2r_kinds, axes, flags, dtype,
                                     device)
        self.device = self.plan.device
        self.in_shape = (howmany,) + self.inembed if inembed \
            else self.plan.in_shape
        self._crop = (slice(None),) + tuple(
            slice(0, t) for t in self.plan.in_shape[1:])
        if self.onembed:
            for e, t in zip(self.onembed, self.plan.out_shape[1:]):
                if e < t:
                    raise ValueError("onembed must be >= transform output")

    def _embed(self, y: torch.Tensor) -> torch.Tensor:
        if not self.onembed:
            return y
        out = y.new_zeros((y.shape[0],) + self.onembed)
        out[(slice(None),) + tuple(slice(0, s) for s in y.shape[1:])] = y
        return out

    def execute(self, x):
        x = torch.as_tensor(x, device=self.device)
        if tuple(x.shape) != self.in_shape:
            raise ValueError(f"plan expects {self.in_shape}, "
                             f"got {tuple(x.shape)}")
        return self._embed(self.plan.execute(x[self._crop]))

    __call__ = execute

    @property
    def apply(self):
        return lambda x: self._embed(self.plan.apply(x[self._crop]))

    @property
    def apply_split(self):
        crop, split = self._crop, self.plan.apply_split
        if self.problem.kind in ("c2c", "c2r"):
            return lambda xr, xi: split(xr[crop], xi[crop])
        return lambda x: split(x[crop])

    @property
    def problem(self):
        return self.plan.problem

    def flops(self):
        return self.plan.flops()

    def cost(self):
        return self.plan.cost()

    def print_plan(self):
        print(repr(self))

    def __repr__(self):
        return (f"(many howmany={self.howmany} inembed={self.inembed} "
                f"{self.plan!r})")


def plan_many_dft(n: Sequence[int], howmany: int,
                  inembed: Optional[Sequence[int]] = None,
                  onembed: Optional[Sequence[int]] = None,
                  sign: int = K.FORWARD, flags: int = K.ESTIMATE,
                  dtype="complex64", device=None) -> ManyPlan:
    return ManyPlan(n, howmany, sign, flags, dtype, "c2c", inembed, onembed,
                    device=device)


def plan_many_dft_r2c(n, howmany, inembed=None, onembed=None,
                      flags: int = K.ESTIMATE, dtype="float32",
                      device=None) -> ManyPlan:
    return ManyPlan(n, howmany, K.FORWARD, flags, dtype, "r2c",
                    inembed, onembed, device=device)


def plan_many_dft_c2r(n, howmany, inembed=None, onembed=None,
                      flags: int = K.ESTIMATE, dtype="float32",
                      device=None) -> ManyPlan:
    return ManyPlan(n, howmany, K.BACKWARD, flags, dtype, "c2r",
                    inembed, onembed, device=device)


def plan_many_r2r(n, howmany, kinds, inembed=None, onembed=None,
                  flags: int = K.ESTIMATE, dtype="float32",
                  device=None) -> ManyPlan:
    return ManyPlan(n, howmany, K.FORWARD, flags, dtype, "r2r",
                    inembed, onembed, r2r_kinds=list(kinds), device=device)


# ---------------------------------------------------------------------------
# New-array execute functions (fftw_execute_dft etc.): the reference's
# alignment check becomes a kind check.
# ---------------------------------------------------------------------------

def _check_kind(plan, kind: str, name: str) -> None:
    if plan.problem.kind != kind:
        article = "an" if kind == "r2c" else "a"
        raise ValueError(f"{name} requires {article} {kind} plan")


def execute_dft(plan, x):
    _check_kind(plan, "c2c", "execute_dft")
    return plan.execute(x)


def execute_split_dft(plan, ri, ii):
    """fftw_execute_split_dft analog: ``plan.apply_split`` on the two
    planes, nothing else (the user path with no conversion pass), in the
    root span ``fftw.execute_split``."""
    _check_kind(plan, "c2c", "execute_split_dft")
    with trace.call("fftw.execute_split", plan.device, plan):
        return plan.apply_split(*_planes(plan, ri, ii))


def execute_dft_r2c(plan, x):
    _check_kind(plan, "r2c", "execute_dft_r2c")
    return plan.execute(x)


def execute_dft_c2r(plan, x):
    _check_kind(plan, "c2r", "execute_dft_c2r")
    return plan.execute(x)


def execute_r2r(plan, x):
    _check_kind(plan, "r2r", "execute_r2r")
    return plan.execute(x)


def execute_split_dft_r2c(plan, x):
    """fftw_execute_split_dft_r2c analog: real tensor in -> (re, im) out.
    Accepts a SplitR2CPlan or any r2c plan."""
    if not isinstance(plan, SplitR2CPlan):
        _check_kind(plan, "r2c", "execute_split_dft_r2c")
        plan = SplitR2CPlan(plan)
    return plan.execute(x)


def execute_split_dft_c2r(plan, ri, ii):
    """fftw_execute_split_dft_c2r analog: (re, im) in -> real tensor out.
    Accepts a SplitC2RPlan or any c2r plan."""
    if not isinstance(plan, SplitC2RPlan):
        _check_kind(plan, "c2r", "execute_split_dft_c2r")
        plan = SplitC2RPlan(plan)
    return plan.execute(ri, ii)


class SplitR2CPlan:
    """Split-output r2c plan: real in -> (re, im) out
    (fftw_plan_guru_split_dft_r2c analog), on ``apply_split``."""

    def __init__(self, plan):
        self._plan = plan
        self.in_shape = plan.in_shape
        self.problem = plan.problem
        self.device = plan.device

    def execute(self, x):
        with trace.call("fftw.execute_split", self.device, self):
            return self._plan.apply_split(*_planes(self._plan, x))

    __call__ = execute


class SplitC2RPlan:
    """Split-input c2r plan: (re, im) in -> real out
    (fftw_plan_guru_split_dft_c2r analog), on ``apply_split``."""

    def __init__(self, plan):
        self._plan = plan
        self.in_shape = plan.in_shape
        self.problem = plan.problem
        self.device = plan.device

    def execute(self, ri, ii):
        with trace.call("fftw.execute_split", self.device, self):
            return self._plan.apply_split(*_planes(self._plan, ri, ii))

    __call__ = execute


def plan_guru_split_dft_r2c(dims: Sequence, howmany_dims: Sequence = (),
                            flags: int = K.ESTIMATE, dtype="float32",
                            device=None) -> SplitR2CPlan:
    return SplitR2CPlan(plan_guru_dft_r2c(dims, howmany_dims, flags, dtype,
                                          device))


def plan_guru_split_dft_c2r(dims: Sequence, howmany_dims: Sequence = (),
                            flags: int = K.ESTIMATE, dtype="float32",
                            device=None) -> SplitC2RPlan:
    return SplitC2RPlan(plan_guru_dft_c2r(dims, howmany_dims, flags, dtype,
                                          device))


plan_guru64_split_dft_r2c = plan_guru_split_dft_r2c
plan_guru64_split_dft_c2r = plan_guru_split_dft_c2r
