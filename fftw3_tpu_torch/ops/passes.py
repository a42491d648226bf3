"""What every kernel pass of the port shares: the operand checks, the
launch, the outputs and their layouts, the one autograd Function of the
kernel passes, and :func:`kernel_pass`, which makes the c2c kernel passes
(K1, K2, K3).

A c2c pass takes and gives either layout: ``apply(xr, xi=None,
cout=False)`` takes split planes (xr, xi) or, with `xi` None, one complex
tensor `xr`, and gives split planes or, with `cout`, one complex tensor.
It converts only where its kernel cannot take or give the layout itself:

* in: a kernel with an interleaved-input form (K1, K2) reads a complex64
  tensor on the card itself, made contiguous with no lazy conjugate or
  negative bit by one complex copy where it is not so already; everything
  else (a twin, K3, a pass with no such form, another dtype) splits it
  into two planes (:func:`kernel_input`, :func:`as_planes`);
* out: a kernel with an interleaved-output form (K1, K2, K3) writes the
  complex output itself; everything else combines the planes
  (:func:`as_output`).

Both conversions run in their spans, ``fftw.convert.split`` and
``fftw.convert.combine``, wherever they run.  :func:`kernel_pass` builds
the passes of K1, K2 and K3 so; :func:`split_pass` gives a pass on split
planes alone (``mixed``, ``direct``, ``bluestein``, ``rader``, ``xla``,
``df32``, ``df32p``, ``pallas4``, a ``movedim``-lifted pass) the same
contract.  A plan runs its route's passes in order, the first on what
its caller gave, the last asked for the complex output where the caller
wants one (``plan.py``).
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import trace

#: the layout bits of a launch of K1, K2 or K3 (``kInC``, ``kOutC`` in
#: ``csrc/stockham_bfly.cuh``): the input, the output is one interleaved
#: complex64 tensor in place of two float32 planes
IN_COMPLEX, OUT_COMPLEX = 1, 2


# ---------------------------------------------------------------------------
# operands, outputs and the launch
# ---------------------------------------------------------------------------

def check_planes(name: str, xr: torch.Tensor, xi: Optional[torch.Tensor],
                 table: torch.Tensor, ndim: int) -> None:
    """The checks every kernel wrapper makes before a launch: one CUDA
    device, float32, two contiguous planes of one `ndim`-D shape; with `xi`
    None one contiguous complex64 tensor `xr` in their place, with no lazy
    conjugate or negative bit (an interleaved input)."""
    if xi is None:
        if xr.device.type != "cuda" or table.device != xr.device:
            raise ValueError(f"{name} needs all tensors on one CUDA device, "
                             f"got {xr.device}, {table.device}")
        if xr.dtype != torch.complex64 or table.dtype != torch.float32:
            raise ValueError(f"{name} takes complex64 and a float32 table, "
                             f"got {xr.dtype}, {table.dtype}")
        if xr.dim() != ndim:
            raise ValueError(f"{name} takes one {ndim}-D complex tensor, got "
                             f"{tuple(xr.shape)}")
        if not (xr.is_contiguous() and table.is_contiguous()) \
                or xr.is_conj() or xr.is_neg():
            raise ValueError(f"{name} takes contiguous tensors with no lazy "
                             f"conjugate or negative bit")
        return
    if xr.device.type != "cuda" or xi.device != xr.device \
            or table.device != xr.device:
        raise ValueError(f"{name} needs all tensors on one CUDA device, got "
                         f"{xr.device}, {xi.device}, {table.device}")
    if xr.dtype != torch.float32 or xi.dtype != torch.float32 \
            or table.dtype != torch.float32:
        raise ValueError(f"{name} takes float32, got {xr.dtype}, "
                         f"{xi.dtype}, {table.dtype}")
    if xr.dim() != ndim or xi.shape != xr.shape:
        raise ValueError(f"{name} takes two {ndim}-D planes of one shape, "
                         f"got {tuple(xr.shape)} and {tuple(xi.shape)}")
    if not (xr.is_contiguous() and xi.is_contiguous()
            and table.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def layout_of(xi: Optional[torch.Tensor], complex_out: bool) -> int:
    """The layout bits of a launch: IN_COMPLEX when the input is one
    complex tensor (`xi` None), OUT_COMPLEX with `complex_out`."""
    return (IN_COMPLEX if xi is None else 0) | \
        (OUT_COMPLEX if complex_out else 0)


def new_output(shape, device: torch.device, complex_out: bool):
    """A kernel's output: two new float32 planes of `shape`, or with
    `complex_out` one new complex64 tensor (a 1-tuple)."""
    if complex_out:
        return (torch.empty(shape, dtype=torch.complex64, device=device),)
    return (torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.float32, device=device))


def pointers(xr: torch.Tensor, xi: Optional[torch.Tensor] = None):
    """A kernel's two pointer arguments of a layout: the planes', or the
    complex tensor's and None."""
    return xr.data_ptr(), None if xi is None else xi.data_ptr()


def device_guard(device: torch.device):
    """The kernels launch on the current device: make it `device` for the
    call (and restore it after), at no cost when it already is."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def launch(kernel: str, device: torch.device, smem: int, work: int, args,
           what: str) -> None:
    """Launch ``<kernel>_launch(*args, grid, smem, stream)`` with `smem`
    bytes of shared memory per block (the root tables and the row or tile
    buffers) on `device`'s current stream, with a grid that fills the card
    and is at most `work` blocks; raises when the launch fails, naming
    `what`, in the span ``fftw.launch.<kernel>``.  Every single-block
    kernel launches here (K1, K2, K4, K5, K6, K7, E1, E5, E7, E8); K3
    launches clusters (``ops/fused2d.py``), E2/E3 pick their instantiation
    by arm (``ops/stage4096.py``)."""
    from . import _build
    lib = _build.library()
    with trace.span(f"fftw.launch.{kernel}"), device_guard(device):
        grid = min(work, resident_blocks(lib, kernel, device, smem))
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"{kernel}_launch")(*args, grid, smem, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} "
                           f"({what})")


#: (kernel, device index, shared-memory bytes) -> blocks resident on the
#: whole card
_grids: Dict[Tuple[str, int, int], int] = {}


def resident_blocks(lib, kernel: str, device: torch.device,
                    smem: int) -> int:
    """The grid that fills `device` with `kernel` at `smem` bytes per
    block; the first call per (kernel, device, smem) also allows the kernel
    its shared memory (``<kernel>_occupancy``).  The caller has made
    `device` current."""
    key = (kernel, device.index, smem)
    grid = _grids.get(key)
    if grid is None:
        per_sm = ctypes.c_int(0)
        rc = getattr(lib, f"{kernel}_occupancy")(smem, ctypes.byref(per_sm))
        if rc != 0:
            raise RuntimeError(f"{kernel} occupancy query failed: CUDA "
                               f"error {rc} (smem={smem} bytes)")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        grid = _grids[key] = sms * max(1, per_sm.value)
    return grid


# ---------------------------------------------------------------------------
# the layouts of a pass: split planes or one interleaved complex tensor
# ---------------------------------------------------------------------------

def as_planes(xr: torch.Tensor, xi: Optional[torch.Tensor]):
    """A pass's input as split planes: (xr, xi) as they are, or with `xi`
    None the complex tensor `xr` converted into two contiguous planes (a
    lazy conjugate or negative bit resolved by the copies), in the span
    ``fftw.convert.split``."""
    if xi is None:
        with trace.span("fftw.convert.split", xr.device):
            return xr.real.contiguous(), xr.imag.contiguous()
    return xr, xi


def as_output(y, cout: bool):
    """A pass's output planes `y` as asked for: with `cout` combined into
    one complex tensor, in the span ``fftw.convert.combine``."""
    if not cout:
        return y
    with trace.span("fftw.convert.combine", y[0].device):
        return torch.complex(*y)


def kernel_input(xr: torch.Tensor, xi: Optional[torch.Tensor],
                 reads: bool):
    """A kernel's input in a form it takes: planes as they are; with `xi`
    None, the complex64 tensor `xr` itself where the kernel `reads` one,
    copied once into a contiguous tensor with no lazy conjugate or negative
    bit where it is not so already (in the span ``fftw.convert.split``);
    any other complex tensor as its two planes (:func:`as_planes`)."""
    if xi is not None or not reads or xr.dtype != torch.complex64:
        return as_planes(xr, xi)
    if xr.is_contiguous() and not (xr.is_conj() or xr.is_neg()):
        return xr, None
    with trace.span("fftw.convert.split", xr.device):
        return torch.empty(xr.shape, dtype=xr.dtype,
                           device=xr.device).copy_(xr), None


def flat(xr: torch.Tensor, xi: Optional[torch.Tensor], shape):
    """A kernel's operands, planes or one complex tensor (`xi` None),
    reshaped to `shape` and contiguous."""
    return xr.reshape(shape).contiguous(), \
        None if xi is None else xi.reshape(shape).contiguous()


def shaped(y, shape):
    """A kernel's output, planes or one complex tensor, reshaped."""
    if isinstance(y, tuple):
        return y[0].reshape(shape), y[1].reshape(shape)
    return y.reshape(shape)


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------

class Adjoint(torch.autograd.Function):
    """A kernel pass with the backward it is given: ``Adjoint.apply(fwd,
    adj, *xs)`` returns ``fwd(*xs)``, and its backward ``adj(*grads)``, the
    gradients of `xs` (one tensor where `xs` is one) from those of the
    output, in the layouts of each."""

    @staticmethod
    def forward(ctx, fwd, adj, *xs):
        ctx.adj = adj
        return fwd(*xs)

    @staticmethod
    def backward(ctx, *grads):
        d = ctx.adj(*grads)
        return (None, None) + (d if isinstance(d, tuple) else (d,))


def _pair(xs):
    """A pass's operands as (xr, xi): `xi` None for one complex tensor."""
    return xs if len(xs) == 2 else (xs[0], None)


def differentiable(run: Callable, sign: int) -> Callable:
    """The pass ``apply(xr, xi=None, cout=False)`` of ``run(xr, xi, s)``, a
    c2c of sign s, with the opposite-sign run as its backward: the VJP of
    an unnormalized DFT on the real planes is the opposite-sign
    unnormalized DFT (the map [[A, -B], [B, A]] has transpose [[A, B],
    [-B, A]]), and on a complex tensor it is the same (A^H).  A kernel
    pass's run also takes the complex tensor itself (`xi` None) and gives
    the complex output (``run(xr, xi, s, True)``), and the backward takes
    the gradient in the output's layout and gives it in the input's; a
    run on planes alone is only ever given planes (:func:`split_pass`)."""
    def at(s, cout):
        if cout:
            return lambda *xs: run(*_pair(xs), s, True)
        return lambda *xs: run(*_pair(xs), s)
    fwd = (at(sign, False), at(sign, True))
    adj = (at(-sign, False), at(-sign, True))

    def apply(xr, xi=None, cout=False):
        if xi is None:
            return Adjoint.apply(fwd[cout], adj[True], xr)
        return Adjoint.apply(fwd[cout], adj[False], xr, xi)
    return apply


def split_pass(fn: Callable) -> Callable:
    """The pass of an apply on split planes alone, ``fn(xr, xi) -> (yr,
    yi)``: a complex input split first, a complex output combined last."""
    def apply(xr, xi=None, cout=False):
        return as_output(fn(*as_planes(xr, xi)), cout)
    return apply


def on_twin(x: torch.Tensor) -> bool:
    """Does a kernel pass run its kernel's twin on `x`?  On a CPU tensor;
    on any other the kernel runs (or raises)."""
    return x.device.type == "cpu"


def kernel_pass(axis: Tuple[int, ...], sign: int, rdtype, device,
                table: Callable, twin: Callable, kernel: Callable,
                columns: int = 0, reads: bool = False,
                writes: bool = False) -> Callable:
    """The c2c pass of a Stockham kernel, with the opposite sign as its
    backward (:func:`differentiable`).

    It takes tensors of shape (..., *axis, *cols): `axis` the sizes the
    kernel transforms ((n,) for K1's last axis and K2's axis, (n1, n2) for
    K3's trailing pair), after them `columns` dims of any size, which K2
    takes as its L columns.  ``table(s, device)`` gives the kernel's root
    tables of sign s on a device, moved there for both signs here when
    `device` is a CUDA device.  A CPU tensor runs ``twin(xr, xi, s)`` on
    split planes (:func:`on_twin`); any other runs ``kernel(xr, xi,
    table, cout)`` on the operands flattened to (rows, *axis[, L]), in the
    forms the kernel has: an interleaved input (`xi` None) where `reads`,
    an interleaved output (`cout`) where `writes`; the pass converts the
    rest."""
    if np.dtype(rdtype) != np.float32:
        raise ValueError(f"the Stockham kernels are float32 only, got "
                         f"{np.dtype(rdtype)}")
    if device is not None and torch.device(device).type == "cuda":
        for s in (sign, -sign):                # move the tables once
            table(s, torch.device(device))
    axis = tuple(axis)
    k = len(axis) + columns

    def run(xr, xi, s, cout=False):
        shp = xr.shape
        d = xr.dim()
        if d < k or tuple(shp[d - k:d - columns]) != axis \
                or (xi is not None and xi.shape != shp):
            dims = ", ".join(map(str, axis)) + ", L" * columns
            got = tuple(shp) if xi is None else (tuple(shp), tuple(xi.shape))
            raise ValueError(f"the pass expects tensors of shape (..., "
                             f"{dims}), got {got}")
        if on_twin(xr):
            return as_output(twin(*as_planes(xr, xi), s), cout)
        xr, xi = kernel_input(xr, xi, reads)
        cols = (math.prod(shp[d - columns:]),) if columns else ()
        y = kernel(*flat(xr, xi, (-1, *axis, *cols)), table(s, xr.device),
                   cout and writes)
        return as_output(shaped(y, shp), cout and not writes)

    return differentiable(run, sign)
