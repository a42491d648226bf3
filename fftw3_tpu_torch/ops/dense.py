"""Dense float products at full precision, whatever the process has set.

The reference asks for ``precision=HIGHEST`` on every dense product it
makes (the c2c ``direct`` and ``mixed`` solvers, ``r2c_dense``,
``c2r_dense``, ``r2r_matmul``), and ``jax.grad`` keeps it in the
transposed products of the backward pass.  ``torch.matmul`` takes no
precision: it follows the process-wide setting, and under
``torch.set_float32_matmul_precision("high")`` (or ``"medium"``) a float32
product sums in TF32 or bf16, about 1e-3 off.  Every float32 dense product
of the port goes through :func:`exact_matmul`, which runs it with the
setting pinned to full float32 ("ieee") and restores the caller's setting
afterwards, also when the product raises.  Its backward, which autograd
runs after the forward has returned (on CUDA, in the autograd engine's own
thread), makes its two products through :func:`exact_matmul` again.

The setting is process-wide, so the pin is shared by every thread: a lock
and a depth count save the caller's setting on the first entry and restore
it on the last exit, so products pinned at once in several threads all run
at full precision and the setting reads back as it was.  A product that
another thread makes without the pin while one is held runs at full
precision too.  The reference's pin is per call and has no such effect.

On PyTorch with ``torch.backends.cuda.matmul.fp32_precision`` (2.9 and
later) the pin reads and writes only that attribute and, where it exists,
``torch.backends.mkldnn.matmul.fp32_precision`` (the CPU's products): the
new spelling, which the legacy setters also write, so a process that uses
either spelling reads back what it set.  On older PyTorch it saves and
restores ``torch.get_float32_matmul_precision()``, which there also
decides ``torch.backends.cuda.matmul.allow_tf32``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["full_precision", "exact_matmul"]

_lock = threading.Lock()
_depth = 0
_saved = None


def _precision_backends():
    """The backends whose ``fp32_precision`` governs a matmul, or None on
    PyTorch without the attribute."""
    cuda = torch.backends.cuda.matmul
    if not hasattr(cuda, "fp32_precision"):
        return None
    out = [cuda]
    mk = getattr(getattr(torch.backends, "mkldnn", None), "matmul", None)
    if mk is not None and hasattr(mk, "fp32_precision"):
        out.append(mk)
    return out


def _pin():
    """Set full precision; returns what restores the caller's setting."""
    backends = _precision_backends()
    if backends is None:                       # PyTorch < 2.9
        prec = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        return lambda: torch.set_float32_matmul_precision(prec)
    saved = [(b, b.fp32_precision) for b in backends]

    def restore():
        for b, value in saved:
            b.fp32_precision = value
    try:
        for b, _ in saved:
            b.fp32_precision = "ieee"
    except BaseException:
        restore()
        raise
    return restore


@contextlib.contextmanager
def full_precision():
    """Float32 products at full precision inside the block; the caller's
    setting is restored when the last pinned block in the process exits,
    also on an exception."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = _pin()
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                restore, _saved = _saved, None
                restore()


class _ExactMatmul(torch.autograd.Function):
    """``a @ b`` for operands of two or more dimensions, with the forward
    product and both products of the backward pinned."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with full_precision():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = exact_matmul(g, b.transpose(-1, -2)).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gb = exact_matmul(a.transpose(-1, -2), g).sum_to_size(b.shape)
        return ga, gb


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` at full precision, forward and backward (the
    reference's ``precision=HIGHEST``)."""
    if a.dim() == 1:
        return exact_matmul(a.unsqueeze(0), b).squeeze(-2)
    if b.dim() == 1:
        return exact_matmul(a, b.unsqueeze(-1)).squeeze(-1)
    return _ExactMatmul.apply(a, b)
