"""Paranoid mode: recursive verification of every planned sub-problem — the
port of ``fftw3_tpu/harness/paranoid.py``.

FFTW's paranoid hook (``fftw/tests/hook.c``) converts each internal
sub-plan into a bench problem and verifies it in isolation, catching
solver-local bugs the end-to-end test would average away.  Here the
planner's instrumentation hook (``Planner.hook``) delivers every planned
descriptor; each is rebuilt standalone (:func:`planner.build_apply`) on the
checked device and compared with the float64 dense oracle on random batched
inputs.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import config
from .. import planner as planner_mod
from ..ops import matrices
from ..ops import real as real_ops


class ParanoiaError(AssertionError):
    pass


def _oracle(kind: str, n: int, x: np.ndarray) -> np.ndarray:
    if kind == "c2c":
        return np.asarray(x, np.complex128) @ matrices.dft_matrix(n, -1)
    if kind == "r2c":
        full = np.asarray(x, np.float64) @ matrices.dft_matrix(n, -1)
        return full[..., : n // 2 + 1]
    if kind == "c2r":
        x = np.asarray(x, np.complex128)
        fr, fi = real_ops.full_spectrum(torch.from_numpy(x.real),
                                        torch.from_numpy(x.imag), n)
        full = fr.numpy() + 1j * fi.numpy()
        return (full @ matrices.dft_matrix(n, +1)).real
    return np.asarray(x, np.float64) @ matrices.r2r_matrix(kind, n)


def check_descriptor(kind: str, n: int, desc: Dict, rdtype=np.float32,
                     batch: int = 3, tol: float = None, seed: int = 0,
                     device=None) -> float:
    """Build `desc` standalone on `device` (default ``config.device``) and
    compare it with the dense float64 oracle."""
    from .verify import acmp, default_tol

    tol = default_tol(rdtype) if tol is None else tol
    device = torch.device(config.device if device is None else device)
    rng = np.random.default_rng(seed)
    fn = planner_mod.build_apply(kind, desc, np.dtype(rdtype), device)
    if kind in ("c2c", "c2r"):
        m = n if kind == "c2c" else n // 2 + 1
        x = rng.standard_normal((batch, m)) + 1j * rng.standard_normal(
            (batch, m))
        if kind == "c2r":          # enforce Hermitian-representable input
            x[..., 0] = x[..., 0].real
            if n % 2 == 0:
                x[..., -1] = x[..., -1].real
        cdt = np.complex64 if np.dtype(rdtype) == np.float32 \
            else np.complex128
        got = fn(torch.from_numpy(x.astype(cdt)).to(device))
    else:
        x = rng.standard_normal((batch, n))
        got = fn(torch.from_numpy(x.astype(rdtype)).to(device))
    try:
        return acmp(got.cpu(), _oracle(kind, n, x), tol,
                    f"paranoid {kind} n={n} "
                    f"{planner_mod.sprint_desc(desc)}")
    except AssertionError as exc:
        raise ParanoiaError(str(exc)) from None


@contextlib.contextmanager
def paranoid(planner: planner_mod.Planner = None, rdtype=np.float32,
             device=None):
    """Context manager: every descriptor the planner emits while active is
    verified in isolation on `device` (tests/hook.c analog).  Collects
    (key, err)."""
    pl = planner or planner_mod.the_planner
    seen: List[Tuple[str, float]] = []
    prev = pl.hook

    def hook(key: str, desc: Dict, cost: float):
        if prev is not None:
            prev(key, desc, cost)
        kind, n, dtname = key.split(":")[:3]
        err = check_descriptor(kind, int(n), desc, np.dtype(dtname),
                               device=device)
        seen.append((key, err))

    pl.hook = hook
    try:
        yield seen
    finally:
        pl.hook = prev
