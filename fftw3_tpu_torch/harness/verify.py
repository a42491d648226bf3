"""Self-verification by mathematical properties — the port of
``fftw3_tpu/harness/verify.py``.

The reference verifier's *method* (``fftw/libbench2/verify-lib.c``, Ergün's
linear-function self-testing):

* **impulse**: the transform of a scaled delta must equal the float64
  oracle's row; plus `rounds` random superposition checks
  ``T(B) + T(A-B) == T(A)``.
* **linear**: ``T(alpha*A + beta*B) == alpha*T(A) + beta*T(B)`` with random
  coefficients (real coefficients for real transforms).
* **tf_shift**: time-shift <-> phase-rotation and frequency-shift <->
  modulation dualities (c2c problems).
* **roundtrip** (r2c/c2r): the unnormalized round trip recovers n*x.

Every array lives on the plan's device in float64/complex128 (torch): the
inputs are drawn there, the plan's input dtype is a cast away, and the
oracle is a float64 dense product on the device.  Errors are compared with
:func:`acmp`, the relative-Linf comparator of ``verify-lib.c``:
``max_i |a_i-b_i| / max_i min(|a_i|,|b_i|)``.  Default tolerances follow
``libbench2/bench-main.c``: 1e-3 single / 1e-10 double.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import config
from .. import kinds as K
from .problem import BenchProblem, make_plan

C128, F64 = torch.complex128, torch.float64


class VerificationError(AssertionError):
    pass


def default_tol(rdtype) -> float:
    return 1e-3 if np.dtype(rdtype) == np.float32 else 1e-10


def _c128(a, device=None) -> torch.Tensor:
    """`a` (tensor or array) as a flat complex128 tensor."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=device or t.device, dtype=C128).reshape(-1)


def acmp(a, b, tol: float, context: str = "") -> float:
    """Relative Linf comparator (aerror/acmp analog) of two tensors or
    arrays, computed in complex128 on `a`'s device."""
    a = _c128(a)
    b = _c128(b, a.device)
    if a.numel() == 0:
        return 0.0
    e = float((a - b).abs().max())
    mag = float(torch.minimum(a.abs(), b.abs()).max())
    rel = e / max(mag, 1e-300)
    if rel > tol:
        raise VerificationError(
            f"relative error {rel:.3e} > tol {tol:.0e} ({context})")
    return rel


@dataclass
class VerifyResult:
    problem: str
    tests: Dict[str, float] = field(default_factory=dict)

    @property
    def max_err(self) -> float:
        return max(self.tests.values()) if self.tests else 0.0

    def __repr__(self):
        inner = " ".join(f"{k}={v:.2e}" for k, v in self.tests.items())
        return f"(verify {self.problem} {inner})"


# ---------------------------------------------------------------------------
# per-kind harness closures: map every problem onto (apply, in/out specs)
# ---------------------------------------------------------------------------

def _rand(rng: np.random.Generator, shape, complex_: bool,
          device) -> torch.Tensor:
    """Uniform [-0.5, 0.5) float64 (complex128) values on `device`, drawn by
    a torch generator that one draw of `rng` seeds."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 62)))

    def u():
        return torch.rand(shape, generator=gen, dtype=F64,
                          device=device) - 0.5
    return torch.complex(u(), u()) if complex_ else u()


class _Closure:
    """dofft_closure analog: a plan plus dtype plumbing.  ``apply`` takes
    and returns float64/complex128 tensors on the plan's device (numpy
    arrays are moved there) and runs ``plan.apply`` on the plan's own
    dtype in between."""

    def __init__(self, prob: BenchProblem, flags: int, rdtype: str,
                 device=None):
        self.prob = prob
        self.rdtype = np.dtype(rdtype)
        self.device = torch.device(config.device if device is None
                                   else device)
        self.complex_in = prob.kind in ("c2c", "c2r")
        self.complex_out = prob.kind in ("c2c", "r2c")
        dtype = ("complex64" if self.rdtype == np.float32 else "complex128") \
            if prob.kind == "c2c" else str(self.rdtype)
        self.plan = make_plan(prob, flags, dtype, self.device)

    def apply(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        y = self.plan.apply(x.to(self.plan.in_dtype))
        return y.to(C128 if self.complex_out else F64)

    def rand_input(self, rng) -> torch.Tensor:
        return _rand(rng, self.plan.in_shape, self.complex_in, self.device)


# ---------------------------------------------------------------------------
# oracle rows: what should T(delta) be?
# ---------------------------------------------------------------------------

def _along(y: torch.Tensor, axis: int, M: torch.Tensor) -> torch.Tensor:
    """``y @ M`` along `axis`."""
    return (y.movedim(axis, -1) @ M).movedim(-1, axis)


def _oracle_1d(prob: BenchProblem, rdtype,
               device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Dense float64 oracle for the (possibly multi-axis) transform,
    applied to the logical input on `device` (the tensor's own when
    None): the closed-form matrices of the dense solvers, a float64 product
    per axis (``torch.matmul``)."""
    from ..ops import matrices

    shape = prob.shape
    axes = prob.axes

    def oracle(x) -> torch.Tensor:
        x = torch.as_tensor(x, device=device)
        dev = x.device
        if prob.kind == "r2r":
            y = x.to(F64)
            for a, k in zip(axes, prob.r2r_kinds):
                M = torch.from_numpy(matrices.r2r_matrix(k.value, shape[a]))
                y = _along(y, a, M.to(dev))
            return y
        y = x.to(C128)
        if prob.kind in ("c2c", "r2c"):
            sign = prob.sign if prob.kind == "c2c" else K.FORWARD
        else:
            sign = K.BACKWARD        # oracle of the logical real signal
        for a in axes:
            M = torch.from_numpy(matrices.dft_matrix(shape[a], sign))
            y = _along(y, a, M.to(dev))
        if prob.kind == "r2c":
            last = axes[-1]
            y = y.narrow(last, 0, shape[last] // 2 + 1)
        if prob.kind == "c2r":
            y = y.real
        return y

    return oracle


# ---------------------------------------------------------------------------
# the property tests
# ---------------------------------------------------------------------------

def _impulse(cl: _Closure, rng, rounds: int, tol: float,
             res: VerifyResult) -> None:
    prob = cl.prob
    oracle = _oracle_1d(prob, cl.rdtype, cl.device)
    # impulsive input: delta at the origin of the transform block, scaled
    inA = torch.zeros(cl.plan.in_shape, dtype=C128 if cl.complex_in
                      else F64, device=cl.device)
    x0 = np.sqrt(prob.logical_n) / 2.0
    inA[(0,) * inA.dim()] = x0
    if prob.kind == "c2r":
        # delta in the half-spectrum == constant real output, but only in
        # the batch entry holding the delta (the rest are zero)
        outA = torch.zeros(cl.plan.out_shape, dtype=F64, device=cl.device)
        outA[(0,) * len(prob.batch)] = x0
    else:
        outA = oracle(inA)
    e = acmp(cl.apply(inA), outA, tol, "impulse 1")
    res.tests["impulse"] = e
    # superposition rounds: T(B) + T(A-B) == T(A)
    for r in range(rounds):
        inB = cl.rand_input(rng)
        inC = inA - inB
        t = cl.apply(inB) + cl.apply(inC)
        e = max(e, acmp(t, cl.apply(inA), tol, f"impulse round {r}"))
    res.tests["impulse"] = e


def _linear(cl: _Closure, rng, rounds: int, tol: float,
            res: VerifyResult) -> None:
    # real coefficients for every non-c2c problem: c2r's Hermitian mirror is
    # conjugate-linear, so only real-linearity holds (verify-rdft2 realp=1)
    realp = cl.prob.kind != "c2c"
    e = 0.0
    for r in range(rounds):
        alpha = rng.uniform(-0.5, 0.5) + \
            (0 if realp else 1j * rng.uniform(-0.5, 0.5))
        beta = rng.uniform(-0.5, 0.5) + \
            (0 if realp else 1j * rng.uniform(-0.5, 0.5))
        inA = cl.rand_input(rng)
        inB = cl.rand_input(rng)
        want = alpha * cl.apply(inA) + beta * cl.apply(inB)
        got = cl.apply(alpha * inA + beta * inB)
        e = max(e, acmp(got, want, tol, f"linear round {r}"))
    res.tests["linear"] = e


def _tf_shift(cl: _Closure, rng, rounds: int, tol: float,
              res: VerifyResult) -> None:
    """Time-shift <-> phase duality over each transform axis (c2c only)."""
    prob = cl.prob
    if prob.kind != "c2c":
        return
    e = 0.0
    sign = prob.sign
    for r in range(rounds):
        inA = cl.rand_input(rng)
        for a in prob.axes:
            n = prob.shape[a]
            shp = [1] * inA.dim()
            shp[a] = n
            k = torch.arange(n, dtype=F64, device=cl.device)
            # time shift by one: y[t] = x[(t-1) mod n]  =>
            # Y[k] = X[k] * exp(sign*2pi i k / n)
            phase = torch.polar(torch.ones_like(k), sign * 2 * np.pi * k / n)
            want = cl.apply(inA) * phase.reshape(shp)
            got = cl.apply(torch.roll(inA, 1, a))
            e = max(e, acmp(got, want, tol, f"tf_shift axis {a} round {r}"))
            # frequency shift: x[t] * exp(-sign*2pi i t / n) => roll(Y, 1)
            got2 = cl.apply(inA * phase.conj().reshape(shp))
            want2 = torch.roll(cl.apply(inA), 1, a)
            e = max(e, acmp(got2, want2, tol, f"fs_shift axis {a} round {r}"))
    res.tests["tf_shift"] = e


def verify_problem(prob_or_str, flags: int = K.ESTIMATE,
                   rounds: int = 4, tol: Optional[float] = None,
                   rdtype: str = "float32", seed: int = 0,
                   device=None) -> VerifyResult:
    """Run the full property-test battery on a problem (verify() analog,
    libbench2/verify.c) on `device` (default ``config.device``).  Raises
    VerificationError on failure."""
    from .problem import parse_problem

    prob = parse_problem(prob_or_str) if isinstance(prob_or_str, str) \
        else prob_or_str
    if tol is None:
        tol = default_tol(rdtype)
    rng = np.random.default_rng(seed)
    cl = _Closure(prob, flags, rdtype, device)
    res = VerifyResult(problem=prob.pstring or str(prob))
    _impulse(cl, rng, rounds, tol, res)
    _linear(cl, rng, rounds, tol, res)
    _tf_shift(cl, rng, rounds, tol, res)
    if prob.kind in ("r2c", "c2r"):
        _real_roundtrip(cl, rng, tol, res)
    return res


def _real_roundtrip(cl: _Closure, rng, tol: float, res: VerifyResult) -> None:
    """r2c/c2r: unnormalized round trip recovers n*x (verify-rdft2 analog),
    the two plans called one after the other."""
    from .. import api

    prob = cl.prob
    real_shape = prob.shape
    dt = str(cl.rdtype)
    if prob.kind == "r2c":
        fwd = cl.plan
        inv = api.plan_dft_c2r(real_shape, prob.axes, dtype=dt,
                               device=cl.device)
    else:
        fwd = api.plan_dft_r2c(real_shape, prob.axes, dtype=dt,
                               device=cl.device)
        inv = cl.plan
    x = _rand(rng, real_shape, False, cl.device)
    y = inv.apply(fwd.apply(x.to(fwd.in_dtype)))
    res.tests["roundtrip"] = acmp(y, prob.logical_n * x, tol,
                                  "real roundtrip")
