"""The double-double ("dd64") c2c tier: the long-double / quad precision
analog (FFTW's ``fftwl_``/``fftwq_`` plan families) — the port of
``fftw3_tpu/ops/dd64.py``.

Every value travels as an unevaluated sum of two f64s and every operation is
an error-free transform: the dtype-generic ``df_*`` ops of ``ops/df32.py``
on f64 tensors (Dekker two-product with the 2^27+1 split, Knuth two-sum),
about 106 mantissa bits.  Trig constants come from mpmath at 40 significant
digits, split exactly into f64 (hi, lo) pairs, so constant error (about
1e-32) never caps the tier: about 1e-30 relative on a transform, past x86
long double (eps 1.1e-19) and a few bits short of IEEE quad (eps 1.9e-34).

:class:`DdPlan` offers

* ``execute(x)`` on host ``np.clongdouble`` arrays (split and recombine on
  the host in longdouble; the planes go to the plan's device and back), and
* ``apply_dd(rh, rl, ih, il)`` on four (..., n) f64 tensors on the plan's
  device: the double-double pair form, which keeps all 106 bits.

Scope: c2c along the last axis, any leading batch dims, 2-3-5-smooth n.
Needs ``mpmath`` (a dependency of torch's ``sympy``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import config
from . import df32
from .df32 import _canon, _on, df32_radices

_MP_DPS = 40


def _mp():
    try:
        import mpmath
    except ImportError as e:
        raise ImportError("the dd64 tier needs mpmath for its constants "
                          "(it comes with torch's sympy dependency)") from e
    mpmath.mp.dps = _MP_DPS
    return mpmath


def _split_mp(vals) -> Tuple[np.ndarray, np.ndarray]:
    """mpmath values -> exact f64 (hi, lo) pair arrays."""
    mp = _mp()
    hi = np.array([float(v) for v in vals], dtype=np.float64)
    lo = np.array([float(v - mp.mpf(h)) for v, h in zip(vals, hi)],
                  dtype=np.float64)
    return hi, lo


def _roots(n: int, ks, sign: int):
    """exp(sign*2*pi*i*k/n) at 40 digits via exact-argument cospi/sinpi."""
    mp = _mp()
    re, im = [], []
    for k in ks:
        a = mp.mpf(2 * int(k)) / n            # angle in units of pi
        re.append(mp.cospi(a))
        im.append(mp.sinpi(a) * sign)
    return re, im


def _split_roots(n: int, ks, sign: int, shape) -> Tuple[np.ndarray, ...]:
    re, im = _roots(n, ks, sign)
    rh, rl = _split_mp(re)
    ih, il = _split_mp(im)
    return tuple(a.reshape(shape) for a in (rh, rl, ih, il))


def _dd_consts(p: int, q: int, sign: int, device):
    """One level's constants for df32's recursive builder, in dd64: the
    radix-p butterfly coefficients and the (p, q) twiddle grid from mpmath,
    split exactly into f64 (hi, lo) pairs (complex128 trig would cap the
    tier at 1e-16), as f64 tensors on `device`."""
    # butterfly matrix F[j,k] = w^(jk), w = exp(sign*2*pi*i/p)
    coeffs = []
    csplit = []
    for k in range(p):
        rh, rl, ih, il = _split_roots(p, [(j * k) % p for j in range(p)],
                                      sign, (p,))
        coeffs.append([_canon(complex(rh[j] + 1j * ih[j]))
                       for j in range(p)])
        csplit.append([(_on(np.array([rh[j], ih[j]]), device),
                        _on(np.array([rl[j], il[j]]), device))
                       for j in range(p)])
    # twiddle grid w_n^(k*j), n = p*q, shaped (p, q)
    n = p * q
    ks = [(k * j) % n for k in range(p) for j in range(q)]
    tw = tuple(_on(a, device) for a in _split_roots(n, ks, sign, (p, q)))
    return coeffs, csplit, tw


def dd64_applicable(n: int) -> bool:
    return n >= 2 and df32_radices(n) is not None


def _device_of(device) -> torch.device:
    device = torch.device(config.device if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"cannot build a dd64 plan for device {device}: "
                           f"this torch build sees no CUDA device")
    return device


def _execute(apply_dd, device: torch.device, x) -> np.ndarray:
    """Host complex array -> np.clongdouble through `apply_dd`: the split
    into four f64 planes (exact for the hi plane) and the recombination
    happen on the host in longdouble, the transform on `device`."""
    xl = np.asarray(x).astype(np.clongdouble)
    rh = xl.real.astype(np.float64)
    ih = xl.imag.astype(np.float64)
    rl = (xl.real - rh.astype(np.longdouble)).astype(np.float64)
    il = (xl.imag - ih.astype(np.longdouble)).astype(np.float64)
    yrh, yrl, yih, yil = (v.cpu().numpy() for v in apply_dd(
        *(torch.from_numpy(v).to(device) for v in (rh, rl, ih, il))))
    yr = yrh.astype(np.longdouble) + yrl.astype(np.longdouble)
    yi = yih.astype(np.longdouble) + yil.astype(np.longdouble)
    return (yr + 1j * yi).astype(np.clongdouble)


class _DdApply(torch.autograd.Function):
    """Four dd planes in and out, with the opposite-sign transform of the
    four cotangent planes as the backward (autograd through the error-free
    chains would lose the lo planes)."""

    @staticmethod
    def forward(ctx, rh, rl, ih, il, fwd, adj):
        ctx.adj = adj
        return fwd((rh, rl, ih, il))

    @staticmethod
    def backward(ctx, *g):
        ref = next(t for t in g if t is not None)
        g = tuple(torch.zeros_like(ref) if t is None else t for t in g)
        return (*ctx.adj(g), None, None)


class DdPlan:
    """Long-double/quad-tier c2c plan (fftwl_plan / fftwq_plan analog) on
    `device` (default ``config.device``)."""

    def __init__(self, n: int, sign: int = -1, device=None):
        if not dd64_applicable(n):
            raise ValueError(
                f"dd64 tier needs 2-3-5-smooth n >= 2, got {n}")
        self.n = n
        self.sign = sign
        self.device = _device_of(device)
        # df32's recursive builder on f64 planes, with dd64's constants
        core, adj = (df32.df_pipeline(n, df32_radices(n), s, self.device,
                                      _dd_consts) for s in (sign, -sign))

        def apply_dd(rh, rl, ih, il):
            """Four (..., n) f64 planes on the plan's device in and out."""
            return _DdApply.apply(rh, rl, ih, il, core, adj)
        self.apply_dd = apply_dd

    def execute(self, x: np.ndarray) -> np.ndarray:
        """Host np.clongdouble (or any complex) array -> np.clongdouble.
        The lo planes carry bits 54-106, of which clongdouble holds 54-64
        (the container's limit, not the transform's: ``apply_dd`` keeps
        all 106)."""
        return _execute(self.apply_dd, self.device, x)

    def flops(self) -> Tuple[float, float, float]:
        # dd ops cost about 20 f64 flops each; the FFTW-convention (adds,
        # muls, fmas) triple, as Plan.flops gives it
        nlogn = self.n * np.log2(self.n)
        return (10.0 * nlogn, 8.0 * nlogn, 0.0)

    def __repr__(self):
        return (f"(dd64-{self.n} sign={self.sign} "
                f"radices={df32_radices(self.n)})")


class DdPlanNd:
    """Rank-n dd64 plan: one DdPlan per transform axis, applied along the
    last axis behind ``movedim``."""

    def __init__(self, shape, axes=None, sign: int = -1, device=None):
        shape = tuple(int(s) for s in shape)
        nd = len(shape)
        axes = tuple(a % nd for a in
                     (range(nd) if axes is None else axes))
        self.shape = shape
        self.axes = axes
        self.sign = sign
        self.device = _device_of(device)
        self._plans = {a: DdPlan(shape[a], sign, self.device) for a in axes}

    def apply_dd(self, rh, rl, ih, il):
        """Four f64 planes of the plan's shape (leading batch dims free) on
        the plan's device in and out; axes count from the right."""
        x = (rh, rl, ih, il)
        for a in self.axes:
            ax = a - len(self.shape)
            x = tuple(v.movedim(ax, -1) for v in x)
            x = self._plans[a].apply_dd(*x)
            x = tuple(v.movedim(-1, ax) for v in x)
        return x

    def execute(self, x: np.ndarray) -> np.ndarray:
        return _execute(self.apply_dd, self.device, x)

    def __repr__(self):
        return f"(dd64-nd {self.shape} axes={self.axes} sign={self.sign})"


def plan_dft_1d_l(n: int, sign: int = -1, device=None) -> DdPlan:
    """fftwl_plan_dft_1d analog (x86 long double: eps 1.1e-19)."""
    return DdPlan(n, sign, device)


def plan_dft_1d_q(n: int, sign: int = -1, device=None) -> DdPlan:
    """fftwq_plan_dft_1d analog (IEEE quad: eps 1.9e-34; dd64 reaches
    about 1e-30, the double-double representation's limit)."""
    return DdPlan(n, sign, device)


def plan_dft_l(shape, axes=None, sign: int = -1, device=None) -> DdPlanNd:
    """fftwl_plan_dft / _2d / _3d analog: rank-n long-double c2c."""
    return DdPlanNd(shape, axes, sign, device)


plan_dft_q = plan_dft_l
