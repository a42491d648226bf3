"""FFT filtering of real fields as an FFTW user writes it: a forward
``plan_many_dft_r2c`` and the matching backward ``plan_many_dft_c2r``
planned once, a fixed filter's half spectrum H kept on the device, and
each call ``X = r2c.execute(x); X.mul_(H); c2r.execute(X)``: the forward
transform, the filter applied in place, the unnormalised backward
transform.  H is the phase-only filter of ``references/phase_filter.py``,
made at plan time in float64 on the device and kept in the transform's
complex precision: data, as a model's weights are.  The call's arguments
are the real part of the seeded complex input; its output, the filtered
real fields, is compared as it is; the control takes the real field too."""
from __future__ import annotations

import torch

from ..references import phase_filter

_COMPLEX = {"float32": torch.complex64, "float64": torch.complex128}


class Filtering:
    """The two plans and H.  ``_plan`` is the c2r's underlying plan, whose
    ``_apply`` each call runs last (where ``faults.hook`` plants)."""

    def __init__(self, r2c, c2r, h):
        self.r2c, self.c2r, self.h = r2c, c2r, h
        self._plan = c2r.plan

    def __call__(self, x):
        X = self.r2c.execute(x)
        X.mul_(self.h)
        return self.c2r.execute(X)

    def __repr__(self):
        return f"(filter {self.r2c!r} {self.c2r!r})"


def plan(ft, problem, dtype, flags, device):
    n, howmany = problem.sizes, problem.nbatch
    r2c = ft.plan_many_dft_r2c(n, howmany, flags=flags, dtype=dtype,
                               device=device)
    c2r = ft.plan_many_dft_c2r(n, howmany, flags=flags, dtype=dtype,
                               device=device)
    h = phase_filter.filter_half(n, device).to(_COMPLEX[dtype])
    return Filtering(r2c, c2r, h)


def args(x):
    return (x.real.contiguous(),)


def bind(ft, plan):
    return plan


def output(y):
    return y


def wrap(f):
    return f
