"""One RK2 step of pseudo-spectral 2-D Navier-Stokes on a batch of real
vorticity fields, as a solver's user calls it: ``step =
fftw3_tpu_torch.models.navier_stokes_step(ny, nx, nu, dt)`` built once,
then ``w = step(w)``.  The step draws its three plans (the forward r2c of
the batch, the c2r of the four stacked velocity and gradient spectra, the
c2r of the new spectrum) from the functional API's cache, which the plan
clears first, at the traffic's patience.  ``nu`` and ``dt`` are the
configuration's, kept in ``references/navier_stokes.py``.  The call's
argument is the real part of the seeded complex input; its output, the
stepped real fields, is compared as it is; the control takes the real
field too."""
from __future__ import annotations

import torch

from fftw3_tpu_torch import models

from ..references import navier_stokes


class Stepping:
    """The step.  ``_plan`` is the plan of its last c2r (the new spectrum
    back to the fields), whose ``_apply`` each call runs last (where
    ``faults.hook`` plants)."""

    def __init__(self, step, last):
        self.step, self._plan = step, last

    def __call__(self, w):
        return self.step(w)

    def __repr__(self):
        return f"(navier-stokes rk2 step, last {self._plan!r})"


def plan(ft, problem, dtype, flags, device):
    if problem.kind != "r2c" or len(problem.sizes) != 2 or dtype != "float32":
        raise ValueError(f"a 2-D real float32 problem steps, not "
                         f"{problem.text!r} in {dtype}")
    ny, nx = problem.sizes
    ft.set_functional_flags(flags)           # drops every cached plan
    step = models.navier_stokes_step(ny, nx, navier_stokes.NU,
                                     navier_stokes.DT)
    # the cached plan the step's last irfftn draws: its key is the one
    # irfftn makes from a half spectrum of the batch's shape
    half = problem.shape[:-1] + (nx // 2 + 1,)
    spectrum = torch.zeros((), dtype=torch.complex64,
                           device=device).expand(half)
    last = ft.api._plan_for("c2r", spectrum, (-2, -1), ft.BACKWARD,
                            dtype, shape=problem.shape)
    return Stepping(step, last)


def args(x):
    return (x.real.contiguous(),)


def bind(ft, plan):
    return plan


def output(y):
    return y


def wrap(f):
    return f
