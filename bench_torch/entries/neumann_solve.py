"""A Neumann Poisson solve on a real grid, as a solver's user calls it:
``solve = fftw3_tpu_torch.models.solve_neumann_fn(spacing)`` built once,
then ``u = solve(f)``, the pressure projection of an incompressible flow
in a closed box, once a time step.  The solve draws its six r2r plans (a
DCT-II and a DCT-III along each axis) from the functional API's cache,
which the plan clears first, at the traffic's patience, and divides by
eigenvalues it builds on the device at its first call.  The spacing is
1/n on every axis, the unit cube of the configuration
(``references/neumann_poisson.py`` solves with the same).  The call's
argument is the real part of the seeded complex input; its output, the
real solution, is compared as it is; the control takes the real field
too."""
from __future__ import annotations

import torch

from fftw3_tpu_torch.models import solve_neumann_fn


class Solving:
    """The solve.  ``_plan`` is the plan of its last DCT-III (along the
    last axis), whose ``_apply`` each call runs last (where
    ``faults.hook`` plants)."""

    def __init__(self, spacing, last):
        self.spacing, self._plan = spacing, last
        self.solve = solve_neumann_fn(spacing)

    def __call__(self, f):
        return self.solve(f)

    def __repr__(self):
        return f"(neumann poisson solve, last {self._plan!r})"


def plan(ft, problem, dtype, flags, device):
    if problem.kind != "r2r" or set(problem.r2r) != {"e10"} \
            or dtype != "float32":
        raise ValueError(f"a real float32 DCT-II problem solves, not "
                         f"{problem.text!r} in {dtype}")
    ft.set_functional_flags(flags)           # drops every cached plan
    spacing = tuple(1.0 / n for n in problem.sizes)
    # the cached plan the solve's last dct draws: its key is the one
    # dct(type=3, axis=-1) makes from a real field of the batch's shape
    field = torch.zeros((), dtype=torch.float32,
                        device=device).expand(problem.shape)
    last = ft.api._plan_for("r2r", field, (-1,), ft.FORWARD, dtype,
                            (ft.Kind.REDFT01.value,))
    return Solving(spacing, last)


def args(x):
    return (x.real.contiguous(),)


def bind(ft, plan):
    return plan


def output(y):
    return y


def wrap(f):
    return f
