"""``Plan.execute(x)`` on a contiguous complex tensor: FFTW's
``fftw_execute`` on ``fftw_complex`` arrays, what ``fft(x)`` runs.  A
batch plans with ``plan_many_dft``, a single transform with ``plan_dft``
(``plan_dft_3d`` for three axes)."""
from __future__ import annotations


def plan(ft, problem, dtype, flags, device):
    if problem.batch:
        return ft.plan_many_dft(problem.sizes, problem.nbatch, problem.sign,
                                flags, dtype, device)
    return ft.plan_dft(problem.sizes, None, problem.sign, flags, dtype,
                       device)


def args(x):
    return (x,)


def bind(ft, plan):
    return plan.execute


def output(y):
    return y


def wrap(f):
    return f
