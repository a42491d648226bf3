"""``execute_split_dft(plan, ri, ii)`` on contiguous real and imaginary
planes, from ``plan_guru_split_dft``: FFTW's split-array guru interface,
the form the port's kernels take, with no conversion pass."""
from __future__ import annotations

import functools

import torch

_REAL = {"complex64": "float32", "complex128": "float64"}


def plan(ft, problem, dtype, flags, device):
    return ft.plan_guru_split_dft(list(problem.sizes), list(problem.batch),
                                  problem.sign, flags, _REAL[dtype], device)


def args(x):
    return (x.real.contiguous(), x.imag.contiguous())


def bind(ft, plan):
    return functools.partial(ft.execute_split_dft, plan)


def output(y):
    return torch.complex(*y)


def wrap(f):
    def split(ri, ii):
        y = f(torch.complex(ri, ii))
        return y.real.contiguous(), y.imag.contiguous()
    return split
