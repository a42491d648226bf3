"""Faults planted in the port's plan underneath the entry point, to show
that the comparison catches them: each is a hook for
:func:`bench_torch.core.run_cell` that breaks the plan in place.

- ``unchanged``: the call returns its input, a transform that never ran;
- ``half_batch``: the second half of the batch is left out, its output
  rows at zero (cells with a batch);
- ``altered``: one output element moved by a thousandth of the output's
  largest magnitude where it is produced.

The exchange between chips has no counterpart: every cell runs on one.
"""
from __future__ import annotations

from typing import Callable, Dict, List


def _unchanged(complex_fn, split_fn):
    return (lambda x: x), (lambda xr, xi: (xr, xi))


def _half_batch(complex_fn, split_fn):
    def left_out(y):
        y = y.clone()
        y[y.shape[0] // 2:] = 0
        return y

    def split(xr, xi):
        return tuple(left_out(y) for y in split_fn(xr, xi))
    return (lambda x: left_out(complex_fn(x))), split


def _altered(complex_fn, split_fn):
    def alter(y):
        y = y.clone()
        flat = y.view(-1)
        flat[flat.numel() // 3] += 1e-3 * y.abs().max()
        return y

    def split(xr, xi):
        yr, yi = split_fn(xr, xi)
        return alter(yr), yi
    return (lambda x: alter(complex_fn(x))), split


FAULTS: Dict[str, Callable] = {"unchanged": _unchanged,
                               "half_batch": _half_batch,
                               "altered": _altered}


def applicable(problem) -> List[str]:
    """The faults a cell on `problem` can have."""
    return [f for f in FAULTS if f != "half_batch" or problem.batch]


def hook(name: str) -> Callable:
    """A ``hook(plan)`` that plants fault `name` in the plan's complex and
    split routes (in the plan a split guru plan wraps, if it is one)."""
    def plant(plan):
        inner = getattr(plan, "_plan", plan)
        inner._apply, inner.apply_split = FAULTS[name](inner._apply,
                                                       inner.apply_split)
    return plant
