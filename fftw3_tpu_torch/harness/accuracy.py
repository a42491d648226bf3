"""Accuracy measurement (the ``accuracy_test`` harness of
``fftw/libbench2/verify.h``; the port of ``fftw3_tpu/harness/accuracy.py``):
L1 / L2 / Linf error columns of a transform against the float64 dense
oracle, on the plan's device, or of the round trip (r2c then the
unnormalized c2r, over N) for c2r problems.

Used for accuracy regression tracking: run
``python -m fftw3_tpu_torch.harness.accuracy c1024 r512 k512e10 ...`` and
diff the columns between versions.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .. import kinds as K
from .problem import parse_problem
from .verify import _Closure, _oracle_1d, _rand


@dataclass
class AccuracyResult:
    problem: str
    norms: Dict[str, float]

    def __repr__(self):
        cols = " ".join(f"{k}={v:.3e}" for k, v in self.norms.items())
        return f"(accuracy {self.problem} {cols})"


def _norms(err: torch.Tensor, ref: torch.Tensor,
           prefix: str) -> Dict[str, float]:
    err, ref = err.abs().reshape(-1), ref.abs().reshape(-1)
    return {
        f"{prefix}l1": float(err.sum()) / max(float(ref.sum()), 1e-300),
        f"{prefix}l2": float(torch.linalg.vector_norm(err))
        / max(float(torch.linalg.vector_norm(ref)), 1e-300),
        f"{prefix}linf": float(err.max()) / max(float(ref.max()), 1e-300),
    }


def accuracy_test(prob_or_str, flags: int = K.ESTIMATE,
                  rdtype: str = "float32", seed: int = 0,
                  device=None) -> AccuracyResult:
    prob = parse_problem(prob_or_str) if isinstance(prob_or_str, str) \
        else prob_or_str
    rng = np.random.default_rng(seed)
    cl = _Closure(prob, flags, rdtype, device)
    x = cl.rand_input(rng)
    got = cl.apply(x)
    if prob.kind == "c2r":
        # no direct oracle for half-spectrum input; measure the round trip
        from .. import api
        fwd = api.plan_dft_r2c(prob.shape, prob.axes, dtype=str(cl.rdtype),
                               device=cl.device)
        xr = _rand(rng, prob.shape, False, cl.device)
        y = cl.plan.apply(fwd.apply(xr.to(fwd.in_dtype))).to(torch.float64)
        ref = prob.logical_n * xr
        return AccuracyResult(prob.pstring, _norms(y - ref, ref, ""))
    want = _oracle_1d(prob, cl.rdtype, cl.device)(x)
    return AccuracyResult(prob.pstring, _norms(got - want, want, ""))


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    double = "--double" in args
    probs = [a for a in args if not a.startswith("-")]
    if not probs:
        print("usage: python -m fftw3_tpu_torch.harness.accuracy [--double] "
              "PROBLEM ...", file=sys.stderr)
        return 2
    for p in probs:
        res = accuracy_test(p, rdtype="float64" if double else "float32")
        print(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
