"""The ``bench`` binary analog (``fftw/libbench2/bench-main.c`` +
``fftw/tests/fftw-bench.c``; the port of ``fftw3_tpu/harness/cli.py``),
on ``config.device``::

    python -m fftw3_tpu_torch.harness -s c1024            # speed
    python -m fftw3_tpu_torch.harness -y c1024 -y r256    # verify
    python -m fftw3_tpu_torch.harness -oestimate -opatient ...
    python -m fftw3_tpu_torch.harness --paranoid -y 32x64
    python -m fftw3_tpu_torch.harness -owisdom -s c4096   # wis.dat read/write

Speed output follows the reference's ``report_benchmark`` shape:
``Problem: <p>, setup: <t>, time: <t>, ``mflops``: <x>``; the time is the
device time of one ``plan.apply`` on tensors of the plan's dtypes (CUDA
events on the card), or of ``plan.apply_split`` for a split (``/``)
problem.

The distributed mode (``--dist``, ``--dist-method``) and ``-o nthreads=N``
wait for the port's distributed and threads tiers: they exit non-zero
with a message.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from .. import api
from .. import config
from .. import kinds as K
from .mflops import mflops
from .problem import make_plan, parse_problem
from .verify import VerificationError, verify_problem

WISFILE = "wis.dat"


def _speed(pstring: str, flags: int, verbose: int, dtype: str) -> None:
    from ..utils import timing

    prob = parse_problem(pstring)
    t0 = time.perf_counter()
    plan = make_plan(prob, flags, dtype)
    setup = time.perf_counter() - t0
    gen = torch.Generator(device=plan.device)
    gen.manual_seed(0)
    rdt = torch.float32 if plan.problem.rdtype == "float32" \
        else torch.float64
    complex_in = prob.kind in ("c2c", "c2r")

    def draw():
        return torch.randn(plan.in_shape, generator=gen, dtype=rdt,
                           device=plan.device)
    parts = (draw(), draw()) if complex_in else (draw(),)
    if prob.split:
        fn, args = plan.apply_split, parts
    else:
        fn = plan.apply
        args = (torch.complex(*parts),) if complex_in else parts
    t = timing.time_dispatched(fn, args, iters=10, reps=3)
    mf = mflops(prob, t)
    print(f"Problem: {pstring}, setup: {setup:.2f} s, time: {t:.3e} s, "
          f"``mflops'': {mf:.5g}")
    if verbose >= 2:
        plan.print_plan()


def _verify(pstring: str, flags: int, verbose: int, dtype: str,
            paranoid_mode: bool, rounds: int) -> None:
    rdtype = "float64" if dtype in ("float64", "complex128") else "float32"
    ctx = contextlib.nullcontext()
    if paranoid_mode:
        from .paranoid import paranoid
        ctx = paranoid()
    with ctx:
        res = verify_problem(pstring, flags=flags, rounds=rounds,
                             rdtype=rdtype)
    if verbose >= 1:
        print(f"{pstring} {res.max_err:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fftw3_tpu_torch.harness", add_help=True,
        description="FFTW-style bench/verify harness on the PyTorch port "
                    f"(device: config.device, now {config.device!r})")
    ap.add_argument("-s", "--speed", action="append", default=[],
                    metavar="PROBLEM")
    ap.add_argument("-y", "--verify", action="append", default=[],
                    metavar="PROBLEM")
    ap.add_argument("-v", "--verbose", type=int, nargs="?", const=1,
                    default=0)
    ap.add_argument("-o", "--option", action="append", default=[],
                    help="estimate|measure|patient|exhaustive|"
                         "wisdom|paranoid")
    ap.add_argument("--paranoid", action="store_true")
    ap.add_argument("--double", action="store_true",
                    help="float64/complex128 transforms")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--dist", type=int, default=0, metavar="P",
                    help="not ported yet: the distributed tier")
    ap.add_argument("--dist-method", default=None,
                    help="not ported yet: the distributed tier")
    args = ap.parse_args(argv)

    if args.dist or args.dist_method is not None:
        ap.error("--dist/--dist-method: the distributed tier is not ported "
                 "to fftw3_tpu_torch yet")
    flags = K.ESTIMATE
    use_wisdom = False
    for opt in args.option:
        o = opt.lower()
        if o == "estimate":
            flags = K.ESTIMATE
        elif o == "measure":
            flags = K.MEASURE
        elif o == "patient":
            flags = K.PATIENT
        elif o == "exhaustive":
            flags = K.EXHAUSTIVE
        elif o == "wisdom":
            use_wisdom = True
        elif o == "paranoid":
            args.paranoid = True
        elif o.startswith("nthreads="):
            ap.error(f"-o {opt}: the threads tier is not ported to "
                     f"fftw3_tpu_torch yet")
        else:
            ap.error(f"unknown -o option {opt!r}")

    if use_wisdom:
        api.import_wisdom_from_filename(WISFILE)

    dtype = "complex128" if args.double else "complex64"
    status = 0
    for p in args.verify:
        try:
            _verify(p, flags, args.verbose, dtype, args.paranoid,
                    args.rounds)
        except (VerificationError, ValueError) as exc:
            print(f"FAILED {p}: {exc}", file=sys.stderr)
            status = 1
    for p in args.speed:
        _speed(p, flags, args.verbose, dtype)

    if use_wisdom:
        api.export_wisdom_to_filename(WISFILE)
    return status


if __name__ == "__main__":
    sys.exit(main())
