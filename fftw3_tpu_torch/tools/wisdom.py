"""fftw-wisdom CLI analog (``fftw/tools/fftw-wisdom.c``; the port of
``fftw3_tpu/tools/wisdom.py``): pre-plan a set of canonical (or
user-given) transforms on ``config.device`` and export accumulated wisdom.

Usage::

    python -m fftw3_tpu_torch.tools.wisdom [-n] [-p|-x|-e] [-T hours] \
           [-o FILE] [-w FILE] [PROBLEM ...]

    PROBLEM      bench problem strings (c1024, r256, k512e10, 64x64, ...)
    -n           plan the canonical size set (powers of two + common sizes,
                 c2c and r2c, 1d/2d), like fftw-wisdom's --canonical
    -e/-m/-p/-x  patience: estimate / measure (default) / patient /
                 exhaustive
    -t HOURS     planner time limit (fftw_set_timelimit analog)
    -o FILE      output wisdom file (default: stdout)
    -w FILE      import existing wisdom first
    -v           verbose: print each planned problem
"""
from __future__ import annotations

import argparse
import sys

from .. import api
from .. import kinds as K
from ..harness.problem import make_plan, parse_problem

CANONICAL = (
    [f"c{1 << k}" for k in range(1, 17)]
    + [f"r{1 << k}" for k in range(1, 17)]
    + ["c100", "c1000", "c10000", "r100", "r1000", "r10000"]
    + [f"c{n}x{n}" for n in (16, 32, 64, 128, 256, 512)]
    + [f"r{n}x{n}" for n in (16, 32, 64, 128, 256, 512)]
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fftw3_tpu_torch.tools.wisdom",
                                 description=__doc__)
    ap.add_argument("problems", nargs="*", metavar="PROBLEM")
    ap.add_argument("-n", "--canonical", action="store_true")
    ap.add_argument("-e", "--estimate", action="store_true")
    ap.add_argument("-m", "--measure", action="store_true")
    ap.add_argument("-p", "--patient", action="store_true")
    ap.add_argument("-x", "--exhaustive", action="store_true")
    ap.add_argument("-t", "--time-limit", type=float, default=None,
                    metavar="HOURS")
    ap.add_argument("-o", "--output-file", default=None)
    ap.add_argument("-w", "--wisdom-file", default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    flags = K.MEASURE
    if args.estimate:
        flags = K.ESTIMATE
    if args.patient:
        flags = K.PATIENT
    if args.exhaustive:
        flags = K.EXHAUSTIVE
    if args.time_limit is not None:
        api.set_timelimit(args.time_limit * 3600.0)
    if args.wisdom_file:
        if not api.import_wisdom_from_filename(args.wisdom_file):
            print(f"error importing wisdom from {args.wisdom_file}",
                  file=sys.stderr)
            return 1

    problems = list(args.problems)
    if args.canonical:
        problems += CANONICAL
    if not problems:
        ap.error("no problems given (pass PROBLEM strings or -n)")

    for ps in problems:
        try:
            plan = make_plan(parse_problem(ps), flags)
            if args.verbose:
                print(f"planned {ps}: {plan!r}", file=sys.stderr)
        except Exception as exc:                       # noqa: BLE001
            print(f"error planning {ps}: {exc}", file=sys.stderr)
            return 1

    wis = api.export_wisdom_to_string()
    if args.output_file:
        with open(args.output_file, "w") as f:
            f.write(wis)
    else:
        print(wis)
    return 0


if __name__ == "__main__":
    sys.exit(main())
