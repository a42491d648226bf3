"""Random-problem fuzzer (``fftw/tests/check.pl`` analog; the port of
``fftw3_tpu/harness/fuzz.py``).

Generates random problems — rank 1-3, smooth and non-smooth sizes, batched,
forward/backward, every transform kind — renders them as bench problem
strings, and runs the property verifier on each, on ``config.device``.
The same seed walks the same problems as the reference's fuzzer (the same
draws from numpy's generator, in the same order).  Used both as a pytest
(bounded) and as a standalone soak run::

    python -m fftw3_tpu_torch.harness.fuzz --count 50 --seed 7 --maxsize 512

The distributed fuzzer (the reference's ``run_fuzz_dist``) waits for the
port's distributed tier.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np

from .. import kinds as K

_R2R_CODES = {K.Kind.R2HC: "f", K.Kind.HC2R: "b", K.Kind.DHT: "h",
              K.Kind.REDFT00: "e00", K.Kind.REDFT01: "e01",
              K.Kind.REDFT10: "e10", K.Kind.REDFT11: "e11",
              K.Kind.RODFT00: "o00", K.Kind.RODFT01: "o01",
              K.Kind.RODFT10: "o10", K.Kind.RODFT11: "o11"}


def random_problem_string(rng: np.random.Generator, maxsize: int = 512,
                          maxrank: int = 3) -> str:
    """One random bench problem string (check.pl's problem generator role)."""
    kind = rng.choice(["c", "c", "c", "r", "k"])      # weight complex
    rank = int(rng.integers(1, maxrank + 1))
    if kind == "k":
        rank = min(rank, 2)                            # r2r: keep cheap
    sizes: List[int] = []
    for _ in range(rank):
        style = rng.choice(["pow2", "smooth", "any", "prime"])
        if style == "pow2":
            n = 2 ** int(rng.integers(1, int(np.log2(maxsize)) + 1))
        elif style == "smooth":
            from ..utils import primes
            n = primes.next_fast_size(int(rng.integers(2, maxsize)), smooth=7)
        elif style == "prime":
            from ..utils import primes
            n = int(rng.integers(3, maxsize))
            while not primes.is_prime(n):
                n += 1
        else:
            n = int(rng.integers(2, maxsize + 1))
        sizes.append(max(2, min(n, maxsize)))
    sign = rng.choice(["", "b"])                       # default forward
    place = rng.choice(["", "i", "o"])
    batch = int(rng.choice([0, 0, 2, 4, 8]))
    s = f"{place}{kind if kind != 'c' else ''}{sign}"
    if kind == "k":
        codes = [k.value for k in K.R2R_KINDS]
        dims = "x".join(f"{n}{_R2R_CODES[K.Kind(rng.choice(codes))]}"
                        for n in sizes)
        # DCT-I needs n>=2 with logical size 2(n-1)>0; DST/DCT fine at n>=2
        s += dims
    else:
        s += "x".join(str(n) for n in sizes)
    if batch:
        s += f"v{batch}"
    return s


def run_fuzz(count: int, seed: int, maxsize: int, patience_flags: int,
             verbose: bool = False, random_estimator: bool = False,
             device=None) -> int:
    """Verify `count` random problems on `device` (default
    ``config.device``); returns the number of failures.
    ``random_estimator=True`` re-rolls the planner's cost oracle per
    problem (FFTW_RANDOM_ESTIMATOR) so verification reaches solver
    compositions the calibrated estimator never picks."""
    from .. import config
    from .verify import VerificationError, verify_problem

    rng = np.random.default_rng(seed)
    failures = 0
    for i in range(count):
        ps = random_problem_string(rng, maxsize=maxsize)
        if random_estimator:
            config.random_estimator = int(rng.integers(1 << 30))
        try:
            res = verify_problem(ps, flags=patience_flags, rounds=2,
                                 seed=int(rng.integers(1 << 31)),
                                 device=device)
            if verbose:
                print(f"ok   {ps:24s} max_err={res.max_err:.2e}")
        except VerificationError as exc:
            failures += 1
            print(f"FAIL {ps}: {exc}", file=sys.stderr)
        except Exception as exc:                       # noqa: BLE001
            failures += 1
            print(f"ERROR {ps}: {type(exc).__name__}: {exc}",
                  file=sys.stderr)
        finally:
            if random_estimator:
                config.random_estimator = None
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--count", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--maxsize", type=int, default=512)
    ap.add_argument("--patient", action="store_true")
    ap.add_argument("--random-estimator", action="store_true",
                    help="re-roll the planner cost oracle per problem")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    flags = K.PATIENT if args.patient else K.ESTIMATE
    failures = run_fuzz(args.count, args.seed, args.maxsize, flags,
                        args.verbose, random_estimator=args.random_estimator)
    print(f"fuzz: {args.count - failures}/{args.count} passed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

