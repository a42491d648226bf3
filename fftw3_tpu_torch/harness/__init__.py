"""Bench/verify harness — the libbench2 analog, the port of
``fftw3_tpu/harness/``.

Components:

* :mod:`.problem`  — FFTW bench problem-string parser (``libbench2/problem.c``
  behavior: ``[i|o][r|c|k][f|b]<size>[x<size>...][v<batch>]``).
* :mod:`.verify`   — self-verification by mathematical properties (impulse /
  linear / time-shift; Ergün linear-function testing, the method of
  ``libbench2/verify-lib.c``) with the relative-Linf ``acmp`` comparator,
  on the plan's device.
* :mod:`.mflops`   — FFTW's normalized-mflops conventions
  (``libbench2/mflops.c``).
* :mod:`.accuracy` — L1/L2/Linf error columns against the float64 oracle.
* :mod:`.paranoid` — planner-hook recursive sub-plan verification
  (``tests/hook.c`` analog).
* :mod:`.fuzz`     — random problem generator + runner (``tests/check.pl``
  analog).
* :mod:`.cli`      — the ``bench`` binary analog: ``python -m
  fftw3_tpu_torch.harness -s <problem> -y <problem>``.
"""
from .problem import BenchProblem, parse_problem  # noqa: F401
from .verify import VerificationError, acmp, verify_problem  # noqa: F401
from .mflops import mflops  # noqa: F401
