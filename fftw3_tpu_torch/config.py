"""Global configuration of the PyTorch/CUDA port.

Read at plan-build time (a plan built under one setting keeps it), except
``measure_hysteresis``, ``measure_points`` and ``random_estimator``, which
the planner reads while it searches.
"""
from __future__ import annotations

#: Hand-written kernel tier, the analog of the reference's ``pallas_mode``:
#: 'auto' (the planner offers the kernel solvers for plans on a CUDA device
#: and leaves them out elsewhere) | 'on' (offered on every device) | 'off'
#: (never offered).  Whatever the mode, a kernel solver runs the CUDA
#: kernel on a CUDA tensor and its plain PyTorch twin on a CPU tensor.
kernel_mode: str = "auto"

#: Device that plans are built for when the caller names none.  A plan for
#: a CUDA device raises when CUDA is missing; nothing falls back to the CPU.
device: str = "cuda"

#: MEASURE-mode problem sizing: points per timing array when the caller
#: gives no batch, and the cap when it does.
measure_points: int = 1 << 23

#: MEASURE hysteresis: a measured winner must satisfy
#: t_winner < measure_hysteresis * t_estimate_choice to override the
#: ESTIMATE ranking.  0.95 suits a locally attached card, where a 5-25%
#: MEASURE win is signal; 1.0 always trusts the measurement.
measure_hysteresis: float = 0.95

#: FFTW_RANDOM_ESTIMATOR analog: an integer seed makes the planner's cost
#: estimator return deterministic pseudo-random values, so repeated
#: planning under different seeds walks plans the real estimator would never
#: pick.  None = off (real costs).
random_estimator = None

#: Leave the double-float tier out of complex128/float64 plans
#: (``ops/df32.py``): with ``strict_f64 = True`` every f64 plan computes in
#: native FP64 (``torch.matmul`` stages, or cuFFT Z2Z for ``xla``), about
#: 1e-16 instead of about 1e-13 — the reference's semantics.
strict_f64: bool = False

#: Swapped rank-2 r2c composition (plan.py): r2c over axis -2 first (K5),
#: then the last-axis c2c over the half spectrum's rows, then a Hermitian
#: rebuild to the contract layout (half spectrum on the last axis).  Off,
#: as in the reference, where it lost; it has no gradient (K5 is
#: forward-only).  ``chip_smoke.py`` times it on the card (PERF.md).
r2c_swapped: bool = False

#: Surface best-effort failures instead of counting them: under ``True`` a
#: MEASURE candidate on the CPU that raises re-raises instead of being
#: dropped (on a CUDA device it always re-raises).
debug: bool = False
