"""fftw3_tpu_torch — the PyTorch/CUDA port of ``fftw3_tpu``.

FFTW3's planned c2c, r2c, c2r and r2r surface on PyTorch tensors: batched
and multidimensional complex and real DFTs, the DCT/DST I-IV, DHT and
halfcomplex transforms (reduced to the real and complex ones, as FFTW's
reodft layer does), with the cost-driven planner and
wisdom of the reference package, the Stockham transforms as hand-written
CUDA kernels for Hopper (``csrc/``: the last axis, axis -2, both trailing
axes fused, the four-step above the one-kernel window, and the real r2c,
axis -2 r2c and c2r kernels, and the double-float kernel of complex128
plans), a plain PyTorch twin of every kernel for the CPU, and the
double-double long-double/quad tier (``plan_dft_1d_l``/``_q``).  Imports
``torch``, never ``jax``.
"""
from . import config  # noqa: F401
from .api import (  # noqa: F401
    Plan, Problem, cost, execute, export_wisdom_to_string, flops,
    forget_wisdom, import_reference_wisdom, import_wisdom_from_string,
    plan_dft, plan_dft_1d, plan_dft_2d, plan_dft_3d, plan_dft_c2r,
    plan_dft_c2r_1d, plan_dft_c2r_2d, plan_dft_c2r_3d, plan_dft_r2c,
    plan_dft_r2c_1d, plan_dft_r2c_2d, plan_dft_r2c_3d, plan_many_dft,
    plan_r2r, plan_r2r_1d, plan_r2r_2d, plan_r2r_3d, print_plan,
    set_timelimit, sprint_plan)
from .kinds import (  # noqa: F401
    BACKWARD, ESTIMATE, EXHAUSTIVE, FORWARD, MEASURE, PATIENT, WISDOM_ONLY,
    Kind, r2r_kind)
from .ops.dd64 import (  # noqa: F401  (fftwl_/fftwq_ tier)
    DdPlan, DdPlanNd, plan_dft_1d_l, plan_dft_1d_q, plan_dft_l, plan_dft_q)
from .planner import the_planner  # noqa: F401

__version__ = "0.1.0"
