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
double-double long-double/quad tier (``plan_dft_1d_l``/``_q``).  Around
the plans: the numpy-style functional API (``fft`` ... ``irfftn``,
``dct``/``dst``/``dht``, plan-cached per device), the guru and advanced
layouts (``guru.py``: iodim strides, split arrays, embedded buffers), the
``numpy.fft``/``scipy.fft`` interfaces (``interfaces/``), wisdom I/O and
the FFTW bench harness (``harness/``, ``python -m
fftw3_tpu_torch.harness``).  Imports ``torch``, never ``jax``.
"""
from . import config  # noqa: F401
from .api import (  # noqa: F401
    BACKWARD, ESTIMATE, FORWARD, Kind, Plan, Problem, alignment_of, alloc_complex, alloc_real, cc, cleanup,
    codelet_optim, cost, dct, destroy_plan, dht, dst, estimate_cost,
    execute, export_wisdom, export_wisdom_to_file, export_wisdom_to_filename,
    export_wisdom_to_string, fft, fft2, fftfreq, fftn, fftshift, flops,
    forget_wisdom, fprint_plan, free, get_functional_flags, idct, idst,
    ifft, ifft2, ifftn, ifftshift, import_reference_wisdom,
    import_system_wisdom, import_wisdom, import_wisdom_from_file,
    import_wisdom_from_filename, import_wisdom_from_string, irfft, irfft2,
    irfftn, malloc, plan_dft, plan_many_dft, plan_dft_1d, plan_dft_2d, plan_dft_3d,
    plan_dft_c2r, plan_dft_c2r_1d, plan_dft_c2r_2d, plan_dft_c2r_3d,
    plan_dft_r2c, plan_dft_r2c_1d, plan_dft_r2c_2d, plan_dft_r2c_3d,
    plan_r2r, plan_r2r_1d, plan_r2r_2d, plan_r2r_3d, print_plan, rfft,
    rfft2, rfftfreq, rfftn, set_functional_flags, set_timelimit,
    sprint_plan, version)
from .guru import (  # noqa: F401
    ManyPlan, SplitPlan, StridedGuruPlan, execute_dft, execute_dft_c2r,
    execute_dft_r2c, execute_r2r, execute_split_dft, execute_split_dft_c2r,
    execute_split_dft_r2c, iodim, iodim64, plan_guru64_dft,
    plan_guru64_dft_c2r, plan_guru64_dft_r2c, plan_guru64_r2r,
    plan_guru64_split_dft, plan_guru64_split_dft_c2r,
    plan_guru64_split_dft_r2c, plan_guru_dft, plan_guru_dft_c2r,
    plan_guru_dft_r2c, plan_guru_r2r, plan_guru_split_dft,
    plan_guru_split_dft_c2r, plan_guru_split_dft_r2c, plan_many_dft_c2r, plan_many_dft_r2c, plan_many_r2r)
from .kinds import (  # noqa: F401
    EXHAUSTIVE, MEASURE, PATIENT, WISDOM_ONLY, r2r_kind)
from .ops.dd64 import (  # noqa: F401  (fftwl_/fftwq_ tier)
    DdPlan, DdPlanNd, plan_dft_1d_l, plan_dft_1d_q, plan_dft_l, plan_dft_q)
from .planner import the_planner  # noqa: F401

__version__ = "0.1.0"
from . import harness  # noqa: F401,E402
from . import interfaces  # noqa: F401,E402
