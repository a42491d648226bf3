"""K8, the fused DCT-II / DCT-III kernel (``csrc/redft.cu``): FFTW's
unnormalised REDFT10 and REDFT01 along the last axis of real float32 rows,
the solvers of the r2r descriptors

    {"alg": "fused_redft10", "n": n, "radices": [...]}   # DCT-II
    {"alg": "fused_redft01", "n": n, "radices": [...]}   # DCT-III

with ``radices`` the n/2-point schedule.  K8 replaces no Pallas kernel: it
fuses K4 (DCT-II) or K6 (DCT-III) with the PyTorch passes of the Makhoul
reductions ``redft10_half`` and ``redft01_half`` (``ops/r2r.py``), so a
row is read once and written once.  Its gate is K4's
(:func:`real_stockham.r2c_applicable`: even n whose half the c2c kernel
takes, 256 <= n <= 4096) on a CUDA device; the planner offers it there
alone, so CPU plans keep the reference's descriptors.

* ``redft_torch``: the plain PyTorch version, today's reduction chains
  (``r2r.makhoul_dct2``/``makhoul_dct3``) around K4's and K6's twins;
* ``redft_cuda``: the launch, counted in :data:`launches`;
* ``build_fused_redft``: the apply of a descriptor, the twin for a CPU
  tensor, the kernel (or an error) for any other.

Gradients, by the transpose identities of FFTW's matrices: REDFT10's
transpose is REDFT01 with input element 0 doubled, REDFT01's is REDFT10
with output element 0 halved, so each direction's backward is the other
direction (``passes.Adjoint``).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import passes
from . import real_stockham as RS
from . import stockham as S

#: launches of the kernel, counted by :func:`redft_cuda`, and those of them
#: that ran the level plan compiled in (:func:`fixed_fits`)
launches = 0
fixed_launches = 0

#: alg -> the r2r kind it computes
KIND_OF = {"fused_redft10": "redft10", "fused_redft01": "redft01"}
#: kind -> the sign of its tables (K4's forward, K6's backward) and the
#: kernel's direction
_SIGN = {"redft10": -1, "redft01": +1}
_DIR = {"redft10": 0, "redft01": 1}

#: the level plan compiled into the kernel (``Fixed256`` in
#: ``csrc/redft.cu``): ``stockham.level_plan(256, (256,))``, the n = 512
#: schedule, on groups of FIXED_ROWS rows
FIXED_PLAN = (2, 1, 264, 512, 16, 16, 1, 256, 0, 0, 256, 1, 16, 16, 16, 16,
              0, 0, 256, 0)
FIXED_ROWS = 16
#: ``kMaxSmem`` of the kernel: the cap on a launch's shared memory
MAX_SMEM = 116736


def applicable(n: int, rdtype, device) -> bool:
    """The planner's gate: a CUDA device, float32, and K4's gate."""
    return (torch.device(device).type == "cuda"
            and RS.r2c_applicable(n, rdtype, device))


# ---------------------------------------------------------------------------
# host constants
# ---------------------------------------------------------------------------

def _table(n: int, radices: Sequence[int], sign: int) -> np.ndarray:
    """The kernel's f32 table: K4's (sign -1) or K6's (sign +1)
    (``real_stockham._real_table``), then re and im of the quarter-wave
    twiddle q^k = exp(sign*i*pi*k/(2n)), k = 0..n/2, from the host in f64."""
    k = np.arange(n // 2 + 1, dtype=np.int64)
    q = np.exp(sign * 1j * np.pi * k / (2 * n))
    return np.ascontiguousarray(np.concatenate(
        [RS._real_table(n, radices, sign), q.real, q.imag]), np.float32)


def table_len(n: int, radices: Sequence[int]) -> int:
    return RS.table_len(n, radices) + 2 * (n // 2 + 1)


@lru_cache(maxsize=None)
def device_table(n: int, radices: Tuple[int, ...], sign: int,
                 device: torch.device) -> torch.Tensor:
    """``_table`` as one f32 tensor on `device`, made once."""
    return torch.from_numpy(_table(n, radices, sign)).to(device)


def fixed_fits(plan: Sequence[int]) -> bool:
    """Does K8 run the level plan compiled into it?  Exactly when the
    host's plan is :data:`FIXED_PLAN`."""
    return tuple(plan) == FIXED_PLAN


def redft_smem(plan: Sequence[int], m: int, rpb: int) -> int:
    """Shared-memory bytes of K8 on the m-point `plan` with `rpb` rows a
    group (``redft_smem`` in csrc/redft.cu): the m-point tables, the w
    (or v) table and the q table; the level buffers; Z, two planes of rpb
    rows of m; the staging buffer of rpb rows of 2m."""
    nbuf, rs, tab_len = plan[1], plan[2], plan[3]

    def up4(v):
        return -(-v // 4) * 4
    return 4 * (up4(tab_len + 4 * (m + 1)) + 2 * nbuf * up4(rpb * rs)
                + 2 * up4(rpb * m) + up4(rpb * 2 * m))


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def redft_torch(x: torch.Tensor, kind: str, radices: Sequence[int]
                ) -> torch.Tensor:
    """Plain PyTorch version of K8: the Makhoul chain of ``redft10_half``
    around K4's twin (kind ``redft10``) or of ``redft01_half`` around K6's
    (``redft01``), real (..., n) -> real (..., n)."""
    from . import r2r
    n = x.shape[-1]
    if kind == "redft10":
        return r2r.makhoul_dct2(
            x, lambda v: RS.r2c_torch(v, radices),
            r2r._makhoul_index(n, False, x.device),
            *r2r._quarter_twiddle(n, -1, np.float32, x.device))
    return r2r.makhoul_dct3(
        x, lambda vr, vi: RS.c2r_torch(vr, vi, radices),
        r2r._makhoul_index(n, True, x.device),
        *r2r._quarter_twiddle(n, +1, np.float32, x.device))


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def redft_cuda(x: torch.Tensor, kind: str, radices: Sequence[int],
               table: torch.Tensor) -> torch.Tensor:
    """Launch K8 on real (B, n) f32 rows on one card: DCT-II for kind
    ``redft10``, DCT-III for ``redft01``.  ``table`` is
    ``device_table(n, radices, sign, device)`` with the kind's sign.
    Returns new real (B, n) rows; raises on anything the kernel does not
    take, and when the launch fails."""
    global launches, fixed_launches
    passes.check_planes("redft_cuda", x, x, table, 2)
    B, n = x.shape
    radices = [int(r) for r in radices]
    if n % 2 or not S.radices_ok(n // 2, radices):
        raise ValueError(f"redft_cuda: schedule {radices} does not fit n={n} "
                         f"(an even n with n/2 = its product)")
    if table.numel() != table_len(n, radices):
        raise ValueError(f"redft_cuda: table of {table.numel()} floats does "
                         f"not match n={n}, schedule {radices}")
    if B >= 2 ** 31:
        raise ValueError(f"batch {B} exceeds the kernel's int row count")
    y = torch.empty_like(x)
    if B == 0:
        return y
    m = n // 2
    plan = S.level_plan(m, tuple(radices))
    fixed = fixed_fits(plan)
    rpb = FIXED_ROWS if fixed else S.rows_per_block(m)
    passes.launch("redft", x.device, redft_smem(plan, m, rpb), -(-B // rpb),
                  (x.data_ptr(), y.data_ptr(), table.data_ptr(),
                   S.plan_array(plan), B, n, rpb, _DIR[kind], int(fixed)),
                  f"{kind}, B={B}, n={n}, radices={radices}")
    launches += 1
    fixed_launches += fixed
    return y


# ---------------------------------------------------------------------------
# descriptor -> apply
# ---------------------------------------------------------------------------

def build_fused_redft(desc: Dict, rdtype,
                      device: Optional[torch.device] = None):
    """Real (..., n) -> real (..., n) for a ``fused_redft10`` or
    ``fused_redft01`` descriptor, on any leading batch shape: the twin on a
    CPU tensor, K8 on a CUDA tensor (a strided input is made contiguous
    first, one copy).  Differentiable: each direction's backward is the
    other direction."""
    n = desc["n"]
    kind = KIND_OF[desc["alg"]]
    radices = RS._schedule(desc, rdtype)
    if device is not None and torch.device(device).type == "cuda":
        for k in _SIGN:                            # move the tables once
            device_table(n, tuple(radices), _SIGN[k], torch.device(device))

    def run(k):
        def fwd(x):
            if x.shape[-1] != n:
                raise ValueError(f"{k} expects real input of shape (..., "
                                 f"{n}), got {tuple(x.shape)}")
            if passes.on_twin(x):
                return redft_torch(x, k, radices)
            table = device_table(n, tuple(radices), _SIGN[k], x.device)
            return redft_cuda(x.reshape(-1, n).contiguous(), k, radices,
                              table).reshape(x.shape)
        return fwd

    def dct2(x):
        return passes.Adjoint.apply(run("redft10"), adj10, x)

    def dct3(x):
        return passes.Adjoint.apply(run("redft01"), adj01, x)

    def adj10(g):                        # REDFT10^T = REDFT01 diag(2, 1, ..)
        g = g.clone()
        g[..., 0] *= 2.0
        return dct3(g)

    def adj01(g):                        # REDFT01^T = diag(1/2, 1, ..) REDFT10
        d = dct2(g)
        d[..., 0] *= 0.5
        return d

    return dct2 if kind == "redft10" else dct3
