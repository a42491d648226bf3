"""E1, the unaligned-row tax — the port of the TPU measurement script
``experiments/copy1000.py`` (``make_arm``, ``_copy_kernel``,
``_trans_kernel``).

Timing-only launches that compute y = 1.0001 * x on one (rows, n) f32
plane (``csrc/unaligned.cu``), raced at n = 1000 against n = 1024 at
matched points (the reference's 16.6e6), to ask whether a row length that
is not a multiple of 32 costs K1's row geometry:

* ``copy``: K1's geometry, ``stockham.rows_per_block(n)`` whole rows a
  group, 16-byte loads where the row start allows it, 4-byte stores;
* ``trans``: tiles of 16 rows in shared memory padded as K1's first level
  pads (``e + (e >> 5)``), read, scaled and written back column by column
  (the counterpart of the reference's (tb, n) -> (n, tb) transposes), then
  stored row by row.

``chip_smoke.py`` times the arms interleaved with K1 at (32768, 1000)
[50, 20] and (32768, 1024) [64, 16].  No user path reaches this module.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import passes
from . import stockham as S

ARMS = ("copy", "trans")
#: rows of one tile of the trans arm (``kTransRows``)
TRANS_ROWS = 16
#: the reference's points per arm
POINTS = 16_600_000

#: launches per (arm, n), counted by :func:`unaligned_cuda`
launches: Dict[Tuple[str, int], int] = {}


def batch(n: int) -> int:
    """The reference's rows at n: ``round(POINTS / n / 128) * 128``."""
    return max(128, int(round(POINTS / n / 128)) * 128)


def unaligned_torch(x: torch.Tensor) -> torch.Tensor:
    """What both arms compute, in plain PyTorch."""
    return 1.0001 * x


def trans_smem(n: int) -> int:
    """Shared-memory bytes of one trans tile: 16 rows of n, padded."""
    e = TRANS_ROWS * n
    return 4 * (e + (e - 1) // 32 + 1)


def unaligned_cuda(x: torch.Tensor, arm: str) -> torch.Tensor:
    """One launch of `arm` on a (rows, n) f32 plane on one card.  Returns a
    new y = 1.0001 * x; raises on anything the kernel does not take, and
    when the launch fails."""
    if arm not in ARMS:
        raise ValueError(f"no E1 arm {arm!r}; the arms are {ARMS}")
    passes.check_planes("unaligned_cuda", x, x, x, 2)
    rows, n = x.shape
    if n < 1 or rows >= 2 ** 31 or rows * n >= 2 ** 31:
        raise ValueError(f"plane {tuple(x.shape)} is not one E1 takes")
    if arm == "trans" and trans_smem(n) > 98304:
        raise ValueError(f"a trans tile at n={n} exceeds the kernel's "
                         f"shared memory")
    y = torch.empty_like(x)
    if rows == 0:
        return y
    what = f"E1 {arm} ({rows}, {n})"
    if arm == "copy":
        rpb = S.rows_per_block(n)
        passes.launch("unaligned_copy", x.device,
                      4 * (-(-rpb * n // 4) * 4), -(-rows // rpb),
                      (x.data_ptr(), y.data_ptr(), rows, n, rpb), what)
    else:
        passes.launch("unaligned_trans", x.device, trans_smem(n),
                      -(-rows // TRANS_ROWS),
                      (x.data_ptr(), y.data_ptr(), rows, n), what)
    launches[arm, n] = launches.get((arm, n), 0) + 1
    return y
