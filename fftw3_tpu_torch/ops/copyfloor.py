"""E8, the copy floors of K2 and K1 — the port of the TPU measurement script
``experiments/copy_inner.py`` (``make_inner``, ``make_lastaxis``).

Timing-only launches that move split f32 planes through shared memory in a
kernel's own geometry and compute y = 1.0001 * x, with no transform
(``csrc/copy_floor.cu``):

* :func:`copy_inner_cuda`, K2's geometry: (pre, n, L) planes in (n, tl)
  tiles of tl consecutive columns (groups of planes as K2 takes them),
  16-byte loads when the tile is full, the edge tile masked, 4-byte stores
  as K2's last level stores;
* :func:`copy_rows_cuda`, K1's geometry: (rows, n) planes in groups of
  ``stockham.rows_per_block(n)`` whole rows.

The reference races the axis -2 layout at L = 1024 and at L = 1025 (the
masked edge tile of the r2c half spectrum) against the last-axis layout at
matched points; ``chip_smoke.py`` times these arms interleaved with K2 and
K1 at the same shapes.  No user path reaches this module.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import inner
from . import passes
from . import stockham as S

#: launches per arm, (kind "inner" or "rows", shape, tile columns or 0),
#: counted by the wrappers
launches: Dict[Tuple[str, Tuple[int, ...], int], int] = {}


def copy_twin(xr: torch.Tensor, xi: torch.Tensor):
    """What every arm computes, in plain PyTorch."""
    return 1.0001 * xr, 1.0001 * xi


def copy_inner_cuda(xr: torch.Tensor, xi: torch.Tensor,
                    tl: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the inner arm on split (pre, n, L) f32 planes on one
    card, in tiles of `tl` columns (K2's own, ``inner.tile_width``, when
    None).  Returns new (yr, yi); raises on anything the kernel does not
    take, and when the launch fails."""
    passes.check_planes("copy_inner_cuda", xr, xi, xr, 3)
    pre, n, L = xr.shape
    if tl is None:
        tl = inner.tile_width(n, L)
        gp = inner.planes_per_group(n, L, pre)
    else:
        gp = 1
    if tl < 1 or tl & (tl - 1) or n * tl > inner.TILE_POINTS:
        raise ValueError(f"tile of {tl} columns at n={n} is not one K2 takes")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    passes.launch("copy_inner", xr.device, 8 * gp * n * tl,
                  -(-pre // gp) * -(-L // tl),
                  (xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
              pre, n, L, tl, gp), f"E8 inner ({pre}, {n}, {L}), tl={tl}")
    key = ("inner", (pre, n, L), tl)
    launches[key] = launches.get(key, 0) + 1
    return yr, yi


def copy_rows_cuda(xr: torch.Tensor, xi: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the rows arm on split (rows, n) f32 planes on one
    card.  Returns new (yr, yi); raises on anything the kernel does not
    take, and when the launch fails."""
    passes.check_planes("copy_rows_cuda", xr, xi, xr, 2)
    rows, n = xr.shape
    rpb = S.rows_per_block(n)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    passes.launch("copy_rows", xr.device, 8 * (-(-rpb * n // 4) * 4),
                  -(-rows // rpb),
                  (xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
              rows, n, rpb), f"E8 rows ({rows}, {n})")
    key = ("rows", (rows, n), 0)
    launches[key] = launches.get(key, 0) + 1
    return yr, yi
