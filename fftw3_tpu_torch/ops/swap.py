"""E7, the four-step's swap — the port of the TPU measurement script
``experiments/race4096.py`` (``make_pallas_transpose``, block 2; block 1's
four-step arms).

The ``pallas4`` route (``ops/fourstep.py``) ends with the swap
(B, p, q) -> (B, q, p) of both planes: two ``transpose(-1, -2)
.contiguous()`` copies unless K1 folds it into its store, which it does
only at the reference's p = 128.  Block 2 races three ways of paying it at
(2048, 32, 128):

* ``palT``: :func:`swap_cuda` (``csrc/swap.cu``), the swap as a kernel of
  its own;
* ``xlaT``: :func:`swap_torch`, what ``ops/fourstep.py`` pays (and the
  kernel's twin);
* ``noT``: the bare reshape, a view: no work on the card.

Block 1 pins ``pallas4`` at n = 4096 to each of :data:`FOURSTEP_ARMS`,
each also with K1's fused transposed store (the descriptor with
``tile_b = p``, which the four-step reads as the reference's row tile).
No user path reaches :func:`swap_cuda`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import passes
from . import stockham as S

#: the measurement's shape: B matrices of (p, q) at n = 4096
BATCH, P, Q = 2048, 32, 128

#: block 1's four-step arms at n = 4096 (the reference's tb512 control,
#: tb512r168, p16tb512, p8tb512; its tile_b and inner_area arms are the
#: control here: tile_b is read only by the fused-store rule and
#: inner_area is stripped)
FOURSTEP_ARMS = {
    "control": {"alg": "pallas4", "n": 4096, "p": 32, "q": 128},
    "radices [16, 8]": {"alg": "pallas4", "n": 4096, "p": 32, "q": 128,
                        "radices": [16, 8]},
    "p16": {"alg": "pallas4", "n": 4096, "p": 16, "q": 256},
    "p8": {"alg": "pallas4", "n": 4096, "p": 8, "q": 512},
}


def fused(desc: Dict) -> Dict:
    """`desc` with K1's fused transposed store (``tile_b = p``)."""
    return {**desc, "tile_b": desc["p"]}


#: launches per (batch, p, q), counted by :func:`swap_cuda`
launches: Dict[Tuple[int, int, int], int] = {}


def swap_torch(xr: torch.Tensor, xi: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The swap in plain PyTorch, as ``ops/fourstep.py`` pays it."""
    return (xr.transpose(-1, -2).contiguous(),
            xi.transpose(-1, -2).contiguous())


def swap_cuda(xr: torch.Tensor, xi: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the swap on split (B, p, q) f32 planes on one card,
    q % 4 == 0.  Returns new (B, q, p) planes; raises on anything the
    kernel does not take, and when the launch fails."""
    p, q = xr.shape[-2:] if xr.dim() >= 2 else (0, 0)
    smem = 8 * p * (q + 4)
    if q % 4 or smem > 98304:
        raise ValueError(f"swap takes q % 4 == 0 and 8*p*(q+4) <= 98304 "
                         f"bytes, got {tuple(xr.shape)}")
    passes.check_planes("swap_cuda", xr, xi, xr, 3)
    B = xr.shape[0]
    if xr.data_ptr() % 16 or xi.data_ptr() % 16:
        raise ValueError("swap_cuda takes 16-byte aligned planes")
    if B * p * q >= 2 ** 31:
        raise ValueError(f"{B} matrices exceed the kernel's int indices")
    yr = torch.empty((B, q, p), dtype=xr.dtype, device=xr.device)
    yi = torch.empty_like(yr)
    if B == 0:
        return yr, yi
    passes.launch("swap", xr.device, smem, B,
                  (xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                   B, p, q), f"E7 swap ({B}, {p}, {q})")
    launches[B, p, q] = launches.get((B, p, q), 0) + 1
    return yr, yi
