"""The four-step for n above the single-kernel window (``pallas4``) — the
port of ``build_pallas_c2c_split_fourstep`` in
``fftw3_tpu/ops/pallas_stockham.py``.

n = p*q with (p, q) from ``stockham.choose_fourstep``.  Each row is viewed
as (p, q); then

1. the axis -2 kernel (K2, ``ops/inner.py``) transforms over p;
2. the last-axis kernel (K1) transforms each of the B*p rows over q, with
   the four-step twiddle w[k1, j2] = exp(sign*2*pi*i*k1*j2/n) fused into its
   load (k1 = row mod p);
3. X[k1 + p*k2] now sits at [b, k1, k2]: the (p, q) -> (q, p) swap.  K1
   folds it into its store when p equals the reference's row tile (128);
   otherwise it is one ``transpose(-1, -2).contiguous()``, as the
   reference leaves it to XLA.

No batch padding: both kernels take any number of rows.  The backward is
the same composition with the opposite sign.  On CPU tensors the kernels'
twins run.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import inner, passes
from . import stockham as S

#: the reference's row tile: the transposed store is used when p equals it
#: (the fused store measured a loss at narrower p on the TPU)
ROW_TILE = 128


def build_pallas_c2c_split_fourstep(desc: Dict, sign: int, rdtype,
                                    device: Optional[torch.device] = None):
    """Split apply for ``{"alg": "pallas4", "n": n, "p": p, "q": q}`` on
    any leading batch shape.  ``radices`` pins the q pass's schedule;
    ``tile_b`` stands for the reference's row tile in the fused-store rule."""
    if not S.fourstep_ok(desc):
        raise ValueError(f"pallas4 descriptor {desc} cannot be built")
    if np.dtype(rdtype) != np.float32:
        raise ValueError(f"the Stockham kernels are float32 only, got "
                         f"{np.dtype(rdtype)}")
    n, p, q = desc["n"], desc["p"], desc["q"]
    rad_p = S.choose_radices(p)
    rad_q = list(desc.get("radices") or S.choose_radices(q))
    fstore = p == (desc.get("tile_b") or ROW_TILE)
    kp, kq = (p, tuple(rad_p)), (q, tuple(rad_q))
    if device is not None and torch.device(device).type == "cuda":
        dev = torch.device(device)
        for s in (sign, -sign):                # move the tables once
            S.device_table(*kp, s, dev)
            S.device_table(*kq, s, dev)
            S.device_pretwiddle(p, q, s, dev)

    def run(xr, xi, s):
        if xr.shape[-1] != n or xi.shape != xr.shape:
            raise ValueError(f"plan expects split planes of shape (..., {n}),"
                             f" got {tuple(xr.shape)} and {tuple(xi.shape)}")
        lead = xr.shape[:-1]
        x3r, x3i = xr.reshape(-1, p, q), xi.reshape(-1, p, q)
        B = x3r.shape[0]
        if xr.device.type == "cpu":
            ar, ai = inner.inner_c2c_torch(x3r, x3i, rad_p, s)
            zr, zi = S.stockham_c2c_torch(ar.reshape(B * p, q),
                                          ai.reshape(B * p, q), rad_q, s,
                                          pretwiddle_p=p,
                                          store_transposed=fstore)
        else:
            dev = xr.device
            ar, ai = inner.inner_c2c_cuda(x3r.contiguous(), x3i.contiguous(),
                                          rad_p, S.device_table(*kp, s, dev))
            zr, zi = S.stockham_c2c_cuda(
                ar.reshape(B * p, q), ai.reshape(B * p, q), rad_q,
                S.device_table(*kq, s, dev),
                pretwiddle=S.device_pretwiddle(p, q, s, dev),
                store_transposed=fstore)
        if not fstore:
            # X[k1 + p*k2] at [b, k1, k2] -> k2-major
            zr = zr.reshape(B, p, q).transpose(-1, -2).contiguous()
            zi = zi.reshape(B, p, q).transpose(-1, -2).contiguous()
        return zr.reshape(*lead, n), zi.reshape(*lead, n)

    return passes.differentiable(run, sign)
