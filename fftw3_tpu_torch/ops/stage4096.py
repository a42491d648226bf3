"""E2 and E3, the wide first stage built op by op — the port of the TPU
measurement scripts ``experiments/bisect4096.py`` (``run_case``; the
bodies ``k_identity``, ``k_transpose``, ``k_stage1``, ``k_stage1_tw_perm``)
and ``experiments/bisect4096b.py`` (``run_case``; ``k_stage1`` in the
``highest``, ``ps`` and ``bf16`` forms).

Timing-only launches on split (rows, n) f32 planes (``csrc/stage4096.cu``)
at the reference's two cases, n = 4096 with p = 64 and n = 2048 with
p = 128 (q = n / p).  Each row is the (p, q) matrix X[j1, j2] =
x[j1 * q + j2]; ``G = [[Fr, -Fi], [Fi, Fr]]`` for the p-point DFT F
(``bisect4096.gmat``).  The arms (:data:`ARMS`):

* ``identity``: y = x;
* ``roundtrip``: y = x through two transposes in shared memory;
* ``stage1_f32``: Y = G X with an f32 sum, no twiddle, Y[k1, j2] at
  k1 * q + j2;
* ``stage1_tw_perm``: Y times w[k1, j2] = exp(-2 pi i k1 j2 / n), stored
  autosorted at j2 * p + k1;
* ``stage1_ps``: Gh Xh + (Gh Xl + Gl Xh) on the tensor cores (bf16 hi/lo
  operands, round to nearest even, f32 sum);
* ``stage1_bf16``: Gh bf16(X), one pass (about 2e-3 from float64).

Every arm takes any number of rows; ``rows_per_block`` is swept by
``chip_smoke.py`` over what fits.  No user path reaches this module.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import matrices
from . import passes
from . import stockham as S
from .dense import exact_matmul

ARMS = ("identity", "roundtrip", "stage1_f32", "stage1_tw_perm", "stage1_ps",
        "stage1_bf16")
#: n -> p of the kernel's two cases
CASES = {4096: 64, 2048: 128}
#: shared memory a block may take (``kMaxSmem``)
MAX_SMEM = 232448
#: rows per block the kernel is run at, where they fit
ROWS_PER_BLOCK = (1, 2, 4)
PAD_X = 4

#: launches per (arm, n, rows per block), counted by :func:`stage_cuda`
launches: Dict[Tuple[str, int, int], int] = {}


def _pq(n: int) -> Tuple[int, int]:
    if n not in CASES:
        raise ValueError(f"E2/E3 run n in {sorted(CASES)}, got {n}")
    return CASES[n], n // CASES[n]


# ---------------------------------------------------------------------------
# host constants
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def f_planes(p: int) -> Tuple[np.ndarray, np.ndarray]:
    """(Fr, Fi) of the forward p-point DFT as float32 (``bisect4096.gmat``'s
    blocks, rounded once from float64)."""
    F = matrices.dft_matrix(p, -1)
    return (np.ascontiguousarray(F.real, np.float32),
            np.ascontiguousarray(F.imag, np.float32))


@lru_cache(maxsize=None)
def g_matrix(p: int) -> np.ndarray:
    """The stacked (2p, 2p) float32 G = [[Fr, -Fi], [Fi, Fr]]."""
    fr, fi = f_planes(p)
    return np.block([[fr, -fi], [fi, fr]])


def bf16(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bf16 (nearest even) and back."""
    return a.to(torch.bfloat16).to(torch.float32)


def split_hi_lo(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = bf16(a), lo = bf16(a - hi), both as float32
    (``bisect4096b.gmats`` for G, ``k_stage1``'s Xh, Xl for X)."""
    hi = bf16(a)
    return hi, bf16(a - hi)


@lru_cache(maxsize=None)
def twiddle(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(wr, wi) of w[k1, j2] = exp(-2 pi i k1 j2 / n) as (p, q) float32
    (``bisect4096.twid``)."""
    p, q = _pq(n)
    w = matrices.twiddle_2d(p, q, -1)
    return (np.ascontiguousarray(w.real, np.float32),
            np.ascontiguousarray(w.imag, np.float32))


def mma_fragments(mats) -> np.ndarray:
    """The p x p float32 matrices `mats` rounded to bf16 and laid out as
    ``mma.sync.m16n8k16`` A fragments: for row tile m, column tile k,
    matrix t and lane l, four 32-bit registers of two bf16 each (the first
    in the low half): rows 16m + l/4 (+8), columns 16k + 2(l%4) (+1, +8,
    +9).  Returns int32 words, 4 per (m, k, t, l), in that order."""
    p = mats[0].shape[0]
    T = p // 16
    bits = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            .to(torch.bfloat16).view(torch.int16).numpy().astype(np.uint16)
            for a in mats]
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    # register r of a lane: (row offset, column offset)
    offs = [(0, 0), (8, 0), (0, 8), (8, 8)]
    out = np.empty((T, T, len(mats), 32, 4, 2), np.uint16)
    for m in range(T):
        for k in range(T):
            for t, b in enumerate(bits):
                for r, (dr, dc) in enumerate(offs):
                    rows = 16 * m + gid + dr
                    cols = 16 * k + 2 * tig + dc
                    out[m, k, t, :, r, 0] = b[rows, cols]
                    out[m, k, t, :, r, 1] = b[rows, cols + 1]
    return out.view(np.int32).reshape(-1)


@lru_cache(maxsize=None)
def _host_consts(arm: str, p: int) -> Optional[np.ndarray]:
    """The constants region the kernel copies into shared memory for `arm`
    (as float32-sized words), or None."""
    fr, fi = f_planes(p)
    if arm in ("stage1_f32", "stage1_tw_perm"):
        return np.concatenate([fr.reshape(-1), fi.reshape(-1)])
    if arm == "stage1_ps":
        hi = [split_hi_lo(torch.from_numpy(a)) for a in (fr, fi)]
        mats = [hi[0][0], hi[1][0], hi[0][1], hi[1][1]]   # Frh Fih Frl Fil
        return mma_fragments([m.numpy() for m in mats]).view(np.float32)
    if arm == "stage1_bf16":
        return mma_fragments([fr, fi]).view(np.float32)
    return None


@lru_cache(maxsize=None)
def _device_consts(arm: str, n: int, device: torch.device):
    """(constants, twr, twi) of `arm` at n on `device`, made once."""
    p, _ = _pq(n)
    c = _host_consts(arm, p)
    ct = None if c is None else torch.from_numpy(c.copy()).to(device)
    if arm != "stage1_tw_perm":
        return ct, None, None
    wr, wi = twiddle(n)
    return ct, torch.from_numpy(wr).to(device), torch.from_numpy(wi).to(device)


def smem_bytes(arm: str, n: int, rpb: int) -> int:
    """Shared-memory bytes of `arm` at n with `rpb` rows a block
    (``smem_bytes`` in ``csrc/stage4096.cu``)."""
    p, q = _pq(n)
    c = {"stage1_f32": 2 * p * p, "stage1_tw_perm": 2 * p * p,
         "stage1_ps": 2 * p * p, "stage1_bf16": p * p}.get(arm, 0)
    x = rpb * 2 * p * (q + PAD_X)
    t = rpb * 2 * q * (p + 1) if arm == "roundtrip" else 0
    return 4 * (c + x + t)


def rows_per_block_fit(arm: str, n: int):
    """The values of :data:`ROWS_PER_BLOCK` whose shared memory fits."""
    return [r for r in ROWS_PER_BLOCK if smem_bytes(arm, n, r) <= MAX_SMEM]


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def stage_torch(xr: torch.Tensor, xi: torch.Tensor, arm: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What `arm` computes, in plain PyTorch, on split (rows, n) planes."""
    if arm not in ARMS:
        raise ValueError(f"no E2/E3 arm {arm!r}; the arms are {ARMS}")
    R, n = xr.shape
    p, q = _pq(n)
    if arm in ("identity", "roundtrip"):
        return xr.clone(), xi.clone()
    X = torch.cat([xr.reshape(R, p, q), xi.reshape(R, p, q)], 1)  # (R, 2p, q)
    G = torch.from_numpy(g_matrix(p)).to(xr.device)
    if arm in ("stage1_f32", "stage1_tw_perm"):
        Y = exact_matmul(G, X)
    elif arm == "stage1_ps":
        Gh, Gl = split_hi_lo(G)
        Xh, Xl = split_hi_lo(X)
        Y = exact_matmul(Gh, Xh) + (exact_matmul(Gh, Xl)
                                    + exact_matmul(Gl, Xh))
    else:
        Y = exact_matmul(bf16(G), bf16(X))
    yr, yi = Y[:, :p], Y[:, p:]
    if arm == "stage1_tw_perm":
        wr, wi = (torch.from_numpy(w).to(xr.device) for w in twiddle(n))
        yr, yi = yr * wr - yi * wi, yr * wi + yi * wr
        yr, yi = yr.transpose(1, 2), yi.transpose(1, 2)
    return yr.reshape(R, n).contiguous(), yi.reshape(R, n).contiguous()


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

#: (arm, n, rpb, device index) -> grid that fills the card
_grids: Dict[Tuple[str, int, int, int], int] = {}


def stage_cuda(xr: torch.Tensor, xi: torch.Tensor, arm: str,
               rows_per_block: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of `arm` on split (rows, n) f32 planes on one card, n in
    :data:`CASES`, `rows_per_block` rows a block.  Returns new (yr, yi);
    raises on anything the kernel does not take, and when the launch
    fails."""
    from . import _build
    if arm not in ARMS:
        raise ValueError(f"no E2/E3 arm {arm!r}; the arms are {ARMS}")
    n = xr.shape[-1]
    p, _ = _pq(n)
    rpb = int(rows_per_block)
    smem = smem_bytes(arm, n, rpb)
    if rpb < 1 or smem > MAX_SMEM:
        raise ValueError(f"{rpb} rows a block of {arm} at n={n} need "
                         f"{smem} bytes of shared memory, over {MAX_SMEM}")
    passes.check_planes("stage_cuda", xr, xi, xr, 2)
    R = xr.shape[0]
    if R >= 2 ** 31 // n:
        raise ValueError(f"{R} rows exceed the kernel's int row count")
    if xr.data_ptr() % 16 or xi.data_ptr() % 16:
        raise ValueError("stage_cuda takes 16-byte aligned planes")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if R == 0:
        return yr, yi
    consts, twr, twi = _device_consts(arm, n, xr.device)
    lib = _build.library()
    a = ARMS.index(arm)
    with passes.device_guard(xr.device):
        key = (arm, n, rpb, xr.device.index)
        grid = _grids.get(key)
        if grid is None:
            per_sm = ctypes.c_int(0)
            rc = lib.stage4096_occupancy(a, p, rpb, smem,
                                         ctypes.byref(per_sm))
            if rc != 0:
                raise RuntimeError(f"stage4096 occupancy query failed: CUDA "
                                   f"error {rc} ({arm}, n={n}, rpb={rpb})")
            sms = torch.cuda.get_device_properties(
                xr.device).multi_processor_count
            grid = _grids[key] = sms * max(1, per_sm.value)
        grid = min(grid, -(-R // rpb))
        ptr = (lambda t: None if t is None else t.data_ptr())
        rc = lib.stage4096_launch(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            ptr(consts), ptr(twr), ptr(twi), R, p, a, rpb, grid, smem,
            torch.cuda.current_stream(xr.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stage4096 kernel launch failed: CUDA error {rc} "
                           f"({arm}, ({R}, {n}), rpb={rpb})")
    key = (arm, n, rpb)
    launches[key] = launches.get(key, 0) + 1
    return yr, yi
