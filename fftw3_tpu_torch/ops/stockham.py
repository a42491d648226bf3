"""Batched 1-D c2c as one Stockham kernel — the port of the K1 part of
``fftw3_tpu/ops/pallas_stockham.py``, and the Stockham algorithm the port's
kernels share: schedules, root tables, level plans and the route gates.

The reference runs the whole transform of a tile of rows inside one Pallas
kernel: one or two radix stages, each a p-point complex DFT contraction, a
twiddle and an autosort permute, with one HBM read and one HBM write per
point.  Here the same stage loop exists twice:

* :func:`stockham_c2c_torch`, the plain PyTorch twin, on the stage loop
  :func:`stages_torch` that the twins of the axis -2 and fused 2-D kernels
  (``ops/inner.py``, ``ops/fused2d.py``) share.  It follows ``_stages``
  exactly: the stage contraction is one real (2p, 2p) matmul by the stacked
  matrix G = [[Fr, -Fi], [Fi, Fr]] over the stacked (re, im) planes, or the
  ``_vpu_dft`` butterflies that the descriptor's ``vpu`` key selects, in
  full f32 (the reference's bf16 hi/lo stage arithmetic is a TPU matter and
  is not copied).
* :func:`stockham_c2c_cuda`, the wrapper of the hand-written CUDA kernel in
  ``csrc/stockham_c2c.cu`` (body ``csrc/stockham_rows.cuh``).  The radix
  alone picks each stage's form on the card: a 2-3-5-smooth radix runs as
  register butterflies (``csrc/stockham_bfly.cuh``, the ``_vpu_dft`` form,
  split into register levels of at most 16 points by :func:`bfly_levels`),
  any other radix as the dense p-term sum (``csrc/stockham_stage.cuh``).
  :func:`level_plan` is the host's side of that choice.  The descriptor's
  ``vpu`` key selects the twin's form only, as ``tile_b`` means nothing
  here.  Its two four-step options (pre-twiddle on load, transposed store)
  serve ``ops/fourstep.py``.  A wide form of the same body (512 threads,
  one row a block) takes MAX_N < n <= ROW_MAX_N on the reference's
  all-butterfly schedule (:func:`wide_ok`), the MEASURE-only candidate the
  reference races there.

:func:`build_pallas_c2c_split` turns a ``{"alg": "pallas", ...}`` descriptor
into a pass of the port's pass contract (``ops/passes.py``, which holds the
launch and the layouts every kernel wrapper shares), whose backward is the
same transform with the opposite sign.  A CUDA tensor runs the kernel (or
raises); only a CPU tensor runs the twin.

The route gates of the multi-axis and four-step paths (``INNER_TILE_L``,
``MAX_2D_POINTS``, :func:`inner_applicable`, :func:`applicable_2d`,
:func:`choose_fourstep`, :func:`fourstep_applicable`) live here too, as in
the reference.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..utils import primes
from . import matrices, passes
from .dense import exact_matmul

#: largest stage radix (one p-point DFT contraction per stage)
MAX_RADIX = 256
#: single-stage ceiling of the radix schedule
MAX_SINGLE = 256
#: fused-kernel window of the planner.  Below MIN_N a dense matmul already
#: runs in one pass; above MAX_N a row no longer fits the kernel's
#: shared-memory tile (the reference's window, kept for route parity).
MIN_N = 128
MAX_N = 2048
#: K1's wide form: one row of up to ROW_MAX_N points per block, for the
#: reference's all-butterfly schedule above MAX_N (:func:`wide_ok`; the
#: reference races it under MEASURE at MAX_N < n <= 2 * MAX_N)
ROW_MAX_N = 2 * MAX_N

#: launches of the CUDA kernel, counted by :func:`stockham_c2c_cuda`:
#: plain ones, those with the four-step pre-twiddle, and the wide form's
launches = 0
fourstep_launches = 0
wide_launches = 0


# ---------------------------------------------------------------------------
# radix schedule (the planner's codelet choice)
# ---------------------------------------------------------------------------

# The ranking rule below is the reference's (pallas_stockham._stage_cost and
# _stage2_cost), kept so that both packages emit the same descriptors.  The
# curves were fitted on another device; they are to be fitted again on the
# H100 (ROADMAP), and nothing here claims they describe the card.

def stage_cost(p: int) -> float:
    """Relative cost of the first stage at radix p."""
    return 230.0 / p + p / 9.0


def stage2_cost(q: int) -> float:
    """Relative cost of the second stage at radix q."""
    return 230.0 / q + float(q)


def choose_radices(n: int) -> List[int]:
    """Factor n into a one- or two-stage radix schedule by the ranking rule:
    one stage up to MAX_SINGLE, else the split n = p*q (p >= q, p <=
    MAX_RADIX) of least s1(p) + s2(q), with q < 8 as a last resort."""
    if n <= MAX_SINGLE:
        return [n]
    best = None
    best_cost = None
    for p in sorted(primes.divisors(n), reverse=True):
        q = n // p
        if not (q >= 2 and p >= q and p <= MAX_RADIX):
            continue
        cost = stage_cost(p) + stage2_cost(q)
        if q < 8:
            cost += 1000.0                  # last resort only
        if best is None or cost < best_cost:
            best, best_cost = [p, q], cost
    if best is None:
        raise ValueError(f"{n} has no two-factor schedule with radices "
                         f"<= {MAX_RADIX}")
    return best


def alternative_radices(n: int, k: int = 3) -> List[List[int]]:
    """Up to k alternative schedules for MEASURE-mode timing, ranked by the
    same rule (single-stage when allowed, then the best two-factor splits)."""
    outs: List[List[int]] = []
    if n <= MAX_RADIX:
        outs.append([n])
    pairs = []
    for p in primes.divisors(n):
        q = n // p
        if q >= 8 and p >= q and p <= MAX_RADIX:
            pairs.append((p, q))
    pairs.sort(key=lambda pq: stage_cost(pq[0]) + stage2_cost(pq[1]))
    outs.extend([list(pq) for pq in pairs])
    return outs[:k]


def backend_allows(rdtype, device) -> bool:
    """The n-independent part of the applicability gate: f32 only, and a
    CUDA device unless ``config.kernel_mode`` says otherwise."""
    if config.kernel_mode == "off":
        return False
    if config.kernel_mode == "auto" and torch.device(device).type != "cuda":
        return False
    return np.dtype(rdtype) == np.float32


def applicable(n: int, rdtype, device) -> bool:
    """Planner applicability predicate: f32, inside the kernel window,
    two-stage-factorable n, on a device the kernel mode admits."""
    if not backend_allows(rdtype, device):
        return False
    if n < MIN_N or n > MAX_N:
        return False
    try:
        choose_radices(n)
    except ValueError:
        return False
    return True


# ---------------------------------------------------------------------------
# route gates of the multi-axis and four-step paths
# ---------------------------------------------------------------------------

# These are the reference's gates, value for value, so that the port takes
# the same route for the same problem.  They were derived on a TPU (lane
# tiles of 128, the 16 MB scoped VMEM); the port's kernels take wider
# shapes, and the gates are to be measured again on the card (ROADMAP).

#: lane tile of the reference's axis -2 kernel: a non-last axis goes through
#: K2 when the product of the axes after it reaches one tile
INNER_TILE_L = 128

#: VMEM-resident point budget of the reference's fused 2-D kernel: the
#: trailing axis pair goes through K3 when n1*n2 stays within it
MAX_2D_POINTS = 300_000


def inner_applicable(desc: Dict, trail: int) -> bool:
    """Can the axis -2 kernel serve a transform whose trailing-dims product
    is `trail`?  Any trail of at least one lane tile (the kernel masks the
    edge tile), for a schedule inside MAX_N: K1's wide schedules above it
    take the last-axis route."""
    return (desc.get("alg") == "pallas" and trail >= INNER_TILE_L
            and desc["n"] <= MAX_N)


def applicable_2d(n1: int, n2: int, rdtype, device) -> bool:
    """Can the fused 2-D kernel take the last two transform axes whole?"""
    if not backend_allows(rdtype, device):
        return False
    if n1 % 128 or n2 % 128:
        return False
    if n1 * n2 > MAX_2D_POINTS:
        return False
    try:
        choose_radices(n1), choose_radices(n2)
    except ValueError:
        return False
    return n1 <= MAX_N and n2 <= MAX_N


def choose_fourstep(n: int):
    """(p, q) with p a power of two in [8, 128] and q a 128-multiple in the
    fused-kernel window, the largest such p; None when there is none.  The
    reference's rule (its p | TB row-phase mapping and measured ranking)."""
    best = None
    for p in (8, 16, 32, 64, 128):
        if n % p:
            continue
        q = n // p
        if q % INNER_TILE_L or q < MIN_N or q > MAX_N:
            continue
        try:
            choose_radices(q), choose_radices(p)
        except ValueError:
            continue
        if best is None or p > best[0]:
            best = (p, q)
    return best


def fourstep_applicable(n: int, rdtype, device) -> bool:
    if not backend_allows(rdtype, device):
        return False
    return n > MAX_N and choose_fourstep(n) is not None


def fourstep_ok(desc) -> bool:
    """Can the four-step build this ``pallas4`` descriptor?  p * q = n, the
    p pass a schedule the axis -2 kernel runs, the q pass one K1 runs."""
    n, p, q = desc.get("n"), desc.get("p"), desc.get("q")
    if not all(isinstance(v, int) and v > 1 for v in (n, p, q)) \
            or p * q != n:
        return False
    try:
        rad_p = choose_radices(p)
        rad_q = desc.get("radices") or choose_radices(q)
    except ValueError:
        return False
    return radices_ok(p, rad_p) and radices_ok(q, rad_q)


def radices_ok(n: int, radices) -> bool:
    """Can the kernel run this schedule?  One or two integer radices in
    [2, MAX_RADIX] whose product is n, with n <= MAX_N."""
    return (isinstance(radices, (list, tuple)) and 1 <= len(radices) <= 2
            and all(isinstance(r, int) and 1 < r <= MAX_RADIX
                    for r in radices)
            and math.prod(radices) == n and n <= MAX_N)


def wide_ok(n: int, radices) -> bool:
    """Can K1's wide form run this schedule?  MAX_N < n <= ROW_MAX_N, one
    or two radices whose product is n, every one a butterfly radix of at
    most 64 (:func:`vpu_last_ok`): the reference's all-butterfly MEASURE
    candidate [n/h, h] above MAX_N."""
    return (isinstance(radices, (list, tuple)) and 1 <= len(radices) <= 2
            and all(isinstance(r, int) and r > 1 and vpu_last_ok(r, 1)
                    for r in radices)
            and math.prod(radices) == n and MAX_N < n <= ROW_MAX_N)


def schedule_ok(n: int, radices, vpu=None) -> bool:
    """Can K1 run a ``pallas`` descriptor's schedule?  Inside MAX_N any
    :func:`radices_ok` schedule; above it, up to ROW_MAX_N, a
    :func:`wide_ok` schedule pinned to butterflies everywhere
    (``vpu == "all"``), as the reference offers it."""
    return radices_ok(n, radices) or (vpu == "all" and wide_ok(n, radices))


def vpu_last_ok(p: int, sign: int) -> bool:
    """Gate of the butterfly stage form: radix 2-3-5-smooth and <= 64.
    ``sign`` is the variant channel of :func:`_vpu_sign` (0 = dense form
    everywhere)."""
    return sign != 0 and p <= 64 and stage_form(p) == "bfly"


def _vpu_sign(sign: int, vpu) -> int:
    """0 = dense stages, +-1 = final stage as butterflies (``vpu is True``),
    +-2 = every eligible stage as butterflies (``vpu == "all"``)."""
    if not vpu:
        return 0
    return sign * (2 if vpu == "all" else 1)


# ---------------------------------------------------------------------------
# stage constants (host f64 -> f32)
# ---------------------------------------------------------------------------

def _stage_consts(n: int, radices: Sequence[int], sign: int):
    """Per stage ``[G]`` or ``[G, wr, wi]``: the stacked (2p, 2p) f32 stage
    matrix G = [[Fr, -Fi], [Fi, Fr]] and, when q > 1, the (p, q) twiddle
    w[k1, j2] = exp(sign*2*pi*i*k1*j2/rest).  Built from the root tables the
    kernel reads, and equal bit for bit to the reference's
    ``_stage_consts(..., presplit=False)``."""
    out = []
    rest = n
    for p in radices:
        q = rest // p
        j = np.arange(p, dtype=np.int64)
        F = matrices.roots(p, sign)[np.mod(np.outer(j, j), p)]
        G = np.block([[F.real, -F.imag], [F.imag, F.real]]).astype(np.float32)
        consts = [np.ascontiguousarray(G)]
        if q > 1:
            e = np.mod(np.outer(j, np.arange(q, dtype=np.int64)), rest)
            w = matrices.roots(rest, sign)[e]
            consts += [np.ascontiguousarray(w.real, np.float32),
                       np.ascontiguousarray(w.imag, np.float32)]
        out.append(consts)
        rest = q
    return out


def kernel_table(n: int, radices: Sequence[int], sign: int) -> np.ndarray:
    """The kernel's f32 root tables, stage by stage: re and im of r_p, then
    re and im of r_rest when the stage has a twiddle (layout documented in
    csrc/stockham_c2c.cu)."""
    parts = []
    rest = n
    for p in radices:
        r = matrices.roots(p, sign)
        parts += [r.real, r.imag]
        if rest // p > 1:
            t = matrices.roots(rest, sign)
            parts += [t.real, t.imag]
        rest //= p
    return np.ascontiguousarray(np.concatenate(parts), np.float32)


@lru_cache(maxsize=None)
def _device_consts(n: int, radices: Tuple[int, ...], sign: int,
                   device: torch.device):
    """The twin's stage constants as f32 tensors on `device`, made once."""
    return [[torch.from_numpy(c).to(device) for c in stage]
            for stage in _stage_consts(n, radices, sign)]


@lru_cache(maxsize=None)
def device_table(n: int, radices: Tuple[int, ...], sign: int,
                 device: torch.device) -> torch.Tensor:
    """The kernel's root tables as one f32 tensor on `device`, made once."""
    return torch.from_numpy(kernel_table(n, radices, sign)).to(device)


@lru_cache(maxsize=None)
def device_pretwiddle(p: int, n: int, sign: int,
                      device: torch.device) -> torch.Tensor:
    """The four-step twiddle w[k1, j] = exp(sign*2*pi*i*k1*j/(p*n)) as a
    (2, p, n) f32 tensor (re, im) on `device`, made once: the reference's
    ``_make_call`` pretwiddle constant, bit for bit."""
    w = matrices.twiddle_2d(p, n, sign)
    return torch.from_numpy(np.ascontiguousarray(
        np.stack([w.real, w.imag]), np.float32)).to(device)


# ---------------------------------------------------------------------------
# the plain PyTorch twin
# ---------------------------------------------------------------------------

def _vpu_dft(xr, xi, m: int, sign: int):
    """Butterfly DFT over axis -2 of split (..., m, R) tensors, natural
    output order: the reference's ``_vpu_dft``.  Recursive radix-4
    (radix-2 tail, radix-5 and radix-3 for the 5-smooth part) DIT with the
    level twiddles snapped to +-1/+-i where they are exact."""
    if m == 1:
        return xr, xi
    if m % 4 == 0:
        r = 4
    elif m % 2 == 0:
        r = 2
    elif m % 5 == 0:
        r = 5
    else:
        if m % 3:
            raise ValueError(f"butterfly radix {m} is not 2-3-5-smooth")
        r = 3
    q = m // r
    lead, R = xr.shape[:-2], xr.shape[-1]
    x3r = xr.reshape(*lead, r, q, R)
    x3i = xi.reshape(*lead, r, q, R)
    xs = [(x3r[..., j, :, :], x3i[..., j, :, :]) for j in range(r)]
    if r == 2:
        br = [xs[0][0] + xs[1][0], xs[0][0] - xs[1][0]]
        bi = [xs[0][1] + xs[1][1], xs[0][1] - xs[1][1]]
    elif r == 3:
        S3 = float(np.float32(np.sqrt(3.0) / 2.0))
        t1r, t1i = xs[1][0] + xs[2][0], xs[1][1] + xs[2][1]
        t3r, t3i = xs[1][0] - xs[2][0], xs[1][1] - xs[2][1]
        ur, ui = xs[0][0] - 0.5 * t1r, xs[0][1] - 0.5 * t1i
        vr_, vi_ = S3 * t3r, S3 * t3i
        if sign < 0:
            br = [xs[0][0] + t1r, ur + vi_, ur - vi_]
            bi = [xs[0][1] + t1i, ui - vr_, ui + vr_]
        else:
            br = [xs[0][0] + t1r, ur - vi_, ur + vi_]
            bi = [xs[0][1] + t1i, ui + vr_, ui - vr_]
    elif r == 5:
        C1 = float(np.float32(np.cos(2 * np.pi / 5)))
        S1 = float(np.float32(np.sin(2 * np.pi / 5)))
        C2 = float(np.float32(np.cos(4 * np.pi / 5)))
        S2 = float(np.float32(np.sin(4 * np.pi / 5)))
        (x0r, x0i), (x1r, x1i), (x2r, x2i), (x3r_, x3i_), (x4r, x4i) = xs
        t1r, t1i = x1r + x4r, x1i + x4i
        t2r, t2i = x2r + x3r_, x2i + x3i_
        t3r, t3i = x1r - x4r, x1i - x4i
        t4r, t4i = x2r - x3r_, x2i - x3i_
        u1r = x0r + C1 * t1r + C2 * t2r
        u1i = x0i + C1 * t1i + C2 * t2i
        u2r = x0r + C2 * t1r + C1 * t2r
        u2i = x0i + C2 * t1i + C1 * t2i
        v1r = S1 * t3r + S2 * t4r
        v1i = S1 * t3i + S2 * t4i
        v2r = S2 * t3r - S1 * t4r
        v2i = S2 * t3i - S1 * t4i
        if sign < 0:
            br = [x0r + t1r + t2r, u1r + v1i, u2r + v2i, u2r - v2i, u1r - v1i]
            bi = [x0i + t1i + t2i, u1i - v1r, u2i - v2r, u2i + v2r, u1i + v1r]
        else:
            br = [x0r + t1r + t2r, u1r - v1i, u2r - v2i, u2r + v2i, u1r + v1i]
            bi = [x0i + t1i + t2i, u1i + v1r, u2i + v2r, u2i - v2r, u1i - v1r]
    else:
        (x0r, x0i), (x1r, x1i), (x2r, x2i), (x3r_, x3i_) = xs
        t0r, t0i = x0r + x2r, x0i + x2i
        t1r, t1i = x0r - x2r, x0i - x2i
        t2r, t2i = x1r + x3r_, x1i + x3i_
        t3r, t3i = x1r - x3r_, x1i - x3i_
        if sign < 0:               # omega_4 = -i
            u3r, u3i = t3i, -t3r
        else:                      # omega_4 = +i
            u3r, u3i = -t3i, t3r
        br = [t0r + t2r, t1r + u3r, t0r - t2r, t1r - u3r]
        bi = [t0i + t2i, t1i + u3i, t0i - t2i, t1i - u3i]
    if q > 1:
        # level twiddle w = omega_m^{j2*k1} per row j2, snapped to +-1/+-i
        # where exact (then the multiply is exact too)
        for k1 in range(1, r):
            w = np.exp(sign * 2j * np.pi * ((np.arange(q) * k1) % m) / m)
            for exact in (1, -1, 1j, -1j):
                w[np.abs(w - exact) < 1e-12] = exact
            wr = torch.tensor(w.real.astype(np.float32), dtype=xr.dtype,
                              device=xr.device)[:, None]
            wi = torch.tensor(w.imag.astype(np.float32), dtype=xr.dtype,
                              device=xr.device)[:, None]
            br[k1], bi[k1] = (br[k1] * wr - bi[k1] * wi,
                              br[k1] * wi + bi[k1] * wr)
    zs = [_vpu_dft(br[k1], bi[k1], q, sign) for k1 in range(r)]
    # X[k1 + r*k2] sits at child k1, row k2: stack k1 minor under k2
    yr = torch.stack([z[0] for z in zs], dim=-2).reshape(*lead, m, R)
    yi = torch.stack([z[1] for z in zs], dim=-2).reshape(*lead, m, R)
    return yr, yi


def stages_torch(st: torch.Tensor, n: int, L: int, radices: Sequence[int],
                 sign: int, vpu=None) -> torch.Tensor:
    """The stage loop of the twins on stacked planes ``st`` of shape
    (B, 2, n*L): point i of column l at i*L + l, transformed along the n
    points of every column (L = 1 is the last-axis form).  Stage by stage as
    the reference's ``_stages`` orders it, with L in the place of its
    lane tile."""
    consts = _device_consts(n, tuple(radices), sign, st.device)
    B = st.shape[0]
    vsign = _vpu_sign(sign, vpu)
    vpu_all = abs(vsign) == 2
    done, rest = 1, n
    for p, c in zip(radices, consts):
        q = rest // p
        M = q * done * L
        if vpu_last_ok(p, vsign) and (q == 1 or vpu_all):
            x = st.reshape(B, 2, p, M)
            yr, yi = _vpu_dft(x[:, 0], x[:, 1], p, sign)
            y = torch.stack([yr, yi], 1)
        else:
            # the complex contraction over j1 as one real matmul by G
            y = exact_matmul(c[0], st.reshape(B, 2 * p, M))
        if q > 1:
            wr = c[1][:, :, None]
            wi = c[2][:, :, None]
            y = y.reshape(B, 2, p, q, done * L)
            tr = y[:, 0] * wr - y[:, 1] * wi
            ti = y[:, 0] * wi + y[:, 1] * wr
            # (p, q, done) -> (q, p, done): the autosort permute
            st = torch.stack([tr, ti], 1).transpose(2, 3).reshape(B, 2, n * L)
        else:
            st = y.reshape(B, 2, n * L)
        done *= p
        rest = q
    return st


def stockham_c2c_torch(xr: torch.Tensor, xi: torch.Tensor,
                       radices: Sequence[int], sign: int, vpu=None,
                       pretwiddle_p: int = 0, store_transposed: bool = False):
    """Plain PyTorch twin of the kernel: unnormalized c2c along the last
    axis of split f32 planes of any leading shape, stage by stage as the
    reference's ``_stages`` orders it.

    The four-step options, as the kernel has them: ``pretwiddle_p`` = P
    multiplies row r (of the rows flattened to (R, n)) by w[r mod P, j] =
    exp(sign*2*pi*i*(r mod P)*j/(P*n)) before the stages;
    ``store_transposed`` (with P) returns (R/P, n, P) planes holding row
    b*P + k1's point k2 at [b, k2, k1]."""
    n = xr.shape[-1]
    if math.prod(radices) != n:
        raise ValueError(f"radices {list(radices)} do not multiply to {n}")
    if store_transposed and not pretwiddle_p:
        raise ValueError("store_transposed needs pretwiddle_p")
    shp = xr.shape[:-1]
    xr2, xi2 = xr.reshape(-1, n), xi.reshape(-1, n)
    R = xr2.shape[0]
    P = pretwiddle_p
    if P:
        if R % P:
            raise ValueError(f"{R} rows are not whole groups of {P}")
        w = device_pretwiddle(P, n, sign, xr.device)
        x3r, x3i = xr2.reshape(-1, P, n), xi2.reshape(-1, P, n)
        xr2 = (x3r * w[0] - x3i * w[1]).reshape(R, n)
        xi2 = (x3r * w[1] + x3i * w[0]).reshape(R, n)
    st = stages_torch(torch.stack([xr2, xi2], 1), n, 1, radices, sign, vpu)
    if store_transposed:
        st = st.reshape(R // P, P, 2, n).permute(2, 0, 3, 1)
        return st[0].contiguous(), st[1].contiguous()
    return st[:, 0].reshape(*shp, n), st[:, 1].reshape(*shp, n)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def stockham_c2c_cuda(xr: torch.Tensor, xi: Optional[torch.Tensor],
                      radices: Sequence[int], table: torch.Tensor,
                      pretwiddle: Optional[torch.Tensor] = None,
                      store_transposed: bool = False,
                      complex_out: bool = False):
    """Launch the CUDA kernel on split (B, n) f32 planes on one card, or
    with `xi` None on one (B, n) complex64 tensor `xr` read interleaved.
    ``table`` is ``device_table(n, radices, sign, device)``: the sign lives
    in it.  The four-step options (planes only): ``pretwiddle`` is
    ``device_pretwiddle(P, n, sign, device)``, multiplied into row r by
    its row r mod P on load; ``store_transposed`` (with ``pretwiddle``)
    returns (B/P, n, P) planes, row b*P + k1's point k2 at [b, k2, k1].
    Returns new (yr, yi), or with `complex_out` one new complex64 tensor
    written interleaved; raises on anything the kernel does not take, and
    when the launch fails."""
    global launches, fourstep_launches, wide_launches
    passes.check_planes("stockham_c2c_cuda", xr, xi, table, 2)
    B, n = xr.shape
    radices = [int(r) for r in radices]
    wide = n > MAX_N
    if not (wide_ok(n, radices) if wide else radices_ok(n, radices)):
        raise ValueError(f"kernel schedule {radices} does not fit n={n}")
    if table.numel() != table_len(n, radices):
        raise ValueError(f"root table of {table.numel()} floats does not "
                         f"match schedule {radices}")
    if B >= 2 ** 31:
        raise ValueError(f"batch {B} exceeds the kernel's int row count")
    P = 0
    if pretwiddle is not None:
        P = pretwiddle.shape[1] if pretwiddle.dim() == 3 else 0
        if (pretwiddle.shape != (2, P, n) or P < 1
                or pretwiddle.device != xr.device
                or pretwiddle.dtype != torch.float32
                or not pretwiddle.is_contiguous()):
            raise ValueError(f"pretwiddle must be a contiguous float32 "
                             f"(2, P, {n}) tensor on {xr.device}, got "
                             f"{tuple(pretwiddle.shape)}")
    if wide and P:
        raise ValueError(f"the wide form (n={n}) has no pre-twiddle")
    if store_transposed and not P:
        raise ValueError("store_transposed needs a pretwiddle")
    if store_transposed and B % P:
        raise ValueError(f"{B} rows are not whole groups of {P}")
    layout = passes.layout_of(xi, complex_out)
    if P and layout:
        raise ValueError("the four-step options take split planes only")
    shape = (B // P, n, P) if store_transposed else (B, n)
    y = passes.new_output(shape, xr.device, complex_out)
    if B == 0:
        return y[0] if complex_out else y
    plan = level_plan(n, tuple(radices))
    rpb = rows_per_block(n)
    passes.launch("stockham_c2c_wide" if wide else "stockham_c2c", xr.device,
                  plan_smem(plan, rpb), -(-B // rpb),
                  (*passes.pointers(xr, xi), *passes.pointers(*y),
                   table.data_ptr(), plan_array(plan), B, n, rpb,
                   pretwiddle.data_ptr() if P else None, P,
                   P if store_transposed else 0, layout),
                  f"n={n}, radices={radices}, B={B}, pretwiddle {P}, "
                  f"transposed {store_transposed}, layout {layout}")
    if P:
        fourstep_launches += 1
    elif wide:
        wide_launches += 1
    else:
        launches += 1
    return y[0] if complex_out else y


def table_len(n: int, radices: Sequence[int]) -> int:
    """Floats of the root tables of `radices` (:func:`kernel_table`)."""
    total, rest = 0, n
    for p in radices:
        total += 2 * p + (2 * rest if rest // p > 1 else 0)
        rest //= p
    return total


# ---------------------------------------------------------------------------
# the stage form on the card: butterfly levels or the dense sum
# ---------------------------------------------------------------------------

#: radices of one register level (``csrc/stockham_bfly.cuh`` instantiates
#: exactly these); a 2-3-5-smooth stage radix is a product of them
LEVEL_RADICES = (16, 8, 5, 4, 3, 2)
#: points per group of rows in K1 (``kRowPts * kRowThreads`` in
#: ``csrc/stockham_rows.cuh``; the wide form takes one row of up to
#: ROW_MAX_N = ``kRowPts * kWideThreads``)
ROW_TILE_POINTS = 2048
#: levels a plan holds (``kMaxLevels``)
MAX_LEVELS = 8


def stage_form(p: int) -> str:
    """``"bfly"`` for a 2-3-5-smooth radix (register butterflies), else
    ``"dense"`` (the p-term sum): the radix alone picks the form."""
    m = p
    for f in (2, 3, 5):
        while m % f == 0:
            m //= f
    return "bfly" if m == 1 else "dense"


@lru_cache(maxsize=None)
def bfly_levels(p: int) -> Tuple[int, ...]:
    """Register levels of a 2-3-5-smooth radix p: the fewest factors from
    LEVEL_RADICES, then the smallest largest factor, largest first (64 ->
    (8, 8), 128 -> (16, 8), 50 -> (5, 5, 2))."""
    if p == 1:
        return ()
    best = None
    for r in LEVEL_RADICES:
        if p % r == 0 and stage_form(p // r) == "bfly":
            rest = bfly_levels(p // r)
            cand = tuple(sorted((r,) + rest, reverse=True))
            if best is None or (len(cand), cand[0]) < (len(best), best[0]):
                best = cand
    if best is None:
        raise ValueError(f"radix {p} is not 2-3-5-smooth")
    return best


def rows_per_block(n: int) -> int:
    """Rows of one group of K1 (and of K4's m-point rows): as many whole
    rows as ROW_TILE_POINTS holds, one above it (K1's wide form)."""
    return max(1, ROW_TILE_POINTS // n)


@lru_cache(maxsize=None)
def level_plan(n: int, radices: Tuple[int, ...], tl: int = 1
               ) -> Tuple[int, ...]:
    """The kernel's level plan for schedule `radices` over tiles of n
    points by tl columns (``LevelPlan`` in ``csrc/stockham_bfly.cuh``):
    a header (levels, buffers, row stride of a buffer plane in floats,
    root-table floats) and 8 ints per level (kind: 0 dense or the butterfly
    radix; radix, done, rest; table offsets a and b; table length; the pad
    of the buffer the level writes).

    A butterfly level of stage (p, done, rest) reads its roots from the
    stage's r_rest (r_p when q == 1), of length rest, at strides.  A level
    that writes shared memory pads it as ``e + pad * (e >> 5)`` with
    pad = min(done*tl, 32 // r), which spreads a warp's stores (runs of
    done*tl words, r*done*tl apart) over the 32 banks; with done*tl >= 32 a
    warp's stores are one run and need no pad.  A dense stage reads and writes
    unpadded buffers out of place, so a schedule with one has no pads and
    two buffers."""
    dense = any(stage_form(p) == "dense" for p in radices)
    levels = []
    off, done, rest = 0, 1, n
    for p in radices:
        q = rest // p
        off_tw = off + 2 * p
        if stage_form(p) == "dense":
            levels.append([0, p, done, rest, off, off_tw if q > 1 else 0, 0,
                           0])
        else:
            t_off = off_tw if q > 1 else off
            sub_done, sub_rest = done, rest
            for r in bfly_levels(p):
                w = sub_done * tl
                pad = 0 if dense or w >= 32 else min(w, 32 // r)
                levels.append([r, r, sub_done, sub_rest, t_off, 0, rest, pad])
                sub_done *= r
                sub_rest //= r
        off = off_tw + (2 * rest if q > 1 else 0)
        done *= p
        rest = q
    levels[-1][7] = 0
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"schedule {list(radices)} needs {len(levels)} "
                         f"levels, over {MAX_LEVELS}")
    m = n * tl
    smax = max(lv[7] for lv in levels)
    rs = m if smax == 0 else -(-(m + smax * ((m - 1) >> 5)) // 4) * 4
    head = [len(levels), 2 if dense else 1, rs, table_len(n, radices)]
    return tuple(head + [v for lv in levels for v in lv])


def form_label(radices: Sequence[int]) -> str:
    """Each stage's form on the card, e.g. ``"bfly 64=8x8, bfly 16"``."""
    return ", ".join(
        f"dense {p}" if stage_form(p) == "dense" else
        f"bfly {p}" + ("" if len(bfly_levels(p)) == 1 else
                       "=" + "x".join(map(str, bfly_levels(p))))
        for p in radices)


def plan_smem(plan: Sequence[int], rows: int) -> int:
    """Shared-memory bytes of K1 on `plan` with `rows` rows per group, and
    of K2 with `rows` planes per group (``plan_smem`` in
    ``csrc/stockham_bfly.cuh``): the root tables, then one buffer (two with
    a dense stage) of two planes of `rows` transforms at the plan's row
    stride."""
    nbuf, rs, tab_len = plan[1], plan[2], plan[3]
    plane = -(-rows * rs // 4) * 4
    return 4 * (-(-tab_len // 4) * 4 + 2 * nbuf * plane)


def plan_array(plan: Sequence[int]):
    """The plan as a C int array for a launch."""
    return (ctypes.c_int * len(plan))(*plan)


# ---------------------------------------------------------------------------
# descriptor -> pass
# ---------------------------------------------------------------------------

def build_pallas_c2c_split(desc: Dict, sign: int, rdtype,
                           device: Optional[torch.device] = None):
    """The pass (``ops/passes.py``) of ``{"alg": "pallas", "n": n,
    "radices": [...]}`` on any leading batch shape, ragged batches included
    (each CUDA block takes whole rows, so nothing is padded); K1 reads and
    writes both layouts itself.

    ``vpu`` selects the twin's butterfly stage form; on the card the radix
    alone picks each stage's form (:func:`stage_form`).  Above MAX_N only a
    ``vpu: "all"`` schedule runs, on K1's wide form (:func:`schedule_ok`).
    ``tile_b`` is the reference's batch-lane tile and means nothing here: it
    is accepted and ignored."""
    n = desc["n"]
    vpu = desc.get("vpu")
    radices = list(desc.get("radices") or choose_radices(n))
    if not schedule_ok(n, radices, vpu):
        raise ValueError(f"pallas schedule {radices} does not fit n={n}")
    key = (n, tuple(radices))
    return passes.kernel_pass(
        (n,), sign, rdtype, device,
        lambda s, dev: device_table(*key, s, dev),
        lambda xr, xi, s: stockham_c2c_torch(xr, xi, radices, s, vpu),
        lambda xr, xi, table, cout: stockham_c2c_cuda(
            xr, xi, radices, table, complex_out=cout),
        reads=True, writes=True)
