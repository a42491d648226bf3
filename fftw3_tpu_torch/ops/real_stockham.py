"""Real transforms as Stockham kernels (K4, K5, K6) — the port of the r2c and
c2r kernels of ``fftw3_tpu/ops/pallas_stockham.py`` (``_kernel_r2c``,
``_kernel_r2c_inner``, ``_kernel_c2r``, ``build_pallas_r2c``,
``build_pallas_r2c_inner`` and ``build_pallas_c2r``).

With m = n/2 (even n, m inside the c2c kernel window):

* K4 r2c, real (B, n) -> split (B, m+1): ``r2c_torch`` (twin) and
  ``r2c_cuda`` (``csrc/r2c.cu``);
* K5 r2c along axis -2, real (pre, n, L) -> split (pre, m+1, L):
  ``r2c_inner_torch`` and ``r2c_inner_cuda`` (``csrc/r2c_inner.cu``, K2's
  tile with K4's untangle); forward only, as in the reference;
* K6 c2r, split (B, m+1) -> real (B, n): ``c2r_torch`` and ``c2r_cuda``
  (``csrc/c2r.cu``).

The reference computes two real m-point transforms per row and recombines
them without any index reversal (Mosaic has none).  The kernels here reverse
in shared memory, so they take the rdft2 pack of the reference's
``r2c_pack``/``c2r_pack`` solvers instead: one complex m-point transform of
z = x_even + i x_odd, then the untangle (r2c), or the tangle, one inverse
m-point transform and the interleaved store (c2r).  K4 runs that transform
as K1 does (register butterfly levels on ``stockham.level_plan(m,
radices)``, groups of ``stockham.rows_per_block(m)`` rows); K5 runs it as
K2 does, on ``stockham.level_plan(m, radices, tl)`` for tiles of tl
columns (:func:`r2c_inner_tile`), its first level reading the packed rows
from the input; K6 runs it as K4 does, the tangle writing the level buffer
and the last level storing the real rows.  The twins follow the same
form on the shared stage loop (``stockham.stages_torch``, the
descriptor's ``vpu`` picking the butterfly form), so the two agree to
rounding and both agree with the reference's kernels to rounding.

Gradients work on split real planes: K4's backward is the real part of the
sign +1 n-point c2c of the zero-padded cotangent planes, and K6's backward
is the weighted r2c (w = [1, 2, ..., 2, 1], zero imaginary weight at the
DC and Nyquist bins), each planned by the port's planner on the tensors'
device.  A CUDA tensor runs the kernel or raises; only a CPU tensor runs
the twin.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import inner
from . import matrices
from . import passes
from . import real as real_ops
from . import stockham as S

#: launches of the three kernels, counted by their wrappers
r2c_launches = 0
r2c_inner_launches = 0
c2r_launches = 0


# ---------------------------------------------------------------------------
# route gates
# ---------------------------------------------------------------------------

def r2c_applicable(n: int, rdtype, device) -> bool:
    """Gate of K4 and K6: even n whose half-size the c2c kernel takes."""
    return n % 2 == 0 and S.applicable(n // 2, rdtype, device)


def r2c_inner_applicable(n: int, trail: int, rdtype, device) -> bool:
    """Gate of K5: K4's gate plus a trailing-dims product that is a whole
    number of the reference's lane tiles (its TPU value, kept for route
    parity; the kernel masks any edge tile)."""
    return r2c_applicable(n, rdtype, device) and trail % S.INNER_TILE_L == 0


# ---------------------------------------------------------------------------
# host constants
# ---------------------------------------------------------------------------

def _real_table(n: int, radices: Sequence[int], sign: int) -> np.ndarray:
    """The kernels' f32 table: the m-point stage tables of ``sign``
    (``stockham.kernel_table``), then re and im of
    w[k] = exp(sign*2*pi*i*k/n), k = 0..m, from the host in f64."""
    m = n // 2
    w = matrices.roots(n, sign)[:m + 1]
    return np.ascontiguousarray(np.concatenate(
        [S.kernel_table(m, radices, sign), w.real, w.imag]), np.float32)


def table_len(n: int, radices: Sequence[int]) -> int:
    m = n // 2
    return S.table_len(m, radices) + 2 * (m + 1)


@lru_cache(maxsize=None)
def device_table(n: int, radices: Tuple[int, ...], sign: int,
                 device: torch.device) -> torch.Tensor:
    """``_real_table`` as one f32 tensor on `device`, made once."""
    return torch.from_numpy(_real_table(n, radices, sign)).to(device)


@lru_cache(maxsize=None)
def _c2r_weights(n: int, device: torch.device) -> torch.Tensor:
    """(2, n/2+1) f32 weights of K6's backward on `device`: [1, 2, ..., 2,
    1] on the real plane, [0, 2, ..., 2, 0] on the imaginary one (the DC
    and Nyquist bins count once, their imaginary parts not at all)."""
    m = n // 2
    w = np.full((2, m + 1), 2.0, np.float32)
    w[0, [0, m]] = 1.0
    w[1, [0, m]] = 0.0
    return torch.from_numpy(w).to(device)


# ---------------------------------------------------------------------------
# the plain PyTorch twins: the shared stage loop, then the pack's untangle
# or tangle of ``ops/real.py``
# ---------------------------------------------------------------------------

def r2c_torch(x: torch.Tensor, radices: Sequence[int], vpu=None):
    """Plain PyTorch twin of K4: real (..., n) -> split (..., n/2+1)."""
    n = x.shape[-1]
    zr, zi = S.stockham_c2c_torch(x[..., 0::2], x[..., 1::2], radices, -1,
                                  vpu)
    return real_ops.untangle(
        zr, zi, *real_ops._roots_half(n, -1, np.float32, x.device))


def r2c_inner_torch(x: torch.Tensor, radices: Sequence[int], vpu=None):
    """Plain PyTorch twin of K5: real (..., n, L) -> split
    (..., n/2+1, L), the transform along axis -2."""
    n, L = x.shape[-2:]
    m = n // 2
    lead = x.shape[:-2]
    st = torch.stack([x[..., 0::2, :].reshape(-1, m * L),
                      x[..., 1::2, :].reshape(-1, m * L)], 1)
    st = S.stages_torch(st, m, L, radices, -1, vpu)
    wr, wi = real_ops._roots_half(n, -1, np.float32, x.device)
    yr, yi = real_ops.untangle(st[:, 0].reshape(-1, m, L),
                               st[:, 1].reshape(-1, m, L), wr[:, None],
                               wi[:, None], -2)
    return yr.reshape(*lead, m + 1, L), yi.reshape(*lead, m + 1, L)


def c2r_torch(xr: torch.Tensor, xi: torch.Tensor, radices: Sequence[int],
              vpu=None) -> torch.Tensor:
    """Plain PyTorch twin of K6: split (..., n/2+1) -> real (..., n),
    unnormalized (c2r(r2c(x)) = n x)."""
    m = xr.shape[-1] - 1
    zr, zi = real_ops.tangle(
        xr, xi, *real_ops._roots_half(2 * m, +1, np.float32, xr.device))
    yr, yi = S.stockham_c2c_torch(zr, zi, radices, +1, vpu)
    return torch.stack([2.0 * yr, 2.0 * yi], -1).reshape(*xr.shape[:-1],
                                                           2 * m)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _check_schedule(name: str, n: int, radices: Sequence[int],
                    table: torch.Tensor) -> None:
    if n % 2 or not S.radices_ok(n // 2, radices):
        raise ValueError(f"{name}: schedule {list(radices)} does not fit "
                         f"n={n} (an even n with n/2 = its product)")
    if table.numel() != table_len(n, radices):
        raise ValueError(f"{name}: table of {table.numel()} floats does "
                         f"not match n={n}, schedule {list(radices)}")


def r2c_smem(plan: Sequence[int], m: int, rpb: int) -> int:
    """Shared-memory bytes of K4 on the m-point `plan` with `rpb` rows a
    group (``r2c_smem`` in csrc/r2c.cu): the m-point tables and the w
    table, the level buffers, then Z, two planes of rpb rows of m."""
    nbuf, rs, tab_len = plan[1], plan[2], plan[3]
    plane = -(-rpb * rs // 4) * 4
    zplane = -(-rpb * m // 4) * 4
    return 4 * (-(-(tab_len + 2 * (m + 1)) // 4) * 4 + 2 * nbuf * plane
                + 2 * zplane)


def c2r_smem(plan: Sequence[int], m: int, rpb: int) -> int:
    """Shared-memory bytes of K6 on the m-point `plan` with `rpb` rows a
    group (``c2r_smem`` in csrc/c2r.cu): the m-point tables and the v
    table, then the level buffers; the last level stores to the output."""
    nbuf, rs, tab_len = plan[1], plan[2], plan[3]
    plane = -(-rpb * rs // 4) * 4
    return 4 * (-(-(tab_len + 2 * (m + 1)) // 4) * 4 + 2 * nbuf * plane)


def r2c_cuda(x: torch.Tensor, radices: Sequence[int], table: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on real (B, n) f32 rows on one card.  ``table`` is
    ``device_table(n, radices, -1, device)``.  Returns new (yr, yi) of
    shape (B, n/2+1); raises on anything the kernel does not take, and
    when the launch fails."""
    global r2c_launches
    passes.check_planes("r2c_cuda", x, x, table, 2)
    B, n = x.shape
    radices = [int(r) for r in radices]
    _check_schedule("r2c_cuda", n, radices, table)
    if B >= 2 ** 31:
        raise ValueError(f"batch {B} exceeds the kernel's int row count")
    m = n // 2
    yr = x.new_empty((B, m + 1))
    yi = x.new_empty((B, m + 1))
    if B == 0:
        return yr, yi
    if x.data_ptr() % 8:
        x = x.clone()               # the kernel loads sample pairs as float2
    plan = S.level_plan(m, tuple(radices))
    rpb = S.rows_per_block(m)
    passes.launch("r2c", x.device, r2c_smem(plan, m, rpb), -(-B // rpb),
                  (x.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                   table.data_ptr(), S.plan_array(plan), B, n, rpb),
                  f"B={B}, n={n}, radices={radices}")
    r2c_launches += 1
    return yr, yi


def c2r_cuda(xr: torch.Tensor, xi: torch.Tensor, radices: Sequence[int],
             table: torch.Tensor) -> torch.Tensor:
    """Launch K6 on split (B, n/2+1) f32 planes on one card.  ``table`` is
    ``device_table(n, radices, +1, device)`` (n from the schedule: 2 *
    its product).  Returns new real (B, n) rows; raises on anything the
    kernel does not take, and when the launch fails."""
    global c2r_launches
    passes.check_planes("c2r_cuda", xr, xi, table, 2)
    B, h = xr.shape
    radices = [int(r) for r in radices]
    n = 2 * (h - 1)
    _check_schedule("c2r_cuda", n, radices, table)
    if B >= 2 ** 31:
        raise ValueError(f"batch {B} exceeds the kernel's int row count")
    y = xr.new_empty((B, n))
    if B == 0:
        return y
    m = n // 2
    plan = S.level_plan(m, tuple(radices))
    rpb = S.rows_per_block(m)
    passes.launch("c2r", xr.device, c2r_smem(plan, m, rpb), -(-B // rpb),
                  (xr.data_ptr(), xi.data_ptr(), y.data_ptr(),
                   table.data_ptr(), S.plan_array(plan), B, n, rpb),
                  f"B={B}, n={n}, radices={radices}")
    c2r_launches += 1
    return y


#: K5's tile (csrc/r2c_inner.cu): 512 threads of up to 16 points in a
#: level, at most R2C_INNER_TILE packed points m * tl, and its cap on shared
#: memory (under the 232448 bytes a block can opt into, room left for the
#: kernel's static levels)
R2C_INNER_TILE = 8192
R2C_INNER_MAX_SMEM = 230400


def r2c_inner_smem(plan: Sequence[int], m: int, tl: int) -> int:
    """Shared-memory bytes of K5 on the m-point `plan` for tiles of tl
    columns (``r2c_inner_smem`` in csrc/r2c_inner.cu): the m-point tables
    and the w table, the level buffers, then Z, two planes of m * tl."""
    nbuf, rs, tab_len = plan[1], plan[2], plan[3]
    plane = -(-rs // 4) * 4
    zplane = -(-m * tl // 4) * 4
    return 4 * (-(-(tab_len + 2 * (m + 1)) // 4) * 4 + 2 * nbuf * plane
                + 2 * zplane)


def r2c_inner_tile(m: int, L: int, radices: Sequence[int]) -> int:
    """K5's columns per tile: K2's choice for an m-point transform
    (``inner.tile_width``: a power of two, m * tl <= R2C_INNER_TILE), halved
    while the plan's shared memory would pass R2C_INNER_MAX_SMEM (a
    schedule with a dense stage holds two buffers)."""
    tl = inner.tile_width(m, L)
    while tl > 1 and r2c_inner_smem(S.level_plan(m, tuple(radices), tl), m,
                                    tl) > R2C_INNER_MAX_SMEM:
        tl //= 2
    return tl


def r2c_inner_cuda(x: torch.Tensor, radices: Sequence[int],
                   table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on real (pre, n, L) f32 on one card.  ``table`` is
    ``device_table(n, radices, -1, device)``.  Returns new (yr, yi) of
    shape (pre, n/2+1, L); raises on anything the kernel does not take, and
    when the launch fails."""
    global r2c_inner_launches
    passes.check_planes("r2c_inner_cuda", x, x, table, 3)
    pre, n, L = x.shape
    radices = [int(r) for r in radices]
    _check_schedule("r2c_inner_cuda", n, radices, table)
    if pre >= 2 ** 31:
        raise ValueError(f"{pre} leading rows exceed the kernel's int count")
    m = n // 2
    yr = x.new_empty((pre, m + 1, L))
    yi = x.new_empty((pre, m + 1, L))
    if pre == 0 or L == 0:
        return yr, yi
    tl = r2c_inner_tile(m, L, radices)
    plan = S.level_plan(m, tuple(radices), tl)
    passes.launch("r2c_inner", x.device, r2c_inner_smem(plan, m, tl),
                  pre * -(-L // tl),
                  (x.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                   table.data_ptr(), S.plan_array(plan), pre, n, L, tl),
                  f"pre={pre}, n={n}, L={L}, radices={radices}, tl={tl}")
    r2c_inner_launches += 1
    return yr, yi


# ---------------------------------------------------------------------------
# descriptors -> applies
# ---------------------------------------------------------------------------

def _schedule(desc: Dict, rdtype) -> list:
    """The m-point schedule of a real-kernel descriptor, checked."""
    n = desc["n"]
    radices = list(desc.get("radices") or S.choose_radices(n // 2))
    if n % 2 or not S.radices_ok(n // 2, radices):
        raise ValueError(f"{desc['alg']} schedule {radices} does not fit "
                         f"n={n}")
    if np.dtype(rdtype) != np.float32:
        raise ValueError(f"the real Stockham kernels are float32 only, got "
                         f"{np.dtype(rdtype)}")
    return radices


def _planned(kind: str, n: int, rdtype, device: torch.device,
             cache: Dict):
    """The split apply of the port's planned `kind` transform of size n on
    `device` (ESTIMATE, the global planner), built once per device: the
    backward of the real kernels."""
    fn = cache.get(device)
    if fn is None:
        from .. import planner
        from . import c2c as c2c_ops
        pl = planner.the_planner
        if kind == "c2c":
            fn = c2c_ops.build_c2c_split(
                pl.plan_c2c(n, rdtype, 0, device=device), +1, rdtype, device)
        else:
            fn = real_ops.build_r2c_split(
                pl.plan_r2c(n, rdtype, 0, device=device), rdtype, device)
        cache[device] = fn
    return fn


def build_pallas_r2c(desc: Dict, rdtype, device: Optional[torch.device] = None):
    """Split apply for ``{"alg": "pallas_r2c", "n": n, "radices": [...]}``
    (the m-point schedule): real (..., n) -> (yr, yi) of (..., n/2+1), on
    any leading batch shape.  ``vpu`` selects the twin's butterfly stage
    form; on the card the radix alone picks each stage's form
    (``stockham.stage_form``).  ``tile_b`` is accepted and ignored.

    Backward: x̄ = Re DFT_n^{+1}(zero-padded (gr, gi)), the transpose of
    the real map, through the port's planned n-point c2c."""
    n = desc["n"]
    m = n // 2
    radices = _schedule(desc, rdtype)
    vpu = desc.get("vpu")
    key = (n, tuple(radices), -1)
    if device is not None and torch.device(device).type == "cuda":
        device_table(*key, torch.device(device))       # move it once
    adj_cache: Dict = {}

    def fwd(x):
        if x.shape[-1] != n:
            raise ValueError(f"r2c expects real input of shape (..., {n}), "
                             f"got {tuple(x.shape)}")
        if x.device.type == "cpu":
            return r2c_torch(x, radices, vpu)
        lead = x.shape[:-1]
        yr, yi = r2c_cuda(x.reshape(-1, n).contiguous(), radices,
                          device_table(*key, x.device))
        return yr.reshape(*lead, m + 1), yi.reshape(*lead, m + 1)

    def adj(gr, gi):
        c2c = _planned("c2c", n, rdtype, gr.device, adj_cache)
        pad = (0, n - (m + 1))
        dr, _ = c2c(torch.nn.functional.pad(gr, pad),
                    torch.nn.functional.pad(gi, pad))
        return dr

    return lambda x: passes.Adjoint.apply(fwd, adj, x)


def build_pallas_c2r(desc: Dict, rdtype, device: Optional[torch.device] = None):
    """Split apply for ``{"alg": "pallas_c2r", "n": n, "radices": [...]}``:
    (xr, xi) of (..., n/2+1) -> real (..., n), unnormalized, with Im X[0]
    and Im X[n/2] dropped.  ``vpu`` selects the twin's butterfly stage
    form; on the card the radix alone picks each stage's form
    (``stockham.stage_form``).  ``tile_b`` is accepted and ignored.

    Backward: (X̄r, X̄i) = (w Re R(g), w' Im R(g)) with R the port's planned
    r2c, w = [1, 2, ..., 2, 1] and w' = [0, 2, ..., 2, 0]."""
    n = desc["n"]
    m = n // 2
    radices = _schedule(desc, rdtype)
    vpu = desc.get("vpu")
    key = (n, tuple(radices), +1)
    if device is not None and torch.device(device).type == "cuda":
        device_table(*key, torch.device(device))
    adj_cache: Dict = {}

    def fwd(xr, xi):
        if xr.shape[-1] != m + 1 or xi.shape != xr.shape:
            raise ValueError(f"c2r expects split planes of shape (..., "
                             f"{m + 1}), got {tuple(xr.shape)} and "
                             f"{tuple(xi.shape)}")
        if xr.device.type == "cpu":
            return c2r_torch(xr, xi, radices, vpu)
        lead = xr.shape[:-1]
        y = c2r_cuda(xr.reshape(-1, m + 1).contiguous(),
                     xi.reshape(-1, m + 1).contiguous(), radices,
                     device_table(*key, xr.device))
        return y.reshape(*lead, n)

    def adj(g):
        rr, ri = _planned("r2c", n, rdtype, g.device, adj_cache)(g)
        w = _c2r_weights(n, g.device)
        return rr * w[0], ri * w[1]

    return lambda xr, xi: passes.Adjoint.apply(fwd, adj, xr, xi)


def _no_gradient(gr, gi):
    """K5's backward: there is none, as in the reference."""
    raise NotImplementedError(
        "the axis -2 r2c kernel (K5, pallas_r2c_inner) is forward-only, as "
        "the reference's build_pallas_r2c_inner has no VJP: plans built "
        "with config.r2c_swapped = True have no gradient")


def build_pallas_r2c_inner(desc: Dict, rdtype,
                           device: Optional[torch.device] = None):
    """Split apply over axis -2 for a ``pallas_r2c`` descriptor (alg
    ``pallas_r2c_inner`` in a plan): real (..., n, L) -> (yr, yi) of
    (..., n/2+1, L), one kernel pass, no transposes.  Runs the descriptor's
    own schedule (the reference's ``_inner_radices`` re-cap is TPU tuning
    and is not carried over).  Forward only."""
    n = desc["n"]
    m = n // 2
    radices = _schedule(desc, rdtype)
    vpu = desc.get("vpu")
    key = (n, tuple(radices), -1)
    if device is not None and torch.device(device).type == "cuda":
        device_table(*key, torch.device(device))

    def fwd(x):
        if x.dim() < 2 or x.shape[-2] != n:
            raise ValueError(f"axis -2 r2c expects real input of shape "
                             f"(..., {n}, L), got {tuple(x.shape)}")
        if x.device.type == "cpu":
            return r2c_inner_torch(x, radices, vpu)
        shp = x.shape
        yr, yi = r2c_inner_cuda(x.reshape(-1, n, shp[-1]).contiguous(),
                                radices, device_table(*key, x.device))
        out = (*shp[:-2], m + 1, shp[-1])
        return yr.reshape(out), yi.reshape(out)

    return lambda x: passes.Adjoint.apply(fwd, _no_gradient, x)
