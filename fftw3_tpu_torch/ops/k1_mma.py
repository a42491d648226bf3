"""E4, E6, E9, E10, E11 and E12 — K1's matmul stage form on the tensor
cores, the port of the TPU measurement scripts
``experiments/kernel_variants.py`` (E4), ``stacked_kernel.py`` (E6),
``mono_stage.py`` (E9), ``headline_gap.py`` (E10), ``presplit_g.py`` (E11)
and ``precision_variants.py`` (E12).

Every arm computes one thing: the forward n = 1024 c2c on split (B, 1024)
f32 planes by the two-stage Stockham schedule [p, q] of the reference's
``_stages``, each stage's complex product in bf16 hi/lo (hi = RNE bf16(v),
lo = bf16(v - hi), hh + (hl + lh), lo * lo dropped).  The arms differ in the
reference's axes (:data:`ARMS`): the product form (the stacked G [Xr; Xi]
or E4's Karatsuba triple), where G is split (in the kernel or on the host),
the grouping of the three passes per stage (``three``, ``fused``, ``mono``,
``noxl``), the inter-stage buffer (f32 or bf16 halves), E12's block-diagonal
packing, E10's repeat count and E4's four diagnostic arms, which compute
the reference's wrong numbers on purpose.

* :func:`k1_mma_torch`, the plain twin: the same arithmetic in PyTorch,
  bf16 through ``Tensor.to(torch.bfloat16)`` and every product through
  ``dense.exact_matmul`` on bf16-valued f32 operands, so each product is
  exact and only the f32 sums differ from the kernel's order.  The bf16
  buffer holds the halves of what the f32 buffer holds, so its twin is the
  f32 one.  Used by the tests and ``chip_smoke.py``; no user path.
* :func:`k1_mma_cuda`, the wrapper of the hand-written kernel family in
  ``csrc/k1_mma.cuh``, instantiated by ``csrc/k1_mma_karatsuba.cu``,
  ``k1_mma_stacked64.cu`` and ``k1_mma_stacked.cu`` (``mma.sync.m16n8k16``
  bf16, f32 sums), with :data:`launches`.
* :func:`k1_inplace_cuda`, E10's ``donate`` arm: the port's butterfly K1
  with the outputs on the inputs, through the in-place form of
  ``csrc/stockham_c2c.cu`` (K1's body, ``csrc/stockham_rows.cuh``, with
  planes that are neither ``__restrict__`` nor read through the read-only
  path).  Every block reads all rows of its group in K1's first level
  before the synchronisation that precedes its last level's stores, and no
  two blocks share a row (``stockham_bfly.run_levels``), so y = x is no
  race.

E4's other variants are the control and have no arm: ``tw="lanes"`` and
``"flat"`` replicate the twiddle across the TPU's 128 lanes, where the card
reads one (p, q) table either way; ``tb256`` is the TPU's row tile and
``vmem100`` its scoped-VMEM limit, neither of which has a counterpart here.

Two arms read the reference's code where a one-line summary of it would
differ: ``_stages``' presplit branch fuses the cross pass on every stage
within ``K2_MAX_BYTES`` whatever ``k2mode`` says
(``fftw3_tpu/ops/pallas_stockham.py:574-577``), so E10's shipping stages
run fused on both stages; and ``build_pallas_c2c_split`` builds presplit G
by default (``config.pallas_presplit_g``), so E11's ``prod_k2first`` is the
in-kernel split only with ``"gsplit": False``, the form this arm takes (the
default build equals ``e11_presplit_k2s2``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import matrices
from . import passes
from . import stockham as S
from .dense import exact_matmul
from .stage4096 import bf16, f_planes, g_matrix, mma_fragments, split_hi_lo

N = 1024
#: rows per block the kernel is run at, where they fit
ROWS_PER_BLOCK = (2, 4, 8)
#: shared memory a block may take (``kMaxSmem``)
MAX_SMEM = 232448
PAD = 4


@dataclass(frozen=True)
class Arm:
    """One arm: the reference function it replaces (``replaces``), the
    schedule [p, q], the product form, where G is split, the pass grouping
    of each stage, the inter-stage buffer, block-diagonal packing, the
    diagnostic, the repeat count, and the instantiation that runs it."""
    replaces: str
    radices: Tuple[int, int]
    source: str
    variant: int
    form: str = "stacked"
    host_split: bool = False
    groups: Tuple[str, str] = ("fused", "fused")
    buffer: str = "f32"
    pack: bool = False
    diag: Optional[str] = None
    reps: int = 1


_E4 = "experiments/kernel_variants.py:187"
_E6 = "experiments/stacked_kernel.py:121"
_E9 = "experiments/mono_stage.py:118"
_E10 = "experiments/headline_gap.py:82"
_E11 = "experiments/presplit_g.py:163"
_E12 = "experiments/precision_variants.py:147"


def _karatsuba(variant, groups=("three", "three"), diag=None, host=False):
    return Arm(_E4, (32, 32), "k1_mma_karatsuba", variant, form="karatsuba",
               host_split=host, groups=groups, diag=diag)


def _s64(ref, variant, groups=("fused", "fused"), host=False, **kw):
    return Arm(ref, (64, 16), "k1_mma_stacked64", variant, host_split=host,
               groups=groups, **kw)


#: every arm, by name
ARMS: Dict[str, Arm] = {
    "e4_baseline": _karatsuba(0),
    "e4_fsplit": _karatsuba(0, host=True),
    "e4_k2": _karatsuba(1, groups=("fused", "fused")),
    "e4_diag_copy": _karatsuba(2, diag="copy"),
    "e4_diag_notw": _karatsuba(3, diag="notw"),
    "e4_diag_noperm": _karatsuba(4, diag="noperm"),
    "e4_diag_noperm_notw": _karatsuba(5, diag="noperm_notw"),
    "e6_stacked": _s64(_E6, 0),
    "e9_mono": _s64(_E9, 1, ("mono", "mono"), host=True),
    "e9_mono_bf16perm": _s64(_E9, 2, ("mono", "mono"), host=True,
                             buffer="bf16"),
    **{f"e10_rep{r}": Arm(_E10, (32, 32), "k1_mma_stacked", 0,
                          host_split=True, reps=r) for r in (1, 3, 5)},
    "e11_presplit_k2s2": _s64(_E11, 0, host=True),
    "e11_presplit_k2first": _s64(_E11, 3, ("fused", "three"), host=True),
    "e11_prod_k2first": _s64(_E11, 3, ("fused", "three")),
    "e12_prod_64x16": _s64(_E12, 0),
    "e12_prod_32x32": Arm(_E12, (32, 32), "k1_mma_stacked", 0),
    "e12_prod_128x8": Arm(_E12, (128, 8), "k1_mma_stacked", 2),
    "e12_blockdiag_64x16": _s64(_E12, 5, pack=True),
    "e12_blockdiag_32x32": Arm(_E12, (32, 32), "k1_mma_stacked", 1,
                               pack=True),
    "e12_blockdiag_128x8": Arm(_E12, (128, 8), "k1_mma_stacked", 3,
                               pack=True),
    "e12_noxl": _s64(_E12, 4, ("noxl", "noxl")),
}

#: launches per arm, counted by :func:`k1_mma_cuda`
launches: Dict[str, int] = {}
#: launches of K1 in place (:func:`k1_inplace_cuda`)
inplace_launches = 0


def arm(name: str) -> Arm:
    if name not in ARMS:
        raise ValueError(f"no E4/E6/E9-E12 arm {name!r}; the arms are "
                         f"{sorted(ARMS)}")
    return ARMS[name]


def notw(a: Arm) -> bool:
    """Whether stage 2 of arm `a` multiplies by the twiddle table
    (:func:`stage_planes`)."""
    return a.diag in ("notw", "noperm_notw")


def pack_factor(p: int, pack: bool) -> int:
    """r of E12's block-diagonal packing of a radix-p stage: 128 / (2p)
    where 2p < 128, else 1 (``precision_variants.bd_gmm``)."""
    return 128 // (2 * p) if pack and 2 * p < 128 else 1


def stage_flops(a: Arm) -> float:
    """bf16 tensor-core flops a point of the whole transform: a radix-p
    stage takes 24p (stacked, three passes of 8p), 16p (noxl) or 18p
    (Karatsuba: three products of 2p, three passes), r-fold where packed;
    times the repeat count; 0 for the copy."""
    if a.diag == "copy":
        return 0.0
    total = 0.0
    for p, g in zip(a.radices, a.groups):
        if a.form == "karatsuba":
            per = 18.0 * p
        else:
            per = (16.0 if g == "noxl" else 24.0) * p
        total += per * pack_factor(p, a.pack)
    return total * a.reps


# ---------------------------------------------------------------------------
# host constants
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def twiddle_pairs(p: int) -> np.ndarray:
    """Stage 1's twiddle w[k1, j2] = exp(-2 pi i k1 j2 / 1024) as a (p, q,
    2) float32 array of (re, im) pairs (the reference's ``w`` in
    ``_stage_consts``, ``make_variant``, ``_tw_flat``)."""
    w = matrices.twiddle_2d(p, N // p, -1)
    return np.ascontiguousarray(
        np.stack([w.real, w.imag], -1).astype(np.float32))


def stage_planes(p: int, twiddled: bool = False):
    """(Fr, Fi), the float32 planes a radix-p stage multiplies by: F's, or
    with `twiddled` the (p, p) stage-1 twiddle of [p, p].  E4's ``notw``
    arms skip the twiddle without stepping past its constants, so their
    stage 2 reads the twiddle where F should be
    (``kernel_variants.py:123-128`` against ``:129-151``): the reference's
    wrong numbers, kept."""
    if twiddled:
        w = twiddle_pairs(p)
        return (np.ascontiguousarray(w[..., 0]),
                np.ascontiguousarray(w[..., 1]))
    return f_planes(p)


def fragment_mats(form: str, p: int, twiddled: bool = False):
    """The matrices whose bf16 halves the kernel keeps as A fragments for a
    radix-p stage, in its order: Frh Fih Frl Fil (stacked, p >= 16), Gh Gl
    (the stacked 16 x 16 G at p = 8), Frh Fih Fsh Frl Fil Fsl (Karatsuba,
    Fs = Fr + Fi in f32)."""
    fr, fi = (torch.from_numpy(a) for a in stage_planes(p, twiddled))
    if form == "karatsuba":
        base = [fr, fi, fr + fi]
    elif p >= 16:
        base = [fr, fi]
    else:
        base = [torch.from_numpy(g_matrix(p))]
    halves = [split_hi_lo(m) for m in base]
    return [h.numpy() for h, _ in halves] + [lo.numpy() for _, lo in halves]


@lru_cache(maxsize=None)
def packed_g(p: int) -> np.ndarray:
    """E12's block-diagonal (2p r, 2p r) float32 packing of the stacked G,
    r = 128 / (2p) (``precision_variants.make_kernel``'s plan-time BD)."""
    r, m = pack_factor(p, True), 2 * p
    bd = np.zeros((m * r, m * r), np.float32)
    for i in range(r):
        bd[m * i:m * (i + 1), m * i:m * (i + 1)] = g_matrix(p)
    return bd


@lru_cache(maxsize=None)
def host_consts(form: str, p: int, host_split: bool,
                twiddled: bool = False) -> np.ndarray:
    """What the kernel reads for a radix-p stage, as float32-sized words:
    the A fragments in ``mma.sync.m16n8k16`` order (a host split), else Fr
    then Fi as p x p float32, which the block splits into the same words
    (`twiddled`: :func:`stage_planes`)."""
    if host_split:
        return mma_fragments(fragment_mats(form, p, twiddled)).view(
            np.float32)
    fr, fi = stage_planes(p, twiddled)
    return np.concatenate([fr.reshape(-1), fi.reshape(-1)])


@lru_cache(maxsize=None)
def _device_consts(name: str, device: torch.device):
    """(stage-1 constants, stage-2 constants, twiddle pairs) of arm `name`
    on `device`, made once."""
    a = ARMS[name]
    p, q = a.radices
    dev = (lambda c: torch.from_numpy(np.ascontiguousarray(c)).to(device))
    return (dev(host_consts(a.form, p, a.host_split)),
            dev(host_consts(a.form, q, a.host_split, notw(a))),
            dev(twiddle_pairs(p)))


def _frag_words(form: str, p: int) -> int:
    """uint4 words of a stage's fragments (``frag_words``)."""
    if form == "karatsuba":
        return 6 * (p // 16) ** 2 * 32
    return 4 * (p // 16) ** 2 * 32 if p >= 16 else 2 * 32


def smem_bytes(name: str, rpb: int) -> int:
    """Shared-memory bytes of arm `name` with `rpb` rows a block
    (``Geo::smem`` in ``csrc/k1_mma.cuh``)."""
    a = arm(name)
    p, q = a.radices
    row = 2 * p * (q + PAD)
    row += 4 * p * (q // 2 + PAD) if a.buffer == "bf16" else \
        2 * q * (p + PAD)
    return 16 * (_frag_words(a.form, p) + _frag_words(a.form, q)) \
        + 4 * rpb * row


def rows_per_block_fit(name: str):
    """The values of :data:`ROWS_PER_BLOCK` whose shared memory fits."""
    return [r for r in ROWS_PER_BLOCK if smem_bytes(name, r) <= MAX_SMEM]


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def _product(Gm: torch.Tensor, X: torch.Tensor, group: str) -> torch.Tensor:
    """Gm @ X in bf16 hi/lo with the grouping `group` (``_gmm``,
    ``_gmm_ps``, ``mono_stage``'s GGG, ``precision_variants.noxl_gmm``); X
    is (rows, K, N)."""
    Gh, Gl = split_hi_lo(Gm)
    if group == "noxl":
        Xh = bf16(X)
        return exact_matmul(torch.cat([Gh, Gl], 1), torch.cat([Xh, Xh], 1))
    Xh, Xl = split_hi_lo(X)
    if group == "three":
        return exact_matmul(Gh, Xh) + (exact_matmul(Gh, Xl)
                                       + exact_matmul(Gl, Xh))
    if group == "fused":
        return exact_matmul(Gh, Xh) + exact_matmul(
            torch.cat([Gh, Gl], 1), torch.cat([Xl, Xh], 1))
    return exact_matmul(torch.cat([Gh, Gh, Gl], 1),
                        torch.cat([Xh, Xl, Xh], 1))


def _stacked(Xr, Xi, p: int, group: str, pack: bool):
    """One stacked stage on (rows, p, N) planes: G [Xr; Xi], packed
    block-diagonally in r column groups where E12 packs it
    (``bd_gmm``)."""
    R, _, Ncol = Xr.shape
    X = torch.cat([Xr, Xi], 1)
    G = torch.from_numpy(g_matrix(p)).to(X.device)
    r = pack_factor(p, pack)
    if r == 1:
        Y = _product(G, X, group)
    else:
        Nr = Ncol // r
        xg = X.reshape(R, 2 * p, r, Nr).transpose(1, 2).reshape(
            R, 2 * p * r, Nr)
        BD = torch.from_numpy(packed_g(p)).to(X.device)
        yg = _product(BD, xg, group)
        Y = yg.reshape(R, r, 2 * p, Nr).transpose(1, 2).reshape(
            R, 2 * p, Ncol)
    return Y[:, :p], Y[:, p:]


def _karatsuba_stage(Xr, Xi, p: int, group: str, twiddled: bool = False):
    """E4's ``mm_pair``: t1 = Fr Xr, t2 = Fi Xi, t3 = (Fr + Fi)(Xr + Xi),
    each in bf16 hi/lo (three passes, or ``k2``'s fused cross)."""
    fr, fi = (torch.from_numpy(a).to(Xr.device)
              for a in stage_planes(p, twiddled))

    def mmx(F, x):
        Fh, Fl = split_hi_lo(F)
        xh, xl = split_hi_lo(x)
        if group == "fused":
            return exact_matmul(Fh, xh) + exact_matmul(
                torch.cat([Fh, Fl], 1), torch.cat([xl, xh], 1))
        return exact_matmul(Fh, xh) + (exact_matmul(Fh, xl)
                                       + exact_matmul(Fl, xh))
    t1 = mmx(fr, Xr)
    t2 = mmx(fi, Xi)
    t3 = mmx(fr + fi, Xr + Xi)
    return t1 - t2, t3 - t1 - t2


def k1_mma_torch(xr: torch.Tensor, xi: torch.Tensor, name: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What arm `name` computes, in plain PyTorch, on split (rows, 1024)
    planes."""
    a = arm(name)
    if xr.dim() != 2 or xr.shape[-1] != N or xi.shape != xr.shape:
        raise ValueError(f"the E4-E12 arms take split (rows, {N}) planes, "
                         f"got {tuple(xr.shape)} and {tuple(xi.shape)}")
    if a.diag == "copy":
        return xr.clone(), xi.clone()
    R = xr.shape[0]
    p, q = a.radices
    w = torch.from_numpy(twiddle_pairs(p)).to(xr.device)
    ar, ai = xr, xi
    for _ in range(a.reps):
        Xr, Xi = ar.reshape(R, p, q), ai.reshape(R, p, q)
        if a.form == "karatsuba":
            yr, yi = _karatsuba_stage(Xr, Xi, p, a.groups[0])
        else:
            yr, yi = _stacked(Xr, Xi, p, a.groups[0], a.pack)
        if not notw(a):
            wr, wi = w[..., 0], w[..., 1]
            yr, yi = yr * wr - yi * wi, yr * wi + yi * wr
        if a.diag in ("noperm", "noperm_notw"):
            tr, ti = yr.reshape(R, q, p), yi.reshape(R, q, p)
        else:
            tr, ti = yr.transpose(1, 2), yi.transpose(1, 2)
        if a.form == "karatsuba":
            zr, zi = _karatsuba_stage(tr, ti, q, a.groups[1], notw(a))
        else:
            zr, zi = _stacked(tr, ti, q, a.groups[1], a.pack)
        ar, ai = zr.reshape(R, N), zi.reshape(R, N)
    return ar.contiguous(), ai.contiguous()


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

#: (source, variant, rpb, device index) -> grid that fills the card
_grids: Dict[Tuple[str, int, int, int], int] = {}


def _check(name: str, xr: torch.Tensor, xi: torch.Tensor, rpb: int) -> Arm:
    """The wrapper's checks, shapes before the device."""
    a = arm(name)
    if xr.dim() != 2 or xr.shape[-1] != N or xi.shape != xr.shape:
        raise ValueError(f"the E4-E12 arms take split (rows, {N}) planes, "
                         f"got {tuple(xr.shape)} and {tuple(xi.shape)}")
    smem = smem_bytes(name, rpb)
    if rpb < 1 or smem > MAX_SMEM:
        raise ValueError(f"{rpb} rows a block of {name} need {smem} bytes "
                         f"of shared memory, over {MAX_SMEM}")
    passes.check_planes("k1_mma_cuda", xr, xi, xr, 2)
    if xr.shape[0] >= 2 ** 31 // N:
        raise ValueError(f"{xr.shape[0]} rows exceed the kernel's int row "
                         "count")
    if xr.data_ptr() % 16 or xi.data_ptr() % 16:
        raise ValueError("k1_mma_cuda takes 16-byte aligned planes")
    return a


def k1_mma_cuda(xr: torch.Tensor, xi: torch.Tensor, name: str,
                rows_per_block: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of arm `name` on split (rows, 1024) f32 planes on one
    card, `rows_per_block` rows a block (any row count: the last group is
    ragged).  Returns new (yr, yi); raises on anything the kernel does not
    take, and when the launch fails."""
    from . import _build
    rpb = int(rows_per_block)
    a = _check(name, xr, xi, rpb)
    R = xr.shape[0]
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if R == 0:
        return yr, yi
    smem = smem_bytes(name, rpb)
    c1, c2, tw = _device_consts(name, xr.device)
    lib = _build.library()
    with passes.device_guard(xr.device):
        key = (a.source, a.variant, rpb, xr.device.index)
        grid = _grids.get(key)
        if grid is None:
            per_sm = ctypes.c_int(0)
            rc = getattr(lib, f"{a.source}_occupancy")(
                a.variant, smem, ctypes.byref(per_sm))
            if rc != 0:
                raise RuntimeError(f"{a.source} occupancy query failed: CUDA "
                                   f"error {rc} ({name}, rpb={rpb})")
            sms = torch.cuda.get_device_properties(
                xr.device).multi_processor_count
            grid = _grids[key] = sms * max(1, per_sm.value)
        grid = min(grid, -(-R // rpb))
        rc = getattr(lib, f"{a.source}_launch")(
            a.variant, xr.data_ptr(), xi.data_ptr(), yr.data_ptr(),
            yi.data_ptr(), c1.data_ptr(), c2.data_ptr(), tw.data_ptr(), R,
            rpb, a.reps, int(a.host_split), grid, smem,
            torch.cuda.current_stream(xr.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{a.source} kernel launch failed: CUDA error "
                           f"{rc} ({name}, ({R}, {N}), rpb={rpb})")
    launches[name] = launches.get(name, 0) + 1
    return yr, yi


def k1_inplace_cuda(xr: torch.Tensor, xi: torch.Tensor, radices,
                    table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """E10's ``donate``: K1 (``stockham_c2c_cuda``'s body, the plain form)
    on split (B, n) planes with the output written over the input, through
    the in-place kernel; returns (xr, xi)."""
    global inplace_launches
    passes.check_planes("k1_inplace_cuda", xr, xi, table, 2)
    B, n = xr.shape
    radices = [int(r) for r in radices]
    if n > S.MAX_N or not S.radices_ok(n, radices):
        raise ValueError(f"kernel schedule {radices} does not fit n={n}")
    if table.numel() != S.table_len(n, radices):
        raise ValueError(f"root table of {table.numel()} floats does not "
                         f"match schedule {radices}")
    if B == 0:
        return xr, xi
    plan = S.level_plan(n, tuple(radices))
    rpb = S.rows_per_block(n)
    passes.launch("stockham_c2c_inplace", xr.device, S.plan_smem(plan, rpb),
                  -(-B // rpb), (xr.data_ptr(), xi.data_ptr(),
                                 table.data_ptr(), S.plan_array(plan), B, n,
                                 rpb),
                  f"in place, n={n}, radices={radices}, B={B}")
    inplace_launches += 1
    return xr, xi
