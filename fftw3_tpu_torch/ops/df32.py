"""The double-float ("df32") double-precision tier — the port of
``fftw3_tpu/ops/df32.py``.

Every value travels as an unevaluated sum of two f32s (hi + lo, |lo| <=
ulp(hi)/2), and every add and multiply is an error-free transform (Knuth
two-sum, Dekker two-product by exact splitting), so the pair behaves like a
float of about 48 mantissa bits computed in f32 arithmetic, about 1e-13
relative error on a transform: inside FFTW's double-precision contract of
1e-10.  The ``df_*`` ops are dtype-generic: on f64 tensors (the 2^27+1
split) they are the double-double arithmetic of ``ops/dd64.py``.

The error-free transforms hold only if every operation rounds on its own:
a fused multiply-add would keep Dekker's split from being exact.  The
PyTorch forms here are separate tensor ops (no ``addcmul``, ``lerp`` or
other fused op), and the CUDA kernel writes every sum with the ``_rn``
intrinsics, which nvcc never contracts.

Two solvers, as in the reference:

* ``df32`` (:func:`build_df32_c2c_split`): the recursive mixed-radix
  Cooley-Tukey of the reference's XLA path in plain PyTorch (a butterfly
  over axis -2, the fused df twiddle, the child along the tail), the
  analog of the reference's XLA pipeline.  ESTIMATE's complex128 choice.
* ``df32p`` (:func:`build_df32_pallas_split`): the fused kernel K7,
  ``csrc/df32_c2c.cu``, beside its plain PyTorch twin
  :func:`df32_c2c_torch`.  MEASURE-only, as in the reference.

f64 planes go in and come out of both; the hi/lo split and the final
recombination are the only f64 operations.  Gradients are the
opposite-sign df transform of the cotangent planes (autograd through the
error-free chains would lose the lo planes).
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
from . import stockham as S

#: Dekker split constants (2^ceil(t/2) + 1 for a t-bit mantissa): f32
#: 2^12+1, f64 2^27+1 (the dd64 tier)
_SPLIT = 4097.0
_SPLIT64 = 134217729.0

# A double-float number is a pair (hi, lo) of tensors; a double-float
# complex is a 4-tuple (rh, rl, ih, il).


def _two_sum(a, b):
    """Error-free a + b = s + e (Knuth; no magnitude precondition)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fast_two_sum(s, e):
    """Renormalize: |s| >= |e| assumed (true after any df op)."""
    h = s + e
    return h, e - (h - s)


def _two_prod(a, b):
    """Error-free a * b = p + e via Dekker splitting.  ``a`` is a tensor;
    its dtype picks the split constant."""
    split = _SPLIT64 if a.dtype == torch.float64 else _SPLIT
    p = a * b
    ah = split * a
    ah = ah - (ah - a)
    al = a - ah
    bh = split * b
    bh = bh - (bh - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(ah, al, bh, bl):
    s, e = _two_sum(ah, bh)
    return _fast_two_sum(s, e + (al + bl))


def df_sub(ah, al, bh, bl):
    return df_add(ah, al, -bh, -bl)


def df_mul(ah, al, bh, bl):
    p, e = _two_prod(ah, bh)
    return _fast_two_sum(p, e + (ah * bl + al * bh))


def df_cadd(a, b):
    return (*df_add(a[0], a[1], b[0], b[1]), *df_add(a[2], a[3], b[2], b[3]))


def df_csub(a, b):
    return (*df_sub(a[0], a[1], b[0], b[1]), *df_sub(a[2], a[3], b[2], b[3]))


def df_cmul(a, b):
    """(ar + i ai)(br + i bi), all components double-float."""
    rr = df_mul(a[0], a[1], b[0], b[1])
    ii = df_mul(a[2], a[3], b[2], b[3])
    ri = df_mul(a[0], a[1], b[2], b[3])
    ir = df_mul(a[2], a[3], b[0], b[1])
    return (*df_sub(*rr, *ii), *df_add(*ri, *ir))


def _split_const(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side f64 -> (hi, lo) f32 pair, exact to about 2^-49."""
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return np.ascontiguousarray(hi), np.ascontiguousarray(lo)


def _coeff_mul(x, c: complex, ch, cl):
    """x * c where c is a unit-circle coefficient known at build time:
    +-1 / +-i are free (negations, swaps); otherwise a full df complex
    multiply against the host-split (ch, cl) pairs."""
    if c == 1:
        return x
    if c == -1:
        return (-x[0], -x[1], -x[2], -x[3])
    if c == 1j:
        return (-x[2], -x[3], x[0], x[1])
    if c == -1j:
        return (x[2], x[3], -x[0], -x[1])
    return df_cmul(x, (ch[0], cl[0], ch[1], cl[1]))


def _canon(c: complex) -> complex:
    """Snap near-exact butterfly coefficients to their exact values so the
    free-multiply cases fire despite f64 trig rounding."""
    for exact in (1, -1, 1j, -1j):
        if abs(c - exact) < 1e-12:
            return exact
    return c


# ---------------------------------------------------------------------------
# the df32 solver (the reference's XLA path)
# ---------------------------------------------------------------------------

def df32_radices(n: int) -> Optional[List[int]]:
    """2-3-5-smooth factorization, largest radices first; None if n has a
    larger prime factor."""
    out = []
    m = n
    for p in (4, 3, 5, 2):
        while m % p == 0:
            out.append(p)
            m //= p
    if m != 1:
        return None
    return sorted(out, reverse=True)


def df32_applicable(n: int) -> bool:
    return n >= 2 and df32_radices(n) is not None


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _df32_consts(p: int, q: int, sign: int, device):
    """One level's constants: the radix-p butterfly coefficients (snapped
    by :func:`_canon`), their host-split f32 (hi, lo) pairs, and the (p, q)
    twiddle grid as four f32 planes (rh, rl, ih, il), on `device`."""
    F = matrices.dft_matrix(p, sign)
    coeffs = [[_canon(complex(F[j, k])) for j in range(p)] for k in range(p)]
    csplit = [[tuple(_on(h, device) for h in _split_const(
        np.array([F[j, k].real, F[j, k].imag]))) for j in range(p)]
        for k in range(p)]
    tw = matrices.twiddle_2d(p, q, sign)
    return coeffs, csplit, tuple(
        _on(h, device) for h in (*_split_const(tw.real),
                                 *_split_const(tw.imag)))


def df_pipeline(n: int, radices: Sequence[int], sign: int, device,
                consts=_df32_consts):
    """Recursive CT level: butterfly radix p over axis -2 in df arithmetic,
    fused df twiddle, child along the tail.  Returns a closure on df
    complex 4-tuples of (..., n)-shaped tensors; ``consts(p, q, sign,
    device)`` makes each level's constants once (:func:`_df32_consts`, or
    dd64's mpmath-split f64 ones)."""
    if n == 1:
        return lambda x: x
    p = radices[0]
    q = n // p
    child = df_pipeline(q, radices[1:], sign, device, consts)
    coeffs, csplit, tw = consts(p, q, sign, device)

    def apply(x):
        shp = x[0].shape[:-1]
        xs = [tuple(v.reshape(*shp, p, q)[..., j, :] for v in x)
              for j in range(p)]
        outs = []
        for k in range(p):
            acc = None
            for j in range(p):
                t = _coeff_mul(xs[j], coeffs[k][j], *csplit[k][j])
                acc = t if acc is None else df_cadd(acc, t)
            if k > 0:          # row 0 of the twiddle grid is all ones
                acc = df_cmul(acc, tuple(v[k] for v in tw))
            outs.append(acc)
        y = tuple(torch.stack([o[i] for o in outs], dim=-2)
                  for i in range(4))
        z = child(y)
        return tuple(v.transpose(-1, -2).reshape(*shp, n) for v in z)
    return apply


def _split(x: torch.Tensor):
    """f64 (or f32) tensor -> (hi, lo) f32 pair."""
    hi = x.to(torch.float32)
    return hi, (x - hi.to(x.dtype)).to(torch.float32)


def _rebuild(hi: torch.Tensor, lo: torch.Tensor, dtype) -> torch.Tensor:
    return hi.to(dtype) + lo.to(dtype)


def build_df32_c2c_split(desc: Dict, sign: int, rdtype, device):
    """Split apply for ``{"alg": "df32", "n": n, "radices": [...]}``: (xr,
    xi) in the plan's real dtype -> (yr, yi) in the same dtype, with the
    opposite-sign df32 transform as the backward."""
    n = desc["n"]
    radices = list(desc["radices"])
    dtype = torch.float64 if np.dtype(rdtype) == np.float64 \
        else torch.float32
    device = torch.device(device)
    cores = {s: df_pipeline(n, radices, s, device) for s in (sign, -sign)}

    def run(xr, xi, s):
        xr, xi = xr.to(dtype), xi.to(dtype)
        yrh, yrl, yih, yil = cores[s]((*_split(xr), *_split(xi)))
        return _rebuild(yrh, yrl, dtype), _rebuild(yih, yil, dtype)

    return passes.differentiable(run, sign)


# ---------------------------------------------------------------------------
# the fused df32 kernel K7 ("df32p") and its plain PyTorch twin
# ---------------------------------------------------------------------------

#: the fused kernel's window, the reference's value (a TPU VMEM bound, kept
#: for route parity: re-measuring it on the card is an open question)
DF32P_MIN_N = 128
DF32P_MAX_N = 1024
#: most stages a df32p schedule may have (the kernel's arguments)
DF32P_MAX_STAGES = 4
#: points per block tile of K7 (at most): ``rows_per_block`` whole rows,
#: 16 bytes of shared memory a point, so 64 KB at 4096 points and two
#: blocks of 256 threads an SM
TILE_POINTS = 4096
#: threads of a K7 block (``kThreads`` in csrc/df32_c2c.cu)
K7_THREADS = 256
#: the two-level passes K7 instantiates, (r1, r2) of consecutive recursion
#: levels: a task holds r1 * r2 <= 16 df points (64 floats) in registers
PASS_PAIRS = ((4, 4), (4, 2), (4, 3), (2, 5), (2, 3), (5, 3), (3, 3))
#: the pass kinds each of K7's instantiations inlines (``fam_has`` in
#: csrc/df32_c2c.cu): those of the df32p schedules of n = 1024, 512 and
#: 256, and 128, then every kind (None).  A schedule runs on the first
#: family holding all its kinds: one body that inlines every kind spills
#: (PERF.md)
K7_FAMILIES = (((4, 4), (4, 1)), ((4, 4), (2, 1)), ((4, 4), (4, 2)), None)
#: passes a plan holds (``kMaxPasses``)
MAX_PASSES = 12
#: the pass fields, in the order the plan holds them (``Pass`` in
#: csrc/df32_c2c.cu): radices of its two levels (r2 = 1 for one level);
#: source (0 the float64 input, 1 shared memory in place, 2 shared memory
#: in the previous stage's digit-reversed layout) and sink (0 shared
#: memory in place, 1 the float64 output); the sub-block m at its first
#: level and the inner span m / (r1 r2); the stage's column stride S = q *
#: done, done, q and p; float4-entry offsets into the constant table of
#: the first level's radix-3/5 coefficients and level twiddles, the second
#: level's, and the stage twiddle (-1: none); int-table offsets of the
#: stage's position -> output table (rev) and the previous stage's output
#: -> position table (dp); the previous stage's S and done; the source
#: stride of a permuted read (q * done of the previous stage); and whether
#: the pass needs a barrier between its reads and its writes
PASS_FIELDS = ("r1", "r2", "src", "dst", "m", "inner", "S", "done", "q", "p",
               "cf1", "lt1", "cf2", "lt2", "stw", "rev", "dp", "sp", "donep",
               "ustride", "mid")

#: FP32 instructions of one df add and one df multiply in K7's body
#: (csrc/df32_c2c.cu): two_sum 6, two adds, fast_two_sum 3; the product
#: one FMUL, its exact error one FFMA, two cross FMULs, two adds,
#: fast_two_sum 3
DF_ADD_INSTR = 11
DF_MUL_INSTR = 9
#: complex df adds and multiplies of one radix-r butterfly of K7 (r = 4:
#: eight adds, the i-rotation free; r = 3 and 5 the direct coefficient
#: form), before its level twiddles
_BFLY_OPS = {2: (2, 0), 4: (8, 0), 3: (6, 4), 5: (20, 16)}

#: launches of the CUDA kernel, counted by :func:`df32_c2c_cuda`
launches = 0


def _df_scal(x: complex) -> Tuple:
    """Host complex -> 4 f32 scalar values (rh, rl, ih, il)."""
    rh = np.float32(x.real)
    rl = np.float32(x.real - np.float64(rh))
    ih = np.float32(x.imag)
    il = np.float32(x.imag - np.float64(ih))
    return rh, rl, ih, il


def _smooth(m: int) -> bool:
    for f in (2, 3, 5):
        while m % f == 0:
            m //= f
    return m == 1


def _df_radix(m: int) -> int:
    if m % 4 == 0:
        return 4
    if m % 2 == 0:
        return 2
    if m % 5 == 0:
        return 5
    if m % 3:
        raise ValueError(f"df butterfly size {m} is not 2-3-5-smooth")
    return 3


def _df_bfly_consts(m: int, sign: int) -> List[np.ndarray]:
    """Flat f32 constant list the size-m df butterfly reads, in the order
    :func:`_df_vpu_dft` and the kernel read it: per recursion node, the
    radix-3/5 coefficient df pairs, then (q, 1) level-twiddle df pairs for
    k1 = 1..r-1, then the child subtree once (all r children share it)."""
    if m == 1:
        return []
    r = _df_radix(m)
    q = m // r
    out: List[np.ndarray] = []
    if r == 3:
        coeffs = [np.exp(sign * 2j * np.pi / 3),
                  np.exp(sign * 4j * np.pi / 3)]
    elif r == 5:
        coeffs = [np.exp(sign * 2j * np.pi * k / 5) for k in range(1, 5)]
    else:
        coeffs = []
    for w in coeffs:
        out += [np.full((1, 1), v, np.float32) for v in _df_scal(w)]
    if q > 1:
        for k1 in range(1, r):
            e = (np.arange(q, dtype=np.int64) * k1) % m
            w = np.exp(sign * 2j * np.pi * e / m)
            rh, rl = _split_const(w.real)
            ih, il = _split_const(w.imag)
            out += [a.reshape(q, 1) for a in (rh, rl, ih, il)]
    return out + _df_bfly_consts(q, sign)


def _df_vpu_dft(x, m: int, sign: int, consts, off: int = 0):
    """Size-m df DFT over axis 0 of four (m, R) planes (rh, rl, ih, il),
    natural order, radix-4/2/5/3 recursion: the reference's
    ``_df_vpu_dft``.  ``consts``/``off``: the :func:`_df_bfly_consts`
    stream.  Returns (planes, next_off)."""
    if m == 1:
        return x, off
    r = _df_radix(m)
    q = m // r
    R = x[0].shape[-1]
    x3 = [tuple(v.reshape(r, q, R)[j] for v in x) for j in range(r)]

    def grab4():
        nonlocal off
        c = tuple(consts[off + i] for i in range(4))
        off += 4
        return c

    def imul(a):               # a * (i*sign)
        if sign < 0:
            return (a[2], a[3], -a[0], -a[1])
        return (-a[2], -a[3], a[0], a[1])

    if r == 2:
        b = [df_cadd(x3[0], x3[1]), df_csub(x3[0], x3[1])]
    elif r == 4:
        t0 = df_cadd(x3[0], x3[2])
        t1 = df_csub(x3[0], x3[2])
        t2 = df_cadd(x3[1], x3[3])
        t3 = df_csub(x3[1], x3[3])
        u3 = imul(t3)
        b = [df_cadd(t0, t2), df_cadd(t1, u3),
             df_csub(t0, t2), df_csub(t1, u3)]
    elif r == 3:
        w1, w2 = grab4(), grab4()
        b = [df_cadd(x3[0], df_cadd(x3[1], x3[2])),
             df_cadd(x3[0], df_cadd(df_cmul(x3[1], w1),
                                    df_cmul(x3[2], w2))),
             df_cadd(x3[0], df_cadd(df_cmul(x3[1], w2),
                                    df_cmul(x3[2], w1)))]
    else:                      # r == 5: direct coefficient form, w^1..w^4
        ws = [grab4() for _ in range(4)]
        b = []
        for k1 in range(5):
            acc = x3[0]
            for j1 in range(1, 5):
                if k1 == 0:
                    acc = df_cadd(acc, x3[j1])
                else:
                    acc = df_cadd(acc, df_cmul(
                        x3[j1], ws[(j1 * k1) % 5 - 1]))
            b.append(acc)
    if q > 1:
        # one df cmul per k1 against the (q, 1) level twiddle pairs
        for k1 in range(1, r):
            b[k1] = df_cmul(b[k1], grab4())
    zs = []
    child_off = off
    for k1 in range(r):
        z, off = _df_vpu_dft(b[k1], q, sign, consts, child_off)
        zs.append(z)
    y = tuple(torch.stack([z[i] for z in zs], dim=1).reshape(m, R)
              for i in range(4))
    return y, off


def _df_stage_consts(n: int, radices: Sequence[int], sign: int):
    """Per-stage constant list: the stage's (p, q) df twiddle pairs (q > 1
    stages), then the radix-p butterfly's constant stream."""
    out = []
    rest = n
    for p in radices:
        q = rest // p
        stage: List[np.ndarray] = []
        if q > 1:
            e = np.mod(np.outer(np.arange(p, dtype=np.int64),
                                np.arange(q, dtype=np.int64)), rest)
            w = np.exp(sign * 2j * np.pi * e / rest)
            rh, rl = _split_const(w.real)
            ih, il = _split_const(w.imag)
            stage += [rh, rl, ih, il]
        stage += _df_bfly_consts(p, sign)
        out.append(stage)
        rest = q
    return out


def _kernel_table(n: int, radices: Sequence[int], sign: int) -> np.ndarray:
    """K7's f32 constant table: :func:`_df_stage_consts` stage by stage,
    each group of four arrays (rh, rl, ih, il) interleaved into float4
    entries, so a constant is one 16-byte load (layout in
    csrc/df32_c2c.cu)."""
    flat = []
    for stage in _df_stage_consts(n, radices, sign):
        for i in range(0, len(stage), 4):
            flat.append(np.stack([c.ravel() for c in stage[i:i + 4]],
                                 -1).ravel())
    return np.ascontiguousarray(np.concatenate(flat) if flat else [],
                                np.float32)


@lru_cache(maxsize=None)
def _device_consts(n: int, radices: Tuple[int, ...], sign: int,
                   device: torch.device):
    """The twin's stage constants as f32 tensors on `device`, made once."""
    return [[torch.from_numpy(c).to(device) for c in stage]
            for stage in _df_stage_consts(n, radices, sign)]


@lru_cache(maxsize=None)
def _device_table(n: int, radices: Tuple[int, ...], sign: int,
                  device: torch.device) -> torch.Tensor:
    """The kernel's constant table as one f32 tensor on `device`, made
    once."""
    return torch.from_numpy(_kernel_table(n, radices, sign)).to(device)


def _df_stages(x, n: int, radices: Sequence[int], sign: int, consts):
    """Stockham stage loop on four (n, R) df planes, the reference's
    ``_df_stages``: every stage a :func:`_df_vpu_dft`, the twiddle a
    broadcast df cmul against the (p, q) constant pairs, the permute a
    per-plane transpose.  R is the batch (the reference's lane tile)."""
    tb = x[0].shape[-1]
    done, rest = 1, n
    for p, c in zip(radices, consts):
        q = rest // p
        M = q * done * tb
        ci = 4 if q > 1 else 0
        y, _ = _df_vpu_dft(tuple(v.reshape(p, M) for v in x), p, sign, c,
                           ci)
        if q > 1:
            sh = (p, q, 1, 1)
            wv = tuple(v.reshape(sh) for v in c[:4])
            tw = df_cmul(tuple(v.reshape(p, q, done, tb) for v in y), wv)
            # (p, q, done, R) -> (q, p, done, R), per plane
            x = tuple(v.transpose(0, 1).reshape(n, tb) for v in tw)
        else:
            x = tuple(v.reshape(n, tb) for v in y)
        done *= p
        rest = q
    return x


def df32_c2c_torch(xr: torch.Tensor, xi: torch.Tensor,
                   radices: Sequence[int], sign: int):
    """Plain PyTorch twin of K7: unnormalized c2c along the last axis of
    (..., n) planes in double-float arithmetic, stage by stage as the
    reference's ``_df_stages`` orders it.  Splits the planes into hi/lo
    f32 pairs on entry and recombines them on exit, in the planes' dtype:
    the reference builder's ``_run`` boundary."""
    n = xr.shape[-1]
    if math.prod(radices) != n:
        raise ValueError(f"radices {list(radices)} do not multiply to {n}")
    shp, dtype = xr.shape[:-1], xr.dtype
    planes = (*_split(xr.reshape(-1, n)), *_split(xi.reshape(-1, n)))
    x = tuple(v.t() for v in planes)                  # (n, R), batch last
    consts = _device_consts(n, tuple(radices), sign, xr.device)
    yrh, yrl, yih, yil = (v.t() for v in _df_stages(x, n, radices, sign,
                                                    consts))
    return (_rebuild(yrh, yrl, dtype).reshape(*shp, n),
            _rebuild(yih, yil, dtype).reshape(*shp, n))


def radices_ok(n: int, radices) -> bool:
    """Can K7 run this schedule?  One to DF32P_MAX_STAGES 2-3-5-smooth
    integer radices whose product is n, with n <= DF32P_MAX_N."""
    return (isinstance(radices, (list, tuple))
            and 1 <= len(radices) <= DF32P_MAX_STAGES
            and all(isinstance(r, int) and r > 1 and _smooth(r)
                    for r in radices)
            and math.prod(radices) == n and n <= DF32P_MAX_N)


def _df_levels(p: int) -> List[int]:
    """The recursion radices of a p-point df butterfly, outermost first
    (:func:`_df_radix` at each size: 64 -> [4, 4, 4], 50 -> [2, 5, 5])."""
    out = []
    while p > 1:
        out.append(_df_radix(p))
        p //= out[-1]
    return out


def _digit_pos(k: int, m: int) -> int:
    """Where the in-place recursion leaves output k of an m-point column:
    digit k1 of the first level (k = k1 + r k2) selects the sub-block
    k1 (m/r), the child places k2 inside it."""
    pos = 0
    while m > 1:
        r = _df_radix(m)
        pos += (k % r) * (m // r)
        k //= r
        m //= r
    return pos


def _pass_tasks(r1: int, r2: int) -> int:
    """Tasks a thread runs at once in a pass of levels (r1, r2): as many as
    keep it at 16 df points or fewer (``kUnroll`` in the kernel)."""
    return max(1, 16 // (r1 * r2))


@lru_cache(maxsize=None)
def k7_plan(n: int, radices: Tuple[int, ...]):
    """K7's host-side plan for schedule `radices`: (passes, itab), the
    passes as :data:`PASS_FIELDS` tuples and the int tables (per stage, its
    output -> position table dp and position -> output table rev).

    Each stage's recursion levels are grouped into passes of one level or
    two (a pair of :data:`PASS_PAIRS`).  A task of a pass holds the points
    sb*m + j + inner*a + (m/r1)*b (a < r2, b < r1) of one column c of a
    row, the first level's butterflies over b, the second's over a.  The
    first pass of stage 0 reads the float64 input; the first pass of a later
    stage reads the previous stage's digit-reversed layout (its twiddle
    applied), so the permute costs no pass of its own; the last pass of the
    last stage writes the float64 output in natural order; every other
    access is in place in one shared-memory buffer."""
    radices = tuple(radices)
    passes, itab = [], []
    off, done, rest = 0, 1, n
    prev = None
    for s, p in enumerate(radices):
        q = rest // p
        S_ = q * done
        stw = off if q > 1 else -1
        if q > 1:
            off += p * q
        levels, m = [], p
        for r in _df_levels(p):
            cf = off if r in (3, 5) else -1
            off += 2 if r == 3 else 4 if r == 5 else 0
            lt = off if m // r > 1 else -1
            if m // r > 1:
                off += (r - 1) * (m // r)
            levels.append((r, m, cf, lt))
            m //= r
        dp_off = len(itab)
        dp = [_digit_pos(k, p) for k in range(p)]
        itab += dp
        rev_off = len(itab)
        rev = [0] * p
        for k, pos in enumerate(dp):
            rev[pos] = k
        itab += rev
        groups, i = [], 0
        while i < len(levels):
            if i + 1 < len(levels) and \
                    (levels[i][0], levels[i + 1][0]) in PASS_PAIRS:
                groups.append(levels[i:i + 2])
                i += 2
            else:
                groups.append(levels[i:i + 1])
                i += 1
        for g, lv in enumerate(groups):
            first, last = g == 0, g == len(groups) - 1
            r1, m1, cf1, lt1 = lv[0]
            r2, _, cf2, lt2 = lv[1] if len(lv) == 2 else (1, 0, -1, -1)
            src = 0 if first and s == 0 else 2 if first else 1
            dst = 1 if last and s == len(radices) - 1 else 0
            passes.append((
                r1, r2, src, dst, m1, m1 // (r1 * r2), S_, done, q, p,
                cf1, lt1, cf2, lt2, stw if last else -1, rev_off,
                prev[0] if src == 2 else 0, prev[1] if src == 2 else 0,
                prev[2] if src == 2 else 1, q * prev[2] if src == 2 else 0,
                int(src == 2 and dst == 0)))
        prev = (dp_off, S_, done)
        done *= p
        rest = q
    if len(passes) > MAX_PASSES:
        raise ValueError(f"K7 schedule {list(radices)} needs {len(passes)} "
                         f"passes, over {MAX_PASSES}")
    return tuple(passes), tuple(itab)


def rows_per_block(n: int, radices: Sequence[int]) -> int:
    """Rows of one block tile of K7: as many whole rows as TILE_POINTS
    holds, and no more than a pass with a barrier between its reads and
    writes can hold in one round of its tasks (every task of such a pass
    keeps its points in registers across the barrier)."""
    cap = TILE_POINTS
    for ps in k7_plan(n, tuple(radices))[0]:
        P = dict(zip(PASS_FIELDS, ps))
        if P["mid"]:
            cap = min(cap, K7_THREADS * _pass_tasks(P["r1"], P["r2"])
                      * P["r1"] * P["r2"])
    return max(1, cap // n)


def _swizzle(e: np.ndarray, s1: int, s2: int) -> np.ndarray:
    """The slot of tile point e in K7's buffer: e with its low three bits
    XORed with bits s1 and s2 on (``slot`` in the kernel)."""
    return e ^ (((e >> s1) ^ (e >> s2)) & 7)


def _accesses(n: int, radices: Tuple[int, ...], rpb: int):
    """Every shared-memory access of one full tile, as K7's warps make
    them: a list of (32,) arrays of tile points, one per warp and
    instruction (each lane's task, the register point the instruction
    moves)."""
    passes, itab = k7_plan(n, radices)
    out = []
    for ps in passes:
        P = dict(zip(PASS_FIELDS, ps))
        r1, r2 = P["r1"], P["r2"]
        tpr = n // (r1 * r2)
        w = np.arange(rpb * tpr)
        row, u = w // tpr, w % tpr
        c, v = u % P["S"], u // P["S"]
        j, sb = v % P["inner"], v // P["inner"]
        a = np.arange(r2)[:, None, None]
        b = np.arange(r1)[None, :, None]
        i = sb * P["m"] + j + P["inner"] * a + (P["m"] // r1) * b
        nat = row * n + i * P["S"] + c
        if P["src"] == 1:
            reads = nat
        elif P["src"] == 2:
            j2s, ds = c // P["done"], c % P["done"]
            k1, d = ds // P["donep"], ds % P["donep"]
            base = (np.asarray(itab)[P["dp"] + k1] * P["sp"]
                    + j2s * P["donep"] + d)
            reads = row * n + base + i * P["ustride"]
        else:
            reads = None
        for acc in (reads, nat if P["dst"] == 0 else None):
            if acc is None:
                continue
            acc = acc.reshape(r1 * r2, -1)
            pad = -acc.shape[1] % 32
            acc = np.concatenate([acc, np.full((r1 * r2, pad), -1)], 1)
            out += list(acc.reshape(r1 * r2, -1, 32).reshape(-1, 32))
    return out


@lru_cache(maxsize=None)
def k7_swizzle(n: int, radices: Tuple[int, ...]) -> Tuple[int, int]:
    """The (s1, s2) of :func:`_swizzle` that gives K7's shared-memory
    accesses the fewest bank cycles: a 16-byte access is served in four
    phases of eight lanes, one cycle for each phase and one more for each
    further distinct slot a bank group (slot mod 8) holds.  31 means no
    bit; ties go to the first of (none, one bit, two bits)."""
    rpb = rows_per_block(n, radices)
    accs = np.array(_accesses(n, radices, rpb))
    cands = [(31, 31)] + [(a, 31) for a in range(3, 14)] + \
        [(a, b) for a in range(3, 14) for b in range(a + 1, 14)]
    best, best_cost = None, None
    for s1, s2 in cands:
        sl = np.where(accs >= 0, _swizzle(np.maximum(accs, 0), s1, s2), -1)
        ph = np.sort(sl.reshape(-1, 4, 8), -1)
        uniq = np.concatenate([np.ones(ph.shape[:-1] + (1,), bool),
                               ph[..., 1:] != ph[..., :-1]], -1) & (ph >= 0)
        bank = ph % 8
        cnt = np.zeros(ph.shape[:-1] + (8,), int)
        for g in range(8):
            cnt[..., g] = (uniq & (bank == g)).sum(-1)
        cost = int(np.maximum(cnt.max(-1), 1).sum())
        if best_cost is None or cost < best_cost:
            best, best_cost = (s1, s2), cost
    return best


def k7_family(n: int, radices: Sequence[int]) -> int:
    """The first of :data:`K7_FAMILIES` that holds every pass kind of the
    schedule's plan: the kernel instantiation that runs it."""
    kinds = {ps[:2] for ps in k7_plan(n, tuple(radices))[0]}
    for f, fam in enumerate(K7_FAMILIES):
        if fam is None or kinds <= set(fam):
            return f
    raise AssertionError("the last family holds every kind")


def k7_plan_array(n: int, radices: Sequence[int]):
    """The plan as a C int array for a launch: a header (passes, s1, s2,
    int-table length) and the :data:`PASS_FIELDS` of each pass."""
    passes, itab = k7_plan(n, tuple(radices))
    s1, s2 = k7_swizzle(n, tuple(radices))
    flat = [len(passes), s1, s2, len(itab)] + [v for ps in passes
                                                for v in ps]
    return (ctypes.c_int * len(flat))(*flat)


def k7_smem(n: int, rpb: int) -> int:
    """Shared-memory bytes of a K7 launch: one buffer of 16 bytes a point
    for rpb rows, rounded up to a whole group of eight slots."""
    return 16 * (-(-rpb * n // 8) * 8)


def kernel_instructions(n: int, radices: Sequence[int]) -> int:
    """FP32 instructions K7 issues on one row: per recursion level of each
    stage, n/r radix-r butterflies (:data:`_BFLY_OPS`) with r - 1 level
    twiddle multiplies each when the level has twiddles; per stage with
    q > 1, one twiddle multiply per point.  Trivial twiddles are multiplied
    all the same, sign flips are operand modifiers, and the float64 split
    and recombination are no FP32 instructions.  The twin runs the same df
    adds and multiplies; the reference's ``c2c_opcount`` counts Dekker's
    form, which K7 does not run."""
    cadd = 2 * DF_ADD_INSTR
    cmul = 4 * DF_MUL_INSTR + 2 * DF_ADD_INSTR
    total, rest = 0, n
    for p in radices:
        q = rest // p
        m = p
        while m > 1:
            r = _df_radix(m)
            adds, muls = _BFLY_OPS[r]
            if m > r:
                muls += r - 1
            total += n // r * (adds * cadd + muls * cmul)
            m //= r
        if q > 1:
            total += n * cmul
        rest = q
    return total


@lru_cache(maxsize=None)
def _device_itab(n: int, radices: Tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """K7's int tables (:func:`k7_plan`) as one int32 tensor on `device`,
    made once."""
    return torch.tensor(k7_plan(n, radices)[1], dtype=torch.int32,
                        device=device)


@lru_cache(maxsize=None)
def _k7_launch(n: int, radices: Tuple[int, ...]):
    """K7's family, rows a tile, shared-memory bytes and plan as a C int
    array for a schedule, made once (a launch's host work stays that of a
    table lookup)."""
    rpb = rows_per_block(n, radices)
    return (k7_family(n, radices), rpb, k7_smem(n, rpb),
            k7_plan_array(n, radices))


def _launch_k7(kernel: str, xr: torch.Tensor, xi: torch.Tensor,
               radices: Sequence[int], sign: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check what K7 takes and launch `kernel` (``df32_c2c``: K7 on its
    schedule's family; else one of the arms) on (B, n) float64 planes;
    returns new (yr, yi)."""
    name = "df32_c2c_cuda" if kernel == "df32_c2c" else "df32_ablate_cuda"
    if xr.device.type != "cuda" or xi.device != xr.device:
        raise ValueError(f"{name} needs both planes on one CUDA device, got "
                         f"{xr.device} and {xi.device}")
    if xr.dtype != torch.float64 or xi.dtype != torch.float64:
        raise ValueError(f"{name} takes float64 planes, got {xr.dtype} and "
                         f"{xi.dtype}")
    if xr.dim() != 2 or xi.shape != xr.shape:
        raise ValueError(f"{name} takes two 2-D planes of one shape, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    if not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError(f"{name} takes contiguous planes")
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    B, n = xr.shape
    radices = tuple(int(r) for r in radices)
    if not radices_ok(n, list(radices)):
        raise ValueError(f"K7 schedule {list(radices)} does not fit n={n}")
    if B >= 2 ** 31:
        raise ValueError(f"batch {B} exceeds the kernel's int row count")
    fam, rpb, smem, plan = _k7_launch(n, radices)
    if kernel == "df32_c2c":
        kernel = f"df32_c2c_f{fam}"
    elif fam:
        raise ValueError(f"K7's arms run power-of-4 stages only, not "
                         f"{list(radices)}")
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if B == 0:
        return yr, yi
    table = _device_table(n, radices, sign, xr.device)
    itab = _device_itab(n, radices, xr.device)
    passes.launch(kernel, xr.device, smem, -(-B // rpb),
                  (xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
              table.data_ptr(), itab.data_ptr(), plan, B, n, rpb, sign),
             f"n={n}, radices={list(radices)}, B={B}")
    return yr, yi


def df32_c2c_cuda(xr: torch.Tensor, xi: torch.Tensor,
                  radices: Sequence[int], sign: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K7 on (B, n) float64 planes on one card, with the constant
    table of (n, radices, sign) and the plan's int tables on that card
    (made once).  Returns new (yr, yi) float64 planes; raises on anything
    the kernel does not take, and when the launch fails."""
    global launches
    yr, yi = _launch_k7("df32_c2c", xr, xi, radices, sign)
    if xr.shape[0]:
        launches += 1
    return yr, yi


#: K7's timing-only arms (``csrc/df32_c2c.cu``; on no user path): ``full``
#: (K7 itself), ``no_twiddle`` (the level and stage twiddle multiplies
#: skipped), ``skeleton`` (each butterfly a reversal of its registers:
#: every load, pass, barrier, permute and store kept, no df arithmetic) and
#: ``copy`` (the float64 split on load and the recombination on store,
#: nothing between), built for schedules of power-of-4 stages (family 0).
#: Every arm but ``full`` computes wrong numbers on purpose.
ABLATE_ARMS = ("full", "no_twiddle", "skeleton", "copy")
#: launches per arm, counted by :func:`df32_ablate_cuda`
ablate_launches: Dict[str, int] = {}


def df32_ablate_cuda(xr: torch.Tensor, xi: torch.Tensor,
                     radices: Sequence[int], sign: int, arm: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K7's ablation `arm` (:data:`ABLATE_ARMS`) on (B, n)
    float64 planes on one card; what :func:`df32_c2c_cuda` takes.  Returns
    new (yr, yi)."""
    if arm not in ABLATE_ARMS:
        raise ValueError(f"no K7 arm {arm!r}; the arms are {ABLATE_ARMS}")
    yr, yi = _launch_k7(f"df32_ablate{ABLATE_ARMS.index(arm)}", xr, xi,
                        radices, sign)
    ablate_launches[arm] = ablate_launches.get(arm, 0) + 1
    return yr, yi


def df32p_radices(n: int) -> Optional[List[int]]:
    """Schedule of the fused kernel: every radix butterfly-eligible
    (2-3-5-smooth <= 64), so the f32 tier's single-stage window falls back
    to the best two-factor eligible split by the same ranking rule."""
    def ok(rad):
        return all(S.vpu_last_ok(r, 1) for r in rad)

    try:
        rad = S.choose_radices(n)
        if ok(rad):
            return rad
    except ValueError:
        pass
    best = None
    best_cost = None
    for p in primes.divisors(n):
        q = n // p
        if p < 2 or q < 2 or not ok([p, q]):
            continue
        cost = S.stage_cost(p) + S.stage2_cost(q)
        if best is None or cost < best_cost:
            best, best_cost = [p, q], cost
    return best


def df32p_applicable(n: int, device) -> bool:
    """Gate of the fused kernel: inside the window, an all-eligible
    schedule exists, and ``config.kernel_mode`` admits the device (``off``
    never, ``auto`` a CUDA device, ``on`` any device, where the CPU runs
    the twin)."""
    if not (DF32P_MIN_N <= n <= DF32P_MAX_N):
        return False
    if config.kernel_mode == "off":
        return False
    if config.kernel_mode == "auto" and torch.device(device).type != "cuda":
        return False
    return df32p_radices(n) is not None


def build_df32_pallas_split(desc: Dict, sign: int, rdtype, device=None):
    """Split apply for ``{"alg": "df32p", "n": n, "radices": [...]}`` on
    any leading batch shape: K7 on a CUDA tensor (or a raise), the twin on
    a CPU tensor, the opposite-sign transform as the backward.  Ragged
    batches need no padding: each block takes whole rows."""
    n = desc["n"]
    radices = list(desc.get("radices") or df32p_radices(n) or [])
    if not radices_ok(n, radices):
        raise ValueError(f"df32p schedule {radices} does not fit n={n}")
    dtype = torch.float64 if np.dtype(rdtype) == np.float64 \
        else torch.float32
    if device is not None and torch.device(device).type == "cuda":
        for s in (sign, -sign):                # move the tables once
            _device_table(n, tuple(radices), s, torch.device(device))

    def run(xr, xi, s):
        if xr.shape[-1] != n or xi.shape != xr.shape:
            raise ValueError(f"plan expects split planes of shape (..., {n}),"
                             f" got {tuple(xr.shape)} and {tuple(xi.shape)}")
        xr, xi = xr.to(dtype), xi.to(dtype)
        if xr.device.type == "cpu":
            return df32_c2c_torch(xr, xi, radices, s)
        shp = xr.shape[:-1]
        yr, yi = df32_c2c_cuda(
            xr.reshape(-1, n).to(torch.float64).contiguous(),
            xi.reshape(-1, n).to(torch.float64).contiguous(), radices, s)
        return (yr.reshape(*shp, n).to(dtype),
                yi.reshape(*shp, n).to(dtype))

    return passes.differentiable(run, sign)
