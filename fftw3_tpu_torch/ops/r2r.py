"""Real-to-real 1-D solver builders — the port of ``fftw3_tpu/ops/r2r.py``:
halfcomplex DFT, DHT, and the eight real-even/odd transforms (DCT/DST
I-IV), all with FFTW's unnormalized definitions ("What FFTW Really
Computes").

Every fast solver here is a *reduction to r2c/c2r/c2c* with O(n) pre/post
passes, the architecture of FFTW's reodft layer, where everything reduces to
R2HC.  Apart from DCT-II and DCT-III, which have K8, no r2r kind has a kernel of
its own: on the card the work runs in the children's kernels, K4
(``pallas_r2c``), K6 (``pallas_c2r``) and K1 (``pallas``), and the passes
around them are PyTorch elementwise ops, gathers and concatenations, each
one read and one write of the planes.

* ``redft10_half`` — DCT-II via Makhoul's even/odd permutation + same-size
  real FFT + quarter-sample twiddle (reodft010e-r2hc analog).
* ``redft01_half`` — DCT-III, the exact inverse route.
* ``fused_redft10`` / ``fused_redft01`` (the port's own, on a CUDA device
  alone) — the same two chains in one kernel, K8 (``ops/redft.py``).
* ``redft00_ext`` / ``rodft00_ext`` — DCT-I / DST-I via even/odd extension
  to a 2(n∓1)-point real FFT (redft00e-r2hc-pad).
* ``redft00_split`` / ``rodft00_split`` — odd-n DCT-I / DST-I as a half-size
  DCT-I (DST-I) and DCT-II (DST-II), recombined by the mirror symmetries.
* ``redft11_2n`` — DCT-IV via a zero-padded 2n-point complex FFT with
  half-sample shifts (reodft11e analog); ``redft11_odd`` — odd-n DCT-IV via
  one same-size R2HC and signed permutations (reodft11e-r2hc-odd).
* ``rodft*_flip`` — each DST kind from the matching DCT kind by the exact
  sign-flip/reversal identities.
* ``dht_via_r2c`` — DHT = Re - Im of the real DFT (dht-r2hc analog);
  ``dht_rader`` — prime-n DHT via Rader's generator permutation, reducing to
  a *real* cyclic convolution of length n-1 (r2c -> pointwise -> c2r), with
  the cas kernel's DFT precomputed on the host in f64 from exact integer
  exponents.
* ``r2hc_via_r2c`` / ``hc2r_via_c2r`` — halfcomplex packing of the real DFT.
* ``r2r_matmul`` — the dense (n, n) kind matrix through ``torch.matmul``,
  any kind and size up to the planner's ``R2R_GENERIC_MAX``; the role of
  FFTW's generic O(n^2) solvers.  The reference asks for HIGHEST precision
  per call; here the product runs under ``dense.exact_matmul``, which pins
  float32 products to full precision for the call whatever the process
  has set (TF32 or bf16 included).  On the H100 a float32 product of
  (B, n) by (n, n) runs on the FP32 units at 2n flops a point, against the
  reductions' few HBM passes; the planner's costs and MEASURE decide.

The spectra stay on split real planes: the children are the port's split
builders (``build_r2c_split`` gives ``(yr, yi)``, ``build_c2r_split`` takes
``(xr, xi)``, ``build_c2c_split`` both), every twiddle is written out in re
and im, and no path combines planes into a complex tensor.  Constants are
computed in float64 on the host and rounded once to the plan's real dtype
(re and im apart, which is what rounding the reference's complex constant
gives), and index tensors are made once per device.  Gradients flow through
the children's autograd functions and PyTorch's own ops; every value is
real, so no conjugation convention enters.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict

import numpy as np
import torch

from ..utils import primes
from . import c2c as c2c_ops
from . import matrices
from . import real as real_ops
from . import redft
from .dense import exact_matmul

Apply = Callable[[torch.Tensor], torch.Tensor]

#: the r2r kind each reduction computes (``r2r_matmul`` computes its
#: descriptor's ``kind``)
KIND_OF = {"dht_via_r2c": "dht", "dht_rader": "dht",
           "r2hc_via_r2c": "r2hc", "hc2r_via_c2r": "hc2r",
           "redft10_half": "redft10", "redft01_half": "redft01",
           "redft00_ext": "redft00", "redft00_split": "redft00",
           "rodft00_ext": "rodft00", "rodft00_split": "rodft00",
           "redft11_2n": "redft11", "redft11_odd": "redft11",
           "rodft10_flip": "rodft10", "rodft01_flip": "rodft01",
           "rodft11_flip": "rodft11", **redft.KIND_OF}

#: the algs of r2r descriptors
ALGS = frozenset(KIND_OF) | {"r2r_matmul"}


def _makhoul_perm(n: int) -> np.ndarray:
    """v[j] = x[perm[j]]: even samples ascending then odd samples descending."""
    idx = np.empty(n, np.int32)
    h = (n + 1) // 2
    idx[:h] = np.arange(0, n, 2)
    idx[h:] = np.arange(1, n, 2)[::-1]
    return idx


def _makhoul_inv(n: int) -> np.ndarray:
    perm = _makhoul_perm(n)
    inv = np.empty(n, np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)
    return inv


def _redft11_odd_maps(n: int):
    """Host-side signed-permutation maps for the odd-n DCT-IV via a single
    same-size R2HC (the 8 x n PFA route of S.C. Chan & K.L. Ho, IEEE
    Trans. CAS-II 39(3) 1992; reodft11e-r2hc-odd analog).  The pre-step
    samples the canonical DCT-IV symmetry extension (even about -1/2, odd
    about n-1/2) of x at positions n//2 + 4i mod 4n; the post-step combines
    pairs of halfcomplex bins with signs and a global sqrt(2)."""
    n2 = n // 2
    m = (n2 + 4 * np.arange(n, dtype=np.int64)) % (4 * n)
    pre_idx = np.empty(n, np.int64)
    pre_sgn = np.empty(n, np.float64)
    for i, mm in enumerate(m):
        if mm < n:
            pre_idx[i], pre_sgn[i] = mm, 1.0
        elif mm < 2 * n:
            pre_idx[i], pre_sgn[i] = 2 * n - 1 - mm, -1.0
        elif mm < 3 * n:
            pre_idx[i], pre_sgn[i] = mm - 2 * n, -1.0
        else:
            pre_idx[i], pre_sgn[i] = 4 * n - 1 - mm, 1.0
    ia = np.zeros(n, np.int64)
    sa = np.zeros(n)
    ib = np.zeros(n, np.int64)
    sb = np.zeros(n)

    def sgn(t):
        return -1.0 if t % 2 else 1.0

    i = 0
    while 2 * i + 1 < n2:
        k = 2 * i + 1
        ia[i], sa[i] = k, sgn((i + 1) // 2)
        ib[i], sb[i] = n - k, sgn(i // 2)
        ia[n - (i + 1)], sa[n - (i + 1)] = k, sgn((n - i) // 2)
        ib[n - (i + 1)], sb[n - (i + 1)] = n - k, -sgn((n - (i + 1)) // 2)
        ia[n2 - (i + 1)], sa[n2 - (i + 1)] = k + 1, sgn((n2 - i) // 2)
        ib[n2 - (i + 1)], sb[n2 - (i + 1)] = \
            n - (k + 1), -sgn((n2 - (i + 1)) // 2)
        ia[n2 + (i + 1)], sa[n2 + (i + 1)] = k + 1, sgn((n2 + i + 2) // 2)
        ib[n2 + (i + 1)], sb[n2 + (i + 1)] = \
            n - (k + 1), sgn((n2 + (i + 1)) // 2)
        i += 1
    if 2 * i + 1 == n2:
        ia[i], sa[i] = n2, sgn((i + 1) // 2)
        ib[i], sb[i] = n - n2, sgn(i // 2)
        ia[n - (i + 1)], sa[n - (i + 1)] = n2, sgn((i + 2) // 2)
        ib[n - (i + 1)], sb[n - (i + 1)] = n - n2, sgn((i + 1) // 2)
    ia[n2], sa[n2] = 0, sgn((n2 + 1) // 2)
    ib[n2], sb[n2] = 0, 0.0
    rt2 = np.sqrt(2.0)
    return pre_idx, pre_sgn, ia, sa * rt2, ib, sb * rt2


# ---------------------------------------------------------------------------
# constants on the device, made once per (size, dtype, device)
# ---------------------------------------------------------------------------

def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


@lru_cache(maxsize=None)
def _makhoul_index(n: int, inverse: bool, device) -> torch.Tensor:
    return _index(_makhoul_inv(n) if inverse else _makhoul_perm(n), device)


@lru_cache(maxsize=None)
def _quarter_twiddle(n: int, sign: int, rdtype, device):
    """(re, im) of exp(sign*i*pi*k/(2n)), k = 0..n//2: Makhoul's twiddle."""
    k = np.arange(n // 2 + 1, dtype=np.int64)
    w = np.exp(sign * 1j * np.pi * k / (2 * n))
    return (c2c_ops._const(w.real, rdtype, device),
            c2c_ops._const(w.imag, rdtype, device))


def makhoul_dct2(x: torch.Tensor, r2c: Callable, perm: torch.Tensor,
                 wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """DCT-II of real (..., n) by Makhoul: the permutation `perm`, the
    split real FFT ``r2c``, the quarter-sample twiddle (wr, wi) =
    ``_quarter_twiddle(n, -1)``, and the flip of the upper half."""
    n = x.shape[-1]
    vr, vi = r2c(x.index_select(-1, perm))
    head = 2.0 * (wr * vr - wi * vi)                             # Y[0..n//2]
    h = (n + 1) // 2
    tail = -2.0 * (wr[1:h] * vi[..., 1:h] + wi[1:h] * vr[..., 1:h])
    return torch.cat([head, tail.flip(-1)], -1)


def makhoul_dct3(y: torch.Tensor, c2r: Callable, inv: torch.Tensor,
                 wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """DCT-III of real (..., n), the exact inverse route of
    :func:`makhoul_dct2`: the half spectrum twiddled by (wr, wi) =
    ``_quarter_twiddle(n, +1)``, the split inverse real FFT ``c2r``, the
    inverse permutation `inv`."""
    n = y.shape[-1]
    re = y[..., :n // 2 + 1] * 0.5
    imt = -0.5 * y[..., n // 2 + 1:].flip(-1)
    zero = torch.zeros_like(y[..., :1])
    # even n, Nyquist bin: Im t[n/2] = -Re t[n/2] (t[n/2] = e^{-i pi/4}
    # V[n/2] with V[n/2] real)
    im = torch.cat([zero, imt] + ([-re[..., -1:]] if n % 2 == 0 else []), -1)
    v = c2r(wr * re - wi * im, wr * im + wi * re) * 2.0
    return v.index_select(-1, inv)                               # 2n irfft(V)


@lru_cache(maxsize=None)
def _dct4_twiddles(n: int, rdtype, device):
    """(wj re, wj im, wk re, wk im) of the 2n route: wj = exp(-i pi j/(2n))
    on the input, wk = exp(-i pi (2k+1)/(4n)) on the output."""
    j = np.arange(n, dtype=np.int64)
    wj = np.exp(-1j * np.pi * j / (2 * n))
    wk = np.exp(-1j * np.pi * (2 * j + 1) / (4 * n))
    return tuple(c2c_ops._const(a, rdtype, device)
                 for a in (wj.real, wj.imag, wk.real, wk.imag))


@lru_cache(maxsize=None)
def _alternating(n: int, rdtype, device) -> torch.Tensor:
    """(-1)^j, j = 0..n-1: the DST-from-DCT sign flips."""
    return c2c_ops._const((-1.0) ** np.arange(n), rdtype, device)


@lru_cache(maxsize=None)
def _odd_maps(n: int, rdtype, device):
    """``_redft11_odd_maps`` on the device: pre index and sign, then the
    two (index, signed weight) pairs of the post-step."""
    pre_idx, pre_sgn, ia, sa, ib, sb = _redft11_odd_maps(n)
    return (_index(pre_idx, device), c2c_ops._const(pre_sgn, rdtype, device),
            _index(ia, device), c2c_ops._const(sa, rdtype, device),
            _index(ib, device), c2c_ops._const(sb, rdtype, device))


@lru_cache(maxsize=None)
def _rader_consts(p: int, rdtype, device):
    """Prime-p DHT by Rader: the generator permutation of x[1..p-1], the
    gather that puts the convolution's outputs in natural order, and (re,
    im) of the cas kernel's real DFT over p-1 with 1/(p-1) folded in."""
    g = primes.find_generator(p)
    ginv = pow(g, p - 2, p)
    perm_a = np.array([pow(g, t, p) for t in range(p - 1)], np.int64)
    idx_out = np.array([pow(ginv, t, p) for t in range(p - 1)], np.int64)
    # out[idx_out[t]] = v[t]: as a gather, out[1 + s] = v[pos[s]]
    pos = np.empty(p - 1, np.int64)
    pos[idx_out - 1] = np.arange(p - 1)
    # cas kernel h[m] = cas(2*pi*g^{-m}/p): H[g^{-t}] - x[0] =
    # (x[g^.] * h)[t], a real length-(p-1) cyclic convolution
    e = np.array([pow(ginv, m, p) for m in range(p - 1)], np.int64)
    t = 2.0 * np.pi * e / p
    K = np.fft.rfft(np.cos(t) + np.sin(t)) / (p - 1)
    return (_index(perm_a, device), _index(pos, device),
            c2c_ops._const(K.real, rdtype, device),
            c2c_ops._const(K.imag, rdtype, device))


@lru_cache(maxsize=None)
def _kind_matrix(kind: str, n: int, rdtype, device) -> torch.Tensor:
    return c2c_ops._const(matrices.r2r_matrix(kind, n), rdtype, device)


# ---------------------------------------------------------------------------
# descriptor -> apply
# ---------------------------------------------------------------------------

def build_r2r(desc: Dict, rdtype, device) -> Apply:
    """Real (..., n) -> real (..., n) for an r2r descriptor tree, with its
    constants and its children on `device`."""
    alg = desc["alg"]
    n = desc["n"]
    device = torch.device(device)

    if alg == "r2r_matmul":
        M = _kind_matrix(desc["kind"], n, rdtype, device)
        return lambda x: exact_matmul(x, M)

    if alg == "dht_via_r2c":
        child = real_ops.build_r2c_split(desc["child"], rdtype, device)

        def apply_dht(x):
            yr, yi = child(x)
            head = yr - yi                                       # k = 0..n//2
            tail = (yr[..., 1:(n + 1) // 2]
                    + yi[..., 1:(n + 1) // 2]).flip(-1)          # k > n//2
            return torch.cat([head, tail], -1)
        return apply_dht

    if alg == "dht_rader":
        perm_a, pos, Kr, Ki = _rader_consts(n, rdtype, device)
        fwd = real_ops.build_r2c_split(desc["children"][0], rdtype, device)
        bwd = real_ops.build_c2r_split(desc["children"][1], rdtype, device)

        def apply_dht_rader(x):
            yr, yi = fwd(x.index_select(-1, perm_a))
            conv = bwd(*c2c_ops.cmul(yr, yi, Kr, Ki))
            v = x[..., 0:1] + conv
            return torch.cat([x.sum(-1, keepdim=True),
                              v.index_select(-1, pos)], -1)
        return apply_dht_rader

    if alg == "r2hc_via_r2c":
        child = real_ops.build_r2c_split(desc["child"], rdtype, device)

        def apply_r2hc(x):
            yr, yi = child(x)                                    # r_0..r_{n/2}
            return torch.cat([yr, yi[..., 1:(n + 1) // 2].flip(-1)], -1)
        return apply_r2hc

    if alg == "hc2r_via_c2r":
        child = real_ops.build_c2r_split(desc["child"], rdtype, device)
        nre = n // 2 + 1

        def apply_hc2r(hc):
            zero = torch.zeros_like(hc[..., :1])
            parts = [zero, hc[..., nre:].flip(-1)] + ([zero] if n % 2 == 0
                                                       else [])
            return child(hc[..., :nre], torch.cat(parts, -1))
        return apply_hc2r

    if alg in redft.KIND_OF:                                     # K8
        return redft.build_fused_redft(desc, rdtype, device)

    if alg == "redft10_half":                                    # DCT-II
        child = real_ops.build_r2c_split(desc["child"], rdtype, device)
        perm = _makhoul_index(n, False, device)
        wr, wi = _quarter_twiddle(n, -1, rdtype, device)
        return lambda x: makhoul_dct2(x, child, perm, wr, wi)

    if alg == "redft01_half":                                    # DCT-III
        child = real_ops.build_c2r_split(desc["child"], rdtype, device)
        inv = _makhoul_index(n, True, device)
        wr, wi = _quarter_twiddle(n, +1, rdtype, device)
        return lambda y: makhoul_dct3(y, child, inv, wr, wi)

    if alg == "redft00_ext":                                     # DCT-I
        child = real_ops.build_r2c_split(desc["child"], rdtype, device)

        def apply_dct1(x):
            e = torch.cat([x, x[..., 1:-1].flip(-1)], -1)        # 2(n-1)
            return child(e)[0]                                   # bins 0..n-1
        return apply_dct1

    if alg == "rodft00_ext":                                     # DST-I
        child = real_ops.build_r2c_split(desc["child"], rdtype, device)

        def apply_dst1(x):
            z = torch.zeros_like(x[..., :1])
            o = torch.cat([z, x, z, -x.flip(-1)], -1)            # 2(n+1)
            return -child(o)[1][..., 1:n + 1]
        return apply_dst1

    if alg == "redft11_2n":                                      # DCT-IV
        child = c2c_ops.build_c2c_split(desc["child"], -1, rdtype, device)
        wjr, wji, wkr, wki = _dct4_twiddles(n, rdtype, device)
        pad = torch.nn.functional.pad

        def apply_dct4(x):
            gr, gi = child(pad(x * wjr, (0, n)), pad(x * wji, (0, n)))
            return 2.0 * (wkr * gr[..., :n] - wki * gi[..., :n])
        return apply_dct4

    if alg == "redft00_split":                                   # DCT-I
        # odd n (logical size N = n-1 even): evens are a half-size DCT-I,
        # odds a half-size DCT-II, recombined by the cosine mirror
        # symmetries (reodft00e-splitradix role; ~2x less work than the
        # zero-padded route)
        h = (n - 1) // 2
        ce = build_r2r(desc["children"][0], rdtype, device)   # REDFT00, h+1
        co = build_r2r(desc["children"][1], rdtype, device)   # REDFT10, h

        def apply_dct1s(x):
            E = ce(x[..., 0::2])
            O = co(x[..., 1::2])
            zero = torch.zeros_like(O[..., :1])
            head = E + torch.cat([O, zero], -1)                  # k = 0..h
            tail = (E[..., 0:h] - O).flip(-1)                    # k = h+1..N
            return torch.cat([head, tail], -1)
        return apply_dct1s

    if alg == "rodft00_split":                                   # DST-I
        # the sine mirror of the split: interior evens are a half-size
        # DST-I, odds a half-size DST-II
        h = (n + 1) // 2
        ce = build_r2r(desc["children"][0], rdtype, device)   # RODFT00, h-1
        co = build_r2r(desc["children"][1], rdtype, device)   # RODFT10, h

        def apply_dst1s(x):
            E = ce(x[..., 1::2])
            O = co(x[..., 0::2])
            zero = torch.zeros_like(O[..., :1])
            head = torch.cat([E, zero], -1) + O                  # Y[0..h-1]
            tail = (O[..., 0:h - 1] - E).flip(-1)                # Y[h..n-1]
            return torch.cat([head, tail], -1)
        return apply_dst1s

    if alg == "redft11_odd":                                     # DCT-IV
        pre, pre_s, ia, sa, ib, sb = _odd_maps(n, rdtype, device)
        child = build_r2r(desc["child"], rdtype, device)      # R2HC, size n

        def apply_dct4o(x):
            H = child(x.index_select(-1, pre) * pre_s)
            return sa * H.index_select(-1, ia) + sb * H.index_select(-1, ib)
        return apply_dct4o

    if alg == "rodft10_flip":                                    # DST-II
        child = build_r2r(desc["child"], rdtype, device)
        sgn = _alternating(n, rdtype, device)
        return lambda x: child(x * sgn).flip(-1)

    if alg in ("rodft01_flip", "rodft11_flip"):                  # DST-III, IV
        child = build_r2r(desc["child"], rdtype, device)
        sgn = _alternating(n, rdtype, device)
        return lambda x: sgn * child(x.flip(-1))

    raise ValueError(f"unknown r2r algorithm {alg!r}")


def r2r_opcount(desc: Dict) -> Dict[str, float]:
    """(add, mul, fma) per transform, equal to the reference's."""
    alg, n = desc["alg"], desc["n"]
    if alg == "r2r_matmul":
        return {"add": float(n * n), "mul": 0.0, "fma": float(n * n)}
    if alg in ("redft00_split", "rodft00_split"):
        a = r2r_opcount(desc["children"][0])
        b = r2r_opcount(desc["children"][1])
        return {"add": a["add"] + b["add"] + 2.0 * n,
                "mul": a["mul"] + b["mul"], "fma": a["fma"] + b["fma"]}
    if alg == "dht_rader":
        a = real_ops.r2c_opcount(desc["children"][0])
        b = real_ops.c2r_opcount(desc["children"][1])
        ptwise = 6.0 * ((n - 1) // 2 + 1)      # halfcomplex pointwise mul
        return {"add": a["add"] + b["add"] + 2.0 * n,
                "mul": a["mul"] + b["mul"] + ptwise,
                "fma": a["fma"] + b["fma"]}
    if alg in ("rodft10_flip", "rodft01_flip", "rodft11_flip",
               "redft11_odd"):
        inner = r2r_opcount(desc["child"])
    elif alg == "redft11_2n":
        inner = c2c_ops.c2c_opcount(desc["child"])
    elif alg in ("redft01_half", "hc2r_via_c2r"):
        inner = real_ops.c2r_opcount(desc["child"])
    elif alg == "fused_redft10":         # the reduction's over K4's count
        inner = real_ops.r2c_opcount(dict(desc, alg="pallas_r2c"))
    elif alg == "fused_redft01":         # the reduction's over K6's count
        inner = real_ops.c2r_opcount(dict(desc, alg="pallas_c2r"))
    else:
        inner = real_ops.r2c_opcount(desc["child"])
    return {"add": inner["add"] + 2.0 * n, "mul": inner["mul"] + 2.0 * n,
            "fma": inner["fma"]}
