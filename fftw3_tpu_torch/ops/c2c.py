"""Complex-to-complex 1-D solver builders — the port of
``fftw3_tpu/ops/c2c.py``.

Each builder turns a *plan descriptor* (a JSON-able dict chosen by the
planner) into an apply closure on the last axis.  Transforms are
unnormalized; ``sign`` is FFTW_FORWARD (-1) or FFTW_BACKWARD (+1).

The core representation is **split complex**, as in the reference: every
algorithm is built as a function ``(xr, xi) -> (yr, yi)`` on real tensors,
and :func:`build_c2c_split` gives it as a pass that also takes and gives
one complex tensor (``ops/passes.py``); :func:`build_c2c` wraps it into a
complex closure.  Plan constants are computed on the host in float64
(numpy), cast to the plan's real dtype and moved to the plan's device once,
when the closure is built.

Solvers: ``nop``, ``direct`` (one dense DFT-matrix product), ``mixed``
(one Cooley-Tukey stage plus a child), ``pallas`` (the fused Stockham
kernel, ops/stockham.py), ``pallas4`` (the four-step over the axis -2 and
last-axis kernels, ops/fourstep.py), ``rader``, ``bluestein`` and ``xla``,
which is ``torch.fft`` here: a competitor MEASURE may time, as the reference
times XLA's FFT; and the double-float tier of complex128 plans, ``df32``
and ``df32p`` (the fused kernel K7), ops/df32.py.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..utils import primes
from . import matrices, passes
from .dense import exact_matmul

Apply = Callable[[torch.Tensor], torch.Tensor]
SplitApply = Callable[[torch.Tensor, torch.Tensor],
                      Tuple[torch.Tensor, torch.Tensor]]


def complex_dtype(rdtype) -> torch.dtype:
    return torch.complex64 if np.dtype(rdtype) == np.float32 \
        else torch.complex128


def _const(a: np.ndarray, rdtype, device) -> torch.Tensor:
    """A host f64 constant as a tensor of the plan's real dtype on its
    device (rounded once on the host, as the reference rounds it)."""
    a = np.ascontiguousarray(a, dtype=np.dtype(rdtype))
    return torch.from_numpy(a).to(device)


def cmatmul(xr, xi, Fr, Fi):
    """Karatsuba complex matmul: 3 real matmuls instead of 4, at full
    precision (``dense.exact_matmul``).

    (xr + i xi)(Fr + i Fi): t1 = xr@Fr, t2 = xi@Fi,
    t3 = (xr+xi)@(Fr+Fi); yr = t1-t2, yi = t3-t1-t2.
    """
    t1 = exact_matmul(xr, Fr)
    t2 = exact_matmul(xi, Fi)
    t3 = exact_matmul(xr + xi, Fr + Fi)
    return t1 - t2, t3 - t1 - t2


def cmul(ar, ai, br, bi):
    """Pointwise complex multiply in split form."""
    return ar * br - ai * bi, ar * bi + ai * br


def build_c2c(desc: Dict, sign: int, rdtype, device) -> Apply:
    """Complex-in/complex-out wrapper over the split-core builder."""
    split = build_c2c_split(desc, sign, rdtype, device)
    if desc["alg"] == "nop" or desc["n"] == 1:
        return lambda x: x

    def apply(x):
        yr, yi = split(x.real, x.imag)
        return torch.complex(yr, yi)
    return apply


def build_c2c_split(desc: Dict, sign: int, rdtype, device) -> SplitApply:
    """The pass of a c2c descriptor tree: ``apply(xr, xi=None, cout=False)``
    (``ops/passes.py``), on split planes or one complex tensor.  A ``pallas``
    descriptor's kernel takes both layouts itself; every other solver runs
    on split planes behind :func:`passes.split_pass`."""
    if desc["alg"] == "pallas" and desc["n"] != 1:
        from . import stockham
        return stockham.build_pallas_c2c_split(desc, sign, rdtype, device)
    return passes.split_pass(_split_apply(desc, sign, rdtype, device))


def _split_apply(desc: Dict, sign: int, rdtype, device) -> SplitApply:
    """The split-complex apply closure of a c2c descriptor tree (every alg
    but ``pallas``): ``(xr, xi) -> (yr, yi)``."""
    alg = desc["alg"]
    n = desc["n"]
    rdtype = np.dtype(rdtype)
    device = torch.device(device)

    if alg == "nop" or n == 1:
        return lambda xr, xi: (xr, xi)

    if alg == "direct":
        F = matrices.dft_matrix(n, sign)
        Fr = _const(F.real, rdtype, device)
        Fi = _const(F.imag, rdtype, device)
        return lambda xr, xi: cmatmul(xr, xi, Fr, Fi)

    if alg == "mixed":
        p = desc["p"]
        q = n // p
        tw = matrices.twiddle_2d(p, q, sign)
        twr = _const(tw.real, rdtype, device)
        twi = _const(tw.imag, rdtype, device)
        child = build_c2c_split(desc["child"], sign, rdtype, device)

        def finish(yr, yi, shp):
            zr, zi = child(yr, yi)                              # along q
            zr = zr.transpose(-1, -2).reshape(*shp, n)
            zi = zi.transpose(-1, -2).reshape(*shp, n)
            return zr, zi

        if p <= 8:
            # small radix: an explicit butterfly over axis -2 with scalar
            # complex coefficients and the twiddle row fused in, no
            # transposes before the child (the reference's p <= 8 form)
            F = matrices.dft_matrix(p, sign)

            def apply_mixed_bfly(xr, xi):
                shp = xr.shape[:-1]
                xr = xr.reshape(*shp, p, q)
                xi = xi.reshape(*shp, p, q)
                xs = [(xr[..., j, :], xi[..., j, :]) for j in range(p)]
                outs = []
                for k in range(p):
                    ar = 0.0
                    ai = 0.0
                    for j in range(p):
                        cr, ci = float(F[j, k].real), float(F[j, k].imag)
                        br, bi = xs[j]
                        if cr:
                            ar = ar + (br if cr == 1.0 else
                                       -br if cr == -1.0 else cr * br)
                            ai = ai + (bi if cr == 1.0 else
                                       -bi if cr == -1.0 else cr * bi)
                        if ci:
                            ar = ar - (bi if ci == 1.0 else
                                       -bi if ci == -1.0 else ci * bi)
                            ai = ai + (br if ci == 1.0 else
                                       -br if ci == -1.0 else ci * br)
                    wr, wi = twr[k], twi[k]
                    outs.append((ar * wr - ai * wi, ar * wi + ai * wr))
                yr = torch.stack([o[0] for o in outs], dim=-2)
                yi = torch.stack([o[1] for o in outs], dim=-2)
                return finish(yr, yi, shp)
            return apply_mixed_bfly

        F = matrices.dft_matrix(p, sign)
        # transposed, so that M @ a contracts the p axis of (..., p, q)
        Fr = _const(F.real.T, rdtype, device)
        Fi = _const(F.imag.T, rdtype, device)
        FrFi = Fr + Fi

        def dotp(a, M):
            # contract the p axis in place
            return exact_matmul(M, a)

        def apply_mixed(xr, xi):
            shp = xr.shape[:-1]
            xr = xr.reshape(*shp, p, q)
            xi = xi.reshape(*shp, p, q)
            t1 = dotp(xr, Fr)
            t2 = dotp(xi, Fi)
            t3 = dotp(xr + xi, FrFi)
            yr, yi = cmul(t1 - t2, t3 - t1 - t2, twr, twi)
            return finish(yr, yi, shp)
        return apply_mixed

    if alg == "pallas4":
        from . import fourstep
        return fourstep.build_pallas_c2c_split_fourstep(desc, sign, rdtype,
                                                        device)

    if alg == "df32":
        from . import df32
        return df32.build_df32_c2c_split(desc, sign, rdtype, device)

    if alg == "df32p":
        from . import df32
        return df32.build_df32_pallas_split(desc, sign, rdtype, device)

    if alg == "bluestein":
        m = desc["m"]
        c = matrices.chirp(n, sign)                 # host f64
        v = np.zeros(m, np.complex128)
        v[:n] = np.conj(c)
        v[m - n + 1:] = np.conj(c[1:])[::-1]
        fwd = build_c2c_split(desc["child"], -1, rdtype, device)
        bwd = build_c2c_split(desc["child"], +1, rdtype, device)
        V = np.fft.fft(v) / m                       # fold 1/m into kernel
        Vr = _const(V.real, rdtype, device)
        Vi = _const(V.imag, rdtype, device)
        cr = _const(c.real, rdtype, device)
        ci = _const(c.imag, rdtype, device)

        def apply_bluestein(xr, xi):
            ur, ui = cmul(xr, xi, cr, ci)
            pad = (0, m - n)
            Ur, Ui = fwd(torch.nn.functional.pad(ur, pad),
                         torch.nn.functional.pad(ui, pad))
            sr, si = bwd(*cmul(Ur, Ui, Vr, Vi))
            return cmul(sr[..., :n], si[..., :n], cr, ci)
        return apply_bluestein

    if alg == "rader":
        p = n
        g = primes.find_generator(p)
        ginv = pow(g, p - 2, p)
        perm_a = torch.tensor([pow(g, t, p) for t in range(p - 1)],
                              device=device)
        idx_out = torch.tensor([pow(ginv, t, p) for t in range(p - 1)],
                               device=device)
        # b[j] = w^{g^{-j}}, exact integer exponents
        e = np.array([pow(ginv, t, p) for t in range(p - 1)], np.int64)
        b = np.exp(sign * 2j * np.pi * e / p)
        fwd = build_c2c_split(desc["child"], -1, rdtype, device)
        bwd = build_c2c_split(desc["child"], +1, rdtype, device)
        B = np.fft.fft(b) / (p - 1)
        Br = _const(B.real, rdtype, device)
        Bi = _const(B.imag, rdtype, device)

        def apply_rader(xr, xi):
            Ar, Ai = fwd(xr[..., perm_a], xi[..., perm_a])
            convr, convi = bwd(*cmul(Ar, Ai, Br, Bi))
            outr = torch.empty_like(xr)
            outi = torch.empty_like(xi)
            outr[..., idx_out] = xr[..., 0:1] + convr
            outi[..., idx_out] = xi[..., 0:1] + convi
            outr[..., 0] = torch.sum(xr, dim=-1)
            outi[..., 0] = torch.sum(xi, dim=-1)
            return outr, outi
        return apply_rader

    if alg == "xla":
        # torch.fft (cuFFT on the card) as the competitor solver
        if sign == -1:
            def apply_xf(xr, xi):
                y = torch.fft.fft(torch.complex(xr, xi), dim=-1)
                return y.real, y.imag
            return apply_xf

        def apply_xb(xr, xi):
            y = torch.fft.ifft(torch.complex(xr, xi), dim=-1, norm="forward")
            return y.real, y.imag
        return apply_xb

    raise ValueError(f"unknown c2c algorithm {alg!r}")


# ---------------------------------------------------------------------------
# Op counts per transform (for plan.flops(), analog of the codelet desc
# opcounts consumed by fftw_flops).  Counts are for one 1-D transform, in
# real operations, and equal the reference's for every ported alg.
# ---------------------------------------------------------------------------

def _vpu_stage_opcount(p: int) -> tuple:
    """(real adds, real muls) of ONE size-p butterfly DFT
    (stockham._vpu_dft): radix-4 butterflies are 16 real adds per 4-point
    column (radix-2: 4; radix-5: 32 adds + 16 rotation muls; radix-3:
    12 + 4); level twiddles cost 4 mul + 2 add each except the ones snapped
    to +-1/+-i."""
    if p == 1:
        return (0.0, 0.0)
    if p % 4 == 0:
        r = 4
    elif p % 2 == 0:
        r = 2
    elif p % 5 == 0:
        r = 5
    else:
        r = 3
    q = p // r
    add = {4: 16.0, 2: 4.0, 5: 32.0, 3: 12.0}[r] * q
    mul = {4: 0.0, 2: 0.0, 5: 16.0, 3: 4.0}[r] * q
    if q > 1:
        for k1 in range(1, r):
            for j2 in range(q):
                w = np.exp(-2j * np.pi * ((j2 * k1) % p) / p)
                if min(abs(w - e) for e in (1, -1, 1j, -1j)) >= 1e-12:
                    mul += 4.0
                    add += 2.0
    ca, cm = _vpu_stage_opcount(q)
    return (add + r * ca, mul + r * cm)


def c2c_opcount(desc: Dict) -> Dict[str, float]:
    alg, n = desc["alg"], desc["n"]
    if alg == "nop" or n == 1:
        return {"add": 0.0, "mul": 0.0, "fma": 0.0}
    if alg in ("direct", "xla"):
        # Karatsuba complex matmul: 3 real matmuls of n^2 MACs
        return {"add": 3.0 * n * n, "mul": 0.0, "fma": 3.0 * n * n}
    if alg == "mixed":
        p = desc["p"]
        q = n // p
        child = c2c_opcount(desc["child"])
        return {
            "add": 3.0 * p * p * q + p * child["add"],
            "mul": 6.0 * n + p * child["mul"],          # twiddle mult
            "fma": 3.0 * p * p * q + p * child["fma"],
        }
    if alg == "pallas":
        # the stacked-G stage form: one (2p, 2p) @ (2p, n/p) real
        # contraction per stage -> 4*p*n MACs, plus the complex twiddle
        # (4 mul + 2 add per point) on every stage but the last; a stage
        # the descriptor's "vpu" key puts on butterflies counts their adds
        # and non-snapped level-twiddle muls instead
        from . import stockham

        total = {"add": 0.0, "mul": 0.0, "fma": 0.0}
        rest = n
        last = len(desc["radices"]) - 1
        vpu = desc.get("vpu")
        for si, p in enumerate(desc["radices"]):
            q = rest // p
            if (vpu and (si == last or vpu == "all")
                    and stockham.vpu_last_ok(p, 1)):
                a, m = _vpu_stage_opcount(p)
                total["add"] += a * (n / p)
                total["mul"] += m * (n / p)
            else:
                total["fma"] += 4.0 * p * n
            if q > 1:
                total["mul"] += 4.0 * n
                total["add"] += 2.0 * n
            rest = q
        return total
    if alg == "pallas4":
        # inner axis pass over p + pretwiddled outer pass over q, each with
        # its own radix schedule (exact per the stacked-G form)
        from . import stockham
        total = {"add": 0.0, "mul": 4.0 * n, "fma": 0.0}   # four-step tw
        total["add"] += 2.0 * n
        for f in (desc["p"], desc["q"]):
            rest = f
            for r in stockham.choose_radices(f):
                q2 = rest // r
                total["fma"] += 4.0 * r * n       # (n/f)*4*r*f MACs
                if q2 > 1:
                    total["mul"] += 4.0 * n
                    total["add"] += 2.0 * n
                rest = q2
        return total
    if alg == "bluestein":
        child = c2c_opcount(desc["child"])
        return {
            "add": 2 * child["add"] + 2.0 * desc["m"],
            "mul": 2 * child["mul"] + 6.0 * (2 * desc["n"] + desc["m"]),
            "fma": 2 * child["fma"],
        }
    if alg == "rader":
        child = c2c_opcount(desc["child"])
        return {
            "add": 2 * child["add"] + 4.0 * n,
            "mul": 2 * child["mul"] + 6.0 * n,
            "fma": 2 * child["fma"],
        }
    if alg == "df32":
        # f32 ops of the double-float pipeline (df add = 11 real adds; df
        # mul = 9 mul + 12 add; complex df mul = 4 df mul + 2 df add): per
        # stage n(p-1) complex df adds, plus (p-1)^2 dense butterfly
        # products per group for p not in {2, 4} (whose +-1/+-i
        # coefficients are free), plus p-1 twiddle products per group
        total = {"add": 0.0, "mul": 0.0, "fma": 0.0}
        for p in desc["radices"]:
            g = n / p
            cmul = g * ((0 if p in (2, 4) else (p - 1) ** 2) + (p - 1))
            cadd = n * (p - 1)
            total["add"] += cadd * 22.0 + cmul * 70.0
            total["mul"] += cmul * 36.0
        return total
    if alg == "df32p":
        # the fused df kernel: the butterfly stage counts mapped to df
        # costs (add -> df add, 11 f32 adds; cmul -> df cmul, 36 mul + 70
        # add), plus the stage twiddle as one df cmul per point on every
        # stage but the last
        total = {"add": 0.0, "mul": 0.0, "fma": 0.0}
        rest = n
        for p in desc["radices"]:
            q = rest // p
            a, m = _vpu_stage_opcount(p)
            cm = m / 4.0
            total["add"] += (a * 11.0 + cm * 70.0) * (n / p)
            total["mul"] += cm * 36.0 * (n / p)
            if q > 1:
                total["add"] += 70.0 * n
                total["mul"] += 36.0 * n
            rest = q
        return total
    raise ValueError(alg)
