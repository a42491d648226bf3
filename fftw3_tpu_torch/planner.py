"""The planner: cost-driven algorithm search with persistent wisdom — the
port of ``fftw3_tpu/planner.py`` (c2c, r2c, c2r and the eleven r2r kinds),
the double-float candidates of complex128 plans included.

A memoized recursive search over the registered c2c, r2c, c2r and r2r
solvers,
with an ESTIMATE cost model, a MEASURE mode that times built candidates on
the plan's device, the patience ladder, and JSON wisdom memoizing results per
(kind, n, dtype, device, batch bucket).  The search is the reference's,
line for line, so that with the reference's hardware constants both
packages pick the same descriptors; what differs is the device (a plan's
``device``, not a global backend) and the absence of a native C++ search.

The *plan descriptor* is a JSON-able dict tree; builders in ``ops/`` turn a
descriptor into an apply closure.  Descriptors are the unit of wisdom, and
:func:`import_reference_wisdom` carries a ``fftw3_tpu`` wisdom export over.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import config
from . import kinds as K
from .ops import c2c as c2c_ops
from .ops import df32
from .ops import r2r as r2r_ops
from .ops import real as real_ops
from .ops import real_stockham, redft, stockham
from .utils import primes

# ---------------------------------------------------------------------------
# Hardware model for the ESTIMATE cost heuristic.  Only *relative* accuracy
# matters (MEASURE corrects the rest).
# ---------------------------------------------------------------------------


@dataclass
class HardwareModel:
    """Defaults: one H100 SXM from NVIDIA's data sheet — 3.35e12 B/s of
    HBM3 and 67 TFLOP/s of FP32 outside the tensor cores.  Everything else
    is guessed, not measured and not fitted: that the FP32 rate serves the
    elementwise terms (``vpu_flops``) as well as the contractions,
    ``mxu_k`` (the contraction width below which a matmul term is charged
    as underfilled) and ``gather_penalty``.  They decide the kernel's place
    off n = 1024: with ``mxu_k = 32`` ESTIMATE leaves the kernel for
    ``mixed`` at n in {192, 200, 240, 256}, and with 128 it keeps the
    kernel at every n in [MIN_N, MAX_N].  PERF.md holds the chip timings of
    both choices at 192, 256 and 512; a fit on the card is ROADMAP work."""
    hbm_bw: float = 3.35e12         # bytes/s
    peak_flops: float = 6.7e13      # f32 flops/s, contraction terms
    vpu_flops: float = 6.7e13       # f32 flops/s, elementwise terms
    mxu_k: int = 32                 # contraction width at full rate
    gather_penalty: float = 4.0     # gathers/scatters relative to streams

    def matmul_eff(self, k: int) -> float:
        """Efficiency of a contraction of width k."""
        return min(k, self.mxu_k) / self.mxu_k


HW = HardwareModel()

#: Largest leaf DFT-matrix size the planner will consider "direct".
DIRECT_MAX = 128
#: Cap for the O(n^2) last-resort dense solver (dft-generic analog).
GENERIC_MAX = 2048
#: Cap for the dense real solvers (``r2c_dense``/``c2r_dense``) and the dense
#: r2r kind matrix (``r2r_matmul``), the reference's value.
R2R_GENERIC_MAX = 4096

#: f64 slowdowns of the reference's cost model, kept so that complex128
#: searches rank as the reference ranks them.
_F64_MXU_PENALTY = 200.0
_F64_VPU_PENALTY = 8.0


def _c2c_cost(desc: Dict, hw: HardwareModel = HW, f64: bool = False) -> float:
    """Estimated seconds per single 1-D transform (batch-amortized)."""
    alg, n = desc["alg"], desc["n"]
    el = 16.0 if f64 else 8.0  # complex bytes
    mxu = hw.peak_flops / (_F64_MXU_PENALTY if f64 else 1.0)
    vpu = hw.vpu_flops / (_F64_VPU_PENALTY if f64 else 1.0)
    if alg == "nop" or n == 1:
        return 0.0
    if alg == "df32":
        # double-float pipeline: per stage one elementwise HBM sweep of the
        # four f32 planes plus the df butterfly/twiddle chains (f32 whatever
        # the plan dtype: the point of the tier)
        t = 0.0
        for p in desc["radices"]:
            per_pt = 260.0 if p in (2, 4) else 170.0 * p
            t += 32.0 * n / hw.hbm_bw + per_pt * n / hw.vpu_flops
        return t
    if alg == "df32p":
        # fused df kernel: one HBM pass, df butterfly/twiddle chains per
        # stage (f32 whatever the plan dtype)
        t = 1.25 * 2 * el * n / hw.hbm_bw
        for p in desc["radices"]:
            t += 60.0 * math.log2(max(p, 2)) * n / hw.vpu_flops
        return t
    if alg == "direct":
        bytes_moved = 2 * el * n
        flops = 8.0 * n * n
        return bytes_moved / hw.hbm_bw + flops / (mxu *
                                                  hw.matmul_eff(n))
    if alg == "mixed":
        p = desc["p"]
        # a staged pass pays ~2 HBM round trips (contraction in/out plus
        # the final axis swap)
        stage = (4 * el * n / hw.hbm_bw
                 + 8.0 * p * n / (mxu * hw.matmul_eff(p))
                 + 6.0 * n / vpu)
        return stage + p * _c2c_cost(desc["child"], hw, f64)
    if alg == "bluestein":
        m = desc["m"]
        extra = 6.0 * el * m / hw.hbm_bw + 12.0 * m / vpu
        return 2 * _c2c_cost(desc["child"], hw, f64) + extra
    if alg == "rader":
        extra = hw.gather_penalty * 4 * el * n / hw.hbm_bw
        return 2 * _c2c_cost(desc["child"], hw, f64) + 6.0 * n / vpu + extra
    if alg == "xla":
        # a generic log-n pipeline; MEASURE decides its real worth
        return (2 * el * n * max(1.0, math.log2(n)) / hw.hbm_bw
                * (8.0 if f64 else 1.0))
    if alg == "pallas":
        # fused kernel: ONE HBM pass for the whole pipeline, plus the
        # contraction time of each stage
        t = 1.25 * 2 * el * n / hw.hbm_bw
        for p in desc["radices"]:
            t += 6.0 * p * n / (hw.peak_flops * hw.matmul_eff(p))
        return t
    if alg == "pallas4":
        # four-step composition: three HBM passes (two kernels + the output
        # transpose) plus the contraction time of each kernel's schedule
        t = 3.3 * 2 * el * n / hw.hbm_bw
        for f in (desc["p"], desc["q"]):
            for r in stockham.choose_radices(f):
                t += 6.0 * r * n / (hw.peak_flops * hw.matmul_eff(r))
        return t
    raise ValueError(alg)


def _model_cost(kind: str, desc: Dict, hw: HardwareModel = HW,
                f64: bool = False) -> float:
    """Estimated seconds per single 1-D transform of a `kind` descriptor:
    :func:`_c2c_cost` for c2c, the reference's r2c/c2r formulas, and
    :func:`_r2r_cost` for every other kind."""
    if kind == "c2c":
        return _c2c_cost(desc, hw, f64)
    if kind not in ("r2c", "c2r"):
        return _r2r_cost(desc, hw, f64)
    alg, n = desc["alg"], desc["n"]
    if alg in ("pallas_r2c", "pallas_c2r"):
        # one fused pass plus the contraction time of the m-point stages
        m = n // 2
        t = 1.1 * 8.0 * n / hw.hbm_bw
        for p in desc["radices"]:
            t += 6.0 * p * m / (hw.peak_flops * hw.matmul_eff(p))
        return t
    if alg in ("r2c_dense", "c2r_dense"):
        mxu = hw.peak_flops / (_F64_MXU_PENALTY if f64 else 1.0)
        return (12.0 * n / hw.hbm_bw
                + 2.0 * n * (n // 2 + 1) / (mxu * hw.matmul_eff(n)))
    if alg in ("r2c_pack", "c2r_pack"):
        # half-size complex child plus a separate untangle pass
        return 0.55 * _c2c_cost(desc["child"], hw, f64) + 16.0 * n / hw.hbm_bw
    if alg in ("r2c_via_c2c", "c2r_via_c2c"):
        return _c2c_cost(desc["child"], hw, f64) + 16.0 * n / hw.hbm_bw
    raise ValueError(alg)


#: the kind of each r2r reduction's child
_R2R_CHILD = {"dht_via_r2c": "r2c", "r2hc_via_r2c": "r2c",
              "hc2r_via_c2r": "c2r", "redft10_half": "r2c",
              "redft01_half": "c2r", "redft00_ext": "r2c",
              "rodft00_ext": "r2c", "redft11_2n": "c2c",
              "rodft10_flip": "redft10", "rodft01_flip": "redft01",
              "rodft11_flip": "redft11", "redft11_odd": "r2hc"}


def _r2r_cost(desc: Dict, hw: HardwareModel = HW, f64: bool = False
              ) -> float:
    """The reference's r2r formulas: the dense kind matrix, or a child's
    cost plus the reduction's passes (two for a real child, one for an r2r
    child)."""
    alg, n = desc["alg"], desc["n"]
    if alg == "r2r_matmul":
        mxu = hw.peak_flops / (_F64_MXU_PENALTY if f64 else 1.0)
        return 8.0 * n / hw.hbm_bw + 2.0 * n * n / (mxu * hw.matmul_eff(n))
    if alg in redft.KIND_OF:
        # K8, one fused pass: the bytes of a read and a write, and FFTW's
        # flops of the transform
        return (1.1 * 8.0 * n / hw.hbm_bw
                + 2.5 * n * math.log2(n) / hw.vpu_flops)
    if alg in ("redft00_split", "rodft00_split"):
        # two half-size r2r children + one recombination pass
        return (_r2r_cost(desc["children"][0], hw, f64)
                + _r2r_cost(desc["children"][1], hw, f64)
                + 8.0 * n / hw.hbm_bw)
    if alg == "dht_rader":
        # real convolution children + permute/pointwise passes
        return (_model_cost("r2c", desc["children"][0], hw, f64)
                + _model_cost("c2r", desc["children"][1], hw, f64)
                + 16.0 * n / hw.hbm_bw)
    child = _R2R_CHILD[alg]
    if child not in ("c2c", "r2c", "c2r"):
        return _r2r_cost(desc["child"], hw, f64) + 8.0 * n / hw.hbm_bw
    return _model_cost(child, desc["child"], hw, f64) + 16.0 * n / hw.hbm_bw


def _mixed_factor_candidates(n: int, patience: int) -> List[int]:
    """Divisor choices p<=DIRECT_MAX for one Cooley-Tukey split, best first:
    p close to sqrt(n) first, then larger p (fftw_choose_radix's role)."""
    divs = [d for d in primes.divisors(n) if 2 <= d <= DIRECT_MAX and d != n]
    if not divs:
        return []

    def rank(p):
        balance = abs(math.log2(p * p / n))
        return (balance, -p)
    divs.sort(key=rank)
    width = {K.PATIENCE_ESTIMATE: 3, K.PATIENCE_MEASURE: 4,
             K.PATIENCE_PATIENT: 8, K.PATIENCE_EXHAUSTIVE: 64}[patience]
    return divs[:width]


#: the r2r kinds' names, as wisdom keys and descriptors spell them
R2R_KIND_NAMES = tuple(k.value for k in K.R2R_KINDS)
#: problem kinds with solvers in this package
KINDS = ("c2c", "r2c", "c2r") + R2R_KIND_NAMES

#: wisdom format of this package.  Keys carry the batch bucket (":b<N>").
WISDOM_FORMAT = "fftw3-tpu-torch-wisdom-1"
#: the ``fftw3_tpu`` export format that :func:`import_reference_wisdom` reads
REFERENCE_WISDOM_FORMAT = "fftw3-tpu-wisdom-2"
#: descriptor keys that only the reference's TPU kernels read: its bf16
#: hi/lo stage arithmetic, the axis -2 form's VMEM budget, its padding
#: variant and the real kernels' double-lane-width variant
_TPU_ONLY_KEYS = ("k2", "gsplit", "inner_area", "pad_align", "merge")


class WisdomOnlyMiss(ValueError):
    """FFTW_WISDOM_ONLY requested but no wisdom covers a subproblem
    (the reference returns NULL from the planner; fftw3.h:487)."""


class Planner:
    """Singleton-style planner with wisdom (fftw_the_planner analog)."""

    def __init__(self, hw: HardwareModel = HW):
        self.hw = hw
        self.wisdom: Dict[str, Dict] = {}
        #: FFTW_WISDOM_ONLY mode: accept any wisdom hit, never search
        self.wisdom_only = False
        self.timelimit: Optional[float] = None
        #: let MEASURE also time torch.fft (the ``xla`` alg) as a
        #: competitor solver; off by default, as in the reference
        self.allow_xla = False
        self._measure_t0: float = 0.0
        self._measure_truncated = False
        self.stats = {"nplan": 0, "nmeasure": 0, "nwisdom_hit": 0,
                      "nmeasure_failed": 0}
        #: hook called with (key, desc, cost) on every planned subproblem:
        #: the instrumentation point of paranoid verification
        #: (``harness/paranoid.py``; FFTW's planner->hook)
        self.hook: Optional[Callable[[str, Dict, float], None]] = None

    # -- wisdom keys ------------------------------------------------------
    def _key(self, kind: str, n: int, rdtype, batch: Optional[int],
             device) -> str:
        re_tag = "" if config.random_estimator is None \
            else f":re{config.random_estimator}"
        return (re_tag + f"{kind}:{n}:{np.dtype(rdtype).name}:"
                f"{_device_signature(device)}:b{_batch_bucket(batch)}")

    # -- public entry point -------------------------------------------------
    # `batch` is the number of independent transforms per call; MEASURE
    # times at the caller's batch and wisdom is bucketed by it.
    def plan_c2c(self, n: int, rdtype, patience: int,
                 batch: Optional[int] = None, device=None) -> Dict:
        return self._plan("c2c", n, rdtype, patience, batch, device)

    def plan_r2c(self, n: int, rdtype, patience: int,
                 batch: Optional[int] = None, device=None) -> Dict:
        return self._plan("r2c", n, rdtype, patience, batch, device)

    def plan_c2r(self, n: int, rdtype, patience: int,
                 batch: Optional[int] = None, device=None) -> Dict:
        return self._plan("c2r", n, rdtype, patience, batch, device)

    def plan_r2r(self, kind: K.Kind, n: int, rdtype, patience: int,
                 batch: Optional[int] = None, device=None) -> Dict:
        return self._plan(K.kind_from_name(kind).value, n, rdtype, patience,
                          batch, device)

    # -- core search --------------------------------------------------------
    def _plan(self, kind: str, n: int, rdtype, patience: int,
              batch: Optional[int] = None, device=None) -> Dict:
        if kind not in KINDS:
            raise ValueError(f"unknown transform kind {kind!r}")
        device = torch.device(config.device if device is None else device)
        key = self._key(kind, n, rdtype, batch, device)
        hit = self.wisdom.get(key)
        # malformed wisdom falls through to the recovery rung, not KeyError
        if not isinstance(hit, dict):
            if hit is not None:
                del self.wisdom[key]
                self.stats["nbogus"] = self.stats.get("nbogus", 0) + 1
            hit = None
        if hit is not None and (self.wisdom_only
                                or (hit.get("patience", -1) >= patience
                                    and self._budget_subsumes(hit,
                                                              patience))):
            # wisdom-bogosity recovery rung 1: a structurally invalid entry
            # is dropped and planning falls through to a fresh search
            if validate_desc(kind, n, hit.get("desc")):
                self.stats["nwisdom_hit"] += 1
                return hit["desc"]
            del self.wisdom[key]
            self.stats["nbogus"] = self.stats.get("nbogus", 0) + 1
        if self.wisdom_only:
            raise WisdomOnlyMiss(
                f"FFTW_WISDOM_ONLY: no wisdom for {kind} n={n}")
        self.stats["nplan"] += 1
        f64 = np.dtype(rdtype) == np.float64
        cands = self._candidates(kind, n, rdtype, patience, batch, device)
        if not cands:
            raise ValueError(f"no applicable solver for {kind} n={n}")
        if patience == K.PATIENCE_ESTIMATE or len(cands) == 1:
            best = min(cands, key=lambda d: self._cost(kind, d, f64))
            cost = self._cost(kind, best, f64)
            self.stats["epcost"] = self.stats.get("epcost", 0.0) + cost
        else:
            self._measure_t0 = time.perf_counter()
            best, cost = self._measure_best(kind, n, rdtype, cands, batch,
                                            device)
        # planner counters (nplan/pcost/epcost, FFTW's planner fields)
        self.stats["pcost"] = self.stats.get("pcost", 0.0) + cost
        entry = {"desc": best, "patience": patience, "cost": cost}
        if self._measure_truncated:
            # a truncated search records its budget so a later request
            # with a larger (or no) timelimit re-searches
            entry["budget"] = self.timelimit
        self._measure_truncated = False
        self.wisdom[key] = entry
        if self.hook is not None:
            self.hook(key, best, cost)
        return best

    def _budget_subsumes(self, hit: Dict, patience: int) -> bool:
        """Does the wisdom entry's search budget cover this request?"""
        if patience < K.PATIENCE_MEASURE:
            return True                # ESTIMATE requests never time
        b = hit.get("budget")
        if b is None:
            return True
        return self.timelimit is not None and self.timelimit <= b

    def _candidates(self, kind: str, n: int, rdtype, patience: int,
                    batch: Optional[int], device) -> List[Dict]:
        if kind == "c2c":
            return self._candidates_c2c(n, rdtype, patience, batch, device)
        if kind not in ("r2c", "c2r"):
            return self._candidates_r2r(kind, n, rdtype, patience, batch,
                                        device)
        # r2c and c2r: the real kernel, the dense matrices, the half-size
        # pack and the complex embedding, as in the reference
        out: List[Dict] = []
        if real_stockham.r2c_applicable(n, rdtype, device):
            out.append({"alg": f"pallas_{kind}", "n": n,
                        "radices": stockham.choose_radices(n // 2)})
        if n <= R2R_GENERIC_MAX:
            out.append({"alg": f"{kind}_dense", "n": n})
        if n % 2 == 0 and n > 2:
            out.append({"alg": f"{kind}_pack", "n": n,
                        "child": self.plan_c2c(n // 2, rdtype, patience,
                                               batch, device)})
        out.append({"alg": f"{kind}_via_c2c", "n": n,
                    "child": self.plan_c2c(n, rdtype, patience, batch,
                                           device)})
        return out

    def _candidates_r2r(self, kind: str, n: int, rdtype, patience: int,
                        batch: Optional[int], device) -> List[Dict]:
        """The reference's r2r candidates, in its order: each kind's
        reductions to r2c/c2r/c2c (or to another r2r kind), children
        planned at the same patience and batch, then the dense kind matrix
        up to R2R_GENERIC_MAX; on a CUDA device the port's fused DCT-II
        and DCT-III (K8) first, where its gate holds."""
        def sub(child_kind, m):
            return self._plan(child_kind, m, rdtype, patience, batch, device)

        out: List[Dict] = []
        if kind == "dht":
            out.append({"alg": "dht_via_r2c", "n": n,
                        "child": sub("r2c", n)})
            if n >= 5 and primes.is_prime(n):
                # the length-(n-1) convolution stays real, racing the
                # via-r2c route whose prime child pays a complex Rader or
                # Bluestein
                out.append({"alg": "dht_rader", "n": n, "children": [
                    sub("r2c", n - 1), sub("c2r", n - 1)]})
        elif kind == "r2hc":
            out.append({"alg": "r2hc_via_r2c", "n": n,
                        "child": sub("r2c", n)})
        elif kind == "hc2r":
            out.append({"alg": "hc2r_via_c2r", "n": n,
                        "child": sub("c2r", n)})
        elif kind in ("redft10", "redft01"):
            if redft.applicable(n, rdtype, device):
                # the port's own: K8 on a CUDA device
                out.append({"alg": f"fused_{kind}", "n": n,
                            "radices": stockham.choose_radices(n // 2)})
            if kind == "redft10":
                out.append({"alg": "redft10_half", "n": n,
                            "child": sub("r2c", n)})
            else:
                out.append({"alg": "redft01_half", "n": n,
                            "child": sub("c2r", n)})
        elif kind == "redft00" and n > 1:
            out.append({"alg": "redft00_ext", "n": n,
                        "child": sub("r2c", 2 * (n - 1))})
            if n % 2 == 1 and n >= 5:
                # split-radix: evens -> DCT-I of (n+1)/2, odds -> DCT-II of
                # (n-1)/2; ~2x less work
                out.append({"alg": "redft00_split", "n": n, "children": [
                    sub("redft00", (n + 1) // 2),
                    sub("redft10", (n - 1) // 2)]})
        elif kind == "rodft00":
            out.append({"alg": "rodft00_ext", "n": n,
                        "child": sub("r2c", 2 * (n + 1))})
            if n % 2 == 1 and n >= 5:
                out.append({"alg": "rodft00_split", "n": n, "children": [
                    sub("rodft00", (n - 1) // 2),
                    sub("rodft10", (n + 1) // 2)]})
        elif kind == "redft11":
            out.append({"alg": "redft11_2n", "n": n,
                        "child": sub("c2c", 2 * n)})
            if n % 2 == 1:
                # odd n: one same-size R2HC through the 8n PFA signed
                # permutations; 2x less work than the 2n route
                out.append({"alg": "redft11_odd", "n": n,
                            "child": sub("r2hc", n)})
        elif kind in ("rodft10", "rodft01", "rodft11"):
            dct = "redft" + kind[5:]
            out.append({"alg": f"{kind}_flip", "n": n,
                        "child": sub(dct, n)})
        if n <= R2R_GENERIC_MAX:
            out.append({"alg": "r2r_matmul", "kind": kind, "n": n})
        return out

    def _candidates_c2c(self, n: int, rdtype, patience: int,
                        batch: Optional[int], device) -> List[Dict]:
        out: List[Dict] = []
        if n == 1:
            return [{"alg": "nop", "n": 1}]
        if np.dtype(rdtype) == np.float64 and not config.strict_f64:
            # the double-float tier: df32 wherever it applies, the fused
            # kernel K7 (df32p) under MEASURE, as in the reference
            if df32.df32_applicable(n):
                out.append({"alg": "df32", "n": n,
                            "radices": df32.df32_radices(n)})
            if (patience >= K.PATIENCE_MEASURE
                    and df32.df32p_applicable(n, device)):
                out.append({"alg": "df32p", "n": n,
                            "radices": df32.df32p_radices(n)})
        if n <= DIRECT_MAX or (n <= GENERIC_MAX and
                               primes.largest_prime_factor(n) > 64):
            out.append({"alg": "direct", "n": n})
        if stockham.applicable(n, rdtype, device):
            default_rad = stockham.choose_radices(n)
            out.append({"alg": "pallas", "n": n, "radices": default_rad})
            if patience >= K.PATIENCE_MEASURE:
                # MEASURE times alternative radix schedules; higher
                # patience widens the set
                width = {K.PATIENCE_MEASURE: 3, K.PATIENCE_PATIENT: 6,
                         K.PATIENCE_EXHAUSTIVE: 16}.get(patience, 3)
                for rad in stockham.alternative_radices(n, width):
                    if rad != default_rad:
                        out.append({"alg": "pallas", "n": n, "radices": rad})
                # butterfly-stage variants, desc-pinned and MEASURE-only;
                # not offered on a CUDA device, where a vpu candidate and
                # its plain twin are the same kernel (the radix alone picks
                # each stage's form there, stockham.stage_form)
                on_card = torch.device(device).type == "cuda"
                for cand in [c for c in out if c["alg"] == "pallas"
                             and not on_card]:
                    if stockham.vpu_last_ok(cand["radices"][-1], 1):
                        out.append({**cand, "vpu": True})
                    if all(stockham.vpu_last_ok(r, 1)
                           for r in cand["radices"]):
                        out.append({**cand, "vpu": "all"})
        elif (patience >= K.PATIENCE_MEASURE
              and stockham.backend_allows(rdtype, device)
              and stockham.MAX_N < n <= 2 * stockham.MAX_N
              and (n & (n - 1)) == 0):
            # above MAX_N the reference races the all-butterfly schedule
            # [n/h, h] under MEASURE; here K1's wide form runs it (on a
            # CUDA device too: it is the only pallas candidate there)
            h = 1 << ((n.bit_length() - 1) // 2)
            rad = [n // h, h]
            if all(stockham.vpu_last_ok(r, 1) for r in rad):
                out.append({"alg": "pallas", "n": n, "radices": rad,
                            "vpu": "all"})
        if stockham.fourstep_applicable(n, rdtype, device):
            fp, fq = stockham.choose_fourstep(n)
            out.append({"alg": "pallas4", "n": n, "p": fp, "q": fq})
        for p in _mixed_factor_candidates(n, patience):
            child = self.plan_c2c(n // p, rdtype, patience,
                                  None if batch is None else batch * p,
                                  device)
            out.append({"alg": "mixed", "n": n, "p": p, "child": child})
        lpf = primes.largest_prime_factor(n)
        # the PATIENT-extra bluestein requires lpf > 5 so its own smooth
        # children can never regenerate the candidate
        if lpf > DIRECT_MAX or (patience >= K.PATIENCE_PATIENT and n > 16
                                and lpf > 5):
            m = primes.next_pow2(2 * n - 1)
            out.append({"alg": "bluestein", "n": n, "m": m,
                        "child": self.plan_c2c(m, rdtype, patience, batch,
                                               device)})
            m5 = primes.next_fast_size(2 * n - 1, smooth=5)
            if m5 != m and patience >= K.PATIENCE_PATIENT:
                out.append({"alg": "bluestein", "n": n, "m": m5,
                            "child": self.plan_c2c(m5, rdtype, patience,
                                                   batch, device)})
        if primes.is_prime(n) and n > DIRECT_MAX:
            nm1 = self.plan_c2c(n - 1, rdtype, patience, batch, device)
            out.append({"alg": "rader", "n": n, "child": nm1})
        if self.allow_xla and patience >= K.PATIENCE_MEASURE:
            out.append({"alg": "xla", "n": n})
        return out

    # -- cost ----------------------------------------------------------------
    def _cost(self, kind: str, desc: Dict, f64: bool = False) -> float:
        if config.random_estimator is not None:
            # FFTW_RANDOM_ESTIMATOR analog: a deterministic pseudo-random
            # cost keyed by (seed, kind, desc)
            import hashlib
            h = hashlib.md5(f"{config.random_estimator}:{kind}:"
                            f"{sprint_desc(desc)}".encode()).digest()
            return 1e-6 * (1 + int.from_bytes(h[:8], 'big') / 2**64)
        return _model_cost(kind, desc, self.hw, f64)

    # -- MEASURE mode ----------------------------------------------------
    def _measure_best(self, kind: str, n: int, rdtype, cands: List[Dict],
                      batch: Optional[int], device):
        """Time built candidates on `device`, keep the fastest.

        Candidates are timed in TWO INTERLEAVED passes and ranked by their
        per-candidate minimum, so drift in the card's state lands on all of
        them.  On a CUDA device a candidate that raises (a kernel that does
        not build or launch) re-raises: the plan must not quietly fall back
        to a plain PyTorch solver.  On the CPU it is counted in
        ``stats["nmeasure_failed"]`` and dropped (re-raised under
        ``config.debug``)."""
        from .utils import timing

        f64 = np.dtype(rdtype) == np.float64
        # order by estimate so a timelimit still leaves a good plan
        cands = sorted(cands, key=lambda d: self._cost(kind, d, f64))
        prepared = {}                 # index -> (fn, args) that built
        times: Dict[int, float] = {}
        self._measure_truncated = False
        for rnd in range(2):
            for i, desc in enumerate(cands):
                if (self.timelimit is not None and times
                        and time.perf_counter() - self._measure_t0
                        > self.timelimit):
                    self._measure_truncated = True
                    break
                if rnd == 1 and i not in prepared:
                    continue
                try:
                    if rnd == 0:
                        prepared[i] = _measure_fn(kind, desc, n, rdtype,
                                                  batch, device)
                    fn, args = prepared[i]
                    # a c2c output feeds its input; a real one cannot
                    timer = timing.time_chained if kind == "c2c" \
                        else timing.time_dispatched
                    t = timer(fn, args, iters=10, reps=3)
                    if rnd == 0:
                        self.stats["nmeasure"] += 1
                except Exception as e:                 # noqa: BLE001
                    # a failing candidate must not look like "the planner
                    # chose the slow path": count it and keep the error
                    if config.debug or device.type == "cuda":
                        raise
                    self.stats["nmeasure_failed"] += 1
                    self.stats["last_measure_error"] = \
                        f"{sprint_desc(desc)}: {type(e).__name__}: " \
                        f"{e}"[:300]
                    continue
                times[i] = min(t, times.get(i, float("inf")))
        if not times:  # every candidate failed: fall back to the estimate
            best = min(cands, key=lambda d: self._cost(kind, d, f64))
            return best, self._cost(kind, best, f64)
        besti = min(times, key=times.get)
        # hysteresis: a measured winner must beat the ESTIMATE choice by
        # the configured margin to override it
        if 0 in times and besti != 0 \
                and times[besti] > config.measure_hysteresis * times[0]:
            besti = 0
        return cands[besti], times[besti]

    # -- wisdom I/O (fftw_export_wisdom analog) ----------------------------
    def export_wisdom(self) -> str:
        return json.dumps({"format": WISDOM_FORMAT,
                           "entries": self.wisdom}, indent=1)

    def import_wisdom(self, s: str) -> bool:
        try:
            data = json.loads(s)
            if data.get("format") != WISDOM_FORMAT:
                return False
            self.wisdom.update(data["entries"])
            return True
        except (json.JSONDecodeError, KeyError, TypeError, AttributeError):
            return False

    def forget_wisdom(self) -> None:
        self.wisdom.clear()

    def import_reference_wisdom(self, s: str, device=None) -> bool:
        """Carry a ``fftw3_tpu`` wisdom export over to this planner.

        Keeps the entries of every kind whose descriptor
        :func:`validate_desc` accepts (so nothing this package cannot
        build), drops the
        reference's TPU-only descriptor keys, re-costs each entry with this
        planner's model and re-keys it to `device`'s signature.  Returns
        False for a string that is not a reference export."""
        try:
            data = json.loads(s)
            if data.get("format") != REFERENCE_WISDOM_FORMAT:
                return False
            entries = data["entries"]
            if not isinstance(entries, dict):
                return False
        except (json.JSONDecodeError, KeyError, TypeError, AttributeError):
            return False
        device = torch.device(config.device if device is None else device)
        sig = _device_signature(device)
        for key, entry in entries.items():
            parts = key.split(":")
            if len(parts) != 5 or parts[0] not in KINDS \
                    or not isinstance(entry, dict):
                continue                 # other kinds; random-estimator keys
            kind, n, dt, _, bucket = parts
            if not n.isdigit() or dt not in ("float32", "float64"):
                continue
            desc = _strip_tpu_keys(entry.get("desc"))
            if not validate_desc(kind, int(n), desc):
                continue
            new = {"desc": desc, "patience": entry.get("patience", 0),
                   "cost": _model_cost(kind, desc, self.hw,
                                       dt == "float64")}
            if "budget" in entry:
                new["budget"] = entry["budget"]
            self.wisdom[f"{kind}:{n}:{dt}:{sig}:{bucket}"] = new
        return True


def _strip_tpu_keys(desc):
    """A copy of a descriptor tree without the reference's TPU-only keys."""
    if not isinstance(desc, dict):
        return desc
    out = {k: v for k, v in desc.items() if k not in _TPU_ONLY_KEYS}
    if "child" in out:
        out["child"] = _strip_tpu_keys(out["child"])
    if isinstance(out.get("children"), list):
        out["children"] = [_strip_tpu_keys(c) for c in out["children"]]
    return out


# ---------------------------------------------------------------------------
# descriptor checks and MEASURE helpers
# ---------------------------------------------------------------------------

def validate_desc(kind: str, n: int, desc) -> bool:
    """Structural sanity of a (possibly imported) wisdom descriptor — the
    bogus-wisdom detector of the recovery ladder.  Only descriptors this
    package can build pass."""
    if kind not in KINDS or not isinstance(desc, dict):
        return False
    alg = desc.get("alg")
    if desc.get("n") != n or not isinstance(alg, str):
        return False
    if kind not in ("c2c", "r2c", "c2r"):
        return _validate_r2r(kind, n, alg, desc)
    if kind != "c2c":
        if alg == f"pallas_{kind}":
            return n % 2 == 0 and stockham.radices_ok(n // 2,
                                                      desc.get("radices"))
        if alg == f"{kind}_dense":
            return True
        if alg == f"{kind}_pack":
            return n % 2 == 0 and validate_desc("c2c", n // 2,
                                                desc.get("child"))
        if alg == f"{kind}_via_c2c":
            return validate_desc("c2c", n, desc.get("child"))
        return False
    if alg in ("nop", "direct", "xla"):
        return True
    if alg == "mixed":
        p = desc.get("p")
        return (isinstance(p, int) and 1 < p < n and n % p == 0
                and validate_desc("c2c", n // p, desc.get("child")))
    if alg == "pallas":
        return stockham.schedule_ok(n, desc.get("radices"), desc.get("vpu"))
    if alg == "df32":
        rad = desc.get("radices")
        return (isinstance(rad, list)
                and all(isinstance(r, int) and 1 < r for r in rad)
                and math.prod(rad) == n)
    if alg == "df32p":
        return df32.radices_ok(n, desc.get("radices"))
    if alg == "pallas4":
        return stockham.fourstep_ok(desc)
    if alg == "bluestein":
        m = desc.get("m")
        return (isinstance(m, int) and m >= 2 * n - 1
                and validate_desc("c2c", m, desc.get("child")))
    if alg == "rader":
        return (primes.is_prime(n)
                and validate_desc("c2c", n - 1, desc.get("child")))
    return False


def _validate_r2r(kind: str, n: int, alg: str, desc: Dict) -> bool:
    """The reference's r2r checks (children links of the reduction table,
    the split's odd n, the Rader prime), plus what the port adds so that
    only a descriptor that computes `kind` passes: the algorithm's own
    kind (the dense matrix's ``kind``) must be `kind`, and ``redft11_odd``
    needs an odd n."""
    own = desc.get("kind") if alg == "r2r_matmul" else \
        r2r_ops.KIND_OF.get(alg)
    if own != kind:
        return False
    if alg == "r2r_matmul":
        return True
    if alg in redft.KIND_OF:
        return n % 2 == 0 and stockham.radices_ok(n // 2,
                                                  desc.get("radices"))
    if alg in ("redft00_split", "rodft00_split"):
        ch = desc.get("children")
        if not (isinstance(ch, list) and len(ch) == 2 and n % 2 == 1):
            return False
        if alg == "redft00_split":
            sub = (("redft00", (n + 1) // 2), ("redft10", (n - 1) // 2))
        else:
            sub = (("rodft00", (n - 1) // 2), ("rodft10", (n + 1) // 2))
        return all(validate_desc(k, m, c) for (k, m), c in zip(sub, ch))
    if alg == "dht_rader":
        ch = desc.get("children")
        return (primes.is_prime(n) and isinstance(ch, list)
                and len(ch) == 2 and validate_desc("r2c", n - 1, ch[0])
                and validate_desc("c2r", n - 1, ch[1]))
    if alg == "redft11_odd" and n % 2 == 0:
        return False
    if alg == "redft00_ext" and n < 2:
        return False
    size = {"redft00_ext": 2 * (n - 1), "rodft00_ext": 2 * (n + 1),
            "redft11_2n": 2 * n}.get(alg, n)
    return validate_desc(_R2R_CHILD[alg], size, desc.get("child"))


def build_apply(kind: str, desc: Dict, rdtype, device=None) -> Callable:
    """One transform of a `kind` descriptor on `device` (default
    ``config.device``), in the reference's form: complex in and out for c2c
    (forward; the caller builds the backward with its sign), real in and
    the complex half spectrum out for r2c, its inverse for c2r, real in
    and out for the r2r kinds.  The solvers themselves run on split
    planes; this wraps them."""
    device = torch.device(config.device if device is None else device)
    if kind == "c2c":
        split = c2c_ops.build_c2c_split(desc, K.FORWARD, rdtype, device)
        return lambda x: torch.complex(*split(x.real, x.imag))
    if kind == "r2c":
        return real_ops.build_r2c(desc, rdtype, device)
    if kind == "c2r":
        return real_ops.build_c2r(desc, rdtype, device)
    return r2r_ops.build_r2r(desc, rdtype, device)


def _measure_fn(kind: str, desc: Dict, n: int, rdtype,
                batch: Optional[int], device):
    """(split fn, args) for MEASURE timing at the caller's batch (capped
    by config.measure_points), or at ~measure_points total points: planes
    of n points for c2c, real rows for r2c and r2r, half-spectrum planes
    for c2r."""
    cap = max(1, config.measure_points // max(n, 1))
    batch = cap if batch is None else max(1, min(int(batch), cap))
    rng = np.random.default_rng(0)
    rdt = np.dtype(rdtype)

    def rows(width):
        return torch.from_numpy(rng.standard_normal((batch, width))
                                .astype(rdt)).to(device)
    if kind == "r2c":
        return real_ops.build_r2c_split(desc, rdtype, device), (rows(n),)
    if kind not in ("c2c", "c2r"):
        return r2r_ops.build_r2r(desc, rdtype, device), (rows(n),)
    if kind == "c2r":
        return (real_ops.build_c2r_split(desc, rdtype, device),
                (rows(n // 2 + 1), rows(n // 2 + 1)))
    fn = c2c_ops.build_c2c_split(desc, K.FORWARD, rdtype, device)
    return fn, (rows(n), rows(n))


def _batch_bucket(batch: Optional[int]) -> str:
    """Coarse power-of-4 bucket of the vector size for wisdom keys."""
    if batch is None:
        return "d"
    return str(max(1, int(batch)).bit_length() // 2)


_sig_cache: Dict[torch.device, str] = {}


def _device_signature(device) -> str:
    """Wisdom-key signature: device type and name plus the torch and CUDA
    versions, so that new toolchains retire old wisdom instead of serving
    stale winners."""
    device = torch.device(device)
    sig = _sig_cache.get(device)
    if sig is None:
        name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else device.type
        sig = (f"{device.type}-{name}-torch{torch.__version__}"
               f"-cuda{torch.version.cuda}").replace(" ", "_")
        sig = sig.replace(":", "_")
        _sig_cache[device] = sig
    return sig


# ---------------------------------------------------------------------------
# plan printing (fftw_sprint_plan analog)
# ---------------------------------------------------------------------------

def sprint_desc(desc: Dict) -> str:
    alg = desc["alg"]
    n = desc.get("n")
    if alg == "mixed":
        return f"(mixed-{desc['p']}/{n} {sprint_desc(desc['child'])})"
    if alg == "pallas":
        v = {True: " vpu", False: " mxu",
             "all": " vpuall"}.get(desc.get("vpu"), "")
        return f"(pallas-{n} r{'x'.join(map(str, desc['radices']))}{v})"
    if alg == "df32p":
        return f"(df32p-{n} r{'x'.join(map(str, desc['radices']))})"
    if alg == "pallas4":
        return f"(pallas4-{desc['p']}x{desc['q']})"
    if alg == "bluestein":
        return f"(bluestein-{n}->{desc['m']} {sprint_desc(desc['child'])})"
    if alg == "rader":
        return f"(rader-{n} {sprint_desc(desc['child'])})"
    if alg == "r2r_matmul":
        return f"(matmul-{desc['kind']}-{n})"
    if "child" in desc:
        return f"({alg}-{n} {sprint_desc(desc['child'])})"
    return f"({alg}-{n})"


#: module-level planner singleton (fftw_the_planner analog)
the_planner = Planner()
