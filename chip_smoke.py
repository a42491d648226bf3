#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels of ``fftw3_tpu_torch`` from ``csrc/`` with nvcc
(one process per source, in parallel) and runs the toolchain canary P1
(``toolchain_probe.run_probes``: every source built, the probe kernel of
``csrc/probe.cu`` launched and right; a FAIL ends the run), then checks each
kernel against its plain PyTorch twin and a float64 oracle.  Then it drives
the port's paths through
the entry points a user calls, each at full width, with every kernel's
launch count set to 0 just before the path and read just after:

* 1-D c2c, ``plan_many_dft([1024], howmany=65536)`` through ``apply_split``
  and ``execute`` (the last-axis kernel K1), then its gradient, times, the
  planner's ESTIMATE choice against K1 off n = 1024, one MEASURE plan and a
  ``torch.profiler`` breakdown (phases 3-7);
* 3-D c2c, ``plan_dft_3d(512, 512, 512)``: axis 0 through the axis -2
  kernel K2, axes 1-2 through the fused 2-D kernel K3, one launch of each
  per call and no copy kernel (phase 9);
* 2-D batched, ``plan_many_dft([512, 512], howmany=64``): K3 alone
  (phase 10);
* 1-D c2c at n = 4096, B = 4096: the MEASURE plan (the four-step
  ``pallas4``, the all-butterfly ``pallas`` [64, 64] on K1's wide form and
  ``mixed``, raced), a plan pinned to ``pallas4-32x128`` by a
  reference-format wisdom import (K2, then K1 with the fused pre-twiddle)
  and one pinned to [64, 64] (one launch of K1's wide form), timed
  interleaved with ``torch.fft.fft`` (phase 11);
* 3-D c2c at 256^3, wherever ESTIMATE sends it (phase 12);
* 1-D r2c and c2r, ``plan_dft_r2c((65536, 1024), axes=(1,))`` and its
  inverse: one launch of the r2c kernel K4 (of the c2r kernel K6) per
  call, their gradients through K1 (K4) (phase 17);
* 2-D r2c and c2r at full width, ``plan_dft_r2c((8, 2048, 2048),
  axes=(1, 2))`` and its inverse: K4 then K2, K2 then K6; with
  ``config.r2c_swapped`` the axis -2 r2c kernel K5 then K1; ``execute``
  bit for bit its ``apply_split`` with the conversions, the r2c's K2
  writing the complex output (``inner.cout_launches``, printed beside
  the launches) and the c2r's reading the complex input; the three arms
  timed interleaved, and K2 and K1 held against their twins on this path's
  own planes (phase 18);
* complex128 c2c, ``plan_many_dft([1024], howmany=8192,
  dtype="complex128")``, the reference suite's f64 cell, planned four
  ways: ESTIMATE (the eager ``df32`` solver, no kernel), ESTIMATE under
  ``config.strict_f64`` (native FP64), MEASURE (``df32`` against the
  double-float kernel K7 and the ``mixed`` splits) and a plan pinned to
  ``df32p`` by a reference-format wisdom import (one K7 launch per call,
  one of the opposite sign in its backward); the five arms timed
  interleaved with ``torch.fft.fft`` (phase 21); then complex128
  ``plan_many_dft([512, 512], howmany=64)`` on the same pin (two K7
  launches, one behind ``movedim``) and a float64 r2c (phase 22);
* the r2r path (phases 27-34): the reference suite's DCT-II cell,
  ``plan_r2r((65536, 512), ["redft10"], axes=(1,))``, in four arms
  (ESTIMATE, MEASURE, pinned to ``redft10_half`` over K4 by a
  reference-format wisdom import: one K4 launch per call, and pinned to
  the dense ``r2r_matmul``) timed interleaved beside ``torch.fft.rfft``,
  with the K4 arm's gradient; DCT-III pinned to K6 (one launch) and its
  round trip; the DHT at (65536, 1024) under ESTIMATE; DCT-IV pinned to the
  2n route on K1 (one launch); every kind and algorithm over a case grid;
  ``plan_r2r_3d(256, 256, 256)`` DCT-II under ESTIMATE and pinned to K4 on
  every axis; a float64 DCT-II under ESTIMATE; and a fourth child
  (``--profile-paths r2r``: the pinned DCT-II and DCT-III, the DHT, the
  pinned 3-D DCT-II).  Every r2r output is held, over all its
  rows, against float64 (scipy.fft's DCT/DST, its FFT for the DHT and
  halfcomplex kinds), and K4, K6 and K1 against their twins over all rows
  at the shapes and on the inputs the pinned arms give them;
* K8, the fused DCT-II/DCT-III (phase 45, after the r2r path): both
  directions at (300, n), n in 256, 512, 2048 and 4096, against the plain
  version and float64, one launch a pass; ESTIMATE's plan at (262144, 512),
  one pass of a 512^3 Neumann solve, one launch a call, against the plain
  version over every row, timed beside it and ``torch.fft.rfft``.

Every path is checked against ``torch.fft`` in complex128 (an oracle only),
and every kernel route's gradient against its opposite-sign launches.
Phase 13 profiles the c2c paths with ``torch.profiler`` in a child process
(``--profile-paths c2c``), phase 14 times each kernel, its twin and the one
PyTorch call that computes the same function at its path's shape, and
holds each against its twin there; K3 at (512, 512, 512), (64, 512, 512),
(256, 256, 1024) and (341, 384, 512) runs on its ring of tile copies and,
from a misaligned copy of the input, in its in-order form: bit for bit the
same, the ring no more than 3% slower.  At the two 512 x 512 shapes it runs
the levels compiled into it (``fused2d.fixed_launches``), timed against its
run-time level plans, bit for bit the same; at the other two it runs the
run-time plans, their time printed beside the one ``K3_OFF_PLANES_BEFORE_MS``
records on the card named there (reported, not enforced: the same code
read 4% apart in two calls).  Phase 15 times the 3-D and 2-D batched
plans against the other routes the port could take for them: K2 on every
non-last axis with K1 on the last (no fusion), and a ``movedim`` lift
around K1 on every axis.  Phase 16 holds K4, K5 and K6 against their twins
and float64 over a case grid (K6 against the dense and the butterfly twin,
also at a radix-5, two dense-stage and the DCT-III child's schedule);
phase 19 profiles the real paths in a second child (``--profile-paths
real``) and times the three real kernels against their twins and
``torch.fft.rfft``/``irfft``.  Phase 20 holds K7 against
its twin bit for bit and complex128 (1e-12) over a case grid; phase 23
runs the dd64 tier on the card against the same plan on the CPU, in
mpmath (1e-28);
phase 24 profiles the f64 path in a third child (``--profile-paths
f64``); phase 25 runs E5, the stage ablation of K1 (``ops/ablate.py``), in
both stage forms, interleaved with K1; phase 26 runs E8, the copy floors
of K2 and K1 (``ops/copyfloor.py``), interleaved with K2 and K1 at the
same shapes.  Phase 35 plans each float32 dense solver (``direct``,
``mixed``, ``r2c_dense``, ``c2r_dense``, ``r2r_matmul``) by a
reference-format wisdom pin under ``torch.set_float32_matmul_precision(
"high")`` and holds it and its gradient against float64 over every row
(``ops/dense.py`` pins full precision per product, in the backward too),
then restores "highest"; phases 36-38
run the measurement kernels E1 (``ops/unaligned.py``: the n = 1000 row
against n = 1024, beside K1), E2/E3 (``ops/stage4096.py``: the n = 4096
and n = 2048 first stage op by op, rows per block swept, beside the wide
K1) and E7 (``ops/swap.py``: the four-step's swap as a kernel against the
two PyTorch copies and a row copy, and ``pallas4`` pinned to eight
splits with and without K1's fused store, beside the wide K1 and
``torch.fft.fft``), each arm held against its twin and timed twice in one
interleaved order and back; the copy arms of E8 and E2 beside ``clone``.
Phase 39 runs E4, E6 and E9-E12 (``ops/k1_mma.py``: the n = 1024 K1 with
its stages on the tensor cores, ``mma.sync`` bf16 hi/lo, 24 arms over the
reference's product forms, G splits, pass groupings, buffers, packing,
repeats and diagnostics), every arm held against its twin over every row
at (256, 1024) and every forward arm against complex128 over every row at
(8192, 1024), then timed at B = 8192 and 24576 beside the butterfly K1 at
three schedules and ``torch.fft.fft``; phase 40 runs E10's host arms on
the butterfly K1 [32, 32] at B = 16384 (``donate``, K1 in place, held bit
for bit against K1 first; ``stream2``; the stages run 1, 3 and 5 times in
one kernel), raced chained.  Phase 41 runs K7's ablation
(``tools/k7_ablation.py``: the ``full``, ``no_twiddle``, ``skeleton`` and
``copy`` arms at the f64 path's (8192, 1024) [64, 16], timed interleaved
with K7 and cuFFT Z2Z, the full arm held bit for bit against K7) and
prints the SASS of K7's arms by instruction class.  Phases 42-44 drive
the user surface at full width: phase 42 the numpy-style functions on CUDA
tensors (``fft``/``ifft`` at (65536, 1024): one K1 launch each;
``rfft``/``irfft``: one K4, one K6; ``fft2`` on (64, 512, 512): one K3;
``fftn`` on 512^3: K2 + K3; ``rfftn``/``irfftn`` on (8, 2048, 2048): K4 +
K2, K2 + K6; ``dct`` at (65536, 512) and ``scipy_fft.dctn`` on 256^3
wherever the functional ESTIMATE sends them), each against float64 over
every output, each second call planning nothing, ``fft(x)`` timed beside
its plan's ``apply_split`` and ``torch.fft.fft``; phase 43 the guru
layouts: ``execute_split_dft`` (one K1 launch; a fifth child,
``--profile-paths surface``, shows K1 and no other kernel beside it), a
strided guru plan over flat buffers with an offset and ``out=``, and a
``plan_many_dft`` with ``inembed``/``onembed``; phase 44 the bench
harness in child processes (``python -m fftw3_tpu_torch.harness`` -s and
-y on the reference suite's cells, ``--double``, ``--paranoid``,
``harness.accuracy``, ``harness.fuzz`` 30/30, ``tools.wisdom`` read back
here).  K1-K6 run their
stages as register butterflies (a radix with a prime factor of 7 or more
keeps the dense sum), K7 its own df passes (two recursion levels a pass
in registers, the permute folded into the next stage's reads); each
butterfly kernel's row in the kernels line names its stage form.
Exits non-zero at the first
failed check, and without printing a result when torch sees no CUDA
device.

The last three lines of standard output are JSON: the r2r path's results,
the kernels of the paths (name, source, launches, error against the twin,
times, bound; K1's, K1's wide, K2's and K3's rows time the form
``Plan.execute`` runs on complex64, named in ``layout``, with its
launches counted in an ``execute`` call and the planar form's time in
``planes_ms``; K3's also its launches on the ring, ``ring_launches``, and
its in-order form's time, ``in_order_ms``, its launches with the levels
compiled in, ``fixed_launches``, and the times of both level forms,
``fixed_ms`` and ``run_time_ms``; P1's launches are the probe's own; the measurement arms'
launches are their phase's, ``on_path`` false but for the ``pallas4``
arms; phase 39's rows carry both batches' times and the marginal slope,
then phase 40's race, then phase 41's K7 arms), then ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import kinds as K
from fftw3_tpu_torch import plan as plan_mod
from fftw3_tpu_torch import planner as P
from fftw3_tpu_torch import toolchain_probe
from fftw3_tpu_torch.ops import _build, ablate, copyfloor, k1_mma
from fftw3_tpu_torch.ops import stage4096, swap
from fftw3_tpu_torch.ops import c2c as c2c_ops
from fftw3_tpu_torch.ops import df32, fused2d, inner, matrices, r2r
from fftw3_tpu_torch.ops import real_stockham as RS
from fftw3_tpu_torch.ops import redft
from fftw3_tpu_torch.ops import stockham as S
from fftw3_tpu_torch.ops import unaligned
from fftw3_tpu_torch.ops.dense import exact_matmul
from fftw3_tpu_torch.utils import timing

N = 1024
BATCH = 65536
MAIN_RADICES = [64, 16]
MAIN_DESC = {"alg": "pallas", "n": N, "radices": MAIN_RADICES}
TOL = 1e-5                  # max-abs error over max-abs, against float64
#: K1's case grid: every stage of the first nine runs as butterflies;
#: 896 and 1792 put a radix with the factor 7 (56, 112) on the dense sum
#: beside a butterfly stage, and 131 is one prime dense stage; 4096 runs
#: the wide form
CASES = [(128, [128]), (256, [256]), (512, [32, 16]), (1000, [50, 20]),
         (1024, [64, 16]), (1024, [32, 32]), (1024, [128, 8]),
         (1536, [96, 16]), (2048, [128, 16]),
         (192, [192]), (896, [56, 16]), (1792, [112, 16]), (131, [131]),
         (4096, [64, 64])]
CASE_BATCHES = [1, 37, 4096]
ORACLE_ROWS = 256
TIMED_RADICES = [[64, 16], [32, 32], [128, 8]]
#: sizes where the planner's ESTIMATE choice is timed against the kernel, at
#: the main path's 2**26 points: 192 and 256 are left off the kernel by the
#: cost model, 512 is a control it keeps on the kernel
OFF_HEADLINE = [192, 256, 512]
PROFILE_CALLS = 5

#: the case grid of the multi-axis and four-step kernels against their twins
INNER_NS = [8, 32, 128, 512, 1000, 2048]
INNER_LS = [1, 37, 130, 4096]
PLANES_2D = [(128, 128), (256, 1024), (512, 512), (384, 768)]
#: K3 timed at planes off the main paths' 512 x 512, 2**26 points each
K3_OFF_PLANES = [(256, 256, 1024), (341, 384, 512)]
#: K3's time (ms, complex64 out, on the ring) at K3_OFF_PLANES before the
#: 512 x 512 levels were compiled in (the mean of two turns beside the
#: change, tools.race_trees), and the card it was read on: these shapes
#: still run the run-time level plans
K3_OFF_PLANES_BEFORE_MS = {(256, 256, 1024): 1.3834, (341, 384, 512): 2.1075}
K3_BEFORE_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PRES = [1, 3, 64]
#: K1 with the four-step options: (q, radices, P, transposed store)
PRETWIDDLE_CASES = [(128, [128], 32, False), (128, [128], 128, True),
                    (512, [32, 16], 8, False), (2048, [128, 16], 64, True)]
PRETWIDDLE_GROUPS = [1, 37, 512]
#: oracle checks in the grid up to this many points per case
GRID_ORACLE_POINTS = 1 << 24

CUBE = 512                  # the 3-D path: plan_dft_3d(512, 512, 512)
MANY_2D = (64, 512, 512)    # the 2-D batched path
N4 = 4096                   # the four-step path: n = 4096, B = 4096
B4 = 4096
SUITE_CUBE = 256            # the reference suite's 3-D shape

#: the real kernels' case grid: n, batches (K4, K6), and pre and L (K5)
REAL_NS = [256, 512, 1024, 2048, 4096]
REAL_BATCHES = [1, 37, 4096]
R2C_INNER_PRES = [1, 3, 8]
R2C_INNER_LS = [1, 37, 128, 1025, 2048]
#: K6's schedules beside REAL_NS's defaults (phase 16): radix-5 levels,
#: a dense stage first and last, and the DCT-III child's [256]
K6_SCHEDULES = [(1000, [25, 20]), (1792, [56, 16]), (1792, [16, 56]),
                (512, [256])]
REAL_1D = (65536, 1024)     # the 1-D real path: plan_dft_r2c(REAL_1D, (1,))
REAL_2D = (8, 2048, 2048)   # the full-width 2-D path, axes (1, 2): the
#                             reference suite's r2c_2d_2048 cell

#: the r2r path (phases 27-34): the reference suite's DCT-II cell
#: dct2_512_b65536 (bench.py:389, :1104), DCT-III and DCT-IV at its shape,
#: the DHT at the headline's points, the 3-D DCT-II of the Neumann Poisson
#: solve (fftw3_tpu/models/poisson.py:89) and a float64 DCT-II
R2R_1D = (65536, 512)
R2R_DHT = (65536, 1024)
R2R_CUBE = 256
R2R_F64 = (8192, 512)
#: phase 31's (kind, n) at B = 4096, which reach every algorithm: odd n for
#: the splits and redft11_odd, the primes 257 and 1021 for dht_rader, and
#: 8192, above R2R_GENERIC_MAX, where no matmul is offered
R2R_GRID_BATCH = 4096
R2R_GRID = [("dht", 1024), ("dht", 1021), ("dht", 257), ("r2hc", 512),
            ("r2hc", 17), ("hc2r", 512), ("hc2r", 17), ("redft10", 512),
            ("redft01", 512), ("redft00", 513), ("redft00", 16),
            ("rodft00", 511), ("rodft00", 16), ("redft11", 512),
            ("redft11", 511), ("rodft10", 512), ("rodft01", 511),
            ("rodft11", 512), ("redft10", 4096), ("redft10", 8192),
            ("dht", 8192), ("rodft11", 8192)]

#: K8 (phase 45): both directions at (K8_ROWS, n) for each n of K8_NS
#: against the plain version and float64, then timed at the rows of one
#: pass of a 512^3 Neumann solve
K8_NS = [256, 512, 2048, 4096]
K8_ROWS = 300
K8_PASS = (512 * 512, 512)

#: a ``fftw3_tpu`` wisdom export (reference format) that pins
#: plan_many_dft([4096], howmany=4096) to the four-step pallas4-32x128: the
#: reference package's own ESTIMATE export for that problem, as
#: ``tests/test_torch_fourstep.py`` checks
REFERENCE_WISDOM = """{
 "format": "fftw3-tpu-wisdom-2",
 "signature": "cpu-cpu-jax0.9.0-jl0.9.0-pvd9747e2d",
 "entries": {
  "c2c:4096:float32:cpu-cpu-jax0.9.0-jl0.9.0-pvd9747e2d:b6": {
   "desc": {
    "alg": "pallas4",
    "n": 4096,
    "p": 32,
    "q": 128
   },
   "patience": 0,
   "cost": 4.2762239999999993e-07
  }
 }
}"""
PALLAS4_DESC = {"alg": "pallas4", "n": N4, "p": 32, "q": 128}

#: a ``fftw3_tpu`` wisdom export (reference format) that pins
#: plan_many_dft([4096], howmany=4096) to the all-butterfly schedule
#: [64, 64] that the reference races under MEASURE above MAX_N (K1's wide
#: form here): the reference package's MEASURE export for that problem with
#: its timing stubbed to pick it, as ``tests/test_torch_planner.py`` checks
REFERENCE_WISDOM_WIDE = """{
 "format": "fftw3-tpu-wisdom-2",
 "signature": "cpu-cpu-jax0.9.0-jl0.9.0-pvd9747e2d",
 "entries": {
  "c2c:4096:float32:cpu-cpu-jax0.9.0-jl0.9.0-pvd9747e2d:b6": {
   "desc": {
    "alg": "pallas",
    "n": 4096,
    "radices": [
     64,
     64
    ],
    "vpu": "all"
   },
   "patience": 1,
   "cost": 0.0
  }
 }
}"""
WIDE_DESC = {"alg": "pallas", "n": N4, "radices": [64, 64], "vpu": "all"}

#: r2r plans pinned by a reference-format wisdom import (:func:`r2r_wisdom`),
#: as ``bench_dct2``'s ``_mkplans("pallas")`` (bench.py:415-433) pinned the
#: DCT-II cell on the TPU: name -> (kind, n, batch, descriptor);
#: ``tests/test_torch_r2r.py`` checks each against the reference's own
#: export
R2R_PINS = {
    "dct2 K4": ("redft10", 512, 65536, {
        "alg": "redft10_half", "n": 512,
        "child": {"alg": "pallas_r2c", "n": 512, "radices": [256]}}),
    "dct2 matmul": ("redft10", 512, 65536, {
        "alg": "r2r_matmul", "kind": "redft10", "n": 512}),
    "dct3 K6": ("redft01", 512, 65536, {
        "alg": "redft01_half", "n": 512,
        "child": {"alg": "pallas_c2r", "n": 512, "radices": [256]}}),
    "dct4 K1": ("redft11", 512, 65536, {
        "alg": "redft11_2n", "n": 512,
        "child": {"alg": "pallas", "n": 1024, "radices": [64, 16]}}),
    "cube K4": ("redft10", 256, 65536, {
        "alg": "redft10_half", "n": 256,
        "child": {"alg": "pallas_r2c", "n": 256, "radices": [128]}}),
}

#: a ``fftw3_tpu`` wisdom export (reference format) that pins complex128
#: plan_many_dft([1024], howmany=8192) and the axes of plan_many_dft([512,
#: 512], howmany=64) to the fused double-float kernel (df32p): the
#: reference package's MEASURE export for those problems with its timing
#: stubbed to pick df32p, as ``tests/test_torch_df32.py`` checks
REFERENCE_WISDOM_F64 = """{
 "format": "fftw3-tpu-wisdom-2",
 "signature": "cpu-cpu-jax0.9.0-jl0.9.0-pvd9747e2d",
 "entries": {
  "c2c:1024:float64:cpu-cpu-jax0.9.0-jl0.9.0-pvd9747e2d:b7": {
   "desc": {
    "alg": "df32p",
    "n": 1024,
    "radices": [
     64,
     16
    ]
   },
   "patience": 1,
   "cost": 0.0
  },
  "c2c:512:float64:cpu-cpu-jax0.9.0-jl0.9.0-pvd9747e2d:b8": {
   "desc": {
    "alg": "df32p",
    "n": 512,
    "radices": [
     32,
     16
    ]
   },
   "patience": 1,
   "cost": 0.0
  }
 }
}"""

#: NVIDIA H100 SXM data sheet: HBM3 rate and FP32 rate outside the tensor
#: cores; a bound is the larger of bytes / HBM and 5*N*log2(N) flops / FP32
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
#: the same FP32 rate in instructions (an FMA is one): the rate that bounds
#: K7, whose error-free transforms are mostly single adds and multiplies
FP32_INSTR_PER_S = 33.5e12
#: the dense bf16 tensor-core rate (E3's bf16 arms)
BF16_FLOPS_PER_S = 989e12

#: the f64 tier (phases 20-23): max-abs error over max-abs against
#: complex128; K7's case grid; the reference suite's c2c_1d_1024_f64_b8192
#: path; the 2-D batched complex128 plan; the dd64 plan on the card
F64_TOL = 1e-12
K7_NS = [128, 256, 512, 1000, 1024]
K7_BATCHES = [1, 37, 4096]
F64_PATH = (8192, 1024)
DF32_DESC = {"alg": "df32", "n": 1024, "radices": [4, 4, 4, 4, 4]}
DF32P_DESC = {"alg": "df32p", "n": 1024, "radices": [64, 16]}
F64_MANY_2D = (64, 512, 512)
DD_N, DD_ROWS, DD_MP_ROWS = 1024, 64, 2
DD_TOL = 1e-28

#: launch counters: kernel name -> (module, attribute)
COUNTERS = {"stockham_c2c": (S, "launches"),
            "stockham_c2c_fourstep": (S, "fourstep_launches"),
            "stockham_c2c_wide": (S, "wide_launches"),
            "inner_c2c": (inner, "launches"),
            "inner_c2c_cout": (inner, "cout_launches"),
            "c2c_2d": (fused2d, "launches"),
            "c2c_2d_ring": (fused2d, "ring_launches"),
            "c2c_2d_fixed": (fused2d, "fixed_launches"),
            "r2c": (RS, "r2c_launches"),
            "r2c_inner": (RS, "r2c_inner_launches"),
            "c2r": (RS, "c2r_launches"),
            "df32_c2c": (df32, "launches"),
            "probe_matmul": (toolchain_probe, "launches"),
            "redft": (redft, "launches"),
            "redft_fixed": (redft, "fixed_launches")}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def relerr(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def planes(rng, shape, device):
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(device) for _ in range(2))


def real_rows(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(device)


def np_oracle(xr, xi, sign, rows=ORACLE_ROWS):
    """float64 numpy DFT of the first `rows` rows, as a complex128 tensor."""
    x = (xr[:rows].double() + 1j * xi[:rows].double()).cpu().numpy()
    n = x.shape[-1]
    y = np.fft.fft(x, axis=-1) if sign < 0 else np.fft.ifft(x, axis=-1) * n
    return torch.from_numpy(y)


def oracle(x: torch.Tensor, dims, sign: int) -> torch.Tensor:
    """Unnormalized DFT over `dims` in complex128 on the card."""
    x = x.to(torch.complex128)
    if sign < 0:
        return torch.fft.fftn(x, dim=dims)
    return torch.fft.ifftn(x, dim=dims, norm="forward")


def gflops(n: int, batch: int, seconds: float) -> float:
    return 5.0 * n * math.log2(n) * batch / seconds / 1e9


def bound(bytes_moved: float, flops: float, rate: float = FP32_FLOPS_PER_S):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the operations at `rate` (FP32 outside the tensor cores unless
    given)."""
    tb = bytes_moved / HBM_BYTES_PER_S
    tf = flops / rate
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def fft_flops(points: int, *ns: int) -> float:
    """5*N*log2(N) per transform, for every axis length in `ns`."""
    return sum(5.0 * points * math.log2(n) for n in ns)


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}


def only(**launches):
    """The full count dict with the named kernels at the given counts and
    every other kernel at 0."""
    return {**dict.fromkeys(COUNTERS, 0), **launches}


def time_ms(fn, args) -> float:
    """Median of 7 reps of 3 calls, CUDA events, in ms."""
    return timing.time_dispatched(fn, args, iters=3, reps=7) * 1e3


def off_by_4(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` in a view 4 bytes into its storage: not 16-byte
    aligned, so K3 takes its in-order form."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = flat[1:].view(t.shape)
    v.copy_(t)
    return v


#: how much slower than its in-order form K3's ring may be at a shape
K3_RING_SLACK = 1.03


def k3_forms(xr, xi, r1, r2, tab, shape):
    """K3 writing complex64 on the ring (the aligned input) and in its
    in-order form (a misaligned copy of it): bit for bit the same output,
    one ring launch counted, and the ring's time (ms) within
    K3_RING_SLACK of the in-order form's.  Returns both times."""
    mr, mi = off_by_4(xr), off_by_4(xi)
    ring0 = fused2d.ring_launches
    a = fused2d.c2c_2d_cuda(xr, xi, r1, r2, tab, complex_out=True)
    b = fused2d.c2c_2d_cuda(mr, mi, r1, r2, tab, complex_out=True)
    torch.cuda.synchronize()
    check(fused2d.ring_launches == ring0 + 1,
          f"K3 at {shape}: the aligned input did not take the ring, or "
          f"the misaligned one did")
    check(torch.equal(a, b), f"K3 at {shape}: the ring's output differs "
          f"from the in-order form's")
    del a, b
    ms = time_ms(lambda u, v: fused2d.c2c_2d_cuda(
        u, v, r1, r2, tab, complex_out=True), (xr, xi))
    in_order = time_ms(lambda u, v: fused2d.c2c_2d_cuda(
        u, v, r1, r2, tab, complex_out=True), (mr, mi))
    print(f"[14] c2c_2d {shape}: ring {ms:.3f} ms, in order {in_order:.3f} "
          f"ms ({ms / in_order:.3f}x)")
    check(ms <= K3_RING_SLACK * in_order,
          f"K3 at {shape}: the ring ({ms:.3f} ms) is over "
          f"{K3_RING_SLACK}x the in-order form ({in_order:.3f} ms)")
    return ms, in_order


def k3_fixed(xr, xi, rad, tab, shape):
    """K3 writing complex64 on a 512 x 512 schedule with the levels
    compiled in (the host's choice) and with its run-time level plans (the
    host made to ask for them): bit for bit the same output, the first
    counted in ``fixed_launches`` and the second not.  Returns the two
    times (ms), each the faster of two turns taken in order and back."""
    def run(u, v):
        return fused2d.c2c_2d_cuda(u, v, rad, rad, tab, complex_out=True)

    def run_time(u, v):
        keep = fused2d.fixed_fits
        fused2d.fixed_fits = lambda p2, p1: False
        try:
            return run(u, v)
        finally:
            fused2d.fixed_fits = keep
    fixed0 = fused2d.fixed_launches
    a = run(xr, xi)
    torch.cuda.synchronize()
    check(fused2d.fixed_launches == fixed0 + 1,
          f"K3 at {shape}: the 512 x 512 plans did not take the compiled-in "
          f"levels")
    b = run_time(xr, xi)
    torch.cuda.synchronize()
    check(fused2d.fixed_launches == fixed0 + 1,
          f"K3 at {shape}: the run-time form counted as compiled in")
    check(torch.equal(a, b), f"K3 at {shape}: the compiled-in levels' "
          f"output differs from the run-time form's")
    del a, b
    turns = [time_ms(f, (xr, xi)) for f in (run, run_time, run_time, run)]
    fixed, slow = min(turns[0], turns[3]), min(turns[1], turns[2])
    print(f"[14] c2c_2d {shape}: levels compiled in {turns[0]:.3f} / "
          f"{turns[3]:.3f} ms, run-time plans {turns[1]:.3f} / "
          f"{turns[2]:.3f} ms ({fixed / slow:.3f}x)")
    return fixed, slow


def time_vs_oracle(fn, xr, xi, ref):
    """(median seconds per call, rel err against `ref`) of a split apply."""
    yr, yi = fn(xr, xi)
    e = relerr(torch.complex(yr, yi).to(torch.complex128), ref)
    del yr, yi
    return timing.time_dispatched(fn, (xr, xi), iters=3, reps=7), e


def profile_calls(label, fn, args, smi_line, tag="[7]"):
    """Wall time per call on the host clock (no profiler), device time per
    call and per device kernel from ``torch.profiler``, and the idle share
    1 - device / wall.  Returns {kernel: (us per call, launches per call)},
    empty when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_CALLS):
        fn(*args)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / PROFILE_CALLS * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_CALLS):
            fn(*args)
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        # a span's copy on the device's timeline is no device activity
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            kernels[ev.key] = (us / PROFILE_CALLS, ev.count / PROFILE_CALLS)
    dev_us = sum(us for us, _ in kernels.values())
    if dev_us == 0:
        print(f"{tag} {label}: wall {wall_us:.1f} us/call; device time not "
              f"measured (the profiler saw no device activity)")
        return kernels
    if any(abs(c - round(c)) > 1e-9 or c < 1 for _, c in kernels.values()):
        # a launch missing from the trace would read as idle time
        print(f"{tag} {label}: wall {wall_us:.1f} us/call; the profiler "
              f"recorded only part of the launches (counts per call below), "
              f"so device time and idle share are not measured here "
              f"({smi_line})")
    else:
        print(f"{tag} {label}: wall {wall_us:.1f} us/call, device "
              f"{dev_us:.1f} us/call, idle share {1 - dev_us / wall_us:.3f} "
              f"({smi_line})")
    for key, (us, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        print(f"{tag}   {us:10.1f} us/call  x{count:g}  {key[:100]}")
    return kernels


def grid_case(label, kern, twin, ref_fn, points):
    """One kernel-vs-twin case: returns the error against the twin; also
    checks against the complex128 oracle up to GRID_ORACLE_POINTS."""
    kr, ki = kern()
    tr, ti = twin()
    torch.cuda.synchronize()
    k = torch.complex(kr, ki)
    e_kt = relerr(k, torch.complex(tr, ti))
    del tr, ti
    e_ko = None
    if points <= GRID_ORACLE_POINTS:
        e_ko = relerr(k.to(torch.complex128), ref_fn())
    check(e_kt <= TOL and (e_ko is None or e_ko <= TOL),
          f"{label}: kernel-twin {e_kt:.2e}, kernel-f64 {e_ko}")
    return e_kt, e_ko


def twin_err(label, kr, ki, tr, ti):
    """Max abs error of a kernel's output against its twin's, checked at
    max-abs over max-abs <= TOL; returns (max abs, relative)."""
    t = torch.complex(tr, ti)
    e = float((torch.complex(kr, ki) - t).abs().max())
    rel = e / float(t.abs().max())
    check(rel <= TOL, f"{label}: kernel-twin {rel:.2e} over {TOL}")
    return e, rel


def compose(stages):
    def apply(xr, xi):
        for s in stages:
            xr, xi = s(xr, xi)
        return xr, xi
    return apply


def routes(plan, dev):
    """The routes the port could take for a multi-axis c2c `plan`, on the
    plan's own descriptors: the plan as built; K2 on every non-last axis
    and K1 on the last (no fusion); a ``movedim`` lift around K1 on every
    axis."""
    shape, sign = plan.problem.shape, plan.problem.sign
    axes = sorted(plan.descriptors)
    d = plan.descriptors
    return {
        "plan": plan.apply_split,
        "K2 + K1": compose([plan_mod._c2c_stage(d[a], sign, np.float32, a,
                                                shape, dev)[1]
                            for a in axes]),
        "movedim + K1": compose([plan_mod._along_axis_split(
            c2c_ops.build_c2c_split(d[a], sign, np.float32, dev),
            a - len(shape)) for a in axes]),
    }


def grad_equals(label, fwd, adj, shape, rng, dev, exact=True):
    """Backward of `fwd` (a split apply) against `adj` on the cotangent."""
    gxr, gxi = (t.requires_grad_() for t in planes(rng, shape, dev))
    gr, gi = planes(rng, shape, dev)
    outr, outi = fwd(gxr, gxi)
    torch.autograd.backward([outr, outi], [gr, gi])
    del outr, outi
    wr, wi = adj(gr, gi)
    e = relerr(torch.complex(gxr.grad, gxi.grad), torch.complex(wr, wi))
    print(f"[grad] {label}: backward vs opposite-sign launches {e:.2e}")
    check(e == 0.0 if exact else e <= TOL, f"{label}: gradient mismatch")


def real_2d_plans():
    """The full-width 2-D real arms: the r2c as planned, with
    ``config.r2c_swapped``, and the c2r."""
    plans = {"r2c": ft.plan_dft_r2c(REAL_2D, axes=(1, 2), device="cuda")}
    ft.config.r2c_swapped = True
    try:
        plans["r2c swapped"] = ft.plan_dft_r2c(REAL_2D, axes=(1, 2),
                                               device="cuda")
    finally:
        ft.config.r2c_swapped = False
    plans["c2r"] = ft.plan_dft_c2r(REAL_2D, axes=(1, 2), device="cuda")
    return plans


def profile_real_paths(rng, dev, smi_line) -> None:
    """``torch.profiler`` breakdowns of the real paths: the 1-D r2c and
    c2r, and the three full-width 2-D arms (the swapped arm's Hermitian
    rebuild shows as its own kernels)."""
    x = real_rows(rng, REAL_1D, dev)
    p = ft.plan_dft_r2c(REAL_1D, axes=(1,), device="cuda")
    q = ft.plan_dft_c2r(REAL_1D, axes=(1,), device="cuda")
    profile_calls(f"r2c {REAL_1D} apply_split", p.apply_split, (x,),
                  smi_line, tag="[19]")
    profile_calls(f"r2c {REAL_1D} execute", p.execute, (x,), smi_line,
                  tag="[19]")
    y = p.apply_split(x)
    profile_calls(f"c2r {REAL_1D} apply_split", q.apply_split, y, smi_line,
                  tag="[19]")
    del x, y, p, q
    x = real_rows(rng, REAL_2D, dev)
    arms = real_2d_plans()
    y = arms["r2c"].apply_split(x)
    for label, plan in arms.items():
        profile_calls(f"{label} {REAL_2D} apply_split", plan.apply_split,
                      y if label == "c2r" else (x,), smi_line, tag="[19]")


def f64_planes(rng, shape, device):
    return tuple(torch.from_numpy(rng.standard_normal(shape)).to(device)
                 for _ in range(2))


def time_few(fn, args) -> float:
    """Median of 3 single calls, CUDA events, in ms: for the eager df32
    plan, which launches a few thousand small kernels per call."""
    return timing.time_dispatched(fn, args, iters=1, reps=3) * 1e3


def f64_plans():
    """The complex128 plans of plan_many_dft([1024], howmany=8192): ESTIMATE
    (df32), ESTIMATE under ``config.strict_f64`` (native FP64), MEASURE, and
    the plan pinned to df32p by a reference-format wisdom import (left in
    the planner's wisdom, where it also pins n = 512)."""
    B, n = F64_PATH
    plans = {}
    for label in ("ESTIMATE", "strict_f64 ESTIMATE", "MEASURE", "pinned"):
        ft.forget_wisdom()
        ft.config.strict_f64 = label.startswith("strict")
        flags = ft.MEASURE if label == "MEASURE" else ft.ESTIMATE
        if label == "pinned":
            check(ft.import_reference_wisdom(REFERENCE_WISDOM_F64,
                                             device="cuda"),
                  "reference f64 wisdom refused")
        try:
            plans[label] = ft.plan_many_dft([n], howmany=B, flags=flags,
                                            dtype="complex128", device="cuda")
        finally:
            ft.config.strict_f64 = False
    return plans


def profile_f64_paths(rng, dev, smi_line) -> None:
    """``torch.profiler`` breakdowns of the f64 path at (8192, 1024): the
    ESTIMATE df32 plan (how many eager kernels per call) and the pinned
    df32p plan's ``apply_split`` and ``execute`` (K7 and what surrounds
    it)."""
    B, n = F64_PATH
    ft.forget_wisdom()
    pe = ft.plan_many_dft([n], howmany=B, dtype="complex128", device="cuda")
    check(pe.descriptors == {1: DF32_DESC}, f"ESTIMATE plan {pe!r}")
    check(ft.import_reference_wisdom(REFERENCE_WISDOM_F64, device="cuda"),
          "reference f64 wisdom refused")
    pp = ft.plan_many_dft([n], howmany=B, dtype="complex128", device="cuda")
    check(pp.descriptors == {1: DF32P_DESC}, f"pinned plan {pp!r}")
    xr, xi = f64_planes(rng, F64_PATH, dev)
    profile_calls(f"df32p plan {F64_PATH} apply_split", pp.apply_split,
                  (xr, xi), smi_line, tag="[24]")
    profile_calls(f"df32p plan {F64_PATH} execute complex128", pp.execute,
                  (torch.complex(xr, xi),), smi_line, tag="[24]")
    profile_calls(f"df32 plan {F64_PATH} apply_split", pe.apply_split,
                  (xr, xi), smi_line, tag="[24]")


def f64_phases(rng, dev, smi_line, seed, t_start):
    """Phases 20-24, the double-precision tier; returns K7's row of the
    kernels line."""
    c128 = torch.complex128

    # -- 20. K7 against its twin and complex128 -----------------------------
    worst_kt = worst_ko = 0.0
    ncases = 0
    for n in K7_NS:
        rad = df32.df32p_radices(n)
        for sign in (-1, +1):
            for b in K7_BATCHES:
                xr, xi = f64_planes(rng, (b, n), dev)
                kr, ki = df32.df32_c2c_cuda(xr, xi, rad, sign)
                tr, ti = df32.df32_c2c_torch(xr, xi, rad, sign)
                torch.cuda.synchronize()
                k = torch.complex(kr, ki)
                same = torch.equal(kr, tr) and torch.equal(ki, ti)
                e_kt = relerr(k, torch.complex(tr, ti))
                e_ko = relerr(k, oracle(torch.complex(xr, xi), (-1,), sign))
                check(same and e_ko <= F64_TOL,
                      f"K7 n={n} r={rad} sign={sign} B={b}: kernel-twin "
                      f"{e_kt:.2e} (bit for bit: {same}), kernel-complex128 "
                      f"{e_ko:.2e}")
                worst_kt, worst_ko = max(worst_kt, e_kt), max(worst_ko, e_ko)
                ncases += 1
                del xr, xi, kr, ki, tr, ti, k
        print(f"[20] K7 n={n} r={rad}: worst so far kernel-twin "
              f"{worst_kt:.2e}, kernel-complex128 {worst_ko:.2e}", flush=True)
    print(f"[20] K7: {ncases} cases, each equal to its twin bit for bit "
          f"(worst kernel-twin {worst_kt:.2e}); kernel vs torch.fft "
          f"complex128 {worst_ko:.2e} (max-abs over max-abs; tolerance "
          f"{F64_TOL})")

    # -- 21. the f64 path: plan_many_dft([1024], howmany=8192, complex128) --
    B, n = F64_PATH
    xr, xi = f64_planes(rng, F64_PATH, dev)
    xc = torch.complex(xr, xi)
    ref = torch.fft.fft(xc)
    pl = ft.the_planner
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts()
    plans = f64_plans()
    torch.cuda.synchronize()
    race = read_counts()
    st = pl.stats
    print(f"[21] four plans in {time.perf_counter() - t0:.1f} s; kernel "
          f"launches while MEASURE timed its candidates: "
          f"{({k: v for k, v in race.items() if v})}; "
          f"nmeasure_failed={st['nmeasure_failed']}")
    for label, plan in plans.items():
        print(f"[21] {label}: {plan!r}")
    check(plans["ESTIMATE"].descriptors == {1: DF32_DESC},
          "ESTIMATE did not pick df32")
    check(plans["pinned"].descriptors == {1: DF32P_DESC}, "pinned plan")
    check("df32" not in repr(plans["strict_f64 ESTIMATE"]),
          "strict_f64 kept the df32 tier")
    check(race["df32_c2c"] > 0, "MEASURE did not race df32p")
    check(st["nmeasure_failed"] == 0,
          f"MEASURE candidate failed: {st.get('last_measure_error')}")
    launches = {}
    for label, plan in plans.items():
        torch.cuda.synchronize()
        reset_counts()
        yr, yi = plan.apply_split(xr, xi)
        torch.cuda.synchronize()
        c_split = read_counts()
        reset_counts()
        yc = plan.execute(xc)
        torch.cuda.synchronize()
        c_exec = read_counts()
        launches[label] = (c_split, c_exec)
        e = relerr(torch.complex(yr, yi), ref)
        e_x = relerr(yc, ref)
        check(bool(torch.isfinite(yr).all() and torch.isfinite(yi).all())
              and tuple(yc.shape) == F64_PATH and yc.dtype == c128,
              f"{label}: bad output")
        print(f"[21] {label}: K7 launches apply_split "
              f"{c_split['df32_c2c']}, execute {c_exec['df32_c2c']}; rel "
              f"err vs torch.fft complex128 apply_split {e:.3e}, execute "
              f"{e_x:.3e}")
        check(max(e, e_x) <= F64_TOL, f"{label} over {F64_TOL}")
        del yr, yi, yc
    check(launches["ESTIMATE"] == (only(), only()),
          f"the df32 plan launched {launches['ESTIMATE']}")
    check(launches["pinned"] == (only(df32_c2c=1), only(df32_c2c=1)),
          f"the df32p plan launched {launches['pinned']}")

    # the pinned plan's gradient: one K7 launch of the opposite sign
    pp = plans["pinned"]
    gxr, gxi = (t.clone().requires_grad_() for t in (xr, xi))
    gr, gi = f64_planes(rng, F64_PATH, dev)
    outr, outi = pp.apply_split(gxr, gxi)
    torch.cuda.synchronize()
    reset_counts()
    torch.autograd.backward([outr, outi], [gr, gi])
    torch.cuda.synchronize()
    c_back = read_counts()
    check(c_back == only(df32_c2c=1), f"df32p backward launched {c_back}")
    wr, wi = df32.df32_c2c_cuda(gr, gi, DF32P_DESC["radices"], +1)
    g = torch.complex(gxr.grad, gxi.grad)
    e_g = relerr(g, torch.complex(wr, wi))
    e_go = relerr(g, oracle(torch.complex(gr, gi), (-1,), +1))
    print(f"[21] df32p backward: one K7 launch of sign +1; vs that launch "
          f"{e_g:.2e}, vs torch.fft complex128 {e_go:.2e}")
    check(e_g == 0.0 and e_go <= F64_TOL, "df32p gradient mismatch")
    del gxr, gxi, gr, gi, outr, outi, wr, wi, g, ref
    torch.cuda.empty_cache()

    # K7 against its twin at the path's shape, and the kernels-line times
    rad = DF32P_DESC["radices"]
    kr, ki = df32.df32_c2c_cuda(xr, xi, rad, -1)
    tr, ti = df32.df32_c2c_torch(xr, xi, rad, -1)
    t = torch.complex(tr, ti)
    max_abs = float((torch.complex(kr, ki) - t).abs().max())
    rel_k7 = max_abs / float(t.abs().max())
    check(torch.equal(kr, tr) and torch.equal(ki, ti),
          f"K7 vs twin at {F64_PATH}: {rel_k7:.2e}, not bit for bit")
    del kr, ki, tr, ti, t
    # K7's own FP32 instructions (its df multiply is fmaf's two_prod, not
    # the reference count's Dekker split)
    ops = df32.kernel_instructions(n, rad) * B
    t_b, t_o = 32.0 * B * n / HBM_BYTES_PER_S, ops / FP32_INSTR_PER_S
    row = {
        "name": "df32_c2c", "route": "cuda",
        "source": "fftw3_tpu_torch/csrc/df32_c2c.cu",
        "replaces": "fftw3_tpu/ops/df32.py:444",
        "launches": launches["pinned"][0]["df32_c2c"],
        "max_abs_err": max_abs, "rel_err": rel_k7,
        "ms": time_ms(lambda a, b: df32.df32_c2c_cuda(a, b, rad, -1),
                      (xr, xi)),
        "plain_ms": time_few(lambda a, b: df32.df32_c2c_torch(a, b, rad, -1),
                             (xr, xi)),
        "library_ms": time_ms(lambda z: torch.fft.fft(z), (xc,)),
        "bound_ms": max(t_b, t_o) * 1e3,
        "bound_by": "bytes" if t_b >= t_o else "operations"}
    print(f"[21] K7 {F64_PATH}: kernel {row['ms']:.3f} ms, twin "
          f"{row['plain_ms']:.3f} ms, torch.fft.fft complex128 "
          f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
          f"({row['bound_by']}: {ops:.3e} FP32 instructions, "
          f"{32.0 * B * n:.3e} bytes); kernel-twin max abs err "
          f"{max_abs:.3e}, over max |twin| {rel_k7:.2e} ({smi_line})")

    # the five arms, interleaved: each timed twice, in order and back; a
    # plan on the eager df32 solver with few calls
    arms = {"ESTIMATE df32": plans["ESTIMATE"],
            "pinned df32p": pp,
            "MEASURE's plan": plans["MEASURE"],
            "strict_f64 ESTIMATE": plans["strict_f64 ESTIMATE"],
            "torch.fft.fft complex128": None}
    times = {k: [] for k in arms}
    for label in list(arms) + list(arms)[::-1]:
        plan = arms[label]
        if plan is None:
            times[label].append(time_ms(lambda z: torch.fft.fft(z), (xc,)))
        else:
            timer = time_few if "(df32-" in repr(plan) else time_ms
            times[label].append(timer(plan.apply_split, (xr, xi)))
    for label, ts in times.items():
        print(f"[21] {label} {F64_PATH}: {ts[0]:.3f} / {ts[1]:.3f} ms "
              f"({smi_line})")
    del xr, xi, xc, plans, pp, arms
    torch.cuda.empty_cache()
    print(f"[21] done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # -- 22. complex128 beyond the last axis -------------------------------
    # the df32p pin for n = 512 is still in the planner's wisdom
    p2 = ft.plan_many_dft(list(F64_MANY_2D[1:]), howmany=F64_MANY_2D[0],
                          dtype="complex128", device="cuda")
    d512 = {"alg": "df32p", "n": 512, "radices": [32, 16]}
    print(f"[22] {p2!r}")
    check(p2.descriptors == {1: d512, 2: d512}, "2-D complex128 plan")
    xr, xi = f64_planes(rng, F64_MANY_2D, dev)
    torch.cuda.synchronize()
    reset_counts()
    yr, yi = p2.apply_split(xr, xi)
    torch.cuda.synchronize()
    c2 = read_counts()
    check(c2 == only(df32_c2c=2), f"2-D complex128 plan launched {c2}")
    e2 = relerr(torch.complex(yr, yi), torch.fft.fft2(torch.complex(xr, xi)))
    print(f"[22] plan_many_dft {F64_MANY_2D} complex128: K7 launches "
          f"{c2['df32_c2c']} (axis 1 behind movedim, axis 2); rel err vs "
          f"torch.fft.fft2 complex128 {e2:.3e}")
    check(e2 <= F64_TOL, "2-D complex128 plan over tolerance")
    del yr, yi
    t2 = time_ms(p2.apply_split, (xr, xi))
    t2_lib = time_ms(lambda z: torch.fft.fft2(z), (torch.complex(xr, xi),))
    print(f"[22] plan {t2:.3f} ms vs torch.fft.fft2 complex128 {t2_lib:.3f} "
          f"ms ({smi_line})")
    del xr, xi, p2
    ft.forget_wisdom()
    pr = ft.plan_dft_r2c(F64_PATH, axes=(1,), dtype="float64", device="cuda")
    print(f"[22] {pr!r}")
    x = torch.from_numpy(rng.standard_normal(F64_PATH)).to(dev)
    torch.cuda.synchronize()
    reset_counts()
    yr, yi = pr.apply_split(x)
    torch.cuda.synchronize()
    cr = read_counts()
    check(yr.dtype == torch.float64, "the complex128 r2c left float64")
    er = relerr(torch.complex(yr, yi), torch.fft.rfft(x))
    print(f"[22] r2c {F64_PATH} float64: launches "
          f"{({k: v for k, v in cr.items() if v})}; rel err vs torch.fft.rfft "
          f"complex128 {er:.3e}")
    check(er <= F64_TOL, "complex128 r2c over tolerance")
    del x, yr, yi, pr
    torch.cuda.empty_cache()

    # -- 23. dd64 on the card ----------------------------------------------
    try:
        import mpmath
    except ImportError:
        fail("phase 23 needs mpmath (it comes with torch's sympy)")
    mpmath.mp.dps = 50
    pq = ft.plan_dft_1d_q(DD_N, device="cuda")
    pcpu = ft.plan_dft_1d_q(DD_N, device="cpu")
    pb = ft.plan_dft_1d_q(DD_N, sign=+1, device="cuda")
    x = (rng.standard_normal((DD_ROWS, DD_N))
         + 1j * rng.standard_normal((DD_ROWS, DD_N))).astype(np.clongdouble)
    x += x * np.longdouble(1e-17)          # bits below float64
    y = pq.execute(x)
    want = np.fft.fft(x.astype(np.complex128))
    e_ex = float(np.max(np.abs(y.astype(np.complex128) - want))
                 / np.max(np.abs(want)))
    check(y.dtype == np.clongdouble and e_ex <= 1e-13,
          f"dd64 execute vs numpy: {e_ex:.2e}")
    planes = [rng.standard_normal((DD_ROWS, DD_N)) * s
              for s in (1.0, 1e-17, 1.0, 1e-17)]
    got = [v.cpu().numpy() for v in
           pq.apply_dd(*(torch.from_numpy(v).to(dev) for v in planes))]
    cpu = [v.numpy() for v in
           pcpu.apply_dd(*(torch.from_numpy(v) for v in planes))]
    back = [v.cpu().numpy() for v in
            pb.apply_dd(*(torch.from_numpy(v).to(dev) for v in got))]

    def mp_rows(p):
        """hi + lo of the first rows, exactly, as mpmath values."""
        return [[(mpmath.mpf(float(p[0][r, k])) + mpmath.mpf(float(p[1][r, k])),
                  mpmath.mpf(float(p[2][r, k])) + mpmath.mpf(float(p[3][r, k])))
                 for k in range(DD_N)] for r in range(DD_MP_ROWS)]

    def mp_err(a, b, scale=1):
        num = max(abs(u[0] - scale * v[0]) + abs(u[1] - scale * v[1])
                  for ra, rb in zip(a, b) for u, v in zip(ra, rb))
        den = max(abs(v[0]) + abs(v[1]) for rb in b for v in rb) * scale
        return float(num / den)
    g_mp, c_mp = mp_rows(got), mp_rows(cpu)
    e_cc = mp_err(g_mp, c_mp)
    e_rt = mp_err(mp_rows(back), mp_rows(planes), DD_N)
    same = all(np.array_equal(a, b) for a, b in zip(got, cpu))
    print(f"[23] {pq!r} on {DD_ROWS} rows: execute (clongdouble) vs numpy "
          f"{e_ex:.2e}; apply_dd on the card vs on the CPU {e_cc:.2e} "
          f"(bit-identical: {same}); backward(forward(x)) vs n x {e_rt:.2e} "
          f"({DD_MP_ROWS} rows rebuilt in mpmath)")
    check(e_cc <= DD_TOL and e_rt <= DD_TOL, "dd64 over tolerance")

    # -- 24. the f64 path profiled in a fresh process ----------------------
    sys.stdout.flush()
    res = subprocess.run([sys.executable, __file__, "--profile-paths", "f64",
                          "--seed", str(seed)], timeout=600)
    check(res.returncode == 0, "the profile of the f64 path failed")
    print(f"[24] done at {time.perf_counter() - t_start:.1f} s", flush=True)
    return row


def profile_paths(rng, dev, group) -> None:
    """``torch.profiler`` breakdowns, group ``c2c``: the 3-D, 2-D batched
    and four-step paths: wall and device time per call, idle share, time
    per kernel (the 3-D path must show K2 and K3 and no other kernel, no
    copy); groups ``real``, ``f64`` and ``r2r``: :func:`profile_real_paths`,
    :func:`profile_f64_paths` and :func:`profile_r2r_paths`."""
    smi_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    _build.library()
    if group == "real":
        profile_real_paths(rng, dev, smi_line)
        return
    if group == "f64":
        profile_f64_paths(rng, dev, smi_line)
        return
    if group == "r2r":
        profile_r2r_paths(rng, dev, smi_line)
        return
    if group == "surface":
        profile_surface_paths(rng, dev, smi_line)
        return
    cube = (CUBE,) * 3
    p3 = ft.plan_dft_3d(*cube, device="cuda")
    xr, xi = planes(rng, cube, dev)
    prof3 = profile_calls(f"plan_dft_3d{cube} apply_split", p3.apply_split,
                          (xr, xi), smi_line, tag="[13]")
    names = sorted(prof3)
    check(len(names) == 2 and any("inner_c2c_kernel" in k for k in names)
          and any("c2c_2d_kernel" in k for k in names),
          f"the 3-D profile is not K2 and K3 alone: {names}")
    for label, fn in routes(p3, dev).items():
        if label != "plan":
            profile_calls(f"plan_dft_3d{cube} by {label}", fn, (xr, xi),
                          smi_line, tag="[13]")
    del xr, xi, p3
    torch.cuda.empty_cache()
    p2 = ft.plan_many_dft(list(MANY_2D[1:]), howmany=MANY_2D[0],
                          device="cuda")
    profile_calls(f"plan_many_dft {MANY_2D} apply_split", p2.apply_split,
                  planes(rng, MANY_2D, dev), smi_line, tag="[13]")
    ft.forget_wisdom()
    check(ft.import_reference_wisdom(REFERENCE_WISDOM, device="cuda"),
          "reference wisdom refused")
    p4 = ft.plan_many_dft([N4], howmany=B4, device="cuda")
    check(p4.descriptors == {1: PALLAS4_DESC}, f"pinned plan {p4!r}")
    profile_calls(f"pallas4 ({B4}, {N4}) apply_split", p4.apply_split,
                  planes(rng, (B4, N4), dev), smi_line, tag="[13]")


def ablation_phase(rng, dev, smi_line, k1_row):
    """Phase 25, E5: K1 at the main path's shape with one op class removed
    at a time, in the dense form (the dense-sum K1 it replaced) and the
    butterfly form (this K1), each arm timed twice in one interleaved order
    and back, beside the K1 wrapper itself.  The full arms are held against
    the twin (the bfly arm bit for bit against K1); the other arms compute
    wrong numbers on purpose.  Returns the arms' rows of the kernels line
    (launches: this phase's, the arms are on no user path)."""
    B, n = BATCH, N
    rad = MAIN_RADICES
    table = S.device_table(n, tuple(rad), -1, dev)
    xr, xi = planes(rng, (B, n), dev)
    tr, ti = S.stockham_c2c_torch(xr, xi, rad, -1)
    twin = torch.complex(tr, ti)
    del tr, ti
    kr, ki = S.stockham_c2c_cuda(xr, xi, rad, table)
    k1 = torch.complex(kr, ki)
    del kr, ki
    arms = [(f, a) for f in ablate.FORMS for a in ablate.ARMS]
    ablate.launches.clear()
    errs = {}
    for f, a in arms:
        yr, yi = ablate.ablate_cuda(xr, xi, rad, table, f, a)
        y = torch.complex(yr, yi)
        errs[f, a] = float((y - twin).abs().max())
        if (f, a) == ("bfly", "full"):
            check(torch.equal(y, k1), "E5 bfly full arm differs from K1")
        if a == "full":
            check(errs[f, a] / float(twin.abs().max()) <= TOL,
                  f"E5 {f} full arm vs twin: {errs[f, a]:.2e}")
        del yr, yi, y
    del twin, k1
    torch.cuda.synchronize()
    labels = arms + [("K1", "stockham_c2c_cuda")]
    fns = {fa: (lambda a, b, fa=fa: ablate.ablate_cuda(a, b, rad, table,
                                                       *fa))
           for fa in arms}
    fns["K1", "stockham_c2c_cuda"] = \
        lambda a, b: S.stockham_c2c_cuda(a, b, rad, table)
    times = {fa: [] for fa in labels}
    for fa in labels + labels[::-1]:
        times[fa].append(time_ms(fns[fa], (xr, xi)))
    for fa, ts in times.items():
        print(f"[25] E5 {fa[0]} {fa[1]} ({B}, {n}) {rad}: {ts[0]:.3f} / "
              f"{ts[1]:.3f} ms ({smi_line})")
    k1_ms = min(times["K1", "stockham_c2c_cuda"])
    dense_ms = min(times["dense", "full"])
    print(f"[25] K1 (butterflies) {k1_ms:.3f} ms vs the dense form's full "
          f"arm {dense_ms:.3f} ms: {dense_ms / k1_ms:.2f}x ({smi_line})")
    rows = []
    for f, a in arms:
        ts = times[f, a]
        rows.append({
            "name": f"ablate_stage {f} {a}", "route": "cuda",
            "source": "fftw3_tpu_torch/csrc/ablate_stage.cu",
            "replaces": "experiments/ablate_stage.py:142",
            "launches": ablate.launches[f, a], "on_path": False,
            "max_abs_err": errs[f, a], "ms": sum(ts) / 2,
            "plain_ms": k1_row["plain_ms"], "bound_ms": k1_row["bound_ms"],
            "bound_by": k1_row["bound_by"],
            "library_ms": k1_row["library_ms"],
            "stage_form": "dense" if f == "dense" else S.form_label(rad)})
    del xr, xi
    torch.cuda.empty_cache()
    return rows


#: E8's shapes: K2's at the 512^3 path's axis 0 and at the 2-D r2c's
#: planes (L = 1024 in whole tiles, L = 1025 with the masked edge tile),
#: the last-axis rows at the same points, and K2's tile width swept at the
#: first shape
E8_INNER = [(1, CUBE, CUBE * CUBE), (8, 2048, 1024), (8, 2048, 1025)]
E8_ROWS = [(CUBE * CUBE, CUBE), (8 * 1024, 2048)]
E8_TL_SWEEP = [4, 8]


def copy_floor_phase(rng, dev, smi_line):
    """Phase 26, E8: the copy floors of K2 and K1 (``ops/copyfloor.py``):
    K2's tile load and store, at its own tile width and at narrower ones,
    and K1's row load and store, each timed twice in one interleaved order
    and back beside K2 (K1) at the same shape.  Every arm's output is held
    against 1.0001 * x bit for bit, K2's and K1's against their twins.
    Returns the arms' rows of the kernels line (launches: this phase's, the
    arms are on no user path)."""
    arms = {}                    # label -> (fn, args, kind, shape, tl)
    for shape in E8_INNER:
        xr, xi = planes(rng, shape, dev)
        n = shape[1]
        rad = S.choose_radices(n)
        tab = S.device_table(n, tuple(rad), -1, dev)
        tl = inner.tile_width(n, shape[2])
        kr, ki = inner.inner_c2c_cuda(xr, xi, rad, tab)
        tr, ti = inner.inner_c2c_torch(xr, xi, rad, -1)
        twin_err(f"inner_c2c {shape}", kr, ki, tr, ti)
        del kr, ki, tr, ti
        arms[f"K2 {shape}"] = (
            lambda a, b, rad=rad, tab=tab: inner.inner_c2c_cuda(a, b, rad,
                                                                tab),
            (xr, xi), "K2", shape, tl)
        for t in [tl] + (E8_TL_SWEEP if shape == E8_INNER[0] else []):
            arms[f"E8 inner {shape} tl={t}"] = (
                lambda a, b, t=t, own=t == tl: copyfloor.copy_inner_cuda(
                    a, b, None if own else t),
                (xr, xi), "inner", shape, t)
    for shape in E8_ROWS:
        xr, xi = planes(rng, shape, dev)
        n = shape[1]
        rad = S.choose_radices(n)
        tab = S.device_table(n, tuple(rad), -1, dev)
        arms[f"K1 {shape}"] = (
            lambda a, b, rad=rad, tab=tab: S.stockham_c2c_cuda(a, b, rad,
                                                               tab),
            (xr, xi), "K1", shape, 0)
        arms[f"E8 rows {shape}"] = (copyfloor.copy_rows_cuda, (xr, xi),
                                    "rows", shape, 0)
    del xr, xi
    copyfloor.launches.clear()
    errs = {}
    for label, (fn, args, kind, shape, _) in arms.items():
        if kind in ("inner", "rows"):
            yr, yi = fn(*args)
            wr, wi = copyfloor.copy_twin(*args)
            errs[label] = max(float((yr - wr).abs().max()),
                              float((yi - wi).abs().max()))
            check(errs[label] == 0.0, f"{label}: not 1.0001 * x")
            del yr, yi, wr, wi
    torch.cuda.synchronize()
    times = {k: [] for k in arms}
    for k in list(arms) + list(arms)[::-1]:
        times[k].append(time_ms(arms[k][0], arms[k][1]))
    for k, ts in times.items():
        print(f"[26] {k}: {ts[0]:.3f} / {ts[1]:.3f} ms ({smi_line})")
    best = {k: min(ts) for k, ts in times.items()}
    rows = []
    for label, (fn, args, kind, shape, tl) in arms.items():
        if kind not in ("inner", "rows"):
            continue
        of = "K2" if kind == "inner" else "K1"
        kern = best[f"{of} {shape}"]
        print(f"[26] {of} {shape} {kern:.3f} ms over E8 {kind} tl={tl} "
              f"{best[label]:.3f} ms: {kern / best[label]:.2f}x, "
              f"+{kern - best[label]:.3f} ms ({smi_line})")
        pts = math.prod(shape)
        bms, by = bound(16.0 * pts, 0.0)
        both = torch.stack(args)
        lib = time_ms(torch.clone, (both,))
        del both
        rows.append({
            "name": f"copy_floor {kind} {shape} tl={tl}", "route": "cuda",
            "source": "fftw3_tpu_torch/csrc/copy_floor.cu",
            "replaces": "experiments/copy_inner.py:"
                        + ("38" if kind == "inner" else "69"),
            "launches": copyfloor.launches[kind, shape, tl],
            "on_path": False, "max_abs_err": errs[label],
            "ms": sum(times[label]) / 2,
            "plain_ms": time_ms(copyfloor.copy_twin, args),
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "floor_of": of, "kernel_ms": kern})
    del arms, args
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# P1, the toolchain canary (phase 2), and the r2r path (phases 27-34)
# ---------------------------------------------------------------------------

def probe_phase(dev, smi_line):
    """P1 right after the build: ``toolchain_probe.run_probes`` must PASS
    (every ``csrc/*.cu`` built, the probe kernel launched and computed
    G @ x).  Then the probe kernel against its twin and float64 at the
    probe's 128 x 128, and its time beside ``torch.matmul``'s.  Returns
    P1's row of the kernels line (launches: the probe's own)."""
    reset_counts()
    res = toolchain_probe.run_probes(sys.stdout)
    counts = read_counts()
    check(res == {"build_launch": True}, f"toolchain probes: {res}")
    check(counts == only(probe_matmul=2),
          f"the probe launched {counts}, not two probe kernels")
    n = toolchain_probe.N
    prng = np.random.default_rng(1)
    g, x = (torch.from_numpy(prng.standard_normal((n, n), np.float32))
            .to(dev) for _ in range(2))
    y = toolchain_probe.matmul_cuda(g, x)
    tw = toolchain_probe.matmul_torch(g, x)
    err = float((y - tw).abs().max())
    rel = err / float(tw.abs().max())
    e64 = relerr(y.double(), g.double() @ x.double())
    check(rel <= TOL and e64 <= TOL,
          f"probe kernel: kernel-twin {rel:.2e}, kernel-f64 {e64:.2e}")
    row = {"name": "probe_matmul", "route": "cuda",
           "source": "fftw3_tpu_torch/csrc/probe.cu",
           "replaces": "fftw3_tpu/toolchain_probe.py:112",
           "launches": counts["probe_matmul"], "max_abs_err": err,
           "rel_err": rel,
           "ms": time_ms(toolchain_probe.matmul_cuda, (g, x)),
           "plain_ms": time_ms(toolchain_probe.matmul_torch, (g, x)),
           "library_ms": time_ms(torch.matmul, (g, x))}
    row["bound_ms"], row["bound_by"] = bound(3 * 4.0 * n * n, 2.0 * n ** 3)
    print(f"[2] P1 probe kernel ({n}, {n}): {row['ms'] * 1e3:.2f} us, twin "
          f"{row['plain_ms'] * 1e3:.2f} us, torch.matmul "
          f"{row['library_ms'] * 1e3:.2f} us, bound "
          f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}; the kernel's "
          f"time is launch latency); kernel-twin max abs {err:.2e}, "
          f"kernel-f64 {e64:.2e} ({smi_line})")
    return row


def r2r_wisdom(name: str) -> str:
    """``R2R_PINS[name]`` as a ``fftw3_tpu`` wisdom export (reference
    format): the entry ``bench_dct2``'s ``_mkplans`` puts in the reference
    planner (patience 99), under the reference's CPU signature, which
    ``import_reference_wisdom`` re-keys to the card."""
    return ref_wisdom(*R2R_PINS[name])


def ref_wisdom(kind: str, n: int, batch: int, desc) -> str:
    """A ``fftw3_tpu`` wisdom export (reference format) pinning the float32
    problem (kind, n) at `batch` transforms per call to `desc` (patience
    99), under the reference's CPU signature, which
    ``import_reference_wisdom`` re-keys to the card."""
    sig = "cpu-cpu-jax0.9.0-jl0.9.0-pvd9747e2d"
    key = f"{kind}:{n}:float32:{sig}:b{P._batch_bucket(batch)}"
    return json.dumps({"format": P.REFERENCE_WISDOM_FORMAT,
                       "signature": sig,
                       "entries": {key: {"desc": desc, "patience": 99,
                                         "cost": 0.0}}}, indent=1)


def r2r_oracle(kind: str, x: np.ndarray) -> np.ndarray:
    """float64 r2r of the last axis of numpy `x`, FFTW's unnormalized
    definitions: scipy.fft's DCT/DST (norm=None is FFTW's), its FFT for DHT
    and the halfcomplex pair."""
    import scipy.fft as sf
    typed = {"redft00": (sf.dct, 1), "redft10": (sf.dct, 2),
             "redft01": (sf.dct, 3), "redft11": (sf.dct, 4),
             "rodft00": (sf.dst, 1), "rodft10": (sf.dst, 2),
             "rodft01": (sf.dst, 3), "rodft11": (sf.dst, 4)}
    x = np.asarray(x, np.float64)
    if kind in typed:
        fn, t = typed[kind]
        return fn(x, type=t, axis=-1, workers=-1)
    n = x.shape[-1]
    h = (n + 1) // 2
    if kind == "dht":
        X = sf.fft(x, axis=-1, workers=-1)
        return X.real - X.imag
    if kind == "r2hc":
        X = sf.rfft(x, axis=-1, workers=-1)
        return np.concatenate([X.real, X.imag[..., 1:h][..., ::-1]], -1)
    X = x[..., :n // 2 + 1].astype(np.complex128)
    X.imag[..., 1:h] = x[..., n // 2 + 1:][..., ::-1]
    return sf.irfft(X, n, axis=-1, workers=-1) * n                 # hc2r


def oracle_err(kind: str, x: torch.Tensor, y: torch.Tensor) -> float:
    """Max-abs error over max-abs of all of `y` against the float64 oracle
    of `x`, after checking that `y` is finite and of `x`'s shape."""
    check(tuple(y.shape) == tuple(x.shape), f"{kind}: shape {y.shape}")
    check(bool(torch.isfinite(y).all()), f"{kind}: non-finite output")
    want = r2r_oracle(kind, x.double().cpu().numpy())
    got = y.double().cpu().numpy()
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def launched(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def r2r_plan(shape, kind, label, pin=None, flags=None):
    """plan_r2r over the last axis of `shape` on the card, from no wisdom,
    or pinned by ``r2r_wisdom(pin)``."""
    ft.forget_wisdom()
    if pin is not None:
        check(ft.import_reference_wisdom(r2r_wisdom(pin), device="cuda"),
              f"reference wisdom {pin} refused")
    t0 = time.perf_counter()
    p = ft.plan_r2r(shape, [kind], axes=(len(shape) - 1,), device="cuda",
                    flags=ft.ESTIMATE if flags is None else flags)
    if pin is not None:
        check(p.descriptors == {len(shape) - 1: R2R_PINS[pin][3]},
              f"{label}: pinned plan {p!r}")
    return p, time.perf_counter() - t0


def run_counted(fn, *args):
    """(output, launches) of one call with every count set to 0 first."""
    torch.cuda.synchronize()
    reset_counts()
    y = fn(*args)
    torch.cuda.synchronize()
    return y, read_counts()


def r2r_phases(rng, dev, smi_line, seed):
    """Phases 27-34, the r2r path; returns the results of its JSON line."""
    f32 = np.float32
    pl = ft.the_planner
    res = {"card": smi_line}

    # -- 27. the suite cell: DCT-II at (65536, 512), four arms --------------
    B, n = R2R_1D
    x = real_rows(rng, R2R_1D, dev)
    arms, out27 = {}, {}
    for label, pin, flags in (("ESTIMATE", None, None),
                              ("MEASURE", None, ft.MEASURE),
                              ("K4 pinned", "dct2 K4", None),
                              ("matmul pinned", "dct2 matmul", None)):
        nm = pl.stats["nmeasure"]
        p, secs = r2r_plan(R2R_1D, "redft10", label, pin, flags)
        if label == "MEASURE":
            raced = pl._candidates("redft10", n, f32, K.PATIENCE_MEASURE, B, dev)
            print(f"[27] MEASURE raced {[P.sprint_desc(d) for d in raced]} "
                  f"({pl.stats['nmeasure'] - nm} candidates timed over the "
                  f"whole search, {pl.stats['nmeasure_failed']} failed) in "
                  f"{secs:.1f} s; picked {P.sprint_desc(p.descriptors[1])}")
            check(pl.stats["nmeasure_failed"] == 0,
                  f"MEASURE: {pl.stats.get('last_measure_error')}")
        y, c = run_counted(p.apply_split, x)
        e = oracle_err("redft10", x, y)
        check(e <= TOL, f"DCT-II {label}: rel err {e:.2e}")
        print(f"[27] DCT-II {R2R_1D} {label}: {p!r}; launches per call "
              f"{launched(c)}; rel err vs float64 (all rows) {e:.2e}")
        arms[label] = p
        out27[label] = {"desc": P.sprint_desc(p.descriptors[1]),
                        "launches": launched(c), "rel_err": e}
        del y
    check(out27["K4 pinned"]["launches"] == {"r2c": 1},
          f"the K4 arm launched {out27['K4 pinned']['launches']}")
    check(out27["matmul pinned"]["launches"] == {},
          "the matmul arm launched a kernel of the port")
    yk, c = run_counted(arms["K4 pinned"].execute, x)
    check(launched(c) == {"r2c": 1}, f"execute launched {c}")
    check(oracle_err("redft10", x, yk) <= TOL, "DCT-II execute")
    del yk
    # K4 against its twin over every row, at the (65536, 512) and on the
    # Makhoul-permuted rows that the pinned arm hands it
    twins = {}
    rad = R2R_PINS["dct2 K4"][3]["child"]["radices"]
    xp = x.index_select(-1, r2r._makhoul_index(n, False, dev))
    k4r, k4i = RS.r2c_cuda(xp, rad, RS.device_table(n, tuple(rad), -1, dev))
    tr, ti = RS.r2c_torch(xp, rad)
    twins["r2c"] = twin_err(f"K4 {tuple(xp.shape)} on the DCT-II path", k4r,
                            k4i, tr, ti)
    print(f"[27] K4 {tuple(xp.shape)} ({S.form_label(rad)}) on the DCT-II "
          f"path's rows: kernel-twin max abs {twins['r2c'][0]:.2e}, rel "
          f"{twins['r2c'][1]:.2e} (all rows)")
    del xp, tr, ti
    times = {label: [] for label in arms}
    for label in list(arms) + list(arms)[::-1]:
        times[label].append(time_ms(arms[label].apply_split, (x,)))
    t_rfft = time_ms(torch.fft.rfft, (x,))
    b27, by27 = bound(8.0 * B * n, 0.0)
    for label, ts in times.items():
        out27[label]["ms"] = ts
        print(f"[27] DCT-II {label}: {ts[0]:.3f} / {ts[1]:.3f} ms "
              f"({smi_line})")
    print(f"[27] torch.fft.rfft {R2R_1D} (the reduction's floor; PyTorch "
          f"has no DCT) {t_rfft:.3f} ms; bound {b27:.3f} ms ({by27}: 4 B "
          f"in, 4 B out per point) ({smi_line})")
    # the gradient of the K4 arm: the transpose of the kind matrix
    M = torch.from_numpy(matrices.r2r_matrix("redft10", n)).to(dev)
    xg = x.clone().requires_grad_()
    gy = real_rows(rng, R2R_1D, dev)
    torch.cuda.synchronize()
    reset_counts()
    arms["K4 pinned"].apply_split(xg).backward(gy)
    torch.cuda.synchronize()
    cg = launched(read_counts())
    eg = relerr(xg.grad.double(), gy.double() @ M.T)
    print(f"[27] gradient of the K4 arm: launches forward + backward {cg}; "
          f"rel err vs float64 g @ M^T (all rows) {eg:.2e}")
    check(eg <= TOL and cg.get("r2c") == 1, "DCT-II K4 gradient")
    res["dct2"] = {"shape": R2R_1D, "arms": out27, "rfft_ms": t_rfft,
                   "bound_ms": b27, "bound_by": by27,
                   "measure_pick": out27["MEASURE"]["desc"],
                   "grad_rel_err": eg, "grad_launches": cg}
    del xg, gy, M
    torch.cuda.empty_cache()

    # -- 28. DCT-III pinned to K6; the round trip --------------------------
    p3, _ = r2r_plan(R2R_1D, "redft01", "DCT-III", "dct3 K6")
    y2 = arms["K4 pinned"].apply_split(x)
    z, c = run_counted(p3.apply_split, y2)
    check(launched(c) == {"c2r": 1}, f"the DCT-III arm launched {c}")
    # K6 against its twin over every row at the arm's (65536, 257) planes,
    # on the half spectra K4 gave above
    rad3 = R2R_PINS["dct3 K6"][3]["child"]["radices"]
    k6 = RS.c2r_cuda(k4r, k4i, rad3, RS.device_table(n, tuple(rad3), +1, dev))
    t6 = RS.c2r_torch(k4r, k4i, rad3)
    twins["c2r"] = twin_err(f"K6 {tuple(k4r.shape)} on the DCT-III path", k6,
                            torch.zeros_like(k6), t6, torch.zeros_like(t6))
    t6 = RS.c2r_torch(k4r, k4i, rad3, "all")
    eb = twin_err(f"K6 {tuple(k4r.shape)} on the DCT-III path vs the "
                  "butterfly twin", k6, torch.zeros_like(k6), t6,
                  torch.zeros_like(t6))[1]
    print(f"[28] K6 {tuple(k4r.shape)} -> {tuple(k6.shape)} "
          f"({S.form_label(rad3)}): kernel-twin max abs "
          f"{twins['c2r'][0]:.2e}, rel {twins['c2r'][1]:.2e}; kernel-"
          f"butterfly twin rel {eb:.2e} (all rows)")
    del k4r, k4i, k6, t6
    N2 = K.logical_size(ft.Kind.REDFT10, n)
    e_rt = relerr(z, N2 * x)
    e3 = oracle_err("redft01", y2, z)
    t3 = time_ms(p3.apply_split, (y2,))
    print(f"[28] DCT-III {R2R_1D} {p3!r}: launches {launched(c)}; "
          f"DCT-III(DCT-II(x)) vs {N2} x {e_rt:.2e}; vs float64 {e3:.2e}; "
          f"{t3:.3f} ms ({smi_line})")
    check(e_rt <= TOL and e3 <= TOL, "DCT-III")
    res["dct3"] = {"desc": P.sprint_desc(p3.descriptors[1]), "ms": t3,
                   "launches": launched(c), "rel_err": e3,
                   "roundtrip_rel_err": e_rt}
    del y2, z, p3, arms

    # -- 29. DHT at (65536, 1024) under ESTIMATE ---------------------------
    pd, _ = r2r_plan(R2R_DHT, "dht", "DHT")
    xd = real_rows(rng, R2R_DHT, dev)
    yd, c = run_counted(pd.apply_split, xd)
    ed = oracle_err("dht", xd, yd)
    desc = pd.descriptors[1]
    on_k4 = desc["alg"] == "dht_via_r2c" and \
        desc["child"]["alg"] == "pallas_r2c"
    if on_k4:
        check(launched(c) == {"r2c": 1}, f"the DHT plan launched {c}")
    td = time_ms(pd.apply_split, (xd,))
    trd = time_ms(torch.fft.rfft, (xd,))
    print(f"[29] DHT {R2R_DHT} ESTIMATE {pd!r} ({'on K4' if on_k4 else 'not on K4'}); "
          f"launches {launched(c)}; rel err {ed:.2e}; {td:.3f} ms, "
          f"torch.fft.rfft {trd:.3f} ms ({smi_line})")
    check(ed <= TOL, "DHT")
    res["dht"] = {"desc": P.sprint_desc(desc), "ms": td, "rfft_ms": trd,
                  "launches": launched(c), "rel_err": ed}
    del xd, yd, pd

    # -- 30. DCT-IV pinned to the 2n route on K1 ---------------------------
    p4, _ = r2r_plan(R2R_1D, "redft11", "DCT-IV", "dct4 K1")
    y4, c = run_counted(p4.apply_split, x)
    check(launched(c) == {"stockham_c2c": 1}, f"the DCT-IV arm launched {c}")
    # K1 against its twin over every row, on the pre-twiddled, zero-padded
    # (65536, 1024) planes that the arm hands it
    rad4 = R2R_PINS["dct4 K1"][3]["child"]["radices"]
    wjr, wji, _, _ = r2r._dct4_twiddles(n, f32, dev)
    pad = torch.nn.functional.pad
    ar, ai = pad(x * wjr, (0, n)), pad(x * wji, (0, n))
    kr, ki = S.stockham_c2c_cuda(ar, ai, rad4, S.device_table(
        2 * n, tuple(rad4), -1, dev))
    tr, ti = S.stockham_c2c_torch(ar, ai, rad4, -1)
    twins["stockham_c2c"] = twin_err(f"K1 {tuple(ar.shape)} on the DCT-IV "
                                     f"path", kr, ki, tr, ti)
    print(f"[30] K1 {tuple(ar.shape)} ({S.form_label(rad4)}) on the DCT-IV "
          f"path's planes: kernel-twin max abs "
          f"{twins['stockham_c2c'][0]:.2e}, rel "
          f"{twins['stockham_c2c'][1]:.2e} (all rows)")
    del ar, ai, kr, ki, tr, ti
    e4 = oracle_err("redft11", x, y4)
    t4 = time_ms(p4.apply_split, (x,))
    print(f"[30] DCT-IV {R2R_1D} {p4!r}: launches {launched(c)}; rel err "
          f"{e4:.2e}; {t4:.3f} ms ({smi_line})")
    check(e4 <= TOL, "DCT-IV")
    res["dct4"] = {"desc": P.sprint_desc(p4.descriptors[1]), "ms": t4,
                   "launches": launched(c), "rel_err": e4}
    del x, y4, p4
    torch.cuda.empty_cache()

    # -- 31. every kind and algorithm over a case grid ---------------------
    seen, worst, ncases = set(), 0.0, 0
    grid_pl = P.Planner()
    for kind, m in R2R_GRID:
        xg = real_rows(rng, (R2R_GRID_BATCH, m), dev)
        for d in grid_pl._candidates(kind, m, f32, 0, R2R_GRID_BATCH, dev):
            fn = r2r.build_r2r(d, f32, dev)
            y, c = run_counted(fn, xg)
            e = oracle_err(kind, xg, y)
            print(f"[31] {kind} n={m} {P.sprint_desc(d)}: launches "
                  f"{launched(c)}; rel err {e:.2e}")
            check(e <= TOL, f"{kind} n={m} {P.sprint_desc(d)}: {e:.2e}")
            seen.add(d["alg"])
            worst, ncases = max(worst, e), ncases + 1
            del y
        del xg
    check(seen == r2r.ALGS, f"the grid missed {sorted(r2r.ALGS - seen)}")
    print(f"[31] {ncases} cases at B={R2R_GRID_BATCH}, all "
          f"{len(seen)} algorithms, worst rel err {worst:.2e}")
    res["grid"] = {"cases": ncases, "algorithms": len(seen),
                   "worst_rel_err": worst}

    # -- 32. 3-D DCT-II, the Neumann Poisson transform ---------------------
    cube = (R2R_CUBE,) * 3
    xc = real_rows(rng, cube, dev)
    Mc = torch.from_numpy(matrices.r2r_matrix("redft10", R2R_CUBE)).to(dev)
    want = torch.einsum("ijk,ia,jb,kc->abc", xc.double(), Mc, Mc, Mc)
    # K4 against its twin over every row at the pinned cube's last axis:
    # (65536, 256) Makhoul-permuted rows
    radc = R2R_PINS["cube K4"][3]["child"]["radices"]
    xp = xc.reshape(-1, R2R_CUBE).index_select(
        -1, r2r._makhoul_index(R2R_CUBE, False, dev))
    kr, ki = RS.r2c_cuda(xp, radc, RS.device_table(R2R_CUBE, tuple(radc),
                                                   -1, dev))
    tr, ti = RS.r2c_torch(xp, radc)
    twins["r2c cube"] = twin_err(f"K4 {tuple(xp.shape)} on the 3-D DCT-II "
                                 f"path", kr, ki, tr, ti)
    print(f"[32] K4 {tuple(xp.shape)} ({S.form_label(radc)}) on the 3-D "
          f"path's last-axis rows: kernel-twin max abs "
          f"{twins['r2c cube'][0]:.2e}, rel {twins['r2c cube'][1]:.2e} "
          f"(all rows)")
    del xp, kr, ki, tr, ti
    out32 = {}
    for label, pin in (("ESTIMATE", None), ("K4 pinned", "cube K4")):
        ft.forget_wisdom()
        if pin:
            check(ft.import_reference_wisdom(r2r_wisdom(pin), device="cuda"),
                  "cube wisdom refused")
        p = ft.plan_r2r_3d(*cube, "redft10", "redft10", "redft10",
                           device="cuda")
        if pin:
            check(all(d == R2R_PINS[pin][3] for d in p.descriptors.values()),
                  f"pinned cube {p!r}")
        y, c = run_counted(p.apply_split, xc)
        e = relerr(y.double(), want)
        if pin:
            check(launched(c) == {"r2c": 3},
                  f"the pinned cube launched {c}")
        t = time_ms(p.apply_split, (xc,))
        print(f"[32] plan_r2r_3d{cube} REDFT10 x3 {label}: {p!r}; launches "
              f"{launched(c)} (axes 0 and 1 behind movedim; phase 34 "
              f"profiles it); rel err vs float64 {e:.2e}; {t:.3f} ms "
              f"({smi_line})")
        check(e <= TOL, f"3-D DCT-II {label}: {e:.2e}")
        out32[label] = {"desc": repr(p), "ms": t, "launches": launched(c),
                        "rel_err": e}
        del y
    b32, by32 = bound(8.0 * xc.numel(), 0.0)
    res["cube"] = {"shape": cube, "arms": out32, "bound_ms": b32,
                   "bound_by": by32}
    res["twins"] = {k: {"max_abs_err": e, "rel_err": r}
                    for k, (e, r) in twins.items()}
    del xc, want, Mc
    torch.cuda.empty_cache()

    # -- 33. float64 DCT-II under ESTIMATE (the eager df32 child) ----------
    ft.forget_wisdom()
    p64 = ft.plan_r2r(R2R_F64, ["redft10"], axes=(1,), dtype="float64",
                      device="cuda")
    x64 = torch.from_numpy(rng.standard_normal(R2R_F64)).to(dev)
    y64, c = run_counted(p64.apply_split, x64)
    e64 = oracle_err("redft10", x64, y64)
    t64 = time_few(p64.apply_split, (x64,))
    print(f"[33] float64 DCT-II {R2R_F64} ESTIMATE {p64!r}: launches "
          f"{launched(c)}; rel err {e64:.2e}; {t64:.3f} ms ({smi_line})")
    check(e64 <= F64_TOL, f"float64 DCT-II: {e64:.2e}")
    res["f64"] = {"shape": R2R_F64, "desc": P.sprint_desc(p64.descriptors[1]),
                  "ms": t64, "launches": launched(c), "rel_err": e64}
    del x64, y64, p64
    torch.cuda.empty_cache()

    # -- 34. the r2r paths profiled in a fresh process ---------------------
    sys.stdout.flush()
    r = subprocess.run([sys.executable, __file__, "--profile-paths", "r2r",
                        "--seed", str(seed)], timeout=600)
    check(r.returncode == 0, "the profile of the r2r paths failed")
    return res


def profile_r2r_paths(rng, dev, smi_line) -> None:
    """``torch.profiler`` breakdowns of the r2r paths: the pinned K4 DCT-II
    at (65536, 512) (the gather, twiddle and concatenation passes beside
    K4), the pinned K6 DCT-III at the same shape, the ESTIMATE DHT at
    (65536, 1024) and the pinned 3-D DCT-II (K4 behind ``movedim``)."""
    x = real_rows(rng, R2R_1D, dev)
    p, _ = r2r_plan(R2R_1D, "redft10", "DCT-II", "dct2 K4")
    profile_calls(f"DCT-II K4 pinned {R2R_1D} apply_split", p.apply_split,
                  (x,), smi_line, tag="[34]")
    p, _ = r2r_plan(R2R_1D, "redft01", "DCT-III", "dct3 K6")
    profile_calls(f"DCT-III K6 pinned {R2R_1D} apply_split", p.apply_split,
                  (x,), smi_line, tag="[34]")
    del x, p
    p, _ = r2r_plan(R2R_DHT, "dht", "DHT")
    profile_calls(f"DHT ESTIMATE {R2R_DHT} apply_split", p.apply_split,
                  (real_rows(rng, R2R_DHT, dev),), smi_line, tag="[34]")
    del p
    ft.forget_wisdom()
    check(ft.import_reference_wisdom(r2r_wisdom("cube K4"), device="cuda"),
          "cube wisdom refused")
    cube = (R2R_CUBE,) * 3
    p = ft.plan_r2r_3d(*cube, "redft10", "redft10", "redft10", device="cuda")
    profile_calls(f"plan_r2r_3d{cube} K4 pinned apply_split", p.apply_split,
                  (real_rows(rng, cube, dev),), smi_line, tag="[34]")


def k8_phase(rng, dev, smi_line):
    """Phase 45, K8: each direction at (K8_ROWS, n) for every n of K8_NS
    against its plain version and float64, one launch a pass (the level
    plan compiled in at n = 512 alone); then ESTIMATE's plan at a 512^3
    pass's rows (K8_PASS), one launch a call, against the plain version
    over every row, and each direction timed beside its plain version and
    ``torch.fft.rfft``.  Returns the kernels
    line's row (DCT-II's times; DCT-III's under ``dct3_*``)."""
    f32 = np.float32
    worst = (0.0, 0.0)
    for kind in ("redft10", "redft01"):
        for n in K8_NS:
            rad = S.choose_radices(n // 2)
            fn = r2r.build_r2r({"alg": f"fused_{kind}", "n": n,
                                "radices": rad}, f32, dev)
            x = real_rows(rng, (K8_ROWS, n), dev)
            y, c = run_counted(fn, x)
            check(launched(c) == {"redft": 1, **({"redft_fixed": 1}
                                                 if n == 512 else {})},
                  f"K8 {kind} n={n} launched {launched(c)}")
            e_t = relerr(y, redft.redft_torch(x, kind, rad))
            e_o = oracle_err(kind, x, y)
            print(f"[45] K8 {kind} ({K8_ROWS}, {n}) {S.form_label(rad)}: "
                  f"kernel-twin {e_t:.2e}, kernel-f64 {e_o:.2e}")
            check(e_t <= TOL and e_o <= TOL,
                  f"K8 {kind} n={n}: {e_t:.2e} / {e_o:.2e}")
            worst = (max(worst[0], e_t), max(worst[1], e_o))
    B, n = K8_PASS
    x = real_rows(rng, K8_PASS, dev)
    rad = S.choose_radices(n // 2)
    times, max_abs = {}, {}
    for kind in ("redft10", "redft01"):
        p, _ = r2r_plan(K8_PASS, kind, f"K8 {kind}")
        check(p.descriptors == {1: {"alg": f"fused_{kind}", "n": n,
                                    "radices": rad}},
              f"ESTIMATE at {K8_PASS}: {p!r}")
        y, c = run_counted(p.apply_split, x)
        check(launched(c) == {"redft": 1, "redft_fixed": 1},
              f"the {kind} plan launched {launched(c)}")
        e = relerr(y[:ORACLE_ROWS].double().cpu(), torch.from_numpy(
            r2r_oracle(kind, x[:ORACLE_ROWS].cpu().numpy())))
        twin = redft.redft_torch(x, kind, rad)
        max_abs[kind] = float((y - twin).abs().max())
        e_t = max_abs[kind] / float(twin.abs().max())
        print(f"[45] K8 {kind} {K8_PASS} ESTIMATE {p!r}: launches "
              f"{launched(c)}; kernel-twin max abs {max_abs[kind]:.2e}, rel "
              f"{e_t:.2e} (all rows); kernel-f64 {e:.2e} ({ORACLE_ROWS} "
              f"rows)")
        check(e <= TOL and e_t <= TOL, f"K8 {kind} at {K8_PASS}: {e:.2e} / "
              f"{e_t:.2e}")
        worst = (max(worst[0], e_t), worst[1])
        del twin
        times[kind] = (time_ms(p.apply_split, (x,)), c["redft"],
                       time_ms(lambda a, k=kind: redft.redft_torch(a, k, rad),
                               (x,)))
        del y
    t_rfft = time_ms(torch.fft.rfft, (x,))
    b, by = bound(8.0 * B * n, 2.5 * B * n * math.log2(n))
    for kind, (t, _, tp) in times.items():
        print(f"[45] K8 {kind} {K8_PASS} (one pass of a 512^3 solve): "
              f"kernel {t:.3f} ms, plain version {tp:.3f} ms, torch.fft.rfft "
              f"{t_rfft:.3f} ms, bound {b:.3f} ms ({by}; "
              f"{100 * b / t:.1f}% of it) ({smi_line})")
    del x
    torch.cuda.empty_cache()
    return {"name": "redft", "route": "cuda",
            "source": "fftw3_tpu_torch/csrc/redft.cu",
            "replaces": "fftw3_tpu/ops/r2r.py:186 (no Pallas kernel: "
                        "redft10_half and redft01_half around K4 and K6)",
            "launches": times["redft10"][1],
            "max_abs_err": max(max_abs.values()),
            "rel_err": worst[0], "f64_rel_err": worst[1],
            "ms": times["redft10"][0], "plain_ms": times["redft10"][2],
            "dct3_ms": times["redft01"][0],
            "dct3_plain_ms": times["redft01"][2],
            "library_ms": t_rfft, "bound_ms": b, "bound_by": by}


# ---------------------------------------------------------------------------
# phase 35, the dense products under "high"; phases 36-38, the measurement
# kernels E1, E2/E3 and E7
# ---------------------------------------------------------------------------

#: phase 35: the dense solvers pinned by reference-format wisdom under
#: torch.set_float32_matmul_precision("high"): name -> (kind, n, batch,
#: descriptor); ESTIMATE's own choices at n = 64 and n = 256 on the card
#: (``mixed-16``), the real pair at n = 256; the DCT-II's ``r2r_matmul`` is
#: ``R2R_PINS["dct2 matmul"]``
DENSE_PINS = {
    "direct": ("c2c", 64, 65536, {"alg": "direct", "n": 64}),
    "mixed": ("c2c", 256, 65536, {"alg": "mixed", "n": 256, "p": 16,
                                  "child": {"alg": "direct", "n": 16}}),
    "r2c_dense": ("r2c", 256, 65536, {"alg": "r2c_dense", "n": 256}),
    "c2r_dense": ("c2r", 256, 65536, {"alg": "c2r_dense", "n": 256}),
}


def interleaved(arms):
    """{label: [ms, ms]}: each arm of {label: (fn, args)} timed twice, in
    one order and back (``time_ms``)."""
    times = {k: [] for k in arms}
    for k in list(arms) + list(arms)[::-1]:
        times[k].append(time_ms(*arms[k]))
    return times


def dense_grad_err(kind, n, fn, xs, rng):
    """Max-abs error over max-abs of the gradient of sum(y * w), for a
    random cotangent w, through `fn` (float32, under the setting in force)
    against the same gradient in float64: through ``torch.fft`` on the card
    (``fft``, ``rfft``, ``irfft`` times n), or for the DCT-II, whose
    adjoint is FFTW's REDFT01 plus the first input column, from
    ``r2r_oracle``."""
    xs = [x.detach().requires_grad_() for x in xs]
    ys = fn(*xs)
    ys = ys if isinstance(ys, tuple) else (ys,)
    ws = [real_rows(rng, tuple(y.shape), y.device) for y in ys]
    got = torch.autograd.grad(sum((y * w).sum() for y, w in zip(ys, ws)),
                              xs)
    del ys
    if kind == "redft10":
        w = ws[0].double().cpu().numpy()
        want = [torch.from_numpy(r2r_oracle("redft01", w) + w[:, :1])]
    else:
        x64 = [x.detach().double().requires_grad_() for x in xs]
        if kind == "c2c":
            y = torch.fft.fft(torch.complex(*x64), dim=-1)
            y64 = (y.real, y.imag)
        elif kind == "r2c":
            y = torch.fft.rfft(x64[0], dim=-1)
            y64 = (y.real, y.imag)
        else:
            y64 = (torch.fft.irfft(torch.complex(*x64), n, dim=-1) * n,)
        want = torch.autograd.grad(
            sum((y * w.double()).sum() for y, w in zip(y64, ws)), x64)
    for g, v in zip(got, want):
        check(tuple(g.shape) == tuple(v.shape)
              and bool(torch.isfinite(g).all()), f"{kind}: bad gradient")
    return max(relerr(g.double().cpu(), v.cpu()) for g, v in zip(got, want))


def dense_phase(rng, dev, smi_line):
    """Phase 35: under ``torch.set_float32_matmul_precision("high")``
    (TF32 for float32 products), each dense solver pinned by
    reference-format wisdom and run through its plan, held against float64
    over every output row at TOL, and its gradient too (``dense_grad_err``;
    autograd runs the backward's products after the forward's pin has
    exited); then the setting reads back "high" and is restored to
    "highest".  Returns {solver: rel err, "<solver> grad": rel err}."""
    torch.set_float32_matmul_precision("high")
    a = real_rows(rng, (4096, 256), dev)
    m = real_rows(rng, (256, 256), dev)
    want = a.double() @ m.double()
    raw = relerr(torch.matmul(a, m).double(), want)
    pinned = relerr(exact_matmul(a, m).double(), want)
    print(f"[35] under 'high' (cuda.matmul.fp32_precision "
          f"{getattr(torch.backends.cuda.matmul, 'fp32_precision', '-')}): "
          f"(4096, 256) @ (256, 256) by torch.matmul {raw:.2e}, by "
          f"exact_matmul {pinned:.2e} against float64")
    check(pinned <= TOL, "exact_matmul over tolerance under 'high'")
    errs = {"torch.matmul unpinned": raw}
    for name, (kind, n, batch, desc) in DENSE_PINS.items():
        ft.forget_wisdom()
        check(ft.import_reference_wisdom(ref_wisdom(kind, n, batch, desc),
                                         device="cuda"),
              f"reference wisdom for {name} refused")
        if kind == "c2c":
            plan = ft.plan_many_dft([n], howmany=batch, device="cuda")
            xs = planes(rng, (batch, n), dev)
            yr, yi = plan.apply_split(*xs)
            got = torch.complex(yr, yi).to(torch.complex128)
            ref = oracle(torch.complex(*xs), (-1,), -1)
        elif kind == "r2c":
            plan = ft.plan_dft_r2c((batch, n), axes=(1,), device="cuda")
            xs = (real_rows(rng, (batch, n), dev),)
            yr, yi = plan.apply_split(*xs)
            got = torch.complex(yr, yi).to(torch.complex128)
            ref = torch.fft.rfft(xs[0].double(), dim=-1)
        else:
            plan = ft.plan_dft_c2r((batch, n), axes=(1,), device="cuda")
            xs = planes(rng, (batch, n // 2 + 1), dev)
            got = plan.apply_split(*xs).double()
            ref = torch.fft.irfft(torch.complex(*(x.double() for x in xs)),
                                  n, dim=-1) * n
        check(plan.descriptors == {1: desc}, f"{name}: pinned plan {plan!r}")
        check(tuple(got.shape) == tuple(ref.shape)
              and bool(torch.isfinite(got).all()), f"{name}: bad output")
        errs[name] = relerr(got, ref)
        del got, ref
        errs[f"{name} grad"] = dense_grad_err(kind, n, plan.apply_split, xs,
                                              rng)
        print(f"[35] {name} ({batch}, {n}) pinned {P.sprint_desc(desc)} "
              f"under 'high': rel err vs float64 over all rows "
              f"{errs[name]:.2e}, gradient {errs[f'{name} grad']:.2e} "
              f"({smi_line})")
        check(errs[name] <= TOL, f"{name} under 'high' over tolerance")
        check(errs[f"{name} grad"] <= TOL,
              f"{name} gradient under 'high' over tolerance")
    p, _ = r2r_plan(R2R_1D, "redft10", "dct2 matmul", pin="dct2 matmul")
    x = real_rows(rng, R2R_1D, dev)
    errs["r2r_matmul"] = oracle_err("redft10", x, p.apply(x))
    errs["r2r_matmul grad"] = dense_grad_err("redft10", R2R_1D[-1], p.apply,
                                             (x,), rng)
    print(f"[35] r2r_matmul DCT-II {R2R_1D} pinned under 'high': rel err "
          f"vs float64 over all rows {errs['r2r_matmul']:.2e}, gradient "
          f"{errs['r2r_matmul grad']:.2e} ({smi_line})")
    check(errs["r2r_matmul"] <= TOL, "r2r_matmul under 'high' over tolerance")
    check(errs["r2r_matmul grad"] <= TOL,
          "r2r_matmul gradient under 'high' over tolerance")
    check(torch.get_float32_matmul_precision() == "high",
          "the dense products did not restore the 'high' setting")
    torch.set_float32_matmul_precision("highest")
    check(torch.get_float32_matmul_precision() == "highest",
          "the 'highest' setting did not come back")
    ft.forget_wisdom()
    torch.cuda.empty_cache()
    return errs


#: E1: K1 at these rows and schedules beside the copy arms
E1_K1_ROWS = 32768
E1_K1 = {1000: [50, 20], 1024: [64, 16]}


def unaligned_phase(rng, dev, smi_line):
    """Phase 36, E1 (``ops/unaligned.py``): y = 1.0001 * x at n = 1000 and
    n = 1024 on the reference's 16.6e6 points, in K1's row geometry
    (``copy``) and through a padded shared-memory tile read by columns
    (``trans``), each held bit for bit against its twin; K1 at (32768,
    1000) [50, 20] and (32768, 1024) [64, 16] held against its twin; all
    timed twice in one interleaved order and back with ``1.0001 * x``.
    Returns the arms' rows of the kernels line (launches: this phase's)."""
    unaligned.launches.clear()
    arms, errs, xs = {}, {}, {}
    for n in (1000, 1024):
        x = xs[n] = real_rows(rng, (unaligned.batch(n), n), dev)
        want = unaligned.unaligned_torch(x)
        for arm in unaligned.ARMS:
            y = unaligned.unaligned_cuda(x, arm)
            errs[arm, n] = float((y - want).abs().max())
            check(errs[arm, n] == 0.0, f"E1 {arm} n={n}: not 1.0001 * x")
            arms[f"E1 {arm} n={n}"] = (
                lambda a, arm=arm: unaligned.unaligned_cuda(a, arm), (x,))
        arms[f"1.0001*x n={n}"] = (unaligned.unaligned_torch, (x,))
        rad = E1_K1[n]
        tab = S.device_table(n, tuple(rad), -1, dev)
        kx = planes(rng, (E1_K1_ROWS, n), dev)
        twin_err(f"K1 ({E1_K1_ROWS}, {n}) {rad}",
                 *S.stockham_c2c_cuda(*kx, rad, tab),
                 *S.stockham_c2c_torch(*kx, rad, -1))
        arms[f"K1 n={n}"] = (
            lambda a, b, rad=rad, tab=tab: S.stockham_c2c_cuda(a, b, rad,
                                                               tab), kx)
        del want, y
    torch.cuda.synchronize()
    times = interleaved(arms)
    for k, ts in times.items():
        print(f"[36] {k}: {ts[0]:.4f} / {ts[1]:.4f} ms ({smi_line})")
    best = {k: min(ts) for k, ts in times.items()}
    for what, pts in (("E1 copy", None), ("E1 trans", None), ("K1", 1)):
        per = {n: best[f"{what} n={n}"] * 1e9
               / ((E1_K1_ROWS if pts else unaligned.batch(n)) * n)
               for n in (1000, 1024)}
        print(f"[36] {what}: {per[1000]:.2f} ps/pt at n = 1000, "
              f"{per[1024]:.2f} at n = 1024: n = 1000 costs "
              f"{per[1000] / per[1024]:.3f}x a point ({smi_line})")
    rows = []
    for n in (1000, 1024):
        x = xs[n]
        bms, by = bound(8.0 * x.numel(), 0.0)
        lib = time_ms(lambda a: torch.mul(a, 1.0001), (x,))
        for arm in unaligned.ARMS:
            ts = times[f"E1 {arm} n={n}"]
            rows.append({
                "name": f"unaligned {arm} n={n}", "route": "cuda",
                "source": "fftw3_tpu_torch/csrc/unaligned.cu",
                "replaces": "experiments/copy1000.py:55",
                "launches": unaligned.launches[arm, n], "on_path": False,
                "max_abs_err": errs[arm, n], "ms": sum(ts) / 2,
                "plain_ms": sum(times[f"1.0001*x n={n}"]) / 2,
                "bound_ms": bms, "bound_by": by, "library_ms": lib,
                "shape": [x.shape[0], n],
                "k1_ms": sum(times[f"K1 n={n}"]) / 2})
    del arms, xs, x
    torch.cuda.empty_cache()
    return rows


#: E2/E3: the reference's own shapes (held against the twins) and the
#: full-width shapes they are timed at, the n = 4096 cell's 16.8e6 points
E2_REF_SHAPES = [(64, 4096), (64, 2048), (256, 2048), (256, 4096)]
E2_TIMED = [(4096, 4096), (8192, 2048)]
E2_ARMS = ("identity", "roundtrip", "stage1_f32", "stage1_tw_perm")


def stage_oracle(xr, xi, arm):
    """float64 of what `arm` computes, on the card, as a complex128
    (rows, n) tensor."""
    R, n = xr.shape
    x = torch.complex(xr.double(), xi.double())
    if arm in ("identity", "roundtrip"):
        return x
    p = stage4096.CASES[n]
    q = n // p
    F = torch.from_numpy(matrices.dft_matrix(p, -1)).to(xr.device)
    y = torch.matmul(F, x.reshape(R, p, q))
    if arm == "stage1_tw_perm":
        w = torch.from_numpy(matrices.twiddle_2d(p, q, -1)).to(xr.device)
        y = (y * w).transpose(1, 2)
    return y.reshape(R, n)


def stage_library(arm, xr, xi):
    """The one PyTorch call computing `arm`'s function, with its inputs:
    ``torch.matmul(G, X)`` on the (rows, 2p, q) stacked planes at full
    precision for the FP32 arms, in bf16 for the bf16 arms; ``clone`` of
    the two planes stacked for the arms that move data only."""
    if arm in ("identity", "roundtrip"):
        return torch.clone, (torch.stack([xr, xi]),)
    p = stage4096.CASES[xr.shape[1]]
    G = torch.from_numpy(stage4096.g_matrix(p)).to(xr.device)
    X = torch.cat([xr.reshape(xr.shape[0], p, -1),
                   xi.reshape(xi.shape[0], p, -1)], 1)
    if arm in ("stage1_ps", "stage1_bf16"):
        return torch.matmul, (G.to(torch.bfloat16), X.to(torch.bfloat16))
    return exact_matmul, (G, X)


def stage_phase(rng, dev, smi_line, wide_tab):
    """Phase 37, E2 and E3 (``ops/stage4096.py``): every arm at every rows
    per block that fits, held against its twin at the reference's four
    shapes and at full width, (4096, 4096) and (8192, 2048), and against
    float64 there (within TOL, but the one-pass bf16 arm, which is a
    measurement arm); then timed twice in one interleaved order and back,
    beside the wide K1 [64, 64] at (4096, 4096).  Returns the arms' rows of
    the kernels line, each at its fastest rows per block."""
    stage4096.launches.clear()
    for shape in E2_REF_SHAPES:
        xr, xi = planes(rng, shape, dev)
        for arm in stage4096.ARMS:
            tr, ti = stage4096.stage_torch(xr, xi, arm)
            for rpb in stage4096.rows_per_block_fit(arm, shape[1]):
                twin_err(f"E2/E3 {arm} {shape} rpb={rpb}",
                         *stage4096.stage_cuda(xr, xi, arm, rpb), tr, ti)
    print(f"[37] every arm at every rows per block within {TOL:g} of its "
          f"twin at {E2_REF_SHAPES}")
    rows = []
    for R, n in E2_TIMED:
        p = stage4096.CASES[n]
        xr, xi = planes(rng, (R, n), dev)
        arms, info = {}, {}
        for arm in stage4096.ARMS:
            o = stage_oracle(xr, xi, arm)
            tr, ti = stage4096.stage_torch(xr, xi, arm)
            e_twin = relerr(torch.complex(tr, ti).to(torch.complex128), o)
            worst, e64 = 0.0, 0.0
            for rpb in stage4096.rows_per_block_fit(arm, n):
                kr, ki = stage4096.stage_cuda(xr, xi, arm, rpb)
                err, _ = twin_err(f"E2/E3 {arm} ({R}, {n}) rpb={rpb}", kr,
                                  ki, tr, ti)
                worst = max(worst, err)
                e64 = max(e64, relerr(torch.complex(kr, ki)
                                      .to(torch.complex128), o))
                arms[arm, rpb] = (
                    lambda a, b, arm=arm, rpb=rpb: stage4096.stage_cuda(
                        a, b, arm, rpb), (xr, xi))
                del kr, ki
            del tr, ti, o
            print(f"[37] {arm} ({R}, {n}) p={p}: kernel vs float64 "
                  f"{e64:.2e}, twin vs float64 {e_twin:.2e}, kernel-twin "
                  f"max abs {worst:.2e}")
            check(arm == "stage1_bf16" or e64 <= TOL,
                  f"E2/E3 {arm} at n={n} over tolerance against float64")
            lib = stage_library(arm, xr, xi)
            info[arm] = {
                "err": worst, "e64": e64,
                "plain_ms": time_ms(lambda a, b, arm=arm:
                                    stage4096.stage_torch(a, b, arm),
                                    (xr, xi)),
                "library_ms": None if lib is None else time_ms(*lib)}
            del lib
        if n == 4096:
            arms["K1 wide", 0] = (
                lambda a, b: S.stockham_c2c_cuda(a, b, [64, 64], wide_tab),
                (xr, xi))
        torch.cuda.synchronize()
        times = interleaved(arms)
        for (arm, rpb), ts in times.items():
            print(f"[37] {arm} ({R}, {n}) rpb={rpb}: {ts[0]:.4f} / "
                  f"{ts[1]:.4f} ms ({smi_line})")
        for arm in stage4096.ARMS:
            sweep = {rpb: sum(times[arm, rpb]) / 2
                     for rpb in stage4096.rows_per_block_fit(arm, n)}
            rpb = min(sweep, key=sweep.get)
            pts = R * n
            flops = {"identity": 0.0, "roundtrip": 0.0,
                     "stage1_f32": 8.0 * p * pts,
                     "stage1_tw_perm": (8.0 * p + 6.0) * pts,
                     "stage1_ps": 24.0 * p * pts,
                     "stage1_bf16": 8.0 * p * pts}[arm]
            rate = (BF16_FLOPS_PER_S if arm in ("stage1_ps", "stage1_bf16")
                    else FP32_FLOPS_PER_S)
            bms, by = bound(16.0 * pts, flops, rate)
            row = {
                "name": f"stage4096 {arm} n={n}", "route": "cuda",
                "source": "fftw3_tpu_torch/csrc/stage4096.cu",
                "replaces": ("experiments/bisect4096.py:29" if arm in E2_ARMS
                             else "experiments/bisect4096b.py:28"),
                "launches": sum(v for (a, nn, _), v in
                                stage4096.launches.items()
                                if a == arm and nn == n),
                "on_path": False, "max_abs_err": info[arm]["err"],
                "rel_err_f64": info[arm]["e64"], "ms": sweep[rpb],
                "plain_ms": info[arm]["plain_ms"], "bound_ms": bms,
                "bound_by": by, "library_ms": info[arm]["library_ms"],
                "shape": [R, n], "rows_per_block": rpb,
                "ms_by_rows_per_block": sweep}
            if n == 4096:
                row["k1_wide_ms"] = sum(times["K1 wide", 0]) / 2
            print(f"[37] {row['name']}: {row['ms']:.4f} ms at rpb={rpb}, "
                  f"twin {row['plain_ms']:.4f}, library "
                  f"{row['library_ms']}, bound {bms:.4f} ms ({by}) "
                  f"({smi_line})")
            rows.append(row)
        del arms, xr, xi
        torch.cuda.empty_cache()
    return rows


def fourstep_twin(desc, xr, xi):
    """The ``pallas4`` plan of `desc` on split (B, n) planes with the
    kernels' twins (the four-step's CPU route, here on the card)."""
    n, p, q = desc["n"], desc["p"], desc["q"]
    fstore = p == (desc.get("tile_b") or 128)
    B = xr.shape[0]
    ar, ai = inner.inner_c2c_torch(xr.reshape(B, p, q), xi.reshape(B, p, q),
                                   S.choose_radices(p), -1)
    zr, zi = S.stockham_c2c_torch(
        ar.reshape(B * p, q), ai.reshape(B * p, q),
        desc.get("radices") or S.choose_radices(q), -1, pretwiddle_p=p,
        store_transposed=fstore)
    if not fstore:
        zr = zr.reshape(B, p, q).transpose(-1, -2)
        zi = zi.reshape(B, p, q).transpose(-1, -2)
    return zr.reshape(B, n), zi.reshape(B, n)


def swap_phase(rng, dev, smi_line):
    """Phase 38, E7 (``ops/swap.py``).  Block 2: the four-step's swap at
    (2048, 32, 128) as a kernel (palT, bit for bit against its twin), as
    ``ops/fourstep.py`` pays it (xlaT, two ``transpose(-1, -2)
    .contiguous()``), and as E8's row copy of the same bytes (the copy
    floor); noT, the bare reshape, is a view and costs nothing on the card.
    Block 1: ``plan_many_dft([4096], howmany=2048)`` pinned by
    reference-format wisdom to each four-step arm, with and without K1's
    fused transposed store, each one K2 and one K1 launch, held against
    float64 and its twins, timed with K1's wide [64, 64] and
    ``torch.fft.fft``.  Returns the rows of the kernels line."""
    B, p, q = swap.BATCH, swap.P, swap.Q
    swap.launches.clear()
    xr, xi = planes(rng, (B, p, q), dev)
    kr, ki = swap.swap_cuda(xr, xi)
    tr, ti = swap.swap_torch(xr, xi)
    check(torch.equal(kr, tr) and torch.equal(ki, ti), "E7 palT is not the "
          "swap")
    pal_err = max(float((kr - tr).abs().max()), float((ki - ti).abs().max()))
    flat = (xr.reshape(B, p * q), xi.reshape(B, p * q))
    check(flat[0].data_ptr() == xr.data_ptr(), "noT is not a view")
    del kr, ki, tr, ti
    t2 = interleaved({"palT": (swap.swap_cuda, (xr, xi)),
                      "xlaT": (swap.swap_torch, (xr, xi)),
                      "E8 row copy": (copyfloor.copy_rows_cuda, flat)})
    for k, ts in t2.items():
        print(f"[38] block 2 {k} ({B}, {p}, {q}): {ts[0]:.4f} / "
              f"{ts[1]:.4f} ms ({smi_line})")
    print("[38] block 2 noT: a view (the reshape shares xr's storage)")
    bms, by = bound(16.0 * B * p * q, 0.0)
    rows = [{
        "name": "swap palT", "route": "cuda",
        "source": "fftw3_tpu_torch/csrc/swap.cu",
        "replaces": "experiments/race4096.py:59",
        "launches": swap.launches[B, p, q], "on_path": False,
        "max_abs_err": pal_err, "ms": sum(t2["palT"]) / 2,
        "plain_ms": sum(t2["xlaT"]) / 2, "bound_ms": bms, "bound_by": by,
        "library_ms": sum(t2["xlaT"]) / 2,
        "copy_floor_ms": sum(t2["E8 row copy"]) / 2, "shape": [B, p, q]}]
    del xr, xi, flat
    n = p * q
    xr, xi = planes(rng, (B, n), dev)
    ref = oracle(torch.complex(xr, xi), (-1,), -1)
    descs = {**swap.FOURSTEP_ARMS,
             **{f"{k} fused": swap.fused(d)
                for k, d in swap.FOURSTEP_ARMS.items()}}
    arms, info = {}, {}
    for label, desc in descs.items():
        ft.forget_wisdom()
        check(ft.import_reference_wisdom(ref_wisdom("c2c", n, B, desc),
                                         device="cuda"),
              f"reference wisdom for pallas4 {label} refused")
        plan = ft.plan_many_dft([n], howmany=B, device="cuda")
        check(plan.descriptors == {1: desc}, f"pinned plan {plan!r}")
        (yr, yi), c = run_counted(plan.apply_split, xr, xi)
        check(c == only(stockham_c2c_fourstep=1, inner_c2c=1),
              f"pallas4 {label}: launches {launched(c)}")
        e = relerr(torch.complex(yr, yi).to(torch.complex128), ref)
        err, _ = twin_err(f"pallas4 {label}", yr, yi,
                          *fourstep_twin(desc, xr, xi))
        check(e <= TOL, f"pallas4 {label} over tolerance: {e:.2e}")
        info[label] = {"launches": sum(c.values()), "err": err, "e64": e,
                       "plain_ms": time_ms(lambda a, b, d=desc:
                                           fourstep_twin(d, a, b), (xr, xi))}
        arms[label] = (plan.apply_split, (xr, xi))
        print(f"[38] block 1 pallas4 {label} {P.sprint_desc(desc)}: "
              f"launches {launched(c)}, rel err vs float64 {e:.2e}")
        del yr, yi
    ft.forget_wisdom()
    check(ft.import_reference_wisdom(ref_wisdom("c2c", n, B, WIDE_DESC),
                                     device="cuda"), "wide wisdom refused")
    pw = ft.plan_many_dft([n], howmany=B, device="cuda")
    check(pw.descriptors == {1: WIDE_DESC}, f"pinned plan {pw!r}")
    ft.forget_wisdom()
    arms["K1 wide [64, 64]"] = (pw.apply_split, (xr, xi))
    xc = torch.complex(xr, xi)
    arms["torch.fft.fft"] = (torch.fft.fft, (xc,))
    del ref
    torch.cuda.synchronize()
    t1 = interleaved(arms)
    for k, ts in t1.items():
        print(f"[38] block 1 {k} ({B}, {n}): {ts[0]:.4f} / {ts[1]:.4f} ms "
              f"({smi_line})")
    bms, by = bound(16.0 * B * n, fft_flops(B * n, n))
    lib = sum(t1["torch.fft.fft"]) / 2
    for label, desc in descs.items():
        rows.append({
            "name": f"pallas4 {label}", "route": "cuda",
            "source": "fftw3_tpu_torch/ops/fourstep.py",
            "replaces": "experiments/race4096.py:80",
            "launches": info[label]["launches"], "on_path": True,
            "max_abs_err": info[label]["err"],
            "rel_err_f64": info[label]["e64"], "ms": sum(t1[label]) / 2,
            "plain_ms": info[label]["plain_ms"], "bound_ms": bms,
            "bound_by": by, "library_ms": lib, "p": desc["p"],
            "q": desc["q"], "fused_store": "tile_b" in desc,
            "k1_wide_ms": sum(t1["K1 wide [64, 64]"]) / 2})
    del arms, xr, xi, xc, pw
    torch.cuda.empty_cache()
    return rows


def measure_phases(rng, dev, smi_line, t_start):
    """Phases 35-38; returns the rows they add to the kernels line."""
    dense_errs = dense_phase(rng, dev, smi_line)
    print(f"[35] done at {time.perf_counter() - t_start:.1f} s: "
          f"{json.dumps(dense_errs)}", flush=True)
    rows = unaligned_phase(rng, dev, smi_line)
    print(f"[36] done at {time.perf_counter() - t_start:.1f} s", flush=True)
    rows += stage_phase(rng, dev, smi_line,
                        S.device_table(N4, (64, 64), -1, dev))
    print(f"[37] done at {time.perf_counter() - t_start:.1f} s", flush=True)
    rows += swap_phase(rng, dev, smi_line)
    print(f"[38] done at {time.perf_counter() - t_start:.1f} s", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phases 39-40: E4, E6 and E9-E12, K1's matmul stage form on the tensor
# cores (ops/k1_mma.py), and E10's host arms on the butterfly K1
# ---------------------------------------------------------------------------

#: phase 39: the reference's verify shape (every arm against its twin, as
#: at the timed batches), the float64 check's rows, and the marginal-slope
#: batches (kernel_variants.py:200); phase 40: E10's batch and chain
#: lengths (headline_gap.py:44)
E39_VERIFY = (256, N)
E39_ORACLE = (8192, N)
E39_BATCHES = (8192, 24576)
E40_BATCH = 16384
E40_K = (4, 16)
E40_REPS = 7
#: the relaxed rungs: noxl drops Xl (precision_variants.py:190); r = 3 and
#: 5 compound the rounding over r passes of growing values
NOXL_TOL = 3e-3
REPEAT_TOL = 1e-4
#: noxl's kernel against its twin, over max |twin|: below what a kernel
#: that split X (prod, about 2.5e-3 from noxl's twin) would read; and the
#: least float64 error a kernel that leaves X unsplit shows (prod: 5e-6)
NOXL_TWIN_TOL = 1.5e-3
NOXL_F64_FLOOR = 1e-4
#: E4's Karatsuba arms against float64: TOL, or where the arm's own
#: arithmetic (its twin) reads above TOL on the draw, 10% over the twin's
#: reading (t3 - t1 - t2 carries the rounding of the larger (Fr + Fi)(Xr +
#: Xi): the kernel 8.23e-6 to 1.058e-5, the twin up to 1.070e-5 over 16
#: draws at 8192 and 24576 rows, fftw3_tpu_torch.tools.k1_mma_errors)
KARATSUBA_F64_SLACK = 1.1
K1_SCHEDULES = ([64, 16], [32, 32], [128, 8])


def mma_twin_tol(name):
    """An arm's tolerance against its twin on the card: TOL, but noxl's (a
    one-ulp difference in a stage-2 input flips its one bf16 rounding) and
    r = 3, 5's."""
    a = k1_mma.ARMS[name]
    if a.groups[0] == "noxl":
        return NOXL_TWIN_TOL
    return REPEAT_TOL if a.reps > 1 else TOL


def mma_twin_check(info, xr, xi):
    """Every arm at every rows per block against its twin over every row
    of (xr, xi); records the largest max abs (``err``) and, per row count,
    the largest distance over max |twin| (``twin_rel``)."""
    rows = xr.shape[0]
    for name in k1_mma.ARMS:
        t = torch.complex(*k1_mma.k1_mma_torch(xr, xi, name))
        tmax = t.abs().max()
        i = info[name]
        for rpb in k1_mma.rows_per_block_fit(name):
            d = (torch.complex(*k1_mma.k1_mma_cuda(xr, xi, name, rpb))
                 - t).abs().max()
            rel = float(d / tmax)
            check(rel <= mma_twin_tol(name),
                  f"E4-E12 {name} ({rows}, {N}) rpb={rpb}: kernel-twin "
                  f"{rel:.2e}")
            i["err"] = max(i["err"], float(d))
            i["twin_rel"][rows] = max(i["twin_rel"].get(rows, 0.0), rel)
        del t


def k1_mma_phase(rng, dev, smi_line):
    """Phase 39 (``ops/k1_mma.py``): every arm at every rows per block held
    against its twin over every row at (256, 1024) and at both timed
    batches, on the inputs then timed; every arm that is a forward DFT (not
    the diagnostics, not r = 3, 5) against complex128 over every row at
    (8192, 1024), within TOL (noxl 3e-3, and above NOXL_F64_FLOOR; E4's
    Karatsuba arms within TOL or 10% over their twin's distance), the
    twin's distance read beside it; then every arm at its rows per block,
    the butterfly K1 at the three schedules and ``torch.fft.fft`` timed at
    B = 8192 and 24576, twice in one interleaved order and back.  Returns
    ({arm: info}, yardsticks, the launches of the phase)."""
    k1_mma.launches.clear()
    info = {name: {"err": 0.0, "twin_rel": {}} for name in k1_mma.ARMS}
    inputs = {B: planes(rng, (B, N), dev) for B in E39_BATCHES}
    mma_twin_check(info, *planes(rng, E39_VERIFY, dev))
    for B in E39_BATCHES:
        mma_twin_check(info, *inputs[B])
    for name in k1_mma.ARMS:
        print(f"[39] {name}: kernel-twin over max |twin| at every rows per "
              f"block {json.dumps(info[name]['twin_rel'])} (tolerance "
              f"{mma_twin_tol(name):g})")
    xr, xi = planes(rng, E39_ORACLE, dev)
    ref = oracle(torch.complex(xr, xi), (-1,), -1)
    for name, a in k1_mma.ARMS.items():
        if a.diag is not None or a.reps > 1:
            continue
        e = relerr(torch.complex(*k1_mma.k1_mma_cuda(xr, xi, name))
                   .to(torch.complex128), ref)
        et = relerr(torch.complex(*k1_mma.k1_mma_torch(xr, xi, name))
                    .to(torch.complex128), ref)
        noxl = a.groups[0] == "noxl"
        tol = NOXL_TOL if noxl else TOL
        if a.form == "karatsuba":
            tol = max(TOL, KARATSUBA_F64_SLACK * et)
        check(e <= tol, f"E4-E12 {name}: {e:.2e} from float64 over {tol:g}")
        check(not noxl or e > NOXL_F64_FLOOR,
              f"E4-E12 {name}: {e:.2e} from float64, not above "
              f"{NOXL_F64_FLOOR:g}: X is not left unsplit")
        info[name]["e64"], info[name]["twin_e64"] = e, et
        print(f"[39] {name}: {e:.3e} from float64 over every row of "
              f"{E39_ORACLE} (twin {et:.3e})")
    del ref, xr, xi
    arms, libs = {}, {}
    for B in E39_BATCHES:
        xr, xi = inputs[B]
        for name in k1_mma.ARMS:
            for rpb in k1_mma.rows_per_block_fit(name):
                arms[name, B, rpb] = (
                    lambda a, b, name=name, rpb=rpb: k1_mma.k1_mma_cuda(
                        a, b, name, rpb), (xr, xi))
        for rad in K1_SCHEDULES:
            tab = S.device_table(N, tuple(rad), -1, dev)
            arms[f"K1 {rad}", B, 0] = (
                lambda a, b, rad=rad, tab=tab: S.stockham_c2c_cuda(
                    a, b, rad, tab), (xr, xi))
        xc = torch.complex(xr, xi)
        arms["torch.fft.fft", B, 0] = (torch.fft.fft, (xc,))
        libs[B] = xc
    torch.cuda.synchronize()
    times = interleaved(arms)
    for (k, B, rpb), ts in times.items():
        print(f"[39] {k} B={B} rpb={rpb}: {ts[0]:.4f} / {ts[1]:.4f} ms "
              f"({smi_line})")
    mean = {k: sum(ts) / 2 for k, ts in times.items()}
    for name in k1_mma.ARMS:
        per_b = {}
        for B in E39_BATCHES:
            sweep = {rpb: mean[name, B, rpb]
                     for rpb in k1_mma.rows_per_block_fit(name)}
            rpb = min(sweep, key=sweep.get)
            per_b[B] = (sweep[rpb], rpb, sweep)
        b1, b2 = E39_BATCHES
        info[name].update({
            "ms": per_b[b2][0], "ms_b8192": per_b[b1][0],
            "rows_per_block": per_b[b2][1],
            "ms_by_rows_per_block": per_b[b2][2],
            "slope_ps_per_pt": (per_b[b2][0] - per_b[b1][0]) * 1e9
            / ((b2 - b1) * N)})
    yard = {}
    for k in [f"K1 {rad}" for rad in K1_SCHEDULES] + ["torch.fft.fft"]:
        b1, b2 = E39_BATCHES
        yard[k] = {"ms_b8192": mean[k, b1, 0], "ms": mean[k, b2, 0],
                   "slope_ps_per_pt": (mean[k, b2, 0] - mean[k, b1, 0])
                   * 1e9 / ((b2 - b1) * N)}
        print(f"[39] yardstick {k}: {yard[k]['ms_b8192']:.4f} ms at B = "
              f"{b1}, {yard[k]['ms']:.4f} at {b2}, marginal slope "
              f"{yard[k]['slope_ps_per_pt']:.2f} ps/pt ({smi_line})")
    B = E39_BATCHES[1]
    xc = libs[B]
    x8 = (xc.real.contiguous(), xc.imag.contiguous())
    fft_ms = yard["torch.fft.fft"]["ms"]
    clone_ms = time_ms(torch.clone, (xc,))
    for name, a in k1_mma.ARMS.items():
        i = info[name]
        i["plain_ms"] = time_ms(lambda p, q, name=name: k1_mma.k1_mma_torch(
            p, q, name), x8)
        i["library_ms"] = (clone_ms if a.diag == "copy" else None
                           if a.diag else fft_ms)
        print(f"[39] {name}: {i['ms_b8192']:.4f} ms at B = {E39_BATCHES[0]}, "
              f"{i['ms']:.4f} at {B} (rpb {i['rows_per_block']}), slope "
              f"{i['slope_ps_per_pt']:.2f} ps/pt; twin {i['plain_ms']:.3f} "
              f"ms; kernel-twin max abs {i['err']:.2e} ({smi_line})")
    del arms, libs, inputs, xc, x8, xr, xi
    torch.cuda.empty_cache()
    return info, yard, dict(k1_mma.launches)


def e10_host_phase(rng, dev, smi_line):
    """Phase 40, E10's host arms (``headline_gap.py``) on the butterfly K1
    [32, 32] at B = 16384: ``prod`` (K1's chained calls), ``donate`` (K1
    with y = x, ``k1_mma.k1_inplace_cuda``, held bit for bit against the
    out-of-place K1 first), ``stream2`` (two chains launched alternately
    on one stream, half the time of a pair), the kernel's stages run r =
    1, 3, 5 times (``e10_rep*``) and ``prod`` at B = 8192 and 24576 for
    K1's marginal slope, all in one chained race (k = 4 and 16 calls, the
    median over 7 reps of the paired differences, CUDA events); then the
    K1 twin and ``torch.fft.fft`` at B = 16384.  Returns the phase's
    numbers."""
    B, rad = E40_BATCH, [32, 32]
    tab = S.device_table(N, tuple(rad), -1, dev)
    xr, xi = planes(rng, (B, N), dev)
    wr, wi = S.stockham_c2c_cuda(xr, xi, rad, tab)
    dr, di = xr.clone(), xi.clone()
    k1_mma.inplace_launches = 0
    k1_mma.k1_inplace_cuda(dr, di, rad, tab)
    donate_err = max(float((dr - wr).abs().max()),
                     float((di - wi).abs().max()))
    check(donate_err == 0.0,
          f"E10 donate: K1 in place differs from K1 by {donate_err:.2e}")
    prod = (lambda a, b: S.stockham_c2c_cuda(a, b, rad, tab))
    pair = (lambda a, b, c, d: prod(a, b) + prod(c, d))
    chains = [
        ("prod", timing.chain(prod, (wr, wi))),
        ("donate", timing.chain(
            lambda a, b: k1_mma.k1_inplace_cuda(a, b, rad, tab), (dr, di))),
        ("stream2", timing.chain(pair, (wr, wi, dr.clone(), di.clone()),
                                 calls_per_step=2))]
    for r in (1, 3, 5):
        name = f"e10_rep{r}"
        chains.append((f"rep{r}", timing.chain(
            lambda a, b, name=name: k1_mma.k1_mma_cuda(a, b, name),
            (xr, xi))))
    rows = dict.fromkeys((tag for tag, _ in chains), B)
    for b in E39_BATCHES:
        rows[f"prod_b{b}"] = b
        chains.append((f"prod_b{b}", timing.chain(
            prod, planes(rng, (b, N), dev))))
    for _, run in chains:
        run(1)                                     # warm
    torch.cuda.synchronize()
    k1, k2 = E40_K
    res = timing.interleaved_chain_race(chains, k1, k2, E40_REPS)
    pp = {tag: sec / (rows[tag] * N) * 1e12 for tag, sec in res.items()}
    slope_r = (pp["rep5"] - pp["rep1"]) / 4.0
    b1, b2 = E39_BATCHES
    out = {"ps_per_pt": pp, "ms": {t: s * 1e3 for t, s in res.items()},
           "rep_slope_ps_per_pt": slope_r,
           "fixed_ps_per_pt": pp["rep1"] - slope_r,
           "donate_saves_ps_per_pt": pp["prod"] - pp["donate"],
           "stream2_saves_ps_per_pt": pp["prod"] - pp["stream2"],
           "prod_marginal_ps_per_pt": (res[f"prod_b{b2}"]
                                       - res[f"prod_b{b1}"])
           / ((b2 - b1) * N) * 1e12,
           "donate_launches": k1_mma.inplace_launches,
           "donate_max_abs_err": donate_err}
    for tag, v in pp.items():
        print(f"[40] chained at B={rows[tag]}: {tag} {v:.2f} ps/pt "
              f"({res[tag] * 1e3:.4f} ms a call) ({smi_line})")
    print(f"[40] in-kernel cost of one pass (rep slope) {slope_r:.2f} "
          f"ps/pt; fixed cost a call (rep1 - slope) "
          f"{out['fixed_ps_per_pt']:.2f} ps/pt; donate saves "
          f"{out['donate_saves_ps_per_pt']:.2f}, stream2 saves "
          f"{out['stream2_saves_ps_per_pt']:.2f} ps/pt; K1 {rad} marginal "
          f"slope (B = {b1} vs {b2}) {out['prod_marginal_ps_per_pt']:.2f} "
          f"ps/pt ({smi_line})")
    del chains, dr, di, wr, wi
    out["twin_ms"] = time_ms(
        lambda a, b: S.stockham_c2c_torch(a, b, rad, -1), (xr, xi))
    out["fft_ms"] = time_ms(torch.fft.fft, (torch.complex(xr, xi),))
    print(f"[40] at B={B}: K1's twin {out['twin_ms']:.4f} ms, torch.fft.fft "
          f"{out['fft_ms']:.4f} ms ({smi_line})")
    del xr, xi
    torch.cuda.empty_cache()
    return out


def k1_mma_rows(info, yard, counts, e10):
    """The kernels line's rows of phases 39-40: one per arm (launches:
    phase 39's `counts`; E10's also carry phase 40's chained time a
    call), and K1 in place."""
    rows = []
    B = E39_BATCHES[1]
    for name, a in k1_mma.ARMS.items():
        i = info[name]
        bms, by = bound(16.0 * B * N, k1_mma.stage_flops(a) * B * N,
                        BF16_FLOPS_PER_S)
        row = {
            "name": f"k1_mma {name}", "route": "cuda",
            "source": f"fftw3_tpu_torch/csrc/{a.source}.cu",
            "replaces": a.replaces, "launches": counts[name],
            "on_path": False, "max_abs_err": i["err"], "ms": i["ms"],
            "plain_ms": i["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": i["library_ms"], "shape": [B, N],
            "ms_b8192": i["ms_b8192"],
            "slope_ps_per_pt": i["slope_ps_per_pt"],
            "rows_per_block": i["rows_per_block"],
            "ms_by_rows_per_block": i["ms_by_rows_per_block"],
            "twin_rel": i["twin_rel"], "radices": list(a.radices)}
        if "e64" in i:
            row["rel_err_f64"] = i["e64"]
            row["twin_rel_err_f64"] = i["twin_e64"]
        if a.reps > 1 or name == "e10_rep1":
            row["chained_ms_b16384"] = e10["ms"][f"rep{a.reps}"]
        rows.append(row)
    rows.append({"name": "k1 in place (E10 donate)", "route": "cuda",
                 "source": "fftw3_tpu_torch/csrc/stockham_c2c.cu",
                 "replaces": "experiments/headline_gap.py:82",
                 "launches": e10["donate_launches"], "on_path": False,
                 "max_abs_err": e10["donate_max_abs_err"],
                 "ms": e10["ms"]["donate"], "plain_ms": e10["twin_ms"],
                 "out_of_place_ms": e10["ms"]["prod"],
                 "bound_ms": bound(16.0 * E40_BATCH * N, 0.0)[0],
                 "bound_by": "bytes", "library_ms": e10["fft_ms"],
                 "shape": [E40_BATCH, N], "e10": e10, "yardsticks": yard})
    return rows


def tensor_core_phases(rng, dev, smi_line, t_start):
    """Phases 39-40; returns the rows they add to the kernels line."""
    info, yard, counts = k1_mma_phase(rng, dev, smi_line)
    print(f"[39] done at {time.perf_counter() - t_start:.1f} s", flush=True)
    e10 = e10_host_phase(rng, dev, smi_line)
    print(f"[40] done at {time.perf_counter() - t_start:.1f} s", flush=True)
    return k1_mma_rows(info, yard, counts, e10)


def k7_ablation_phase(dev, smi_line, k7_row, seed):
    """Phase 41: K7's ablation (``tools/k7_ablation.py``) at the f64 path's
    shape and schedule: the ``full``, ``no_twiddle``, ``skeleton`` and
    ``copy`` arms timed in one interleaved order and back beside K7's
    wrapper and cuFFT Z2Z, the full arm held bit for bit against K7; then
    the SASS of K7's arms by instruction class (``cuobjdump``, each
    instruction once).  Returns the arms' rows of the kernels line
    (launches: this phase's, the arms are on no user path)."""
    from fftw3_tpu_torch.tools import k7_ablation
    B, n = F64_PATH
    res = k7_ablation.race(B, n, seed)
    times = res["times_ms"]
    for k, ts in times.items():
        print(f"[41] {k} {F64_PATH} {res['radices']}: {ts[0]:.4f} / "
              f"{ts[1]:.4f} ms ({smi_line})")
    sass = k7_ablation.static_mix(k7_ablation.cuobjdump_sass(
        _build._library_path()))
    for name, mix in sorted(sass.items()):
        print(f"[41] SASS {_build._kernel_name(name)}: {sum(mix.values())} "
              f"instructions, {mix}")
    check(len(sass) == len(df32.K7_FAMILIES) + len(df32.ABLATE_ARMS) - 1,
          f"K7's SASS: {sorted(sass)}")
    cufft = sum(times["cuFFT Z2Z torch.fft.fft"]) / 2
    rows = []
    for a in df32.ABLATE_ARMS:
        rows.append({
            "name": f"df32_c2c arm {a}", "route": "cuda",
            "source": "fftw3_tpu_torch/csrc/df32_c2c.cu",
            "replaces": "fftw3_tpu/ops/df32.py:444",
            "launches": res["launches"][a], "on_path": False,
            "max_abs_err": res["max_abs_err"][a],
            "ms": sum(times[f"arm {a}"]) / 2,
            "plain_ms": k7_row["plain_ms"], "bound_ms": k7_row["bound_ms"],
            "bound_by": k7_row["bound_by"], "library_ms": cufft})
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 42-44: the user surface on the card — the functional API, the guru
# and advanced layouts, the bench harness
# ---------------------------------------------------------------------------

#: phase 44's problem strings: the reference suite's cells (bench.py:1099-
#: 1104) and the headline; "-y" runs each at the size given here
HARNESS_SPEED = ["c1024v65536", "c4096v4096", "r2048x2048v8",
                 "c256x256x256", "c1000v32768", "k512e10v65536",
                 "c512x512x512", "/c1024v65536"]
HARNESS_VERIFY = ["c1024v65536", "r2048x2048v8", "c4096v4096",
                  "c256x256x256", "c1000v32768", "k512e10v65536",
                  "c512x512x512"]
HARNESS_DOUBLE = "c1024v8192"
#: the strided guru path (phase 43): n points at input stride 2 and output
#: stride 2, GURU_BATCH transforms 2n apart on both sides, from an offset
GURU_N, GURU_BATCH, GURU_OFFSET = 1024, 32768, 7
#: the advanced-layout path: rows of MANY_N points inside rows of MANY_EMBED
MANY_N, MANY_BATCH, MANY_EMBED = 1024, 32768, 1040


def surface_call(label, fn, args, want, ref):
    """One functional call at full width: its launches (checked against
    `want` when given), its error against the float64 `ref` over every
    output (checked at TOL), a second call that must plan nothing (the
    plan cache), and its time.  Returns the output of the first call."""
    y, counts = run_counted(fn, *args)
    fired = launched(counts)
    check(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
    e = relerr(y.to(ref.dtype), ref)
    nplan = ft.the_planner.stats["nplan"]
    fn(*args)
    torch.cuda.synchronize()
    again = ft.the_planner.stats["nplan"] - nplan
    print(f"[42] {label}: launches {fired}; rel err vs float64 over every "
          f"output {e:.2e}; second call planned {again} subproblems; "
          f"{time_ms(fn, args):.3f} ms")
    check(want is None or fired == want,
          f"{label} launched {fired}, expected {want}")
    check(e <= TOL, f"{label}: {e:.2e} over {TOL}")
    check(again == 0, f"{label}: the second call planned again")
    return y


def functional_phase(rng, dev, smi_line):
    """Phase 42: the numpy-style functions on CUDA tensors at full width,
    planned under the functional ESTIMATE from no wisdom."""
    from fftw3_tpu_torch.interfaces import scipy_fft
    c128 = torch.complex128
    ft.forget_wisdom()                     # also empties the plan cache
    xr, xi = planes(rng, (BATCH, N), dev)
    x = torch.complex(xr, xi)
    x64 = x.to(c128)
    surface_call(f"fft(x) {tuple(x.shape)}", ft.fft, (x,),
                 {"stockham_c2c": 1}, torch.fft.fft(x64))
    surface_call("ifft(x, norm='ortho')", lambda a: ft.ifft(a, norm="ortho"),
                 (x,), {"stockham_c2c": 1},
                 torch.fft.ifft(x64, norm="ortho"))
    del x64
    plan = api_plan("c2c", x, (1,), K.FORWARD)
    print(f"[42] fft's cached plan: {plan!r}")
    times = interleaved({
        "fft(x)": (ft.fft, (x,)),
        "plan.apply_split": (plan.apply_split, (xr, xi)),
        "torch.fft.fft": (torch.fft.fft, (x,)),
        "ifft(x, norm='ortho')": (lambda a: ft.ifft(a, norm="ortho"), (x,)),
    })
    for k, v in times.items():
        print(f"[42] time {k} ({BATCH}, {N}): {v[0]:.3f} / {v[1]:.3f} ms "
              f"(in order / back; {smi_line})")
    del x, xr, xi
    torch.cuda.empty_cache()

    xr = real_rows(rng, REAL_1D, dev)
    X = surface_call(f"rfft {REAL_1D}", ft.rfft, (xr,), {"r2c": 1},
                     torch.fft.rfft(xr.double()))
    surface_call(f"irfft {tuple(X.shape)}", ft.irfft, (X,), {"c2r": 1},
                 torch.fft.irfft(X.to(c128)))
    times = interleaved({"rfft": (ft.rfft, (xr,)),
                         "torch.fft.rfft": (torch.fft.rfft, (xr,)),
                         "irfft": (ft.irfft, (X,)),
                         "torch.fft.irfft": (torch.fft.irfft, (X,))})
    for k, v in times.items():
        print(f"[42] time {k} {REAL_1D}: {v[0]:.3f} / {v[1]:.3f} ms "
              f"({smi_line})")
    del xr, X
    torch.cuda.empty_cache()

    x = torch.complex(*planes(rng, MANY_2D, dev))
    surface_call(f"fft2 {MANY_2D}", ft.fft2, (x,),
                 {"c2c_2d": 1, "c2c_2d_ring": 1, "c2c_2d_fixed": 1},
                 torch.fft.fft2(x.to(c128)))
    del x
    x = torch.complex(*planes(rng, (CUBE,) * 3, dev))
    surface_call(f"fftn {(CUBE,) * 3}", ft.fftn, (x,),
                 {"inner_c2c": 1, "c2c_2d": 1, "c2c_2d_ring": 1,
                  "c2c_2d_fixed": 1},
                 torch.fft.fftn(x.to(c128)))
    del x
    torch.cuda.empty_cache()
    xr = real_rows(rng, REAL_2D, dev)
    X = surface_call(f"rfftn {REAL_2D} axes (1, 2)",
                     lambda a: ft.rfftn(a, axes=(1, 2)), (xr,),
                     {"r2c": 1, "inner_c2c": 1, "inner_c2c_cout": 1},
                     torch.fft.rfftn(xr.double(), dim=(1, 2)))
    surface_call(f"irfftn {tuple(X.shape)} axes (1, 2)",
                 lambda a: ft.irfftn(a, axes=(1, 2)), (X,),
                 {"inner_c2c": 1, "c2r": 1},
                 torch.fft.irfftn(X.to(c128), dim=(1, 2)))
    del xr, X
    torch.cuda.empty_cache()

    x = real_rows(rng, R2R_1D, dev)
    y, counts = run_counted(lambda a: ft.dct(a, 2), x)
    dplan = api_plan("r2r", x, (1,), K.FORWARD, ("redft10",))
    e = oracle_err("redft10", x, y)
    print(f"[42] dct(x, 2) {R2R_1D} under the functional ESTIMATE: route "
          f"{dplan!r}; launches {launched(counts)}; rel err vs float64 over "
          f"every row {e:.2e}")
    check(e <= TOL, f"dct(x, 2): {e:.2e}")
    nplan = ft.the_planner.stats["nplan"]
    ft.dct(x, 2)
    check(ft.the_planner.stats["nplan"] == nplan, "dct planned again")
    print(f"[42] time dct(x, 2) {R2R_1D}: "
          f"{time_ms(lambda a: ft.dct(a, 2), (x,)):.3f} ms ({smi_line})")
    del x, y
    import scipy.fft as sfft
    x = real_rows(rng, (R2R_CUBE,) * 3, dev)
    y, counts = run_counted(lambda a: scipy_fft.dctn(a, norm="ortho"), x)
    want = sfft.dctn(x.double().cpu().numpy(), norm="ortho", workers=-1)
    e = float(np.max(np.abs(y.double().cpu().numpy() - want))
              / np.max(np.abs(want)))
    print(f"[42] scipy_fft.dctn {(R2R_CUBE,) * 3} norm='ortho': launches "
          f"{launched(counts)}; rel err vs scipy float64 {e:.2e}; "
          f"{time_ms(lambda a: scipy_fft.dctn(a, norm='ortho'), (x,)):.3f} "
          f"ms ({smi_line})")
    check(e <= TOL, f"dctn: {e:.2e}")
    nplan = ft.the_planner.stats["nplan"]
    scipy_fft.dctn(x, norm="ortho")
    check(ft.the_planner.stats["nplan"] == nplan, "dctn planned again")
    del x, y
    torch.cuda.empty_cache()


def api_plan(kind, x, axes, sign, r2r_kinds=()):
    """The functional API's cached plan for `x` (a cache hit)."""
    from fftw3_tpu_torch import api
    return api._plan_for(kind, x, axes, sign, api._dtype_name(x), r2r_kinds)


def guru_phase(rng, dev, smi_line, seed, t_start):
    """Phase 43: the split, strided and advanced layouts on the card; the
    split path's profile in a child process."""
    from fftw3_tpu_torch import guru
    c128 = torch.complex128
    xr, xi = planes(rng, (BATCH, N), dev)
    sp = ft.plan_guru_split_dft([N], [BATCH], device=dev)
    print(f"[43] {sp!r}")
    (yr, yi), counts = run_counted(ft.execute_split_dft, sp, xr, xi)
    e = relerr(torch.complex(yr, yi).to(c128),
               torch.fft.fft(torch.complex(xr, xi).to(c128)))
    print(f"[43] execute_split_dft ({BATCH}, {N}): launches "
          f"{launched(counts)}; rel err vs float64 {e:.2e}")
    check(launched(counts) == {"stockham_c2c": 1},
          f"execute_split_dft launched {launched(counts)}")
    check(e <= TOL, f"execute_split_dft: {e:.2e}")
    del yr, yi
    plan = ft.plan_many_dft([N], howmany=BATCH, device=dev)
    times = interleaved({
        "execute_split_dft": (lambda a, b: ft.execute_split_dft(sp, a, b),
                              (xr, xi)),
        "plan.apply_split": (plan.apply_split, (xr, xi))})
    for k, v in times.items():
        print(f"[43] time {k} ({BATCH}, {N}): {v[0]:.3f} / {v[1]:.3f} ms "
              f"({smi_line})")
    del xr, xi
    torch.cuda.empty_cache()
    res = subprocess.run([sys.executable, __file__, "--profile-paths",
                          "surface", "--seed", str(seed)], timeout=600)
    check(res.returncode == 0, "the profile of the surface paths failed")

    # a strided guru plan over flat buffers: element stride 2 on both sides
    # (every other element of each 2n-element row), an offset, out=
    n, b, off = GURU_N, GURU_BATCH, GURU_OFFSET
    dims = [guru.iodim(n, 2, 2)]
    hm = [guru.iodim(b, 2 * n, 2 * n)]
    p = ft.plan_guru_dft(dims, hm, device=dev)
    flat = torch.complex(*planes(rng, (off + 2 * n * b,), dev))
    out = torch.full((off + 2 * n * b,), 3.0 + 0j, dtype=torch.complex64,
                     device=dev)
    got, counts = run_counted(lambda: p.execute(flat, off, out))
    check(got is out, "the strided plan did not write into out=")
    view = out[off:].view(b, n, 2)
    want = torch.fft.fft(flat[off:].view(b, n, 2)[..., 0].to(c128))
    e = relerr(view[..., 0].to(c128), want)
    kept = bool((view[..., 1] == 3.0).all() and (out[:off] == 3.0).all())
    print(f"[43] {p!r} ({b} x {n}, is = os = 2, offset {off}, out=): "
          f"launches {launched(counts)}; rel err vs float64 {e:.2e}; the "
          f"rest of out untouched: {kept}; "
          f"{time_ms(lambda a: p.execute(a, off, out), (flat,)):.3f} ms "
          f"({smi_line})")
    check(launched(counts) == {"stockham_c2c": 1} and e <= TOL and kept,
          "the strided guru plan")
    del flat, out, view, want
    torch.cuda.empty_cache()

    # the advanced layout: rows of 1024 inside rows of 1040, both sides
    mp = guru.plan_many_dft([MANY_N], MANY_BATCH, inembed=[MANY_EMBED],
                            onembed=[MANY_EMBED], device=dev)
    x = torch.complex(*planes(rng, (MANY_BATCH, MANY_EMBED), dev))
    y, counts = run_counted(mp.execute, x)
    e = relerr(y[:, :MANY_N].to(c128),
               torch.fft.fft(x[:, :MANY_N].to(c128)))
    zero = not bool(y[:, MANY_N:].abs().sum())
    print(f"[43] {mp!r}: launches {launched(counts)}; rel err vs float64 "
          f"{e:.2e}; zero outside the block: {zero}; "
          f"{time_ms(mp.execute, (x,)):.3f} ms ({smi_line})")
    check(launched(counts) == {"stockham_c2c": 1} and e <= TOL and zero,
          "the advanced-layout plan")
    del x, y
    torch.cuda.empty_cache()
    print(f"[43] done at {time.perf_counter() - t_start:.1f} s", flush=True)


def profile_surface_paths(rng, dev, smi_line) -> None:
    """``torch.profiler`` breakdowns of the user surface at (65536, 1024):
    ``fft(x)``, ``ifft(x, norm="ortho")``, the plan's ``apply_split``,
    ``execute_split_dft`` (which must show K1 and no other kernel) and
    ``rfft``."""
    xr, xi = planes(rng, (BATCH, N), dev)
    x = torch.complex(xr, xi)
    plan = ft.plan_many_dft([N], howmany=BATCH, device=dev)
    sp = ft.plan_guru_split_dft([N], [BATCH], device=dev)
    prof = profile_calls(f"execute_split_dft ({BATCH}, {N})",
                         lambda a, b: ft.execute_split_dft(sp, a, b),
                         (xr, xi), smi_line, tag="[43]")
    check(len(prof) == 1 and list(prof.values())[0][1] == 1,
          f"execute_split_dft ran more than one kernel: {sorted(prof)}")
    profile_calls(f"apply_split ({BATCH}, {N})", plan.apply_split, (xr, xi),
                  smi_line, tag="[43]")
    profile_calls(f"fft(x) ({BATCH}, {N})", ft.fft, (x,), smi_line,
                  tag="[43]")
    profile_calls(f"ifft(x, norm='ortho') ({BATCH}, {N})",
                  lambda a: ft.ifft(a, norm="ortho"), (x,), smi_line,
                  tag="[43]")
    del x, xi
    profile_calls(f"rfft {REAL_1D}", ft.rfft, (xr,), smi_line, tag="[43]")


def harness_run(*args, timeout=600):
    """``python -m`` one of the port's command-line tools in a child
    process from the checkout's root; its output, echoed; a non-zero exit
    fails the run."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                         text=True, timeout=timeout,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in res.stdout.splitlines():
        print(f"[44]   {line[:300]}")
    print(f"[44] python -m {' '.join(args)}: exit {res.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(res.returncode == 0, f"python -m {' '.join(args)} failed: "
          f"{res.stderr[-3000:]}")
    return res.stdout


def harness_phase(dev, smi_line, t_start):
    """Phase 44: the FFTW bench harness on the card, each tool in a child
    process: -s and -y on the reference suite's cells, --double, paranoid,
    accuracy, fuzz, and the wisdom tool's export read back here."""
    import tempfile
    print(f"[44] harness on {smi_line}; -y at full size on "
          f"{', '.join(HARNESS_VERIFY)} (no cell reduced)")
    ys = [a for p in HARNESS_VERIFY for a in ("-y", p)]
    ss = [a for p in HARNESS_SPEED for a in ("-s", p)]
    out = harness_run("fftw3_tpu_torch.harness", *ys, *ss, "-v", "1")
    speed = [ln for ln in out.splitlines() if ln.startswith("Problem: ")]
    check(len(speed) == len(HARNESS_SPEED), "missing speed lines")
    out = harness_run("fftw3_tpu_torch.harness", "--double", "-y",
                      HARNESS_DOUBLE, "-s", HARNESS_DOUBLE, "-v", "1")
    harness_run("fftw3_tpu_torch.harness", "--paranoid", "-y", "c1024v64",
                "-v", "1")
    harness_run("fftw3_tpu_torch.harness.accuracy", "c1024v65536",
                "r1024v65536")
    out = harness_run("fftw3_tpu_torch.harness.fuzz", "--count", "30",
                      "--seed", "0")
    check("fuzz: 30/30 passed" in out, "the fuzzer did not read 30/30")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wisdom.json")
        harness_run("fftw3_tpu_torch.tools.wisdom", "-e", "-o", path,
                    "c1024", "r1024")
        ft.forget_wisdom()
        check(ft.import_wisdom_from_filename(path), "wisdom import refused")
        keys = sorted({":".join(k.split(":")[:2])
                       for k in ft.the_planner.wisdom})
        print(f"[44] the wisdom tool's export read back: "
              f"{len(keys)} entries, {keys}")
        check({"c2c:1024", "r2c:1024"} <= set(keys), "wisdom entries")
        hits = ft.the_planner.stats["nwisdom_hit"]
        ft.plan_dft_r2c_1d(1024, device=dev)
        check(ft.the_planner.stats["nwisdom_hit"] > hits,
              "the imported wisdom was not used")
    print(f"[44] done at {time.perf_counter() - t_start:.1f} s", flush=True)


def surface_phases(rng, dev, smi_line, seed, t_start):
    """Phases 42-44; prints the time they added."""
    t0 = time.perf_counter()
    functional_phase(rng, dev, smi_line)
    print(f"[42] done at {time.perf_counter() - t_start:.1f} s", flush=True)
    guru_phase(rng, dev, smi_line, seed, t_start)
    harness_phase(dev, smi_line, t_start)
    print(f"[44] phases 42-44 added {time.perf_counter() - t0:.1f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-paths",
                    choices=["c2c", "real", "f64", "r2r", "surface"],
                    help="only profile the c2c paths (3-D, 2-D batched, "
                    "four-step), the real paths, the f64 path or the r2r "
                    "paths (the full run starts each in a child process)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch sees no CUDA device", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    if args.profile_paths:
        profile_paths(rng, dev, args.profile_paths)
        return
    t_start = time.perf_counter()

    # -- 1. the card -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[1] device {name}")
    print(f"[1] nvidia-smi: {smi_line}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] kernel library ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s, "
          f"{len(_build.sources())} sources)", flush=True)
    for k, (regs, spill, stack) in sorted(_build.register_report().items()):
        print(f"[2] ptxas {k}: {regs} registers, {spill} bytes of spill "
              f"stores, {stack} bytes of stack frame")
    p1_row = probe_phase(dev, smi_line)

    # -- 3. kernel vs twin vs float64 --------------------------------------
    for n, rad in CASES:
        for sign in (-1, +1):
            table = S.device_table(n, tuple(rad), sign, dev)
            for b in CASE_BATCHES:
                xr, xi = planes(rng, (b, n), dev)
                kr, ki = S.stockham_c2c_cuda(xr, xi, rad, table)
                tr, ti = S.stockham_c2c_torch(xr, xi, rad, sign)
                torch.cuda.synchronize()
                k = torch.complex(kr, ki)
                t = torch.complex(tr, ti)
                o = np_oracle(xr, xi, sign)
                e_kt = relerr(k, t)
                e_ko = relerr(k[:ORACLE_ROWS].cpu().to(torch.complex128), o)
                e_to = relerr(t[:ORACLE_ROWS].cpu().to(torch.complex128), o)
                print(f"[3] n={n} r={rad} sign={sign:+d} B={b}: kernel-twin "
                      f"{e_kt:.2e} kernel-f64 {e_ko:.2e} twin-f64 "
                      f"{e_to:.2e}")
                check(e_kt <= TOL and e_ko <= TOL and e_to <= TOL,
                      f"kernel case n={n} r={rad} sign={sign} B={b} over "
                      f"{TOL}")

    # -- 4. the main path --------------------------------------------------
    plan = ft.plan_many_dft([N], howmany=BATCH, dtype="complex64",
                            device="cuda")
    print(f"[4] {plan!r}")
    check(plan.descriptors == {1: MAIN_DESC},
          f"main-path descriptor {plan.descriptors} != {MAIN_DESC}")
    xr, xi = planes(rng, (BATCH, N), dev)
    xc = torch.complex(xr, xi)
    torch.cuda.synchronize()
    reset_counts()
    yr, yi = plan.apply_split(xr, xi)
    torch.cuda.synchronize()
    counts_split = read_counts()
    reset_counts()
    yc = plan.execute(xc)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["stockham_c2c"]
    print(f"[4] kernel launches on the main path: apply_split "
          f"{counts_split}; execute {counts}")
    check(counts_split == only(stockham_c2c=1)
          and counts == only(stockham_c2c=1),
          "the main path is not one K1 launch a call")
    ref = torch.fft.fft(xc.to(torch.complex128), dim=-1)
    y = torch.complex(yr, yi)
    e_all = relerr(y.to(torch.complex128), ref)
    e_exec = relerr(yc.to(torch.complex128), ref)
    e_np = relerr(y[:ORACLE_ROWS].cpu().to(torch.complex128),
                  np_oracle(xr, xi, -1))
    check(bool(torch.isfinite(yr).all() and torch.isfinite(yi).all()),
          "non-finite output")
    check(tuple(y.shape) == (BATCH, N) and tuple(yc.shape) == (BATCH, N),
          "wrong output shape")
    print(f"[4] rel err, all {BATCH} rows vs torch.fft complex128: "
          f"apply_split {e_all:.3e}, execute {e_exec:.3e}; "
          f"{ORACLE_ROWS} rows vs numpy f64: {e_np:.3e}")
    check(max(e_all, e_exec, e_np) <= TOL, "main path over tolerance")
    check(torch.equal(yc, y), "execute differs from apply_split's planes")
    del yc

    # -- 5. gradient -------------------------------------------------------
    p64 = ft.plan_many_dft([N], howmany=64, device="cuda")
    check(p64.descriptors == {1: MAIN_DESC}, f"B=64 plan {p64!r}")
    gxr, gxi = (t.requires_grad_() for t in planes(rng, (64, N), dev))
    gr, gi = planes(rng, (64, N), dev)
    outr, outi = p64.apply_split(gxr, gxi)
    torch.autograd.backward([outr, outi], [gr, gi])
    wr, wi = S.stockham_c2c_cuda(gr, gi, MAIN_RADICES, S.device_table(
        N, tuple(MAIN_RADICES), +1, dev))
    want = torch.complex(wr, wi)
    e_g = relerr(torch.complex(gxr.grad, gxi.grad), want)
    e_go = relerr(want.cpu().to(torch.complex128), np_oracle(gr, gi, +1))
    print(f"[5] grad vs opposite-sign kernel {e_g:.2e}; "
          f"that vs numpy f64 {e_go:.2e}")
    check(e_g == 0.0 and e_go <= TOL, "gradient mismatch")

    # -- 6. times at the main-path shape -----------------------------------
    rows = []
    outs = {}
    for rad in TIMED_RADICES:
        table = S.device_table(N, tuple(rad), -1, dev)

        def kern(a, b, rad=rad, table=table):
            return S.stockham_c2c_cuda(a, b, rad, table)
        kr, ki = kern(xr, xi)
        e = relerr(torch.complex(kr, ki).to(torch.complex128), ref)
        check(e <= TOL, f"kernel r={rad} at the main shape: {e:.2e}")
        outs[tuple(rad)] = torch.complex(kr, ki)
        t = timing.time_dispatched(kern, (xr, xi), iters=3, reps=7)
        rows.append((f"kernel r{'x'.join(map(str, rad))}", t, e))
    # the form execute runs: K1 reading and writing interleaved complex64
    table = S.device_table(N, tuple(MAIN_RADICES), -1, dev)

    def kern_c(z):
        return S.stockham_c2c_cuda(z, None, MAIN_RADICES, table,
                                   complex_out=True)
    kc = kern_c(xc)
    check(torch.equal(kc, outs[tuple(MAIN_RADICES)]),
          "K1's interleaved form differs from its planar form")
    t_c = timing.time_dispatched(kern_c, (xc,), iters=3, reps=7)
    rows.insert(0, ("kernel r64x16 complex64 in and out (execute's form)",
                    t_c, relerr(kc.to(torch.complex128), ref)))
    tr, ti = S.stockham_c2c_torch(xr, xi, MAIN_RADICES, -1)
    twin_out = torch.complex(tr, ti)
    e_twin = relerr(twin_out.to(torch.complex128), ref)
    max_abs = float((kc - twin_out).abs().max())
    del tr, ti, twin_out, kc
    t_twin = timing.time_dispatched(
        lambda a, b: S.stockham_c2c_torch(a, b, MAIN_RADICES, -1),
        (xr, xi), iters=3, reps=7)
    rows.append(("twin r64x16 (plain PyTorch)", t_twin, e_twin))
    t_fft = timing.time_dispatched(lambda z: torch.fft.fft(z, dim=-1),
                                   (xc,), iters=3, reps=7)
    rows.append(("torch.fft.fft (context only)", t_fft,
                 relerr(torch.fft.fft(xc, dim=-1).to(torch.complex128),
                        ref)))
    for label, t, e in rows:
        print(f"[6] {label}: {t * 1e6:.1f} us, "
              f"{gflops(N, BATCH, t):.1f} GFLOPS(5NlogN), rel err {e:.2e} "
              f"(n={N}, B={BATCH}; {smi_line})")
    rel_k1 = max_abs / float(ref.abs().max())
    print(f"[6] kernel r64x16 complex64 in and out vs twin on the same "
          f"input: max abs err {max_abs:.3e}, over max |f64 output| "
          f"{rel_k1:.2e}")
    check(rel_k1 <= TOL, "kernel vs twin")
    del ref, y, yr, yi, outs      # xr, xi, xc stay for phase 7
    torch.cuda.empty_cache()

    # the cost model's choice against the kernel off the headline size
    for n in OFF_HEADLINE:
        b = BATCH * N // n
        est = P.Planner().plan_c2c(n, np.float32, 0, b, dev)
        ft.config.kernel_mode = "off"
        plain = P.Planner().plan_c2c(n, np.float32, 0, b, dev)
        ft.config.kernel_mode = "auto"
        kdesc = {"alg": "pallas", "n": n, "radices": S.choose_radices(n)}
        hr, hi = planes(rng, (b, n), dev)
        ref = torch.fft.fft(torch.complex(hr, hi).to(torch.complex128))
        line = []
        for desc in (kdesc, plain):
            fn = c2c_ops.build_c2c_split(desc, -1, np.float32, dev)
            t, e = time_vs_oracle(fn, hr, hi, ref)
            check(e <= TOL, f"{P.sprint_desc(desc)} at n={n}: {e:.2e}")
            line.append(f"{P.sprint_desc(desc)} {t * 1e6:.1f} us "
                        f"({gflops(n, b, t):.1f} GFLOPS, rel err {e:.2e})")
        print(f"[6] n={n} B={b}: ESTIMATE picks {P.sprint_desc(est)}; "
              + "; ".join(line) + f" ({smi_line})")
        del hr, hi, ref
    torch.cuda.empty_cache()

    pl = ft.the_planner
    t0 = time.perf_counter()
    pm = ft.plan_many_dft([N], howmany=4096, flags=ft.MEASURE,
                          device="cuda")
    st = pl.stats
    print(f"[6] MEASURE n={N} B=4096 in {time.perf_counter() - t0:.1f} s: "
          f"{pm!r}; nmeasure={st['nmeasure']} "
          f"nmeasure_failed={st['nmeasure_failed']}")
    check(st["nmeasure"] > 0, "MEASURE timed nothing")
    check(st["nmeasure_failed"] == 0,
          f"MEASURE candidate failed: {st.get('last_measure_error')}")
    mr, mi = planes(rng, (4096, N), dev)
    mo = pm.execute(torch.complex(mr, mi))
    e_m = relerr(mo.to(torch.complex128),
                 torch.fft.fft(torch.complex(mr, mi).to(torch.complex128)))
    print(f"[6] MEASURE plan rel err vs torch.fft complex128 {e_m:.2e}")
    check(e_m <= TOL, "MEASURE plan over tolerance")
    del mr, mi, mo

    # -- 7. where the time goes on the main path ----------------------------
    profile_calls(f"apply_split ({BATCH}, {N})", plan.apply_split, (xr, xi),
                  smi_line)
    profile_calls(f"execute ({BATCH}, {N}) complex64", plan.execute, (xc,),
                  smi_line)
    sr, si = xr[:64].contiguous(), xi[:64].contiguous()
    profile_calls(f"apply_split (64, {N})", p64.apply_split, (sr, si),
                  smi_line)
    kernels = [{
        "name": "stockham_c2c",
        "route": "cuda",
        "source": "fftw3_tpu_torch/csrc/stockham_c2c.cu",
        "replaces": "fftw3_tpu/ops/pallas_stockham.py:641",
        # execute's form: its launches, its time, its error against the twin
        "layout": "complex64 in and out",
        "launches": launches,
        "max_abs_err": max_abs,
        "rel_err": rel_k1,
        "ms": rows[0][1] * 1e3,
        "planes_ms": rows[1][1] * 1e3,
        "plain_ms": t_twin * 1e3,
        "library_ms": t_fft * 1e3,
        "stage_form": S.form_label(MAIN_RADICES),
    }]
    kernels[0]["bound_ms"], kernels[0]["bound_by"] = bound(
        16.0 * BATCH * N, fft_flops(BATCH * N, N))
    del xr, xi, xc, sr, si, plan, p64, pm
    torch.cuda.empty_cache()
    print(f"[7] phases 1-7 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 8. the multi-axis and four-step kernels vs twins vs float64 --------
    worst = {"inner_c2c": 0.0, "c2c_2d": 0.0, "stockham_c2c_fourstep": 0.0}
    ncases = dict.fromkeys(worst, 0)
    for n in INNER_NS:
        rad = S.choose_radices(n)
        for sign in (-1, +1):
            table = S.device_table(n, tuple(rad), sign, dev)
            for pre in PRES:
                for L in INNER_LS:
                    xr, xi = planes(rng, (pre, n, L), dev)
                    e, eo = grid_case(
                        f"inner n={n} L={L} pre={pre} sign={sign}",
                        lambda: inner.inner_c2c_cuda(xr, xi, rad, table),
                        lambda: inner.inner_c2c_torch(xr, xi, rad, sign),
                        lambda: oracle(torch.complex(xr, xi), (-2,), sign),
                        pre * n * L)
                    worst["inner_c2c"] = max(worst["inner_c2c"], e)
                    ncases["inner_c2c"] += 1
                    del xr, xi
        print(f"[8] inner_c2c n={n} r={rad}: {len(PRES) * len(INNER_LS) * 2}"
              f" cases, worst kernel-twin so far "
              f"{worst['inner_c2c']:.2e}", flush=True)
    for n1, n2 in PLANES_2D:
        r1, r2 = S.choose_radices(n1), S.choose_radices(n2)
        for sign in (-1, +1):
            table = fused2d.device_table_2d(n1, tuple(r1), n2, tuple(r2),
                                            sign, dev)
            for pre in PRES:
                xr, xi = planes(rng, (pre, n1, n2), dev)
                e, eo = grid_case(
                    f"c2c_2d ({n1}, {n2}) pre={pre} sign={sign}",
                    lambda: fused2d.c2c_2d_cuda(xr, xi, r1, r2, table),
                    lambda: fused2d.c2c_2d_torch(xr, xi, r1, r2, sign),
                    lambda: oracle(torch.complex(xr, xi), (-2, -1), sign),
                    pre * n1 * n2)
                worst["c2c_2d"] = max(worst["c2c_2d"], e)
                ncases["c2c_2d"] += 1
                print(f"[8] c2c_2d ({n1}, {n2}) r={r1},{r2} pre={pre} "
                      f"sign={sign:+d}: kernel-twin {e:.2e} kernel-f64 "
                      f"{eo if eo is None else f'{eo:.2e}'}")
                del xr, xi
    for q, rad, p, store in PRETWIDDLE_CASES:
        for sign in (-1, +1):
            table = S.device_table(q, tuple(rad), sign, dev)
            w = S.device_pretwiddle(p, q, sign, dev)
            for g in PRETWIDDLE_GROUPS:
                xr, xi = planes(rng, (g * p, q), dev)

                def pt_oracle():
                    # rows b*p + k1: pre-twiddle, DFT over q (row order), then
                    # the kernel's (g, q, p) layout when it stores transposed
                    x = torch.complex(xr, xi).to(torch.complex128).reshape(
                        g, p, q) * torch.complex(w[0], w[1]).to(
                            torch.complex128)
                    y = oracle(x, (-1,), sign)
                    return y.transpose(1, 2) if store else y.reshape(g * p, q)
                e, eo = grid_case(
                    f"stockham_c2c pretwiddle q={q} p={p} store={store} "
                    f"groups={g} sign={sign}",
                    lambda: S.stockham_c2c_cuda(xr, xi, rad, table,
                                                pretwiddle=w,
                                                store_transposed=store),
                    lambda: S.stockham_c2c_torch(xr, xi, rad, sign,
                                                 pretwiddle_p=p,
                                                 store_transposed=store),
                    pt_oracle, g * p * q)
                worst["stockham_c2c_fourstep"] = max(
                    worst["stockham_c2c_fourstep"], e)
                ncases["stockham_c2c_fourstep"] += 1
                del xr, xi
        print(f"[8] stockham_c2c pretwiddle q={q} r={rad} p={p} "
              f"store_transposed={store}: worst kernel-twin so far "
              f"{worst['stockham_c2c_fourstep']:.2e}")
    for k, e in worst.items():
        print(f"[8] {k}: {ncases[k]} cases, worst kernel-twin {e:.2e} "
              f"(max-abs over max-abs; tolerance {TOL})")
    torch.cuda.empty_cache()
    print(f"[8] done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # -- 9. the 3-D path: plan_dft_3d(512, 512, 512) ------------------------
    cube = (CUBE,) * 3
    p3 = ft.plan_dft_3d(*cube, device="cuda")
    print(f"[9] {p3!r}")
    d512 = {"alg": "pallas", "n": CUBE, "radices": S.choose_radices(CUBE)}
    check(p3.descriptors == {0: d512, 1: d512, 2: d512},
          f"3-D descriptors {p3.descriptors}")
    xr, xi = planes(rng, cube, dev)
    torch.cuda.synchronize()
    reset_counts()
    yr, yi = p3.apply_split(xr, xi)
    torch.cuda.synchronize()
    counts3_split = read_counts()
    print(f"[9] launches, one apply_split call: {counts3_split}")
    check(counts3_split == only(inner_c2c=1, c2c_2d=1, c2c_2d_ring=1,
                                c2c_2d_fixed=1),
          "the 3-D split path is not one K2 and one K3 launch")
    check(bool(torch.isfinite(yr).all() and torch.isfinite(yi).all()),
          "non-finite 3-D output")
    y = torch.complex(yr, yi)
    del yr, yi
    ref = oracle(torch.complex(xr, xi), (0, 1, 2), -1)
    e3 = relerr(y.to(torch.complex128), ref)
    del ref
    torch.cuda.empty_cache()
    # execute's own run (K2 reading complex64, K3 writing it): its
    # launches are the ones the kernels line reports
    xc = torch.complex(xr, xi)
    torch.cuda.synchronize()
    reset_counts()
    yc = p3.execute(xc)
    torch.cuda.synchronize()
    counts3 = read_counts()
    print(f"[9] launches, one execute call: {counts3}")
    check(counts3 == only(inner_c2c=1, c2c_2d=1, c2c_2d_ring=1,
                          c2c_2d_fixed=1),
          "the 3-D execute path is not one K2 and one K3 launch")
    e3x = relerr(yc, y)
    del yc, xc
    print(f"[9] rel err vs torch.fft.fftn complex128: {e3:.3e}; execute vs "
          f"apply_split {e3x:.1e}")
    check(e3 <= TOL and e3x == 0.0, "3-D path over tolerance")
    del y
    t3 = time_ms(p3.apply_split, (xr, xi))
    xc = torch.complex(xr, xi)
    t3_lib = time_ms(lambda z: torch.fft.fftn(z), (xc,))
    del xc
    b3, _ = bound(2 * 16.0 * CUBE ** 3, fft_flops(CUBE ** 3, CUBE, CUBE,
                                                    CUBE))
    print(f"[9] plan {t3:.3f} ms vs torch.fft.fftn {t3_lib:.3f} ms; bound "
          f"{b3:.3f} ms (two passes of 16 B per point over HBM) "
          f"({smi_line})")
    torch.cuda.empty_cache()

    # gradient: K3's adjoint, then K2's, each the opposite-sign launch
    t_in = S.device_table(CUBE, tuple(d512["radices"]), +1, dev)
    t_2d = fused2d.device_table_2d(CUBE, tuple(d512["radices"]), CUBE,
                                   tuple(d512["radices"]), +1, dev)

    def adj3(gr, gi):
        ar, ai = fused2d.c2c_2d_cuda(gr, gi, d512["radices"],
                                     d512["radices"], t_2d)
        ar, ai = inner.inner_c2c_cuda(ar.reshape(1, CUBE, -1),
                                      ai.reshape(1, CUBE, -1),
                                      d512["radices"], t_in)
        return ar.reshape(cube), ai.reshape(cube)
    grad_equals(f"plan_dft_3d{cube}", p3.apply_split, adj3, cube, rng, dev)
    del xr, xi, p3
    torch.cuda.empty_cache()
    print(f"[9] done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # -- 10. the 2-D batched path: plan_many_dft([512, 512], howmany=64) ----
    p2 = ft.plan_many_dft(list(MANY_2D[1:]), howmany=MANY_2D[0],
                          device="cuda")
    print(f"[10] {p2!r}")
    xr, xi = planes(rng, MANY_2D, dev)
    torch.cuda.synchronize()
    reset_counts()
    yr, yi = p2.apply_split(xr, xi)
    torch.cuda.synchronize()
    counts2_split = read_counts()
    xc = torch.complex(xr, xi)
    torch.cuda.synchronize()
    reset_counts()
    yc = p2.execute(xc)        # K3 writing complex64, its entry split
    torch.cuda.synchronize()
    counts2 = read_counts()
    print(f"[10] launches, one call: apply_split {counts2_split}; execute "
          f"{counts2}")
    check(counts2_split == only(c2c_2d=1, c2c_2d_ring=1, c2c_2d_fixed=1)
          and counts2 == only(c2c_2d=1, c2c_2d_ring=1, c2c_2d_fixed=1),
          "the 2-D batched path is not one K3 launch")
    check(torch.equal(yc, torch.complex(yr, yi)),
          "2-D execute differs from apply_split's planes")
    del yc, xc
    e2 = relerr(torch.complex(yr, yi).to(torch.complex128),
                oracle(torch.complex(xr, xi), (1, 2), -1))
    print(f"[10] rel err vs torch.fft.fft2 complex128: {e2:.3e}")
    check(e2 <= TOL, "2-D batched path over tolerance")
    del yr, yi
    t2 = time_ms(p2.apply_split, (xr, xi))
    xc = torch.complex(xr, xi)
    t2_lib = time_ms(lambda z: torch.fft.fft2(z), (xc,))
    b2, _ = bound(16.0 * math.prod(MANY_2D),
                  fft_flops(math.prod(MANY_2D), *MANY_2D[1:]))
    print(f"[10] plan {t2:.3f} ms vs torch.fft.fft2 {t2_lib:.3f} ms; bound "
          f"{b2:.3f} ms ({smi_line})")
    p2b = ft.plan_many_dft(list(MANY_2D[1:]), howmany=MANY_2D[0],
                           sign=ft.BACKWARD, device="cuda")
    grad_equals(f"plan_many_dft {MANY_2D}", p2.apply_split, p2b.apply_split,
                MANY_2D, rng, dev)
    del xr, xi, xc, p2, p2b
    torch.cuda.empty_cache()

    # -- 11. n = 4096, B = 4096: MEASURE, then the wisdom-pinned four-step --
    ft.forget_wisdom()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts()
    pm4 = ft.plan_many_dft([N4], howmany=B4, flags=ft.MEASURE, device="cuda")
    torch.cuda.synchronize()
    race = read_counts()
    print(f"[11] (a) MEASURE in {time.perf_counter() - t0:.1f} s: {pm4!r} "
          f"picks {P.sprint_desc(pm4.descriptors[1])}; kernel launches while "
          f"it timed its candidates: {race}")
    # the four-step's pre-twiddled K1 and K1's wide form run nowhere else:
    # both were timed
    check(race["stockham_c2c_fourstep"] > 0, "MEASURE did not race pallas4")
    check(race["stockham_c2c_wide"] > 0,
          "MEASURE did not race the all-butterfly pallas schedule")
    check(pl.stats["nmeasure_failed"] == 0,
          f"MEASURE candidate failed: {pl.stats.get('last_measure_error')}")
    xr, xi = planes(rng, (B4, N4), dev)
    ref4 = oracle(torch.complex(xr, xi), (-1,), -1)
    ym = pm4.execute(torch.complex(xr, xi))
    e4m = relerr(ym.to(torch.complex128), ref4)
    del ym
    print(f"[11] (a) MEASURE plan rel err vs torch.fft complex128 {e4m:.2e}")
    check(e4m <= TOL, "MEASURE plan at n=4096 over tolerance")

    ft.forget_wisdom()
    check(ft.import_reference_wisdom(REFERENCE_WISDOM, device="cuda"),
          "reference wisdom refused")
    p4 = ft.plan_many_dft([N4], howmany=B4, device="cuda")
    print(f"[11] (b) wisdom-pinned plan: {p4!r}")
    check(p4.descriptors == {1: PALLAS4_DESC}, f"pinned plan {p4!r}")
    torch.cuda.synchronize()
    reset_counts()
    yr, yi = p4.apply_split(xr, xi)
    torch.cuda.synchronize()
    counts4 = read_counts()
    print(f"[11] (b) launches, one apply_split call: {counts4}")
    check(counts4 == only(stockham_c2c_fourstep=1, inner_c2c=1),
          "the four-step is not one K2 and one pre-twiddled K1 launch")
    e4 = relerr(torch.complex(yr, yi).to(torch.complex128), ref4)
    print(f"[11] (b) rel err vs torch.fft complex128 {e4:.2e}")
    check(e4 <= TOL, "four-step over tolerance")
    del yr, yi
    p4b = ft.plan_many_dft([N4], howmany=B4, sign=ft.BACKWARD, device="cuda")
    check(p4b.descriptors == {1: PALLAS4_DESC}, f"pinned plan {p4b!r}")
    grad_equals(f"pallas4 ({B4}, {N4})", p4.apply_split, p4b.apply_split,
                (B4, N4), rng, dev)
    del p4b

    # (c) the plan pinned to the reference's all-butterfly [64, 64]: one
    # launch of K1's wide form per call
    ft.forget_wisdom()
    check(ft.import_reference_wisdom(REFERENCE_WISDOM_WIDE, device="cuda"),
          "reference wisdom refused")
    pw = ft.plan_many_dft([N4], howmany=B4, device="cuda")
    print(f"[11] (c) wisdom-pinned plan: {pw!r}")
    check(pw.descriptors == {1: WIDE_DESC}, f"pinned plan {pw!r}")
    torch.cuda.synchronize()
    reset_counts()
    yr, yi = pw.apply_split(xr, xi)
    torch.cuda.synchronize()
    counts_ws = read_counts()
    xc = torch.complex(xr, xi)
    torch.cuda.synchronize()
    reset_counts()
    yc = pw.execute(xc)        # the wide form reading and writing complex64
    torch.cuda.synchronize()
    counts_w = read_counts()
    print(f"[11] (c) launches, one call: apply_split {counts_ws}; execute "
          f"{counts_w}")
    check(counts_ws == only(stockham_c2c_wide=1)
          and counts_w == only(stockham_c2c_wide=1),
          "the pinned [64, 64] plan is not one launch of K1's wide form")
    check(torch.equal(yc, torch.complex(yr, yi)),
          "the wide K1's execute differs from its apply_split")
    del yc, xc
    ew = relerr(torch.complex(yr, yi).to(torch.complex128), ref4)
    print(f"[11] (c) rel err vs torch.fft complex128 {ew:.2e}")
    check(ew <= TOL, "the wide K1 plan over tolerance")
    del yr, yi, ref4
    pwb = ft.plan_many_dft([N4], howmany=B4, sign=ft.BACKWARD, device="cuda")
    check(pwb.descriptors == {1: WIDE_DESC}, f"pinned plan {pwb!r}")
    grad_equals(f"K1 wide ({B4}, {N4})", pw.apply_split, pwb.apply_split,
                (B4, N4), rng, dev)
    del pwb
    # K1's wide form against its twin and complex128 in both signs, then
    # the three plans interleaved with torch.fft.fft
    rad_w = WIDE_DESC["radices"]
    for sign in (-1, +1):
        t_w = S.device_table(N4, tuple(rad_w), sign, dev)
        kr, ki = S.stockham_c2c_cuda(xr, xi, rad_w, t_w)
        tr, ti = S.stockham_c2c_torch(xr, xi, rad_w, sign)
        err, rel = twin_err(f"stockham_c2c wide sign {sign:+d}", kr, ki, tr,
                            ti)
        eo = relerr(torch.complex(kr, ki).to(torch.complex128),
                    oracle(torch.complex(xr, xi), (-1,), sign))
        check(eo <= TOL, f"K1 wide sign {sign:+d} vs complex128 {eo:.2e}")
        print(f"[11] K1 wide ({B4}, {N4}) {rad_w} sign {sign:+d}: "
              f"kernel-twin max abs {err:.3e}, over max |twin| {rel:.2e}, "
              f"kernel-f64 {eo:.2e}")
        if sign < 0:
            wide_err = (err, rel)
        del kr, ki, tr, ti
    t_w = S.device_table(N4, tuple(rad_w), -1, dev)
    xc = torch.complex(xr, xi)
    arms11 = {"pallas4-32x128": (p4.apply_split, (xr, xi)),
              "K1 wide [64, 64]": (pw.apply_split, (xr, xi)),
              f"MEASURE's {P.sprint_desc(pm4.descriptors[1])}":
                  (pm4.apply_split, (xr, xi)),
              "torch.fft.fft": (lambda z: torch.fft.fft(z), (xc,))}
    times11 = {k: [] for k in arms11}
    for k in list(arms11) + list(arms11)[::-1]:
        times11[k].append(time_ms(*arms11[k]))
    b4, by4 = bound(16.0 * N4 * B4, fft_flops(N4 * B4, N4))
    for k, ts in times11.items():
        print(f"[11] {k} ({B4}, {N4}): {ts[0]:.3f} / {ts[1]:.3f} ms "
              f"({smi_line})")
    print(f"[11] bound {b4:.3f} ms ({by4})")
    wide_row = {
        "name": "stockham_c2c_wide", "route": "cuda",
        "source": "fftw3_tpu_torch/csrc/stockham_c2c.cu",
        "replaces": "fftw3_tpu/ops/pallas_stockham.py:641",
        "layout": "complex64 in and out",
        "launches": counts_w["stockham_c2c_wide"],
        "max_abs_err": wide_err[0], "rel_err": wide_err[1],
        "ms": time_ms(lambda z: S.stockham_c2c_cuda(
            z, None, rad_w, t_w, complex_out=True), (xc,)),
        "planes_ms": time_ms(lambda a, b: S.stockham_c2c_cuda(
            a, b, rad_w, t_w), (xr, xi)),
        "plain_ms": time_ms(lambda a, b: S.stockham_c2c_torch(a, b, rad_w,
                                                              -1), (xr, xi)),
        "library_ms": min(times11["torch.fft.fft"]),
        "bound_ms": b4, "bound_by": by4,
        "stage_form": S.form_label(rad_w)}
    print(f"[11] K1 wide kernel, complex64 in and out {wide_row['ms']:.3f} "
          f"ms, planes {wide_row['planes_ms']:.3f} ms, twin "
          f"{wide_row['plain_ms']:.3f} ms ({smi_line})")
    del xr, xi, xc, p4, pm4, pw, arms11
    ft.forget_wisdom()
    torch.cuda.empty_cache()

    # -- 12. the suite's 256^3, wherever ESTIMATE sends it -------------------
    c256 = (SUITE_CUBE,) * 3
    p256 = ft.plan_dft_3d(*c256, device="cuda")
    print(f"[12] {p256!r}")
    xr, xi = planes(rng, c256, dev)
    torch.cuda.synchronize()
    reset_counts()
    yr, yi = p256.apply_split(xr, xi)
    torch.cuda.synchronize()
    print(f"[12] launches, one apply_split call: {read_counts()}")
    e256 = relerr(torch.complex(yr, yi).to(torch.complex128),
                  oracle(torch.complex(xr, xi), (0, 1, 2), -1))
    print(f"[12] rel err vs torch.fft.fftn complex128 {e256:.2e}")
    check(e256 <= TOL, "256^3 over tolerance")
    del yr, yi
    t256 = time_ms(p256.apply_split, (xr, xi))
    xc = torch.complex(xr, xi)
    t256_lib = time_ms(lambda z: torch.fft.fftn(z), (xc,))
    print(f"[12] plan {t256:.3f} ms vs torch.fft.fftn {t256_lib:.3f} ms "
          f"({smi_line})")
    p256b = ft.plan_dft_3d(*c256, sign=ft.BACKWARD, device="cuda")
    grad_equals(f"plan_dft_3d{c256} (autograd through its solvers)",
                p256.apply_split, p256b.apply_split, c256, rng, dev,
                exact=False)
    del xr, xi, xc, p256, p256b
    torch.cuda.empty_cache()

    # -- 13. torch.profiler over the new paths, in a fresh process ---------
    # On the card machine the profiler stops seeing device activity about a
    # minute into a process, so these profiles run in a child process.
    sys.stdout.flush()
    res = subprocess.run([sys.executable, __file__, "--profile-paths", "c2c",
                          "--seed", str(args.seed)], timeout=600)
    check(res.returncode == 0, "the profile of the paths failed")

    # -- 14. each kernel at its path's shape: kernel, twin, library call ----
    rows14 = []
    rad = S.choose_radices(CUBE)

    # K2: axis 0 of 512^3, as the 3-D plan runs it, in both signs against
    # its twin and complex128
    shape = (1, CUBE, CUBE * CUBE)
    xr, xi = planes(rng, shape, dev)
    for sign in (+1, -1):
        tab = S.device_table(CUBE, tuple(rad), sign, dev)
        kr, ki = inner.inner_c2c_cuda(xr, xi, rad, tab)
        tr, ti = inner.inner_c2c_torch(xr, xi, rad, sign)
        err, rel = twin_err(f"inner_c2c {shape} sign {sign:+d}", kr, ki, tr,
                            ti)
        del tr, ti
        eo = relerr(torch.complex(kr, ki).to(torch.complex128),
                    oracle(torch.complex(xr, xi), (-2,), sign))
        del kr, ki
        check(eo <= TOL, f"K2 {shape} sign {sign:+d} vs complex128 {eo:.2e}")
        print(f"[14] K2 {shape} sign {sign:+d}: kernel-twin {rel:.2e}, "
              f"kernel-f64 {eo:.2e}")
        torch.cuda.empty_cache()
    xc = torch.complex(xr, xi)
    # execute's form, complex64 in: bit for bit the planar form's output,
    # so the planar form's error against the twin is its error
    cr, ci = inner.inner_c2c_cuda(xc, None, rad, tab)
    pr, pi = inner.inner_c2c_cuda(xr, xi, rad, tab)
    check(torch.equal(cr, pr) and torch.equal(ci, pi),
          "K2's complex64-in form differs from its planar form")
    del cr, ci, pr, pi
    rows14.append({
        "name": "inner_c2c", "route": "cuda",
        "source": "fftw3_tpu_torch/csrc/inner_c2c.cu",
        "replaces": "fftw3_tpu/ops/pallas_stockham.py:683",
        "layout": "complex64 in",
        "launches": counts3["inner_c2c"],
        "cout_launches": counts3["inner_c2c_cout"], "max_abs_err": err,
        "rel_err": rel,
        "ms": time_ms(lambda z: inner.inner_c2c_cuda(z, None, rad, tab),
                      (xc,)),
        "planes_ms": time_ms(lambda a, b: inner.inner_c2c_cuda(a, b, rad,
                                                               tab),
                             (xr, xi)),
        "plain_ms": time_ms(lambda a, b: inner.inner_c2c_torch(a, b, rad,
                                                               -1),
                            (xr, xi)),
        "library_ms": time_ms(lambda z: torch.fft.fft(z, dim=-2), (xc,)),
        "stage_form": S.form_label(rad),
        "shape": shape})
    del xr, xi, xc
    torch.cuda.empty_cache()

    # K3: axes 1-2 of 512^3 (512 planes), and the 2-D batched shape
    for shape in ((CUBE,) * 3, MANY_2D):
        xr, xi = planes(rng, shape, dev)
        tab = fused2d.device_table_2d(CUBE, tuple(rad), CUBE, tuple(rad),
                                      -1, dev)
        kr, ki = fused2d.c2c_2d_cuda(xr, xi, rad, rad, tab)
        tr, ti = fused2d.c2c_2d_torch(xr, xi, rad, rad, -1)
        err, rel = twin_err(f"c2c_2d {shape}", kr, ki, tr, ti)
        del tr, ti
        # execute's form, complex64 out: bit for bit the planar form's
        kc = fused2d.c2c_2d_cuda(xr, xi, rad, rad, tab, complex_out=True)
        check(torch.equal(kc, torch.complex(kr, ki)),
              f"K3's complex64-out form differs from its planar form "
              f"at {shape}")
        del kr, ki, kc
        ms, in_order_ms = k3_forms(xr, xi, rad, rad, tab, shape)
        fixed_ms, run_time_ms = k3_fixed(xr, xi, rad, tab, shape)
        xc = torch.complex(xr, xi)
        counts = counts3 if shape[0] == CUBE else counts2
        rows14.append({
            "name": "c2c_2d", "route": "cuda",
            "source": "fftw3_tpu_torch/csrc/c2c_2d.cu",
            "replaces": "fftw3_tpu/ops/pallas_stockham.py:897",
            "layout": "complex64 out",
            "launches": counts["c2c_2d"],
            "ring_launches": counts["c2c_2d_ring"],
            "fixed_launches": counts["c2c_2d_fixed"],
            "max_abs_err": err, "rel_err": rel,
            "ms": ms, "in_order_ms": in_order_ms, "fixed_ms": fixed_ms,
            "run_time_ms": run_time_ms,
            "planes_ms": time_ms(lambda a, b: fused2d.c2c_2d_cuda(
                a, b, rad, rad, tab), (xr, xi)),
            "plain_ms": time_ms(lambda a, b: fused2d.c2c_2d_torch(
                a, b, rad, rad, -1), (xr, xi)),
            "library_ms": time_ms(lambda z: torch.fft.fft2(z), (xc,)),
            "stage_form": f"rows: {S.form_label(rad)}; columns: "
                          f"{S.form_label(rad)}",
            "cluster": fused2d.CLUSTER, "shape": shape})
        del xr, xi, xc
        torch.cuda.empty_cache()
    # K3 off the 512 x 512 planes: the run-time level plans, as before the
    # 512 x 512 levels were compiled in
    for shape in K3_OFF_PLANES:
        r1, r2 = S.choose_radices(shape[1]), S.choose_radices(shape[2])
        xr, xi = planes(rng, shape, dev)
        tab = fused2d.device_table_2d(shape[1], tuple(r1), shape[2],
                                      tuple(r2), -1, dev)
        fixed0 = fused2d.fixed_launches
        kr, ki = fused2d.c2c_2d_cuda(xr, xi, r1, r2, tab)
        e = relerr(torch.complex(kr, ki),
                   torch.complex(*fused2d.c2c_2d_torch(xr, xi, r1, r2, -1)))
        check(e <= TOL, f"c2c_2d {shape}: {e:.2e}")
        del kr, ki
        ms, in_order_ms = k3_forms(xr, xi, r1, r2, tab, shape)
        check(fused2d.fixed_launches == fixed0,
              f"K3 at {shape} took the levels compiled in for 512 x 512")
        before = K3_OFF_PLANES_BEFORE_MS[shape]
        if smi_line == K3_BEFORE_CARD:
            verdict = ("within" if ms <= K3_RING_SLACK * before else "OVER")
            print(f"[14] c2c_2d {shape}: run-time plans {ms:.3f} ms against "
                  f"{before:.3f} before the compiled-in levels "
                  f"({ms / before:.3f}x, {verdict} {K3_RING_SLACK}x)")
        xc = torch.complex(xr, xi)
        lib = time_ms(lambda z: torch.fft.fft2(z), (xc,))
        bms, by = bound(16.0 * math.prod(shape),
                        fft_flops(math.prod(shape), *shape[1:]))
        print(f"[14] c2c_2d {shape} (rows: {S.form_label(r2)}; columns: "
              f"{S.form_label(r1)}): kernel {ms:.3f} ms on the ring, "
              f"{in_order_ms:.3f} in order (complex64 out), library "
              f"{lib:.3f} ms, bound {bms:.3f} ms ({by}); kernel-twin "
              f"{e:.2e} ({smi_line})")
        del xr, xi, xc
        torch.cuda.empty_cache()

    # K1 with the pre-twiddle: the four-step's q pass at n = 4096, B = 4096
    p, q = PALLAS4_DESC["p"], PALLAS4_DESC["q"]
    radq = S.choose_radices(q)
    shape = (B4 * p, q)
    xr, xi = planes(rng, shape, dev)
    tab = S.device_table(q, tuple(radq), -1, dev)
    w = S.device_pretwiddle(p, q, -1, dev)
    kr, ki = S.stockham_c2c_cuda(xr, xi, radq, tab, pretwiddle=w)
    tr, ti = S.stockham_c2c_torch(xr, xi, radq, -1, pretwiddle_p=p)
    err, rel = twin_err(f"stockham_c2c pretwiddle {shape}", kr, ki, tr, ti)
    del kr, ki, tr, ti
    rows14.append({
        "name": "stockham_c2c_fourstep", "route": "cuda",
        "source": "fftw3_tpu_torch/csrc/stockham_c2c.cu",
        "replaces": "fftw3_tpu/ops/pallas_stockham.py:654",
        "launches": counts4["stockham_c2c_fourstep"], "max_abs_err": err,
        "rel_err": rel,
        "ms": time_ms(lambda a, b: S.stockham_c2c_cuda(a, b, radq, tab,
                                                       pretwiddle=w),
                      (xr, xi)),
        "plain_ms": time_ms(lambda a, b: S.stockham_c2c_torch(
            a, b, radq, -1, pretwiddle_p=p), (xr, xi)),
        # no single PyTorch call computes a pre-twiddled DFT; the four-step
        # as a whole is timed against torch.fft.fft in phase 11
        "library_ms": None,
        "stage_form": S.form_label(radq),
        "shape": shape})
    del xr, xi
    torch.cuda.empty_cache()

    for r in rows14:
        pts = math.prod(r["shape"])
        n_ax = r["shape"][-2:] if r["name"] == "c2c_2d" else \
            (r["shape"][-2],) if r["name"] == "inner_c2c" else \
            (r["shape"][-1],)
        extra = 8.0 * p * q if r["name"] == "stockham_c2c_fourstep" else 0.0
        r["bound_ms"], r["bound_by"] = bound(16.0 * pts + extra,
                                             fft_flops(pts, *n_ax))
        lib = r["library_ms"]
        print(f"[14] {r['name']} {r['shape']} "
              f"({r.get('stage_form', 'dense')}): kernel "
              f"{r['ms']:.3f} ms"
              + (f" ({r['layout']}; planes {r['planes_ms']:.3f} ms)"
                 if "layout" in r else "")
              + (f" ({r['cout_launches']} of {r['launches']} launches "
                 f"writing complex64)" if "cout_launches" in r else "")
              + (f" (in order {r['in_order_ms']:.3f} ms; "
                 f"{r['ring_launches']} of {r['launches']} launches on "
                 f"the ring)" if "in_order_ms" in r else "")
              + (f" (levels compiled in {r['fixed_ms']:.3f} ms, run-time "
                 f"plans {r['run_time_ms']:.3f} ms; {r['fixed_launches']} "
                 f"of {r['launches']} launches compiled in)"
                 if "fixed_ms" in r else "")
              + f", twin {r['plain_ms']:.3f} ms, library "
              f"{'none' if lib is None else f'{lib:.3f} ms'}, bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']}); kernel-twin max "
              f"abs err {r['max_abs_err']:.3e}, over max |twin| "
              f"{r['rel_err']:.2e} ({smi_line})")
    # what K2's narrow tile costs at n = 2048 (4 columns: 16-byte row
    # segments, half a sector): K2 against K1 on the same 2**26 points and
    # the same schedule, where K1 reads and writes whole rows
    n, rad = 2048, S.choose_radices(2048)
    tab = S.device_table(n, tuple(rad), -1, dev)
    xr, xi = planes(rng, (1, n, (1 << 26) // n), dev)
    t_k2 = time_ms(lambda a, b: inner.inner_c2c_cuda(a, b, rad, tab),
                   (xr, xi))
    yr, yi = xr.reshape(-1, n), xi.reshape(-1, n)
    t_k1 = time_ms(lambda a, b: S.stockham_c2c_cuda(a, b, rad, tab),
                   (yr, yi))
    print(f"[14] n={n} r={rad}, 2^26 points: K2 (tile of "
          f"{inner.tile_width(n, xr.shape[-1])} columns) {t_k2:.3f} ms vs K1 "
          f"(whole rows) {t_k1:.3f} ms, ratio {t_k2 / t_k1:.2f} ({smi_line})")
    del xr, xi, yr, yi
    torch.cuda.empty_cache()

    # -- 15. the multi-axis plans against the port's other routes ----------
    # On each plan's own descriptors: launches counted, output held against
    # the plan's, then timed in the order plan, K2 + K1, movedim + K1, and
    # back again, in this one process.
    for label, make in (
            (f"plan_dft_3d{(CUBE,) * 3}",
             lambda: ft.plan_dft_3d(CUBE, CUBE, CUBE, device="cuda")),
            (f"plan_many_dft {MANY_2D}",
             lambda: ft.plan_many_dft(list(MANY_2D[1:]), howmany=MANY_2D[0],
                                      device="cuda"))):
        pr = make()
        naxes = len(pr.descriptors)
        rt = routes(pr, dev)
        want_launches = {"K2 + K1": {"inner_c2c": naxes - 1,
                                     "stockham_c2c": 1},
                         "movedim + K1": {"stockham_c2c": naxes}}
        xr, xi = planes(rng, pr.problem.shape, dev)
        wr, wi = pr.apply_split(xr, xi)
        want = torch.complex(wr, wi)
        del wr, wi
        for rname, fn in rt.items():
            torch.cuda.synchronize()
            reset_counts()
            yr, yi = fn(xr, xi)
            torch.cuda.synchronize()
            c = {k: v for k, v in read_counts().items() if v}
            e = relerr(torch.complex(yr, yi), want)
            del yr, yi
            print(f"[15] {label} by {rname}: launches {c}, vs the plan "
                  f"{e:.2e}")
            check(e <= TOL, f"{label} by {rname} disagrees with the plan")
            check(rname not in want_launches or c == want_launches[rname],
                  f"{label} by {rname} launched {c}")
        del want
        times = {k: [] for k in rt}
        for k in list(rt) + list(rt)[::-1]:
            times[k].append(time_ms(rt[k], (xr, xi)))
        for k, ts in times.items():
            print(f"[15] {label} by {k}: {ts[0]:.3f} / {ts[1]:.3f} ms, "
                  f"best {min(ts) / min(times['plan']):.3f}x the plan's "
                  f"({smi_line})")
        del xr, xi, pr, rt
        torch.cuda.empty_cache()

    print(f"[15] done at {time.perf_counter() - t_start:.1f} s", flush=True)
    c128 = torch.complex128

    # -- 16. the real kernels vs twins vs float64 ---------------------------
    worst = dict.fromkeys(("r2c", "c2r", "r2c_inner"), 0.0)
    ncases = dict.fromkeys(worst, 0)

    def k6_case(n, rad, b, table):
        """K6 on random half spectra (Im X[0] and Im X[n/2] must drop
        out) against the dense twin, the butterfly twin and float64;
        returns the larger kernel-twin error."""
        xr, xi = planes(rng, (b, n // 2 + 1), dev)
        y = RS.c2r_cuda(xr, xi, rad, table)
        e_kt = relerr(y, RS.c2r_torch(xr, xi, rad))
        e_kb = relerr(y, RS.c2r_torch(xr, xi, rad, "all"))
        e_ko = relerr(y.double(), torch.fft.irfft(
            torch.complex(xr, xi).to(c128), n) * n)
        check(max(e_kt, e_kb, e_ko) <= TOL, f"c2r n={n} {rad} B={b}: "
              f"kernel-twin {e_kt:.2e}, kernel-butterfly twin {e_kb:.2e}, "
              f"kernel-f64 {e_ko:.2e}")
        return max(e_kt, e_kb)
    for n in REAL_NS:
        rad = S.choose_radices(n // 2)
        t_fwd = RS.device_table(n, tuple(rad), -1, dev)
        t_inv = RS.device_table(n, tuple(rad), +1, dev)
        for b in REAL_BATCHES:
            x = real_rows(rng, (b, n), dev)
            kr, ki = RS.r2c_cuda(x, rad, t_fwd)
            tr, ti = RS.r2c_torch(x, rad)
            torch.cuda.synchronize()
            k = torch.complex(kr, ki)
            e_kt = relerr(k, torch.complex(tr, ti))
            e_ko = relerr(k.to(c128), torch.fft.rfft(x.double()))
            check(e_kt <= TOL and e_ko <= TOL, f"r2c n={n} B={b}: "
                  f"kernel-twin {e_kt:.2e}, kernel-f64 {e_ko:.2e}")
            worst["r2c"] = max(worst["r2c"], e_kt)
            worst["c2r"] = max(worst["c2r"], k6_case(n, rad, b, t_inv))
            ncases["r2c"] += 1
            ncases["c2r"] += 1
            del x, kr, ki, tr, ti, k
        for pre in R2C_INNER_PRES:
            for L in R2C_INNER_LS:
                x = real_rows(rng, (pre, n, L), dev)
                kr, ki = RS.r2c_inner_cuda(x, rad, t_fwd)
                tr, ti = RS.r2c_inner_torch(x, rad, "all")
                torch.cuda.synchronize()
                k = torch.complex(kr, ki)
                e_kt = relerr(k, torch.complex(tr, ti))
                e_ko = relerr(k.to(c128), torch.fft.rfft(x.double(), dim=-2)) \
                    if pre * n * L <= GRID_ORACLE_POINTS else None
                check(e_kt <= TOL and (e_ko is None or e_ko <= TOL),
                      f"r2c_inner n={n} pre={pre} L={L}: kernel-twin "
                      f"{e_kt:.2e}, kernel-f64 {e_ko}")
                worst["r2c_inner"] = max(worst["r2c_inner"], e_kt)
                ncases["r2c_inner"] += 1
                del x, kr, ki, tr, ti, k
        print(f"[16] n={n} r={rad}: worst kernel-twin so far "
              + ", ".join(f"{k} {e:.2e}" for k, e in worst.items()),
              flush=True)
    # K6 on a radix-5, a dense-first, a dense-last and the DCT-III's [256]
    # schedule
    for n, rad in K6_SCHEDULES:
        t_inv = RS.device_table(n, tuple(rad), +1, dev)
        for b in REAL_BATCHES:
            worst["c2r"] = max(worst["c2r"], k6_case(n, rad, b, t_inv))
            ncases["c2r"] += 1
        print(f"[16] K6 n={n} r={rad} ({S.form_label(rad)}): worst "
              f"kernel-twin so far {worst['c2r']:.2e}", flush=True)
    for k, e in worst.items():
        print(f"[16] {k}: {ncases[k]} cases, worst kernel-twin {e:.2e} "
              f"(max-abs over max-abs; tolerance {TOL}), each also within "
              f"{TOL} of complex128 up to {GRID_ORACLE_POINTS} points")
    torch.cuda.empty_cache()

    # -- 17. the 1-D real path: plan_dft_r2c((65536, 1024), axes=(1,)) -----
    n1 = REAL_1D[1]
    rad1 = S.choose_radices(n1 // 2)
    p1 = ft.plan_dft_r2c(REAL_1D, axes=(1,), device="cuda")
    q1 = ft.plan_dft_c2r(REAL_1D, axes=(1,), device="cuda")
    print(f"[17] {p1!r}; {q1!r}")
    check(p1.descriptors == {1: {"alg": "pallas_r2c", "n": n1,
                                 "radices": rad1}}, f"1-D r2c plan {p1!r}")
    check(q1.descriptors == {1: {"alg": "pallas_c2r", "n": n1,
                                 "radices": rad1}}, f"1-D c2r plan {q1!r}")
    x = real_rows(rng, REAL_1D, dev)
    torch.cuda.synchronize()
    reset_counts()
    yr, yi = p1.apply_split(x)
    torch.cuda.synchronize()
    c17_r2c = read_counts()
    check(c17_r2c == only(r2c=1), f"1-D r2c launched {c17_r2c}")
    yc = p1.execute(x)
    torch.cuda.synchronize()
    reset_counts()
    z = q1.apply_split(yr, yi)
    torch.cuda.synchronize()
    c17_c2r = read_counts()
    check(c17_c2r == only(c2r=1), f"1-D c2r launched {c17_c2r}")
    zc = q1.execute(yc)
    ref = torch.fft.rfft(x.double())
    e_r = relerr(torch.complex(yr, yi).to(c128), ref)
    e_rx = relerr(yc.to(c128), ref)
    del ref
    e_c = relerr(z.double(), torch.fft.irfft(yc.to(c128), n1) * n1)
    e_rt = relerr(zc.double(), n1 * x.double())
    check(bool(torch.isfinite(yc).all() and torch.isfinite(zc).all()),
          "non-finite 1-D real output")
    check(tuple(yc.shape) == (REAL_1D[0], n1 // 2 + 1)
          and tuple(zc.shape) == REAL_1D, "wrong 1-D real output shape")
    print(f"[17] launches per call: r2c {c17_r2c['r2c']} K4, c2r "
          f"{c17_c2r['c2r']} K6; rel err vs torch.fft complex128: r2c "
          f"apply_split {e_r:.3e}, execute {e_rx:.3e}; c2r vs irfft * n "
          f"{e_c:.3e}; c2r(r2c(x)) vs n x {e_rt:.3e}")
    check(max(e_r, e_rx, e_c, e_rt) <= TOL, "1-D real path over tolerance")
    del yc, z, zc

    # gradients: r2c's backward is one K1 launch, c2r's one K4 launch
    xg = x.clone().requires_grad_()
    gr, gi = planes(rng, (REAL_1D[0], n1 // 2 + 1), dev)
    outr, outi = p1.apply_split(xg)
    torch.cuda.synchronize()
    reset_counts()
    torch.autograd.backward([outr, outi], [gr, gi])
    torch.cuda.synchronize()
    c_back = read_counts()
    check(c_back == only(stockham_c2c=1),
          f"r2c's backward launched {c_back}")
    x64 = x.double().requires_grad_()
    y64 = torch.fft.rfft(x64)
    torch.autograd.backward([y64.real, y64.imag], [gr.double(), gi.double()])
    e_gr = relerr(xg.grad.double(), x64.grad)
    del xg, outr, outi, x64, y64
    hr, hi = yr.clone().requires_grad_(), yi.clone().requires_grad_()
    g = real_rows(rng, REAL_1D, dev)
    out = q1.apply_split(hr, hi)
    torch.cuda.synchronize()
    reset_counts()
    out.backward(g)
    torch.cuda.synchronize()
    c_backc = read_counts()
    check(c_backc == only(r2c=1), f"c2r's backward launched {c_backc}")
    X64 = torch.complex(yr, yi).to(c128).requires_grad_()
    (torch.fft.irfft(X64, n1) * n1).backward(g.double())
    e_gc = relerr(torch.complex(hr.grad, hi.grad).to(c128), X64.grad)
    print(f"[17] gradients vs torch.fft autograd in complex128: r2c "
          f"{e_gr:.2e} (one K1 launch), c2r {e_gc:.2e} (one K4 launch)")
    check(e_gr <= TOL and e_gc <= TOL, "1-D real gradients over tolerance")
    del x, yr, yi, gr, gi, hr, hi, g, out, X64, p1, q1
    torch.cuda.empty_cache()

    # -- 18. the full-width 2-D path: plan_dft_r2c((8, 2048, 2048), (1, 2)) -
    arms = real_2d_plans()
    for label, plan in arms.items():
        print(f"[18] {label}: {plan!r}")
    n2 = REAL_2D[-1]
    d_r2c = {"alg": "pallas_r2c", "n": n2,
             "radices": S.choose_radices(n2 // 2)}
    d_c2c = {"alg": "pallas", "n": n2, "radices": S.choose_radices(n2)}
    check(arms["r2c"].descriptors == {1: d_c2c, 2: d_r2c}, "2-D r2c plan")
    check(arms["r2c swapped"].descriptors == {
        1: dict(d_r2c, alg="pallas_r2c_inner"), 2: d_c2c}, "swapped plan")
    check(arms["c2r"].descriptors == {1: d_c2c,
                                      2: dict(d_r2c, alg="pallas_c2r")},
          "2-D c2r plan")
    x = real_rows(rng, REAL_2D, dev)
    ref = torch.fft.rfftn(x.double(), dim=(1, 2))
    want18 = {"r2c": only(r2c=1, inner_c2c=1),
              "r2c swapped": only(r2c_inner=1, stockham_c2c=1)}
    counts18 = {}
    for label, want_c in want18.items():
        torch.cuda.synchronize()
        reset_counts()
        yr, yi = arms[label].apply_split(x)
        torch.cuda.synchronize()
        counts18[label] = c = read_counts()
        e = relerr(torch.complex(yr, yi).to(c128), ref)
        print(f"[18] {label}: launches {({k: v for k, v in c.items() if v})}"
              f", rel err vs torch.fft.rfftn complex128 {e:.3e}")
        check(c == want_c, f"{label} launched {c}")
        check(e <= TOL, f"{label} over tolerance at {REAL_2D}")
        if label == "r2c":
            y2 = (yr, yi)
        del yr, yi
    del ref
    npts = REAL_2D[1] * REAL_2D[2]
    torch.cuda.synchronize()
    reset_counts()
    z = arms["c2r"].apply_split(*y2)
    torch.cuda.synchronize()
    counts18["c2r"] = c = read_counts()
    check(c == only(inner_c2c=1, c2r=1), f"2-D c2r launched {c}")
    e_c = relerr(z.double(), torch.fft.irfftn(
        torch.complex(*y2).to(c128), s=REAL_2D[1:], dim=(1, 2)) * npts)
    e_rt = relerr(z.double(), npts * x.double())
    print(f"[18] c2r: launches {({k: v for k, v in c.items() if v})}, "
          f"rel err vs irfftn * N complex128 {e_c:.3e}, c2r(r2c(x)) vs N x "
          f"{e_rt:.3e}")
    check(e_c <= TOL and e_rt <= TOL, "2-D c2r over tolerance")
    # execute's forms, complex64 at the edge K2 crosses: bit for bit the
    # conversion path above, one K2 launch writing complex64 in the r2c
    # and none in the c2r, which reads it
    yc, c_x = run_counted(arms["r2c"].execute, x)
    check(c_x == only(r2c=1, inner_c2c=1, inner_c2c_cout=1),
          f"2-D r2c execute launched {c_x}")
    check(torch.equal(yc, torch.complex(*y2)),
          "2-D r2c execute differs from its apply_split")
    zx, c_z = run_counted(arms["c2r"].execute, yc)
    check(c_z == only(inner_c2c=1, c2r=1), f"2-D c2r execute launched {c_z}")
    check(torch.equal(zx, z), "2-D c2r execute differs from its apply_split")
    print(f"[18] execute: r2c launches {launched(c_x)}, K2 writing "
          f"complex64 in {c_x['inner_c2c_cout']} of {c_x['inner_c2c']}; "
          f"c2r launches {launched(c_z)}; both bit for bit apply_split")
    del z, zx, yc

    # gradients through K2, K4's and K6's backward, against torch.fft's
    xg = x.clone().requires_grad_()
    w = torch.complex(*planes(rng, y2[0].shape, dev))
    (torch.complex(*arms["r2c"].apply_split(xg)) * w).real.sum().backward()
    x64 = x.double().requires_grad_()
    (torch.fft.rfftn(x64, dim=(1, 2)) * w.to(c128)).real.sum().backward()
    e_gr = relerr(xg.grad.double(), x64.grad)
    del xg, x64
    hr, hi = (t.clone().requires_grad_() for t in y2)
    g = real_rows(rng, REAL_2D, dev)
    (arms["c2r"].apply_split(hr, hi) * g).sum().backward()
    X64 = torch.complex(*y2).to(c128).requires_grad_()
    (torch.fft.irfftn(X64, s=REAL_2D[1:], dim=(1, 2)) * npts
     * g.double()).sum().backward()
    e_gc = relerr(torch.complex(hr.grad, hi.grad).to(c128), X64.grad)
    print(f"[18] gradients vs torch.fft autograd in complex128: r2c "
          f"{e_gr:.2e}, c2r {e_gc:.2e}")
    check(e_gr <= TOL and e_gc <= TOL, "2-D real gradients over tolerance")
    del w, hr, hi, g, X64
    torch.cuda.empty_cache()

    # K2 and K1 against their twins on this path's own planes: K2 on the
    # (8, 2048, 1025) half spectrum (the r2c's sign -1 pass on K4's output,
    # the c2r's sign +1 pass on its input: 256 full tiles and a 1-column
    # edge tile per plane), K1 on the swapped route's (8 * 1025, 2048) rows
    # (K5's output).  Launches made here are not counted.
    n_a = REAL_2D[1]
    rad_a, rad_h = S.choose_radices(n_a), S.choose_radices(n_a // 2)
    t_h = RS.device_table(n_a, tuple(rad_h), -1, dev)
    kr, ki = RS.r2c_cuda(x.reshape(-1, n2), rad_h, t_h)
    half = (kr.view(*REAL_2D[:2], -1), ki.view(*REAL_2D[:2], -1))
    for sign, (pr, pi) in ((-1, half), (+1, y2)):
        t_a = S.device_table(n_a, tuple(rad_a), sign, dev)
        kr, ki = inner.inner_c2c_cuda(pr, pi, rad_a, t_a)
        tr, ti = inner.inner_c2c_torch(pr, pi, rad_a, sign)
        err, rel = twin_err(f"inner_c2c {tuple(pr.shape)} sign {sign:+d}",
                            kr, ki, tr, ti)
        del tr, ti
        eo = relerr(torch.complex(kr, ki).to(c128),
                    oracle(torch.complex(pr, pi), (-2,), sign))
        check(eo <= TOL, f"K2 on {tuple(pr.shape)} sign {sign:+d} vs "
              f"complex128 {eo:.2e}")
        print(f"[18] K2 on {tuple(pr.shape)} sign {sign:+d} (tile "
              f"{inner.tile_width(n_a, pr.shape[-1])} columns): kernel-twin "
              f"max abs {err:.3e}, over max |twin| {rel:.2e}; kernel-f64 "
              f"{eo:.2e}")
        del kr, ki
    del half
    kr, ki = RS.r2c_inner_cuda(x, rad_h, t_h)
    rows = (kr.reshape(-1, n2), ki.reshape(-1, n2))
    del kr, ki
    kr, ki = S.stockham_c2c_cuda(*rows, rad_a, S.device_table(
        n2, tuple(rad_a), -1, dev))
    tr, ti = S.stockham_c2c_torch(*rows, rad_a, -1)
    err, rel = twin_err(f"stockham_c2c {tuple(rows[0].shape)}", kr, ki, tr,
                        ti)
    print(f"[18] K1 on {tuple(rows[0].shape)} sign -1: kernel-twin max abs "
          f"{err:.3e}, over max |twin| {rel:.2e}")
    del rows, kr, ki, tr, ti
    torch.cuda.empty_cache()

    # the three arms, interleaved: each timed twice, in the order r2c,
    # swapped, c2r, then back
    args18 = {label: (y2 if label == "c2r" else (x,)) for label in arms}
    times18 = {label: [] for label in arms}
    for label in list(arms) + list(arms)[::-1]:
        times18[label].append(time_ms(arms[label].apply_split,
                                      args18[label]))
    yc2 = torch.complex(*y2)
    t_rfftn = time_ms(lambda a: torch.fft.rfftn(a, dim=(1, 2)), (x,))
    t_irfftn = time_ms(lambda a: torch.fft.irfftn(a, s=REAL_2D[1:],
                                                  dim=(1, 2)), (yc2,))
    b18, by18 = bound(4.0 * x.numel() + 8.0 * y2[0].numel(),
                      fft_flops(x.numel(), *REAL_2D[1:]) / 2)
    for label, ts in times18.items():
        print(f"[18] {label} {REAL_2D}: {ts[0]:.3f} / {ts[1]:.3f} ms "
              f"({smi_line})")
    print(f"[18] torch.fft.rfftn {t_rfftn:.3f} ms, irfftn {t_irfftn:.3f} "
          f"ms; bound {b18:.3f} ms ({by18}: real in, half spectrum out, "
          f"once) ({smi_line})")
    del x, y2, yc2, arms
    torch.cuda.empty_cache()

    # -- 19. the real paths profiled in a fresh process; kernel times -------
    sys.stdout.flush()
    res = subprocess.run([sys.executable, __file__, "--profile-paths",
                          "real", "--seed", str(args.seed)], timeout=600)
    check(res.returncode == 0, "the profile of the real paths failed")
    rows19 = []

    def zeros(t):
        return torch.zeros_like(t)
    # K4 and K6 at the 1-D path's shape (the JSON rows) and at the 2-D
    # path's rows (printed for PERF.md)
    for shape, launches in ((REAL_1D, (c17_r2c["r2c"], c17_c2r["c2r"])),
                            ((REAL_2D[0] * REAL_2D[1], REAL_2D[2]),
                             (counts18["r2c"]["r2c"],
                              counts18["c2r"]["c2r"]))):
        B, n = shape
        rad = S.choose_radices(n // 2)
        tf = RS.device_table(n, tuple(rad), -1, dev)
        ti_ = RS.device_table(n, tuple(rad), +1, dev)
        x = real_rows(rng, shape, dev)
        kr, ki = RS.r2c_cuda(x, rad, tf)
        tr, ti = RS.r2c_torch(x, rad)
        err, rel = twin_err(f"r2c {shape}", kr, ki, tr, ti)
        del tr, ti
        eo = relerr(torch.complex(kr, ki).to(c128), torch.fft.rfft(x.double()))
        check(eo <= TOL, f"K4 {shape} vs complex128 {eo:.2e}")
        print(f"[19] K4 {shape} ({S.form_label(rad)}, "
              f"{S.rows_per_block(n // 2)} rows a group): kernel-f64 {eo:.2e}")
        rows19.append({
            "name": "r2c", "route": "cuda",
            "source": "fftw3_tpu_torch/csrc/r2c.cu",
            "replaces": "fftw3_tpu/ops/pallas_stockham.py:1245",
            "launches": launches[0], "max_abs_err": err, "rel_err": rel,
            "ms": time_ms(lambda a: RS.r2c_cuda(a, rad, tf), (x,)),
            "plain_ms": time_ms(lambda a: RS.r2c_torch(a, rad), (x,)),
            "library_ms": time_ms(lambda a: torch.fft.rfft(a), (x,)),
            "stage_form": S.form_label(rad),
            "shape": shape, "bytes": 4.0 * B * n + 8.0 * kr.numel(),
            "flops": fft_flops(B * n, n) / 2})
        y = RS.c2r_cuda(kr, ki, rad, ti_)
        ty = RS.c2r_torch(kr, ki, rad)
        err, rel = twin_err(f"c2r {shape}", y, zeros(y), ty, zeros(ty))
        ty = RS.c2r_torch(kr, ki, rad, "all")
        eb = twin_err(f"c2r {shape} vs the butterfly twin", y, zeros(y), ty,
                      zeros(ty))[1]
        eo = relerr(y.double(), torch.fft.irfft(
            torch.complex(kr, ki).to(c128), n) * n)
        check(eo <= TOL, f"K6 {shape} vs complex128 {eo:.2e}")
        del y, ty
        kc = torch.complex(kr, ki)
        # the one PyTorch call of K6's function: irfft unscaled; the
        # earlier yardstick, irfft then a scaling pass, printed beside it
        t_scaled = time_ms(lambda z: torch.fft.irfft(z, n) * n, (kc,))
        rows19.append({
            "name": "c2r", "route": "cuda",
            "source": "fftw3_tpu_torch/csrc/c2r.cu",
            "replaces": "fftw3_tpu/ops/pallas_stockham.py:1578",
            "launches": launches[1], "max_abs_err": err, "rel_err": rel,
            "ms": time_ms(lambda a, b: RS.c2r_cuda(a, b, rad, ti_),
                          (kr, ki)),
            "plain_ms": time_ms(lambda a, b: RS.c2r_torch(a, b, rad),
                                (kr, ki)),
            "library_ms": time_ms(
                lambda z: torch.fft.irfft(z, n, norm="forward"), (kc,)),
            "stage_form": S.form_label(rad),
            "shape": (B, n // 2 + 1), "bytes": 8.0 * kr.numel() + 4.0 * B * n,
            "flops": fft_flops(B * n, n) / 2})
        print(f"[19] K6 {shape} ({S.form_label(rad)}, "
              f"{S.rows_per_block(n // 2)} rows a group): kernel-butterfly "
              f"twin {eb:.2e}, kernel-f64 {eo:.2e}; irfft(norm=\"forward\") "
              f"{rows19[-1]['library_ms']:.3f} ms, irfft * n "
              f"{t_scaled:.3f} ms ({smi_line})")
        del x, kr, ki, kc
        torch.cuda.empty_cache()
    # K5 at the swapped path's shape
    n = REAL_2D[1]
    rad = S.choose_radices(n // 2)
    tf = RS.device_table(n, tuple(rad), -1, dev)
    x = real_rows(rng, REAL_2D, dev)
    kr, ki = RS.r2c_inner_cuda(x, rad, tf)
    tr, ti = RS.r2c_inner_torch(x, rad, "all")
    err, rel = twin_err(f"r2c_inner {REAL_2D}", kr, ki, tr, ti)
    e64 = relerr(torch.complex(kr, ki).to(c128),
                 torch.fft.rfft(x.double(), dim=-2))
    print(f"[19] K5 {REAL_2D} (tiles of "
          f"{RS.r2c_inner_tile(n // 2, REAL_2D[2], rad)} columns): vs "
          f"float64 over every bin {e64:.2e}")
    check(e64 <= TOL, f"K5 at {REAL_2D} vs float64: {e64:.2e}")
    rows19.append({
        "name": "r2c_inner", "route": "cuda",
        "source": "fftw3_tpu_torch/csrc/r2c_inner.cu",
        "replaces": "fftw3_tpu/ops/pallas_stockham.py:1343",
        "launches": counts18["r2c swapped"]["r2c_inner"],
        "max_abs_err": err, "rel_err": rel,
        "ms": time_ms(lambda a: RS.r2c_inner_cuda(a, rad, tf), (x,)),
        "plain_ms": time_ms(lambda a: RS.r2c_inner_torch(a, rad, "all"),
                            (x,)),
        "library_ms": time_ms(lambda a: torch.fft.rfft(a, dim=-2), (x,)),
        "shape": REAL_2D, "bytes": 4.0 * x.numel() + 8.0 * kr.numel(),
        "flops": fft_flops(x.numel(), n) / 2})
    del x, kr, ki, tr, ti
    torch.cuda.empty_cache()
    for r in rows19:
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"))
        print(f"[19] {r['name']} {r['shape']}: kernel {r['ms']:.3f} ms, "
              f"twin {r['plain_ms']:.3f} ms, library "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}); launches per call on its path "
              f"{r['launches']}; kernel-twin max abs err "
              f"{r['max_abs_err']:.3e}, over max |twin| {r['rel_err']:.2e} "
              f"({smi_line})")

    k7_row = f64_phases(rng, dev, smi_line, args.seed, t_start)
    e5_rows = ablation_phase(rng, dev, smi_line, kernels[0])
    e8_rows = copy_floor_phase(rng, dev, smi_line)
    print(f"[26] phases 1-26 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    r2r_res = r2r_phases(rng, dev, smi_line, args.seed)
    k8_row = k8_phase(rng, dev, smi_line)
    measure_rows = measure_phases(rng, dev, smi_line, t_start)
    measure_rows += tensor_core_phases(rng, dev, smi_line, t_start)
    measure_rows += k7_ablation_phase(dev, smi_line, k7_row, args.seed)
    print(f"[41] done at {time.perf_counter() - t_start:.1f} s", flush=True)
    surface_phases(rng, dev, smi_line, args.seed, t_start)

    # the JSON line keeps one row per kernel: K3 at its 3-D path shape, K4
    # and K6 at the 1-D real path's shape
    for r in rows14 + rows19:
        if r["name"] == "c2c_2d" and r["shape"] != (CUBE,) * 3:
            continue
        if r["name"] in ("r2c", "c2r") and r["shape"][0] != REAL_1D[0]:
            continue
        kernels.append({k: v for k, v in r.items() if k != "shape"})
    kernels += [wide_row, k7_row, p1_row, k8_row]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
    kernels += e5_rows + e8_rows + measure_rows

    print(f"[41] whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"r2r": r2r_res}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
