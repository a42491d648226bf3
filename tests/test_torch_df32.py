"""fftw3_tpu_torch's double-precision tier against the reference's.

The same numpy inputs go through ``fftw3_tpu.ops.df32`` (the XLA-path
``df32`` solver as plain XLA, the fused ``df32p`` kernel in Pallas interpret
mode, as ``tests/test_df32.py`` runs them) and through the port's
``ops/df32.py`` (the ``df32`` solver and the plain PyTorch twin of the
``df32p`` kernel K7) on the CPU.  Errors are max-abs error over max-abs:
1e-13 between the packages for ``df32`` (the same error-free chains), 1e-12
for the K7 twin against the reference kernel and for each against numpy in
float64.  The CUDA kernel runs only on a card: those tests are marked
``cuda``.
"""
import dataclasses
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftw3_tpu as ref_ft
from fftw3_tpu import config as ref_config
from fftw3_tpu import planner as ref_planner
from fftw3_tpu.ops import c2c as ref_c2c
from fftw3_tpu.ops import df32 as ref_df32

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import config, kinds
from fftw3_tpu_torch import planner
from fftw3_tpu_torch.ops import c2c
from fftw3_tpu_torch.ops import df32

REPO = str(Path(__file__).resolve().parent.parent)
TOL_PKG = 1e-13
TOL_F64 = 1e-12

#: sizes of the complex128 descriptor parity: smooth, prime (bluestein over
#: a df32 child), and above the fused kernel's window
F64_NS = [2, 12, 64, 360, 1000, 1009, 1024, 2048, 4096]
#: the reference kernel's schedules the twin is held against
KERNEL_CASES = [(256, [16, 16]), (1000, [50, 20]), (1024, [64, 16])]


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    """Both packages' global settings restored after each test, kernels on
    in both (the reference's in interpret mode), and both global planners
    without wisdom."""
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    monkeypatch.setattr(ref_config, "strict_f64", False)
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(config, "strict_f64", False)
    monkeypatch.setattr(ref_planner.the_planner, "wisdom", {})
    monkeypatch.setattr(ft.the_planner, "wisdom", {})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


def _port_planner():
    return planner.Planner(planner.HardwareModel(
        **dataclasses.asdict(ref_planner.HW)))


def _relerr(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _c128(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _oracle(x, sign):
    n = x.shape[-1]
    return np.fft.fft(x, axis=-1) if sign < 0 \
        else np.fft.ifft(x, axis=-1) * n


def _port_split(fn, x):
    yr, yi = fn(torch.from_numpy(np.ascontiguousarray(x.real)),
                torch.from_numpy(np.ascontiguousarray(x.imag)))
    assert yr.dtype == yi.dtype == torch.float64
    return yr.numpy() + 1j * yi.numpy()


def _ref_split(fn, x, jit=False):
    """The reference's split apply on x, op by op or compiled.  Op by op
    its ops run one by one: no trace and compile of the whole unrolled df
    graph, which costs far more than running it, and each primitive is
    compiled once per shape in the process, so cases on the same shapes
    share that cost."""
    if jit:
        yr, yi = jax.jit(fn)(jnp.asarray(x.real), jnp.asarray(x.imag))
    else:
        with jax.disable_jit():
            yr, yi = fn(jnp.asarray(x.real), jnp.asarray(x.imag))
    return np.asarray(yr) + 1j * np.asarray(yi)


#: the rows of every df32 solver case: cases of one n share their shapes
ROWS = 3


@functools.lru_cache(maxsize=None)
def _ref_df32(n, sign):
    """The reference's df32 solver on ``_c128(n, (ROWS, n))``, op by op,
    once per (n, sign) in the module: the solver, gradient and plan cases
    share it."""
    desc = {"alg": "df32", "n": n, "radices": ref_df32.df32_radices(n)}
    return _ref_split(ref_df32.build_df32_c2c_split(desc, sign, np.float64),
                      _c128(n, (ROWS, n)))


# ---------------------------------------------------------------------------
# the error-free arithmetic
# ---------------------------------------------------------------------------

def _operands(dtype, k):
    """k arrays of df-typical magnitudes: hi planes near 1, lo planes near
    ulp(hi), and one spread over many binades."""
    rng = np.random.default_rng(7 + k)
    eps = np.finfo(dtype).eps
    out = []
    for i in range(k):
        scale = eps if i % 2 else 1.0
        v = rng.standard_normal(513) * scale
        v[:64] *= np.exp2(rng.integers(-20, 20, 64))
        out.append(v.astype(dtype))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,nargs,split", [
    ("_two_sum", 2, False), ("_fast_two_sum", 2, False),
    ("_two_prod", 2, False), ("df_add", 4, False), ("df_sub", 4, False),
    ("df_mul", 4, False), ("df_cadd", 8, True), ("df_csub", 8, True),
    ("df_cmul", 8, True)])
def test_error_free_ops_equal_reference_bit_for_bit(dtype, name, nargs,
                                                    split):
    """Op by op on the same arrays, both packages give the same bits (the
    reference's ops run one by one, so nothing fuses or reassociates)."""
    args = _operands(dtype, nargs)
    if name == "_fast_two_sum":         # its precondition |s| >= |e|
        args[1] = args[1] * np.finfo(dtype).eps
    if split:
        ref_args = (tuple(jnp.asarray(a) for a in args[:4]),
                    tuple(jnp.asarray(a) for a in args[4:]))
        mine_args = (tuple(torch.from_numpy(a) for a in args[:4]),
                     tuple(torch.from_numpy(a) for a in args[4:]))
    else:
        ref_args = tuple(jnp.asarray(a) for a in args)
        mine_args = tuple(torch.from_numpy(a) for a in args)
    want = getattr(ref_df32, name)(*ref_args)
    got = getattr(df32, name)(*mine_args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_two_prod_is_exact():
    """p + e is the exact product: checked in float64 for f32 operands and
    with mpmath-free exact rationals for f64 ones."""
    from fractions import Fraction
    a32, b32 = _operands(np.float32, 2)
    p, e = df32._two_prod(torch.from_numpy(a32), torch.from_numpy(b32))
    assert np.array_equal(p.double().numpy() + e.double().numpy(),
                          a32.astype(np.float64) * b32.astype(np.float64))
    a, b = _operands(np.float64, 2)
    p, e = df32._two_prod(torch.from_numpy(a), torch.from_numpy(b))
    for i in range(0, 513, 37):
        assert Fraction(float(p[i])) + Fraction(float(e[i])) \
            == Fraction(float(a[i])) * Fraction(float(b[i]))


# ---------------------------------------------------------------------------
# the df32 solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8, 12, 60, 360, 1000, 1024, 2048])
@pytest.mark.parametrize("sign", [-1, +1])
def test_df32_solver_matches_reference(n, sign):
    desc = {"alg": "df32", "n": n, "radices": df32.df32_radices(n)}
    assert desc["radices"] == ref_df32.df32_radices(n)
    x = _c128(n, (ROWS, n))
    want = _ref_df32(n, sign)
    got = _port_split(c2c.build_c2c_split(desc, sign, np.float64, "cpu"), x)
    assert _relerr(got, want) <= TOL_PKG, n
    assert _relerr(got, _oracle(x, sign)) <= TOL_F64, n


def test_df32_gates_equal_reference():
    for n in list(range(1, 130)) + [720, 1009, 2048, 4096]:
        assert df32.df32_radices(n) == ref_df32.df32_radices(n), n
        assert df32.df32_applicable(n) == ref_df32.df32_applicable(n), n
        assert df32.df32p_radices(n) == ref_df32.df32p_radices(n), n
        assert df32.df32p_applicable(n, "cpu") == \
            ref_df32.df32p_applicable(n), n


def test_df32p_gate_follows_kernel_mode():
    assert df32.df32p_applicable(1024, "cpu")
    assert not df32.df32p_applicable(2048, "cpu")     # above the window
    assert not df32.df32p_applicable(1009, "cpu")     # prime
    config.kernel_mode = "auto"
    assert not df32.df32p_applicable(1024, "cpu")
    assert df32.df32p_applicable(1024, "cuda")
    config.kernel_mode = "off"
    assert not df32.df32p_applicable(1024, "cuda")


# ---------------------------------------------------------------------------
# the K7 twin against the reference kernel
# ---------------------------------------------------------------------------

def test_stage_constants_equal_reference():
    """The twin's and the kernel's constants are the reference kernel's
    operands, bit for bit; the kernel's table is them with each group of
    four arrays (rh, rl, ih, il) interleaved into float4 entries."""
    for n, rad in KERNEL_CASES + [(240, [16, 15]), (12, [3, 4])]:
        for sign in (-1, 1):
            want = ref_df32._df_stage_consts(n, rad, sign)
            got = df32._df_stage_consts(n, rad, sign)
            assert [len(s) for s in got] == [len(s) for s in want]
            for gs, ws in zip(got, want):
                for g, w in zip(gs, ws):
                    assert g.dtype == w.dtype and np.array_equal(g, w)
            assert np.array_equal(df32._kernel_table(n, rad, sign),
                                  np.concatenate(
                                      [np.stack([c.ravel() for c in
                                                 s[i:i + 4]], -1).ravel()
                                       for s in want
                                       for i in range(0, len(s), 4)]))


def _ref_kernel_body(n, radices, sign, x):
    """The reference kernel's own stage loop (``_df_stages``, the body of
    ``_kernel_df32``) on x's rows, op by op outside ``pallas_call``, with
    the builder's hi/lo split and recombination around it."""
    consts = [jnp.asarray(c) for stage in
              ref_df32._df_stage_consts(n, radices, sign) for c in stage]
    planes = []
    for v in (x.real, x.imag):
        hi = v.astype(np.float32)
        planes += [hi, (v - hi.astype(np.float64)).astype(np.float32)]
    with jax.disable_jit():
        y = ref_df32._df_stages(radices, n, x.shape[0], consts,
                                tuple(jnp.asarray(v.T) for v in planes),
                                sign)
    yrh, yrl, yih, yil = (np.asarray(v).T.astype(np.float64) for v in y)
    return (yrh + yrl) + 1j * (yih + yil)


@pytest.mark.parametrize("n,radices,interpret", [
    (256, [16, 16], True), (1000, [50, 20], False), (1024, [64, 16], False)])
def test_twin_matches_reference_kernel(n, radices, interpret):
    """The twin against the reference kernel on ragged batches of 130 and
    37 rows (the reference pads to its 128-row tile, the port pads
    nothing), and both against numpy.  At n = 256 the kernel runs as
    ``build_df32_pallas_split`` in interpret mode; at n = 1000 and 1024,
    whose interpret-mode trace and compile alone take 20 s to over a minute
    on a CPU, its stage loop runs op by op instead, with the builder's
    split and recombination around it."""
    desc = {"alg": "df32p", "n": n, "radices": radices}
    x = _c128(n, (130, n))
    if interpret:
        want = _ref_split(ref_df32.build_df32_pallas_split(desc, -1,
                                                           np.float64), x,
                          jit=True)
    else:
        want = _ref_kernel_body(n, radices, -1, x)
    fn = c2c.build_c2c_split(desc, -1, np.float64, "cpu")
    for batch in (130, 37):
        got = _port_split(fn, x[:batch])
        assert _relerr(got, want[:batch]) <= TOL_F64, batch
        assert _relerr(got, _oracle(x[:batch], -1)) <= TOL_F64, batch
        yr, yi = df32.df32_c2c_torch(torch.from_numpy(x[:batch].real.copy()),
                                     torch.from_numpy(x[:batch].imag.copy()),
                                     radices, -1)
        assert np.array_equal(yr.numpy() + 1j * yi.numpy(), got)


@pytest.mark.parametrize("n,radices", [(240, [16, 15]), (360, [8, 45]),
                                       (60, [60]), (1024, [4, 4, 64])])
@pytest.mark.parametrize("sign", [-1, +1])
def test_twin_other_schedules(n, radices, sign):
    """Radix-3 and radix-5 recursion levels, one stage, three stages."""
    x = _c128(n, (5, n))
    yr, yi = df32.df32_c2c_torch(torch.from_numpy(x.real.copy()),
                                 torch.from_numpy(x.imag.copy()), radices,
                                 sign)
    assert _relerr(yr.numpy() + 1j * yi.numpy(), _oracle(x, sign)) \
        <= TOL_F64


@pytest.mark.parametrize("n,radices", [(1024, [64, 16]), (1000, [50, 20]),
                                       (360, [8, 45]), (128, [16, 8]),
                                       (1024, [4, 4, 64])])
def test_kernel_instructions_count_the_twins_df_ops(n, radices, monkeypatch):
    """K7's FP32 instruction count (its bound in ``chip_smoke.py``) is the
    twin's df adds and multiplies on one row at 11 and 9 instructions each;
    at [64, 16] that is 408.5 per point, under the reference's 542."""
    counts = {"add": 0, "mul": 0}

    def counting(kind, fn):
        def op(*args):
            out = fn(*args)
            counts[kind] += out[0].numel()
            return out
        return op
    monkeypatch.setattr(df32, "df_add", counting("add", df32.df_add))
    monkeypatch.setattr(df32, "df_mul", counting("mul", df32.df_mul))
    x = _c128(n, (1, n))
    df32.df32_c2c_torch(torch.from_numpy(x.real.copy()),
                        torch.from_numpy(x.imag.copy()), radices, -1)
    assert df32.kernel_instructions(n, radices) == \
        df32.DF_ADD_INSTR * counts["add"] + df32.DF_MUL_INSTR * counts["mul"]
    if radices == [64, 16]:
        assert df32.kernel_instructions(n, radices) == 408.5 * n
        assert sum(c2c.c2c_opcount({"alg": "df32p", "n": n,
                                    "radices": radices}).values()) == 542 * n


# ---------------------------------------------------------------------------
# K7's host-side plan, executed on the CPU index for index
# ---------------------------------------------------------------------------

def _imul(a, sign):
    """a * (i*sign), as the kernel's imul."""
    if sign < 0:
        return (a[2], a[3], -a[0], -a[1])
    return (-a[2], -a[3], a[0], a[1])


def _bfly(x, r, sign, coeff):
    """The kernel's r-point df butterfly on df complexes x[0..r) (the
    reference's ``_df_vpu_dft`` body); ``coeff(k)`` is w^(k+1) for radix
    3 and 5."""
    if r == 2:
        return [df32.df_cadd(x[0], x[1]), df32.df_csub(x[0], x[1])]
    if r == 4:
        t0, t1 = df32.df_cadd(x[0], x[2]), df32.df_csub(x[0], x[2])
        t2 = df32.df_cadd(x[1], x[3])
        u3 = _imul(df32.df_csub(x[1], x[3]), sign)
        return [df32.df_cadd(t0, t2), df32.df_cadd(t1, u3),
                df32.df_csub(t0, t2), df32.df_csub(t1, u3)]
    if r == 3:
        w1, w2 = coeff(0), coeff(1)
        return [df32.df_cadd(x[0], df32.df_cadd(x[1], x[2])),
                df32.df_cadd(x[0], df32.df_cadd(df32.df_cmul(x[1], w1),
                                                df32.df_cmul(x[2], w2))),
                df32.df_cadd(x[0], df32.df_cadd(df32.df_cmul(x[1], w2),
                                                df32.df_cmul(x[2], w1)))]
    out = []
    for k1 in range(5):
        acc = x[0]
        for j1 in range(1, 5):
            acc = df32.df_cadd(acc, x[j1] if k1 == 0 else df32.df_cmul(
                x[j1], coeff((j1 * k1) % 5 - 1)))
        out.append(acc)
    return out


def _emulate_k7(xr, xi, radices, sign):
    """K7 on (B, n) float64 planes as the CUDA kernel runs it, executed in
    torch float32 df ops: the plan's passes (``df32.k7_plan``) over tiles
    of ``rows_per_block`` rows (the last one ragged), each task's points
    gathered from and scattered to a one-buffer tile through the plan's
    swizzle, its sources and stores, the digit-reversal tables, the float4
    constant table and the thread that runs it.  Asserts what the kernel
    relies on: every pass covers each point of the tile once, an in-place
    pass reads exactly what it writes, and a pass with a barrier between
    its reads and writes runs all its tasks in one round."""
    B, n = xr.shape
    rad = tuple(radices)
    passes, itab = df32.k7_plan(n, rad)
    itab = np.asarray(itab)
    s1, s2 = df32.k7_swizzle(n, rad)
    rpb = df32.rows_per_block(n, rad)
    nslot = df32.k7_smem(n, rpb) // 16
    tab = torch.from_numpy(df32._kernel_table(n, rad, sign)).reshape(-1, 4)

    def const(e):
        e = torch.as_tensor(e)
        return tuple(tab[e, k] for k in range(4))

    def slot(e):
        return torch.from_numpy(df32._swizzle(np.asarray(e), s1, s2))

    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    for t0 in range(0, B, rpb):
        nrows = min(rpb, B - t0)
        buf = torch.full((nslot, 4), float("nan"), dtype=torch.float32)
        for ps in passes:
            P = dict(zip(df32.PASS_FIELDS, ps))
            r1, r2, m, inner = P["r1"], P["r2"], P["m"], P["inner"]
            U = df32._pass_tasks(r1, r2)
            tpr = n // (r1 * r2)
            w = np.arange(nrows * tpr)
            thread = w % df32.K7_THREADS
            rounds = w // (df32.K7_THREADS * U)
            if P["mid"]:
                assert rounds.max() == 0
            assert np.bincount(thread).max() <= (rounds.max() + 1) * U
            row, u = w // tpr, w % tpr
            c, v = u % P["S"], u // P["S"]
            j, sb = v % inner, v // inner
            ab = [(a, b) for b in range(r1) for a in range(r2)]
            nat = {(a, b): row * n + (sb * m + j + inner * a
                                      + (m // r1) * b) * P["S"] + c
                   for a, b in ab}
            if P["dst"] == 0 or P["src"] == 1:
                allpts = np.sort(np.concatenate(list(nat.values())))
                assert np.array_equal(allpts, np.arange(nrows * n))
            x = {}
            if P["src"] == 0:
                for a, b in ab:
                    e = t0 * n + nat[a, b]
                    x[a, b] = (*df32._split(xr.reshape(-1)[e]),
                               *df32._split(xi.reshape(-1)[e]))
            else:
                if P["src"] == 1:
                    src = nat
                else:
                    j2s, ds = c // P["done"], c % P["done"]
                    k1, d = ds // P["donep"], ds % P["donep"]
                    base = itab[P["dp"] + k1] * P["sp"] + j2s * P["donep"] + d
                    src = {(a, b): row * n + base + (sb * m + j + inner * a
                                                     + (m // r1) * b)
                           * P["ustride"] for a, b in ab}
                    assert np.array_equal(
                        np.sort(np.concatenate(list(src.values()))),
                        np.arange(nrows * n))
                for a, b in ab:
                    v4 = buf[slot(src[a, b])]
                    x[a, b] = tuple(v4[:, k] for k in range(4))

            def coeffs(off):
                return lambda k: const(np.full(len(w), off + k))
            for a in range(r2):                        # first level
                y = _bfly([x[a, b] for b in range(r1)], r1, sign,
                          coeffs(P["cf1"]))
                for b in range(r1):
                    if b and P["lt1"] >= 0:
                        y[b] = df32.df_cmul(y[b], const(
                            P["lt1"] + (b - 1) * (m // r1) + j + inner * a))
                    x[a, b] = y[b]
            if r2 > 1:                                 # second level
                for b in range(r1):
                    y = _bfly([x[a, b] for a in range(r2)], r2, sign,
                              coeffs(P["cf2"]))
                    for a in range(r2):
                        if a and P["lt2"] >= 0:
                            y[a] = df32.df_cmul(y[a], const(
                                P["lt2"] + (a - 1) * inner + j))
                        x[a, b] = y[a]
            if P["stw"] >= 0 or P["dst"] == 1:
                assert inner == 1
                k0 = itab[P["rev"] + sb * m]
                k = {(a, b): k0 + b * (P["p"] // m)
                     + a * r1 * (P["p"] // m) for a, b in ab}
            if P["stw"] >= 0:
                j2s = c // P["done"]
                for a, b in ab:
                    x[a, b] = df32.df_cmul(
                        x[a, b], const(P["stw"] + k[a, b] * P["q"] + j2s))
            for a, b in ab:
                if P["dst"] == 1:
                    e = t0 * n + row * n + k[a, b] * P["done"] + c
                    yr.reshape(-1)[e] = df32._rebuild(x[a, b][0], x[a, b][1],
                                                      xr.dtype)
                    yi.reshape(-1)[e] = df32._rebuild(x[a, b][2], x[a, b][3],
                                                      xr.dtype)
                else:
                    buf[slot(nat[a, b])] = torch.stack(x[a, b], -1)
    return yr, yi


K7_PLAN_CASES = [(n, df32.df32p_radices(n)) for n in
                 (128, 240, 360, 512, 1000, 1024)] + \
    [(1024, [4, 4, 64]), (360, [8, 45]), (60, [60]), (240, [16, 15])]


@pytest.mark.parametrize("n,radices", K7_PLAN_CASES)
@pytest.mark.parametrize("sign", [-1, +1])
def test_k7_plan_executed_equals_twin_bit_for_bit(n, radices, sign):
    """K7's plan, executed on the CPU (:func:`_emulate_k7`) over two full
    tiles and a ragged one, gives the twin's bits: the same df operations
    on the same operands in the same order, only where values live and how
    indices are found differ.  The df32p schedules of n = 128-1024, both
    signs, and three- and one-stage schedules."""
    rpb = df32.rows_per_block(n, radices)
    B = 2 * rpb + 1
    x = _c128(n + sign, (B, n))
    xr, xi = (torch.from_numpy(np.ascontiguousarray(v))
              for v in (x.real, x.imag))
    er, ei = _emulate_k7(xr, xi, radices, sign)
    tr, ti = df32.df32_c2c_torch(xr, xi, radices, sign)
    assert torch.equal(er, tr) and torch.equal(ei, ti)


def test_k7_plan_geometry():
    """At [64, 16]: three passes (two levels, one level, two levels), the
    stage twiddle folded into stage 0's last pass, stage 1 reading stage
    0's digit-reversed layout and storing the output, four rows a tile in
    64 KB, two barriers a tile besides the one between tiles (so under one
    a row, against six a row before), and a swizzle under which every
    shared-memory access of a full tile takes four bank cycles (no
    conflict), where no swizzle would cost more."""
    passes, itab = df32.k7_plan(1024, (64, 16))
    P = [dict(zip(df32.PASS_FIELDS, ps)) for ps in passes]
    assert [(p["r1"], p["r2"], p["src"], p["dst"]) for p in P] == \
        [(4, 4, 0, 0), (4, 1, 1, 0), (4, 4, 2, 1)]
    assert [p["stw"] >= 0 for p in P] == [False, True, False]
    assert not any(p["mid"] for p in P)
    assert df32.rows_per_block(1024, (64, 16)) == 4
    assert df32.k7_smem(1024, 4) == 65536
    assert itab[:64] == tuple(df32._digit_pos(k, 64) for k in range(64))
    accs = np.array(df32._accesses(1024, (64, 16), 4))
    for s1, s2, ok in ((*df32.k7_swizzle(1024, (64, 16)), True),
                       (31, 31, False)):
        sl = df32._swizzle(accs, s1, s2).reshape(-1, 4, 8) % 8
        free = all(len(set(ph)) == 8 for ph in sl.reshape(-1, 8).tolist())
        assert free == ok, (s1, s2)


#: K7's shared-memory cap (``kMaxSmem`` in csrc/df32_c2c.cu)
K7_MAX_SMEM = 163840


@pytest.mark.parametrize("lo,hi", [(128, 512), (512, 1025)])
def test_every_df32p_schedule_fits_k7(lo, hi):
    """Every schedule df32p can hand K7 in its window has a plan the
    kernel takes: at most MAX_PASSES passes of kinds it instantiates, a
    family holding them, whole rows a tile within its shared memory, a
    pass with a barrier between its reads and writes holding all its tasks
    in one round, and a swizzle the kernel accepts."""
    for n in range(lo, hi):
        rad = df32.df32p_radices(n)
        if rad is None:
            continue
        passes, itab = df32.k7_plan(n, tuple(rad))
        assert 1 <= len(passes) <= df32.MAX_PASSES
        fam = df32.K7_FAMILIES[df32.k7_family(n, rad)]
        kinds = {ps[:2] for ps in passes}
        assert fam is None or kinds <= set(fam)
        rpb = df32.rows_per_block(n, rad)
        assert rpb * n <= df32.TILE_POINTS
        assert df32.k7_smem(n, rpb) <= K7_MAX_SMEM
        for ps in passes:
            P = dict(zip(df32.PASS_FIELDS, ps))
            U = df32._pass_tasks(P["r1"], P["r2"])
            assert P["r1"] * P["r2"] * U <= 16
            if P["mid"]:
                assert rpb * n // (P["r1"] * P["r2"]) <= df32.K7_THREADS * U
            assert 0 <= P["rev"] and P["rev"] + P["p"] <= len(itab)
        assert all(3 <= s <= 31 for s in df32.k7_swizzle(n, tuple(rad)))


def test_k7_ablation_tool_reads_sass():
    """The SASS reader of ``tools/k7_ablation.py``: instructions by class,
    loops from backward branches (the innermost owns its body), and a trip
    model's count per point."""
    from fftw3_tpu_torch.tools import k7_ablation
    sass = """
        code for sm_90a
                Function : _Zk_df32_kernelILi0ELi0EE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   FADD R2, R3, R4 ;
        /*0030*/                   IMAD R2, R3, R4, R5 ;
        /*0040*/              @!P0 BRA 0x20 ;
        /*0050*/                   LDS.128 R4, [R2] ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/               @P1 BRA `(.L_x_3) 0x10 ;
        /*0080*/                   EXIT ;
    """
    (name, mix), = k7_ablation.sass_mix(sass, "df32",
                                        [(0x10, 0x70, 2), (0x20, 0x40, 4)],
                                        per_tile=0.5).items()
    assert mix["instructions"] == 9
    assert [lp["span"] for lp in mix["loops"]] == [["0x10", "0x70"],
                                                    ["0x20", "0x40"]]
    assert mix["loops"][1]["body"] == {"fp32": 1, "integer": 1,
                                       "control": 1}
    assert mix["outside"] == {"constant": 1, "control": 1}
    assert mix["per_point"] == {"barrier": 1.0, "control": 3.0,
                                "fp32": 2.0, "integer": 2.0,
                                "lds_sts": 1.0, "move": 1.0}
    assert k7_ablation.static_mix(sass)[name]["fp32"] == 1


def test_twin_leading_dims_and_float32_planes():
    x = _c128(3, (2, 3, 128))
    f = df32.build_df32_pallas_split({"alg": "df32p", "n": 128}, -1,
                                     np.float64, "cpu")
    got = _port_split(f, x)
    assert got.shape == (2, 3, 128)
    assert _relerr(got, _oracle(x, -1)) <= TOL_F64
    f32 = df32.build_df32_pallas_split({"alg": "df32p", "n": 128}, -1,
                                       np.float32, "cpu")
    yr, yi = f32(torch.from_numpy(x.real.astype(np.float32)),
                 torch.from_numpy(x.imag.astype(np.float32)))
    assert yr.dtype == torch.float32
    with pytest.raises(ValueError, match="does not fit"):
        df32.build_df32_pallas_split({"alg": "df32p", "n": 126,
                                      "radices": [7, 18]}, -1, np.float64)
    with pytest.raises(ValueError, match="does not fit"):
        df32.build_df32_pallas_split({"alg": "df32p", "n": 1009}, -1,
                                     np.float64)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", ["df32", "df32p"])
def test_split_gradients_equal_reference(alg):
    """On the real planes the port's backward (the opposite-sign df
    transform) equals what the reference's custom VJP computes: the
    backward of ``build_df32_c2c_split`` and ``build_df32_pallas_split``
    is the same builder's transform of the opposite sign, no conjugation.
    That transform is the df32 case's cached output, and for df32p the
    reference kernel's stage loop of sign +1, op by op on the twin case's
    shapes.  (``test_complex_gradient_is_conj_of_jax`` differentiates the
    reference's df32 plan through JAX itself.)"""
    n = 1024
    rows = ROWS if alg == "df32" else 130
    desc = {"alg": alg, "n": n, "radices": df32.df32_radices(n)
            if alg == "df32" else [64, 16]}
    rng = np.random.default_rng(5)
    xr, xi = (rng.standard_normal((rows, n)) for _ in range(2))
    g = _c128(n, (rows, n))
    gr, gi = g.real.copy(), g.imag.copy()
    w = _ref_df32(n, +1) if alg == "df32" else \
        _ref_kernel_body(n, desc["radices"], +1, g)
    wr, wi = w.real, w.imag
    mine = c2c.build_c2c_split(desc, -1, np.float64, "cpu")
    tr, ti = (torch.from_numpy(v).requires_grad_() for v in (xr, xi))
    yr, yi = mine(tr, ti)
    torch.autograd.backward([yr, yi], [torch.from_numpy(gr),
                                       torch.from_numpy(gi)])
    assert _relerr(tr.grad.numpy() + 1j * ti.grad.numpy(),
                   wr + 1j * wi) <= TOL_F64
    # the backward is the opposite-sign transform at df accuracy
    assert _relerr(tr.grad.numpy() + 1j * ti.grad.numpy(),
                   _oracle(gr + 1j * gi, +1)) <= TOL_F64


def test_complex_gradient_is_conj_of_jax():
    """At a complex tensor boundary torch's gradient is the conjugate of
    JAX's (ROADMAP queue 3), through a df32 plan (the reference op by op,
    on the df32 cases' shapes)."""
    n = 1024
    ref = ref_ft.plan_many_dft([n], howmany=ROWS, dtype="complex128")
    mine = ft.plan_many_dft([n], howmany=ROWS, dtype="complex128",
                            device="cpu")
    assert mine.descriptors == {1: {"alg": "df32", "n": n,
                                    "radices": [4, 4, 4, 4, 4]}}
    x, w = _c128(1, (ROWS, n)), _c128(2, (ROWS, n))
    with jax.disable_jit():
        g_jax = np.asarray(jax.grad(
            lambda z: jnp.sum(jnp.real(ref.apply(z) * w)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (mine.execute(xt) * torch.from_numpy(w)).real.sum().backward()
    assert _relerr(xt.grad.numpy(), np.conj(g_jax)) <= TOL_F64


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("port_mode,ref_mode", [("on", "interpret"),
                                                ("auto", "auto")])
@pytest.mark.parametrize("batch", [None, 64])
def test_complex128_estimate_equals_reference_default(port_mode, ref_mode,
                                                      batch):
    """The repair: with the reference's hardware constants the port's
    complex128 ESTIMATE search equals the reference's default search (the
    double-float ``df32`` tier on), not only its ``strict_f64`` one."""
    config.kernel_mode = port_mode
    ref_config.pallas_mode = ref_mode
    mine, ref = _port_planner(), ref_planner.Planner()
    for n in F64_NS:
        want = ref.plan_c2c(n, np.float64, kinds.PATIENCE_ESTIMATE, batch)
        got = mine.plan_c2c(n, np.float64, kinds.PATIENCE_ESTIMATE, batch,
                            device="cpu")
        assert got == want, (n, batch)
        assert planner.sprint_desc(got) == ref_planner.sprint_desc(want)


@pytest.mark.parametrize("strict", [False, True])
def test_measure_candidates_equal_reference(strict, monkeypatch):
    """MEASURE's complex128 candidate lists (children planned with the
    timing stubbed out in both packages) equal the reference's, df32p
    inside the kernel window; under strict_f64 neither offers df32."""
    config.strict_f64 = ref_config.strict_f64 = strict

    def first(self, kind, n, rdtype, cands, *a, **k):
        return cands[0], 0.0
    monkeypatch.setattr(planner.Planner, "_measure_best", first)
    monkeypatch.setattr(ref_planner.Planner, "_measure_best", first)
    mine, ref = _port_planner(), ref_planner.Planner()
    for n in (128, 1000, 1009, 1024, 2048):
        want = ref._candidates_c2c(n, np.float64, kinds.PATIENCE_MEASURE, 64)
        got = mine._candidates_c2c(n, np.float64, kinds.PATIENCE_MEASURE,
                                   64, torch.device("cpu"))
        assert got == want, n
        algs = {d["alg"] for d in got}
        assert ("df32p" in algs) == (not strict and n in (128, 1000, 1024))
        assert ("df32" in algs) == (not strict and n != 1009)


def test_strict_f64_estimate_equals_reference():
    config.strict_f64 = ref_config.strict_f64 = True
    mine, ref = _port_planner(), ref_planner.Planner()
    for n in F64_NS:
        got = mine.plan_c2c(n, np.float64, 0, 64, device="cpu")
        assert got == ref.plan_c2c(n, np.float64, 0, 64), n
        assert "df32" not in json.dumps(got)


@pytest.mark.parametrize("n,desc,ok", [
    (1024, {"alg": "df32", "n": 1024, "radices": [4, 4, 4, 4, 4]}, True),
    (1024, {"alg": "df32", "n": 1024, "radices": [4, 4, 64]}, True),
    (21, {"alg": "df32", "n": 21, "radices": [7, 3]}, True),
    (1024, {"alg": "df32", "n": 1024, "radices": [4, 4]}, False),
    (1024, {"alg": "df32", "n": 1024, "radices": [1, 1024]}, False),
    (1024, {"alg": "df32", "n": 1024}, False),
    (1024, {"alg": "df32", "n": 1024, "radices": ["4", 256]}, False),
    (1024, {"alg": "df32p", "n": 1024, "radices": [64, 16]}, True),
    (1000, {"alg": "df32p", "n": 1000, "radices": [50, 20]}, True),
    (1024, {"alg": "df32p", "n": 1024, "radices": [4, 4, 4, 4, 4]}, False),
    (21, {"alg": "df32p", "n": 21, "radices": [7, 3]}, False),
    (2048, {"alg": "df32p", "n": 2048, "radices": [64, 32]}, False),
    (1024, {"alg": "df32p", "n": 1024, "radices": [64, 8]}, False),
])
def test_validate_desc(n, desc, ok):
    """df32 as the reference validates it (any radices whose product is
    n); df32p only what K7 runs."""
    assert planner.validate_desc("c2c", n, desc) is ok
    if ok and desc["alg"] == "df32":
        assert ref_planner.validate_desc("c2c", n, desc)


@pytest.mark.parametrize("desc", [
    {"alg": "df32", "n": 1024, "radices": [4, 4, 4, 4, 4]},
    {"alg": "df32", "n": 360, "radices": [4, 3, 3, 5, 2]},
    {"alg": "df32p", "n": 1024, "radices": [64, 16]},
    {"alg": "df32p", "n": 1000, "radices": [50, 20]},
    {"alg": "df32p", "n": 128, "radices": [16, 8]}],
    ids=lambda d: f"{d['alg']}-{d['n']}")
def test_sprint_opcount_cost_equal_reference(desc):
    assert planner.sprint_desc(desc) == ref_planner.sprint_desc(desc)
    assert c2c.c2c_opcount(desc) == ref_c2c.c2c_opcount(desc)
    assert planner._c2c_cost(desc, ref_planner.HW, True) == \
        ref_planner._c2c_cost(desc, ref_planner.HW, True)


def _smoke_literal():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke.REFERENCE_WISDOM_F64


def test_chip_smoke_df32p_wisdom_literal_is_the_reference_export(
        monkeypatch):
    """The reference-format wisdom that ``chip_smoke.py`` imports to pin
    df32p equals ``fftw3_tpu``'s own MEASURE export (its timing stubbed to
    pick df32p) for plan_many_dft([1024], howmany=8192) and the axes of
    plan_many_dft([512, 512], howmany=64), up to the device signature; the
    port serves it under ESTIMATE."""
    def pick_df32p(self, kind, n, rdtype, cands, *a, **k):
        return next((c for c in cands if c["alg"] == "df32p"), cands[0]), 0.0
    monkeypatch.setattr(ref_planner.Planner, "_measure_best", pick_df32p)
    ref = ref_planner.Planner()
    ref.plan_c2c(1024, np.float64, kinds.PATIENCE_MEASURE, 8192)
    ref.plan_c2c(512, np.float64, kinds.PATIENCE_MEASURE, 64 * 512)
    want = json.loads(ref.export_wisdom())
    got = json.loads(_smoke_literal())
    assert got["format"] == want["format"] == planner.REFERENCE_WISDOM_FORMAT

    def unsigned(entries):
        out = {}
        for key, value in entries.items():
            kind, n, dt, _, bucket = key.split(":")
            out[f"{kind}:{n}:{dt}:{bucket}"] = value
        return out
    mine_entries = unsigned(got["entries"])
    assert mine_entries == {k: v for k, v in unsigned(want["entries"]).items()
                            if k in mine_entries}
    assert set(mine_entries) == {"c2c:1024:float64:b7", "c2c:512:float64:b8"}
    pl = _port_planner()
    assert pl.import_reference_wisdom(_smoke_literal(), device="cpu")
    assert pl.plan_c2c(1024, np.float64, 0, 8192, "cpu") == \
        {"alg": "df32p", "n": 1024, "radices": [64, 16]}
    assert pl.plan_c2c(512, np.float64, 0, 64 * 512, "cpu") == \
        {"alg": "df32p", "n": 512, "radices": [32, 16]}
    assert pl.stats["nplan"] == 0


# ---------------------------------------------------------------------------
# complex128 plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["many_1024", "many_131", "3d_12x16x10",
                                  "r2c_8x1024", "c2r_6x24x20"])
def test_complex128_plans_match_reference(name, monkeypatch):
    """Plans through the normal entry points on the reference's hardware
    constants: the same descriptors (df32 on every smooth axis), outputs
    within 1e-12 of the reference's, and float64 throughout."""
    monkeypatch.setattr(ft.the_planner, "hw", _port_planner().hw)
    kind, _, dims = name.partition("_")
    shape = tuple(int(v) for v in dims.split("x"))
    if kind == "many":
        n = shape[0]
        ref = ref_ft.plan_many_dft([n], howmany=ROWS, dtype="complex128")
        mine = ft.plan_many_dft([n], howmany=ROWS, dtype="complex128",
                                device="cpu")
        x = _c128(n, (ROWS, n))
    elif kind == "3d":
        ref = ref_ft.plan_dft_3d(*shape, dtype="complex128")
        mine = ft.plan_dft_3d(*shape, dtype="complex128", device="cpu")
        x = _c128(0, shape)
    elif kind == "r2c":
        ref = ref_ft.plan_dft_r2c(shape, axes=(1,), dtype="float64")
        mine = ft.plan_dft_r2c(shape, axes=(1,), dtype="float64",
                               device="cpu")
        x = np.random.default_rng(0).standard_normal(shape)
    else:
        ref = ref_ft.plan_dft_c2r(shape, axes=(1, 2), dtype="float64")
        mine = ft.plan_dft_c2r(shape, axes=(1, 2), dtype="float64",
                               device="cpu")
        x = _c128(0, shape[:-1] + (shape[-1] // 2 + 1,))
    assert mine.descriptors == ref.descriptors
    assert "df32" in repr(mine)
    if kind == "many":          # op by op, on the df32 cases' shapes
        with jax.disable_jit():
            want = np.asarray(ref.apply(jnp.asarray(x)))
    else:                       # compiled: cheaper than op by op here
        want = np.asarray(ref.execute(x))
    got = mine.execute(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and got.dtype in (np.float64,
                                                     np.complex128)
    assert _relerr(got, want) <= TOL_F64
    assert mine.flops() == pytest.approx(ref.flops(), rel=1e-12)


def test_wisdom_pinned_df32p_plan_on_cpu():
    """A plan pinned to df32p by a reference-format wisdom import runs the
    twin on the CPU and stays within the double contract."""
    pl = ft.the_planner
    assert pl.import_reference_wisdom(_smoke_literal(), device="cpu")
    p = ft.plan_many_dft([1024], howmany=8192, dtype="complex128",
                         device="cpu")
    assert p.descriptors == {1: {"alg": "df32p", "n": 1024,
                                 "radices": [64, 16]}}
    assert "(df32p-1024 r64x16)" in repr(p)
    # 542 f32 operations per point: the reference's count, in Dekker's form
    add, mul, fma = p.flops()
    assert fma == 0.0 and round((add + mul) / (8192 * 1024)) == 542


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,radices", [(128, [16, 8]), (256, [16, 16]),
                                       (512, [32, 16]), (1000, [50, 20]),
                                       (1024, [64, 16]), (240, [16, 15]),
                                       (360, [8, 45]), (1024, [4, 4, 64])])
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("batch", [1, 37, 130])
def test_kernel_matches_twin_on_card(cuda_device, n, radices, sign, batch):
    """K7 against its twin on the same card, bit for bit, and against
    complex128."""
    x = _c128(n * batch, (batch, n))
    xr, xi = (torch.from_numpy(np.ascontiguousarray(v)).to(cuda_device)
              for v in (x.real, x.imag))
    before = df32.launches
    kr, ki = df32.df32_c2c_cuda(xr, xi, radices, sign)
    torch.cuda.synchronize()
    assert df32.launches == before + 1
    tr, ti = df32.df32_c2c_torch(xr, xi, radices, sign)
    k = torch.complex(kr, ki).cpu().numpy()
    assert torch.equal(kr, tr) and torch.equal(ki, ti)
    assert _relerr(k, _oracle(x, sign)) <= TOL_F64


@pytest.mark.cuda
@pytest.mark.parametrize("n,radices", [(1024, [64, 16]), (256, [16, 16])])
def test_ablation_arms_on_card(cuda_device, n, radices):
    """K7's timing-only arms launch on a ragged batch: the full arm is K7
    bit for bit, the others compute other numbers, each counted; a
    schedule outside their family is refused."""
    x = _c128(n, (2 * df32.rows_per_block(n, radices) + 3, n))
    xr, xi = (torch.from_numpy(np.ascontiguousarray(v)).to(cuda_device)
              for v in (x.real, x.imag))
    kr, ki = df32.df32_c2c_cuda(xr, xi, radices, -1)
    df32.ablate_launches.clear()
    for arm in df32.ABLATE_ARMS:
        yr, yi = df32.df32_ablate_cuda(xr, xi, radices, -1, arm)
        torch.cuda.synchronize()
        same = torch.equal(yr, kr) and torch.equal(yi, ki)
        assert same == (arm == "full"), arm
        assert bool(torch.isfinite(yr).all() and torch.isfinite(yi).all())
    assert df32.ablate_launches == dict.fromkeys(df32.ABLATE_ARMS, 1)
    with pytest.raises(ValueError, match="no K7 arm"):
        df32.df32_ablate_cuda(xr, xi, radices, -1, "fast")
    with pytest.raises(ValueError, match="power-of-4"):
        df32.df32_ablate_cuda(xr[:, :n // 2].contiguous(),
                              xi[:, :n // 2].contiguous(),
                              df32.df32p_radices(n // 2), -1, "full")


@pytest.mark.cuda
def test_plan_runs_kernel_once_per_call_and_backward(cuda_device):
    """A CUDA plan pinned to df32p launches K7 once per call and once (the
    opposite sign) in its backward; the df32 plan launches it never."""
    ft.forget_wisdom()
    assert ft.import_reference_wisdom(_smoke_literal(), device=cuda_device)
    p = ft.plan_many_dft([1024], howmany=8192, dtype="complex128",
                         device=cuda_device)
    assert p.descriptors == {1: {"alg": "df32p", "n": 1024,
                                 "radices": [64, 16]}}
    x = _c128(4, (8192, 1024))
    xr, xi = (torch.from_numpy(np.ascontiguousarray(v)).to(cuda_device)
              .requires_grad_() for v in (x.real, x.imag))
    before = df32.launches
    yr, yi = p.apply_split(xr, xi)
    assert df32.launches == before + 1
    got = torch.complex(yr, yi)[:64].detach().cpu().numpy()
    assert _relerr(got, np.fft.fft(x[:64])) <= TOL_F64
    (yr.sum() + yi.sum()).backward()
    assert df32.launches == before + 2
    ft.forget_wisdom()
    q = ft.plan_many_dft([1024], howmany=8, dtype="complex128",
                         device=cuda_device)
    assert q.descriptors[1]["alg"] == "df32"
    q.apply_split(xr[:8].detach(), xi[:8].detach())
    assert df32.launches == before + 2


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(4, 1024, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="float64"):
        df32.df32_c2c_cuda(x.float(), x.float(), [64, 16], -1)
    with pytest.raises(ValueError, match="does not fit"):
        df32.df32_c2c_cuda(x, x, [64, 8], -1)
    with pytest.raises(ValueError, match="contiguous"):
        df32.df32_c2c_cuda(x.t(), x.t(), [2, 2], -1)
