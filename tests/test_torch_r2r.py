"""The r2r slice: fftw3_tpu_torch's real-to-real solvers, planner and plans
against fftw3_tpu's.

Both packages get the same numpy input (seeded) — the reference with Pallas
in interpret mode wherever a descriptor has a kernel child, the port with
``kernel_mode = "on"`` (its plain twins on the CPU) and its planners on the
reference's hardware constants.  Host constants equal bit for bit; the
ESTIMATE descriptors and the MEASURE candidate lists equal the
reference's; every one of the sixteen algorithms, with kernel children and
with plain ones, is within 2e-5 (float32) and 1e-12 (float64) of the
reference and of float64 ``x @ r2r_matrix`` (max-abs error over max-abs);
plans equal the reference's in descriptors, ``repr`` and ``flops()``; each
kind and its inverse kind multiply by ``logical_size``; gradients equal
``jax.grad``; reference wisdom carries over.  Tests marked ``cuda`` hold the
kernel routes against the twins and float64 on the card.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftw3_tpu as ref_ft
from fftw3_tpu import config as ref_config
from fftw3_tpu import kinds as ref_kinds
from fftw3_tpu import planner as ref_planner
from fftw3_tpu.ops import matrices as ref_matrices
from fftw3_tpu.ops import pallas_stockham as PS
from fftw3_tpu.ops import r2r as ref_r2r

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import config, kinds, planner
from fftw3_tpu_torch import plan as plan_mod
from fftw3_tpu_torch.ops import matrices, r2r
from fftw3_tpu_torch.ops import real_stockham as RS
from fftw3_tpu_torch.ops import stockham as S

TOL = 2e-5
TOL64 = 1e-12
KINDS = [k.value for k in kinds.R2R_KINDS]
NS = [1, 2, 3, 5, 7, 16, 17, 64, 127, 128, 257, 512, 513, 1021, 1024, 4096,
      4097]
F32, F64 = np.float32, np.float64


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    """Kernels on in both packages, the port's global planner on the
    reference's hardware constants, both global planners without wisdom,
    the double-float tiers on."""
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    for cfg in (config, ref_config):
        monkeypatch.setattr(cfg, "strict_f64", False)
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(ft.the_planner, "hw", _ref_hw())
    monkeypatch.setattr(ft.the_planner, "wisdom", {})
    monkeypatch.setattr(ref_planner.the_planner, "wisdom", {})


def _ref_hw():
    return planner.HardwareModel(**dataclasses.asdict(ref_planner.HW))


def _relerr(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _x(shape, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# -- host constants --------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_r2r_matrix_equals_reference(kind):
    with np.errstate(divide="ignore", invalid="ignore"):
        for n in (1, 2, 3, 5, 8, 17, 64, 127, 128):
            assert np.array_equal(matrices.r2r_matrix(kind, n),
                                  ref_matrices.r2r_matrix(kind, n)), n


def test_permutations_and_odd_maps_equal_reference():
    for n in list(range(1, 70)) + [127, 255, 511, 513, 1021]:
        assert np.array_equal(r2r._makhoul_perm(n), ref_r2r._makhoul_perm(n))
        assert np.array_equal(r2r._makhoul_inv(n), ref_r2r._makhoul_inv(n))
        if n % 2:
            for a, b in zip(r2r._redft11_odd_maps(n),
                            ref_r2r._redft11_odd_maps(n)):
                assert a.dtype == b.dtype and np.array_equal(a, b), n


def test_kinds_equal_reference():
    assert [k.value for k in kinds.R2R_KINDS] == \
        [k.value for k in ref_kinds.R2R_KINDS]
    assert {i: k.value for i, k in kinds.R2R_KIND_VALUES.items()} == \
        {i: k.value for i, k in ref_kinds.R2R_KIND_VALUES.items()}
    for k in kinds.Kind:
        assert kinds.kind_from_name(k.value.upper()) is k
        for n in (1, 2, 7, 64):
            assert kinds.logical_size(k, n) == \
                ref_kinds.logical_size(ref_kinds.Kind(k.value), n)
    assert kinds.kind_from_name(5) is kinds.Kind.REDFT10
    assert kinds.kind_from_name(kinds.Kind.DHT) is kinds.Kind.DHT


# -- the planner -----------------------------------------------------------

@pytest.mark.parametrize("port_mode,ref_mode", [("on", "interpret"),
                                                ("auto", "auto")])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("kind", KINDS)
def test_estimate_descriptors_equal_reference(kind, dtype, port_mode,
                                              ref_mode):
    config.kernel_mode = port_mode
    ref_config.pallas_mode = ref_mode
    mine, ref = planner.Planner(_ref_hw()), ref_planner.Planner()
    for n in NS:
        want = ref._plan(kind, n, dtype, 0, 64)
        got = mine.plan_r2r(kinds.Kind(kind), n, dtype, 0, 64, "cpu")
        assert got == want, (kind, n)
        assert planner.sprint_desc(got) == ref_planner.sprint_desc(want)
        assert r2r.r2r_opcount(got) == ref_r2r.r2r_opcount(want)
        assert mine._cost(kind, got, dtype == F64) == \
            ref._cost(kind, want, dtype == F64)


def _first(self, kind, n, rdtype, cands, *a, **k):
    return cands[0], 0.0


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("kind", KINDS)
def test_measure_candidates_equal_reference(kind, dtype, monkeypatch):
    """MEASURE's r2r candidate lists (children planned at MEASURE patience
    with the timing stubbed out in both packages) equal the reference's."""
    monkeypatch.setattr(planner.Planner, "_measure_best", _first)
    monkeypatch.setattr(ref_planner.Planner, "_measure_best", _first)
    mine, ref = planner.Planner(_ref_hw()), ref_planner.Planner()
    for n in (5, 16, 17, 257, 512, 1021):
        want = ref._candidates(kind, n, dtype, kinds.PATIENCE_MEASURE, 64)
        got = mine._candidates(kind, n, dtype, kinds.PATIENCE_MEASURE, 64,
                               torch.device("cpu"))
        assert got == want, (kind, n)


R2C256 = {"alg": "pallas_r2c", "n": 256, "radices": [128]}
C2R256 = {"alg": "pallas_c2r", "n": 256, "radices": [128]}
DENSE16 = {"alg": "r2c_dense", "n": 16}


@pytest.mark.parametrize("kind,n,desc,ok", [
    ("redft10", 256, {"alg": "redft10_half", "n": 256, "child": R2C256},
     True),
    ("dht", 257, {"alg": "dht_rader", "n": 257,
                  "children": [R2C256, C2R256]}, True),
    ("dht", 256, {"alg": "dht_rader", "n": 256,
                  "children": [R2C256, C2R256]}, False),      # not prime
    ("dht", 257, {"alg": "dht_rader", "n": 257,
                  "children": [R2C256]}, False),
    ("redft00", 9, {"alg": "redft00_ext", "n": 9, "child": DENSE16}, True),
    ("redft00", 9, {"alg": "redft00_ext", "n": 9,
                    "child": {"alg": "r2c_dense", "n": 18}}, False),
    ("rodft00", 7, {"alg": "rodft00_ext", "n": 7, "child": DENSE16}, True),
    ("redft11", 8, {"alg": "redft11_2n", "n": 8,
                    "child": {"alg": "direct", "n": 16}}, True),
    ("redft11", 8, {"alg": "redft11_2n", "n": 8,
                    "child": {"alg": "direct", "n": 8}}, False),
    ("redft00", 17, {"alg": "redft00_split", "n": 17, "children": [
        {"alg": "r2r_matmul", "kind": "redft00", "n": 9},
        {"alg": "r2r_matmul", "kind": "redft10", "n": 8}]}, True),
    ("redft00", 16, {"alg": "redft00_split", "n": 16, "children": [
        {"alg": "r2r_matmul", "kind": "redft00", "n": 9},
        {"alg": "r2r_matmul", "kind": "redft10", "n": 8}]}, False),
    ("rodft00", 17, {"alg": "rodft00_split", "n": 17, "children": [
        {"alg": "r2r_matmul", "kind": "rodft00", "n": 8},
        {"alg": "r2r_matmul", "kind": "rodft10", "n": 9}]}, True),
    ("rodft10", 16, {"alg": "rodft10_flip", "n": 16, "child": {
        "alg": "r2r_matmul", "kind": "redft10", "n": 16}}, True),
    ("rodft10", 16, {"alg": "rodft10_flip", "n": 16, "child": {
        "alg": "r2r_matmul", "kind": "redft10", "n": 15}}, False),
    ("redft11", 17, {"alg": "redft11_odd", "n": 17, "child": {
        "alg": "r2r_matmul", "kind": "r2hc", "n": 17}}, True),
    ("hc2r", 16, {"alg": "hc2r_via_c2r", "n": 16,
                  "child": {"alg": "c2r_dense", "n": 16}}, True),
    ("hc2r", 16, {"alg": "hc2r_via_c2r", "n": 16,
                  "child": {"alg": "r2c_dense", "n": 16}}, False),
    ("dht", 64, {"alg": "r2r_matmul", "kind": "dht", "n": 64}, True),
    ("dht", 64, {"alg": "r2r_matmul", "kind": "dht", "n": 63}, False),
    ("dht", 64, {"alg": "r2r_matmul", "n": 64}, False),
    ("dht", 64, {"alg": "nosuch", "n": 64}, False),
    ("dht", 64, "garbage", False),
])
def test_validate_desc_agrees_with_reference(kind, n, desc, ok):
    assert planner.validate_desc(kind, n, desc) is ok
    assert ref_planner.validate_desc(kind, n, desc) is ok


@pytest.mark.parametrize("kind,n,desc", [
    ("redft10", 64, {"alg": "r2r_matmul", "kind": "dht", "n": 64}),
    ("redft10", 64, {"alg": "r2r_matmul", "kind": "bogus", "n": 64}),
    ("redft10", 16, {"alg": "dht_via_r2c", "n": 16, "child": DENSE16}),
    ("rodft10", 16, {"alg": "rodft10_flip", "n": 16, "child": {
        "alg": "r2r_matmul", "kind": "dht", "n": 16}}),
    ("redft11", 16, {"alg": "redft11_odd", "n": 16, "child": {
        "alg": "r2r_matmul", "kind": "r2hc", "n": 16}}),
])
def test_validate_desc_refuses_another_kind(kind, n, desc):
    """Deliberate deviation: the port refuses an r2r descriptor that would
    compute another kind than the one planned (the reference checks only
    that a child is some r2r kind), and ``redft11_odd`` at an even n."""
    assert ref_planner.validate_desc(kind, n, desc)
    assert not planner.validate_desc(kind, n, desc)


def _set_tf32(on):
    torch.set_float32_matmul_precision("high" if on else "highest")


@pytest.mark.parametrize("kind", KINDS)
def test_dense_solver_refused_while_tf32_allowed(kind):
    """The name dates from when the port refused the dense solver while
    float32 products could be TF32; it is kept so that the test's history
    stays one line.  Now every dense product pins full precision for its
    call (``dense.exact_matmul``), so under
    ``set_float32_matmul_precision("high")`` the float32 ``r2r_matmul`` is
    offered as the reference offers it (MEASURE's list ends with it), a
    wisdom hit on it is served, it builds, and it stays within 2e-5 of
    float64 both when it was built before the setting and after; the
    setting reads back unchanged after every call."""
    n = 17 if kind in ("redft00", "rodft00", "redft11") else 16
    dense = {"alg": "r2r_matmul", "kind": kind, "n": n}
    pl = planner.Planner(_ref_hw())
    assert pl.plan_r2r(kind, n, F32, 0, 8, "cpu") == dense
    built = r2r.build_r2r(dense, F32, "cpu")
    x = _x((8, n), F32)
    want = x.astype(F64) @ ref_matrices.r2r_matrix(kind, n)
    try:
        _set_tf32(True)
        cands = pl._candidates(kind, n, F32, kinds.PATIENCE_MEASURE, 8,
                               torch.device("cpu"))
        assert cands[-1] == dense
        assert pl._candidates(kind, n, F64, 0, 8, "cpu")[-1] == dense
        assert pl.plan_r2r(kind, n, F32, 0, 8, "cpu") == dense  # wisdom hit
        for fn in (built, r2r.build_r2r(dense, F32, "cpu")):
            y = fn(torch.from_numpy(x))
            assert _relerr(y.numpy(), want) <= TOL
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        _set_tf32(False)
    assert torch.get_float32_matmul_precision() == "highest"
    assert _relerr(built(torch.from_numpy(x)).numpy(), want) <= TOL


def test_import_reference_wisdom_carries_r2r_entries():
    """The reference's r2r wisdom (children included, ``children`` lists
    stripped of TPU-only keys) pins the same descriptors in the port,
    served from wisdom with no new search."""
    ref = ref_planner.Planner()
    problems = [("redft10", 256), ("dht", 257), ("redft00", 17),
                ("rodft11", 64), ("hc2r", 1024), ("redft11", 17)]
    rader = json.loads(json.dumps(KERNEL_CASES["dht_rader"][2]))
    rader["children"][0]["merge"] = True      # TPU-only key: stripped
    ref.wisdom[ref._key("dht", 257, F32, 64)] = {
        "desc": rader, "patience": 0, "cost": 0.0}
    for kind, n in problems:
        ref._plan(kind, n, F32, 0, 64)
    data = json.loads(ref.export_wisdom())
    mine = planner.Planner(_ref_hw())
    assert mine.import_reference_wisdom(json.dumps(data), device="cpu")
    assert {k for k, _ in problems} <= {k.split(":")[0] for k in mine.wisdom}
    for kind, n in problems:
        got = mine.plan_r2r(kind, n, F32, 0, 64, "cpu")
        want = ref._plan(kind, n, F32, 0, 64)
        assert got == planner._strip_tpu_keys(want), (kind, n)
    assert mine.plan_r2r("dht", 257, F32, 0, 64, "cpu") == \
        KERNEL_CASES["dht_rader"][2]
    assert "merge" not in json.dumps(mine.wisdom)
    assert mine.stats["nplan"] == 0


def test_measure_times_r2r_candidates_on_cpu():
    config.measure_points = 1 << 11
    pl = planner.Planner(_ref_hw())
    for kind, n in (("redft10", 256), ("dht", 17), ("redft00", 17)):
        d = pl.plan_r2r(kind, n, F32, kinds.PATIENCE_MEASURE, 4, "cpu")
        assert planner.validate_desc(kind, n, d)
    assert pl.stats["nmeasure"] >= 6 and pl.stats["nmeasure_failed"] == 0


def test_measure_failure_raises_on_cuda(monkeypatch):
    """An r2r candidate that fails to build re-raises on a CUDA device."""
    def broken(*args):
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(planner, "_measure_fn", broken)
    cands = [{"alg": "redft10_half", "n": 256, "child": R2C256},
             {"alg": "r2r_matmul", "kind": "redft10", "n": 256}]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        planner.Planner()._measure_best("redft10", 256, F32, cands, 64,
                                        torch.device("cuda"))


# -- every algorithm, against the reference's builder and float64 ---------

def _bfly(n):
    return S.choose_radices(n)


#: alg -> (kind, n, descriptor) with kernel children (K4, K6 or K1)
KERNEL_CASES = {
    "dht_via_r2c": ("dht", 256, {"alg": "dht_via_r2c", "n": 256,
                                 "child": R2C256}),
    "dht_rader": ("dht", 257, {"alg": "dht_rader", "n": 257,
                               "children": [R2C256, C2R256]}),
    "r2hc_via_r2c": ("r2hc", 256, {"alg": "r2hc_via_r2c", "n": 256,
                                   "child": R2C256}),
    "hc2r_via_c2r": ("hc2r", 256, {"alg": "hc2r_via_c2r", "n": 256,
                                   "child": C2R256}),
    "redft10_half": ("redft10", 256, {"alg": "redft10_half", "n": 256,
                                      "child": R2C256}),
    "redft01_half": ("redft01", 256, {"alg": "redft01_half", "n": 256,
                                      "child": C2R256}),
    "redft00_ext": ("redft00", 129, {"alg": "redft00_ext", "n": 129,
                                     "child": R2C256}),
    "rodft00_ext": ("rodft00", 127, {"alg": "rodft00_ext", "n": 127,
                                     "child": R2C256}),
    "redft11_2n": ("redft11", 64, {"alg": "redft11_2n", "n": 64, "child": {
        "alg": "pallas", "n": 128, "radices": [128]}}),
    "redft00_split": ("redft00", 513, {"alg": "redft00_split", "n": 513,
                                       "children": [
        {"alg": "redft00_ext", "n": 257, "child": {
            "alg": "pallas_r2c", "n": 512, "radices": [256]}},
        {"alg": "redft10_half", "n": 256, "child": R2C256}]}),
    "rodft00_split": ("rodft00", 511, {"alg": "rodft00_split", "n": 511,
                                       "children": [
        {"alg": "rodft00_ext", "n": 255, "child": {
            "alg": "pallas_r2c", "n": 512, "radices": [256]}},
        {"alg": "rodft10_flip", "n": 256, "child": {
            "alg": "redft10_half", "n": 256, "child": R2C256}}]}),
    "rodft10_flip": ("rodft10", 256, {"alg": "rodft10_flip", "n": 256,
                                      "child": {"alg": "redft10_half",
                                                "n": 256, "child": R2C256}}),
    "rodft01_flip": ("rodft01", 256, {"alg": "rodft01_flip", "n": 256,
                                      "child": {"alg": "redft01_half",
                                                "n": 256, "child": C2R256}}),
    "rodft11_flip": ("rodft11", 64, {"alg": "rodft11_flip", "n": 64,
                                     "child": {"alg": "redft11_2n", "n": 64,
                                               "child": {
                                                   "alg": "pallas", "n": 128,
                                                   "radices": [128]}}}),
}

#: alg -> (kind, n) where the plain planner (no kernels) offers it
PLAIN_CASES = {
    "r2r_matmul": ("redft10", 16), "dht_via_r2c": ("dht", 17),
    "dht_rader": ("dht", 17), "r2hc_via_r2c": ("r2hc", 16),
    "hc2r_via_c2r": ("hc2r", 17), "redft10_half": ("redft10", 17),
    "redft01_half": ("redft01", 16), "redft00_ext": ("redft00", 16),
    "rodft00_ext": ("rodft00", 17), "redft11_2n": ("redft11", 16),
    "redft00_split": ("redft00", 17), "rodft00_split": ("rodft00", 17),
    "redft11_odd": ("redft11", 17), "rodft10_flip": ("rodft10", 16),
    "rodft01_flip": ("rodft01", 17), "rodft11_flip": ("rodft11", 16),
}


#: alg -> (kind, n, descriptor) of the port's own algorithms, which only a
#: CUDA device's planner offers (K8, ``ops/redft.py``), and the reference's
#: descriptor that computes the same
FUSED_CASES = {
    "fused_redft10": ("redft10", 256, {"alg": "fused_redft10", "n": 256,
                                       "radices": [128]},
                      KERNEL_CASES["redft10_half"][2]),
    "fused_redft01": ("redft01", 256, {"alg": "fused_redft01", "n": 256,
                                       "radices": [128]},
                      KERNEL_CASES["redft01_half"][2]),
}


def test_cases_cover_every_algorithm():
    assert set(PLAIN_CASES) | set(FUSED_CASES) == r2r.ALGS
    assert set(KERNEL_CASES) == r2r.ALGS - {"r2r_matmul", "redft11_odd"} \
        - set(FUSED_CASES)
    for name, (kind, n, desc) in KERNEL_CASES.items():
        assert planner.validate_desc(kind, n, desc), name
        assert desc["alg"] == name
    for name, (kind, n, desc, ref_desc) in FUSED_CASES.items():
        assert planner.validate_desc(kind, n, desc), name
        assert ref_planner.validate_desc(kind, n, ref_desc), name
        assert desc["alg"] == name


def _both(kind, n, desc, dtype, seed):
    x = _x((5, n), dtype, seed)
    got = r2r.build_r2r(desc, dtype, "cpu")(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(ref_r2r.build_r2r(desc, dtype))(
        jnp.asarray(x)))
    oracle = x.astype(F64) @ ref_matrices.r2r_matrix(kind, n)
    return got, want, oracle


@pytest.mark.parametrize("alg", sorted(KERNEL_CASES))
def test_kernel_children_match_reference(alg):
    """Each algorithm over K4/K6/K1 children: the port's twins against the
    reference's kernels in interpret mode, both against float64."""
    kind, n, desc = KERNEL_CASES[alg]
    got, want, oracle = _both(kind, n, desc, F32, len(alg))
    assert got.dtype == F32 and got.shape == (5, n)
    assert _relerr(got, want) <= TOL
    assert _relerr(got, oracle) <= TOL
    assert _relerr(want, oracle) <= TOL


@pytest.mark.parametrize("alg", sorted(FUSED_CASES))
def test_fused_twins_match_reference(alg):
    """The port's fused DCT-II/III (its plain version on the CPU) against
    the reference's Makhoul reduction over its K4/K6 kernels in interpret
    mode, both against float64."""
    kind, n, desc, ref_desc = FUSED_CASES[alg]
    x = _x((5, n), F32, len(alg))
    got = r2r.build_r2r(desc, F32, "cpu")(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(ref_r2r.build_r2r(ref_desc, F32))(
        jnp.asarray(x)))
    oracle = x.astype(F64) @ ref_matrices.r2r_matrix(kind, n)
    assert got.dtype == F32 and got.shape == (5, n)
    assert _relerr(got, want) <= TOL
    assert _relerr(got, oracle) <= TOL
    assert r2r.r2r_opcount(desc) == ref_r2r.r2r_opcount(ref_desc)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("alg", sorted(PLAIN_CASES))
def test_plain_children_match_reference(alg, dtype):
    """Each algorithm over the children the planner picks without kernels
    (float64: the double-float tier under them)."""
    config.kernel_mode = "auto"
    ref_config.pallas_mode = "auto"
    kind, n = PLAIN_CASES[alg]
    cands = planner.Planner(_ref_hw())._candidates(
        kind, n, dtype, 0, 8, torch.device("cpu"))
    desc = next(d for d in cands if d["alg"] == alg)
    got, want, oracle = _both(kind, n, desc, dtype, n)
    tol = TOL if dtype == F32 else TOL64
    assert got.dtype == dtype
    assert _relerr(got, want) <= tol
    assert _relerr(got, oracle) <= tol


# -- plans -----------------------------------------------------------------

PLANS = {  # name -> (shape, axes, kinds, dtype)
    "1d_8x64_dct2": ((8, 64), (1,), ["redft10"], F32),
    "1d_4x256_dct2": ((4, 256), (1,), ["redft10"], F32),
    "1d_3x257_dht": ((3, 257), (1,), ["dht"], F32),
    "2d_mixed": ((16, 12), (0, 1), ["dht", "rodft11"], F32),
    "axis0_17x6": ((17, 6), (0,), ["redft00"], F32),
    "3d_mixed": ((5, 8, 6), (0, 1, 2), ["r2hc", "redft01", "rodft00"], F32),
    "2d_f64": ((9, 16), (0, 1), ["redft11", "hc2r"], F64),
    "axis1_f64": ((4, 17, 3), (1,), ["rodft10"], F64),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plans_match_reference(name):
    shape, axes, ks, dtype = PLANS[name]
    ref = ref_ft.plan_r2r(shape, ks, axes=axes, dtype=np.dtype(dtype).name)
    mine = ft.plan_r2r(shape, ks, axes=axes, dtype=np.dtype(dtype).name,
                       device="cpu")
    assert mine.descriptors == ref.descriptors and repr(mine) == repr(ref)
    assert mine.flops() == ref.flops() and mine.cost() == ref.cost()
    assert (mine.in_shape, mine.out_shape) == (shape, shape)
    assert mine.in_dtype == mine.out_dtype == torch.from_numpy(
        np.zeros(1, dtype)).dtype
    x = _x(shape, dtype, len(name))
    y = mine.execute(x).numpy()
    assert y.dtype == dtype and y.shape == shape
    want = np.asarray(ref(x))
    tol = TOL if dtype == F32 else TOL64
    assert _relerr(y, want) <= tol
    oracle = x.astype(F64)
    for a, k in zip(axes, ks):
        oracle = np.moveaxis(np.moveaxis(oracle, a, -1)
                             @ ref_matrices.r2r_matrix(k, shape[a]), -1, a)
    assert _relerr(y, oracle) <= tol


INVERSE = {"redft00": "redft00", "rodft00": "rodft00", "redft10": "redft01",
           "redft01": "redft10", "rodft10": "rodft01", "rodft01": "rodft10",
           "redft11": "redft11", "rodft11": "rodft11", "dht": "dht",
           "r2hc": "hc2r", "hc2r": "r2hc"}


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("kind", KINDS)
def test_roundtrip_logical_size(kind, dtype):
    """Each kind composed with its inverse kind multiplies by the logical
    size N (FFTW manual "Real even/odd DFTs"), on one axis of a 2-D
    array."""
    dt = np.dtype(dtype).name
    for n in (9, 16):
        f = ft.plan_r2r((n, 3), [kind], axes=(0,), dtype=dt, device="cpu")
        b = ft.plan_r2r((n, 3), [INVERSE[kind]], axes=(0,), dtype=dt,
                        device="cpu")
        x = _x((n, 3), dtype, n)
        N = kinds.logical_size(kinds.Kind(kind), n)
        assert _relerr(b(f(x)).numpy(), N * x) <= \
            (1e-5 if dtype == F32 else TOL64), (kind, n)


def test_api_entry_points_and_kind_spellings():
    """plan_r2r_1d/2d/3d equal plan_r2r; a kind may be a Kind, a name or
    the fftw3.h integer; one kind stands for every axis."""
    p1 = ft.plan_r2r_1d(64, ft.Kind.REDFT10, device="cpu")
    assert p1.descriptors == ft.plan_r2r((64,), "redft10",
                                         device="cpu").descriptors
    p2 = ft.plan_r2r_2d(8, 12, 5, "RODFT10", device="cpu")
    assert p2.problem.r2r_kinds == (ft.Kind.REDFT10, ft.Kind.RODFT10)
    p3 = ft.plan_r2r_3d(4, 6, 8, "dht", 2, ft.r2r_kind.DHT, device="cpu")
    x = _x((4, 6, 8), F32, 3)
    ref = ref_ft.plan_r2r_3d(4, 6, 8, "dht", "dht", "dht")
    assert p3.descriptors == ref.descriptors
    assert _relerr(p3.execute(x).numpy(), np.asarray(ref(x))) <= TOL
    allk = ft.plan_r2r((4, 6), "redft01", device="cpu")
    assert allk.problem.r2r_kinds == (ft.Kind.REDFT01,) * 2
    with pytest.raises(ValueError, match="one r2r kind per"):
        ft.plan_r2r((4, 6), ["dht"], axes=(0, 1), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        p1.execute(np.zeros(63, np.float32))
    y = p1.apply(torch.from_numpy(_x((2, 3, 64), F32)))   # leading dims
    assert tuple(y.shape) == (2, 3, 64)


def _pin(pl, kind, n, batch, desc, device=None):
    """Put `desc` in a planner's wisdom for (kind, n, float32, batch)."""
    key = pl._key(kind, n, F32, batch) if device is None else \
        pl._key(kind, n, F32, batch, torch.device(device))
    pl.wisdom[key] = {"desc": desc, "patience": 99, "cost": 0.0}


GRAD_CASES = {
    "pallas_r2c": ("redft10", 256, KERNEL_CASES["redft10_half"][2]),
    "pallas_c2r": ("redft01", 256, KERNEL_CASES["redft01_half"][2]),
    "r2r_matmul": ("rodft11", 64, {"alg": "r2r_matmul", "kind": "rodft11",
                                   "n": 64}),
    "pallas_2n": ("redft11", 64, KERNEL_CASES["redft11_2n"][2]),
}


@pytest.mark.parametrize("route", sorted(GRAD_CASES))
def test_plan_grads_equal_jax(route):
    """Torch autograd through a port r2r plan (pinned by wisdom to the
    route) equals jax.grad through the reference plan: real in, real out,
    no conjugation."""
    kind, n, desc = GRAD_CASES[route]
    shape = (3, n)
    _pin(ref_planner.the_planner, kind, n, 3, desc)
    _pin(ft.the_planner, kind, n, 3, desc, "cpu")
    ref = ref_ft.plan_r2r(shape, [kind], axes=(1,))
    mine = ft.plan_r2r(shape, [kind], axes=(1,), device="cpu")
    assert mine.descriptors == ref.descriptors == {1: desc}
    x, w = _x(shape, F32, 1), _x(shape, F32, 2)
    g_jax = np.asarray(jax.grad(lambda a: jnp.sum(ref.apply(a) * w))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (mine.execute(xt) * torch.from_numpy(w)).sum().backward()
    assert _relerr(xt.grad.numpy(), g_jax) <= TOL
    # the transpose of the kind matrix, in float64
    assert _relerr(xt.grad.numpy(),
                   w.astype(F64) @ ref_matrices.r2r_matrix(kind, n).T) <= TOL


def test_routes_reach_the_kernel_builders(monkeypatch):
    """A pinned DCT-II plan builds K4's apply, a DCT-III plan K6's and a
    DCT-IV plan K1's, as the reference's builds its kernels."""
    calls = []
    for mod, name in ((RS, "build_pallas_r2c"), (RS, "build_pallas_c2r"),
                      (S, "build_pallas_c2c_split")):
        real = getattr(mod, name)

        def spy(desc, *a, _name=name, _real=real, **k):
            calls.append((_name, desc["n"]))
            return _real(desc, *a, **k)
        monkeypatch.setattr(mod, name, spy)
    for alg in ("redft10_half", "redft01_half", "redft11_2n"):
        kind, n, desc = KERNEL_CASES[alg]
        _pin(ft.the_planner, kind, n, 4, desc, "cpu")
        ft.plan_r2r((4, n), [kind], axes=(1,), device="cpu")
    assert calls == [("build_pallas_r2c", 256), ("build_pallas_c2r", 256),
                     ("build_pallas_c2c_split", 128)]


def _chip_smoke():
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


def test_chip_smoke_pins_are_reference_exports():
    """The reference-format wisdom that ``chip_smoke.py`` imports to pin
    its r2r arms equals ``fftw3_tpu``'s own export after bench.py's pin
    (``bench_dct2``'s ``_mkplans``: the entry put in the reference planner
    at patience 99), up to the device signature; the port imports it and
    serves the pinned descriptor with no search."""
    chip_smoke = _chip_smoke()

    def unsigned(entries):
        return {":".join(k.split(":")[:3] + k.split(":")[4:]): v
                for k, v in entries.items()}
    for name, (kind, n, batch, desc) in chip_smoke.R2R_PINS.items():
        ref = ref_planner.Planner()
        ref.wisdom[ref._key(kind, n, F32, batch)] = {
            "desc": desc, "patience": 99, "cost": 0.0}
        want = json.loads(ref.export_wisdom())
        got = json.loads(chip_smoke.r2r_wisdom(name))
        assert got["format"] == want["format"]
        assert unsigned(got["entries"]) == unsigned(want["entries"])
        pl = planner.Planner()
        assert pl.import_reference_wisdom(chip_smoke.r2r_wisdom(name),
                                          device="cpu")
        assert pl.plan_r2r(kind, n, F32, 0, batch, "cpu") == desc
        assert pl.stats["nplan"] == 0, name
    pins = chip_smoke.R2R_PINS
    assert pins["dct2 K4"][3]["child"] == {
        "alg": "pallas_r2c", "n": 512, "radices": PS.choose_radices(256)}
    assert pins["cube K4"][3]["child"]["radices"] == PS.choose_radices(128)
    assert pins["dct4 K1"][3]["child"] == ref_planner.Planner().plan_c2c(
        1024, F32, 0, 65536)


@pytest.mark.parametrize("kind", KINDS)
def test_chip_smoke_oracle_equals_kind_matrix(kind):
    """``chip_smoke.r2r_oracle`` (scipy.fft's DCT/DST, its FFT for the DHT
    and halfcomplex kinds) equals float64 ``x @ r2r_matrix``."""
    chip_smoke = _chip_smoke()
    for n in (16, 17, 64):
        x = _x((3, n), F64, n)
        assert _relerr(chip_smoke.r2r_oracle(kind, x),
                       x @ ref_matrices.r2r_matrix(kind, n)) <= 1e-13


# -- on the card -----------------------------------------------------------

#: (kind, n, descriptor, counter of the kernel it launches)
CUDA_ROUTES = [
    ("redft10", 512, {"alg": "redft10_half", "n": 512, "child": {
        "alg": "pallas_r2c", "n": 512, "radices": [256]}}, "r2c"),
    ("redft01", 512, {"alg": "redft01_half", "n": 512, "child": {
        "alg": "pallas_c2r", "n": 512, "radices": [256]}}, "c2r"),
    ("redft11", 512, {"alg": "redft11_2n", "n": 512, "child": {
        "alg": "pallas", "n": 1024, "radices": [64, 16]}}, "c2c"),
    ("dht", 1024, {"alg": "dht_via_r2c", "n": 1024, "child": {
        "alg": "pallas_r2c", "n": 1024, "radices": [32, 16]}}, "r2c"),
    ("rodft10", 256, KERNEL_CASES["rodft10_flip"][2], "r2c"),
    ("dht", 257, KERNEL_CASES["dht_rader"][2], "r2c c2r"),
    ("redft00", 513, KERNEL_CASES["redft00_split"][2], "r2c"),
]


def _launches():
    return {"r2c": RS.r2c_launches, "c2r": RS.c2r_launches,
            "c2c": S.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CUDA_ROUTES)))
def test_kernel_routes_on_card(case):
    """On the card each route launches its kernels and agrees with the same
    descriptor's twins on the CPU and with float64 (1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    kind, n, desc, counters = CUDA_ROUTES[case]
    x = _x((300, n), F32, case)
    before = _launches()
    y = r2r.build_r2r(desc, F32, "cuda")(torch.from_numpy(x).cuda())
    torch.cuda.synchronize()
    after = _launches()
    for c in counters.split():
        assert after[c] > before[c], c
    twin = r2r.build_r2r(desc, F32, "cpu")(torch.from_numpy(x)).numpy()
    got = y.cpu().numpy()
    assert _relerr(got, twin) <= 1e-5
    assert _relerr(got, x.astype(F64)
                   @ ref_matrices.r2r_matrix(kind, n)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plans_on_card(dtype):
    """Every kind plans and runs on a CUDA device by default, with the
    port's own constants, within 1e-5 (1e-12) of float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    ft.the_planner.hw = planner.HardwareModel()
    config.kernel_mode = "auto"
    tol = 1e-5 if dtype == "float32" else TOL64
    for kind in KINDS:
        for n in (17, 512, 1024):
            x = _x((64, n), np.dtype(dtype), n)
            p = ft.plan_r2r((64, n), [kind], axes=(1,), dtype=dtype)
            assert p.device.type == "cuda"
            y = p.execute(x)
            assert y.device.type == "cuda"
            want = x.astype(F64) @ ref_matrices.r2r_matrix(kind, n)
            assert _relerr(y.cpu().numpy(), want) <= tol, (kind, n, repr(p))
