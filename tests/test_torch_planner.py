"""fftw3_tpu_torch.planner against fftw3_tpu.planner.

With the reference's hardware constants (read here from
``fftw3_tpu.planner.HW``) the port's ESTIMATE search must pick the
reference's descriptors: kernels offered in both (port ``kernel_mode =
"on"``, reference ``pallas_mode = "interpret"``) and kernels left out in
both (``"auto"`` on the CPU), n = 4096 included: with kernels on, both
offer the four-step ``pallas4``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from fftw3_tpu import config as ref_config
from fftw3_tpu import kinds as ref_kinds
from fftw3_tpu import planner as ref_planner

from fftw3_tpu_torch import config, kinds, plan as plan_mod
from fftw3_tpu_torch import planner

NS = [8, 64, 128, 256, 512, 1000, 1009, 1024, 2048]
BATCHES = [8, 65536]


@pytest.fixture(autouse=True)
def _restore():
    old = (ref_config.pallas_mode, ref_config.strict_f64, config.kernel_mode,
           config.measure_points, config.strict_f64)
    yield
    (ref_config.pallas_mode, ref_config.strict_f64, config.kernel_mode,
     config.measure_points, config.strict_f64) = old


def _port_planner():
    return planner.Planner(planner.HardwareModel(
        **dataclasses.asdict(ref_planner.HW)))


@pytest.mark.parametrize("port_mode,ref_mode,ns", [
    ("on", "interpret", NS + [4096]),
    ("auto", "auto", NS + [4096]),
])
@pytest.mark.parametrize("batch", BATCHES)
def test_estimate_descriptors_equal_reference(port_mode, ref_mode, ns,
                                              batch):
    config.kernel_mode = port_mode
    ref_config.pallas_mode = ref_mode
    mine, ref = _port_planner(), ref_planner.Planner()
    for n in ns:
        want = ref.plan_c2c(n, np.float32, kinds.PATIENCE_ESTIMATE, batch)
        got = mine.plan_c2c(n, np.float32, kinds.PATIENCE_ESTIMATE, batch,
                            device="cpu")
        assert got == want, (n, batch)
        assert planner.sprint_desc(got) == ref_planner.sprint_desc(want)


def test_complex128_descriptors_equal_strict_reference():
    """With strict_f64 on both sides (no double-float tier) the port's
    complex128 search equals the reference's; the default search is held
    in tests/test_torch_df32.py."""
    config.kernel_mode = "on"
    ref_config.pallas_mode = "interpret"
    ref_config.strict_f64 = config.strict_f64 = True
    mine, ref = _port_planner(), ref_planner.Planner()
    for n in (64, 1000, 1009, 1024):
        assert mine.plan_c2c(n, np.float64, 0, 64, device="cpu") == \
            ref.plan_c2c(n, np.float64, 0, 64)


def test_main_path_descriptor_with_port_defaults():
    """The port's own H100 model picks the reference's main-path schedule
    for a CUDA device."""
    config.kernel_mode = "on"
    d = planner.Planner().plan_c2c(1024, np.float32, 0, 65536, "cpu")
    assert d == {"alg": "pallas", "n": 1024, "radices": [64, 16]}


@pytest.mark.parametrize("n,desc,ok", [
    (1024, {"alg": "pallas", "n": 1024, "radices": [64, 16]}, True),
    (1024, {"alg": "pallas", "n": 1024, "radices": [64, 16], "vpu": "all"},
     True),
    (48, {"alg": "mixed", "n": 48, "p": 4,
          "child": {"alg": "direct", "n": 12}}, True),
    (37, {"alg": "bluestein", "n": 37, "m": 128,
          "child": {"alg": "direct", "n": 128}}, True),
    (131, {"alg": "rader", "n": 131, "child": {"alg": "direct", "n": 130}},
     True),
    (1024, {"alg": "pallas", "n": 1024, "radices": [64, 8]}, False),
    (1024, {"alg": "pallas", "n": 1024, "radices": [16, 8, 8]}, False),
    (4096, {"alg": "pallas", "n": 4096, "radices": [64, 64]}, False),
    (4096, {"alg": "pallas", "n": 4096, "radices": [64, 64], "vpu": "all"},
     True),
    (4096, {"alg": "pallas", "n": 4096, "radices": [128, 32], "vpu": "all"},
     False),
    (4096, {"alg": "pallas", "n": 4096, "radices": [64, 64], "vpu": True},
     False),
    (8192, {"alg": "pallas", "n": 8192, "radices": [64, 128], "vpu": "all"},
     False),
    (4096, {"alg": "pallas4", "n": 4096, "p": 64, "q": 64}, True),
    (4096, {"alg": "pallas4", "n": 4096, "p": 64, "q": 32}, False),
    (1024, {"alg": "df32", "n": 1024, "radices": [4, 4, 64]}, True),
    (48, {"alg": "mixed", "n": 48, "p": 5,
          "child": {"alg": "direct", "n": 9}}, False),
    (37, {"alg": "bluestein", "n": 37, "m": 64,
          "child": {"alg": "direct", "n": 64}}, False),
    (130, {"alg": "rader", "n": 130, "child": {"alg": "direct", "n": 129}},
     False),
    (64, {"alg": "direct", "n": 63}, False),
    (64, "garbage", False),
])
def test_validate_desc(n, desc, ok):
    assert planner.validate_desc("c2c", n, desc) is ok


def test_wisdom_round_trip_and_wisdom_only():
    config.kernel_mode = "on"
    pl = _port_planner()
    want = [pl.plan_c2c(n, np.float32, 0, 64, "cpu") for n in (256, 1000)]
    s = pl.export_wisdom()
    pl.forget_wisdom()
    assert pl.wisdom == {}
    assert pl.import_wisdom(s)
    assert not pl.import_wisdom("not json")
    assert not pl.import_wisdom(json.dumps({"format": "other"}))
    nplan = pl.stats["nplan"]
    assert [pl.plan_c2c(n, np.float32, 0, 64, "cpu")
            for n in (256, 1000)] == want
    assert pl.stats["nplan"] == nplan and pl.stats["nwisdom_hit"] >= 2
    prob = plan_mod.Problem(shape=(4, 512), axes=(1,), kind="c2c")
    with pytest.raises(planner.WisdomOnlyMiss):
        plan_mod.make_plan(prob, kinds.ESTIMATE | kinds.WISDOM_ONLY,
                           planner=pl, device="cpu")
    p = plan_mod.make_plan(plan_mod.Problem(shape=(64, 1000), axes=(1,),
                                            kind="c2c"),
                           kinds.ESTIMATE | kinds.WISDOM_ONLY, planner=pl,
                           device="cpu")
    assert p.descriptors[1] == want[1]


def test_import_reference_wisdom_gives_fresh_plan():
    config.kernel_mode = "on"
    ref_config.pallas_mode = "interpret"
    ref = ref_planner.Planner()
    for n in (1009, 1024, 2048):
        ref.plan_c2c(n, np.float32, 0, 64)
    ref.plan_r2r(ref_kinds.Kind.DHT, 64, np.float32, 0, 64)  # carried
    data = json.loads(ref.export_wisdom())
    key = next(k for k, v in data["entries"].items()
               if k.startswith("c2c:2048:"))
    data["entries"][key]["desc"]["k2"] = "all"    # TPU-only key: stripped
    mine = _port_planner()
    assert not mine.import_reference_wisdom("{]", device="cpu")
    assert not mine.import_reference_wisdom(mine.export_wisdom(),
                                            device="cpu")
    assert mine.import_reference_wisdom(json.dumps(data), device="cpu")
    assert all(k.startswith(("c2c:", "r2c:", "dht:")) for k in mine.wisdom)
    fresh = _port_planner()
    for n in (1009, 1024, 2048):
        got = mine.plan_c2c(n, np.float32, 0, 64, "cpu")
        assert got == fresh.plan_c2c(n, np.float32, 0, 64, "cpu")
        assert "k2" not in got
    assert mine.stats["nplan"] == 0 and mine.stats["nwisdom_hit"] == 3


def test_measure_times_candidates_on_cpu():
    """MEASURE builds and times every candidate (torch.fft's ``xla`` alg
    included when allowed) and keeps a valid one."""
    config.kernel_mode = "on"
    config.measure_points = 1 << 11
    pl = _port_planner()
    pl.allow_xla = True
    d = pl.plan_c2c(256, np.float32, kinds.PATIENCE_MEASURE, 4, "cpu")
    assert planner.validate_desc("c2c", 256, d)
    assert pl.stats["nmeasure"] > 0
    assert pl.stats["nmeasure_failed"] == 0
    assert "pcost" in pl.stats


@pytest.mark.parametrize("mode,device,vpu", [
    ("on", "cpu", True), ("on", "cuda", False), ("auto", "cuda", False)])
def test_vpu_variants_only_where_they_differ(mode, device, vpu,
                                             monkeypatch):
    """MEASURE races the butterfly (``vpu``) variants on the CPU, where the
    twin runs, and not on a CUDA device, where a ``vpu`` candidate and its
    plain twin are the same kernel (the radix alone picks each stage's
    form)."""
    config.kernel_mode = mode
    # no mixed candidates: their children would be timed on the device
    monkeypatch.setattr(planner, "_mixed_factor_candidates",
                        lambda n, patience: [])
    cands = _port_planner()._candidates_c2c(
        1024, np.float32, kinds.PATIENCE_MEASURE, 64, torch.device(device))
    rads = [c["radices"] for c in cands if c["alg"] == "pallas"]
    assert [64, 16] in rads and [32, 32] in rads
    assert any("vpu" in c for c in cands) is vpu


def _first(self, kind, n, rdtype, cands, *a, **k):
    return cands[0], 0.0


@pytest.mark.parametrize("n", [1024, 2048, 4096])
def test_measure_candidates_equal_reference_complex64(n, monkeypatch):
    """MEASURE's complex64 candidate lists (children planned with the
    timing stubbed out in both packages, kernels on in both) equal the
    reference's; at n = 4096 both race the all-butterfly ``pallas``
    schedule [64, 64] beside ``pallas4``."""
    config.kernel_mode = "on"
    ref_config.pallas_mode = "interpret"
    monkeypatch.setattr(planner.Planner, "_measure_best", _first)
    monkeypatch.setattr(ref_planner.Planner, "_measure_best", _first)
    mine, ref = _port_planner(), ref_planner.Planner()
    want = ref._candidates_c2c(n, np.float32, kinds.PATIENCE_MEASURE, 64)
    got = mine._candidates_c2c(n, np.float32, kinds.PATIENCE_MEASURE, 64,
                               torch.device("cpu"))
    assert got == want
    wide = {"alg": "pallas", "n": 4096, "radices": [64, 64], "vpu": "all"}
    assert (wide in got) is (n == 4096)


def test_chip_smoke_wide_wisdom_literal_is_the_reference_export(
        monkeypatch):
    """The reference-format wisdom that ``chip_smoke.py`` imports to pin
    the all-butterfly [64, 64] at n = 4096 equals ``fftw3_tpu``'s own
    MEASURE export (its timing stubbed to pick that candidate) for
    plan_many_dft([4096], howmany=4096), up to the device signature; the
    port imports it and serves it under ESTIMATE."""
    import os
    import sys
    ref_config.pallas_mode = "interpret"
    wide = {"alg": "pallas", "n": 4096, "radices": [64, 64], "vpu": "all"}

    def pick_wide(self, kind, n, rdtype, cands, *a, **k):
        return (wide if wide in cands else cands[0]), 0.0
    monkeypatch.setattr(ref_planner.Planner, "_measure_best", pick_wide)
    ref = ref_planner.Planner()
    assert ref.plan_c2c(4096, np.float32, kinds.PATIENCE_MEASURE, 4096) \
        == wide
    want = json.loads(ref.export_wisdom())
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    got = json.loads(chip_smoke.REFERENCE_WISDOM_WIDE)
    assert got["format"] == want["format"] == planner.REFERENCE_WISDOM_FORMAT

    def unsigned(entries):
        return {":".join(k.split(":")[:3] + k.split(":")[4:]): v
                for k, v in entries.items()}
    mine = unsigned(got["entries"])
    assert set(mine) == {"c2c:4096:float32:b6"}
    assert mine == {k: v for k, v in unsigned(want["entries"]).items()
                    if k in mine}
    assert chip_smoke.WIDE_DESC == wide
    pl = _port_planner()
    assert pl.import_reference_wisdom(chip_smoke.REFERENCE_WISDOM_WIDE,
                                      device="cpu")
    assert pl.plan_c2c(4096, np.float32, 0, 4096, "cpu") == wide
    assert pl.stats["nplan"] == 0


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_wide_candidate_offered_on_cuda(mode, monkeypatch):
    """On a CUDA device the all-butterfly schedule at n = 4096 is the only
    ``pallas`` candidate (K1's wide form runs it); ESTIMATE offers none."""
    config.kernel_mode = mode
    monkeypatch.setattr(planner, "_mixed_factor_candidates",
                        lambda n, patience: [])
    pl = _port_planner()
    cands = pl._candidates_c2c(4096, np.float32, kinds.PATIENCE_MEASURE, 64,
                               torch.device("cuda"))
    assert [c for c in cands if c["alg"] == "pallas"] == [
        {"alg": "pallas", "n": 4096, "radices": [64, 64], "vpu": "all"}]
    assert "pallas4" in {c["alg"] for c in cands}
    est = pl._candidates_c2c(4096, np.float32, kinds.PATIENCE_ESTIMATE, 64,
                             torch.device("cuda"))
    assert all(c["alg"] != "pallas" for c in est)


@pytest.mark.parametrize("device,debug,raises", [
    ("cpu", False, False), ("cpu", True, True), ("cuda", False, True)])
def test_measure_failure_raises_on_cuda(device, debug, raises, monkeypatch):
    """A MEASURE candidate that fails (say, a kernel that does not build)
    is counted and dropped on the CPU unless ``config.debug`` is set, and
    always re-raises on a CUDA device, so a CUDA plan never falls back to a
    plain PyTorch solver unnoticed.  No tensor is made: the candidate fails
    while it is built."""
    def broken(kind, desc, n, rdtype, batch, dev):
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(planner, "_measure_fn", broken)
    monkeypatch.setattr(config, "debug", debug)
    config.kernel_mode = "on"
    pl = _port_planner()
    cands = [{"alg": "pallas", "n": 1024, "radices": [64, 16]},
             {"alg": "pallas", "n": 1024, "radices": [32, 32]}]
    if raises:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            pl._measure_best("c2c", 1024, np.float32, cands, 64,
                             torch.device(device))
        assert pl.stats["nmeasure_failed"] == 0
    else:
        best, _ = pl._measure_best("c2c", 1024, np.float32, cands, 64,
                                   torch.device(device))
        assert best == cands[0]
        assert pl.stats["nmeasure_failed"] == 2
        assert "nvcc failed" in pl.stats["last_measure_error"]


@pytest.mark.cuda
def test_measure_plan_raises_when_kernel_build_fails(monkeypatch):
    """On the card: MEASURE with a kernel library that does not build
    raises instead of returning a plain PyTorch plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    from fftw3_tpu_torch.ops import _build

    def no_library():
        raise RuntimeError("nvcc failed (simulated)")
    monkeypatch.setattr(_build, "library", no_library)
    config.kernel_mode = "auto"
    config.measure_points = 1 << 16
    prob = plan_mod.Problem(shape=(64, 1024), axes=(1,), kind="c2c")
    with pytest.raises(RuntimeError, match="simulated"):
        plan_mod.make_plan(prob, kinds.MEASURE, planner=planner.Planner(),
                           device="cuda")


@pytest.mark.parametrize("seed", [1, 2])
def test_random_estimator_matches_reference(seed, monkeypatch):
    """FFTW_RANDOM_ESTIMATOR: both packages hash (seed, kind, sprint_desc)
    into the cost, so the same seed walks them to the same plans."""
    config.kernel_mode = "on"
    ref_config.pallas_mode = "interpret"
    monkeypatch.setattr(config, "random_estimator", seed)
    monkeypatch.setattr(ref_config, "random_estimator", seed)
    mine, ref = _port_planner(), ref_planner.Planner()
    for n in (60, 1000, 1024):
        assert mine.plan_c2c(n, np.float32, 0, 8, "cpu") == \
            ref.plan_c2c(n, np.float32, 0, 8)
    assert all(k.startswith(f":re{seed}") for k in mine.wisdom)


@pytest.mark.parametrize("kind,problem_kind", [("nosuch", "nosuch"),
                                               ("r2r", "dht"),
                                               ("DHT", "R2R")])
def test_other_kinds_not_ported(kind, problem_kind):
    """Every FFTW kind the reference plans is planned; a kind the port
    does not know raises ValueError, in the planner and in make_plan (the
    planner takes each r2r kind by name, a Problem takes "r2r")."""
    with pytest.raises(ValueError, match="unknown transform kind"):
        _port_planner()._plan(kind, 64, np.float32, 0, device="cpu")
    prob = plan_mod.Problem(shape=(4, 64), axes=(1,), kind=problem_kind)
    with pytest.raises(ValueError, match="unknown problem kind"):
        plan_mod.make_plan(prob, planner=_port_planner(), device="cpu")


def test_device_signature_names_device_and_versions():
    sig = planner._device_signature("cpu")
    assert sig.startswith("cpu-cpu-torch") and torch.__version__ in sig
    assert ":" not in sig and " " not in sig
