"""``fftw3_tpu_torch.harness`` and ``tools`` against ``fftw3_tpu``'s.

The problem grammar field by field, mflops, ``verify_problem`` on the
reference's ``PROBLEMS`` list (``tests/test_harness.py``) and on planted
bugs, paranoid mode seeing the reference's planner keys, the fuzzer's
problem strings for three seeds, the accuracy columns, the CLI's output
shape and its refusals, ``tools.wisdom`` and ``tools.wisdom_to_conf``;
the planner's ``hook``, ``build_apply`` and counters beside the
reference's.  The port runs on the CPU (kernel twins, the planner on the
reference's hardware constants), the reference with Pallas in interpret
mode.
"""
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftw3_tpu as ref_ft
from fftw3_tpu import config as ref_config
from fftw3_tpu import planner as ref_planner
from fftw3_tpu.harness import fuzz as ref_fuzz
from fftw3_tpu.harness.mflops import mflops as ref_mflops
from fftw3_tpu.harness import problem as ref_problem
from fftw3_tpu.harness.accuracy import accuracy_test as ref_accuracy
from fftw3_tpu.harness.cli import main as ref_cli
from fftw3_tpu.harness.paranoid import paranoid as ref_paranoid
from fftw3_tpu.tools import wisdom as ref_wisdom_tool

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import config
from fftw3_tpu_torch import kinds as K
from fftw3_tpu_torch import planner as planner_mod
from fftw3_tpu_torch.harness import (VerificationError, acmp, fuzz, mflops,
                                     parse_problem, verify_problem)
from fftw3_tpu_torch.harness import problem, verify
from fftw3_tpu_torch.harness.accuracy import accuracy_test
from fftw3_tpu_torch.harness.cli import main as cli
from fftw3_tpu_torch.harness.paranoid import (ParanoiaError,
                                              check_descriptor, paranoid)
from fftw3_tpu_torch.planner import HardwareModel
from fftw3_tpu_torch.tools import wisdom as wisdom_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    """Kernels on in both packages, the port's planner on the reference's
    hardware constants, no wisdom, the port on the CPU."""
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(ft.the_planner, "hw", HardwareModel(
        **dataclasses.asdict(ref_planner.HW)))
    monkeypatch.setattr(ft.the_planner, "wisdom", {})
    monkeypatch.setattr(ref_planner.the_planner, "wisdom", {})


PARSE = ["c1024", "ib256", "32x64", "ocf1024", "r256", "rb256", "c4k",
         "c1m", "k10e10x512o11", "k128f", "k128h", "k128b", "c1024v64",
         "k8e00", "k512e10v4096", "c64:32x32", "/c1024v65536", "dtc64x64",
         "i+128", "o-128", "r2048x2048v8", "c256x256x256",
         "k16o01x8e11v3", "c10*4x2", "[]c64", "rb229v8", "k1000e01",
         "c1000v32768"]
UNSUPPORTED = ["c64:2", "c64x32:7", "k16:3e10"]
JUNK = ["c64q", "x", "c", "c64v", "[c64]"]


def _fields(p):
    return (p.kind, p.sizes, p.sign, tuple(k.value for k in p.r2r_kinds),
            p.batch, p.in_place, p.split, p.destroy_input, p.transposed,
            p.pstring, p.shape, p.axes, p.logical_n, p.nbatch)


@pytest.mark.parametrize("s", PARSE)
def test_parse_problem_equals_reference(s):
    got, want = parse_problem(s), ref_problem.parse_problem(s)
    assert _fields(got) == _fields(want)
    for t in (1e-3, 0.5, 2.0):
        assert mflops(got, t) == ref_mflops(want, t)


@pytest.mark.parametrize("s", UNSUPPORTED + JUNK)
def test_parse_problem_raises_where_reference_raises(s):
    with pytest.raises(ValueError) as ref_exc:
        ref_problem.parse_problem(s)
    with pytest.raises(ValueError) as exc:
        parse_problem(s)
    assert isinstance(exc.value, problem.UnsupportedProblem) \
        == isinstance(ref_exc.value, ref_problem.UnsupportedProblem)


def test_acmp():
    a = np.array([1.0, 2.0, 3.0])
    assert acmp(a, a + 1e-7, 1e-3) < 1e-3
    assert acmp(torch.from_numpy(a), a + 1e-7, 1e-3) < 1e-3
    with pytest.raises(VerificationError):
        acmp(a, a + 1.0, 1e-3)


#: the reference's PROBLEMS list (tests/test_harness.py) and its batched
#: c2r regressions
PROBLEMS = ["c64", "cb64", "c60", "c13", "ic128", "32x16", "r64", "r63",
            "rb64", "k64f", "k64b", "k64h", "k32e10x12e01", "k16o00",
            "c16v4", "k20e11", "k24o10", "k12o11", "orb229v8", "rb64v4"]


@pytest.mark.parametrize("pstring", PROBLEMS)
def test_verify_problem(pstring):
    res = verify_problem(pstring, rounds=2)
    assert res.max_err < 1e-3
    assert set(res.tests) >= {"impulse", "linear"}


def test_verify_double_and_kernel_sizes():
    assert verify_problem("c128", rounds=2, rdtype="float64").max_err \
        < 1e-10
    for p in ("c256v3", "r512v2", "128x256", "rb256v2"):   # kernel twins
        assert verify_problem(p, rounds=1).max_err < 1e-3


def test_verify_catches_planted_bugs():
    class BrokenClosure(verify._Closure):
        def apply(self, x):
            return super().apply(x) * 1.01          # 1% systematic error

    res = verify.VerifyResult(problem="broken")
    rng = np.random.default_rng(0)
    cl = BrokenClosure(parse_problem("c64"), K.ESTIMATE, "float32")
    with pytest.raises(VerificationError):
        verify._impulse(cl, rng, 2, 1e-3, res)
    # the opposite sign passes the impulse and linearity, not the shifts
    cl = verify._Closure(parse_problem("c64"), K.ESTIMATE, "float32")
    cl.plan = ft.plan_dft((64,), sign=ft.BACKWARD)
    verify._impulse(cl, rng, 2, 1e-3, res)
    with pytest.raises(VerificationError, match="shift"):
        verify._tf_shift(cl, rng, 1, 1e-3, res)


def _key_fields(key):
    parts = key.split(":")
    return (parts[0], parts[1], parts[2], parts[-1])


def test_paranoid_sees_reference_keys(monkeypatch):
    monkeypatch.setattr(ref_config, "use_native", False)
    with ref_paranoid() as ref_seen:
        ref_ft.plan_dft((96,))
    with paranoid(device="cpu") as seen:
        ft.plan_dft((96,), device="cpu")
    assert len(seen) >= 2 and all(err < 1e-3 for _, err in seen)
    assert sorted(_key_fields(k) for k, _ in seen) \
        == sorted(_key_fields(k) for k, _ in ref_seen)
    assert ft.the_planner.hook is None


def test_check_descriptor_catches():
    with pytest.raises((ParanoiaError, ValueError, RuntimeError)):
        check_descriptor("c2c", 8, {"alg": "direct", "n": 16}, device="cpu")
    assert check_descriptor("c2r", 64, {"alg": "c2r_dense", "n": 64},
                            device="cpu") < 1e-3


@pytest.mark.parametrize("kind,n,desc", [
    ("c2c", 96, {"alg": "mixed", "n": 96, "p": 12,
                 "child": {"alg": "direct", "n": 8}}),
    ("c2c", 256, {"alg": "pallas", "n": 256, "radices": [256]}),
    ("r2c", 256, {"alg": "pallas_r2c", "n": 256, "radices": [128]}),
    ("c2r", 64, {"alg": "c2r_pack", "n": 64,
                 "child": {"alg": "direct", "n": 32}}),
    ("redft10", 32, {"alg": "r2r_matmul", "kind": "redft10", "n": 32}),
])
def test_build_apply_equals_reference(kind, n, desc):
    rng = np.random.default_rng(1)
    m = n // 2 + 1 if kind == "c2r" else n
    if kind in ("c2c", "c2r"):
        x = (rng.standard_normal((3, m))
             + 1j * rng.standard_normal((3, m))).astype(np.complex64)
        x[:, 0] = x[:, 0].real
    else:
        x = rng.standard_normal((3, n)).astype(np.float32)
    got = planner_mod.build_apply(kind, desc, np.float32, "cpu")(
        torch.from_numpy(x)).numpy()
    want = np.asarray(ref_planner.build_apply(kind, desc, np.float32)(
        jnp.asarray(x)))
    assert np.max(np.abs(got - want)) <= 2e-5 * np.max(np.abs(want))


def test_planner_counters_and_hook_equal_reference(monkeypatch):
    monkeypatch.setattr(ref_config, "use_native", False)
    ref = ref_planner.Planner()
    port = planner_mod.Planner(HardwareModel(
        **dataclasses.asdict(ref_planner.HW)))
    calls = {"ref": [], "port": []}
    ref.hook = lambda k, d, c: calls["ref"].append((k.split(":")[:3], d))
    port.hook = lambda k, d, c: calls["port"].append((k.split(":")[:3], d))
    ref.plan_c2c(96, np.float32, 0)
    port.plan_c2c(96, np.float32, 0, device="cpu")
    assert port.stats["pcost"] > 0 and port.stats["epcost"] > 0
    for k in ("nplan", "pcost", "epcost"):
        assert port.stats[k] == pytest.approx(ref.stats[k], rel=1e-12)
    assert calls["port"] == calls["ref"]


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("maxsize", [512, 64])
def test_random_problem_strings_equal_reference(seed, maxsize):
    rng, ref_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    got = [fuzz.random_problem_string(rng, maxsize) for _ in range(12)]
    want = [ref_fuzz.random_problem_string(ref_rng, maxsize)
            for _ in range(12)]
    assert got == want
    for s in got:
        assert _fields(parse_problem(s)) \
            == _fields(ref_problem.parse_problem(s))


def test_fuzz_bounded(capsys):
    assert fuzz.run_fuzz(count=8, seed=42, maxsize=128,
                         patience_flags=K.ESTIMATE) == 0
    assert fuzz.main(["--count", "3", "--seed", "1", "--maxsize", "64"]) == 0
    assert "fuzz: 3/3 passed" in capsys.readouterr().out


@pytest.mark.parametrize("pstring,rdtype,tol", [
    ("c128", "float32", 1e-4), ("c128", "float64", 1e-12),
    ("rb64", "float32", 1e-4), ("k64e10", "float32", 1e-4),
    ("r96x8", "float32", 1e-4)])
def test_accuracy_columns(pstring, rdtype, tol):
    res = accuracy_test(pstring, rdtype=rdtype)
    want = ref_accuracy(pstring, rdtype=rdtype)
    assert list(res.norms) == list(want.norms) == ["l1", "l2", "linf"]
    assert all(0 < v < tol for v in res.norms.values()), res
    assert all(v < tol for v in want.norms.values()), want
    assert repr(res).startswith(f"(accuracy {pstring} l1=")


def test_accuracy_cli(capsys):
    from fftw3_tpu_torch.harness.accuracy import main
    assert main(["c64", "r32"]) == 0
    assert capsys.readouterr().out.count("linf") == 2
    assert main([]) == 2


SPEED = re.compile(r"^Problem: (\S+), setup: \d+\.\d\d s, time: "
                   r"\d\.\d{3}e[+-]\d\d s, ``mflops'': [\d.e+]+$")


def test_cli_verify_and_speed_shape(capsys):
    assert cli(["-y", "c64", "-y", "r32", "-y", "k16e10", "-v", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in out] == ["c64", "r32", "k16e10"]
    assert cli(["-s", "c64", "-s", "/c64v4", "-s", "rb32x16",
                "-s", "k16e10v2", "-v", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    speed = [ln for ln in out if ln.startswith("Problem:")]
    assert [SPEED.match(ln).group(1) for ln in speed] \
        == ["c64", "/c64v4", "rb32x16", "k16e10v2"]
    assert sum(ln.startswith("(plan") for ln in out) == 4
    assert ref_cli(["-s", "c64"]) == 0
    assert SPEED.match(capsys.readouterr().out.splitlines()[0])
    assert cli(["--double", "--paranoid", "-y", "c32", "-v"]) == 0
    assert cli(["-y", "c64:3"]) == 1              # UnsupportedProblem
    assert "FAILED c64:3" in capsys.readouterr().err


@pytest.mark.parametrize("argv,what", [
    (["--dist", "4", "-y", "c64"], "distributed"),
    (["--dist-method", "ppermute", "-y", "c64"], "distributed"),
    (["-o", "nthreads=2", "-y", "c64"], "threads"),
    (["-o", "bogus"], "unknown")])
def test_cli_refuses_what_is_not_ported(argv, what, capsys):
    with pytest.raises(SystemExit) as exc:
        cli(argv)
    assert exc.value.code != 0
    assert what in capsys.readouterr().err


def test_cli_wisdom_option(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli(["-owisdom", "-oestimate", "-y", "c32"]) == 0
    data = json.loads((tmp_path / "wis.dat").read_text())
    assert data["format"] == planner_mod.WISDOM_FORMAT
    assert any(k.startswith("c2c:32:") for k in data["entries"])


def test_wisdom_tool_roundtrip(tmp_path, capsys):
    assert wisdom_tool.CANONICAL == ref_wisdom_tool.CANONICAL
    out = tmp_path / "wis.json"
    assert wisdom_tool.main(["-e", "-o", str(out), "c64", "r32",
                             "k16e10"]) == 0
    data = json.loads(out.read_text())
    assert data["format"] == planner_mod.WISDOM_FORMAT
    assert {k.split(":")[0] for k in data["entries"]} >= {"c2c", "r2c",
                                                          "redft10"}
    ft.forget_wisdom()
    assert ft.import_wisdom_from_filename(str(out))
    assert wisdom_tool.main(["-e", "-w", str(out), "c16"]) == 0
    assert json.loads(capsys.readouterr().out)["entries"]
    assert wisdom_tool.main(["-e", "-w", str(tmp_path / "none")]) == 1
    assert wisdom_tool.main(["-e", "c64:2"]) == 1


def test_wisdom_to_conf_roundtrip(tmp_path):
    ft.plan_dft_1d(64, device="cpu")
    wis = tmp_path / "w.json"
    wis.write_text(ft.export_wisdom_to_string())
    conf = tmp_path / "myconf.py"
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m",
                        "fftw3_tpu_torch.tools.wisdom_to_conf", "-w",
                        str(wis), "-o", str(conf)], capture_output=True,
                       cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr.decode()
    assert "import fftw3_tpu_torch\n" in conf.read_text()
    ft.forget_wisdom()
    spec = importlib.util.spec_from_file_location("myconf", conf)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert any(k.startswith("c2c:64:") for k in ft.the_planner.wisdom)
    # the reference's export is refused
    ref_ft.plan_dft_1d(64)
    wis.write_text(ref_ft.export_wisdom_to_string())
    from fftw3_tpu_torch.tools.wisdom_to_conf import main
    assert main(["-w", str(wis), "-o", str(conf)]) == 1
