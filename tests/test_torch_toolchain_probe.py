"""fftw3_tpu_torch.toolchain_probe (P1, the build-and-launch canary) against
fftw3_tpu.toolchain_probe.

Without CUDA the probes report SKIP and record nothing, as the reference's
do off the TPU (``tests/test_round5_fixes.py``); the twin computes G @ x;
the kernel's C entry point is bound.  Tests marked ``cuda`` run the probe
and the kernel on the card.
"""
import ctypes
import io

import numpy as np
import pytest
import torch

from fftw3_tpu import toolchain_probe as ref_probe

from fftw3_tpu_torch import toolchain_probe
from fftw3_tpu_torch.ops import _build


@pytest.fixture(autouse=True)
def _fresh():
    toolchain_probe.RESULTS = None
    yield
    toolchain_probe.RESULTS = None


def _relerr(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_probes_skip_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    assert toolchain_probe.run_probes(out) == {}
    assert out.getvalue() == \
        "# toolchain-probe build_launch: SKIP (no CUDA device)\n"
    assert not toolchain_probe.passed("build_launch")
    assert toolchain_probe.run_probes(out) is toolchain_probe.RESULTS
    assert out.getvalue().count("SKIP") == 1          # once per process


def test_skip_matches_reference_off_its_device():
    """Both packages skip off their device: {} and no gate passes."""
    ref_probe.RESULTS = None
    try:
        assert ref_probe.run_probes(io.StringIO()) == {}
        assert not ref_probe.passed("x64_ambient")
    finally:
        ref_probe.RESULTS = None
    if not torch.cuda.is_available():
        assert toolchain_probe.run_probes(io.StringIO()) == {}


def test_failing_probe_reports_fail(monkeypatch):
    """A probe that raises counts as FAIL with its first line shown."""
    def broken():
        raise RuntimeError("nvcc failed (1): probe.cu\nmore")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(toolchain_probe, "_PROBES",
                        [("build_launch", broken)])
    out = io.StringIO()
    assert toolchain_probe.run_probes(out) == {"build_launch": False}
    assert "(build_launch: nvcc failed (1): probe.cu)" in out.getvalue()
    assert "build_launch: FAIL" in out.getvalue()
    assert not toolchain_probe.passed("build_launch")


@pytest.mark.parametrize("n", [1, 16, 37, 128])
def test_twin_equals_numpy(n):
    rng = np.random.default_rng(n)
    g = rng.standard_normal((n, n)).astype(np.float32)
    x = rng.standard_normal((n, n)).astype(np.float32)
    y = toolchain_probe.matmul_torch(torch.from_numpy(g),
                                     torch.from_numpy(x))
    assert y.dtype == torch.float32 and tuple(y.shape) == (n, n)
    assert _relerr(y.numpy(), g.astype(np.float64) @ x) <= 1e-6
    assert _relerr(y.numpy(), g @ x) <= 1e-6
    eye = toolchain_probe.matmul_torch(torch.eye(n), torch.from_numpy(x))
    assert np.array_equal(eye.numpy(), x)


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a tensor that is not on the card the kernel wrapper raises; the
    twin is a function of its own, called by name."""
    g = torch.eye(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        toolchain_probe.matmul_cuda(g, g)


def test_entry_point_is_bound():
    sig = _build.SIGNATURES["probe_matmul_launch"]
    assert sig == [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    src = _build.CSRC / "probe.cu"
    assert src in _build.sources()
    assert 'extern "C" int probe_matmul_launch(' in src.read_text()


@pytest.mark.cuda
def test_probe_passes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    before = toolchain_probe.launches
    out = io.StringIO()
    assert toolchain_probe.run_probes(out) == {"build_launch": True}
    assert "build_launch: PASS" in out.getvalue()
    assert toolchain_probe.passed("build_launch")
    assert toolchain_probe.launches - before == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 128, 300])
def test_kernel_equals_twin_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    rng = np.random.default_rng(n)
    g = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    y = toolchain_probe.matmul_cuda(g.cuda(), x.cuda())
    torch.cuda.synchronize()
    want = g.double().numpy() @ x.double().numpy()
    assert _relerr(y.cpu().numpy(), want) <= 1e-5
    assert _relerr(y.cpu().numpy(),
                   toolchain_probe.matmul_torch(g, x).numpy()) <= 1e-5
