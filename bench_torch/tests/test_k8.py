"""K8's share of its roofline in the Neumann cell
(``metrics/neumann.k8_roofline.json``): the work of a solve's six DCT
passes (``work/neumann_dct.py``) and the kernel map ``kernels/k8.json``
against the kernels of the port's sources."""
import math
import re
from pathlib import Path

import pytest

from bench_torch import core, problem
from bench_torch.work import neumann_dct

CSRC = Path(__file__).resolve().parents[2] / "fftw3_tpu_torch" / "csrc"
BENCH = core.load()


def test_six_passes_of_the_512_cube():
    """Six passes of 512^3 float32 points, each point read once and written
    once at 4 B, and 2.5 n log2 n flops a row at the physical n = 512."""
    prob = problem.parse("k512e10x512e10x512e10")
    flops, nbytes = neumann_dct.work(prob, "float32")
    assert flops == pytest.approx(1.812e10, rel=1e-3)
    assert nbytes == pytest.approx(6.442e9, rel=1e-3)
    assert flops == 6 * 2.5 * 512 ** 3 * 9
    assert nbytes == 6 * 8 * 512 ** 3
    assert nbytes / 3.35e12 == pytest.approx(1.923e-3, rel=1e-3)


def test_axes_of_other_lengths_and_double():
    prob = problem.parse("k16e10x12e10x8e10")
    flops, nbytes = neumann_dct.work(prob, "float64")
    pts = 16 * 12 * 8
    assert flops == pytest.approx(2 * 2.5 * pts * (4 + 3 + math.log2(12)))
    assert nbytes == 6 * 16 * pts


@pytest.mark.parametrize("text", ["cf1024", "rf2048x2048", "k64e00",
                                  "k512e10x512e01"])
def test_refuses_another_problem(text):
    with pytest.raises(ValueError):
        neumann_dct.work(problem.parse(text), "float32")


def test_the_map_names_a_kernel_of_the_sources():
    patterns = BENCH.file("kernels", "k8")["patterns"]
    names = set()
    for path in sorted(CSRC.glob("*.cu*")):
        names |= set(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(",
                                path.read_text(), flags=re.S))
    assert patterns == [r"\bredft_kernel\b"]
    assert "redft_kernel" in names
    for d, fixed in ((0, "true"), (1, "false")):
        assert re.search(patterns[0], f"void fftw3_tpu_torch::(anonymous "
                         f"namespace)::redft_kernel<{d}, {fixed}>(float "
                         f"const*, float*, float const*, "
                         f"fftw3_tpu_torch::LevelPlan, int, int, int)")
    assert not re.search(patterns[0], "fftw3_tpu_torch::r2c_kernel")


def test_the_metric_reads_k8_over_the_solve():
    spec = BENCH.file("metrics", "neumann.k8_roofline")
    assert spec == {"reader": "roofline", "kernels": "k8",
                    "work": "neumann_dct"}
    (entry,) = [m for m in BENCH.spec["per_layer"]
                if m["name"] == "neumann.k8_roofline"]
    assert entry["workloads"] == ["neumann512x512x512-v1.solve"]
    assert entry["layer"] == "kernels" and entry["moves"] == "gflops"
    cfg = BENCH.config(BENCH.cell(entry["workloads"][0])["config"])
    assert cfg["problem"] == "k512e10x512e10x512e10"
