"""The work arithmetic against the port's harness's mflops convention,
and the problem grammar the configurations use."""
import importlib
import math

import pytest

from bench_torch import problem
from bench_torch.work import trailing2, transform
port_mflops = importlib.import_module("fftw3_tpu_torch.harness.mflops")
port_problem = importlib.import_module("fftw3_tpu_torch.harness.problem")


@pytest.mark.parametrize("text, batch, flops", [
    ("cf1024", 65536, 3.3554432e9),
    ("cf1024", 64, 3.2768e6),
    ("cf512x512x512", 1, 1.8119393280e10),
])
def test_transform_flops_and_bytes(text, batch, flops):
    prob = problem.parse(text).with_batch(batch)
    f, b = transform.work(prob, "complex64")
    assert f == pytest.approx(flops, rel=1e-12)
    assert b == 16 * prob.points           # 8 B a point in, 8 B out


@pytest.mark.parametrize("text", ["cf1024v65536", "cf512x512x512",
                                  "rf2048x2048v8", "k512e10v65536",
                                  "cb4096v4096", "k64e00"])
def test_transform_flops_equal_the_ports_mflops(text):
    """5 N log2 N (complex) or 2.5 N log2 N (real, r2r), as the port's
    harness scores a second of it."""
    ours = problem.parse(text)
    theirs = port_problem.parse_problem(text)
    assert ours.shape == theirs.shape and ours.axes == theirs.axes
    assert ours.kind == theirs.kind and ours.logical_n == theirs.logical_n
    f, _ = transform.work(ours, "float32" if ours.kind != "c2c"
                          else "complex64")
    assert f == pytest.approx(port_mflops.mflops(theirs, 1.0) * 1e6,
                              rel=1e-12)


def test_trailing_pair_pass():
    prob = problem.parse("cf512x512x512")
    f, b = trailing2.work(prob, "complex64")
    assert f == pytest.approx(5 * 512 ** 3 * math.log2(512 * 512))
    assert b == 16 * 512 ** 3


def test_batch_of_one_is_a_single_transform():
    prob = problem.parse("cf512x512x512").with_batch(1)
    assert prob.shape == (512, 512, 512) and prob.axes == (0, 1, 2)
    prob = problem.parse("cf1024").with_batch(64)
    assert prob.shape == (64, 1024) and prob.axes == (1,)
    assert prob.sign == problem.FORWARD


def test_parser_rejects_junk():
    with pytest.raises(ValueError):
        problem.parse("cf1024q")
