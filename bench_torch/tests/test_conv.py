"""The FFT filtering cell's files on the CPU at a tiny size: a real problem
through the ``conv`` entry (the r2c plan, the phase-only filter in place,
the c2r plan) is ``correct`` for the port, and not for the control or any
fault planted under the entry; the work of K4's, K6's and K2's passes;
the spans read per harness call of two plans."""
import json
import shutil

import pytest

from bench_torch import core, faults, problem
from bench_torch.readers import program_span_call
from bench_torch.work import c2r_rows, conv_k2, r2c_rows

REAL = "rf2048x2048-v8.conv"
TINY = "t.conv"
NEW = ("k4_roofline", "k6_roofline", "conv.k2_roofline",
       "conv.convert_span_ms")


@pytest.fixture
def conv_bench(tmp_path):
    """The real benchmark's data files with a tiny real configuration and
    its ``conv`` mix beside them, held to the real cell's limit."""
    real = core.load()
    data = tmp_path / core.HERE.name
    for sub in ("metrics", "kernels", "peaks"):
        shutil.copytree(real.data / sub, data / sub)
    for sub in ("configs", "traffic", "limits"):
        (data / sub).mkdir()
    (data / "configs" / "rf32x64.json").write_text(json.dumps(
        {"name": "rf32x64", "problem": "rf32x64", "dtype": "float32",
         "reference": "phase_filter"}))
    (data / "traffic" / "v2-conv.json").write_text(json.dumps(
        {"batch": 2, "entry": "conv", "loop": "stream", "flags": "estimate",
         "inputs": 2, "warmup_calls": 2, "checked_calls": 3,
         "trace_seconds": 0.1}))
    shutil.copy(real.data / "limits" / f"{REAL}.json",
                data / "limits" / f"{TINY}.json")
    spec = json.loads(json.dumps(real.spec))
    spec["configs"].append({"name": "rf32x64", "source": "test",
                            "file": f"{data.name}/configs/rf32x64.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": TINY, "config": "rf32x64",
                              "traffic": "v2-conv", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(TINY)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return core.load(tmp_path)


def run(bench, traced=False, **kw):
    return core.run_cell(bench, TINY, 2 ** 33 + 5, 0.3, traced, "cpu",
                         log=lambda *_: None, **kw)


@pytest.mark.parametrize("traced", [False, True])
def test_port_is_correct(conv_bench, cpu_port, traced):
    line = run(conv_bench, traced)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in conv_bench.metrics(conv_bench.cell(TINY),
                                                  traced)}
    assert set(NEW) <= want if traced else not set(NEW) & want
    # on the CPU: no peaks for the rooflines, no events for the spans
    assert set(line["metrics"]) == want - set(NEW)
    check = line["checks"]["max_err"]
    assert check["value"] < check["limit"] / 10
    json.dumps(line, allow_nan=False)


def test_control_fails(conv_bench, cpu_port):
    line = run(conv_bench, system="control")
    assert line["correct"] is False
    assert line["checks"]["max_err"]["value"] > 10 * \
        line["checks"]["max_err"]["limit"]


@pytest.mark.parametrize("fault", faults.applicable(
    problem.parse("rf32x64").with_batch(2)))
def test_fault_fails(conv_bench, cpu_port, fault):
    """Each fault, planted in the c2r plan that the call runs last, changes
    the output the comparison sees."""
    line = run(conv_bench, hook=faults.hook(fault))
    assert line["correct"] is False


def test_faults_are_all_applicable():
    assert faults.applicable(problem.parse("rf2048x2048").with_batch(8)) \
        == ["unchanged", "half_batch", "altered"]


CELL = problem.parse("rf2048x2048").with_batch(8)
HALF = 8 * 2048 * 1025


@pytest.mark.parametrize("mod", [r2c_rows, c2r_rows])
def test_real_row_passes(mod):
    """4 B read a real point and 8 B written a half-spectrum point (or the
    reverse), 2.5 n log2 n flops a row of n = 2048."""
    flops, nbytes = mod.work(CELL, "float32")
    assert flops == 2.5 * 8 * 2048 * 2048 * 11
    assert nbytes == 4 * 8 * 2048 * 2048 + 8 * HALF == 268566528
    assert mod.work(CELL, "float64")[1] == 2 * nbytes


def test_axis_minus_two_passes():
    """Two passes over the half spectrum, each reading and writing 8 B a
    point with 5 log2 2048 flops a point: 0.160 ms of bytes at 3.35 TB/s."""
    flops, nbytes = conv_k2.work(CELL, "float32")
    assert flops == 2 * 5 * HALF * 11
    assert nbytes == 2 * 16 * HALF
    assert nbytes / 3.35e12 == pytest.approx(0.1604e-3, rel=1e-3)


@pytest.mark.parametrize("mod", [r2c_rows, c2r_rows, conv_k2])
def test_no_real_axis_is_refused(mod):
    with pytest.raises(ValueError):
        mod.work(problem.parse("cf1024").with_batch(64), "complex64")


class _Window:
    start, end, calls = 100, 200, 4


class _Run:
    trace = _Window()


#: four harness calls, each an r2c root (its combine) and a c2r root (its
#: split); one of each timed
SNAP = {"calls": 8, "timed_calls": 2, "dropped": 0,
        "spans": {"fftw.execute": {"count": 8, "host_ms": 1.0, "timed": 2,
                                   "device_ms": None},
                  "fftw.convert.combine": {"count": 4, "host_ms": 0.1,
                                           "timed": 1, "device_ms": 0.1},
                  "fftw.convert.split": {"count": 4, "host_ms": 0.1,
                                         "timed": 1, "device_ms": 0.3}},
        "counters": {}}


def test_spans_read_per_harness_call(monkeypatch):
    """The conversions of one harness call: r2c's combine plus c2r's split,
    where the per-root reading would give half of that."""
    from fftw3_tpu_torch import trace
    seen = []

    def snapshot(reset=False, within=None):
        seen.append(within)
        return SNAP
    monkeypatch.setattr(trace, "snapshot", snapshot)
    params = {"prefix": "fftw.convert."}
    assert program_span_call.read(_Run(), params) == pytest.approx(0.4)
    assert set(seen) == {(100, 200)}
    monkeypatch.setattr(_Window, "calls", 0)
    assert program_span_call.read(_Run(), params) is None
    untimed = dict(SNAP, timed_calls=0)
    monkeypatch.setattr(trace, "snapshot", lambda **kw: untimed)
    monkeypatch.setattr(_Window, "calls", 4)
    assert program_span_call.read(_Run(), params) is None
    assert program_span_call.read(type("R", (), {"trace": None})(),
                                  params) is None
