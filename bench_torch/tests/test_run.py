"""Whole runs on the CPU at tiny sizes: the result line's keys, the
comparison that decides ``correct`` passing the port and failing the
control and every fault planted in the timed path, and the command
refusing to run without a card."""
import json
import subprocess
import sys

import pytest

from bench_torch import core, faults, problem

from .conftest import TINY


def run(bench, cell, traced=False, **kw):
    return core.run_cell(bench, cell, 2 ** 33 + 7, 0.3, traced, "cpu",
                         log=lambda *_: None, **kw)


@pytest.mark.parametrize("cell", TINY)
@pytest.mark.parametrize("traced", [False, True])
def test_line(tiny_bench, cpu_port, cell, traced):
    line = run(tiny_bench, cell, traced)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in tiny_bench.metrics(tiny_bench.cell(cell),
                                                  traced)}
    # the rooflines need a card's peaks
    assert set(line["metrics"]) <= want
    if not traced:
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    check = line["checks"]["max_err"]
    assert check["value"] < check["limit"]
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("cell", TINY)
def test_control_fails(tiny_bench, cpu_port, cell):
    line = run(tiny_bench, cell, system="control")
    assert line["correct"] is False
    assert line["checks"]["max_err"]["value"] > 10 * \
        line["checks"]["max_err"]["limit"]


CASES = [(cell, f) for cell, t in TINY.items()
         for f in faults.applicable(problem.parse(t[1]).with_batch(t[3]))]


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_fails(tiny_bench, cpu_port, cell, fault):
    line = run(tiny_bench, cell, hook=faults.hook(fault))
    assert line["correct"] is False


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no line:
    nothing runs on the CPU in the card's place."""
    res = subprocess.run(
        [sys.executable, "-m", "bench_torch.run", "--workload",
         "cf1024-v65536.execute", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=core.ROOT)
    assert res.returncode != 0
    assert "{" not in res.stdout


def test_imports_neither_jax_nor_the_reference_package(tiny_bench, cpu_port):
    run(tiny_bench, "t.execute")
    code = ("import sys, bench_torch.run, bench_torch.core, fftw3_tpu_torch;"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'fftw3_tpu', 'bench')))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=core.ROOT)
    assert res.stdout.strip() == "[]", res.stderr
