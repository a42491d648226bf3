"""BENCHMARK.json against the benchmark's contract, and every name in it
found in the files beside it: nothing in the harness's code names a
cell, a configuration, a mix or a metric."""
import importlib
import json
import re
import shutil
from pathlib import Path

import pytest

from bench_torch import core, problem

BENCH = core.load()
SPEC = BENCH.spec
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in SPEC["end_to_end"]}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench_torch"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert "setup_s" in E2E


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["reduced"] == []
    assert entry["file"].startswith("bench_torch/configs/")
    cfg = BENCH.config(entry["name"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    problem.parse(cfg["problem"])
    importlib.import_module(f"bench_torch.references.{cfg['reference']}")


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1
    assert len(cell["why"]) <= 200
    mix = BENCH.file("traffic", cell["traffic"])
    importlib.import_module(f"bench_torch.entries.{mix['entry']}")
    importlib.import_module(f"bench_torch.loops.{mix['loop']}")
    assert set(BENCH.file("limits", cell["name"])) == {"max_err"}
    e2e = {m["name"] for m in BENCH.metrics(cell, False)}
    per_layer = BENCH.metrics(cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    assert all(m["moves"] in e2e for m in per_layer)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in SPEC["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if metric["name"] in E2E:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in E2E and "workloads" in metric
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"
    spec = BENCH.file("metrics", metric["name"])
    reader = importlib.import_module(f"bench_torch.readers.{spec['reader']}")
    assert callable(reader.read)
    for key in ("kernels",):
        if key in spec:
            assert BENCH.file("kernels", spec[key])["patterns"]
    if "work" in spec:
        importlib.import_module(f"bench_torch.work.{spec['work']}")


def test_layers_are_named_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"API / plan", "kernels", "device"}


def test_peaks_of_the_card():
    peaks = BENCH.file("peaks", "NVIDIA_H100_80GB_HBM3")
    assert peaks["bytes_per_s"] == 3.35e12
    assert peaks["flops_per_s"]["complex64"] == 6.7e13


def test_additions_are_files_only(tmp_path):
    """A configuration, a mix, a cell and a per-layer metric are added as
    new files and new entries of BENCHMARK.json, no code edited."""
    data = tmp_path / "bench_torch"
    shutil.copytree(BENCH.data, data,
                    ignore=shutil.ignore_patterns("__pycache__", "*.py",
                                                  "tests", "tools"))
    (data / "configs" / "cf4096.json").write_text(json.dumps(
        {"name": "cf4096", "problem": "cf4096", "dtype": "complex64",
         "reference": "dft_c2c"}))
    (data / "traffic" / "v4096-split.json").write_text(json.dumps(
        {"batch": 4096, "entry": "split", "loop": "stream",
         "flags": "estimate", "inputs": 2, "warmup_calls": 4,
         "checked_calls": 3, "trace_seconds": 2}))
    (data / "limits" / "cf4096-v4096.split.json").write_text(
        json.dumps({"max_err": {"limit": 1e-5}}))
    (data / "metrics" / "k1_share.json").write_text(json.dumps(
        {"reader": "device_time", "kernels": "k1"}))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "cf4096", "source": "x",
                            "file": "bench_torch/configs/cf4096.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "cf4096-v4096.split",
                              "config": "cf4096", "traffic": "v4096-split",
                              "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "k1_share", "unit": "ms",
                              "better": "lower", "source": "device_trace",
                              "layer": "kernels", "moves": "gflops"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = core.load(Path(tmp_path))
    cell = bench.cell("cf4096-v4096.split")
    assert bench.config("cf4096")["problem"] == "cf4096"
    assert "k1_share" in {m["name"] for m in bench.metrics(cell, True)}
    assert "gflops" in {m["name"] for m in bench.metrics(cell, False)}
