"""A benchmark of tiny cells beside the real one, for the CPU: the real
data files (metrics, kernel maps, peaks) with configurations, mixes and
limits of a size a test run holds, each cell held to the limit of the
real cell it stands for."""
from __future__ import annotations

import json
import shutil

import pytest

from bench_torch import core

#: tiny cell -> (configuration, problem, mix, batch, entry, loop, real cell)
TINY = {
    "t.execute": ("cf64", "cf64", "v8-execute", 8, "execute", "stream",
                  "cf1024-v65536.execute"),
    "t.split": ("cf64", "cf64", "v8-split", 8, "split", "stream",
                "cf1024-v65536.split"),
    "t.3d": ("cf8x8x8", "cf8x8x8", "v1-execute", 1, "execute", "stream",
             "cf512x512x512.execute"),
}


@pytest.fixture
def cpu_port(monkeypatch):
    """The port's plans on the CPU, its kernel solvers' twins offered."""
    import fftw3_tpu_torch as ft
    monkeypatch.setattr(ft.config, "device", "cpu")
    monkeypatch.setattr(ft.config, "kernel_mode", "on")
    return ft


@pytest.fixture
def tiny_bench(tmp_path):
    real = core.load()
    data = tmp_path / core.HERE.name
    for sub in ("metrics", "kernels", "peaks"):
        shutil.copytree(real.data / sub, data / sub)
    for sub in ("configs", "traffic", "limits"):
        (data / sub).mkdir()
    spec = json.loads(json.dumps(real.spec))
    for name, (cfg, prob, mix, batch, entry, loop, like) in TINY.items():
        (data / "configs" / f"{cfg}.json").write_text(json.dumps(
            {"name": cfg, "problem": prob, "dtype": "complex64",
             "reference": "dft_c2c"}))
        (data / "traffic" / f"{mix}.json").write_text(json.dumps(
            {"batch": batch, "entry": entry, "loop": loop,
             "flags": "estimate", "inputs": 2, "warmup_calls": 2,
             "checked_calls": 3, "trace_seconds": 0.1}))
        shutil.copy(real.data / "limits" / f"{like}.json",
                    data / "limits" / f"{name}.json")
        if cfg not in {c["name"] for c in spec["configs"]}:
            spec["configs"].append({"name": cfg, "source": "test",
                                    "file": f"{data.name}/configs/{cfg}.json",
                                    "reduced": [], "why": "test"})
        spec["workloads"].append({"name": name, "config": cfg,
                                  "traffic": mix, "chips": 1, "why": "test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return core.load(tmp_path)
