"""The harness core: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration (a file of ``configs/``: the FFTW problem,
its precision and its plain reference) and a traffic mix (a file of
``traffic/``: the batch, the entry point, the call pattern).  The run
loads the port, plans the problem, makes its inputs on the device from the
seed, warms the plan up, drives the entry for the window, checks what the
window's calls produced against the float64 reference, and reads each of
the cell's metrics with the reader its file in ``metrics/`` names.  Every
name is looked up in those files; this module holds no cell's.
"""
from __future__ import annotations

import collections
import importlib
import json
import math
import random
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import problem as problem_mod
from . import trace as trace_mod

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
#: elements a block of the comparison holds
CHECK_BLOCK = 1 << 24


@dataclass
class Bench:
    """``BENCHMARK.json`` and the data files beside it under ``data``."""
    spec: dict
    data: Path = HERE

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for cfg in self.spec["configs"]:
            if cfg["name"] == name:
                return json.loads((self.data.parent / cfg["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def file(self, kind: str, name: str) -> dict:
        return json.loads((self.data / kind / f"{name}.json").read_text())

    def metrics(self, cell: dict, traced: bool) -> List[dict]:
        """The cell's end-to-end metrics, or with `traced` its per-layer
        ones: those whose ``workloads`` name it, or that name none and
        (per-layer) move an end-to-end metric the cell reports."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])]
        if not traced:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell["name"] in m.get("workloads", ()) or (
                    "workloads" not in m and m["moves"] in reported)]


def load(root: Path = ROOT) -> Bench:
    return Bench(json.loads((root / "BENCHMARK.json").read_text()),
                 root / HERE.name)


class _HostEvent:
    """Stands in for a CUDA event on the CPU, where every op is done when
    it returns (the harness's tests run there)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class Clock:
    def __init__(self, torch, device):
        self._torch, self.cuda = torch, device.type == "cuda"

    def event(self):
        return (self._torch.cuda.Event(enable_timing=True) if self.cuda
                else _HostEvent())

    def synchronize(self):
        if self.cuda:
            self._torch.cuda.synchronize()


@dataclass
class Run:
    """What the metric readers read."""
    bench: Bench
    problem: problem_mod.Problem
    dtype: str
    device_name: str
    setup_s: float
    calls: int = 0
    window_s: float = 0.0
    series: Dict[str, list] = field(default_factory=dict)
    trace: Optional[trace_mod.Trace] = None

    def work(self, name: str):
        mod = importlib.import_module(f"{__package__}.work.{name}")
        return mod.work(self.problem, self.dtype)

    def kernels(self, name: str) -> List[str]:
        return self.bench.file("kernels", name)["patterns"]

    def complete_trace(self) -> Optional[trace_mod.Trace]:
        if self.trace is None or not self.trace.complete(self.kernels("port")):
            return None
        return self.trace

    def peaks(self) -> Optional[dict]:
        slug = re.sub(r"[^A-Za-z0-9_.-]", "_", self.device_name)
        try:
            return self.bench.file("peaks", slug)
        except FileNotFoundError:
            return None


def make_input(torch, problem, seed: int, j: int, device):
    """Input `j` of the pool: real and imaginary parts uniform in
    [-0.5, 0.5), drawn on `device` from the seed in one call."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed << 8) + j) & (2 ** 64 - 1))
    x = torch.rand((*problem.shape, 2), generator=g, device=device) - 0.5
    return torch.view_as_complex(x)


def _counted(bench: Bench) -> int:
    """The program's launch counters of its kernels, summed."""
    total = 0
    for ref in bench.file("kernels", "port")["counters"]:
        mod, attr = ref.split(":")
        total += getattr(importlib.import_module(mod), attr)
    return total


def _max_err(torch, y, ref) -> float:
    """max |y - ref| / max |ref| over every element, in float64; inf for
    a wrong shape or a value that is not finite."""
    if tuple(y.shape) != tuple(ref.shape):
        return math.inf
    y, ref = y.reshape(-1), ref.reshape(-1)
    diff = scale = 0.0
    for a in range(0, ref.numel(), CHECK_BLOCK):
        r = ref[a:a + CHECK_BLOCK]
        d = (y[a:a + CHECK_BLOCK].to(torch.complex128) - r).abs().max().item()
        if not math.isfinite(d):
            return math.inf
        diff, scale = max(diff, d), max(scale, r.abs().max().item())
    return diff / scale


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda",
             t_start: Optional[float] = None, system: str = "program",
             hook: Optional[Callable] = None,
             log: Callable = print) -> dict:
    """One run of cell `name`; returns the result line as a dict.

    `system` is ``"program"`` (the port) or ``"control"`` (the
    configuration's reference in the precision below, in the port's
    place).  `hook(plan)` may alter the plan before the window (the tests
    break it there)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    mix = bench.file("traffic", cell["traffic"])
    limits = bench.file("limits", name)
    prob = problem_mod.parse(cfg["problem"]).with_batch(mix["batch"])
    dtype = cfg["dtype"]
    entry = importlib.import_module(f"{__package__}.entries.{mix['entry']}")
    loop = importlib.import_module(f"{__package__}.loops.{mix['loop']}")
    ref_mod = importlib.import_module(
        f"{__package__}.references.{cfg['reference']}")

    stamps = {"torch": time.perf_counter() - t_start}
    import torch
    import fftw3_tpu_torch as ft
    dev = torch.device(device)
    clock = Clock(torch, dev)
    stamps["program"] = time.perf_counter() - t_start
    if dev.type == "cuda":
        from fftw3_tpu_torch.ops import _build
        _build.library()
    stamps["library"] = time.perf_counter() - t_start
    flags = {"estimate": ft.ESTIMATE, "measure": ft.MEASURE}[mix["flags"]]
    plan = None
    if system == "control":
        fn = entry.wrap(lambda x: ref_mod.control(x, prob.axes, prob.sign))
    else:
        plan = entry.plan(ft, prob, dtype, flags, dev)
        if hook is not None:
            hook(plan)
        fn = entry.bind(ft, plan)
    stamps["plan"] = time.perf_counter() - t_start
    pool = [entry.args(make_input(torch, prob, seed, j, dev))
            for j in range(mix["inputs"])]
    clock.synchronize()
    stamps["inputs"] = time.perf_counter() - t_start
    # warm-up holds as many outputs as the window's sample does, so that
    # the allocator has its blocks before the window
    held = collections.deque(maxlen=mix["checked_calls"])
    for j in range(mix["warmup_calls"]):
        held.append(fn(*pool[j % len(pool)]))
    clock.synchronize()
    del held
    setup_s = time.perf_counter() - t_start
    stamps["warmup"] = setup_s

    rng, kept, k = random.Random(seed), {}, mix["checked_calls"]

    def keep(i, out):                  # reservoir sample of the calls
        slot = i if i < k else rng.randrange(i + 1)
        if slot < k:
            kept[slot] = (i, out)

    run = Run(bench, prob, dtype, torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu", setup_s)
    launches0 = _counted(bench)
    calls = failed = 0
    error = traced_part = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        tseconds = min(mix["trace_seconds"], seconds / 2)
        with profile(activities=acts) as prof:
            traced_part = loop.run(fn, pool, tseconds, keep, 0, clock,
                                   lambda: record_function(trace_mod.WINDOW))
        run.trace = trace_mod.read(prof, traced_part["calls"],
                                   _counted(bench) - launches0)
        del prof
        seconds -= traced_part["window_s"]
        calls = traced_part["calls"]
        failed, error = traced_part["failed"], traced_part["error"]
    rest = loop.run(fn, pool, seconds, keep, calls, clock)
    run.calls = rest["calls"]
    run.window_s = rest["window_s"]
    run.series = rest["series"]
    calls += rest["calls"]
    failed += rest["failed"]
    error = error or rest["error"]
    launches = _counted(bench) - launches0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    log(f"plan: {plan!r}" if plan is not None else f"system: {system}")
    log("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in stamps.items()))
    log(f"window: {calls} calls ({failed} failed) in "
        f"{run.window_s + (traced_part or {}).get('window_s', 0):.3f} s; "
        f"{launches / max(calls, 1):g} launches of the port's kernels a call")
    if error:
        log(f"first failure: {error}")

    metrics = {}
    for m in bench.metrics(cell, traced):
        spec = bench.file("metrics", m["name"])
        reader = importlib.import_module(
            f"{__package__}.readers.{spec['reader']}")
        value = reader.read(run, spec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"attempted": calls, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": run.device_name, "count": 1,
                         "memory_peak_bytes": peak}}
    if traced and run.trace is not None:
        if run.complete_trace() is None:
            log(f"trace incomplete: {run.trace.count(run.kernels('port'))} "
                f"of {run.trace.launches} launches recorded")
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()

    # the check, once the window has closed and the peak is read: the
    # program's state is freed, the reference made from the seed anew
    samples = sorted(kept.values(), key=lambda s: s[0])
    del fn, plan, pool, kept, run
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    errs = []
    for j in sorted({i % mix["inputs"] for i, _ in samples}):
        ref = ref_mod.reference(make_input(torch, prob, seed, j, dev),
                                prob.axes, prob.sign)
        errs += [_max_err(torch, entry.output(out), ref)
                 for i, out in samples if i % mix["inputs"] == j]
        del ref
    checks = {"max_err": max(errs, default=math.inf)}
    log(f"checked calls {[i for i, _ in samples]}: max_err {errs}")
    result["correct"] = failed == 0 and all(
        checks[key] <= lim["limit"] for key, lim in limits.items())
    result["checks"] = {
        key: {"value": checks[key] if math.isfinite(checks[key]) else None,
              "limit": lim["limit"]} for key, lim in limits.items()}
    return {key: result[key] for key in ("correct", "attempted", "failed",
                                         "metrics", "device", "breakdown",
                                         "checks") if key in result}
