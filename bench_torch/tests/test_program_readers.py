"""The readers of the program's own spans and counters
(``readers/program_span.py``, ``readers/host_span.py``,
``readers/program_counter.py``): whole traced runs of the tiny cells on
the CPU, the control in the port's place, a program without spans, and the
arithmetic on a made-up snapshot and made-up host ranges."""
import sys

import pytest

from bench_torch import core
from bench_torch.readers import host_span, program_counter, program_span

from .conftest import TINY

NEW = ("plan.convert_span_ms", "kernels.launches_per_call", "setup.port_s")


def run(bench, cell, traced=True, **kw):
    return core.run_cell(bench, cell, 2 ** 33 + 11, 0.3, traced, "cpu",
                         log=lambda *_: None, **kw)


@pytest.mark.parametrize("cell", TINY)
def test_traced_cells(tiny_bench, cpu_port, cell):
    """On the CPU the spans take no events (no device time to read) and
    the twins launch nothing; the port's set-up is read."""
    metrics = run(tiny_bench, cell)["metrics"]
    assert "plan.convert_span_ms" not in metrics
    assert metrics["kernels.launches_per_call"]["value"] == 0
    assert metrics["kernels.launches_per_call"]["unit"] == "launches"
    assert metrics["setup.port_s"]["value"] > 0


@pytest.mark.parametrize("cell", TINY)
def test_none_for_the_control(tiny_bench, cpu_port, cell):
    metrics = run(tiny_bench, cell, system="control")["metrics"]
    assert not set(NEW) & set(metrics)


def test_none_untraced(tiny_bench, cpu_port):
    metrics = run(tiny_bench, "t.execute", traced=False)["metrics"]
    assert not set(NEW) & set(metrics)


def test_none_for_a_program_without_spans(tiny_bench, cpu_port, monkeypatch):
    """What an older program (no ``trace.py``, no spans opened) gives: the
    metrics are left out and nothing raises."""
    import fftw3_tpu_torch
    trace = fftw3_tpu_torch.trace
    monkeypatch.setattr(trace, "span", lambda *a, **k: trace._OFF)
    monkeypatch.setattr(trace, "call", lambda *a, **k: trace._OFF)
    monkeypatch.delattr(fftw3_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "fftw3_tpu_torch.trace", None)
    line = run(tiny_bench, "t.split")
    assert line["correct"] is True
    assert not set(NEW) & set(line["metrics"])


class _Window:
    start, end = 100, 200


class _Run:
    trace = _Window()


SNAP = {"calls": 4, "timed_calls": 2, "dropped": 0,
        "spans": {"fftw.execute": {"count": 4, "host_ms": 1.0, "timed": 2,
                                   "device_ms": 4.0},
                  "fftw.convert.split": {"count": 4, "host_ms": 0.1,
                                         "timed": 2, "device_ms": 1.0},
                  "fftw.convert.combine": {"count": 4, "host_ms": 0.1,
                                           "timed": 2, "device_ms": 0.5},
                  "fftw.launch.stockham_c2c": {"count": 4, "host_ms": 0.2,
                                               "timed": 0,
                                               "device_ms": None}},
        "counters": {"setup.library_s": 0.25, "setup.plan_s": 0.5}}


def test_arithmetic(monkeypatch):
    from fftw3_tpu_torch import trace
    seen = []

    def snapshot(reset=False, within=None):
        seen.append(within)
        return SNAP
    monkeypatch.setattr(trace, "snapshot", snapshot)
    assert program_span.read(_Run(), {"prefix": "fftw.convert."}) == 0.75
    assert program_span.read(_Run(), {"prefix": "fftw.nothing."}) == 0
    assert program_counter.read(_Run(), {"counters": [
        "setup.library_s", "setup.plan_s"]}) == 0.75
    assert program_counter.read(_Run(), {"counters": ["setup.none"]}) is None
    assert seen == [(100, 200)] * 4
    assert program_span.read(type("R", (), {"trace": None})(),
                             {"prefix": "x"}) is None


class _Host:
    """A window [100, 200] and host ranges: two calls inside it (the
    second holding a nested root), one call across its start, launches
    inside and outside."""
    start, end = 100, 200
    host = [("fftw.execute", 90, 110), ("fftw.launch.a", 95, 105),
            ("fftw.execute", 120, 140), ("fftw.launch.a", 121, 125),
            ("fftw.launch.b", 126, 130),
            ("fftw.execute_split", 150, 180), ("fftw.execute", 151, 179),
            ("fftw.launch.a", 160, 170), ("aten::copy_", 160, 161),
            ("fftw.launch.a", 210, 220)]


LAUNCHES = {"prefix": "fftw.launch.",
            "calls": ["fftw.execute", "fftw.execute_split"]}


def test_host_span_arithmetic():
    assert host_span.read(type("R", (), {"trace": _Host()})(),
                          LAUNCHES) == 1.5
    none = type("T", (_Host,), {"host": [("fftw.launch.a", 121, 125)]})
    assert host_span.read(type("R", (), {"trace": none()})(),
                          LAUNCHES) is None
    assert host_span.read(type("R", (), {"trace": None})(), LAUNCHES) is None
