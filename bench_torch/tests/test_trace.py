"""The trace arithmetic on a hand-made trace: busy time as a union,
device time by kernel map, completeness by the launch count, idle gaps by
the host op around them, and the readers on it."""
import pytest

from bench_torch import trace as trace_mod
from bench_torch.readers import idle_share, percentile

K1 = ("void fftw3_tpu_torch::(anonymous namespace)::"
      "stockham_c2c_kernel<0, false, false, 256>(float const*)")
COPY = "void at::native::elementwise_kernel<128, 2>(int)"
PORT = [r"\bstockham_c2c_kernel\b"]


def make(launches=2):
    device = [(K1, 100, 300), (COPY, 250, 400), (K1, 600, 700)]
    host = [("aten::copy_", 0, 90), ("cudaDeviceSynchronize", 400, 590),
            ("aten::empty", 720, 900)]
    return trace_mod.Trace(0, 1000, device, host, calls=2,
                           launches=launches)


def test_busy_is_the_union():
    t = make()
    assert t.busy == [(100, 400), (600, 700)]
    assert t.busy_s == pytest.approx(400e-9)
    assert t.window_s == pytest.approx(1000e-9)


def test_device_time_by_map():
    t = make()
    assert t.device_s(PORT) == pytest.approx(300e-9)
    assert t.device_s(PORT, exclude=True) == pytest.approx(150e-9)
    assert t.count(PORT) == 2


@pytest.mark.parametrize("launches, complete", [(2, True), (3, False)])
def test_completeness(launches, complete):
    assert make(launches).complete(PORT) is complete


def test_breakdown():
    b = make().breakdown()
    assert b["device_ops"][0] == ["fftw3_tpu_torch::stockham_c2c_kernel<0, false, false, 256>",
                                  pytest.approx(300e-9)]
    gaps = dict(b["idle_gaps"])
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(200e-9)
    assert gaps["aten::copy_"] == pytest.approx(100e-9)
    assert gaps["aten::empty"] == pytest.approx(300e-9)


class _Run:
    def __init__(self, trace=None, series=None):
        self.trace, self.series = trace, series or {}

    def complete_trace(self):
        return self.trace


def test_readers():
    assert idle_share.read(_Run(make()), {}) == pytest.approx(60.0)
    assert idle_share.read(_Run(None), {}) is None
    run = _Run(series={"call_ms": list(range(1, 101))})
    assert percentile.read(run, {"series": "call_ms", "q": 95}) == 95
    assert percentile.read(run, {"series": "call_ms", "q": 50}) == 50
    assert percentile.read(run, {"series": "sync_us", "q": 95}) is None
