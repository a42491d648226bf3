"""The port's Navier-Stokes step on the card (``cuda`` marker; each test
skips without a card): at (2, 2048, 2048) against the plain float64
reference (``bench_torch/references/navier_stokes.py``) within the limit
of the cell ``ns2048x2048-v16.rk2``, with 12 launches of the port's
kernels a step (K4 and K2 for each of 3 r2c calls, K2 and K6 for each of
3 c2r calls) and its 6 plan calls drawn from the functional cache with no
planning after the first step; the stacked inverse transform against
four separate ones.  This file imports no JAX.
"""
import importlib
import json
from pathlib import Path

import pytest
import torch

from bench_torch.references import navier_stokes as ref
from fftw3_tpu_torch import api, models

LIMITS = (Path(__file__).resolve().parents[1] / "bench_torch" / "limits"
          / "ns2048x2048-v16.rk2.json")
#: the port's launch counters (``bench_torch/kernels/port.json``)
COUNTERS = json.loads((LIMITS.parents[1] / "kernels" / "port.json")
                      .read_text())["counters"]


def _launches():
    out = {}
    for name in COUNTERS:
        mod, attr = name.split(":")
        out[name] = getattr(importlib.import_module(mod), attr)
    return out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    from fftw3_tpu_torch.ops import _build
    _build.library()
    api._cached_plan.cache_clear()
    yield torch.device("cuda")
    api._cached_plan.cache_clear()


def _err(y, want):
    return ((y.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
def test_card_step_against_the_reference(card):
    limit = json.loads(LIMITS.read_text())["max_err"]["limit"]
    g = torch.Generator(device=card).manual_seed(2100)
    w = torch.rand((2, 2048, 2048), generator=g, device=card) - 0.5
    step = models.navier_stokes_step(2048, 2048, ref.NU, ref.DT)
    y = step(w)
    first = api._cached_plan.cache_info()
    assert (first.misses, first.hits) == (3, 3)
    before = _launches()
    again = step(w)
    torch.cuda.synchronize()
    after = _launches()
    info = api._cached_plan.cache_info()
    assert (info.misses, info.hits) == (3, 3 + 6)
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"fftw3_tpu_torch.ops.real_stockham:r2c_launches": 3,
                     "fftw3_tpu_torch.ops.inner:launches": 6,
                     "fftw3_tpu_torch.ops.real_stockham:c2r_launches": 3}
    assert torch.equal(y, again)
    want = ref.step(w.double(), ref.NU, ref.DT)
    err = _err(y, want)
    assert err <= limit / 20, err
    # the control and the step without its advection fail the limit
    assert _err(ref.control_step(w, ref.NU, ref.DT), want) > limit
    e = ref.operators(2048, 2048, ref.NU, ref.DT, card)[-1]
    viscous = torch.fft.irfft2(torch.fft.rfft2(w.double()) * e,
                               s=(2048, 2048))
    assert _err(viscous, want) > 100 * limit


@pytest.mark.cuda
def test_card_stacked_inverse_is_four_inverses(card):
    g = torch.Generator(device=card).manual_seed(2101)
    S = torch.randn((4, 2, 2048, 1025), generator=g, device=card,
                    dtype=torch.complex64)
    one = api.irfftn(S, s=(2048, 2048), axes=(-2, -1))
    four = torch.stack([api.irfftn(S[i], s=(2048, 2048), axes=(-2, -1))
                        for i in range(4)])
    assert torch.equal(one, four)
