"""Toolchain canary — the port of ``fftw3_tpu/toolchain_probe.py`` (P1,
``_probe_x64_ambient``, whose ``pl.pallas_call`` is at ``:112``).

On the TPU the canaries notice when the Mosaic compiler fixes a gate that a
kernel works around.  On the card the question that stands is whether the
hand-written kernels of ``csrc/`` still build and launch under the
installed CUDA toolkit.  One probe asks it:

* ``build_launch`` builds the kernel library through ``ops/_build.py``, so
  every ``csrc/*.cu`` must compile, then launches ``csrc/probe.cu``'s
  kernel, y = G @ x for 128 x 128 float32 with an fp32 sum, once with
  G = I (checked against x within 1e-6, as the reference checks) and once
  with a seeded random G (against float64 G @ x within 1e-5, max-abs error
  over max-abs).

``chip_smoke.py`` runs the probes first, right after the build, and fails
on a FAIL.  The reference's other three probes (``k2_done1``, ``tb32``,
``stage3``) build K1 with TPU-only descriptor keys or a Mosaic-gated
schedule and reach no ``pallas_call`` of their own; they are not ported
(ROADMAP, "Not ported, on purpose").

As in the reference: ``run_probes`` prints one PASS/FAIL line per probe,
runs once per process, and without a device (here: without CUDA) prints
SKIP and returns ``{}``; ``passed(name)`` is True only for a probe that ran
and passed.
"""
from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np
import torch

#: probe outcomes for this process: name -> bool (PASS).  None until
#: run_probes() executes.
RESULTS: Optional[Dict[str, bool]] = None

#: launches of the probe kernel, counted by its wrapper
launches = 0

#: the probe's matrix size, the reference's
N = 128


def matmul_torch(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the probe kernel: G @ x as products and an
    fp32 sum over the contraction, no matmul library."""
    return (g.unsqueeze(-1) * x.unsqueeze(0)).sum(1)


def matmul_cuda(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the probe kernel on square (n, n) float32 G and x on one card.
    Returns a new y = G @ x; raises on anything the kernel does not take,
    and when the launch fails."""
    global launches
    from .ops import _build
    from .ops.passes import device_guard
    for name, t in (("G", g), ("x", x)):
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"probe kernel: {name} must be a contiguous 2-D "
                             f"float32 CUDA tensor, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    n = g.shape[0]
    if g.shape != (n, n) or x.shape != (n, n) or x.device != g.device:
        raise ValueError(f"probe kernel: square matrices of one size on one "
                         f"device, got {tuple(g.shape)} and "
                         f"{tuple(x.shape)}")
    y = torch.empty_like(x)
    lib = _build.library()
    with device_guard(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.probe_matmul_launch(g.data_ptr(), x.data_ptr(),
                                     y.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"probe kernel launch failed: CUDA error {rc} "
                           f"(n={n})")
    launches += 1
    return y


def _relerr(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.max(np.abs(got.cpu().numpy() - want))
                 / np.max(np.abs(want)))


def _probe_build_launch() -> bool:
    """Every ``csrc/*.cu`` builds, and the probe kernel launches and
    computes G @ x (G = I within 1e-6 of x, a random G within 1e-5 of
    float64)."""
    from .ops import _build
    _build.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, N)).astype(np.float32)
    g = rng.standard_normal((N, N)).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    y = matmul_cuda(torch.eye(N, device=dev), xt)
    y2 = matmul_cuda(torch.from_numpy(g).to(dev), xt)
    torch.cuda.synchronize(dev)
    eye_ok = float((y - xt).abs().max()) < 1e-6
    return eye_ok and _relerr(y2, g.astype(np.float64) @ x) <= 1e-5


_PROBES = [
    ("build_launch", _probe_build_launch),
]


def run_probes(stream=None) -> Dict[str, bool]:
    """Run every canary on the card (without CUDA each is reported as SKIP
    and nothing is recorded).  Idempotent per process."""
    global RESULTS
    if RESULTS is not None:
        return RESULTS
    stream = stream or sys.stderr
    out: Dict[str, bool] = {}
    on_card = torch.cuda.is_available()
    for name, probe in _PROBES:
        if not on_card:
            print(f"# toolchain-probe {name}: SKIP (no CUDA device)",
                  file=stream)
            continue
        try:
            ok = probe()
        except Exception as exc:                       # noqa: BLE001
            first = (str(exc).splitlines() or [type(exc).__name__])[0]
            print(f"#   ({name}: {first[:110]})", file=stream)
            ok = False
        out[name] = ok
        print(f"# toolchain-probe {name}: {'PASS' if ok else 'FAIL'}",
              file=stream)
    RESULTS = out
    return out


def passed(name: str) -> bool:
    """Gate helper: True only if the probes ran AND the canary passed."""
    return bool(RESULTS and RESULTS.get(name))
