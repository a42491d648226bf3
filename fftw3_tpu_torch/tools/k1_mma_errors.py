"""Read the errors of the E4-E12 tensor-core arms (``ops/k1_mma.py``) on one
card over several inputs.

    python3 -m fftw3_tpu_torch.tools.k1_mma_errors [--seeds 8] \\
        [--rows 8192 24576]

For each seed and row count it draws split (rows, 1024) float32 planes
from ``numpy.random.default_rng(seed)`` and prints one JSON line: for every
arm that is a forward DFT (not the diagnostics, not E10's r = 3, 5) the
kernel's and its twin's distance from the DFT in complex128 on the card
(max abs over max |y|), and for every arm the kernel's largest distance
from its twin (over max |twin|) at any rows per block.  Then one line with
the largest of each over the draws, and the card's name and power limit.
Exits non-zero when torch sees no card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import k1_mma


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def draw(seed: int, rows: int, dev: torch.device) -> dict:
    """The readings of one (rows, 1024) draw."""
    rng = np.random.default_rng(seed)
    xr, xi = (torch.from_numpy(rng.standard_normal((rows, k1_mma.N),
                                                   np.float32)).to(dev)
              for _ in range(2))
    ref = torch.fft.fft(torch.complex(xr, xi).to(torch.complex128), dim=-1)
    out = {"seed": seed, "rows": rows, "kernel_f64": {}, "twin_f64": {},
           "kernel_twin": {}}
    for name, a in k1_mma.ARMS.items():
        t = torch.complex(*k1_mma.k1_mma_torch(xr, xi, name))
        out["kernel_twin"][name] = max(
            _rel(torch.complex(*k1_mma.k1_mma_cuda(xr, xi, name, rpb)), t)
            for rpb in k1_mma.rows_per_block_fit(name))
        if a.diag is None and a.reps == 1:
            k = torch.complex(*k1_mma.k1_mma_cuda(xr, xi, name))
            out["kernel_f64"][name] = _rel(k.to(torch.complex128), ref)
            out["twin_f64"][name] = _rel(t.to(torch.complex128), ref)
        del t
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--rows", type=int, nargs="+", default=[8192, 24576])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch sees no CUDA device", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    worst: dict = {}
    for rows in args.rows:
        for seed in range(args.seeds):
            d = draw(seed, rows, dev)
            print(json.dumps(d), flush=True)
            for key in ("kernel_f64", "twin_f64", "kernel_twin"):
                w = worst.setdefault(key, {})
                for name, v in d[key].items():
                    w[name] = max(w.get(name, 0.0), v)
            torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"worst": worst, "seeds": args.seeds,
                      "rows": args.rows, "card": smi.strip()}))


if __name__ == "__main__":
    main()
