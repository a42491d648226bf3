"""The edge kernels' layouts timed alone on the card, and the memory a
complex64 ``Plan.execute`` call takes above what its caller holds.

    python -m fftw3_tpu_torch.tools.edge_layouts [--rounds R] [--hold N]
        [--only K1] [--out F]
    python fftw3_tpu_torch/tools/edge_layouts.py --peak [--repo DIR]

Layouts: each kernel wrapper at the benchmark's shapes, in every layout
it has (``planes``: float32 planes in and out; ``in``: complex64 in;
``out``: complex64 out; ``in+out``), each arm first held bit for bit
against the planar arm's output.  K1 at (65536, 1024) [64, 16], also
``in+out`` with the input 8 bytes past a 16-byte boundary (``in@8B``:
the kernel's 8-byte loads) and 16 bytes past the allocation's start
(``in@16B``); K1's wide form at (4096, 4096) [64, 64]; K2 at (1, 512,
262144) [32, 16] (the 512^3 plan's axis 0) and at (8, 2048, 1025) and
(64, 2048, 1025) [128, 16] (the half spectra of the conv and ns cells'
2-D real plans, the latter ns's stacked inverse); K3 at (512, 512, 512)
[32, 16]^2; ``--only`` keeps the kernels whose label starts so.  Each
round times every arm once with CUDA events (the median of 7 reps of 10
calls), in order in odd rounds and backwards in even ones; each arm's
list holds its reading of every round.  ``--hold N`` keeps each arm's
last N outputs alive while it runs, so that outputs rotate through N + 1
allocations, as in a benchmark window that keeps outputs (0: each output
is freed at once and the next call reuses its block).  Also prints the
card's clocks and temperature after each kernel's arms, and the
registers, spill stores and stack frame ptxas gave each instantiation of
the three kernels.

``--peak``: ``torch.cuda.max_memory_allocated`` over one warm
``Plan.execute`` call above the memory allocated before it, with the
input already held, at (65536, 1024) and at 512^3, in bytes and in units
of the input's size.  It uses the public API only, so ``--repo`` can
point it at another checkout (one without the layouts).

Prints one JSON line with the card's name and power limit; ``--out``
also writes it to a file.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
from pathlib import Path


def _smi(query: str = "name,power.limit") -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return res.stdout.strip()


def _complex(torch, shape, dev):
    """A complex64 tensor of `shape` drawn on `dev`."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return torch.randn(shape, dtype=torch.complex64, device=dev, generator=g)


def _at_offset(torch, x, offset):
    """A copy of `x` that starts `offset` complex elements into its
    allocation."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    y = buf[offset:].view(x.shape)
    y.copy_(x)
    return y


def _arms(torch, dev):
    """{kernel: a builder of {arm: (fn, args)}}; each arm is checked
    against its planar arm bit for bit."""
    from fftw3_tpu_torch.ops import fused2d, inner
    from fftw3_tpu_torch.ops import stockham as S

    def planes(x):
        return x.real.contiguous(), x.imag.contiguous()

    def every_layout(run, x):
        """The arms of a wrapper ``run(xr, xi, cout=False)`` that reads and
        writes either layout, on `x`."""
        return {"planes": (run, planes(x)),
                "in": (run, (x, None)),
                "out": (lambda a, b: run(a, b, cout=True), planes(x)),
                "in+out": (lambda z: run(z, None, cout=True), (x,))}

    def k1(shape, rad):
        n = shape[-1]
        tab = S.device_table(n, tuple(rad), -1, dev)

        def run(*a, cout=False):
            return S.stockham_c2c_cuda(*a, rad, tab, complex_out=cout)
        x = _complex(torch, shape, dev)
        arms = every_layout(run, x)
        if n <= S.MAX_N:
            for label, off in (("in@8B", 1), ("in@16B", 2)):
                xo = _at_offset(torch, x, off)
                arms[f"in+out {label}"] = (
                    lambda z: run(z, None, cout=True), (xo,))
        else:
            arms = {k: arms[k] for k in ("planes", "in+out")}
        return arms

    def k2(shape, rad):
        tab = S.device_table(shape[1], tuple(rad), -1, dev)

        def run(*a, cout=False):
            return inner.inner_c2c_cuda(*a, rad, tab, complex_out=cout)
        return every_layout(run, _complex(torch, shape, dev))

    def k3(shape, rad):
        tab = fused2d.device_table_2d(shape[1], tuple(rad), shape[2],
                                      tuple(rad), -1, dev)

        def run(a, b, cout=False):
            return fused2d.c2c_2d_cuda(a, b, rad, rad, tab, complex_out=cout)
        x = _complex(torch, shape, dev)
        return {"planes": (run, planes(x)),
                "out": (lambda a, b: run(a, b, True), planes(x))}

    return {"K1 (65536, 1024) [64, 16]":
            lambda: k1((65536, 1024), [64, 16]),
            "K1 wide (4096, 4096) [64, 64]":
            lambda: k1((4096, 4096), [64, 64]),
            "K2 (1, 512, 262144) [32, 16]":
            lambda: k2((1, 512, 262144), [32, 16]),
            "K2 (8, 2048, 1025) [128, 16]":
            lambda: k2((8, 2048, 1025), [128, 16]),
            "K2 (64, 2048, 1025) [128, 16]":
            lambda: k2((64, 2048, 1025), [128, 16]),
            "K3 (512, 512, 512) [32, 16]^2":
            lambda: k3((512, 512, 512), [32, 16])}


def _as_complex(torch, y):
    return y if isinstance(y, torch.Tensor) else torch.complex(*y)


def _holding(fn, hold: int):
    """`fn` keeping its last `hold` outputs alive."""
    if not hold:
        return fn, None
    kept = collections.deque(maxlen=hold)

    def run(*args):
        kept.append(fn(*args))
    return run, kept


def layouts(torch, dev, rounds: int, hold: int = 0,
            only: str = "") -> dict:
    from fftw3_tpu_torch.ops import _build
    from fftw3_tpu_torch.utils import timing
    _build.library()
    out = {}
    for kernel, build in _arms(torch, dev).items():
        if not kernel.startswith(only):
            continue
        arms = build()
        want = _as_complex(torch, arms["planes"][0](*arms["planes"][1]))
        for arm, (fn, args) in arms.items():
            if not torch.equal(_as_complex(torch, fn(*args)), want):
                raise SystemExit(f"{kernel} {arm} differs from its planes")
        del want
        names = list(arms)
        times = {a: [] for a in names}
        runs = {a: _holding(fn, hold) for a, (fn, _) in arms.items()}
        for r in range(rounds):
            for a in (names if r % 2 == 0 else names[::-1]):
                times[a].append(timing.time_dispatched(
                    runs[a][0], arms[a][1], iters=10, reps=7) * 1e3)
        out[kernel] = {a: {"ms": ts, "median": statistics.median(ts)}
                       for a, ts in times.items()}
        out[kernel]["clocks"] = _smi("clocks.sm,clocks.mem,"
                                     "temperature.gpu,power.draw")
        del arms, runs
        torch.cuda.empty_cache()
    out["ptxas"] = {k: {"registers": v[0], "spill_bytes": v[1],
                        "stack_bytes": v[2]}
                    for k, v in sorted(_build.register_report().items())
                    if k.split("<")[0] in ("stockham_c2c_kernel",
                                           "inner_c2c_kernel",
                                           "c2c_2d_kernel")}
    return out


def peak(torch, dev) -> dict:
    import fftw3_tpu_torch as ft
    out = {}
    for label, make, shape in (
            ("(65536, 1024)", lambda: ft.plan_many_dft(
                [1024], 65536, dtype="complex64", device=dev),
             (65536, 1024)),
            ("512^3", lambda: ft.plan_dft_3d(512, 512, 512,
                                              dtype="complex64", device=dev),
             (512, 512, 512))):
        plan = make()
        x = _complex(torch, shape, dev)
        plan.execute(x)                          # warm: builds, tables
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        y = plan.execute(x)
        torch.cuda.synchronize()
        above = torch.cuda.max_memory_allocated(dev) - base
        xb = x.numel() * x.element_size()
        out[label] = {"peak_above_held_bytes": above,
                      "in_input_sizes": above / xb, "input_bytes": xb}
        del x, y, plan
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--hold", type=int, default=0)
    ap.add_argument("--only", default="")
    ap.add_argument("--peak", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.repo.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("edge_layouts: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    res = {"card": _smi()}
    if args.peak:
        res["peak"] = peak(torch, dev)
    else:
        res["hold"] = args.hold
        res["layouts"] = layouts(torch, dev, args.rounds, args.hold,
                                 args.only)
    line = json.dumps(res)
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
