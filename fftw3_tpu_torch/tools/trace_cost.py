"""What the port's spans cost a host-bound caller: host µs a call of
``Plan.execute`` on a small batch, a synchronise after each call, with the
profiler off and on.

    python fftw3_tpu_torch/tools/trace_cost.py [--repo DIR] [--calls N]
        [--rounds R] [--shape 64,1024]

Plans ``plan_many_dft`` on the card, warms it up, then runs `rounds`
rounds of `calls` calls with the profiler off and `calls` with it on
(CPU and CUDA activity), in turns.  Each call is timed on the host clock:
``issue_us`` until ``execute`` returns, ``call_us`` until the synchronise
after it returns.  Where the package has spans (``trace.py``) it also
times one span with the profiler off (``span_off_ns``, the median of
blocks of 1000 ``with`` statements) and counts the spans of a call.
Prints the medians and quartiles, and the card's name and power limit, as
one JSON line.  `--repo` imports the package from another checkout (a
version without spans runs the same calls).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _stats(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return {"median": q2, "q1": q1, "q3": q3, "n": len(values)}


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return res.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--calls", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--shape", default="64,1024")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.repo.resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import fftw3_tpu_torch as ft
    if not torch.cuda.is_available():
        print("trace_cost: needs a CUDA card", file=sys.stderr)
        return 2
    batch, n = (int(v) for v in args.shape.split(","))
    dev = torch.device("cuda")
    plan = ft.plan_many_dft([n], batch, dtype="complex64", device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.view_as_complex(torch.rand((batch, n, 2), generator=g,
                                         device=dev) - 0.5)

    def loop(calls, issue, total):
        for _ in range(calls):
            t0 = time.perf_counter_ns()
            plan.execute(x)
            t1 = time.perf_counter_ns()
            torch.cuda.synchronize()
            t2 = time.perf_counter_ns()
            issue.append((t1 - t0) * 1e-3)
            total.append((t2 - t0) * 1e-3)

    loop(200, [], [])
    out = {"off": ([], []), "on": ([], [])}
    for _ in range(args.rounds):
        loop(args.calls, *out["off"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            loop(args.calls, *out["on"])
    try:
        from fftw3_tpu_torch import trace
    except ImportError:
        spans = {}
    else:
        snap = trace.snapshot(reset=True)
        spans = {k: v["count"] / snap["calls"]
                 for k, v in snap["spans"].items()}
        blocks = []
        for _ in range(200):
            t0 = time.perf_counter_ns()
            for _ in range(1000):
                with trace.span("fftw.stage.k1", dev):
                    pass
            blocks.append((time.perf_counter_ns() - t0) / 1000)
        spans["span_off_ns"] = statistics.median(blocks)
    print(json.dumps({
        "repo": str(args.repo), "shape": [batch, n], "plan": repr(plan),
        "card": _card(), "spans": spans,
        **{f"{k}.issue_us": _stats(v[0]) for k, v in out.items()},
        **{f"{k}.call_us": _stats(v[1]) for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
