"""Run cells several times, each run a process of its own, and
summarise the spread of every metric.

    python3 -m bench_torch.tools.series --workload <cell> [--workload ...]
        --seeds 11,12,13 [--sets 2] [--seconds 10] [--trace 0|1]
        --out FILE

Each run's result line (or its failure, with the end of its output) is
appended to ``--out``.  Per cell and set it prints each metric's median
and its spread: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median, with
each set's first run, which may build, left out of ``setup_s``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "bench_torch.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=1300)
    rec = {"workload": workload, "seed": seed, "trace": trace,
           "rc": res.returncode, "wall_s": time.perf_counter() - t0}
    try:
        rec["line"] = json.loads(res.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        rec["line"] = None
    rec["stdout"] = res.stdout[-3000:]
    rec["stderr"] = res.stderr[-3000:]
    return rec


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def summarise(records, label: str) -> dict:
    lines = [r["line"] for r in records if r["line"]]
    out = {"runs": len(records), "correct": sum(bool(ln["correct"])
                                                for ln in lines)}
    names = sorted({k for ln in lines for k in ln["metrics"]})
    for name in names:
        vals = [ln["metrics"][name]["value"] for ln in lines
                if name in ln["metrics"]]
        if name == "setup_s":
            out["setup_first"] = vals[:1]
            vals = vals[1:]
        if vals:
            out[name] = {"median": statistics.median(vals),
                         "spread": spread(vals), "values": vals}
    checks = [ln["checks"]["max_err"]["value"] for ln in lines]
    out["max_err"] = checks
    print(f"== {label}: {json.dumps(out)}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for workload in args.workload:
        for k in range(args.sets):
            records = []
            for seed in seeds:
                rec = one(workload, seed, args.seconds, args.trace)
                records.append(rec)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                ln = rec["line"]
                print(f"{workload} set {k} seed {seed} rc {rec['rc']} "
                      f"wall {rec['wall_s']:.1f} s: "
                      + (json.dumps({key: ln[key] for key in ln
                                     if key != "breakdown"})
                         if ln else rec["stderr"][-1500:]), flush=True)
            summarise(records, f"{workload} set {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
