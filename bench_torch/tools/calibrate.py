"""Readings that a cell's correctness limits are set from, in one process
on the card: the program's ``max_err`` over a dozen seeds or more (the
lower reading), the control's (the configuration's reference in TF32 in
the program's place; the upper reading), and each fault of
:mod:`bench_torch.faults` planted in the program, each over a short
window at the cell's own size and load.

    python3 -m bench_torch.tools.calibrate --workload <cell> [--workload ...]
        --seeds 3001,...,3012 --control-seeds 3101,3102,3103
        [--fault-seeds 3201,3202,3203] [--seconds 2] --out FILE
"""
from __future__ import annotations

import argparse
import json
import sys

from .. import core, faults, problem


def reading(bench, workload, seed, seconds, **kw) -> dict:
    res = core.run_cell(bench, workload, seed, seconds, False, "cuda",
                        log=lambda *_: None, **kw)
    return {"seed": seed, "correct": res["correct"],
            "attempted": res["attempted"],
            "max_err": res["checks"]["max_err"]["value"] or float("inf")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    ints = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    bench = core.load()
    for w in args.workload:
        cfg = bench.config(bench.cell(w)["config"])
        mix = bench.file("traffic", bench.cell(w)["traffic"])
        prob = problem.parse(cfg["problem"]).with_batch(mix["batch"])
        rec = {"workload": w,
               "program": [reading(bench, w, s, args.seconds)
                           for s in ints(args.seeds)],
               "control": [reading(bench, w, s, args.seconds,
                                   system="control")
                           for s in ints(args.control_seeds)]}
        for f in faults.applicable(prob):
            rec[f] = [reading(bench, w, s, args.seconds, hook=faults.hook(f))
                      for s in ints(args.fault_seeds)]
        errs = lambda k: [r["max_err"] for r in rec[k]]  # noqa: E731
        rec["lower"] = max(errs("program"))
        rec["upper"] = min(errs("control"))
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        print(json.dumps({k: (v if k in ("workload", "lower", "upper")
                              else [r["max_err"] for r in v])
                          for k, v in rec.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
