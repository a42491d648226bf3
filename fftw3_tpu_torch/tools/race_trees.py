"""Race the kernels of two or more checkouts of this repository on one card.

    python3 -m fftw3_tpu_torch.tools.race_trees TREE [TREE ...] [--rounds N]

Each round runs one child process per tree, in order and then back (A, B,
B, A for two trees), so drift in the card's state lands on every tree.  A
child imports ``fftw3_tpu_torch`` from its tree (which builds that tree's
kernels into its own ``_build/`` at first use), times each kernel below at
its path's shape with CUDA events (median of 7 reps of 3 calls) and prints
one JSON line.  The parent prints, per kernel, every tree's times and the
ratio of each tree's best to the first tree's, with the card's name and
power limit.  Exits non-zero when a child fails or torch sees no card.

The kernels, through wrappers every tree since the double-precision
slice has: K1 at (65536, 1024) [64, 16]; K2 at (1, 512, 262144) and on
the (8, 2048, 1025) half-spectrum planes; K3 at (512, 512, 512), (64,
512, 512), (256, 256, 1024) and (341, 384, 512), writing complex64 (the
form ``Plan.execute`` runs, in every tree since the edge kernels) and
planes; K4 at (65536, 1024) and
(16384, 2048); K5 at (8, 2048, 2048); K6 at (65536, 1024) and (16384,
2048) on their default schedules and at (65536, 512) on [256], the
DCT-III's child (``c2r_cuda`` has had the same signature since the real
slice); K7 at (8192, 1024) [64, 16] and (1024, 512) [32, 16], float64
planes.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, numpy as np, torch
from fftw3_tpu_torch.ops import df32, fused2d, inner, stockham as S
from fftw3_tpu_torch.ops import real_stockham as RS
from fftw3_tpu_torch.utils import timing
dev = torch.device("cuda")
rng = np.random.default_rng(0)
def planes(shape):
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(dev) for _ in range(2))
def ms(fn, args):
    return timing.time_dispatched(fn, args, iters=3, reps=7) * 1e3
out = {}
xr, xi = planes((65536, 1024))
t = S.device_table(1024, (64, 16), -1, dev)
out["K1 (65536, 1024) [64, 16]"] = ms(
    lambda a, b: S.stockham_c2c_cuda(a, b, [64, 16], t), (xr, xi))
del xr, xi
for shape in ((1, 512, 262144), (8, 2048, 1025)):
    xr, xi = planes(shape)
    rad = S.choose_radices(shape[1])
    t = S.device_table(shape[1], tuple(rad), -1, dev)
    out[f"K2 {shape}"] = ms(
        lambda a, b: inner.inner_c2c_cuda(a, b, rad, t), (xr, xi))
    del xr, xi
for shape in ((512, 512, 512), (64, 512, 512), (256, 256, 1024),
              (341, 384, 512)):
    xr, xi = planes(shape)
    r1, r2 = S.choose_radices(shape[1]), S.choose_radices(shape[2])
    t = fused2d.device_table_2d(shape[1], tuple(r1), shape[2], tuple(r2),
                                -1, dev)
    out[f"K3 {shape} complex64 out"] = ms(
        lambda a, b: fused2d.c2c_2d_cuda(a, b, r1, r2, t, complex_out=True),
        (xr, xi))
    out[f"K3 {shape}"] = ms(
        lambda a, b: fused2d.c2c_2d_cuda(a, b, r1, r2, t), (xr, xi))
    del xr, xi
for shape in ((65536, 1024), (16384, 2048)):
    x = planes(shape)[0]
    rad = S.choose_radices(shape[1] // 2)
    t = RS.device_table(shape[1], tuple(rad), -1, dev)
    out[f"K4 {shape}"] = ms(lambda a: RS.r2c_cuda(a, rad, t), (x,))
    del x
for shape, rad in (((65536, 1024), None), ((16384, 2048), None),
                   ((65536, 512), [256])):
    n = shape[1]
    rad = rad or S.choose_radices(n // 2)
    xr, xi = planes((shape[0], n // 2 + 1))
    t = RS.device_table(n, tuple(rad), +1, dev)
    out[f"K6 {shape} {rad}"] = ms(
        lambda a, b: RS.c2r_cuda(a, b, rad, t), (xr, xi))
    del xr, xi
x = planes((8, 2048, 2048))[0]
rad = S.choose_radices(1024)
t = RS.device_table(2048, tuple(rad), -1, dev)
out["K5 (8, 2048, 2048)"] = ms(lambda a: RS.r2c_inner_cuda(a, rad, t), (x,))
del x
for shape in ((8192, 1024), (1024, 512)):
    xr, xi = (torch.from_numpy(rng.standard_normal(shape)).to(dev)
              for _ in range(2))
    rad = df32.df32p_radices(shape[1])
    out[f"K7 {shape} {rad}"] = ms(
        lambda a, b: df32.df32_c2c_cuda(a, b, rad, -1), (xr, xi))
    del xr, xi
print(json.dumps(out))
"""


def run_child(tree: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"child in {tree} failed ({res.returncode}):\n"
                         f"{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    trees = [os.path.abspath(t) for t in args.trees]
    times = {t: {} for t in trees}
    for _ in range(args.rounds):
        for tree in trees + trees[::-1]:
            for k, v in run_child(tree).items():
                times[tree].setdefault(k, []).append(v)
    base = trees[0]
    for k in times[base]:
        line = []
        for tree in trees:
            ts = times[tree][k]
            ratio = min(ts) / min(times[base][k])
            line.append(f"{os.path.basename(tree)} "
                        + " / ".join(f"{v:.3f}" for v in ts)
                        + f" ms ({ratio:.3f}x)")
        print(f"{k}: " + "; ".join(line) + f" ({smi})")
    print(json.dumps({"card": smi, "times": {
        os.path.basename(t): times[t] for t in trees}}))


if __name__ == "__main__":
    main()
