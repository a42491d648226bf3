"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 -m bench_torch.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the plan, the set-up's stages, the
window and the card's name, clocks and power limit on earlier lines, the
result as one JSON object on the last line of standard output, and each
number compared beside its limit as the last lines of standard error.
Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result: nothing runs on the CPU in its place.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import core  # noqa: E402

#: kernel caches a program may use, kept at fixed paths in the checkout so
#: that only the first run of a checkout builds
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}
CACHE_ROOT = core.ROOT / ".bench_cache"


def card_line() -> str:
    """The card's name, clocks, power draw and limit, by ``nvidia-smi``."""
    query = "name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"card: nvidia-smi not read ({exc!r})"
    return f"card ({query}): {res.stdout.strip() or res.stderr.strip()}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(CACHE_ROOT / sub)
    if str(core.ROOT) not in sys.path:
        sys.path.insert(0, str(core.ROOT))

    bench = core.load()
    chips = bench.cell(args.workload)["chips"]
    t_import = time.perf_counter()
    import torch
    t_cuda = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_torch: needs {chips} CUDA card(s), this torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f"; nothing runs in their place", file=sys.stderr)
        return 2
    print(f"harness: start {t_import - T_START:.3f} s, import torch "
          f"{t_cuda - t_import:.3f} s, CUDA's start "
          f"{time.perf_counter() - t_cuda:.3f} s")
    result = core.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    print(card_line())
    print(json.dumps(result), flush=True)
    for key, check in result["checks"].items():
        print(f"check {key}: {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
