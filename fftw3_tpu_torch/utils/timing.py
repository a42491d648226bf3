"""Device timing for MEASURE planning and benchmarks.

On a CUDA tensor a timing is CUDA events recorded on the current stream
around a run of calls, read after the end event has completed, so the
host's enqueue rate cannot hide in it.  On a CPU tensor (the tests) it is
the host clock around the run.  Each function warms up once (the first
call may build a kernel), then reports the median over ``reps`` runs of
``iters`` calls, in seconds per call.

Chained values grow without bound for unnormalized transforms (sqrt(n)
RMS gain per call, reaching inf after a few dozen calls).  The card's FP32
arithmetic runs at one rate whatever the values, and scaling the output
back would add a pass over memory that distorts the quantity measured.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, List, Sequence, Tuple

import torch


def _elapsed(run: Callable[[], None], device: torch.device) -> float:
    """Seconds that `run` takes on `device`."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def _device_of(args: Sequence[torch.Tensor]) -> torch.device:
    return args[0].device


def time_chained(fn: Callable, args: Sequence[torch.Tensor],
                 iters: int = 10, reps: int = 5) -> float:
    """Seconds per call of ``fn`` whose output tuple feeds its inputs."""
    return time_chained_multi([(fn, args)], iters, reps)[0]


def time_chained_multi(configs: Sequence[Tuple[Callable, Sequence]],
                       iters: int = 10, reps: int = 5) -> List[float]:
    """Chained seconds per call for SEVERAL (fn, args) configs,
    interleaved: every rep times every config's :func:`chain` of ``iters``
    calls before the next rep starts, so slow drift in the card's state
    (clocks, temperature) lands on all of them alike.  Each chain starts
    from the warm-up call's output.  Returns a list aligned with
    ``configs``."""
    runs = []
    for fn, args in configs:
        runs.append(chain(fn, tuple(fn(*args))))   # warm-up (builds)
    samples: List[List[float]] = [[] for _ in runs]
    for _ in range(reps):
        for i, run in enumerate(runs):
            samples[i].append(run(iters) / iters)
    return [statistics.median(s) for s in samples]


def time_dispatched(fn: Callable, args: Sequence[torch.Tensor],
                    iters: int = 10, reps: int = 5) -> float:
    """Like :func:`time_chained` for fns whose output cannot feed the
    input: ``iters`` independent calls on the same arguments per rep."""
    fn(*args)                                      # warm-up (builds)

    def run():
        for _ in range(iters):
            fn(*args)
    dev = _device_of(args)
    return statistics.median(_elapsed(run, dev) / iters
                             for _ in range(reps))


def chain(fn: Callable, args: Sequence[torch.Tensor],
          calls_per_step: int = 1) -> Callable[[int], float]:
    """A chain of `fn` from `args`: ``run(k)`` makes k dependent steps (each
    call's output tuple feeds the next) and returns the seconds they take,
    CUDA events on a CUDA tensor; each step holds `calls_per_step` calls,
    and the seconds are divided by it."""
    dev = _device_of(args)

    def run(k: int) -> float:
        state = [tuple(args)]

        def steps():
            cur = state[0]
            for _ in range(k):
                cur = tuple(fn(*cur))
            state[0] = cur
        return _elapsed(steps, dev) / calls_per_step
    return run


def interleaved_chain_race(named_chains, k1: int = 4, k2: int = 16,
                           reps: int = 7) -> dict:
    """Seconds per call of each chain of ``[(tag, run)]`` (``run(k)`` makes
    k chained calls and returns their seconds, as :func:`chain` builds):
    every rep runs every chain at k1 and k2 calls before the next rep, and
    a chain's time per call is the median over reps of (t(k2) - t(k1)) /
    (k2 - k1), so a fixed cost per chain cancels and drift lands on every
    chain alike (the port of ``experiments/_race.py``)."""
    samples = {tag: [] for tag, _ in named_chains}
    for _ in range(reps):
        for tag, run in named_chains:
            t1 = run(k1)
            t2 = run(k2)
            samples[tag].append((t2 - t1) / (k2 - k1))
    return {tag: statistics.median(s) for tag, s in samples.items()}
