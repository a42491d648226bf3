"""Work functions, one module each, found by the name a per-layer metric
gives: ``work(problem, dtype) -> (flops, bytes)`` of one call."""
