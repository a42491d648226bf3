"""Metric readers, one module each, found by the ``reader`` a metric's
file in ``metrics/`` names: ``read(run, params) -> float | None``, where
``run`` is :class:`bench_torch.core.Run` and ``params`` the rest of the
metric's file.  A reader that finds nothing to read returns None and the
metric is left out of the result line."""
