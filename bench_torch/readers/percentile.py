"""The ``q``-th percentile (nearest rank) of one per-call series of the
window, times ``scale``.  The series are the loop's: ``call_ms`` (stream),
``sync_us`` and ``entry_us`` (sync); in a traced run only the calls made
after the traced stretch count, as the profiler slows the host."""
import math


def read(run, params):
    series = run.series.get(params["series"])
    if not series:
        return None
    ranked = sorted(series)
    k = max(0, math.ceil(params["q"] / 100 * len(ranked)) - 1)
    return ranked[k] * params.get("scale", 1.0)
