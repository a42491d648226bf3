"""The sum of the named counters of the program (``fftw3_tpu_torch.trace``
``snapshot()["counters"]``), as the process holds them when the metrics
are read.  None where the program has no such counters, and where no call
of the program's entry spans lies in the traced window (an untraced run,
the control in the port's place)."""


def read(run, params):
    if run.trace is None:
        return None
    try:
        from fftw3_tpu_torch import trace
    except ImportError:
        return None
    snap = trace.snapshot(within=(run.trace.start, run.trace.end))
    if not snap["calls"] or not all(k in snap["counters"]
                                    for k in params["counters"]):
        return None
    return sum(snap["counters"][k] for k in params["counters"])
