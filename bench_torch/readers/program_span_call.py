"""Device ms per harness call of the traced window, from the program's own
spans: ``program_span``'s reading (per root that took events) times the
roots a harness call makes there (the window's roots over its harness
calls).  A call that runs two plans, as FFT filtering's r2c and c2r do,
so reads the spans of both.  None wherever ``program_span`` reads none."""
from . import program_span


def read(run, params):
    per_root = program_span.read(run, params)
    if per_root is None or not run.trace.calls:
        return None
    from fftw3_tpu_torch import trace
    roots = trace.snapshot(within=(run.trace.start, run.trace.end))["calls"]
    return per_root * roots / run.trace.calls
