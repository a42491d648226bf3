"""Device ms per call of the traced window, from the program's own spans
(``fftw3_tpu_torch.trace``): the CUDA-event time of every span whose name
starts with ``prefix`` and that lies inside the window, over the calls
there whose spans took events (every few calls do).  None where the
program records no spans (a version without ``trace.py``), where no call
in the window took events (an untraced run, the control in the port's
place, a run off the card)."""


def read(run, params):
    if run.trace is None:
        return None
    try:
        from fftw3_tpu_torch import trace
    except ImportError:
        return None
    snap = trace.snapshot(within=(run.trace.start, run.trace.end))
    if not snap["timed_calls"]:
        return None
    return sum(s["device_ms"] or 0.0 for name, s in snap["spans"].items()
               if name.startswith(params["prefix"])) / snap["timed_calls"]
