"""Device time per call, in ms, of the traced activity whose name matches
the named kernel map (``exclude``: matches none of it), from the device
trace.  0 is a reading: the trace is complete and nothing matched."""


def read(run, params):
    trace = run.complete_trace()
    if trace is None or trace.calls == 0:
        return None
    seconds = trace.device_s(run.kernels(params["kernels"]),
                             params.get("exclude", False))
    return seconds / trace.calls * 1e3
