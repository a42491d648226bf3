"""A pass's share of its roofline, in %: the least time of the named work
on the card (the larger of its bytes at the peak bandwidth and its flops
at the peak rate of the configuration's precision, from ``peaks/``) over
the device time per call of the kernels of the named map."""


def read(run, params):
    trace = run.complete_trace()
    peaks = run.peaks()
    if trace is None or peaks is None or trace.calls == 0:
        return None
    seconds = trace.device_s(run.kernels(params["kernels"])) / trace.calls
    if seconds <= 0:
        return None
    flops, nbytes = run.work(params["work"])
    least = max(nbytes / peaks["bytes_per_s"],
                flops / peaks["flops_per_s"][run.dtype])
    return 100.0 * least / seconds
