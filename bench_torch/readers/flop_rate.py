"""All the window's work over all its time: the named work function's
flops per call times the calls completed, over the window's seconds,
times ``scale`` (1e-9 for GFLOP/s)."""


def read(run, params):
    flops, _ = run.work(params["work"])
    return flops * run.calls / run.window_s * params["scale"]
