"""The device's idle share of the traced window, in %: 1 minus the union
of its kernels, copies and sets over the window's wall time."""


def read(run, params):
    trace = run.complete_trace()
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
