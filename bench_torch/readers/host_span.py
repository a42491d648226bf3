"""Per call of the traced window, from the profiler's host ranges
(``run.trace.host``): the ranges whose name starts with ``prefix`` over
the outermost ranges named one of ``calls``, both counted inside the
window.  None where no such call lies in it (an untraced run, a program
that opens no such range, the control in the port's place)."""


def read(run, params):
    if run.trace is None:
        return None
    lo, hi = run.trace.start, run.trace.end
    inside = [(n, s, e) for n, s, e in run.trace.host if lo <= s and e <= hi]
    calls, edge = 0, lo - 1
    for _, s, e in sorted((iv for iv in inside if iv[0] in params["calls"]),
                          key=lambda iv: iv[1]):
        if s > edge:
            calls, edge = calls + 1, e
    if not calls:
        return None
    return sum(1 for n, _, _ in inside if n.startswith(params["prefix"])) / calls
