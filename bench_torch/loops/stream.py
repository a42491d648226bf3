"""A closed loop of one caller on one stream, calls back to back with no
synchronise between them: the host issues ahead of the device.

Per-call times come from events recorded on the stream before each call
and once after the last, so the intervals tile the window and hold any
gap the host leaves.  The window runs on the host clock from the first
call's issue to the return of the synchronise after the last call, inside
``span()`` (the traced window's span in a traced run).
"""
from __future__ import annotations

import contextlib
import time


def run(fn, pool, seconds, keep, first, clock, span=contextlib.nullcontext):
    events, calls, failed, error = [], 0, 0, None
    with span():
        t0 = time.perf_counter()
        while True:
            ev = clock.event()
            ev.record()
            events.append(ev)
            i = first + calls
            try:
                out = fn(*pool[i % len(pool)])
            except (RuntimeError, ValueError) as exc:
                failed, error = failed + 1, error or repr(exc)
            else:
                keep(i, out)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        end = clock.event()
        end.record()
        clock.synchronize()
        window_s = time.perf_counter() - t0
    events.append(end)
    call_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {"calls": calls, "failed": failed, "error": error,
            "window_s": window_s, "series": {"call_ms": call_ms}}
