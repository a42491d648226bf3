"""The traced window: ``torch.profiler`` over one stretch of a run, read
into the device's activity, the host's ops and the window's bounds.

The window is the host span ``bench.window`` that the harness opens
around its calls; device activity (kernels, copies, sets: every event on
the device's timeline but the spans of ``record_function``) is clipped to
it.  A trace is complete when it holds as many launches of the port's
kernels as the program's own launch counters counted in the window: a
launch missing from the trace would read as idle time, so the readers
read nothing from an incomplete one.
"""
from __future__ import annotations

import bisect
import functools
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "bench.window"
#: entries of each list of the breakdown
TOP = 10

Interval = Tuple[str, int, int]            # name, start ns, end ns


def _matches(name: str, patterns: Sequence[str]) -> bool:
    return any(re.search(p, name) for p in patterns)


def short_name(name: str) -> str:
    """A kernel's identifier and template arguments, without ``void`` and
    its parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:160]


@dataclass
class Trace:
    start: int
    end: int
    device: List[Interval]
    host: List[Interval]
    calls: int                   # calls issued inside the window
    launches: int                # the program's counted kernel launches

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    @functools.cached_property
    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device's activity, as disjoint intervals."""
        out: List[List[int]] = []
        for _, s, e in sorted(self.device, key=lambda iv: iv[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def device_s(self, patterns: Sequence[str], exclude: bool = False) -> float:
        """Seconds of device activity whose name matches one of
        `patterns` (or, with `exclude`, matches none)."""
        return sum(e - s for n, s, e in self.device
                   if _matches(n, patterns) != exclude) * 1e-9

    def count(self, patterns: Sequence[str]) -> int:
        return sum(1 for n, _, _ in self.device if _matches(n, patterns))

    def complete(self, port_patterns: Sequence[str]) -> bool:
        return self.count(port_patterns) == self.launches

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing (the innermost host op at
        the gap's middle)."""
        ops: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            ops[short_name(n)] += (e - s) * 1e-9
        host = sorted(self.host, key=lambda iv: iv[1])
        starts = [s for _, s, _ in host]
        gaps: Dict[str, float] = defaultdict(float)
        edge = self.start
        for s, e in self.busy + [(self.end, self.end)]:
            if s > edge:
                gaps[_host_at(host, starts, (edge + s) // 2)] += (s - edge) * 1e-9
            edge = max(edge, e)
        top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                                   key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def _host_at(host: List[Interval], starts: List[int], t: int,
             depth: int = 256) -> str:
    """The latest-starting host op that is still running at `t`: the
    innermost one, as ops on one thread nest."""
    i = bisect.bisect_right(starts, t) - 1
    for k in range(i, max(i - depth, -1), -1):
        if host[k][2] >= t:
            return host[k][0]
    return "no host op (Python)"


def _annotation(e) -> bool:
    """A span of ``record_function`` (on the host, or its copy on the
    device's timeline), not an op."""
    flag = getattr(e, "is_user_annotation", None)
    return flag() if flag is not None else e.name() == WINDOW


def read(prof, calls: int, launches: int) -> Optional[Trace]:
    """The trace of a finished ``torch.profiler.profile`` whose window
    span is :data:`WINDOW`; None when the span is missing."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    window = [e for e in events
              if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not window:
        return None
    start, end = window[0].start_ns(), window[0].end_ns()
    device, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if e.name() == WINDOW:
            continue
        if e.device_type() == DeviceType.CPU:
            host.append((e.name(), s, t))
        elif not _annotation(e) and t > start and s < end:
            device.append((e.name(), max(s, start), min(t, end)))
    return Trace(start, end, device, host, calls, launches)
