"""Spans and counters of the port's calls, on ``torch.profiler``'s clock.

A span marks one layer of a call: the entry (``fftw.execute``,
``fftw.execute_split``), the conversions between interleaved complex and
split planes (``fftw.convert.split``, ``fftw.convert.combine``), each axis
pass (``fftw.stage.<kernel or alg>``) and each kernel launch
(``fftw.launch.<kernel>``).  Spans exist only while ``torch.profiler``
runs, by torch's own flag: otherwise :func:`span` and :func:`call` return
one shared no-op context manager, and nothing is recorded.  While the
profiler runs, a span

* enters a profiler range of its name (torch's ``_RecordFunctionFast``,
  the form compiled graphs use, a tenth of ``record_function``'s cost on a
  host; ``record_function`` where a torch lacks it), so it lands in the
  profiler's trace beside the device activity, on its clock;
* appends a :class:`Record` to memory: its name, the call it belongs to
  (counted at the entry span, the root), its parent record and its host
  interval in ns on the profiler's clock (``time.time_ns()``: a range's
  event holds the ``time.time_ns()`` read inside it);
* where it is given a CUDA device (the conversions are), and its call is
  a timed one, records a pair of CUDA events on that device's current
  stream at its edges: the device time of the work issued inside it.  A
  call on a CUDA device is timed every :data:`EVENT_EVERY`-th of its
  plan's calls while the profiler runs (a root given no plan: every
  :data:`EVENT_EVERY`-th call id): each event recorded on a stream holds
  the device back about 3 µs under the profiler (an NVIDIA H100: 2.8-3.0
  µs), so events in every call would add 1-2% to a closed loop's idle
  share.  Counting per plan, and not by call id, keeps a caller that
  alternates plans (an r2c, then its c2r) from timing one of them alone.

A model's step (``models/``) marks its layers with :func:`model`:
``fftw.model.ns_step`` around a Navier-Stokes step and
``fftw.model.ns.nonlinear`` around each evaluation of its advection term,
``fftw.model.neumann_solve`` around a Neumann Poisson solve.  A model span
is a profiler range alone: it takes no events and appends no record, so a
plan called inside a step still opens a root of its own
(``fftw.execute``), sampled by its own plan's count.

The record keeps the latest :data:`CAP` spans, the older ones counted as
dropped, and belongs to one profiler session: a call of the port while the
profiler is off, or a read of the record after it stopped, ends the
session, and the next span recorded starts a new record (two sessions with
neither between them share one: ``snapshot(within=...)`` tells them
apart).  :func:`snapshot`
sums the record by span name, resolving and then dropping the events, and
adds the set-up counters: the kernel library's load and the planning, timed
always.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

#: the profiler range a span enters
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 _profiler.record_function)

#: records kept at most, the latest
CAP = 1 << 16
#: every this many calls of a plan on a CUDA device take CUDA events
EVENT_EVERY = 8


class _Off:
    """The span while the profiler is off: does nothing (cheaper than
    ``contextlib.nullcontext``, whose methods take more arguments)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        return None


_OFF = _Off()
_lock = threading.Lock()
_local = threading.local()
_calls = itertools.count(1)
#: each plan's count of its roots recorded
_plan_calls: "weakref.WeakKeyDictionary[object, itertools.count]" = \
    weakref.WeakKeyDictionary()
_records: Deque["Record"] = deque()
_dropped = 0
#: the record's profiler session has ended: the next span starts anew
_ended = False
#: seconds of the port's set-up: the kernel library's load (a build
#: excluded, ``ops/_build.build_seconds`` keeps that) and the planning
_setup = {"setup.library_s": 0.0, "setup.plan_s": 0.0}


@dataclass(eq=False)
class Record:
    """One span: `call` is the id of the root span it ran under (None
    outside any), `parent` the record of the span it opened in (None for
    the outermost), `timed` whether its call takes CUDA events.  `events`
    are its pair until :func:`snapshot` resolves them into `device_ms`."""
    name: str
    call: Optional[int]
    parent: Optional["Record"]
    start_ns: int
    timed: bool = False
    end_ns: Optional[int] = None
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None
    device_ms: Optional[float] = None

    @property
    def root(self) -> bool:
        return self.parent is None and self.call is not None


def _cuda(device) -> bool:
    return device is not None and device.type == "cuda"


def _nth(plan) -> int:
    """This root's place among `plan`'s roots recorded (1 for the first)."""
    with _lock:
        count = _plan_calls.get(plan)
        if count is None:
            count = _plan_calls[plan] = itertools.count(1)
    return next(count)


class _Span:
    __slots__ = ("name", "root", "device", "plan", "rf", "rec")

    def __init__(self, name: str, root: bool, device, plan=None):
        self.name, self.root, self.device = name, root, device
        self.plan = plan

    def __enter__(self):
        global _dropped, _ended
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1].rec if stack else None
        if outer is None:
            call = next(_calls) if self.root else None
            nth = call if self.plan is None else _nth(self.plan)
            timed = (call is not None and _cuda(self.device)
                     and nth % EVENT_EVERY == 0)
        else:
            call, timed = outer.call, outer.timed
        self.rf = _range(self.name)
        self.rf.__enter__()
        rec = self.rec = Record(self.name, call, outer, time.time_ns(), timed)
        if timed and outer is not None and _cuda(self.device):
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(torch.cuda.current_stream(self.device))
        with _lock:
            if _ended and outer is None:
                _records.clear()
                _dropped, _ended = 0, False
            if len(_records) >= CAP:
                _records.popleft()
                _dropped += 1
            _records.append(rec)
        stack.append(self)
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(self.device))
        rec.end_ns = time.time_ns()
        _local.stack.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A context manager marking `name` while the profiler runs (CUDA
    events on `device`'s current stream in a timed call, if it is a CUDA
    device), else the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, False, device)


def call(name: str, device: Optional[torch.device] = None, plan=None):
    """:func:`span` for an entry point of `plan` on `device`: the root of
    a call, which counts a new call id unless a span is already open on
    this thread, and is timed every ``EVENT_EVERY``-th call of `plan` if
    `device` is a CUDA device (the root itself takes no events).  Off, it
    ends the record's session."""
    if not _profiler._is_profiler_enabled:
        global _ended
        _ended = True
        return _OFF
    return _Span(name, True, device, plan)


def model(name: str):
    """A context manager marking a layer `name` of a model's step while the
    profiler runs (a profiler range, no record), else the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _range(name)


def add(counter: str, seconds: float) -> None:
    """Add `seconds` to a set-up counter."""
    with _lock:
        _setup[counter] += seconds


def records() -> List[Record]:
    """A copy of the record, in the order the spans opened."""
    return _take(False)[0]


def _take(clear: bool) -> Tuple[List[Record], int]:
    global _dropped, _ended
    with _lock:
        out = list(_records), _dropped
        if clear:
            _records.clear()
            _dropped = 0
        elif not _profiler._is_profiler_enabled:
            _ended = True
    return out


def reset() -> None:
    """Clear the record and its dropped count (the counters stay)."""
    _take(True)


def counters() -> Dict[str, float]:
    """The set-up counters: ``setup.library_s``, ``setup.plan_s``."""
    with _lock:
        return dict(_setup)


def snapshot(reset: bool = False,
             within: Optional[Tuple[int, int]] = None) -> dict:
    """The record summed by span name: ``{"spans": {name: {"count",
    "host_ms", "timed", "device_ms"}}, "calls", "timed_calls", "dropped",
    "counters"}``.

    ``host_ms`` is the total over the name's spans, ``device_ms`` the total
    over the ``timed`` of them that took CUDA events (None where none
    did).  ``calls`` counts root spans, ``timed_calls`` the timed ones: a
    per-call device time is a ``device_ms`` over ``timed_calls``.  Only
    closed spans count, and with `within` = (start ns, end ns) on the
    profiler's clock only those inside it.  Waits for the device to pass
    each span's end event, then keeps its time and drops the events.
    `reset` clears the record after reading it."""
    recs, dropped = _take(reset)
    lo, hi = within if within is not None else (None, None)
    spans: Dict[str, dict] = {}
    calls = timed_calls = 0
    for rec in recs:
        if rec.end_ns is None or (within is not None and not (
                lo <= rec.start_ns and rec.end_ns <= hi)):
            continue
        s = spans.setdefault(rec.name, {"count": 0, "host_ms": 0.0,
                                        "timed": 0, "device_ms": None})
        s["count"] += 1
        s["host_ms"] += (rec.end_ns - rec.start_ns) * 1e-6
        calls += rec.root
        timed_calls += rec.root and rec.timed
        if rec.events is not None:
            start, end = rec.events
            end.synchronize()
            rec.device_ms, rec.events = start.elapsed_time(end), None
        if rec.device_ms is not None:
            s["timed"] += 1
            s["device_ms"] = (s["device_ms"] or 0.0) + rec.device_ms
    return {"spans": spans, "calls": calls, "timed_calls": timed_calls,
            "dropped": dropped, "counters": counters()}
