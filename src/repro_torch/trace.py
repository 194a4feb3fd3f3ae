"""Spans and counters at the port's layer boundaries, kept in memory.

Tracing is off by default, and then ``span`` returns one shared null
context (no clock read, nothing allocated) and ``count`` returns at once.
It is on while ``enable()`` holds, and while a ``torch.profiler`` records
(so a profiled stretch of a run leaves its spans in the recorder).  Only
after ``enable(annotate=True)`` is each span also a
``torch.profiler.record_function`` region, whose copy in a profile lies
on the device operations' clock; otherwise a span adds no event to a
profile.

    from repro_torch import trace
    trace.enable()
    state, egress, to_host = nic.step(state, batch)
    spans, counters = trace.collect()       # and clears them
    trace.disable()

A span records its name, its start and end (``time.perf_counter_ns``),
the index of its parent (the innermost span open on the same thread, in
the list ``collect`` returns), a request (its parent's when not given:
the spans of one unit of work share it) and its thread.  The counter
``host_syncs`` counts each place where the host waits for the device
(a read of a device value, a stream synchronise), on every device alike.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int                 # 0 while the span is open
    parent: Optional[int]       # index of the parent in the same list
    request: object
    thread: int                 # ``threading.get_ident()``


_NULL = contextlib.nullcontext()
_on = False
_annotate = False
_spans: List[list] = []         # Span fields, filled in as spans close
_counters: Dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()      # .stack: (index, request) of open spans


def enable(annotate: bool = False) -> None:
    """Record spans and counters; with ``annotate``, each span is also a
    ``record_function`` region."""
    global _on, _annotate
    _on, _annotate = True, annotate


def disable() -> None:
    global _on, _annotate
    _on = _annotate = False


def span(name: str, request=None):
    """A context manager that records the region as ``name``."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, request)


def count(name: str, n: int = 1) -> None:
    if not (_on or _profiler._is_profiler_enabled):
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def collect() -> Tuple[List[Span], Dict[str, int]]:
    """The spans (in the order they opened) and counters recorded since
    the last call, which are then cleared.  Call it between units of work:
    a span still open keeps its parent's index in the old list."""
    global _spans, _counters
    with _lock:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
    return [Span(*s) for s in spans], counters


class _Span:
    __slots__ = ("_rec", "_region")

    def __init__(self, name: str, request):
        self._rec = [name, 0, 0, None, request, threading.get_ident()]
        self._region = None

    def __enter__(self):
        rec = self._rec
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            rec[3], parent_request = stack[-1]
            if rec[4] is None:
                rec[4] = parent_request
        with _lock:
            index = len(_spans)
            _spans.append(rec)
        stack.append((index, rec[4]))
        if _annotate:
            self._region = _profiler.record_function(rec[0])
            self._region.__enter__()
        rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._rec[2] = time.perf_counter_ns()
        if self._region is not None:
            self._region.__exit__(*exc)
        _local.stack.pop()
        return False
