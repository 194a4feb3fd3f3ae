"""The program's own spans and counters over a traced run, for the
metric readers.

While ``torch.profiler`` records, the program's tracing
(``repro_torch.trace``) records too, so after a ``--trace 1`` run its
recorder holds exactly the spans and counters of the profiled window.
The first reader to ask collects them (which clears the recorder) and
keeps the summary in the run's readings for the others.  A program
without ``repro_torch.trace`` records nothing, and every reader of these
reads None.

The spans' times are host time under the profiler: the profiler's own
cost is in them, so a stage's milliseconds read more than the same stage
unprofiled (``nic.host_ms_per_step`` and ``serve.decode_ms_per_step``
time the unprofiled window).  ``tools/trace_check.py cost`` reads these
metrics over an unprofiled run.
"""
from __future__ import annotations

import collections
from typing import Iterable, Optional


def summarize(spans, counters) -> Optional[dict]:
    """``{"count": {span: n}, "s": {span: inclusive seconds},
    "counters": {name: n}, "spans": spans}`` of collected spans and
    counters, or None where there are no spans."""
    if not spans:
        return None
    count, secs = collections.Counter(), collections.Counter()
    for s in spans:
        count[s.name] += 1
        secs[s.name] += (s.end_ns - s.start_ns) * 1e-9
    return {"count": dict(count), "s": dict(secs),
            "counters": dict(counters), "spans": spans}


def summary(r: dict) -> Optional[dict]:
    """The summary of the run's profiled window (collected at the first
    call), or None."""
    if "program_trace" not in r:
        if r.get("trace") is None:
            return None
        try:
            from repro_torch import trace
        except ImportError:
            r["program_trace"] = None
            return None
        r["program_trace"] = summarize(*trace.collect())
    return r["program_trace"]


def ms_per(r: dict, names: Iterable[str], per: str) -> Optional[float]:
    """Inclusive host milliseconds of the spans ``names`` over the count
    of spans ``per`` in the same window."""
    t = summary(r)
    if not t or not t["count"].get(per):
        return None
    return sum(t["s"].get(n, 0.0) for n in names) * 1e3 / t["count"][per]


def counter_per(r: dict, counter: str, per: str) -> Optional[float]:
    """Counter ``counter`` over the count of spans ``per``."""
    t = summary(r)
    if not t or not t["count"].get(per):
        return None
    return t["counters"].get(counter, 0) / t["count"][per]
