"""Median host time of the window's prefills, a synchronise on each
side."""
import statistics


def read(r):
    v = r.get("prefill_ms")
    return statistics.median(v) if v else None
