"""Median host time of ``SpinNIC.step`` from call to return over the
window's steps (the host's issue of the step's device work)."""
import statistics


def read(r):
    v = r.get("host_step_ms")
    return statistics.median(v) if v else None
