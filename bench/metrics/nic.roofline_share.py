"""The step's share of its bandwidth bound: the bytes the traffic needs a
step (live frame bytes in, message bytes written to host memory) over
the H100's 3.35 TB/s, divided by the window's time a step.  It counts the
same work whatever implements the step."""
from bench.ref import peaks


def read(r):
    if "necessary_bytes_per_step" not in r:
        return None
    bound_s = r["necessary_bytes_per_step"] / peaks.HBM_BYTES_PER_S
    return 100.0 * bound_s / (r["window_s"] / r["steps"])
