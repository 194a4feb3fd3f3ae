"""Share of the profiled NIC steps in which no operation ran on the device
(1 - union of device operation intervals / host clock).  The profiler
slows the host, so this is an upper estimate."""


def read(r):
    t = r.get("trace")
    return None if t is None or "trace_steps" not in r else t.idle_share
