"""Device operations (kernels, copies, fills) a step, from the profiler
over the steps of one round's completion that begin at a ring boundary,
the host poll of each step included."""


def read(r):
    t = r.get("trace")
    if t is None or "trace_steps" not in r:
        return None
    return t.ops / r["trace_steps"]
