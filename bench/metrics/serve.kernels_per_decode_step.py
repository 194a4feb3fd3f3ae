"""Device operations (kernels, copies, fills) a decode step, from the
profiler over the traced decode steps."""


def read(r):
    t = r.get("trace")
    if t is None or "traced_decode_steps" not in r:
        return None
    return t.ops / r["traced_decode_steps"]
