"""Share of the traced decode steps in which no operation ran on the
device; the profiler slows the host, so an upper estimate."""


def read(r):
    t = r.get("trace")
    return None if t is None or "traced_decode_steps" not in r \
        else t.idle_share
