"""Share of two traced train steps (ingest overlapped) in which no
operation ran on the device; the profiler slows the host, so an upper
estimate."""


def read(r):
    t = r.get("trace")
    return None if t is None or "train_steps" not in r else t.idle_share
