"""95th percentile, over the messages completed in the window, of the time
from the issue of the step carrying a message's first frame to the host
poll that saw its completion."""
from bench.harness import quantile


def read(r):
    lat = r.get("latency_ms")
    return quantile(lat, 0.95) if lat else None
