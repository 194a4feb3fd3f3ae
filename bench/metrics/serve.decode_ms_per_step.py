"""Median over the window's finished batches of the batch's decode time
(prefill's end to the client's read of its tokens) per decode step."""
import statistics


def read(r):
    v = r.get("decode_ms")
    return statistics.median(v) if v else None
