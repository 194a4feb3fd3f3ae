"""Median host time of one ``SpinIngest`` call alone (the frames' copy to
the device, K1, reassembly, K2), with a synchronise on each side, over
ten calls after the window."""
import statistics


def read(r):
    v = r.get("ingest_ms")
    return statistics.median(v) if v else None
