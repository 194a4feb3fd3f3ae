"""K6 (the grouped expert kernel) over the traced decode steps: its bound
(``bench/ref/qwen2_moe.k6_bound_s``: the weights of each expert that got
a row, read once a call, and the rows in and out, over 3.35 TB/s, or its
6 d ff operations a row over 989 TFLOP/s, whichever is larger) over its
device time in the profiler, in percent."""


def read(r):
    k = r.get("k6")
    if not k or not k["device_s"]:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
