"""The window's model FLOPs (``bench/ref/flops``: prompt tokens at the
chunked forward's count, generated tokens at the recurrent step's) per
second, as a share of the H100's bf16 peak (989 TFLOP/s at 700 W)."""
from bench.ref import peaks


def read(r):
    if "serve_flops" not in r:
        return None
    return 100.0 * r["serve_flops"] / r["window_s"] / peaks.BF16_FLOPS
