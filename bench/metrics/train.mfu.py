"""The window's model FLOPs (``bench/ref/flops.train_step``: products of
the published sizes, forward and backward, recompute not counted) per
second, as a share of the H100's bf16 peak (989 TFLOP/s at 700 W)."""
from bench.ref import peaks


def read(r):
    if "train_steps" not in r:
        return None
    rate = r["train_flops_per_step"] * r["train_steps"] / r["window_s"]
    return 100.0 * rate / peaks.BF16_FLOPS
