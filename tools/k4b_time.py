#!/usr/bin/env python3
"""K4b's device time at four training shapes, from the checkout given, on
an NVIDIA GPU (random bf16 inputs from seed 0; CUDA events, median of 15
runs of 10 calls queued behind a GPU spin).

    python tools/k4b_time.py <checkout> <label>

To compare two versions, unpack one into a directory and run both in
turns in one session on one card (a, b, b, a): each process builds its
checkout's kernels.
"""
import statistics
import sys

sys.path.insert(0, sys.argv[1] + "/src")

import torch  # noqa: E402

from repro_torch.kernels.flash_attention import ops  # noqa: E402

SHAPES = {  # B, Sq, Sk, H, KV, D, causal
    "gemma3-1b global": (4, 1024, 1024, 4, 1, 256, True),
    "whisper cross": (4, 448, 1500, 6, 6, 64, False),
    "whisper encoder": (4, 1500, 1536, 6, 6, 64, False),
    "qwen2-vl layer 0": (4, 2048, 2048, 12, 2, 128, True),
}


def main():
    dev = torch.device("cuda")
    out = []
    for name, (b, sq, sk, h, kv, d, causal) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        q, do = (torch.randn((b, sq, h, d), device=dev,
                             generator=g).bfloat16() for _ in range(2))
        k, v = (torch.randn((b, sk, kv, d), device=dev,
                            generator=g).bfloat16() for _ in range(2))
        o, lse = ops.flash_attention_with_lse(q, k, v, causal=causal)

        def call():
            ops.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
        for _ in range(3):
            call()
        times = []
        for _ in range(15):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 10)
        out.append(f"{name} {statistics.median(times) * 1e3:.3f} us")
    print(sys.argv[2], "; ".join(out), flush=True)


if __name__ == "__main__":
    main()
