#!/usr/bin/env python3
"""K4b's errors on whisper-tiny's attention layers in training, on an
NVIDIA GPU, against the exact (float64) gradients of the same bfloat16
inputs.

    PYTHONPATH=src python tools/k4b_precision.py

Trains whisper-tiny at full width for 6 steps on one
``shapes.train_batch_specs`` batch (as ``chip_smoke.py`` phase 5g does),
records the inputs of one more step's K4b calls (layer 0's cross-, self-
and encoder attention), and prints, for dq, dk and dv, the max abs error
over the largest value and the row error (``ref.row_error``, each row's
RMS floored at 0.05 of the tensor's, as ``chip_smoke.py`` holds bfloat16)
of: the kernel against the plain float32 version and against float64; the
plain float32 version against float64; and, for the cross layer, a plain
version that rounds P and dS to one bfloat16 before their products (the
numerics of the kernel before P and dS were held as bfloat16 pairs).  The
cross layer runs at ``kv_len`` 1,500 each and at (1,500, 1,200, 700, 1).
"""
import itertools
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k4, ref  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

FLOOR = 0.05


def bf16_rounded(q, k, v, o, do, kv_len):
    """The backward with P and dS rounded to one bfloat16 before their
    products (float32 otherwise), no GQA (whisper: H = KV)."""
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    sc = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * sc
    j = torch.arange(k.shape[1], device=q.device)
    live = (j[None, :] < kv_len[:, None])[:, None, None, :]
    s = s.masked_fill(~live, -torch.inf)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]
    ds = (p * (dp - delta)).bfloat16().float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), do)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * sc
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * sc
    return dq, dk, dv


def report(tag, got, want):
    out = []
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.double(), w.double()
        rms = w.pow(2).mean().sqrt().item()
        rows = w.pow(2).mean(-1).sqrt().clamp_min(FLOOR * rms)
        e = (a - w).abs().amax(-1) / rows
        at = np.unravel_index(int(e.argmax()), e.shape)
        rel = ((a - w).abs().max() / w.abs().max()).item()
        out.append(f"{name}: rel {rel:.3e} row {e.max().item():.3e} at "
                   f"{tuple(int(x) for x in at)}")
    print(f"  {tag}: " + "; ".join(out), flush=True)


def main():
    dev = torch.device("cuda")
    cfg = configs.get_config("whisper-tiny")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ost = opt.init(params.tree())
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             shapes.train_batch_specs(cfg, 448, 4,
                                      rng=np.random.default_rng(0)).items()}
    tr = Trainer(model, opt.OptConfig(lr=3e-3, warmup_steps=1,
                                      total_steps=6),
                 TrainerConfig(steps=6, log_every=1))
    params, ost, _ = tr.fit(params, ost, itertools.repeat(batch),
                            resume=False)
    calls = {}
    plain = k4.flash_attention_bwd

    def recording(q, k, v, o, do, **kw):    # the last call of a kind:
        name = ("cross" if kw.get("kv_len") is not None else     # layer 0
                "self" if kw["causal"] else "encoder")
        calls[name] = (q, k, v, o, do, kw)
        return plain(q, k, v, o, do, **kw)
    k4.flash_attention_bwd = recording
    try:
        tr._step_fn(params, ost, batch)
    finally:
        k4.flash_attention_bwd = plain
    for name in ("cross", "encoder", "self"):
        q, k, v, o, do, kw = calls[name]
        lens_list = ([1500] * 4, [1500, 1200, 700, 1]) if name == "cross" \
            else (None,)
        for lens in lens_list:
            kv_len = None if lens is None else torch.tensor(
                lens, dtype=torch.int32, device=dev)
            args = dict(causal=kw["causal"], window=0, kv_len=kv_len)
            o, lse = k4.flash_attention_with_lse(q, k, v, **args)
            got = k4.flash_attention_bwd(q, k, v, o, do, lse=lse, **args)
            f32 = ref.flash_attention_bwd_ref(q, k, v, o, do, **args)
            exact = ref.flash_attention_bwd_ref(
                *(t.double() for t in (q, k, v, o, do)), **args)
            print(f"{name} layer 0, q{tuple(q.shape)} k{tuple(k.shape)} "
                  f"kv_len {lens}", flush=True)
            report("kernel against plain float32", got, f32)
            report("kernel against float64", got, exact)
            report("plain float32 against float64", f32, exact)
            if name == "cross":
                report("P, dS in one bfloat16, against float64",
                       bf16_rounded(q, k, v, o, do, kv_len), exact)


if __name__ == "__main__":
    main()
