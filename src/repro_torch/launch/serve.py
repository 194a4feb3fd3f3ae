"""Serving command line: prefill a batch of prompts, then greedy decode;
PyTorch port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Every arch serves (``--arch qwen2-moe-a2.7b``, ``mamba2-780m``,
``recurrentgemma-9b``, ``whisper-tiny``, ``qwen2-vl-2b``, ...;
kimi-k2-1t-a32b only at ``--smoke``: its full width does not fit one
card).  ``--prompt-len`` is the whole prompt: for whisper-tiny the
decoder's tokens, beside ``enc_seq`` (1,500) encoder frames; for
qwen2-vl-2b ``min(img_tokens, prompt_len // 2)`` image embeddings, then
text.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --batch 4 --prompt-len 224 --gen 32

Weights are drawn from ``--seed`` (a ``torch.Generator`` on the device)
and every input of the prompt batch (tokens and the modality stubs) from
the same seed with numpy, as ``repro.launch.serve`` draws them. Prints
the prefill time and the decode time per step (host clock around calls
that end in a device synchronisation; the first of the ``--gen`` tokens
comes from the prefill, so ``--gen`` - 1 decode steps run) and, on CUDA,
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import card_line, configs, resolve_device
from repro_torch.configs import shapes as sh
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServeEngine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.gen < 2:
        ap.error("--gen must be at least 2 (the first token comes from the "
                 "prefill)")

    dev = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    engine = ServeEngine(model, params,
                         max_len=args.prompt_len + args.gen + 8)

    rng = np.random.default_rng(args.seed)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             sh.prefill_batch_specs(cfg, args.prompt_len, args.batch,
                                    rng=rng).items()}
    _sync(dev)
    t0 = time.perf_counter()
    state = engine.prefill(batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    toks, state = engine.generate(state, steps=args.gen)
    out = toks.cpu().numpy()                      # waits for the device
    t_step = (time.perf_counter() - t0 - t_prefill) / (args.gen - 1)
    where = card_line() if dev.type == "cuda" else "cpu"
    print(f"[serve] arch={cfg.name} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} vocab={cfg.vocab} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} "
          f"prefill={t_prefill * 1e3:.3f}ms "
          f"decode={t_step * 1e3:.3f}ms/step over {args.gen - 1} steps "
          f"on {where}")
    print(f"[serve] generated tokens[0] = {out[0].tolist()}")
    return {"tokens": out, "prefill_s": t_prefill,
            "decode_s_per_step": t_step, "device": where}


if __name__ == "__main__":
    main()
