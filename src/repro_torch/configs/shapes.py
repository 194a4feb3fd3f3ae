"""Model inputs drawn from a seed; numpy copy of ``repro.configs.shapes``'
concrete batches (every family).

The arrays are drawn from the ``np.random.Generator`` in the same order and
with the same calls as the JAX package draws them (tokens, targets, then
the modality stubs), so one seed gives both packages the same batch.
Floating inputs (``enc_frames``, ``img_embeds``) come as float32, 0.02
times standard normal draws: numpy has no bfloat16, and the model casts
them to its dtype, as the JAX package's ``jnp.asarray(.., bfloat16)``
does, through float32 (it gives the same bits).  Callers move the arrays
to a device themselves.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


def _ints(shape, high: int, rng: np.random.Generator, low: int = 0
          ) -> np.ndarray:
    return rng.integers(low, high, size=shape).astype(np.int32)


def _floats(shape, rng: np.random.Generator) -> np.ndarray:
    return (rng.normal(size=shape) * 0.02).astype(np.float32)


def train_batch_specs(cfg: ModelConfig, seq: int, batch: int,
                      rng: Optional[np.random.Generator] = None
                      ) -> Dict[str, np.ndarray]:
    """Inputs for a training step; ``seq`` is the whole sequence.  tokens
    and targets (batch, seq) int32; encdec adds ``enc_frames`` (batch,
    enc_seq, d_model) and ``enc_len`` (batch,) int32, all ``enc_seq``;
    vlm's text is ``seq - img`` tokens after ``img = min(img_tokens, seq
    // 2)`` image embeddings ``img_embeds`` (batch, img, d_model), with
    M-RoPE ``positions`` (3, batch, seq) int32, all three components 0..seq
    - 1 (the text behaviour)."""
    rng = rng or np.random.default_rng(0)
    v = cfg.vocab
    if cfg.family == "vlm":
        img = min(cfg.img_tokens, seq // 2)
        text = seq - img
        out = {"tokens": _ints((batch, text), v, rng),
               "targets": _ints((batch, text), v, rng),
               "img_embeds": _floats((batch, img, cfg.d_model), rng)}
        out["positions"] = np.broadcast_to(
            np.arange(seq, dtype=np.int32), (3, batch, seq)).copy()
        return out
    out = {"tokens": _ints((batch, seq), v, rng),
           "targets": _ints((batch, seq), v, rng)}
    if cfg.family == "encdec":
        out["enc_frames"] = _floats((batch, cfg.enc_seq, cfg.d_model), rng)
        out["enc_len"] = _ints((batch,), cfg.enc_seq + 1, rng,
                               low=cfg.enc_seq)
    return out


def prefill_batch_specs(cfg: ModelConfig, seq: int, batch: int,
                        rng: Optional[np.random.Generator] = None
                        ) -> Dict[str, np.ndarray]:
    """Inputs for a prefill: the training batch without its targets (which
    are still drawn, to keep the generator in step with the JAX package)."""
    b = train_batch_specs(cfg, seq, batch, rng)
    b.pop("targets")
    return b
