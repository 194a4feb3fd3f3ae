"""Assigned input-shape suites and model inputs; numpy and torch copy of
``repro.configs.shapes``.

Four shapes per architecture (40 cells):

  train_4k    : seq 4096,   global_batch 256  -> train step
  prefill_32k : seq 32768,  global_batch 32   -> prefill (serve)
  decode_32k  : seq 32768,  global_batch 128  -> decode step (1 new token,
                                                 KV cache of 32768)
  long_500k   : seq 524288, global_batch 1    -> decode step; requires
                sub-quadratic attention: runs only for SSM / hybrid /
                mostly-local archs, skipped (and recorded) otherwise.

Concrete inputs are numpy arrays drawn from the ``np.random.Generator`` in
the same order and with the same calls as the JAX package draws them
(tokens, targets, then the modality stubs), so one seed gives both
packages the same batch.  Floating inputs (``enc_frames``,
``img_embeds``) come as float32, 0.02 times standard normal draws: numpy
has no bfloat16, and the model casts them to its dtype, as the JAX
package's ``jnp.asarray(.., bfloat16)`` does, through float32 (it gives
the same bits).  Callers move the arrays to a device themselves.

Abstract inputs (``concrete=False``; the JAX package's
``ShapeDtypeStruct``s) are tensors on the ``meta`` device, in the model's
dtype where JAX's are; the dry run turns them into fake tensors.  The
port's ``train_batch_specs``, ``prefill_batch_specs`` and
``decode_specs`` take ``rng`` fourth and are concrete unless told
otherwise; ``input_specs`` keeps the JAX signature and default.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: Dict[str, ShapeSuite] = {
    "train_4k": ShapeSuite("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSuite("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSuite("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSuite("long_500k", 524288, 1, "decode"),
}

# Archs whose attention cost is sub-quadratic / O(1)-state at decode time.
LONG_CONTEXT_ARCHS = {"mamba2-780m", "recurrentgemma-9b", "gemma3-1b"}


def cell_supported(arch: str, shape_name: str) -> Tuple[bool, str]:
    """Is this (arch x shape) cell in contract?  Returns (ok, reason)."""
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, ("pure full-attention arch: 524k decode requires "
                       "sub-quadratic attention (DESIGN.md skip list)")
    return True, ""


def _ints(shape, high: int, rng: np.random.Generator, low: int = 0,
          concrete: bool = True):
    if not concrete:
        return torch.empty(shape, dtype=torch.int32, device="meta")
    rng = rng or np.random.default_rng(0)      # per array, as in JAX
    return rng.integers(low, high, size=shape).astype(np.int32)


def _floats(shape, rng: np.random.Generator, dtype: str = "float32",
            concrete: bool = True):
    if not concrete:
        return torch.empty(shape, dtype=getattr(torch, dtype),
                           device="meta")
    rng = rng or np.random.default_rng(0)
    return (rng.normal(size=shape) * 0.02).astype(np.float32)


def train_batch_specs(cfg: ModelConfig, seq: int, batch: int,
                      rng: Optional[np.random.Generator] = None, *,
                      concrete: bool = True) -> Dict[str, Any]:
    """Inputs for a training step; ``seq`` is the whole sequence.  tokens
    and targets (batch, seq) int32; encdec adds ``enc_frames`` (batch,
    enc_seq, d_model) and ``enc_len`` (batch,) int32, all ``enc_seq``;
    vlm's text is ``seq - img`` tokens after ``img = min(img_tokens, seq
    // 2)`` image embeddings ``img_embeds`` (batch, img, d_model), with
    M-RoPE ``positions`` (3, batch, seq) int32, all three components 0..seq
    - 1 (the text behaviour)."""
    v = cfg.vocab
    ints = dict(rng=rng, concrete=concrete)
    floats = dict(rng=rng, dtype=cfg.dtype, concrete=concrete)
    if cfg.family == "vlm":
        img = min(cfg.img_tokens, seq // 2)
        text = seq - img
        out = {"tokens": _ints((batch, text), v, **ints),
               "targets": _ints((batch, text), v, **ints),
               "img_embeds": _floats((batch, img, cfg.d_model), **floats)}
        out["positions"] = (np.broadcast_to(
            np.arange(seq, dtype=np.int32), (3, batch, seq)).copy()
            if concrete else _ints((3, batch, seq), seq, **ints))
        return out
    out = {"tokens": _ints((batch, seq), v, **ints),
           "targets": _ints((batch, seq), v, **ints)}
    if cfg.family == "encdec":
        out["enc_frames"] = _floats((batch, cfg.enc_seq, cfg.d_model),
                                    **floats)
        out["enc_len"] = _ints((batch,), cfg.enc_seq + 1, low=cfg.enc_seq,
                               **ints)
    return out


def prefill_batch_specs(cfg: ModelConfig, seq: int, batch: int,
                        rng: Optional[np.random.Generator] = None, *,
                        concrete: bool = True) -> Dict[str, Any]:
    """Inputs for a prefill: the training batch without its targets (which
    are still drawn, to keep the generator in step with the JAX package)."""
    b = train_batch_specs(cfg, seq, batch, rng, concrete=concrete)
    b.pop("targets")
    return b


def decode_specs(cfg: ModelConfig, seq: int, batch: int,
                 rng: Optional[np.random.Generator] = None, *,
                 concrete: bool = True) -> Dict[str, Any]:
    """Inputs for a decode step: one new token (``tokens`` (batch, 1)
    int32) against a cache of ``seq``, at position ``pos`` = seq - 1 (a
    0-d int32)."""
    return {"tokens": _ints((batch, 1), cfg.vocab, rng, concrete=concrete),
            "pos": (np.asarray(seq - 1, np.int32) if concrete else
                    torch.empty((), dtype=torch.int32, device="meta"))}


def input_specs(cfg: ModelConfig, shape_name: str, concrete: bool = False,
                rng: Optional[np.random.Generator] = None):
    """(step kind, batch) for one assigned cell."""
    s = SHAPES[shape_name]
    if s.kind == "train":
        return "train", train_batch_specs(cfg, s.seq_len, s.global_batch,
                                          rng, concrete=concrete)
    if s.kind == "prefill":
        return "prefill", prefill_batch_specs(
            cfg, s.seq_len, s.global_batch, rng, concrete=concrete)
    return "decode", decode_specs(cfg, s.seq_len, s.global_batch, rng,
                                  concrete=concrete)
