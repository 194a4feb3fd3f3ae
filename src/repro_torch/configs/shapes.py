"""Model inputs drawn from a seed; numpy copy of the token-model part of
``repro.configs.shapes`` (the dense, moe, ssm and hybrid families).

The arrays are drawn from the ``np.random.Generator`` in the same order as
the JAX package draws them (tokens, then targets), so one seed gives both
packages the same prompt.  Callers move them to a device themselves.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


def _ints(shape, high: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, high, size=shape).astype(np.int32)


def train_batch_specs(cfg: ModelConfig, seq: int, batch: int,
                      rng: Optional[np.random.Generator] = None
                      ) -> Dict[str, np.ndarray]:
    """Inputs for a training step: tokens and targets, (batch, seq) int32."""
    if cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(
            f"shapes: family {cfg.family!r} is not ported yet (ROADMAP.md, "
            f"\"Modules to port\"); dense, moe, ssm and hybrid are")
    rng = rng or np.random.default_rng(0)
    tokens = _ints((batch, seq), cfg.vocab, rng)
    targets = _ints((batch, seq), cfg.vocab, rng)
    return {"tokens": tokens, "targets": targets}


def prefill_batch_specs(cfg: ModelConfig, seq: int, batch: int,
                        rng: Optional[np.random.Generator] = None
                        ) -> Dict[str, np.ndarray]:
    """Inputs for a prefill: the training batch without its targets (which
    are still drawn, to keep the generator in step with the JAX package)."""
    b = train_batch_specs(cfg, seq, batch, rng)
    b.pop("targets")
    return b
