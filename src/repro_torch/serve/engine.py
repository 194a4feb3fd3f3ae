"""Serving engine: prefill + greedy decode; PyTorch port of
``repro.serve.engine``.

The JAX engine jits prefill and decode and donates the cache to decode.
Here both run eagerly under ``torch.inference_mode``, and decode updates
the cache in place (the same memory effect as the donation).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch import trace
from repro_torch.models.model import Cache, Model, Params


@dataclasses.dataclass
class ServeState:
    cache: Cache
    last_tokens: torch.Tensor   # (B, 1) int64
    pos: int                    # next position to write
    request: int = 0            # the engine's count of prefills


class ServeEngine:
    """``prefill`` takes the whole batch of ``prefill_batch_specs`` (tokens,
    and encdec's ``enc_frames``/``enc_len`` or vlm's ``img_embeds``/
    ``positions``) to the model."""

    def __init__(self, model: Model, params: Params, max_len: int):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.prefills = 0

    @torch.inference_mode()
    def prefill(self, batch: Dict[str, torch.Tensor]) -> ServeState:
        """Traced as ``serve.prefill``; its request, the count of
        prefills, goes with the state to the decode steps."""
        self.prefills += 1
        with trace.span("serve.prefill", request=self.prefills):
            logits, cache = self.model.prefill(self.params, batch,
                                               max_len=self.max_len)
            first = torch.argmax(logits, dim=-1)[:, None]
            prompt_len = batch["tokens"].shape[1]
            if self.model.cfg.family == "vlm":   # the image tokens first
                prompt_len += batch["img_embeds"].shape[1]
            return ServeState(cache=cache, last_tokens=first,
                              pos=prompt_len, request=self.prefills)

    @torch.inference_mode()
    def step(self, state: ServeState) -> Tuple[torch.Tensor, ServeState]:
        """Traced as ``serve.step``."""
        if state.pos >= self.max_len:
            raise ValueError(f"ServeEngine: position {state.pos} is past "
                             f"max_len {self.max_len}")
        with trace.span("serve.step", request=state.request):
            logits, cache = self.model.decode_step(
                self.params, state.last_tokens, state.cache, state.pos)
            nxt = torch.argmax(logits, dim=-1)[:, None]
            return nxt, ServeState(cache=cache, last_tokens=nxt,
                                   pos=state.pos + 1, request=state.request)

    def generate(self, state: ServeState, steps: int
                 ) -> Tuple[torch.Tensor, ServeState]:
        """``steps`` greedy tokens (B, steps), the first from the prefill."""
        toks = [state.last_tokens]
        for _ in range(steps - 1):
            nxt, state = self.step(state)
            toks.append(nxt)
        return torch.cat(toks, dim=1), state
