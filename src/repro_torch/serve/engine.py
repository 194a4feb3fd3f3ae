"""Serving engine: prefill + greedy decode; PyTorch port of
``repro.serve.engine``.

The JAX engine jits prefill and decode and donates the cache to decode.
Here both run eagerly under ``torch.inference_mode``, and decode updates
the cache in place (the same memory effect as the donation).  With
``cuda_graph`` a decode step on one card is instead the replay of a CUDA
graph captured once for its batch size, so it costs the host one replay
instead of a launch for each operation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.models.model import Cache, Model, Params
from repro_torch.parallel import dtensor as D


@dataclasses.dataclass
class ServeState:
    cache: Cache
    last_tokens: torch.Tensor   # (B, 1) int64
    pos: int                    # next position to write
    request: int = 0            # the engine's count of prefills
    logits: Optional[torch.Tensor] = None   # (B, V): last_tokens' logits


class _DecodeGraph:
    """One decode step of a batch of ``batch`` rows captured as a CUDA
    graph over static inputs (tokens (B, 1), the position as a 0-d device
    tensor, a cache of its own) and outputs (logits, next tokens).
    ``owner`` is the request whose cache the graph's cache holds."""

    def __init__(self, engine: "ServeEngine", batch: int,
                 tokens: torch.Tensor):
        model, dev = engine.model, tokens.device
        self.tokens = torch.zeros_like(tokens)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.cache = model.init_cache(batch, engine.max_len, dev)
        self.owner: Optional[int] = None

        def run():
            logits, _ = model.decode_step(engine.params, self.tokens,
                                          self.cache, self.pos)
            return logits, torch.argmax(logits, dim=-1)[:, None]

        # lazy set-up (libraries' handles and workspaces) off the graph,
        # on a side stream as capture requires
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                run()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, self.next = run()

    def step(self, state: ServeState) -> Tuple[torch.Tensor, torch.Tensor]:
        """Replay at ``state``: its cache is copied into the graph's once
        (the graph's cache then is the state's); returns fresh (logits,
        next tokens)."""
        if state.cache is not self.cache:
            for mine, theirs in zip(self.cache, state.cache):
                for k, t in theirs.items():
                    mine[k].copy_(t)
            self.owner = state.request
        elif self.owner != state.request:
            raise ValueError(
                f"ServeEngine: request {state.request}'s cache was taken by "
                f"request {self.owner}'s decode (one request a batch size "
                f"decodes at a time through the graph)")
        self.pos.fill_(state.pos)
        self.tokens.copy_(state.last_tokens)
        self.graph.replay()
        return self.logits.clone(), self.next.clone()


class ServeEngine:
    """``prefill`` takes the whole batch of ``prefill_batch_specs`` (tokens,
    and encdec's ``enc_frames``/``enc_len`` or vlm's ``img_embeds``/
    ``positions``) to the model.  ``cuda_graph``: decode steps of tokens on
    a card (not on a mesh) replay one CUDA graph a batch size, captured at
    the first such step (the graph holds a cache of its own, into which a
    request's cache is copied at its first step); elsewhere the flag does
    nothing."""

    def __init__(self, model: Model, params: Params, max_len: int,
                 cuda_graph: bool = False):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.prefills = 0
        self.cuda_graph = cuda_graph
        self._graphs: Dict[int, _DecodeGraph] = {}

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
                              pos=prompt_len, request=self.prefills,
                              logits=logits)

    @torch.inference_mode()
    def step(self, state: ServeState) -> Tuple[torch.Tensor, ServeState]:
        """Traced as ``serve.step``."""
        if state.pos >= self.max_len:
            raise ValueError(f"ServeEngine: position {state.pos} is past "
                             f"max_len {self.max_len}")
        tokens = state.last_tokens
        with trace.span("serve.step", request=state.request):
            if (self.cuda_graph and tokens.device.type == "cuda"
                    and not D.is_dt(tokens)):
                b = tokens.shape[0]
                g = self._graphs.get(b)
                if g is None:
                    g = self._graphs[b] = _DecodeGraph(self, b, tokens)
                logits, nxt = g.step(state)
                cache = g.cache
            else:
                logits, cache = self.model.decode_step(
                    self.params, tokens, state.cache, state.pos)
                nxt = torch.argmax(logits, dim=-1)[:, None]
            return nxt, ServeState(cache=cache, last_tokens=nxt,
                                   pos=state.pos + 1, request=state.request,
                                   logits=logits)

    def generate(self, state: ServeState, steps: int
                 ) -> Tuple[torch.Tensor, ServeState]:
        """``steps`` greedy tokens (B, steps), the first from the prefill."""
        toks = [state.last_tokens]
        for _ in range(steps - 1):
            nxt, state = self.step(state)
            toks.append(nxt)
        return torch.cat(toks, dim=1), state
