"""Model assembly for the dense family; PyTorch port of
``repro.models.model``.

The JAX package scans one period of the layer pattern over stacked
parameters; here the layers are an ``nn.ModuleList`` in absolute layer
order (layer i has kind ``cfg.pattern_layers[i]``), run by a Python loop.
``convert.params_from_numpy`` maps the JAX tree onto that order.

Entry points:
  init(generator)                          -> params
  forward(params, batch)                   -> (logits, aux)
  prefill(params, batch, max_len)          -> (last logits, cache)
  decode_step(params, tokens, cache, pos)  -> (logits, cache)
  init_cache(batch_size, max_len, device)  -> cache

The cache is a list with one ``{"k", "v"}`` dict per layer; ``prefill``
fills a fresh one and ``decode_step`` updates it in place.  The moe, ssm,
hybrid, encdec and vlm families are not ported yet (ROADMAP.md, "Modules to
port"), nor is ``loss_fn`` (the training slice).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

Cache = List[Dict[str, torch.Tensor]]


# ===================================================================== blocks
def _block_init(g: torch.Generator, cfg: ModelConfig) -> nn.ModuleDict:
    dt = L.dtype_of(cfg.dtype)
    return nn.ModuleDict({
        "norm1": L.rmsnorm_init(cfg.d_model, dt, g.device),
        "attn": A.attn_init(g, cfg),
        "norm2": L.rmsnorm_init(cfg.d_model, dt, g.device),
        "mlp": L.mlp_init(g, cfg, cfg.d_ff),
    })


def _block_apply_train(p, cfg: ModelConfig, kind: str, h, positions,
                       cache=None):
    """One block over the full sequence.  With ``cache`` (prefill) the
    block's K/V are written into it with decode-compatible addressing."""
    x = L.rmsnorm(p["norm1"], h, cfg.norm_eps)
    if cache is not None:
        y, (k, v) = A.attend_train(p["attn"], cfg, x, positions, kind=kind,
                                   return_kv=True)
        A.fill_kv_cache(cache["k"], cache["v"], k, v, kind, cfg.window)
    else:
        y = A.attend_train(p["attn"], cfg, x, positions, kind=kind)
    h = h + y
    x2 = L.rmsnorm(p["norm2"], h, cfg.norm_eps)
    return h + L.mlp_apply(p["mlp"], x2, cfg.mlp_kind)


def _block_apply_decode(p, cfg: ModelConfig, kind: str, h, cache, pos):
    """One block, single token; updates ``cache`` in place."""
    x = L.rmsnorm(p["norm1"], h, cfg.norm_eps)
    y, _, _ = A.attend_decode(p["attn"], cfg, x, cache["k"], cache["v"],
                              pos, kind=kind)
    h = h + y
    x2 = L.rmsnorm(p["norm2"], h, cfg.norm_eps)
    return h + L.mlp_apply(p["mlp"], x2, cfg.mlp_kind)


class Params(nn.Module):
    """The dense model's parameters: ``embed`` ({"tok", "lm_head"}),
    ``blocks`` (one ModuleDict per layer, absolute order) and
    ``final_norm`` ({"scale"})."""

    def __init__(self, embed: nn.ParameterDict, blocks: List[nn.ModuleDict],
                 final_norm: nn.ParameterDict):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm


# ==================================================================== model
@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator) -> Params:
        """Random weights drawn from ``generator`` on its device, at the JAX
        package's scales (the numbers differ: another generator)."""
        cfg, g = self.cfg, generator
        embed = L.embed_init(g, cfg)
        blocks = [_block_init(g, cfg) for _ in range(cfg.n_layers)]
        return Params(embed, blocks,
                      L.rmsnorm_init(cfg.d_model, L.dtype_of(cfg.dtype),
                                     g.device))

    # ------------------------------------------------------------- forward
    def _embed_inputs(self, params: Params, tokens: torch.Tensor):
        h = L.embed_tokens(params.embed, tokens)
        b, s = tokens.shape
        positions = torch.arange(s, device=h.device).expand(b, s)
        return h, positions

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
        return L.lm_logits(params.embed, h, cfg.tie_embeddings,
                           out_dtype=L.dtype_of(cfg.logits_dtype),
                           true_vocab=cfg.vocab)

    def forward(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  Returns (logits (B, S, V), aux loss)."""
        h, positions = self._embed_inputs(params, batch["tokens"])
        for p, kind in zip(params.blocks, self.cfg.pattern_layers):
            h = _block_apply_train(p, self.cfg, kind, h, positions)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return self._logits(params, h), aux

    # -------------------------------------------------------------- prefill
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_len: int) -> Tuple[torch.Tensor, Cache]:
        """Process a full prompt.  Returns (last-position logits (B, V),
        filled cache); ``decode_step`` continues from position S."""
        h, positions = self._embed_inputs(params, batch["tokens"])
        cache = self.init_cache(h.shape[0], max_len, h.device)
        for p, c, kind in zip(params.blocks, cache, self.cfg.pattern_layers):
            h = _block_apply_train(p, self.cfg, kind, h, positions, cache=c)
        return self._logits(params, h[:, -1:])[:, 0], cache

    # --------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, device="cuda") -> Cache:
        cfg = self.cfg
        dev = resolve_device(device)
        dt = L.dtype_of(cfg.dtype)
        cache = []
        for kind in cfg.pattern_layers:
            c = min(cfg.window, max_len) if (kind == "local" and cfg.window) \
                else max_len
            shape = (batch, c, cfg.n_kv_heads, cfg.head_dim)
            cache.append({"k": torch.zeros(shape, dtype=dt, device=dev),
                          "v": torch.zeros(shape, dtype=dt, device=dev)})
        return cache

    # -------------------------------------------------------------- decode
    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Cache,
                    pos) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, 1); pos: absolute position (int or (B,)).  Returns
        (logits (B, V), cache), the cache updated in place."""
        h = L.embed_tokens(params.embed, tokens)
        pos = torch.as_tensor(pos, dtype=torch.int64, device=h.device)
        for p, c, kind in zip(params.blocks, cache, self.cfg.pattern_layers):
            h = _block_apply_decode(p, self.cfg, kind, h, c, pos)
        return self._logits(params, h)[:, 0], cache


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"build_model: family {cfg.family!r} is not ported yet "
            f"(ROADMAP.md, \"Modules to port\": moe, ssm, hybrid, encdec "
            f"and vlm come in later slices); only 'dense' is")
    return Model(cfg)
