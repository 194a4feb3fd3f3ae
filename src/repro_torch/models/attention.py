"""GQA attention (the ``attn`` and ``local`` layers of the dense, moe and
hybrid families); PyTorch port of ``repro.models.attention``.

The full-sequence (prefill) path goes through kernel K4
(:func:`repro_torch.kernels.flash_attention.ops.flash_attention`), which
computes the function ``blockwise_attention`` computes in the JAX package:
causal attention, with a sliding window on ``local`` layers.  The
single-token decode path is plain torch, as it is plain jnp there.  The
``cross`` kind, ``kv_len`` and ``q_offset`` belong to the encdec family,
which is not ported yet (ROADMAP.md, "Modules to port").

Unlike the JAX functions, ``fill_kv_cache`` and ``attend_decode`` write
the cache in place and return the same tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as L

NEG_INF = -1e30


def attn_init(g: torch.Generator, cfg: ModelConfig) -> nn.ParameterDict:
    d, dt = cfg.d_model, L.dtype_of(cfg.dtype)
    s = float(1.0 / np.sqrt(d))
    p = {"wq": L._normal((d, cfg.q_dim), s, dt, g),
         "wk": L._normal((d, cfg.kv_dim), s, dt, g),
         "wv": L._normal((d, cfg.kv_dim), s, dt, g),
         "wo": L._normal((cfg.q_dim, d), s, dt, g)}
    z = dict(dtype=dt, device=g.device)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.q_dim, **z)
        p["bk"] = torch.zeros(cfg.kv_dim, **z)
        p["bv"] = torch.zeros(cfg.kv_dim, **z)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(cfg.head_dim, **z)
        p["k_norm"] = torch.ones(cfg.head_dim, **z)
    return nn.ParameterDict({k: L.param(v) for k, v in p.items()})


def _project_qkv(p, cfg: ModelConfig, x, positions):
    """Returns q (B,S,H,D), k/v (B,S,KV,D) with RoPE applied."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm({"scale": p["q_norm"]}, q, cfg.norm_eps)
        k = L.rmsnorm({"scale": p["k_norm"]}, k, cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attend_train(p, cfg: ModelConfig, x, positions, *, kind: str,
                 return_kv: bool = False):
    """Full-sequence causal self-attention for prefill; kind: attn|local.
    Returns (B, S, d_model), or ((B, S, d), (k, v)) when return_kv."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = fa_ops.flash_attention(
        q, k, v, causal=True, window=cfg.window if kind == "local" else 0)
    b, s = x.shape[:2]
    y = out.reshape(b, s, cfg.q_dim) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def fill_kv_cache(cache_k, cache_v, k, v, kind: str, window: int):
    """Write a prefill's K/V (B, S, KV, D) into a decode cache, in place.

    Full attention: positions [0, S) go to slots [0, S).  Local: only the
    last C = cache length positions survive, at their ring-buffer slots
    (slot = pos % C), matching attend_decode's addressing."""
    s = k.shape[1]
    c = cache_k.shape[1]
    if kind == "local" and s > c:
        slots = torch.arange(s - c, s, device=k.device) % c
        cache_k[:, slots] = k[:, s - c:]
        cache_v[:, slots] = v[:, s - c:]
    else:
        n = min(s, c)
        cache_k[:, :n] = k[:, :n]
        cache_v[:, :n] = v[:, :n]
    return cache_k, cache_v


def attend_decode(p, cfg: ModelConfig, x, cache_k, cache_v, pos, *,
                  kind: str):
    """Single-token decode.  x: (B, 1, d); cache_k/v: (B, C, KV, D) where
    C = max_len (full) or window (local, ring buffer).  pos: int or (B,)
    absolute position of the new token.  Writes the new K/V into the cache
    in place; returns (y, cache_k, cache_v)."""
    b = x.shape[0]
    c = cache_k.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int64,
                          device=x.device).expand(b)
    q, k_new, v_new = _project_qkv(p, cfg, x, pos[:, None])
    slot = pos % c if kind == "local" else pos      # ring buffer for local
    rows = torch.arange(b, device=x.device)
    cache_k[rows, slot] = k_new[:, 0]
    cache_v[rows, slot] = v_new[:, 0]

    g = cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(b, cfg.n_kv_heads, g, cfg.head_dim)
    s = torch.einsum("bkgd,btkd->bkgt", qh.to(torch.float32),
                     cache_k.to(torch.float32)) / math.sqrt(cfg.head_dim)
    # validity: absolute position of each cache slot
    slots = torch.arange(c, device=x.device)[None, :]          # (1, C)
    if kind == "local":
        # slot t holds the most recent position p <= pos with p % C == t
        abs_pos = pos[:, None] - ((pos[:, None] - slots) % c)
        live = (abs_pos >= 0) & (abs_pos > pos[:, None] - cfg.window) & \
               (abs_pos <= pos[:, None])
    else:
        live = slots <= pos[:, None]
    s = torch.where(live[:, None, None, :], s, NEG_INF)
    o = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", o.to(cache_v.dtype), cache_v)
    y = out.reshape(b, 1, cfg.q_dim) @ p["wo"]
    return y, cache_k, cache_v
