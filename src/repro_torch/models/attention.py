"""GQA attention: the ``attn`` and ``local`` layers, whisper's
bidirectional encoder and ``cross`` attention; PyTorch port of
``repro.models.attention``.

The full-sequence (prefill) path goes through kernel K4
(:func:`repro_torch.kernels.flash_attention.ops.flash_attention`), which
computes the function ``blockwise_attention`` computes in the JAX package:
causal attention, with a sliding window on ``local`` layers; non-causal
for the encoder and cross-attention, the latter with the per-batch key
length ``kv_len`` (``enc_len``).  The single-token decode paths are plain
torch, as they are plain jnp there.  ``blockwise_attention``'s
``q_offset`` has no caller there and is not ported.

The padded-key rule, made explicit here and nowhere else.
``blockwise_attention`` pads K and V with zero rows up to a multiple of
``min(block_k, Sk)`` (``src/repro/models/attention.py:113-118``) and masks
them only under ``causal`` or ``kv_len``; so in a non-causal call without
``kv_len`` each zero key scores 0 and enters every softmax denominator
(whisper's encoder, block 512, ``enc_seq`` 1,500: 36 such keys).  K4 and
``flash_attention_ref`` compute exact attention, so ``bidirectional``
appends the same zero rows before K4 when it is given no ``kv_len``
(block 512 for the encoder, ``cfg.attn_block_k`` for cross-attention);
with ``kv_len`` the pad would be masked anyway, and it appends none.
Causal calls need none: a padded key lies past every query.

Unlike the JAX functions, ``fill_kv_cache`` and ``attend_decode`` write
the cache in place and return the same tensors.

On the mesh path x and the projections are DTensors: q, k and v come out
split by batch over the data axes and by heads over ``model`` where the
sharding rules split ``wq`` (``wk``, ``wv``), so each rank reshapes and
rotates its local heads, and K4 runs on them (``fa_ops.flash_attention``
takes DTensors; where the KV heads do not divide ``model``, ``wk`` and
``wv`` are whole and each rank attends with its query heads' KV heads).
Whisper's ``enc_len`` comes split over the data axes like the batch.
Decode on the mesh: ``fill_kv_cache`` and ``attend_decode`` write into a
cache placed by ``cache_shardings`` on the ranks whose shards hold the
slots (offsets from ``dtensor.local_shape_and_offset``), and the
single-token attention runs on each rank's batch rows and heads over the
cache gathered whole along its sequence.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as L
from repro_torch.parallel import dtensor as D

NEG_INF = -1e30
ENCODER_BLOCK = 512       # blockwise_attention's default block_k


def attn_init(g: torch.Generator, cfg: ModelConfig, cross: bool = False
              ) -> nn.ParameterDict:
    """Projections wq, wk, wv, wo; q/k/v biases where ``cfg.qkv_bias``,
    except on cross-attention; q/k norms where ``cfg.qk_norm``."""
    d, dt = cfg.d_model, L.dtype_of(cfg.dtype)
    s = float(1.0 / np.sqrt(d))
    p = {"wq": L._normal((d, cfg.q_dim), s, dt, g),
         "wk": L._normal((d, cfg.kv_dim), s, dt, g),
         "wv": L._normal((d, cfg.kv_dim), s, dt, g),
         "wo": L._normal((cfg.q_dim, d), s, dt, g)}
    z = dict(dtype=dt, device=g.device)
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros(cfg.q_dim, **z)
        p["bk"] = torch.zeros(cfg.kv_dim, **z)
        p["bv"] = torch.zeros(cfg.kv_dim, **z)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(cfg.head_dim, **z)
        p["k_norm"] = torch.ones(cfg.head_dim, **z)
    return nn.ParameterDict({k: L.param(v) for k, v in p.items()})


def _project_qkv(p, cfg: ModelConfig, x, kv_x, positions, kv_positions):
    """Returns q (B,Sq,H,D), k/v (B,Sk,KV,D): queries from ``x``, keys and
    values from ``kv_x``; RoPE (M-RoPE where ``cfg.mrope``, positions
    (3, B, S)) only when ``positions`` is not None."""
    b, sq, _ = x.shape
    sk = kv_x.shape[1]
    q = x @ p["wq"]
    k = kv_x @ p["wk"]
    v = kv_x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, sq, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, sk, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, sk, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm({"scale": p["q_norm"]}, q, cfg.norm_eps)
        k = L.rmsnorm({"scale": p["k_norm"]}, k, cfg.norm_eps)
    if positions is not None and cfg.pos_kind == "rope":
        rope = L.apply_mrope if cfg.mrope else L.apply_rope
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def bidirectional(q, k, v, *, block: int, kv_len=None):
    """Non-causal attention through K4, as ``blockwise_attention(q, k, v,
    causal=False, kv_len=kv_len, block_k=block)`` computes it: without
    ``kv_len``, with the reference's zero-padded keys (module docstring)."""
    if kv_len is None:
        pad = (-k.shape[1]) % min(block, k.shape[1])
        if pad:
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return fa_ops.flash_attention(q, k, v, causal=False, window=0,
                                  kv_len=kv_len)


def attend_train(p, cfg: ModelConfig, x, positions, *, kind: str,
                 enc_out=None, enc_len=None, return_kv: bool = False):
    """Full-sequence attention for prefill; kind: attn|local (causal
    self-attention) or cross (queries from ``x``, keys and values from the
    encoder's ``enc_out``, keys past ``enc_len`` masked; no RoPE).
    Returns (B, S, d_model), or ((B, S, d), (k, v)) when return_kv."""
    if kind == "cross":
        q, k, v = _project_qkv(p, cfg, x, enc_out, None, None)
        out = bidirectional(q, k, v, block=cfg.attn_block_k, kv_len=enc_len)
    else:
        q, k, v = _project_qkv(p, cfg, x, x, positions, positions)
        out = fa_ops.flash_attention(
            q, k, v, causal=True, window=cfg.window if kind == "local" else 0)
    b, s = x.shape[:2]
    y = out.reshape(b, s, cfg.q_dim) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def attend_encoder(p, cfg: ModelConfig, x):
    """Whisper's encoder self-attention: bidirectional, no RoPE, the
    reference's default block of 512 (so its zero-padded keys)."""
    q, k, v = _project_qkv(p, cfg, x, x, None, None)
    out = bidirectional(q, k, v, block=ENCODER_BLOCK)
    b, s = x.shape[:2]
    return out.reshape(b, s, cfg.q_dim) @ p["wo"]


def fill_kv_cache(cache_k, cache_v, k, v, kind: str, window: int):
    """Write a prefill's K/V (B, S, KV, D) into a decode cache, in place.

    Full attention: positions [0, S) go to slots [0, S).  Local: only the
    last C = cache length positions survive, at their ring-buffer slots
    (slot = pos % C), matching attend_decode's addressing."""
    s = k.shape[1]
    c = cache_k.shape[1]
    if D.is_dt(cache_k):
        for cache, new in ((cache_k, k), (cache_v, v)):
            (_, cl, _, _), (_, off, _, _) = D.local_shape_and_offset(
                cache.shape, cache.device_mesh, cache.placements)
            _fill_local(cache.to_local(), _like_cache(new, cache).to_local(),
                        off, cl, c, kind)
    elif kind == "local" and s > c:
        slots = torch.arange(s - c, s, device=k.device) % c
        cache_k[:, slots] = k[:, s - c:]
        cache_v[:, slots] = v[:, s - c:]
    else:
        n = min(s, c)
        cache_k[:, :n] = k[:, :n]
        cache_v[:, :n] = v[:, :n]
    return cache_k, cache_v


def _like_cache(new, cache):
    """A DTensor ``new`` (B, S, KV, D) placed as the DTensor ``cache`` on
    every dim but the sequence (dim 1), which it keeps whole, so that each
    rank holds the batch rows and KV heads of its cache shard."""
    from torch.distributed.tensor import Replicate
    place = [Replicate() if p.is_shard(1) else p for p in cache.placements]
    return (new if list(new.placements) == place
            else new.redistribute(placements=place))


def _fill_local(dst, k, off: int, n: int, c: int, kind: str) -> None:
    """``fill_kv_cache`` of one rank: cache slots [off, off + n) of C = c
    (``dst``, its local shard) from the whole sequence of K or V ``k``."""
    s = k.shape[1]
    if kind == "local" and s > c:      # slot t holds the p in [s-c, s)
        t = torch.arange(off, off + n, device=k.device)      # with p % c = t
        dst.copy_(k.index_select(1, (s - c) + (t - (s - c)) % c))
    elif min(off + n, s) > off:
        dst[:, :min(off + n, s) - off] = k[:, off:min(off + n, s)]


def _write_slot(cache, new, slot) -> None:
    """Write each batch row's new K or V (a DTensor (B, 1, KV, D)) into
    cache slot ``slot`` (a plain (B,) tensor) of the DTensor ``cache``, on
    the rank whose shard holds that slot; a where in place of a mask, so
    no shape depends on the data."""
    (bl, cl, _, _), (boff, off, _, _) = D.local_shape_and_offset(
        cache.shape, cache.device_mesh, cache.placements)
    new = _like_cache(new, cache).to_local()[:, 0]
    t = slot[boff:boff + bl] - off
    mine = (t >= 0) & (t < cl)
    t = t.clamp(0, cl - 1)
    rows = torch.arange(bl, device=t.device)
    dst = cache.to_local()
    dst[rows, t] = torch.where(mine[:, None, None], new, dst[rows, t])


def _attend_cache(q, k, v, live):
    """One query per row against a cache: q (b, 1, H, D), k/v (b, C, KV, D)
    (query head h reads KV head h // (H / KV)), ``live`` (b, C) bool or
    None (all live).  Returns (b, 1, H * D) in v's dtype."""
    b, _, h, d = q.shape
    kv = k.shape[2]
    qh = q.reshape(b, kv, h // kv, d)
    s = torch.einsum("bkgd,btkd->bkgt", qh.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(d)
    if live is not None:
        s = torch.where(live[:, None, None, :], s, NEG_INF)
    o = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", o.to(v.dtype), v)
    return out.reshape(b, 1, h * d)


def _attend_cache_mesh(q, k, v, live_of):
    """``_attend_cache`` of DTensors on each rank's shards: q (B, 1, H, D)
    split by batch and heads; k, v (B, C, KV, D) placed as
    ``cache_shardings`` places a cache, gathered here over a mesh dim that
    splits their sequence (DTensor's all-gather).  Each rank attends with
    its query heads' KV heads (where ``model`` splits q's heads and not
    k's, one KV head per query head); ``live_of(off, n)`` gives the live
    mask (n, C) of global batch rows [off, off + n), or None.  Returns a
    DTensor (B, 1, H * D) placed like q."""
    from torch.distributed.tensor import DTensor
    k, v = D.unsplit(k, 1), D.unsplit(v, 1)
    mesh = q.device_mesh
    (bl, _, hl, d), (boff, _, hoff, _) = D.local_shape_and_offset(
        q.shape, mesh, q.placements)
    (kbl, _, kvl, _), (_, _, koff, _) = D.local_shape_and_offset(
        k.shape, mesh, k.placements)
    if kbl != bl:
        raise ValueError("attend_decode: the cache's batch is not split "
                         "like the tokens'")
    group = q.shape[2] // k.shape[2]
    kl, vl = k.to_local(), v.to_local()
    need = [(hoff + i) // group - koff for i in range(hl)]
    if need != [i // group for i in range(hl)] or hl // group != kvl:
        idx = torch.tensor(need, device=kl.device)
        kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    out = _attend_cache(q.to_local(), kl, vl, live_of(boff, bl))
    shape = (q.shape[0], 1, q.shape[2] * q.shape[3])
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def attend_decode(p, cfg: ModelConfig, x, cache_k, cache_v, pos, *,
                  kind: str, positions=None):
    """Single-token decode.  x: (B, 1, d); cache_k/v: (B, C, KV, D) where
    C = max_len (full) or window (local, ring buffer).  pos: int or (B,)
    absolute position of the new token; ``positions``, its RoPE positions
    where they are not (B, 1) = pos (M-RoPE's (3, B, 1)).  Writes the new
    K/V into the cache in place; returns (y, cache_k, cache_v)."""
    b = x.shape[0]
    c = cache_k.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int64,
                          device=x.device).expand(b)
    if positions is None:
        positions = pos[:, None]
    q, k_new, v_new = _project_qkv(p, cfg, x, x, positions, positions)
    slot = pos % c if kind == "local" else pos      # ring buffer for local

    def live_of(off: int, n: int):
        """Whether each cache slot holds a live key, rows [off, off + n)."""
        at = pos[off:off + n, None]
        slots = torch.arange(c, device=x.device)[None, :]      # (1, C)
        if kind == "local":
            # slot t holds the most recent position p <= pos with p % C == t
            abs_pos = at - ((at - slots) % c)
            return (abs_pos >= 0) & (abs_pos > at - cfg.window) & \
                (abs_pos <= at)
        return slots <= at

    if D.is_dt(x):
        _write_slot(cache_k, k_new, slot)
        _write_slot(cache_v, v_new, slot)
        out = _attend_cache_mesh(q, cache_k, cache_v, live_of)
    else:
        rows = torch.arange(b, device=x.device)
        cache_k[rows, slot] = k_new[:, 0]
        cache_v[rows, slot] = v_new[:, 0]
        out = _attend_cache(q, cache_k, cache_v, live_of(0, b))
    return out @ p["wo"], cache_k, cache_v


def attend_decode_cross(p, cfg: ModelConfig, x, enc_k, enc_v, enc_len):
    """Cross-attention of one decode token.  x: (B, 1, d); enc_k/v:
    (B, T, KV, D), the encoder's keys and values from the prefill;
    enc_len: (B,) or None, keys at or past it masked.  q is ``x @ wq``
    alone: no bias, norm or RoPE, as in the JAX package."""
    b = x.shape[0]
    q = (x @ p["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    if enc_len is not None:
        enc_len = D.whole(enc_len)
        enc_len = enc_len.to_local() if D.is_dt(enc_len) else enc_len

    def live_of(off: int, n: int):
        if enc_len is None:
            return None
        return torch.arange(enc_k.shape[1], device=x.device)[None, :] \
            < enc_len[off:off + n, None]

    if D.is_dt(x):
        out = _attend_cache_mesh(q, enc_k, enc_v, live_of)
    else:
        out = _attend_cache(q, enc_k, enc_v, live_of(0, b))
    return out @ p["wo"]
