"""Plain PyTorch version of the flash-attention kernel (K4).

Computes what ``flash_attention_ref`` of the JAX package computes (a
materialized softmax in float32, scale 1/sqrt(D), causal and sliding-window
masks with absolute positions from 0 in both q and k, a fully masked row
gives 0), in the model's layout and with GQA folded by a reshape instead of
a repeat of K/V.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, KV, D), H % KV == 0 -> (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.to(torch.float32).reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.to(torch.float32)) \
        / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(torch.float32))
    denom = p.sum(dim=-1).clamp_min(1e-30)                 # (B, KV, G, Sq)
    o = o / denom.permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, sq, h, d).to(q.dtype)


def row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest error of ``got`` against ``want`` (..., D), each row's
    largest element error over that row's RMS.  An absolute error hides a
    fault in rows whose outputs are small (a row that averages n keys has
    |o| ~ n**-0.5); this measure weighs every row alike."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(dim=-1).sqrt()
    err = (g - w).abs().amax(dim=-1)
    return (err / rms.clamp_min(1e-30)).max().item() if err.numel() else 0.0
