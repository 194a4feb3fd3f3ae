"""Plain PyTorch versions of the flash-attention kernels: the forward (K4)
and its backward (K4b).

``flash_attention_ref`` computes what ``flash_attention_ref`` of the JAX
package computes (a materialized softmax in float32, scale 1/sqrt(D),
causal and sliding-window masks with absolute positions from 0 in both q
and k, a fully masked row gives 0), with the per-batch key length
``kv_len`` of ``blockwise_attention`` on top (key j of batch row b is live
only if j < kv_len[b]), in the model's layout and with GQA
folded by a reshape instead of a repeat of K/V.  ``flash_attention_bwd_ref``
writes out the backward's formulas on the same materialized scores.  Both
compute in float32, or in float64 for float64 inputs (gradcheck).
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        kv_len: torch.Tensor = None,
                        return_lse: bool = False):
    """q (B, Sq, H, D); k, v (B, Sk, KV, D), H % KV == 0 -> (B, Sq, H, D).
    ``kv_len``: None, or int32 / int64 (B,).

    With ``return_lse``, also each row's log-sum-exp of the scaled, masked
    scores, float32 (B, H, Sq) (float64 for float64 inputs): +inf for a row
    with no live key, for which exp(s - lse) is 0, as K4 writes it."""
    b, sq, h, d = q.shape
    p, denom, lse = _probs(q, k, causal, window, kv_len)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(_compute_dtype(q)))
    o = o / denom.permute(0, 3, 1, 2)[..., None]
    o = o.reshape(b, sq, h, d).to(q.dtype)
    return (o, lse.reshape(b, h, sq)) if return_lse else o


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    return torch.promote_types(q.dtype, torch.float32)


def _scores(q, k, causal: bool, window: int, kv_len=None):
    """Scaled scores (B, KV, G, Sq, Sk), -1e30 where masked, and the mask
    (Sq, Sk), or (B, 1, 1, Sq, Sk) with ``kv_len``."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    ct = _compute_dtype(q)
    qf = q.to(ct).reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.to(ct)) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    if kv_len is not None:
        live = kpos < kv_len.to(q.device)[:, None, None]       # (B, 1, Sk)
        mask = (mask & live)[:, None, None]
    return torch.where(mask, s, -1e30), mask


def _probs(q, k, causal: bool, window: int, kv_len=None):
    """Unnormalised softmax numerators p (B, KV, G, Sq, Sk), 0 where masked,
    their row sums clamped to 1e-30 (a fully masked row gives 0), and the
    rows' log-sum-exp (B, KV, G, Sq), +inf for a fully masked row."""
    s, mask = _scores(q, k, causal, window, kv_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, 0.0)
    total = p.sum(dim=-1)
    lse = torch.where(total > 0, m[..., 0] + torch.log(total), torch.inf)
    return p, total.clamp_min(1e-30), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            window: int = 0, lse: torch.Tensor = None,
                            kv_len: torch.Tensor = None):
    """Gradients of ``flash_attention_ref`` at ``do``: (dq (B, Sq, H, D),
    dk, dv (B, Sk, KV, D)) in the inputs' dtypes.  ``o`` is the forward's
    output, as the kernel reads it: P = softmax(S), dV = P^T dO,
    dP = dO V^T, dS = P * (dP - Delta) with Delta_i = sum(dO_i * O_i),
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D); dK and dV summed over each
    KV head's G query heads.  Given the forward's ``lse`` (B, H, Sq), P is
    exp(S - lse), as K4b forms it; else the softmax of S.  ``kv_len`` as
    in ``flash_attention_ref``."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    ct = _compute_dtype(q)
    if lse is None:
        p, denom, _ = _probs(q, k, causal, window, kv_len)
        p = p / denom[..., None]                           # (B,KV,G,Sq,Sk)
    else:
        s, mask = _scores(q, k, causal, window, kv_len)
        p = torch.where(mask, torch.exp(
            s - lse.to(ct).reshape(b, kvh, g, sq)[..., None]), 0.0)
    qf = q.to(ct).reshape(b, sq, kvh, g, d)
    dof = do.to(ct).reshape(b, sq, kvh, g, d)
    delta = (dof * o.to(ct).reshape(b, sq, kvh, g, d)).sum(-1)
    dp = torch.einsum("bqkgd,btkd->bkgqt", dof, v.to(ct))
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, k.to(ct)) * scale
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qf) * scale
    dv = torch.einsum("bkgqt,bqkgd->btkd", p, dof)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def row_error(got: torch.Tensor, want: torch.Tensor,
              floor: float = 0.0) -> float:
    """Largest error of ``got`` against ``want`` (..., D), each row's
    largest element error over that row's RMS.  An absolute error hides a
    fault in rows whose outputs are small (a row that averages n keys has
    |o| ~ n**-0.5); this measure weighs every row alike.  ``floor`` > 0
    puts each row's RMS at least at ``floor`` times the whole tensor's:
    for gradients, where a row can be 0 but for rounding (dQ of query 0,
    which sees key 0 alone)."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(dim=-1).sqrt()
    if floor:
        rms = rms.clamp_min(floor * w.pow(2).mean().sqrt())
    err = (g - w).abs().amax(dim=-1)
    return (err / rms.clamp_min(1e-30)).max().item() if err.numel() else 0.0
