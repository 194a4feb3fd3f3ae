"""Plain PyTorch version of mamba2's SSD decode mixer (K5).

The arithmetic of one decode step between ``in_proj`` and ``out_proj``,
as the JAX package's ``ssm_apply_decode`` computes it: the conv window
shifted by one and the depthwise conv with SiLU, dt's softplus and the
decay, the float32 state update, ``y = C.s + D.x`` and the gated RMS
norm.  Both caches are updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def ssm_decode_mixer_ref(proj, conv_cache, ssd_cache, conv_w, conv_b,
                         dt_bias, a_log, d_skip, norm, eps: float
                         ) -> torch.Tensor:
    """proj (B, W) = [z (di), xBC (C), dt (H)]; conv_cache (B, K-1, C);
    ssd_cache (B, H, N, P) float32.  Returns y (B, di) in proj's dtype."""
    b = proj.shape[0]
    ch = conv_w.shape[1]
    nh, ns, hd = ssd_cache.shape[1:]
    di = nh * hd
    z, xbc, dt_raw = proj[:, :di], proj[:, di:di + ch], proj[:, di + ch:]
    win = torch.cat([conv_cache, xbc[:, None, :]], dim=1)
    conv = F.silu(torch.einsum("bkc,kc->bc", win, conv_w) + conv_b)
    xs = conv[..., :di].reshape(b, nh, hd)
    bmat = conv[..., di:di + ns].to(torch.float32)
    cmat = conv[..., di + ns:].to(torch.float32)
    dt = L.softplus(dt_raw.to(torch.float32) + dt_bias)        # (B, H)
    dec = torch.exp(dt * -torch.exp(a_log))
    xf = xs.to(torch.float32)
    upd = bmat[:, None, :, None] * (dt[..., None] * xf)[:, :, None, :]
    s_new = ssd_cache * dec[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", cmat, s_new)
    y = y + d_skip[None, :, None] * xf
    y = y.reshape(b, 1, di).to(proj.dtype)
    y = L.gated_norm(y, z[:, None, :], norm, eps)
    conv_cache.copy_(win[:, 1:])
    ssd_cache.copy_(s_new)
    return y.reshape(b, di)
