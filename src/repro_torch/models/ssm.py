"""Mamba-2 block: the chunked SSD (state-space duality) algorithm for a
full sequence and the O(1)-state decode step (arXiv:2405.21060); PyTorch
port of ``repro.models.ssm``.

The full-sequence path is the JAX package's chunked decomposition: within
chunks of Q positions the quadratic (attention-like) form gives the
intra-chunk outputs, a sequential recurrence over the nc = S / Q chunks
carries the state across them (``lax.scan`` there, a Python loop here),
and one more product adds the inter-chunk part.  State math is float32.
The JAX package contracts three operands at once (``bcij,bcijh,bcjhp``);
here each such product is two steps, an element-wise product and a
batched matrix product over (batch, chunk, head), so no (B, nc, Q, Q, H,
P) tensor is formed.  Decode carries ``{"conv", "ssd"}`` and updates them
in place; its mixer between the two projections is K5
(``kernels/ssm_decode``), the same arithmetic in two CUDA launches.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_decode import ops as K5
from repro_torch.models import layers as L
from repro_torch.parallel import dtensor as dt

FLOAT32 = frozenset({"a_log", "dt_bias", "d_skip"})   # float32 at any dtype


def ssm_init(g: torch.Generator, cfg: ModelConfig) -> nn.ParameterDict:
    d, dt = cfg.d_model, L.dtype_of(cfg.dtype)
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * ns                       # x, B, C go through the conv
    f32 = dict(dtype=torch.float32, device=g.device)
    p = {
        # fused input projection: [z, xBC, dt]
        "in_proj": L._normal((d, 2 * di + 2 * ns + nh), float(1 / np.sqrt(d)),
                             dt, g),
        "conv_w": L._normal((cfg.conv_width, conv_ch),
                            float(1 / np.sqrt(cfg.conv_width)), dt, g),
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=g.device),
        "a_log": torch.tensor(np.log(np.linspace(1.0, 16.0, nh)), **f32),
        "dt_bias": torch.tensor(np.log(np.expm1(np.linspace(1e-3, 0.1, nh))),
                                **f32),
        "d_skip": torch.ones(nh, **f32),
        "norm": torch.ones(di, dtype=dt, device=g.device),
        "out_proj": L._normal((di, d), float(1 / np.sqrt(di)), dt, g),
    }
    return nn.ParameterDict({k: L.param(v) for k, v in p.items()})


def _split_proj(cfg: ModelConfig, proj):
    di, ns = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di + 2 * ns],
            proj[..., 2 * di + 2 * ns:])


def _causal_conv(xbc, w, b):
    """Depthwise causal conv of width K, then SiLU.  xbc: (B, S, C); w:
    (K, C).  Terms added in the JAX package's order."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b)


def ssd_chunked(xh, dt, a, bmat, cmat, chunk: int):
    """SSD over one sequence.

    xh : (B, S, H, P) inputs per head
    dt : (B, S, H)    discretization steps (softplus applied), float32
    a  : (H,)         negative decay rates (A = -exp(a_log))
    bmat, cmat: (B, S, N) input/output projections (single group), float32
    Returns y (B, S, H, P) and the final state (B, H, N, P), float32.
    Traced as ``ssm.chunked``.
    """
    with trace.span("ssm.chunked"):
        return _ssd_chunked(xh, dt, a, bmat, cmat, chunk)


def _ssd_chunked(xh, dt, a, bmat, cmat, chunk: int):
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        # dt = 0 on padding: decay exp(0) = 1 and zero input, state unchanged
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    s_orig, s = s, s + pad
    nc = s // q

    da = dt * a                                            # (B, S, H)
    xw = xh * dt[..., None]                                # float32
    cum = torch.cumsum(da.reshape(b, nc, q, h), dim=2)     # (B,nc,Q,H)
    total = cum[:, :, -1]                                  # (B,nc,H)
    cum_h = cum.transpose(2, 3)                            # (B,nc,H,Q)
    xc = xw.reshape(b, nc, q, h, p).to(torch.float32)
    xc_h = xc.permute(0, 1, 3, 2, 4)                       # (B,nc,H,Q,P)
    bc = bmat.reshape(b, nc, q, n)
    cc = cmat.reshape(b, nc, q, n)

    # intra-chunk (quadratic within a chunk): (C B^T o L) per head, then
    # a product with the chunk's inputs
    scores = cc @ bc.transpose(-1, -2)                     # (B,nc,Q,Q)
    decay = torch.exp(torch.clamp(cum_h[..., :, None] - cum_h[..., None, :],
                                  -60, 0))                 # (B,nc,H,Q,Q)
    causal = torch.ones(q, q, dtype=torch.bool, device=xh.device).tril()
    w = torch.where(causal, scores[:, :, None] * decay, 0.0)
    y = w @ xc_h                                           # (B,nc,H,Q,P)

    # chunk states: S_c = sum_j exp(total - cum_j) B_j (dt_j x_j)^T
    state_decay = torch.exp(torch.clamp(total[:, :, None, :] - cum, -60, 0))
    xs = (xc * state_decay[..., None]).reshape(b, nc, q, h * p)
    s_local = (bc.transpose(-1, -2) @ xs).reshape(b, nc, n, h, p
                                                  ).transpose(2, 3)

    s_before, state = chunk_states(torch.exp(torch.clamp(total, -60, 0)),
                                   s_local)

    # inter-chunk contribution: y_i += exp(cum_i) C_i . S_prev
    in_decay = torch.exp(torch.clamp(cum_h, -60, 0))       # (B,nc,H,Q)
    y = y + (cc[:, :, None] @ s_before) * in_decay[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    return y[:, :s_orig], state


def chunk_states(chunk_decay, s_local):
    """The inter-chunk recurrence, sequential over the nc chunks (the JAX
    package's ``lax.scan``): S_c = S_{c-1} * decay_c + local_c from S = 0.
    chunk_decay (B, nc, H); s_local (B, nc, H, N, P).  Returns the state
    before each chunk (B, nc, H, N, P) and the final state (B, H, N, P)."""
    state = torch.zeros_like(s_local[:, 0])
    before = []
    for c in range(s_local.shape[1]):
        before.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_local[:, c]
    return torch.stack(before, dim=1), state


def ssm_apply_train(p, cfg: ModelConfig, x: torch.Tensor,
                    return_state: bool = False):
    """x: (B, S, d_model) -> (B, S, d_model) [, decode cache].  On DTensors
    the mixer between the two projections runs on each rank's local batch
    rows (``in_proj`` is whole over ``model``, and every step of it is
    per row); ``out_proj`` splits d_inner over ``model`` where the rules
    do."""
    proj = x @ p["in_proj"]
    y, tail, final = dt.local_call(
        functools.partial(_mixer, cfg, return_state), proj,
        p["conv_w"], p["conv_b"], p["dt_bias"], p["a_log"], p["d_skip"],
        p["norm"], like=proj)
    out = y @ p["out_proj"]
    if return_state:
        return out, {"conv": tail, "ssd": final}
    return out


def _mixer(cfg: ModelConfig, with_state: bool, proj, conv_w, conv_b,
           dt_bias, a_log, d_skip, norm):
    """The mixer of (B, S, in_proj width) projections: (the gated-norm
    output (B, S, d_inner), and with ``with_state`` the conv's last K - 1
    inputs and the final SSD state, else None twice)."""
    b, s, _ = proj.shape
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z, xbc_raw, dt_raw = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc_raw, conv_w, conv_b)
    xs = xbc[..., :di].reshape(b, s, nh, cfg.ssm_head_dim)
    bmat = xbc[..., di:di + ns].to(torch.float32)
    cmat = xbc[..., di + ns:].to(torch.float32)
    dt = L.softplus(dt_raw.to(torch.float32) + dt_bias)
    a = -torch.exp(a_log)
    y, final = ssd_chunked(xs, dt, a, bmat, cmat, cfg.ssm_chunk)
    y = y + d_skip[None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, s, di).to(proj.dtype)
    out = L.gated_norm(y, z, norm, cfg.norm_eps)
    if not with_state:
        return out, None, None
    k = conv_w.shape[0]
    return out, F.pad(xbc_raw, (0, 0, k - 1, 0))[:, -(k - 1):], final


def ssm_decode_init(cfg: ModelConfig, batch: int, dtype, device
                    ) -> Dict[str, torch.Tensor]:
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * ns),
                            dtype=dtype, device=device),
        "ssd": torch.zeros((batch, nh, ns, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
    }


def ssm_apply_decode(p, cfg: ModelConfig, x, cache):
    """x: (B, 1, d_model); cache {conv (B, K-1, C), ssd (B, H, N, P)},
    updated in place.  Returns (y (B, 1, d_model), cache).  Traced as
    ``ssm.decode``."""
    with trace.span("ssm.decode"):
        return _ssm_decode(p, cfg, x, cache)


def _ssm_decode(p, cfg: ModelConfig, x, cache):
    """The mixer between the two projections is K5 (``kernels/
    ssm_decode``) on CUDA, its plain version on the CPU.  On DTensors it
    runs on each rank's local batch rows, a cache placed otherwise than
    ``proj`` (the SSD heads split over ``model``) gathered for it and
    written back."""
    b = x.shape[0]
    proj = (x @ p["in_proj"])[:, 0]                        # (B, ...)
    caches = [cache["conv"], cache["ssd"]]
    rows = [c.redistribute(proj.device_mesh, proj.placements)
            if dt.is_dt(c) and c.placements != proj.placements else c
            for c in caches]
    y = dt.local_call(functools.partial(K5.ssm_decode_mixer,
                                        eps=cfg.norm_eps),
                      proj, *rows, p["conv_w"], p["conv_b"], p["dt_bias"],
                      p["a_log"], p["d_skip"], p["norm"], like=proj)
    for c, r in zip(caches, rows):
        if r is not c:
            c.copy_(r)
    return y.reshape(b, 1, cfg.d_inner) @ p["out_proj"], cache
