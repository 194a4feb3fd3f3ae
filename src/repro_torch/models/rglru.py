"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427);
PyTorch port of ``repro.models.rglru``.

    r_t = sigmoid(W_r x_t + b_r)                 (recurrence gate)
    i_t = sigmoid(W_i x_t + b_i)                 (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence path runs the linear recurrence as a log-depth scan
(``linear_scan``: Hillis-Steele doubling over the sequence, ceil(log2 S)
element-wise passes), where the JAX package uses
``jax.lax.associative_scan``: the same combine on another tree, so the
float32 results differ only in rounding.  Decode is one O(width) update
of ``{"conv", "h"}``, in place.  The temporal block follows Griffin: a
width-4 causal conv in front of the RG-LRU and a GeLU-gated linear branch
multiplied into its output.  On DTensors the scan runs on each rank's
local shards (it is per batch row and per width lane), the rest on
DTensor's operators, with the LRU width split over ``model`` where the
rules split it.  Casts follow the JAX package's: the gate
biases are cast to the activations' dtype before the add, ``i * x`` goes
to float32 after the product, and ``h`` is cast back before the gate.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel import dtensor as dt

_C = 8.0
FLOAT32 = frozenset({"b_r", "b_i", "lam"})       # float32 at any dtype


def rglru_init(g: torch.Generator, cfg: ModelConfig) -> nn.ParameterDict:
    d, dt, w = cfg.d_model, L.dtype_of(cfg.dtype), cfg.lru_width
    s, sw = float(1 / np.sqrt(d)), float(1 / np.sqrt(w))
    # Lambda so that a ~ Uniform(0.9, 0.999)^c-ish (Griffin init); the JAX
    # package's numpy draw, so both packages hold the same values
    lam = -np.log(np.expm1(-np.log(np.random.RandomState(0)
                                   .uniform(0.9, 0.999, w)) / _C))
    f32 = dict(dtype=torch.float32, device=g.device)
    p = {
        "w_x": L._normal((d, w), s, dt, g),
        "w_gate": L._normal((d, w), s, dt, g),
        "conv_w": L._normal((cfg.conv_width, w),
                            float(1 / np.sqrt(cfg.conv_width)), dt, g),
        "conv_b": torch.zeros(w, dtype=dt, device=g.device),
        "w_r": L._normal((w, w), sw, dt, g),
        "b_r": torch.zeros(w, **f32),
        "w_i": L._normal((w, w), sw, dt, g),
        "b_i": torch.zeros(w, **f32),
        "lam": torch.tensor(-lam, **f32),
        "out": L._normal((w, d), sw, dt, g),
    }
    return nn.ParameterDict({k: L.param(v) for k, v in p.items()})


def _gates(p, xb):
    """(a, gated input), float32, for conv outputs xb (..., w).  The gate
    products take xb whole (gathered where ``model`` splits the width) by
    ``w_r`` and ``w_i``'s columns, so no weight is gathered."""
    xw = dt.unsplit(xb, -1)
    r = torch.sigmoid(xw @ p["w_r"] + p["b_r"].to(xb.dtype))
    i = torch.sigmoid(xw @ p["w_i"] + p["b_i"].to(xb.dtype))
    log_a = -_C * L.softplus(p["lam"]) * r.to(torch.float32)
    a = torch.exp(log_a)
    gated_x = (i * xb).to(torch.float32) * torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, gated_x


def _causal_conv(xb, w, b):
    k = w.shape[0]
    pad = F.pad(xb, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + xb.shape[1], :] * w[i] for i in range(k)) + b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 along dim 1.

    Hillis-Steele: at offset d = 1, 2, 4, ... each position t >= d
    combines the partial (a, b) of t - d into its own, (a_{t-d} a_t,
    a_t b_{t-d} + b_t), the combine ``associative_scan`` uses; after
    ceil(log2 S) passes each position holds h_t."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_apply_train(p, cfg: ModelConfig, x: torch.Tensor,
                      return_state: bool = False):
    """x: (B, S, d_model) -> (B, S, d_model) [, decode cache]."""
    xb_raw = x @ p["w_x"]
    xb = _causal_conv(xb_raw, p["conv_w"], p["conv_b"])
    a, gx = _gates(p, xb)                                  # (B,S,w) f32
    h = dt.local_call(linear_scan, a, gx, like=a)
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    out = (h.to(x.dtype) * gate) @ p["out"]
    if return_state:
        k = p["conv_w"].shape[0]
        tail = F.pad(xb_raw, (0, 0, k - 1, 0))[:, -(k - 1):]
        return out, {"conv": tail, "h": h[:, -1]}
    return out


def rglru_decode_init(cfg: ModelConfig, batch: int, dtype, device
                      ) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }


def rglru_apply_decode(p, cfg: ModelConfig, x, cache):
    """x: (B, 1, d_model); cache {conv (B, K-1, w), h (B, w)}, updated in
    place.  Returns (y (B, 1, d_model), cache)."""
    xb_raw = (x @ p["w_x"])[:, 0]                          # (B, w)
    win = torch.cat([cache["conv"], xb_raw[:, None]], dim=1)
    xb = torch.einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"]
    a, gx = _gates(p, xb)
    h = a * cache["h"] + gx
    gate = F.gelu((x @ p["w_gate"])[:, 0], approximate="tanh")
    y = (h.to(x.dtype) * gate) @ p["out"]
    cache["conv"].copy_(win[:, 1:])
    cache["h"].copy_(h)
    return y[:, None, :], cache
