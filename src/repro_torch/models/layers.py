"""Shared layers: norms, rotary embeddings, MLP variants, embedding and
logits; PyTorch port of ``repro.models.layers``.

Parameters are held in ``nn.ParameterDict``s keyed as in the JAX package's
parameter trees (``{"scale"}``, ``{"up", "gate", "down"}``, ...), so the
functions here read them the same way.  ``apply_mrope`` (qwen2-vl's
M-RoPE) serves the vlm family and ``sinusoid_positions`` (a numpy copy of
the JAX package's table) whisper's encoder.

On the mesh path (``DTensor`` activations and parameters) the norms and
RoPE run on each rank's local shards (``parallel.dtensor.local_call``:
they work along dims no mesh dim splits), a plain position tensor is
placed by the activations' batch first, the embedding of a vocabulary
split over ``model`` is summed over that axis, and the logits' lane mask
is replicated onto the logits' mesh.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import unset_fake_temporarily

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import dtensor as dt


def _constant(maxsize=None):
    """Cache a function's tensor per arguments, and build it outside any
    ``FakeTensorMode``: a fake run (the dry run) then leaves a real
    tensor in the cache, never a fake one that a later real run would
    meet."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            with unset_fake_temporarily():
                return cached(*args)
        get.cache_clear = cached.cache_clear
        return get
    return wrap


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def param(t: torch.Tensor) -> nn.Parameter:
    """Serving parameter: no gradient is kept."""
    return nn.Parameter(t, requires_grad=False)


def _normal(shape, scale: float, dtype, g: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, dtype=dtype, device=g.device,
                       generator=g) * scale


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold (torch's
    ``F.softplus`` returns x itself from x > 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


# ------------------------------------------------------------------- norms
def rmsnorm_init(d: int, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": param(torch.ones(d, dtype=dtype,
                                                       device=device))})


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Computed in float32 and cast back to ``x``'s dtype."""
    return dt.local_call(_rmsnorm, x, p["scale"], eps, like=x)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    orig = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32)).to(orig)


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               eps: float) -> torch.Tensor:
    """mamba2's gated RMS norm: ``y * silu(z)`` normalised over the last
    dim in float32, cast back to ``y``'s dtype, then scaled."""
    y = y * F.silu(z)
    var = y.to(torch.float32).square().mean(-1, keepdim=True)
    return (y.to(torch.float32) * torch.rsqrt(var + eps)).to(y.dtype) * scale


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """float64, as the JAX package computes them."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@_constant()
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device
                   ) -> torch.Tensor:
    """float32 frequencies on ``device``, copied there once: a copy from
    the host on every call would stall the stream of a decode step."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Half-split rotation.  x: (B, S, H, D); positions: (B, S) int."""
    return dt.local_call(_apply_rope, x, dt.place_like(positions, x), theta,
                         like=x)


def _apply_rope(x, positions, theta):
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    angles = positions[..., None].to(torch.float32) * freqs     # (B,S,D/2)
    return _rotate(x, angles)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """The half-split rotation of x (B, S, H, D) by angles (B, S, D/2)."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int):
    """qwen2-vl's default split of the head_dim / 2 frequency pairs into
    (temporal, height, width): (16, 24, 24) at head_dim 128."""
    t = head_dim // 8
    h = (head_dim // 2 - t) // 2
    return (t, h, head_dim // 2 - t - h)


@_constant()
def _mrope_components(sections: tuple, device: torch.device) -> torch.Tensor:
    """The position component (0, 1, 2) of each frequency pair."""
    return torch.as_tensor(np.concatenate([np.full(n, i) for i, n in
                                           enumerate(sections)]),
                           dtype=torch.int64, device=device)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=None) -> torch.Tensor:
    """Qwen2-VL M-RoPE.  x: (B, S, H, D); positions: (3, B, S) int, the
    (temporal, height, width) components.  The D / 2 frequency pairs are
    split into ``sections`` (in pairs, summing to D / 2; default
    ``mrope_sections(D)``), each rotated by its own component.  With three
    equal components it is ``apply_rope``."""
    d = x.shape[-1]
    sections = tuple(sections or mrope_sections(d))
    if sum(sections) != d // 2:
        raise ValueError(f"apply_mrope: sections {sections} do not sum to "
                         f"head_dim / 2 = {d // 2}")
    return dt.local_call(_apply_mrope, x, dt.place_like(positions, x, 1),
                         theta, sections, like=x)


def _apply_mrope(x, positions, theta, sections):
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, float(theta), x.device)
    comp = _mrope_components(sections, x.device)
    pos = positions.to(torch.float32)[comp]                   # (D/2, B, S)
    return _rotate(x, pos.permute(1, 2, 0) * freqs)


# ------------------------------------------------------------- sinusoids
def sinusoid_positions(seq: int, d: int) -> np.ndarray:
    """Whisper-style sinusoidal absolute position table, float32 (seq, d):
    sin in the even columns, cos in the odd."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    angle = pos / (10000 ** (dim / d))
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


@_constant(maxsize=8)
def sinusoid_on(seq: int, d: int, dtype: torch.dtype, device: torch.device
                ) -> torch.Tensor:
    """``sinusoid_positions`` in ``dtype`` on ``device``, copied there once."""
    return torch.as_tensor(sinusoid_positions(seq, d), device=device
                           ).to(dtype)


# --------------------------------------------------------------------- MLP
def mlp_init(g: torch.Generator, cfg: ModelConfig, d_ff: int
             ) -> nn.ParameterDict:
    d, dt = cfg.d_model, dtype_of(cfg.dtype)
    s_in = float(1.0 / np.sqrt(d))
    s_out = float(1.0 / np.sqrt(d_ff))
    p = {"up": _normal((d, d_ff), s_in, dt, g),
         "down": _normal((d_ff, d), s_out, dt, g)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["gate"] = _normal((d, d_ff), s_in, dt, g)
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def mlp_apply(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    up = x @ p["up"]
    if kind == "swiglu":
        h = F.silu(x @ p["gate"]) * up
    elif kind == "geglu":
        h = F.gelu(x @ p["gate"], approximate="tanh") * up
    elif kind == "squared_relu":                     # nemotron-4
        h = F.relu(up).square()
    elif kind == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(kind)
    return h @ p["down"]


# --------------------------------------------------------------- embedding
def embed_init(g: torch.Generator, cfg: ModelConfig) -> nn.ParameterDict:
    dt = dtype_of(cfg.dtype)
    v = cfg.padded_vocab
    p = {"tok": _normal((v, cfg.d_model), 0.02, dt, g)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal((cfg.d_model, v),
                               float(1.0 / np.sqrt(cfg.d_model)), dt, g)
    return nn.ParameterDict({k: param(t) for k, t in p.items()})


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``tok``; with the vocabulary split over ``model`` each rank
    looks up its rows and the partial embeddings are summed."""
    return dt.settle(F.embedding(tokens.to(torch.int64), p["tok"]))


def lm_logits(p, x: torch.Tensor, tie: bool, out_dtype=torch.float32,
              true_vocab: int = 0) -> torch.Tensor:
    """Logits over the (possibly padded) vocab; padded lanes get -1e9."""
    w = p["tok"].T if tie else p["lm_head"]
    logits = (x @ w).to(out_dtype)
    v = w.shape[-1]
    if true_vocab and true_vocab < v:
        lane = torch.arange(v, device=logits.device) < true_vocab
        logits = torch.where(dt.place_like(lane, logits, None), logits, -1e9)
    return logits
