"""Mixture-of-Experts layer with sort-based dispatch (qwen2-moe, kimi-k2);
PyTorch port of ``repro.models.moe``.

Dispatch is the JAX package's capacity-bounded sort/scatter, step for
step: token->expert assignments are sorted by expert id (a stable sort,
as ``jnp.argsort`` is, because which assignments drop at capacity
depends on that order), each expert keeps up to C of them in a dense
(E_pad, C, d) buffer, the expert FFNs run as batched matrix products, and
the results are combined with the router weights.  An assignment of rank
C or more in its expert drops (its token keeps the other experts' share,
with no renormalisation).  The expert count is zero-padded to a multiple
of 16 (padded experts receive no tokens: the router scores real experts
only).  Shared experts run densely for every token.

Where the port differs in form:
* A dropped assignment's slot is one past the end of the buffer, as in
  JAX, where ``mode="drop"`` discards it; here the buffer has that one
  spare row, written and never read, so no index is out of bounds and
  no host synchronisation picks the kept ones.
* The expert products are ``torch.bmm`` in the weights' dtype: in
  bfloat16 ``h`` and ``u`` are rounded to bfloat16 where JAX keeps them
  in float32 (``preferred_element_type``); float32 is the same arithmetic.
* Combine: JAX adds each assignment's weighted output into its token's
  row with a scatter-add in ``x.dtype``; on CUDA that would be atomics in
  no fixed order.  Here the assignments are un-sorted to (T, top_k, d) and
  added in the router's top-k order (largest weight first), each addition
  rounded to ``x.dtype``, so two runs give the same bits.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

EP_PAD_MULTIPLE = 16
FLOAT32 = frozenset({"router"})       # leaves held in float32 at any dtype


def padded_experts(n_experts: int) -> int:
    return ((n_experts + EP_PAD_MULTIPLE - 1) // EP_PAD_MULTIPLE) \
        * EP_PAD_MULTIPLE


def moe_init(g: torch.Generator, cfg: ModelConfig) -> nn.ParameterDict:
    d, dt = cfg.d_model, L.dtype_of(cfg.dtype)
    e_pad = padded_experts(cfg.n_experts)
    ff = cfg.d_ff_expert
    s_in, s_out = float(1 / np.sqrt(d)), float(1 / np.sqrt(ff))
    p = {"router": L._normal((d, cfg.n_experts), s_in, torch.float32, g),
         "up": L._normal((e_pad, d, ff), s_in, dt, g),
         "gate": L._normal((e_pad, d, ff), s_in, dt, g),
         "down": L._normal((e_pad, ff, d), s_out, dt, g)}
    p = {k: L.param(v) for k, v in p.items()}
    if cfg.n_shared_experts:
        ffs = cfg.d_ff_shared * cfg.n_shared_experts
        p["shared"] = nn.ParameterDict({k: L.param(v) for k, v in {
            "up": L._normal((d, ffs), s_in, dt, g),
            "gate": L._normal((d, ffs), s_in, dt, g),
            "down": L._normal((ffs, d), float(1 / np.sqrt(ffs)), dt, g),
        }.items()})
    return nn.ParameterDict(p)


def route(p, cfg: ModelConfig, xt: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router over tokens xt (T, d), in float32.  Returns (probs (T, E),
    top-k weights renormalised to sum 1 (T, k), top-k experts (T, k))."""
    logits = xt.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_e


def capacity_of(cfg: ModelConfig, n_tokens: int,
                capacity_factor: float) -> int:
    """Slots per expert: ceil(T * top_k / E * factor), as JAX rounds it."""
    return int(np.ceil(n_tokens * cfg.top_k / cfg.n_experts
                       * capacity_factor))


def dispatch(top_e: torch.Tensor, e_pad: int, capacity: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assignments (T*k, flattened from top_e (T, k)) sorted stably by
    expert.  Returns (order: the sorted assignments' flat indices, keep:
    whether each sorted assignment has a slot, slot: its buffer row, or
    e_pad * capacity, the spare row, where it drops)."""
    flat_e = top_e.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e_pad)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat_e.numel(), device=flat_e.device) - starts[se]
    keep = rank < capacity
    slot = torch.where(keep, se * capacity + rank, e_pad * capacity)
    return order, keep, slot


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: float = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d).  Returns (y (B, S, d), aux loss, a 0-d float32 tensor).

    capacity_factor None -> cfg.moe_capacity_factor (training and
    prefill); decode passes n_experts, which drops nothing."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    e_pad = p["up"].shape[0]
    xt = x.reshape(t, d)
    probs, top_w, top_e = route(p, cfg, xt)

    # load-balancing auxiliary loss (Switch-style): the share of
    # assignments each expert got, against its mean router probability
    density = torch.bincount(top_e.reshape(-1), minlength=e).to(
        torch.float32) / t
    aux = cfg.router_aux_coef * e * torch.sum(density / k * probs.mean(0))

    capacity = capacity_of(cfg, t, capacity_factor)
    order, keep, slot = dispatch(top_e, e_pad, capacity)
    st = torch.div(order, k, rounding_mode="floor")      # sorted tokens
    buf = x.new_zeros((e_pad * capacity + 1, d))
    buf[slot] = xt[st]
    buf = buf[:-1].view(e_pad, capacity, d)

    h = torch.bmm(buf, p["gate"])
    u = torch.bmm(buf, p["up"])
    act = (F.silu(h.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    out = torch.bmm(act, p["down"]).view(e_pad * capacity, d)

    sw = top_w.reshape(-1)[order].to(x.dtype)
    y_sorted = torch.where(keep[:, None],
                           out[torch.clamp(slot, max=e_pad * capacity - 1)],
                           0) * sw[:, None]
    y_tk = torch.empty_like(y_sorted)
    y_tk[order] = y_sorted                       # back to (token, choice)
    y_tk = y_tk.view(t, k, d)
    y = y_tk[:, 0]
    for j in range(1, k):
        y = y + y_tk[:, j]

    if "shared" in p:
        sp = p["shared"]
        hs = F.silu(xt @ sp["gate"]) * (xt @ sp["up"])
        y = y + hs @ sp["down"]
    return y.reshape(b, s, d), aux
