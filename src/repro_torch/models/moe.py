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
only).  Shared experts run densely for every token.  On the mesh path
(DTensor x) the dispatch runs as pjit partitions it: over the global
tokens on every rank, with each rank's experts (split over ``model``)
over their slots.

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

Three options of ``ModelConfig`` that the JAX package does not have, off
by default (qwen2-moe as published, Qwen1.5-MoE-A2.7B, sets all three):
``moe_norm_topk`` False keeps the top-k weights of the softmax over all
experts as they are; ``moe_shared_gate`` scales the shared experts'
output by ``sigmoid(x @ shared_gate)`` ((d, 1), a leaf of its own); and
``moe_dropless`` keeps every assignment, in the forward, the prefill and
decode alike: the assignments sorted stably by expert on the device, each
expert's offsets found by a search of the sorted ids, the token rows
gathered in that order, the routed experts run over each expert's
contiguous rows by the grouped kernel K6
(``kernels/moe_experts``; the plain per-expert loop on the CPU), and the
results combined as above.  No step of it reads a device value on the
host.  The mesh path takes only the capacity-bounded dispatch.

Spans (``repro_torch.trace``): ``moe.router`` (the router and its top-k,
the aux loss), ``moe.dispatch`` (sort, offsets or slots, gather),
``moe.experts`` (K6, its plain loop, or the batched products),
``moe.combine`` and ``moe.shared``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_experts import ops as K6
from repro_torch.models import layers as L
from repro_torch.parallel import dtensor as dt

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
        if cfg.moe_shared_gate:
            p["shared_gate"] = L.param(L._normal((d, 1), s_in, dt, g))
    return nn.ParameterDict(p)


def route(p, cfg: ModelConfig, xt: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router over tokens xt (T, d), in float32.  Returns (probs (T, E),
    top-k weights (T, k), renormalised to sum 1 where
    ``cfg.moe_norm_topk``, top-k experts (T, k))."""
    logits = xt.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.moe_norm_topk:
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
    counts = _counts(flat_e, e_pad)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat_e.numel(), device=flat_e.device) - starts[se]
    keep = rank < capacity
    slot = torch.where(keep, se * capacity + rank, e_pad * capacity)
    return order, keep, slot


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(idx, minlength=n)`` for ``idx`` in [0, n), with a
    shape that does not depend on the values (a fake tensor has none)."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx.to(torch.int64), torch.ones_like(idx, dtype=torch.int64))


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: float = None, with_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, d).  Returns (y (B, S, d), aux loss, a 0-d float32 tensor,
    or None without ``with_aux``: serving has no use for it).

    capacity_factor None -> cfg.moe_capacity_factor (training and
    prefill); decode passes n_experts, which drops nothing.  A dropless
    config (``cfg.moe_dropless``) takes no capacity."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    if dt.is_dt(x):
        if cfg.moe_dropless:
            raise NotImplementedError("moe_apply: the dropless dispatch "
                                      "takes no DTensor (mesh) input")
        return _moe_apply_mesh(p, cfg, x, capacity_factor)
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    if cfg.moe_dropless:
        y, aux = _dropless(cfg, p, xt, with_aux)
    else:
        y, aux = _routed(cfg, xt, p["router"], capacity_factor,
                         lambda buf: _experts(buf, p["gate"], p["up"],
                                              p["down"]), with_aux)
    if "shared" in p:
        with trace.span("moe.shared"):
            ys = _shared(p["shared"], xt)
            if cfg.moe_shared_gate:
                ys = torch.sigmoid(xt @ p["shared_gate"]) * ys
            y = y + ys
    return y.reshape(b, s, d), aux


def _experts(buf, gate, up, down):
    """The expert FFNs over their slots: buf (E, C, d) -> (E, C, d)."""
    h = torch.bmm(buf, gate)
    u = torch.bmm(buf, up)
    act = (F.silu(h.to(torch.float32)) * u.to(torch.float32)).to(buf.dtype)
    return torch.bmm(act, down)


def _shared(sp, xt):
    """The shared experts, dense over every token."""
    return (F.silu(xt @ sp["gate"]) * (xt @ sp["up"])) @ sp["down"]


def _aux_loss(cfg: ModelConfig, probs, top_e):
    """Load-balancing auxiliary loss (Switch-style): the share of
    assignments each expert got, against its mean router probability."""
    k, e = cfg.top_k, cfg.n_experts
    density = _counts(top_e.reshape(-1), e).to(
        torch.float32) / top_e.shape[0]
    return cfg.router_aux_coef * e * torch.sum(density / k * probs.mean(0))


def _combine(y_sorted, order, t: int, k: int):
    """Assignment outputs in sorted order back to (token, choice), added in
    the router's top-k order, each addition rounded to their dtype."""
    y_tk = torch.empty_like(y_sorted)
    y_tk[order] = y_sorted                       # back to (token, choice)
    y_tk = y_tk.view(t, k, -1)
    y = y_tk[:, 0]
    for j in range(1, k):
        y = y + y_tk[:, j]
    return y


def _routed(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor,
            capacity_factor: float, experts, with_aux: bool = True):
    """The routed experts over tokens xt (T, d): (y (T, d), aux or None).
    ``experts`` maps the dispatch buffer (E_pad, C, d) to its outputs."""
    t, d = xt.shape
    k, e = cfg.top_k, cfg.n_experts
    with trace.span("moe.router"):
        probs, top_w, top_e = route({"router": router}, cfg, xt)
        aux = _aux_loss(cfg, probs, top_e) if with_aux else None

    with trace.span("moe.dispatch"):
        e_pad = padded_experts(e)
        capacity = capacity_of(cfg, t, capacity_factor)
        order, keep, slot = dispatch(top_e, e_pad, capacity)
        st = torch.div(order, k, rounding_mode="floor")      # sorted tokens
        buf = xt.new_zeros((e_pad * capacity + 1, d))
        buf[slot] = xt[st]
    with trace.span("moe.experts"):
        out = experts(buf[:-1].view(e_pad, capacity, d)).reshape(
            e_pad * capacity, d)

    with trace.span("moe.combine"):
        sw = top_w.reshape(-1)[order].to(xt.dtype)
        y_sorted = torch.where(
            keep[:, None], out[torch.clamp(slot, max=e_pad * capacity - 1)],
            0) * sw[:, None]
        return _combine(y_sorted, order, t, k), aux


def _dropless(cfg: ModelConfig, p, xt: torch.Tensor, with_aux: bool):
    """The routed experts over tokens xt (T, d) with no capacity: (y (T,
    d), aux or None).  Every assignment is kept; none of it reads a device
    value on the host (K6's grid is an upper bound of its tiles)."""
    t, k = xt.shape[0], cfg.top_k
    with trace.span("moe.router"):
        probs, top_w, top_e = route(p, cfg, xt)
        aux = _aux_loss(cfg, probs, top_e) if with_aux else None
    with trace.span("moe.dispatch"):
        e_pad = padded_experts(cfg.n_experts)
        se, order = torch.sort(top_e.reshape(-1), stable=True)
        # offsets[e]: the first sorted assignment of expert e or later
        offsets = torch.searchsorted(se, _expert_ids(e_pad + 1, se.device))
        rows = xt[torch.div(order, k, rounding_mode="floor")]
    with trace.span("moe.experts"):
        out = K6.moe_experts(rows, offsets, p["gate"], p["up"], p["down"])
    with trace.span("moe.combine"):
        sw = top_w.reshape(-1)[order].to(xt.dtype)
        return _combine(out * sw[:, None], order, t, k), aux


@L._constant()
def _expert_ids(n: int, device: torch.device) -> torch.Tensor:
    """0 .. n-1 (int64) on ``device``, made there once."""
    return torch.arange(n, device=device)


def _moe_apply_mesh(p, cfg: ModelConfig, x, capacity_factor: float):
    """``moe_apply`` of a DTensor x, as pjit partitions it: the routing,
    the capacity, the stable sort and the dropped pairs over the global
    tokens (gathered whole on every rank, which all compute the same
    dispatch), each rank's experts (split over ``model``) over their
    slots, and the outputs gathered back; the shared experts as a dense
    MLP on x."""
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    b, s, d = x.shape
    xt = dt.whole(x).to_local().reshape(b * s, d)
    gate = p["gate"]
    mine = tuple(gate.placements)

    def experts(buf):
        # each rank's slots of its experts; the gradient of the buffer is
        # gathered back over the experts' split
        buf = DTensor.from_local(buf, mesh, rep, run_check=False
                                 ).redistribute(placements=mine).to_local()
        out = _experts(buf, gate.to_local(), p["up"].to_local(),
                       p["down"].to_local())
        return DTensor.from_local(out, mesh, mine, run_check=False
                                  ).redistribute(placements=rep).to_local()

    y, aux = _routed(cfg, xt, dt.whole(p["router"]).to_local(),
                     capacity_factor, experts)
    y = DTensor.from_local(y.reshape(b, s, d), mesh, rep, run_check=False
                           ).redistribute(placements=x.placements)
    if "shared" in p:
        y = y + dt.settle(_shared(p["shared"], x))
    return y, DTensor.from_local(aux, mesh, rep, run_check=False)
