"""AdamW with cosine/linear schedules and global-norm clipping; PyTorch
port of ``repro.train.optimizer``.

The update rule is the JAX package's, step for step (not
``torch.optim.AdamW``, which keeps its moments in the parameter's dtype
and adds the decay in another order): the moments are float32 whatever
the parameter dtype, the update is computed in float32 from
``p.float()`` with the weight decay inside ``delta`` before the ``lr``
multiply, and the result is rounded back to the parameter's dtype; there
are no master weights.  The bias corrections are ``1 - b ** step`` in
float32.  ``lr``, the step and the norms stay on the parameters' device as
0-d tensors, so a step never waits for the device.

Trees are nested dicts, lists, tuples and NamedTuples of tensors
(``repro_torch.train.tree``).  Unlike the JAX functions,
``apply_updates`` writes the new parameters and moments into the tensors
it is given (the memory effect of the JAX trainer's donation) and returns
them.

On the mesh path the parameters and moments are ``DTensor``s (the
moments placed like their parameters: ZeRO's sharded moments under
FSDP, and the step replicated).  ``apply_updates`` then reduces each
gradient to its parameter's placements (a gradient's partial sums over
the data axes become the data-parallel mean's sum), takes the global
norm of the whole gradient (each leaf's local sum of squares, summed
over the mesh dims that split it), and runs the same element-wise
update on each rank's local shards, in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.parallel import dtensor as dt
from repro_torch.train import tree as T


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | linear | constant
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor                # 0-d int32


def init(params) -> OptState:
    """Zero moments, float32, and step 0; for DTensor parameters DTensors
    placed like them and a replicated step."""
    def f32(p):
        return torch.zeros_like(p, dtype=torch.float32)
    first = T.leaves(params)[0]
    step = dt.place_like(torch.zeros((), dtype=torch.int32,
                                     device=first.device), first, None)
    return OptState(mu=T.map_tree(f32, params), nu=T.map_tree(f32, params),
                    step=step)


def schedule_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in T.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads in float32 scaled to at most ``max_norm``, their norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return T.map_tree(lambda g: g.to(torch.float32) * scale, grads), norm


def sharded_norm(locals_, places) -> torch.Tensor:
    """The global norm of a gradient held as local shards: ``locals_``,
    each leaf's local tensor, and ``places``, its (mesh, placements).
    Each leaf's local sum of squares is summed over the mesh dims that
    split it (one all-reduce per set of such dims, over the stacked sums
    of its leaves; a replicated leaf counts once), then the leaves' sums
    in leaf order, as ``global_norm`` sums them."""
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in locals_]
    groups = {}
    for i, (mesh, place) in enumerate(places):
        dims = tuple(d for d, p in enumerate(place) if p.is_shard())
        if dims:
            groups.setdefault((id(mesh), dims), (mesh, []))[1].append(i)
    for (_, dims), (mesh, idx) in groups.items():
        part = torch.stack([sq[i] for i in idx])
        for d in dims:
            torch.distributed.all_reduce(part, group=mesh.get_group(d))
        for i, x in zip(idx, part):
            sq[i] = x
    return torch.sqrt(torch.sum(torch.stack(sq)))


def apply_updates(params, opt_state: OptState, grads, cfg: OptConfig):
    """One AdamW step, in place.  ``grads``: a tree of ``params``'s
    structure or a list in ``tree.leaves(params)`` order, of any float
    dtype.  Returns (params, opt_state, {"grad_norm", "lr"}).  DTensor
    parameters take DTensor gradients of any placements, or each rank's
    local shards of gradients already reduced (module docstring)."""
    glist = grads if isinstance(grads, list) else T.leaves(grads)
    ps, ms, vs = (T.leaves(t) for t in (params, opt_state.mu, opt_state.nu))
    if not len(ps) == len(ms) == len(vs) == len(glist):
        raise ValueError("apply_updates: params, moments and grads differ "
                         "in their leaves")
    if not any(dt.is_dt(p) for p in ps):
        glist, gnorm = clip_by_global_norm(glist, cfg.clip_norm)
        step, lr = _adamw(ps, ms, vs, glist, opt_state.step, cfg)
        return params, OptState(opt_state.mu, opt_state.nu, step), \
            {"grad_norm": gnorm, "lr": lr}
    with torch.no_grad():
        glist = [(g.redistribute(placements=p.placements).to_local()
                  if dt.is_dt(g) else g) for p, g in zip(ps, glist)]
        places = [(p.device_mesh, tuple(p.placements)) for p in ps]
        ps, ms, vs = ([x.to_local() for x in xs] for xs in (ps, ms, vs))
        gnorm = sharded_norm(glist, places)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        glist = [g.to(torch.float32) * scale for g in glist]
        step = opt_state.step
        step_l, lr = _adamw(ps, ms, vs, glist, step.to_local()
                            if dt.is_dt(step) else step, cfg)
        if dt.is_dt(step):
            step_l = DTensor.from_local(step_l, step.device_mesh,
                                        step.placements, run_check=False)
        step = step_l
    return params, OptState(opt_state.mu, opt_state.nu, step), \
        {"grad_norm": gnorm, "lr": lr}


def _adamw(ps, ms, vs, glist, step, cfg: OptConfig):
    """The element-wise update of plain tensors, in place, from clipped
    float32 gradients ``glist``.  Returns (the new step, lr)."""
    step = step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))
    with torch.no_grad():
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2.  Temporaries are
        # dropped as soon as they are used: at gemma3-1b's width each list
        # of float32 leaves holds 5.2 GB.
        torch._foreach_mul_(ms, b1)
        t = torch._foreach_mul(glist, 1 - b1)
        torch._foreach_add_(ms, t)
        t = torch._foreach_mul(glist, glist)
        del glist
        torch._foreach_mul_(t, 1 - b2)
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, t)
        # delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd p
        t = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(t)
        torch._foreach_add_(t, cfg.eps)
        delta = torch._foreach_div(ms, bc1)
        torch._foreach_div_(delta, t)
        pf = [p.to(torch.float32) for p in ps]
        t = torch._foreach_mul(pf, cfg.weight_decay)
        torch._foreach_add_(delta, t)
        del t
        # p = (p - lr delta) in p's dtype
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(pf, delta)
        del delta
        for p, new in zip(ps, pf):
            p.copy_(new)
    return step, lr
