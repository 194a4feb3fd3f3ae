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
them.  The sharded (ZeRO) moments of the JAX package wait for the
Trainer's mesh branch (ROADMAP.md, "Modules to port").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

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
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = T.leaves(params)[0].device
    return OptState(mu=T.map_tree(f32, params), nu=T.map_tree(f32, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


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


def apply_updates(params, opt_state: OptState, grads, cfg: OptConfig):
    """One AdamW step, in place.  ``grads``: a tree of ``params``'s
    structure or a list in ``tree.leaves(params)`` order, of any float
    dtype.  Returns (params, opt_state, {"grad_norm", "lr"})."""
    glist = grads if isinstance(grads, list) else T.leaves(grads)
    glist, gnorm = clip_by_global_norm(glist, cfg.clip_norm)
    step = opt_state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))
    ps, ms, vs = (T.leaves(t) for t in (params, opt_state.mu, opt_state.nu))
    if not len(ps) == len(ms) == len(vs) == len(glist):
        raise ValueError("apply_updates: params, moments and grads differ "
                         "in their leaves")
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
    return params, OptState(opt_state.mu, opt_state.nu, step), \
        {"grad_norm": gnorm, "lr": lr}
