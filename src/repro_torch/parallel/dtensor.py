"""DTensor helpers of the mesh path: what the model's layers need to run
on ``DTensor`` activations and parameters, where the JAX package relies on
XLA's partitioner.

The mesh path's activations are ``DTensor``s placed by the batch (its dim
0 over the data axes) and, inside a layer, by the heads or widths of the
parameters that made them (over ``model``).  DTensor's own operators
carry the matrix products with the parameters, the residual adds and the
reductions; the parts of a layer that are independent along every split
dim (RoPE, the norms, attention per head, the SSD and RG-LRU scans) run
on each rank's local shards through :func:`local_call`, which turns
DTensors into local tensors and back without a collective, and gives a
whole (replicated) input the partial gradient its shard of the work
makes.  Every function here passes plain tensors through unchanged, so
the single-device path never meets them.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)


def is_dt(x) -> bool:
    return isinstance(x, DTensor)


def settle(t):
    """``t`` with its partial sums (``Partial`` placements) reduced to
    ``Replicate``; any other tensor as it is."""
    if is_dt(t) and any(p.is_partial() for p in t.placements):
        return t.redistribute(placements=[
            Replicate() if p.is_partial() else p for p in t.placements])
    return t


def whole(t):
    """``t`` replicated on every dim of its mesh (an all-gather where it
    is sharded); a plain tensor as it is."""
    if is_dt(t) and any(not p.is_replicate() for p in t.placements):
        return t.redistribute(placements=[Replicate()] * len(t.placements))
    return t


def unsplit(t, dim: int):
    """``t`` with tensor dim ``dim`` whole on every rank: an all-gather
    over the mesh dims that split it, its other placements kept; a plain
    tensor as it is."""
    if not is_dt(t):
        return t
    dim %= t.dim()
    place = [Replicate() if p.is_shard(dim) else p for p in t.placements]
    return (t if place == list(t.placements)
            else t.redistribute(placements=place))


def reduced_grad(t):
    """``t`` itself, whose gradient is brought to ``t``'s placements in
    the backward: a gradient that is partial over ``model`` (from the
    heads of each rank) is summed there, before it meets a product with
    a split weight, which would otherwise gather that weight."""
    if not is_dt(t):
        return t
    return DTensor.from_local(t.to_local(), t.device_mesh, t.placements,
                              run_check=False)


def grad_placements(arg: DTensor, out: Sequence) -> list:
    """The placements of the gradient that a local computation gives an
    input placed ``arg.placements`` when its output is placed ``out``: on
    a mesh dim that splits the output but not the input, each rank's
    gradient is its share of a sum (``Partial``)."""
    return [Partial() if (o.is_shard() and not a.is_shard()) else a
            for a, o in zip(arg.placements, out)]


def local_call(fn: Callable, *args, like, out_placements=None):
    """``fn`` on the local shards of its DTensor arguments, its output(s)
    placed like ``like`` (a DTensor: its placements; or ``out_placements``,
    one list per output).  ``fn`` must be independent along every tensor
    dim that a mesh dim splits; a whole input is used whole on every
    rank.  With a plain ``like`` it is ``fn(*args)``."""
    if not is_dt(like):
        return fn(*args)
    like = settle(like)
    mesh, place = like.device_mesh, tuple(like.placements)
    local = []
    for a in args:
        if is_dt(a):
            a = settle(a)
            a = (a.to_local(grad_placements=grad_placements(a, place))
                 if a.requires_grad else a.to_local())
        local.append(a)
    out = fn(*local)
    if isinstance(out, tuple):
        outs = out_placements or [place] * len(out)
        return tuple(None if o is None else
                     DTensor.from_local(o, mesh, p, run_check=False)
                     for o, p in zip(out, outs))
    return DTensor.from_local(out, mesh, out_placements or place,
                              run_check=False)


def local_shape_and_offset(shape, mesh, placements):
    """(local shape, global offset) of this rank's shard of a tensor of
    global ``shape`` placed ``placements`` on ``mesh``, from the rank's
    mesh coordinate and the ``Shard`` placements in mesh-dim order (the
    first the major one), split as ``torch.chunk`` splits.  Plain Python
    integers, so it also holds under ``FakeTensorMode``, where torch's
    ``compute_local_shape_and_global_offset`` computes its offsets with
    tensors and cannot read them back."""
    coord = mesh.get_coordinate()
    local, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            d = p.dim % len(shape)
            full = -(-local[d] // mesh.size(i))          # torch.chunk's size
            start = min(full * coord[i], local[d])
            local[d] = min(local[d], start + full) - start
            offset[d] += start
    return tuple(local), tuple(offset)


def zeros_placed(shape, dtype, mesh, placements, device) -> DTensor:
    """A DTensor of zeros of global ``shape`` placed ``placements`` on
    ``mesh``, made from this rank's shard alone (no collective, and no
    memory for the other ranks' shards)."""
    local, _ = local_shape_and_offset(shape, mesh, placements)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), mesh, placements,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def batch_placements(like: DTensor, batch_dim: int = 0) -> list:
    """Placements of a tensor whose dim ``batch_dim`` is split as
    ``like``'s batch (dim 0) is, whole elsewhere."""
    from torch.distributed.tensor import Shard
    return [Shard(batch_dim) if p.is_shard(0) else Replicate()
            for p in like.placements]


def place_like(t: torch.Tensor, like, batch_dim: Optional[int] = 0):
    """A plain tensor ``t`` (the same on every rank) as a DTensor on
    ``like``'s mesh: its dim ``batch_dim`` split as ``like``'s batch is,
    or (``batch_dim`` None) replicated.  Each rank keeps its slice; no
    collective.  ``t`` itself where ``like`` is plain."""
    if not is_dt(like) or is_dt(t):
        return t
    place = ([Replicate()] * like.device_mesh.ndim if batch_dim is None
             else batch_placements(like, batch_dim))
    return distribute_tensor(t, like.device_mesh, place, src_data_rank=None)


DATA_AXES = ("pod", "data")


def gather_data(tree):
    """FSDP's gather before a layer runs: a tree of dicts (or
    ``ParameterDict``/``ModuleDict``s) of tensors as nested dicts, each
    DTensor that a data axis (``pod``, ``data``) splits gathered whole
    over that axis (an all-gather; its backward a reduce-scatter of the
    gradient), its ``model`` split kept."""
    if isinstance(tree, torch.Tensor):
        if not is_dt(tree):
            return tree
        names = tree.device_mesh.mesh_dim_names or ()
        place = [Replicate() if (p.is_shard() and n in DATA_AXES) else p
                 for n, p in zip(names, tree.placements)]
        return (tree if place == list(tree.placements)
                else tree.redistribute(placements=place))
    return {k: gather_data(v) for k, v in tree.items()}
