"""Gradient compression: int8 quantized data-parallel all-reduce with error
feedback; PyTorch port of ``repro.parallel.compression``.

  q   = round(g / s) clipped to int8, s = max|g| / (127 / n)
  e' += g - q*s                (error feedback, carried in CompressionState)
  G   = sum(q) * s / n         (int8 payload on the wire, f32 accumulate)

The JAX package runs this inside ``shard_map`` over the data axes, with
``psum``/``pmax`` over their names.  Here the axes are process groups
(``groups``: the data groups of a ``DeviceMesh``, ``pod`` then ``data``;
``data_groups`` finds them): a reduction over pod x data is one
``all_reduce`` per group in turn, which is exact for the two reductions
it is used for (a max, and a sum of int8).  ``psum(1)`` is the product of
the groups' sizes; no groups (the JAX ``axis_names=()``) is n = 1 and no
collective.  The int8 sum runs as an int8 ``all_reduce(SUM)``: 1 byte an
element on the wire.  The scale is shared across shards and chosen as
max|g| / (127 / n), so the sum of n payloads never leaves +-127.

Every float step runs in float32 in the JAX order, with true divisions by
0-d float32 tensors (CUDA divides by a Python scalar through its
reciprocal), so that the codes, the error state and the mean are the JAX
package's bit for bit on the CPU.  A tree's leaves are reduced together:
one ``all_reduce(MAX)`` of their maxima and one int8 ``all_reduce(SUM)``
of their codes, concatenated, per group.

DTensor gradients (the manual data-parallel step on a model axis above
1) are quantised as their local shards.  Inside the JAX package's
partial-manual ``shard_map`` the model axis is automatic, so a leaf's
scale is the maximum over the whole leaf: here the maxima are reduced
over the gradients' other mesh dims (``model``) too, before the codes
are taken; the int8 sum stays per data group, and each mean comes back
as a DTensor placed like its gradient.  The error state is each rank's
local shards.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel import dtensor as dt
from repro_torch.train import tree as T


class CompressionState(NamedTuple):
    error: Any            # tree like grads, float32 residuals


def init_state(grads_shape_tree) -> CompressionState:
    """Zero residuals: float32 of each leaf's shape, on its device (a
    leaf without one, such as a numpy array, gives a CPU tensor)."""
    return CompressionState(error=T.map_tree(
        lambda g: torch.zeros(tuple(g.shape), dtype=torch.float32,
                              device=getattr(g, "device", "cpu")),
        grads_shape_tree))


def data_groups(mesh) -> List:
    """The process groups of ``mesh``'s data axes, ``pod`` then ``data``
    (those it has)."""
    return [mesh.get_group(a) for a in ("pod", "data")
            if a in (mesh.mesh_dim_names or ())]


def _size(groups: Sequence) -> int:
    n = 1
    for g in groups:
        n *= dist.get_world_size(g)
    return n


def _all_reduce(t: torch.Tensor, op, groups: Sequence) -> torch.Tensor:
    for g in groups:
        dist.all_reduce(t, op=op, group=g)
    return t


def _model_groups(places) -> List:
    """The groups of the mesh dims other than the data axes (``model``)
    of the first DTensor gradient's mesh; [] without one."""
    mesh = next((p[0] for p in places if p is not None), None)
    if mesh is None:
        return []
    return [mesh.get_group(i) for i, name in
            enumerate(mesh.mesh_dim_names or ()) if name not in dt.DATA_AXES]


def quantize(g32: torch.Tensor, gmax: torch.Tensor, n: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the int8 codes of float32 ``g32``, its scale) at the shared max
    |value| ``gmax`` (0-d float32) of ``n`` shards: scale = max(gmax,
    1e-12) / (127 / n), codes round(g32 / scale) within +-floor(127 /
    n)."""
    levels = torch.full((), 127.0 / n, dtype=torch.float32,
                        device=g32.device)
    scale = torch.clamp_min(gmax, 1e-12) / levels
    lim = float(int(127.0 / n))
    q = torch.clamp(torch.round(g32 / scale), -lim, lim).to(torch.int8)
    return q, scale


def compress_psum_leaf(g: torch.Tensor, err: torch.Tensor,
                       groups: Sequence = ()
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf: (the mean over ``groups`` of ``g`` through the int8
    codes, the new error).  Every rank of the groups calls it."""
    (mean,), (new_err,) = compressed_pmean([g], [err], groups)
    return mean, new_err


def compressed_pmean(grads, error_tree, groups: Sequence = (),
                     scale_of=None):
    """Compressed mean all-reduce of a gradient tree over ``groups``.
    Returns (the means, float32, and the new error tree), both of
    ``grads``'s structure.  Every rank of the groups calls it with trees
    of the same shapes.  ``scale_of``: None (a scale per leaf), or one
    key per leaf in ``tree.leaves`` order; the leaves of one key share a
    scale, as the slices of one tensor do (the port keeps a layer per
    leaf where the JAX package stacks the layers of a period-scan
    position into one tensor)."""
    gl, el = T.leaves(grads), T.leaves(error_tree)
    if len(gl) != len(el):
        raise ValueError("compressed_pmean: grads and errors differ in "
                         "their leaves")
    if not gl:
        return grads, error_tree
    n = _size(groups)
    places = [(g.device_mesh, g.placements) if dt.is_dt(g) else None
              for g in gl]
    max_groups = list(groups) + _model_groups(places)
    with torch.no_grad():
        gl = [dt.settle(g).to_local() if dt.is_dt(g) else g for g in gl]
        g32 = [g.to(torch.float32) + e for g, e in zip(gl, el)]
        gmax = torch.stack([x.abs().max() for x in g32])
        _all_reduce(gmax, dist.ReduceOp.MAX, max_groups)
        if scale_of is not None:
            keys = list(scale_of)
            index = {k: i for i, k in enumerate(dict.fromkeys(keys))}
            ids = torch.tensor([index[k] for k in keys],
                               device=gmax.device)
            top = torch.zeros(len(index), device=gmax.device).scatter_reduce(
                0, ids, gmax, "amax", include_self=False)
            gmax = top[ids]
        codes = [quantize(x, m, n) for x, m in zip(g32, gmax)]
        new_err = [x - q.to(torch.float32) * s
                   for x, (q, s) in zip(g32, codes)]
        total = torch.cat([q.reshape(-1) for q, _ in codes])
        del g32
        _all_reduce(total, dist.ReduceOp.SUM, groups)          # int8 wire
        div = torch.full((), float(n), dtype=torch.float32,
                         device=total.device)
        means, off = [], 0
        for q, s in codes:
            part = total[off:off + q.numel()].view(q.shape)
            means.append(part.to(torch.float32) * s / div)
            off += q.numel()
        means = [m if pl is None else
                 DTensor.from_local(m, pl[0], pl[1], run_check=False)
                 for m, pl in zip(means, places)]
    names = [name for name, _ in T.flatten_with_names(grads)]
    by_m, by_e = dict(zip(names, means)), dict(zip(names, new_err))
    return (T.map_with_names(lambda name, _: by_m[name], grads),
            T.map_with_names(lambda name, _: by_e[name], grads))


def make_compressed_allreduce(mesh):
    """``fn(grads, err) -> (means, new err)``: the compressed gradient mean
    over ``mesh``'s data axes.  Each rank passes its local gradients
    (whole within the model axis, which the JAX package's in/out specs
    say and this function needs not be told)."""
    groups = data_groups(mesh)

    def fn(grads, err):
        return compressed_pmean(grads, err, groups)
    return fn
