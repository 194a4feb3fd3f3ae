"""Deterministic scatter with the semantics of JAX's
``x.at[idx].set(val, mode="drop")`` on the CPU.

JAX normalises a negative index by adding the size, drops an index that
is still out of range, and applies repeated indices in lane order, so the
last lane wins.  ``index_put_`` raises on an index out of range, and on
CUDA leaves the winner among repeats undefined.  ``scatter_set_`` picks
the winner explicitly: a scatter-amax of the flat lane id per target,
after which every lane writes its target's winning value, so repeats
agree whatever order the device applies them in.
"""
from __future__ import annotations

import torch

from repro_torch import trace


def scatter_set_(dst: torch.Tensor, idx: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """In place ``dst[idx] = val`` for a 1-D ``dst``; returns ``dst``.

    ``idx`` and ``val`` are flattened in row-major order, which is the lane
    order that decides repeats.  Indexing ``val`` with the 0-d ``w0``
    reads it on the host: on CUDA one synchronisation a call
    (``host_syncs`` counts it).
    """
    size = dst.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    val = val.reshape(-1).to(dst.dtype)
    if idx.numel() == 0:
        return dst
    idx = torch.where(idx < 0, idx + size, idx)
    keep = (idx >= 0) & (idx < size)
    tgt = torch.where(keep, idx, size)                  # size: dropped lanes
    lane = torch.arange(idx.numel(), device=dst.device)
    winner = torch.full((size + 1,), -1, dtype=torch.int64,
                        device=dst.device)
    winner.scatter_reduce_(0, tgt, lane, reduce="amax")
    win_val = val[winner[tgt].clamp(min=0)]
    # dropped lanes rewrite dst[0] with the value it ends up with anyway
    w0 = winner[0]
    trace.count("host_syncs")
    final0 = torch.where(w0 >= 0, val[w0.clamp(min=0)], dst[0])
    dst.index_put_((torch.where(keep, idx, 0),),
                   torch.where(keep, win_val, final0))
    return dst
