"""Plain PyTorch version of the grouped expert kernel (K6).

The routed SwiGLU experts over rows already sorted by expert: rows
``offsets[e]:offsets[e + 1]`` of ``x`` go through expert ``e``,
``down(silu(x gate) * (x up))``.  The arithmetic is K6's: both products
of the first stage accumulate in float32, the SwiGLU is taken in
float32 and rounded once to the rows' dtype, and the down product
accumulates in float32 and is rounded once.  An expert with no rows is
not touched.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace


def moe_experts_ref(x: torch.Tensor, offsets: torch.Tensor,
                    gate: torch.Tensor, up: torch.Tensor,
                    down: torch.Tensor) -> torch.Tensor:
    """x (R, d) sorted by expert; offsets (E + 1,) integer, offsets[0] 0 and
    offsets[E] R; gate, up (>= E, d, ff); down (>= E, ff, d).  Returns
    (R, d) in x's dtype.  The loop reads the offsets on the host
    (``host_syncs`` counts it)."""
    trace.count("host_syncs")
    bounds = offsets.tolist()
    parts = []
    for e, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        if hi == lo:
            continue
        xe = x[lo:hi].to(torch.float32)
        h = xe @ gate[e].to(torch.float32)
        u = xe @ up[e].to(torch.float32)
        act = (F.silu(h) * u).to(x.dtype)
        parts.append((act.to(torch.float32)
                      @ down[e].to(torch.float32)).to(x.dtype))
    if not parts:
        return x.new_zeros(x.shape)
    return torch.cat(parts)
