"""Internet checksum, handler-side form; PyTorch port of
``internet_checksum_1`` in ``repro.core.checksum``.

The batched checksum kernel (K3) is not on this slice's path and is not
ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.packet import MTU


def internet_checksum_1(data: torch.Tensor, length: torch.Tensor, start: int
                        ) -> torch.Tensor:
    """RFC1071 checksum of bytes [start, length) of each packet buffer.

    data (N, MTU) uint8, length (N,) int32; returns (N,) int64 (u16 value).
    Words are read up to ``(length + 1) // 2``, so for an odd length the
    byte after the last one is summed too, as in the JAX package.
    """
    b = data.to(torch.int64).reshape(-1, MTU // 2, 2)
    words = (b[..., 0] << 8) | b[..., 1]
    w_iota = torch.arange(MTU // 2, dtype=torch.int32, device=data.device)
    live = (w_iota[None, :] >= start // 2) \
        & (w_iota[None, :] < torch.div(length + 1, 2,
                                       rounding_mode="floor")[:, None])
    s = torch.where(live, words, 0).sum(dim=1)
    s = (s & 0xFFFF) + (s >> 16)
    s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF
