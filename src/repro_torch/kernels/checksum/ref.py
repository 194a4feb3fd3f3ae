"""Plain PyTorch version of the batched checksum kernel (K3).

Computes what ``checksum_ref`` of the JAX package computes, bit for bit:
the RFC1071 ones'-complement sum of the big-endian 16-bit words of each
packet over word indices [start // 2, (length + 1) // 2).  For an odd
length the last word pairs the final byte with the byte after it in the
buffer, whatever that byte holds.
"""
from __future__ import annotations

import torch


def checksum_ref(data: torch.Tensor, lengths: torch.Tensor, start: int
                 ) -> torch.Tensor:
    """data (N, W) uint8, lengths (N,) int; returns (N,) int64 (u16 value)."""
    n, w = data.shape
    b = data.to(torch.int64).reshape(n, w // 2, 2)
    words = (b[..., 0] << 8) | b[..., 1]
    w_iota = torch.arange(w // 2, dtype=torch.int64, device=data.device)
    last = torch.div(lengths.to(torch.int64) + 1, 2, rounding_mode="floor")
    live = (w_iota[None, :] >= start // 2) & (w_iota[None, :] < last[:, None])
    s = torch.where(live, words, 0).sum(dim=1)
    s = (s & 0xFFFF) + (s >> 16)
    s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF
