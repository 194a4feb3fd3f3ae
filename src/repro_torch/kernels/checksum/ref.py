"""Plain PyTorch version of the batched checksum kernel (K3).

Computes what ``checksum_ref`` of the JAX package computes, bit for bit:
the RFC1071 ones'-complement sum of the big-endian 16-bit words of each
packet over word indices [start // 2, (length + 1) // 2), with
(length + 1) taken in int32 as the reference takes it (a length of
2**31 - 1 wraps negative and has no live word).  For an odd length the
last word pairs the final byte with the byte after it in the buffer,
whatever that byte holds.
"""
from __future__ import annotations

import torch


def _live_words_end(lengths: torch.Tensor) -> torch.Tensor:
    """(length + 1) // 2 with the sum wrapped to int32, as int64."""
    end = lengths.to(torch.int64) + 1
    end = torch.where(end > 2**31 - 1, end - 2**32, end)
    return torch.div(end, 2, rounding_mode="floor")


def checksum_ref(data: torch.Tensor, lengths: torch.Tensor, start: int
                 ) -> torch.Tensor:
    """data (N, W) uint8, lengths (N,) int; returns (N,) int64 (u16 value)."""
    n, w = data.shape
    b = data.to(torch.int64).reshape(n, w // 2, 2)
    words = (b[..., 0] << 8) | b[..., 1]
    w_iota = torch.arange(w // 2, dtype=torch.int64, device=data.device)
    last = _live_words_end(lengths)
    live = (w_iota[None, :] >= start // 2) & (w_iota[None, :] < last[:, None])
    s = torch.where(live, words, 0).sum(dim=1)
    s = (s & 0xFFFF) + (s >> 16)
    s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


def live_byte_ranges(lengths: torch.Tensor, start: int, width: int):
    """The bytes of each packet that the kernel reads, in whole 16-byte
    chunks: its live words' bytes [2 * (start // 2), 2 * w_hi) rounded out
    to 16 bytes, where w_hi = (length + 1) // 2 (as ``checksum_ref`` takes
    it) clipped to [0, width // 2].  Returns (lo, hi), each (N,) int64,
    with lo = hi = 0 for a packet with no live word; for
    ``width % 16 == 0`` the range lies inside the row."""
    end = 2 * _live_words_end(lengths).clamp(0, width // 2)
    begin = 2 * (start // 2)
    live = end > begin
    lo = torch.where(live, begin // 16 * 16, 0)
    hi = torch.where(live, (end + 15) // 16 * 16, 0)
    return lo, hi
