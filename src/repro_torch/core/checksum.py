"""Internet checksum, handler-side and batched-kernel forms; PyTorch port
of ``repro.core.checksum``.

``internet_checksum_1`` is the form the ICMP handler calls, as in the JAX
package; ``internet_checksum_batch`` goes through the batched kernel K3
(:mod:`repro_torch.kernels.checksum`), which launches on CUDA tensors.
Both compute the same function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.checksum import ops as checksum_ops
from repro_torch.kernels.checksum.ref import checksum_ref


def internet_checksum_1(data: torch.Tensor, length: torch.Tensor, start: int
                        ) -> torch.Tensor:
    """RFC1071 checksum of bytes [start, length) of each packet buffer.

    data (N, MTU) uint8, length (N,) int32; returns (N,) int64 (u16 value).
    Words are read up to ``(length + 1) // 2``, so for an odd length the
    byte after the last one is summed too, as in the JAX package.  Plain
    torch on every device.
    """
    return checksum_ref(data, length, start)


def internet_checksum_batch(data: torch.Tensor, lengths: torch.Tensor,
                            start: int) -> torch.Tensor:
    """The same checksum through kernel K3 (plain version on the CPU)."""
    return checksum_ops.internet_checksum(data, lengths, start=start)
