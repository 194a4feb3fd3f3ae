"""Plain PyTorch version of the DDT gather kernel (K2).

The CPU path, and the oracle that ``chip_smoke.py`` holds the CUDA kernel
against.  Same semantics as ``repro.kernels.ddt.ref.ddt_gather_ref``.
"""
from __future__ import annotations

import torch


def ddt_gather_ref(src: torch.Tensor, idx: torch.Tensor, fill=0
                   ) -> torch.Tensor:
    """out[i] = src[clip(idx[i], 0, S-1)] if idx[i] >= 0 else fill."""
    safe = idx.to(torch.int64).clamp(0, src.shape[0] - 1)
    fill_t = torch.full((), fill, dtype=src.dtype, device=src.device)
    return torch.where(idx >= 0, src[safe], fill_t)
