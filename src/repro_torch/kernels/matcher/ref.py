"""Plain PyTorch versions of the matching-engine kernel (K1).

The CPU path, and the oracle that ``chip_smoke.py`` holds the CUDA kernel
against.  ``match_ref`` computes what ``repro.kernels.matcher.ref.match_ref``
computes, reading the frames' bytes instead of a precomputed word view;
``match_first_ref`` adds the epilogue of ``repro.core.matching.match_batch``.
"""
from __future__ import annotations

import torch


def match_ref(data: torch.Tensor, rules: torch.Tensor, modes: torch.Tensor):
    """data (N, B) uint8 frames, B a multiple of 4; rules (C, 4, 4) int64
    holding u32 ``[idx, mask, start, end]``; modes (C,) int32.

    Rule (c, r) selects the big-endian u32 word at byte ``4*idx`` (``idx``
    read as int32 and clipped to [0, B/4 - 1]) and tests
    ``start <= word & mask <= end``.  Returns (matched, eom) as (N, C) bool:
    matched is the AND (mode 0) or OR of rules 0-2, eom is rule 3.
    """
    w = data.shape[1] // 4
    u32 = rules.to(torch.int64) & 0xFFFFFFFF
    idx = ((u32[:, :, 0] ^ 0x80000000) - 0x80000000).clamp(0, w - 1)
    byte = 4 * idx[..., None] + torch.arange(4, device=data.device)
    b = data[:, byte].to(torch.int64)                       # (N, C, 4, 4)
    word = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) \
        | b[..., 3]                                          # (N, C, 4)
    v = word & u32[None, :, :, 1]
    ok = (v >= u32[None, :, :, 2]) & (v <= u32[None, :, :, 3])
    and_mode = ok[..., 0] & ok[..., 1] & ok[..., 2]
    or_mode = ok[..., 0] | ok[..., 1] | ok[..., 2]
    matched = torch.where(modes[None, :] == 0, and_mode, or_mode)
    return matched, ok[..., 3]


def match_first_ref(data: torch.Tensor, rules: torch.Tensor,
                    modes: torch.Tensor, valid: torch.Tensor):
    """``match_ref`` followed by the first-match priority encoder: returns
    (ctx_id, eom), ctx_id (N,) int32 the lowest-numbered context that
    matches a valid lane (-1 when none does), eom (N,) bool that context's
    EOM rule (False when none matches)."""
    matched, eom = match_ref(data, rules, modes)
    matched = matched & valid[:, None]
    any_match = matched.any(dim=1)
    first = matched.to(torch.uint8).argmax(dim=1)
    ctx_id = torch.where(any_match, first.to(torch.int32), -1)
    eom_hit = eom.gather(1, first[:, None])[:, 0]
    return ctx_id, any_match & eom_hit
