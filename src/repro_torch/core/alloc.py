"""Bimodal fixed-slot packet-buffer allocator (paper §IV, block 2); PyTorch
port of ``repro.core.alloc``.

The L2 packet buffer is split into two halves: fixed 128-byte slots and
fixed 1536-byte slots, with free slots held in two FIFOs; allocation pops,
free pushes.  A whole batch of requests is served at once: per-class ranks
come from a cumsum, so pops stay FIFO-ordered, and once a class is
exhausted every later request in the batch fails, exactly like sequential
pops.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core.packet import MTU, SMALL_SLOT
from repro_torch.core.scatter import scatter_set_

# Paper Table I: FPsPIN L2 packet memory = 512 KiB, split in half.
L2_PKT_BYTES = 512 * 1024
N_SMALL = (L2_PKT_BYTES // 2) // SMALL_SLOT          # 2048 slots
N_LARGE = (L2_PKT_BYTES // 2) // MTU                 # 170 slots
LARGE_BASE = N_SMALL * SMALL_SLOT                    # byte address of region


@dataclasses.dataclass
class AllocState:
    small_fifo: torch.Tensor   # (N_SMALL,) int32 slot ids
    small_head: torch.Tensor   # () int32
    small_count: torch.Tensor  # () int32
    large_fifo: torch.Tensor
    large_head: torch.Tensor
    large_count: torch.Tensor


def make_state(n_small: int = N_SMALL, n_large: int = N_LARGE,
               device="cuda") -> AllocState:
    dev = resolve_device(device)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return AllocState(
        small_fifo=torch.arange(n_small, dtype=torch.int32, device=dev),
        small_head=scalar(0), small_count=scalar(n_small),
        large_fifo=torch.arange(n_large, dtype=torch.int32, device=dev),
        large_head=scalar(0), large_count=scalar(n_large),
    )


def _class_alloc(fifo, head, count, want):
    """Vectorized FIFO pop for one size class.

    want: (N,) bool.  Returns (head, count, slot, ok).
    """
    cap = fifo.shape[0]
    rank = torch.cumsum(want.to(torch.int32), 0, dtype=torch.int32) - 1
    ok = want & (rank < count)
    pos = (head + rank.clamp(min=0)) % cap
    slot = fifo[pos.to(torch.int64)]
    taken = ok.sum(dtype=torch.int32)
    return (head + taken) % cap, count - taken, slot, ok


def alloc(state: AllocState, sizes: torch.Tensor, valid: torch.Tensor):
    """Allocate a slot per packet.  sizes (N,) int32, valid (N,) bool.

    Returns (state, addr (N,) int32, ok (N,) bool).  addr is the byte
    address within the L2 packet buffer; -1 when allocation failed (the
    packet is dropped, as in hardware when the free FIFO underflows).
    """
    is_small = sizes <= SMALL_SLOT
    sh, sc, s_slot, s_ok = _class_alloc(
        state.small_fifo, state.small_head, state.small_count,
        valid & is_small)
    lh, lc, l_slot, l_ok = _class_alloc(
        state.large_fifo, state.large_head, state.large_count,
        valid & ~is_small)
    addr = torch.where(
        s_ok, s_slot * SMALL_SLOT,
        torch.where(l_ok, LARGE_BASE + l_slot * MTU, -1)).to(torch.int32)
    new = AllocState(state.small_fifo, sh, sc, state.large_fifo, lh, lc)
    return new, addr, s_ok | l_ok


def _class_free(fifo, head, count, slot, do):
    cap = fifo.shape[0]
    rank = torch.cumsum(do.to(torch.int32), 0, dtype=torch.int32) - 1
    tail = (head + count) % cap
    pos = torch.where(do, (tail + rank) % cap, cap)          # cap -> dropped
    fifo = scatter_set_(fifo.clone(), pos, slot)
    return fifo, count + do.sum(dtype=torch.int32)


def free(state: AllocState, addr: torch.Tensor, do: torch.Tensor
         ) -> AllocState:
    """Return slots to their FIFOs.  addr (N,) int32, do (N,) bool."""
    do = do & (addr >= 0)
    is_small = addr < LARGE_BASE
    s_fifo, s_count = _class_free(
        state.small_fifo, state.small_head, state.small_count,
        torch.div(addr, SMALL_SLOT, rounding_mode="floor"), do & is_small)
    l_fifo, l_count = _class_free(
        state.large_fifo, state.large_head, state.large_count,
        torch.div(addr - LARGE_BASE, MTU, rounding_mode="floor"),
        do & ~is_small)
    return AllocState(s_fifo, state.small_head, s_count,
                      l_fifo, state.large_head, l_count)
