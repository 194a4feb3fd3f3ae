"""Handler Execution Requests and the packet scheduler (paper §III-C,
§IV-4); PyTorch port of ``repro.core.her``.

A ``HERBatch`` carries one record per packet; the scheduler decides, per
packet, whether the header handler must run (first packet of a
not-yet-active message) and assigns an HPU lane.  The message-state table
is the Message Processing Queue (MPQ), 16 entries as in FPsPIN (Table I),
indexed by a hash of ``(ctx, msg_id)``.  An MPQ collision evicts the older
message and counts it.  When two new messages of one batch hash to the same
slot, the later lane's key wins, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core.scatter import scatter_set_

MPQ_ENTRIES = 16           # Table I (FPsPIN column)
N_CLUSTERS = 2             # Table I
HPUS_PER_CLUSTER = 8       # PsPIN cluster = 8 PULP cores


@dataclasses.dataclass
class HERBatch:
    ctx: torch.Tensor         # (N,) int32  matched execution context (-1)
    addr: torch.Tensor        # (N,) int32  packet address in L2 buffer
    size: torch.Tensor        # (N,) int32  packet length in bytes
    msg_id: torch.Tensor      # (N,) int64  u32 message id
    eom: torch.Tensor         # (N,) bool
    valid: torch.Tensor       # (N,) bool
    lane: torch.Tensor        # (N,) int32  assigned HPU lane
    slot: torch.Tensor        # (N,) int32  MPQ slot (message-state index)
    run_header: torch.Tensor  # (N,) bool
    run_tail: torch.Tensor    # (N,) bool


@dataclasses.dataclass
class MPQState:
    """Active-message table (the Message Processing Queue)."""
    key: torch.Tensor        # (S,) int64 packed u32 (ctx, msg_id) key
    active: torch.Tensor     # (S,) bool
    evictions: torch.Tensor  # () int32 observability counter


def make_mpq(entries: int = MPQ_ENTRIES, device="cuda") -> MPQState:
    dev = resolve_device(device)
    return MPQState(key=torch.zeros((entries,), dtype=torch.int64,
                                    device=dev),
                    active=torch.zeros((entries,), dtype=torch.bool,
                                       device=dev),
                    evictions=torch.zeros((), dtype=torch.int32, device=dev))


def _msg_key(ctx, msg_id):
    # pack context into the top 4 bits; contexts are few (<16)
    return ((msg_id & 0x0FFFFFFF) | (ctx.to(torch.int64) << 28)) & 0xFFFFFFFF


def generate(mpq: MPQState, ctx, addr, size, msg_id, eom, valid):
    """HER generation + scheduling for one packet batch.

    Decides header/tail handler execution and updates the MPQ.  Returns
    (mpq, HERBatch); ``mpq`` is not modified.
    """
    n = ctx.shape[0]
    entries = mpq.key.shape[0]
    key = _msg_key(ctx.clamp(min=0), msg_id)
    slot = (key % entries).to(torch.int32)
    slot64 = slot.to(torch.int64)

    # first occurrence of each (ctx,msg) within this batch, in batch order
    same = (key[:, None] == key[None, :]) & valid[:, None] & valid[None, :]
    earlier = torch.ones((n, n), dtype=torch.bool,
                         device=ctx.device).tril(diagonal=-1)
    first_in_batch = ~(same & earlier).any(dim=1)

    # message already active in the MPQ?
    key_at = mpq.key[slot64]
    active_at = mpq.active[slot64]
    mpq_hit = active_at & (key_at == key)
    run_header = valid & first_in_batch & ~mpq_hit
    run_tail = valid & eom

    # MPQ update: activate started messages, deactivate completed ones.
    # A slot collision (different key, slot active) evicts: count it.
    evict = run_header & active_at & (key_at != key)
    start_pos = torch.where(run_header, slot64, entries)
    new_key = scatter_set_(mpq.key.clone(), start_pos, key)
    new_active = scatter_set_(mpq.active.clone(), start_pos,
                              torch.ones_like(run_header))
    # EOM completes the message (tail handler runs in this batch)
    done = run_tail & (new_key[slot64] == key)
    new_active = scatter_set_(new_active, torch.where(done, slot64, entries),
                              torch.zeros_like(done))
    new_mpq = MPQState(new_key, new_active,
                       mpq.evictions + evict.sum(dtype=torch.int32))

    # Lane assignment: cluster = slot parity (message affinity), round-robin
    # HPUs inside the cluster, mirroring the two-level scheduler.
    lane = (slot % N_CLUSTERS) * HPUS_PER_CLUSTER + (
        torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    ) % HPUS_PER_CLUSTER
    her = HERBatch(ctx=ctx, addr=addr, size=size, msg_id=msg_id, eom=eom,
                   valid=valid, lane=lane.to(torch.int32), slot=slot,
                   run_header=run_header, run_tail=run_tail)
    return new_mpq, her
