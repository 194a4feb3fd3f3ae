"""The link model: a lossy, reordering, duplicating wire with latency;
PyTorch port of ``repro.net.link``.

A :class:`Link` owns a fixed-capacity in-flight buffer (``LinkState``,
tensors that carry a leading batch dimension when the fabric stacks its
links).  Both operations follow the JAX package draw for draw:

  ``push(state, key, batch, now)``  - admit an egress ``PacketBatch``:
      each packet is independently dropped with probability ``loss``,
      duplicated with probability ``duplicate``, and stamped with a
      delivery tick ``now + latency + U[0, jitter]`` (+ an extra
      ``reorder_delay`` with probability ``reorder``).
  ``pop(state, now, n)``            - extract up to ``n`` packets whose
      delivery tick has passed, as an ingress ``PacketBatch``.

Randomness comes only from the key (:mod:`repro_torch.net.prng`, bit for
bit ``jax.random``), and which draws are made is part of the stream:
``split(key, 4)`` always, the jitter draw only when ``jitter > 0``, the
reorder draw only when ``reorder > 0`` (the loss and duplication draws
come from their own keys, so skipping them at probability 0, where their
results are known, changes nothing).  The probability thresholds are
compared in float32, as JAX rounds a Python float against a float32
array.

The module-level ``push``/``pop`` work on a stack of links (fields with a
leading link dimension), as the JAX package's vmapped fabric calls do;
``push`` writes the stack's ``data`` in place (the JAX package donates
it), so keep a ``clone()`` to hold the old state.  ``Link`` is the
one-link form and leaves its argument untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import packet as pkt
from repro_torch.net import prng

COUNTERS = ("pushed", "lost", "overflowed", "duplicated", "reordered",
            "delivered", "deferred")


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """Static link parameters (latencies in fabric ticks)."""
    loss: float = 0.0           # per-packet drop probability
    duplicate: float = 0.0      # per-packet duplication probability
    latency: int = 1            # base one-way latency, ticks (>= 1)
    jitter: int = 0             # uniform extra delay in [0, jitter]
    reorder: float = 0.0        # prob. of an extra reorder_delay penalty
    reorder_delay: int = 3
    capacity: int = 512         # in-flight buffer slots (overflow drops)


@dataclasses.dataclass
class LinkState:
    data: torch.Tensor        # (CAP, MTU) uint8 in-flight frames
    length: torch.Tensor      # (CAP,) int32
    deliver_at: torch.Tensor  # (CAP,) int32 delivery tick
    occupied: torch.Tensor    # (CAP,) bool
    pushed: torch.Tensor      # () int32 - packets offered to the link
    lost: torch.Tensor        # () int32 - dropped by the loss process
    overflowed: torch.Tensor  # () int32 - dropped on buffer overflow
    duplicated: torch.Tensor  # () int32
    reordered: torch.Tensor   # () int32 - packets given the reorder penalty
    delivered: torch.Tensor   # () int32
    deferred: torch.Tensor    # () int32 - ready packets a pop left behind
    #                           because the ingress batch was full

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}

    @staticmethod
    def from_numpy(d, device="cuda") -> "LinkState":
        """From a dict of arrays, or any object with the fields as
        attributes (the JAX package's ``LinkState`` with numpy leaves)."""
        dev = resolve_device(device)
        want = dict(data=np.uint8, occupied=bool)

        def get(name):
            return d[name] if isinstance(d, dict) else getattr(d, name)

        return LinkState(**{
            f.name: torch.as_tensor(
                np.array(get(f.name), dtype=want.get(f.name, np.int32)),
                device=dev)
            for f in dataclasses.fields(LinkState)})

    def clone(self) -> "LinkState":
        return LinkState(**{f.name: getattr(self, f.name).clone()
                            for f in dataclasses.fields(self)})

    def __getitem__(self, i) -> "LinkState":
        """Link ``i`` of a stacked state (views)."""
        return LinkState(**{f.name: getattr(self, f.name)[i]
                            for f in dataclasses.fields(self)})


def stack(states) -> LinkState:
    return LinkState(**{f.name: torch.stack([getattr(s, f.name)
                                             for s in states])
                        for f in dataclasses.fields(LinkState)})


def make_state(capacity: int, device="cuda") -> LinkState:
    dev = resolve_device(device)

    def zeros(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return LinkState(
        data=zeros((capacity, pkt.MTU), torch.uint8),
        length=zeros((capacity,)), deliver_at=zeros((capacity,)),
        occupied=zeros((capacity,), torch.bool),
        **{k: zeros(()) for k in COUNTERS})


def push(cfg: LinkConfig, state: LinkState, key: torch.Tensor,
         batch: pkt.PacketBatch, now: int) -> LinkState:
    """``push`` over a stack of links: ``state`` fields (L, ...), ``key``
    (L, 2), ``batch`` (L, n, MTU) / (L, n) - link ``i`` takes row ``i``
    of the batch with key ``i``, as the JAX package's vmapped push."""
    n = batch.data.shape[1]
    dev = batch.data.device

    def f32(p):
        return torch.tensor(p, dtype=torch.float32, device=dev)

    keys = prng.split(key, 4)
    k_loss, k_dup, k_jit, k_reo = (keys[:, i] for i in range(4))

    # a draw in [0, 1) always passes ``>= 0`` and never ``< 0``: at a
    # probability of 0 its result is known, and skipping it leaves the
    # other keys, and so the stream, as they are
    survives = batch.valid
    if cfg.loss > 0.0:
        survives = survives & (prng.uniform(k_loss, (n,)) >= f32(cfg.loss))
    dup = torch.zeros_like(survives)
    if cfg.duplicate > 0.0:
        dup = survives & (prng.uniform(k_dup, (n,)) < f32(cfg.duplicate))

    # candidates = originals + duplicates, each with its own delay sample
    cand_valid = torch.cat([survives, dup], dim=1)             # (L, 2n)
    delay = torch.full_like(cand_valid, cfg.latency, dtype=torch.int32)
    if cfg.jitter > 0:
        delay = delay + prng.randint(k_jit, (2 * n,), 0, cfg.jitter + 1)
    reo = torch.zeros_like(cand_valid)
    if cfg.reorder > 0.0:
        reo = prng.uniform(k_reo, (2 * n,)) < f32(cfg.reorder)
        delay = delay + torch.where(reo, cfg.reorder_delay, 0).to(
            torch.int32)
    deliver_at = (delay + now).to(torch.int32)

    # scatter candidates into free slots (FIFO over the slot array)
    n_links, cap = state.occupied.shape
    cand_rank = torch.cumsum(cand_valid.to(torch.int32), 1,
                             dtype=torch.int32) - 1
    n_free = (~state.occupied).sum(1, dtype=torch.int32, keepdim=True)
    fits = cand_valid & (cand_rank < n_free)
    # slot index for the r-th candidate = index of the r-th free slot
    slot_of_rank = torch.argsort(state.occupied.to(torch.uint8), dim=1,
                                 stable=True)                  # free first
    slot = torch.gather(slot_of_rank, 1,
                        cand_rank.clamp(0, cap - 1).to(torch.int64))
    # flat row targets; cap*L drops (fitting candidates never repeat one)
    rows = torch.arange(n_links, device=dev)[:, None] * cap + slot
    tgt = torch.where(fits, rows, n_links * cap).reshape(-1)
    cand = torch.arange(2 * n, device=dev) % n                 # source row
    src = (torch.arange(n_links, device=dev)[:, None] * n
           + cand[None, :]).reshape(-1)
    data = state.data.view(n_links * cap, pkt.MTU)
    _put_rows(data, tgt, batch.data.reshape(n_links * n, pkt.MTU)[src])
    length = state.length.clone().view(-1)
    _put_rows(length, tgt, batch.length.reshape(-1)[src])
    dat = state.deliver_at.clone().view(-1)
    _put_rows(dat, tgt, deliver_at.reshape(-1))
    occupied = state.occupied.clone().view(-1)
    _put_rows(occupied, tgt, torch.ones_like(tgt, dtype=torch.bool))

    def count(m):
        return m.sum(1, dtype=torch.int32)

    return LinkState(
        data=state.data, length=length.view(n_links, cap),
        deliver_at=dat.view(n_links, cap),
        occupied=occupied.view(n_links, cap),
        pushed=state.pushed + count(batch.valid),
        lost=state.lost + count(batch.valid & ~survives),
        overflowed=state.overflowed + count(cand_valid & ~fits),
        duplicated=state.duplicated + count(dup),
        reordered=state.reordered + count(cand_valid & reo),
        delivered=state.delivered, deferred=state.deferred)


def _put_rows(dst: torch.Tensor, tgt: torch.Tensor, val: torch.Tensor):
    """In place ``dst[tgt] = val`` along dim 0, where ``tgt == len(dst)``
    drops a row and no kept target repeats; no host synchronisation.
    Dropped rows rewrite row 0 with the value it ends up with anyway."""
    size = dst.shape[0]
    keep = tgt < size
    hit0 = tgt == 0
    row0 = torch.where(hit0.any(), val[hit0.to(torch.int8).argmax()],
                       dst[0])
    shape = (-1,) + (1,) * (val.dim() - 1)
    dst.index_put_((torch.where(keep, tgt, 0),),
                   torch.where(keep.view(shape), val, row0))


def pop(state: LinkState, now: int, n: int
        ) -> Tuple[LinkState, pkt.PacketBatch]:
    """``pop`` over a stack of links (fields (L, ...)): the batch is
    (L, min(n, CAP), ...), taken slots first in slot order, then the
    untaken rows in slot order (invalid, but whole, as in JAX)."""
    ready = state.occupied & (state.deliver_at <= now)
    rank = torch.cumsum(ready.to(torch.int32), 1, dtype=torch.int32) - 1
    take = ready & (rank < n)
    order = torch.argsort((~take).to(torch.uint8), dim=1,
                          stable=True)[:, :n]                  # taken first
    out = pkt.PacketBatch(
        data=torch.gather(state.data, 1,
                          order[:, :, None].expand(-1, -1, pkt.MTU)),
        length=torch.gather(state.length, 1, order),
        valid=torch.gather(take, 1, order))
    new = dataclasses.replace(
        state, occupied=state.occupied & ~take,
        delivered=state.delivered + take.sum(1, dtype=torch.int32),
        deferred=state.deferred + (ready & ~take).sum(1, dtype=torch.int32))
    return new, out


class Link:
    """One directed ingress pipe: every frame headed to a node traverses
    its link before the NIC sees it."""

    def __init__(self, cfg: LinkConfig = LinkConfig(), device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_state(self) -> LinkState:
        return make_state(self.cfg.capacity, self.device)

    def push(self, state: LinkState, key: torch.Tensor,
             batch: pkt.PacketBatch, now: int) -> LinkState:
        one = pkt.PacketBatch(batch.data[None], batch.length[None],
                              batch.valid[None])
        return push(self.cfg, stack([state]), key[None], one, now)[0]

    def pop(self, state: LinkState, now: int, n: int
            ) -> Tuple[LinkState, pkt.PacketBatch]:
        new, out = pop(stack([state]), now, n)
        return new[0], pkt.PacketBatch(out.data[0], out.length[0],
                                       out.valid[0])

    def stats(self, state: LinkState) -> dict:
        return {k: int(getattr(state, k)) for k in COUNTERS}
