"""The sPIN handler programming model and its batched execution VM;
PyTorch port of ``repro.core.handlers``.

A user of sPIN writes up to three functions: *header-*, *packet-* and
*tail-handler* (paper §III-A, §IV-C).  Here a handler is a function

    fn(args: HandlerArgs, user) -> HandlerOut

written over an explicit leading batch dimension: every field of
``HandlerArgs`` and ``HandlerOut`` has one row per packet, except the
``expect`` table, which is shared by all lanes.  ``user`` is the
per-context constant state uploaded with the execution context.  The
handler-visible API mirrors Table IV:

    spin_send_packet   -> HandlerOut.egress_*
    spin_dma (to host) -> HandlerOut.dma_off / dma_val (byte-granular
                          scatter, the unaligned-write path of
                          pspin_hostmem_dma)
    spin_write_to_host -> write_u64_to_host helper
    push_counter       -> HandlerOut.counter_*
    cycles()           -> args.cycles
    spin_lock_*        -> intentionally absent: the VM applies all effects
                          by deterministic masked scatter, so message state
                          updates must be associative-commutative.

Ordering semantics: the VM runs three phases per batch (header handlers,
then packet handlers, then tail handlers) and message state written by one
phase is visible to the next (sPIN guarantee).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.packet import MTU

MSG_STATE_DIM = 8        # int32 words of per-message handler state
N_COUNTER_QUEUES = 4
COUNTER_QUEUE_LEN = 64


@dataclasses.dataclass
class HandlerArgs:
    """Per-packet arguments (the ``handler_args_t`` of the paper), batched."""
    pkt: torch.Tensor        # (N, MTU) uint8 packet bytes read from L2
    pkt_len: torch.Tensor    # (N,) int32
    msg_id: torch.Tensor     # (N,) int64 u32
    eom: torch.Tensor        # (N,) bool
    ctx: torch.Tensor        # (N,) int32
    msg_state: torch.Tensor  # (N, MSG_STATE_DIM) int32
    cycles: torch.Tensor     # (N,) int32 global cycle counter (cycles())
    expect: torch.Tensor     # (E,) int64 u32, host-programmed per-slot
    #                          expected msg_id table (shared across lanes):
    #                          contexts that reuse DMA regions check arriving
    #                          frames against it, so a stale retransmit of a
    #                          previous occupant can never scribble a
    #                          recycled slot

    @property
    def n(self) -> int:
        return self.pkt.shape[0]


@dataclasses.dataclass
class HandlerOut:
    """All effects of a batch of handler invocations, one row per packet."""
    egress_data: torch.Tensor    # (N, MTU) uint8
    egress_len: torch.Tensor     # (N,) int32
    egress_valid: torch.Tensor   # (N,) bool
    dma_off: torch.Tensor        # (N, MTU) int32 host byte offsets, -1 skip
    dma_val: torch.Tensor        # (N, MTU) uint8
    state_delta: torch.Tensor    # (N, MSG_STATE_DIM) int32 (assoc. add)
    counter_queue: torch.Tensor  # (N,) int32, -1 = none
    counter_val: torch.Tensor    # (N,) int32


def none_out(n: int, device) -> HandlerOut:
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return HandlerOut(
        egress_data=full((n, MTU), 0, torch.uint8),
        egress_len=full((n,), 0, torch.int32),
        egress_valid=full((n,), False, torch.bool),
        dma_off=full((n, MTU), -1, torch.int32),
        dma_val=full((n, MTU), 0, torch.uint8),
        state_delta=full((n, MSG_STATE_DIM), 0, torch.int32),
        counter_queue=full((n,), -1, torch.int32),
        counter_val=full((n,), 0, torch.int32),
    )


def _rows(value, n: int, dtype, device) -> torch.Tensor:
    """A scalar or (N,) value as an (N,) tensor."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype).expand(n)
    return torch.full((n,), value, dtype=dtype, device=device)


# ----------------------------------------------------------------- runtime
def spin_send_packet(out: HandlerOut, data: torch.Tensor, length
                     ) -> HandlerOut:
    """Queue one egress packet per lane (non-blocking spin_send_packet)."""
    n = data.shape[0]
    return dataclasses.replace(
        out, egress_data=data,
        egress_len=_rows(length, n, torch.int32, data.device),
        egress_valid=torch.ones((n,), dtype=torch.bool, device=data.device))


def spin_dma_to_host(out: HandlerOut, host_off, values: torch.Tensor,
                     nbytes, src_start=0) -> HandlerOut:
    """DMA ``values[:, src_start:src_start+nbytes]`` to host byte offset
    ``host_off`` (per lane).  Byte-granular, so arbitrarily unaligned."""
    n, k = values.shape
    dev = values.device
    lane = torch.arange(k, dtype=torch.int32, device=dev)[None, :]
    host_off = _rows(host_off, n, torch.int32, dev)[:, None]
    nbytes = _rows(nbytes, n, torch.int32, dev)[:, None]
    src_start = _rows(src_start, n, torch.int32, dev)[:, None]
    live = (lane >= src_start) & (lane < src_start + nbytes)
    off = torch.where(live, host_off + (lane - src_start), -1)
    # merge with existing ops (first-writer wins on overlapping lanes)
    take = live & (out.dma_off[:, :k] < 0)
    dma_off = out.dma_off.clone()
    dma_val = out.dma_val.clone()
    dma_off[:, :k] = torch.where(take, off, out.dma_off[:, :k])
    dma_val[:, :k] = torch.where(take, values, out.dma_val[:, :k])
    return dataclasses.replace(out, dma_off=dma_off, dma_val=dma_val)


def spin_dma_scatter(out: HandlerOut, offsets: torch.Tensor,
                     values: torch.Tensor) -> HandlerOut:
    """Fully general per-byte scatter DMA (offsets -1 = skip), the DDT
    unpack path.  offsets/values are (N, MTU)."""
    return dataclasses.replace(out, dma_off=offsets.to(torch.int32),
                               dma_val=values)


def write_u64_to_host(out: HandlerOut, host_off, value) -> HandlerOut:
    """spin_write_to_host: 64-bit little-endian word per lane.  The value
    is taken modulo 2**32 (upper four bytes zero), as the JAX package's
    ``uint64`` is 32 bits wide with JAX's default 64-bit mode off."""
    n = out.dma_off.shape[0]
    dev = out.dma_off.device
    v = _rows(value, n, torch.int64, dev)[:, None] & 0xFFFFFFFF
    shifts = torch.arange(8, dtype=torch.int64, device=dev) * 8
    data = ((v >> shifts) & 0xFF).to(torch.uint8)
    return spin_dma_to_host(out, host_off, data, 8)


def push_counter(out: HandlerOut, queue: int, value) -> HandlerOut:
    """Enqueue a value into a host-readable FIFO (paper push_counter)."""
    n = out.counter_queue.shape[0]
    dev = out.counter_queue.device
    return dataclasses.replace(
        out, counter_queue=_rows(queue, n, torch.int32, dev),
        counter_val=_rows(value, n, torch.int32, dev))


def add_msg_state(out: HandlerOut, index: int, delta) -> HandlerOut:
    """Associative-commutative update of per-message state word ``index``."""
    n = out.state_delta.shape[0]
    sd = out.state_delta.clone()
    sd[:, index] += _rows(delta, n, torch.int32, sd.device)
    return dataclasses.replace(out, state_delta=sd)


HandlerFn = Callable[[HandlerArgs, Any], HandlerOut]


def default_handler(args: HandlerArgs, user: Any) -> HandlerOut:
    return none_out(args.n, args.pkt.device)


@dataclasses.dataclass
class ExecutionContext:
    """Host-side execution context: fpspin_init(ctx, ruleset, handlers)."""
    name: str
    ruleset: Any                          # matching.Ruleset
    header: HandlerFn = default_handler
    packet: HandlerFn = default_handler
    tail: HandlerFn = default_handler
    user: Any = None                      # constant per-context state
    host_base: int = 0                    # base offset into host DMA buffer
    host_size: int = 0
    n_expect: int = 0                     # slots of the host-programmed
    #                                       expected-msg_id table this
    #                                       context owns (0 = unused)
    # message_mode=True: the protocol defines messages (header/tail handlers
    # run, MPQ tracks state).  False: pure packet matching (sPIN layer-2
    # mode: "simply execute the packet handler on every matching packet").
    message_mode: bool = False


def run_phase(fn: HandlerFn, args: HandlerArgs, user: Any,
              mask: torch.Tensor) -> HandlerOut:
    """Run one handler over the batch and mask out non-participants (the
    expect table is shared, not per-lane)."""
    outs = fn(args, user)
    m1 = mask[:, None]
    return HandlerOut(
        egress_data=outs.egress_data,
        egress_len=torch.where(mask, outs.egress_len, 0),
        egress_valid=outs.egress_valid & mask,
        dma_off=torch.where(m1, outs.dma_off, -1),
        dma_val=outs.dma_val,
        state_delta=torch.where(m1, outs.state_delta, 0),
        counter_queue=torch.where(mask, outs.counter_queue, -1),
        counter_val=torch.where(mask, outs.counter_val, 0),
    )
