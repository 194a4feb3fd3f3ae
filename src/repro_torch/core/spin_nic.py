"""The complete FPsPIN datapath (paper Fig 5); PyTorch port of
``repro.core.spin_nic``.

One ``step`` processes a batch of ingress frames through the module
sequence of the hardware:

  1. ``pspin_pkt_match``   - execution-context matching, kernel K1
                              (kernels/matcher); non-matching frames are
                              forwarded to the Corundum/host datapath.
  2. ``pspin_pkt_alloc``   - bimodal slot allocation in the L2 packet
                              buffer (core/alloc); on FIFO underflow the
                              frame is dropped and counted.
  3. ``pspin_ingress_dma`` - frames are copied into the modelled L2 packet
                              buffer, and the handlers read a full MTU
                              window back out of it, as HPUs read L1/L2.
  4. ``pspin_her_gen``     - HER generation + MPQ scheduling (core/her).
  5. handler execution     - header, packet, tail phases (core/handlers),
                              message state visible across phases.
  6. effect application    - egress arbitration, byte-granular host DMA,
                              counter FIFOs, slot free on completion.

Where the hardware writes one target from several lanes (host DMA of
overlapping datatype bytes, MPQ slots, FIFO positions), the last lane wins,
chosen explicitly (core/scatter) so that CUDA gives the JAX package's
answer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, trace
from repro_torch.core import alloc as palloc
from repro_torch.core import handlers as H
from repro_torch.core import her as herlib
from repro_torch.core import matching
from repro_torch.core import packet as pkt
from repro_torch.core.scatter import scatter_set_

# NICState.to_numpy keys whose values are u32 (held as int64 in torch)
_U32_FIELDS = ("mpq.key", "expect")


@dataclasses.dataclass
class NICState:
    l2: torch.Tensor             # (L2_PKT_BYTES,) uint8 packet buffer
    alloc: palloc.AllocState
    mpq: herlib.MPQState
    msg_state: torch.Tensor      # (MPQ, MSG_STATE_DIM) int32
    host: torch.Tensor           # (HOST,) uint8 host DMA window
    counters: torch.Tensor       # (Q, QLEN) int32
    counter_count: torch.Tensor  # (Q,) int32
    cycles: torch.Tensor         # () int32
    dropped: torch.Tensor        # () int32 alloc-failure drops
    expect: torch.Tensor         # (E,) int64 u32 host-programmed per-slot
    #                              expected msg_id (0 = slot disarmed)

    # ---------------------------------------------------- carrying state
    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Flat dict of numpy arrays: ``"l2"``, ``"alloc.small_fifo"``, ...,
        ``"mpq.key"``, ..., ``"expect"``; u32 fields come back as uint32."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if dataclasses.is_dataclass(v):
                for g in dataclasses.fields(v):
                    out[f"{f.name}.{g.name}"] = getattr(v, g.name)
            else:
                out[f.name] = v
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for k in _U32_FIELDS:
            out[k] = out[k].astype(np.uint32)
        return out

    @staticmethod
    def from_numpy(d: Dict[str, np.ndarray], device="cuda") -> "NICState":
        """Inverse of ``to_numpy``: the dict may come from either package
        (the JAX package's ``NICState`` flattened the same way)."""
        dev = resolve_device(device)
        want = {"l2": np.uint8, "msg_state": np.int32, "host": np.uint8,
                "counters": np.int32, "counter_count": np.int32,
                "cycles": np.int32, "dropped": np.int32, "expect": np.int64,
                "mpq.key": np.int64, "mpq.active": bool,
                "mpq.evictions": np.int32}

        def t(k):
            return torch.as_tensor(
                np.array(d[k], dtype=want.get(k, np.int32)), device=dev)

        sub = {name: {f.name: t(f"{name}.{f.name}")
                      for f in dataclasses.fields(cls)}
               for name, cls in (("alloc", palloc.AllocState),
                                 ("mpq", herlib.MPQState))}
        return NICState(
            l2=t("l2"), alloc=palloc.AllocState(**sub["alloc"]),
            mpq=herlib.MPQState(**sub["mpq"]), msg_state=t("msg_state"),
            host=t("host"), counters=t("counters"),
            counter_count=t("counter_count"), cycles=t("cycles"),
            dropped=t("dropped"), expect=t("expect"))

    def clone(self) -> "NICState":
        """A deep copy (``step`` updates ``l2`` and ``host`` in place)."""
        def cp(x):
            if dataclasses.is_dataclass(x):
                return type(x)(**{f.name: cp(getattr(x, f.name))
                                  for f in dataclasses.fields(x)})
            return x.clone()
        return cp(self)


def _select_out(acc: H.HandlerOut, new: H.HandlerOut, mask) -> H.HandlerOut:
    m1 = mask[:, None]
    return H.HandlerOut(
        egress_data=torch.where(m1, new.egress_data, acc.egress_data),
        egress_len=torch.where(mask, new.egress_len, acc.egress_len),
        egress_valid=torch.where(mask, new.egress_valid, acc.egress_valid),
        dma_off=torch.where(m1, new.dma_off, acc.dma_off),
        dma_val=torch.where(m1, new.dma_val, acc.dma_val),
        state_delta=torch.where(m1, new.state_delta, acc.state_delta),
        counter_queue=torch.where(mask, new.counter_queue,
                                  acc.counter_queue),
        counter_val=torch.where(mask, new.counter_val, acc.counter_val),
    )


class SpinNIC:
    """Host-side object holding installed execution contexts (fpspin_init).

    ``device`` (default ``"cuda"``) is where the state lives and the step
    runs; CUDA runs kernel K1, the CPU its plain version.  Contexts that
    upload tables (the DDT contexts) must be built for the same device.
    ``steps_run`` counts the calls of ``step`` (its spans' request); it is
    the object's only mutable field and changes nothing it computes.
    """

    def __init__(self, contexts: List[H.ExecutionContext],
                 host_bytes: int = 1 << 20, batch: int = 64,
                 mpq_entries: int = herlib.MPQ_ENTRIES, device="cuda"):
        if not contexts:
            raise ValueError("SpinNIC needs at least one execution context")
        # the expect table has a single flat slot space indexed from 0:
        # exactly one context may own it
        if sum(1 for c in contexts if c.n_expect > 0) > 1:
            raise ValueError(
                "only one execution context may use the expect table")
        self.device = resolve_device(device)
        self.contexts = contexts
        self.host_bytes = host_bytes
        self.batch = batch
        self.mpq_entries = mpq_entries
        self.tables = matching.MatchTables.build(
            [c.ruleset for c in contexts], device=self.device)
        self._msgful = torch.as_tensor(
            [c.message_mode for c in contexts], device=self.device)
        self._host_base = torch.as_tensor(
            [c.host_base for c in contexts], dtype=torch.int32,
            device=self.device)
        self.steps_run = 0

    # -------------------------------------------------------------- state
    def init_state(self) -> NICState:
        dev = self.device

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return NICState(
            l2=zeros((palloc.L2_PKT_BYTES,), torch.uint8),
            alloc=palloc.make_state(device=dev),
            mpq=herlib.make_mpq(self.mpq_entries, device=dev),
            msg_state=zeros((self.mpq_entries, H.MSG_STATE_DIM), torch.int32),
            host=zeros((self.host_bytes,), torch.uint8),
            counters=zeros((H.N_COUNTER_QUEUES, H.COUNTER_QUEUE_LEN),
                           torch.int32),
            counter_count=zeros((H.N_COUNTER_QUEUES,), torch.int32),
            cycles=zeros((), torch.int32),
            dropped=zeros((), torch.int32),
            expect=zeros((max(1, sum(c.n_expect for c in self.contexts)),),
                         torch.int64),
        )

    # --------------------------------------------------------------- step
    def step(self, state: NICState, batch: pkt.PacketBatch
             ) -> Tuple[NICState, pkt.PacketBatch, pkt.PacketBatch]:
        """Process one ingress batch.

        Returns (state, egress_batch, to_host_batch): egress = handler
        sends; to_host = non-matching frames forwarded to the standard NIC
        datapath (ARP passthrough & friends, paper §IV).

        The step consumes ``state``: its ``l2`` and ``host`` buffers are
        updated in place and reused by the returned state (the JAX package
        donates them).  Use ``state.clone()`` to keep the old state.

        Traced as ``spin_nic.step`` (request: the count of steps this
        object has run), a child span per stage.
        """
        self.steps_run += 1
        with trace.span("spin_nic.step", request=self.steps_run):
            return self._step(state, batch)

    def _step(self, state: NICState, batch: pkt.PacketBatch):
        n = batch.n
        dev = self.device
        byte_iota = torch.arange(pkt.MTU, dtype=torch.int32, device=dev)
        l2_size = state.l2.shape[0]

        # (1) matching engine (kernel K1)
        with trace.span("spin_nic.match"):
            ctx_id, eom = matching.match_batch(batch, self.tables)
            process = batch.valid & (ctx_id >= 0)
            to_host = pkt.PacketBatch(batch.data, batch.length,
                                      batch.valid & (ctx_id < 0))

        # (2) allocator
        with trace.span("spin_nic.alloc"):
            alloc_state, addr, ok = palloc.alloc(state.alloc, batch.length,
                                                 process)
            dropped = state.dropped + (process & ~ok).sum(dtype=torch.int32)
            live = process & ok

        # (3) ingress DMA into the L2 packet buffer: bytes [0, length) of
        # each live frame land at its slot address (a masked copy of one MTU
        # window per lane; live slots are disjoint and a frame fits its
        # slot, so no target repeats).  Slot geometry guarantees
        # addr + MTU <= L2_PKT_BYTES.
        with trace.span("spin_nic.l2_dma"):
            addr64 = addr.clamp(min=0).to(torch.int64)
            window = addr64[:, None] + byte_iota[None, :]       # (N, MTU)
            keep = live[:, None] & (byte_iota[None, :]
                                    < batch.length[:, None])
            l2 = scatter_set_(state.l2, torch.where(keep, window, l2_size),
                              batch.data)

        # (4) HER generation + scheduling (message-mode contexts only track
        #     MPQ state; packet-mode contexts always run packet handlers)
        with trace.span("spin_nic.her"):
            ctx0 = ctx_id.clamp(min=0).to(torch.int64)
            msgful = self._msgful[ctx0] & live
            msg_id = pkt.read_u32(batch.data, pkt.SLMP_MSGID)
            mpq, her = herlib.generate(state.mpq, ctx_id, addr, batch.length,
                                       msg_id, eom & msgful, msgful)
            run_header = her.run_header & msgful
            run_tail = her.run_tail & msgful

        # (5) handler execution: read the full MTU window back from L2
        with trace.span("spin_nic.handlers"):
            pkt_view = torch.where(live[:, None], l2[window], 0)
            slot64 = her.slot.to(torch.int64)

            msg_state = state.msg_state
            phase_outs = []
            for phase, phase_mask, name in (
                    ("header", run_header, "spin_nic.handlers.header"),
                    ("packet", live, "spin_nic.handlers.packet"),
                    ("tail", run_tail, "spin_nic.handlers.tail")):
                with trace.span(name):
                    args = H.HandlerArgs(
                        pkt=pkt_view, pkt_len=batch.length, msg_id=msg_id,
                        eom=eom, ctx=ctx_id, msg_state=msg_state[slot64],
                        cycles=state.cycles.expand(n), expect=state.expect)
                    acc = H.none_out(n, dev)
                    for c, ectx in enumerate(self.contexts):
                        fn = getattr(ectx, phase)
                        if fn is H.default_handler:
                            continue
                        mask = phase_mask & (ctx_id == c)
                        out = H.run_phase(fn, args, ectx.user, mask)
                        acc = _select_out(acc, out, mask)
                    # message state becomes visible to the next phase
                    msg_state = msg_state.index_add(
                        0, slot64, torch.where(phase_mask[:, None],
                                               acc.state_delta, 0))
                    phase_outs.append(acc)

        # (6a) host DMA: one byte-granular scatter over the three phases in
        # order, so a later phase, packet or byte wins a repeated offset.
        with trace.span("spin_nic.host_dma"):
            base = self._host_base[ctx0]
            off = torch.cat([torch.where(o.dma_off >= 0,
                                         base[:, None] + o.dma_off,
                                         self.host_bytes)  # OOB -> dropped
                             for o in phase_outs])
            host = scatter_set_(state.host, off,
                                torch.cat([o.dma_val for o in phase_outs]))

        # (6b) egress arbitration (axis_arb_mux): compact all sends
        with trace.span("spin_nic.egress"):
            eg_data = torch.cat([o.egress_data for o in phase_outs])
            eg_len = torch.cat([o.egress_len for o in phase_outs])
            eg_valid = torch.cat([o.egress_valid for o in phase_outs])
            order = torch.argsort((~eg_valid).to(torch.uint8),
                                  stable=True)[:n]
            egress = pkt.PacketBatch(eg_data[order], eg_len[order],
                                     eg_valid[order])

        # (6c) counter FIFOs
        with trace.span("spin_nic.counters"):
            counters, counter_count = state.counters, state.counter_count
            for out in phase_outs:
                counters = counters.clone()
                counter_count = counter_count.clone()
                for q in range(H.N_COUNTER_QUEUES):
                    sel = out.counter_queue == q
                    rank = torch.cumsum(sel.to(torch.int32), 0,
                                        dtype=torch.int32) - 1
                    pos = torch.where(sel, (counter_count[q] + rank)
                                      % H.COUNTER_QUEUE_LEN,
                                      H.COUNTER_QUEUE_LEN)
                    scatter_set_(counters[q], pos, out.counter_val)
                    counter_count[q] += sel.sum(dtype=torch.int32)

        # (6d) completion notification -> free packet-buffer slots
        with trace.span("spin_nic.free"):
            alloc_state = palloc.free(alloc_state, addr, live)

        new_state = NICState(
            l2=l2, alloc=alloc_state, mpq=mpq, msg_state=msg_state,
            host=host, counters=counters, counter_count=counter_count,
            cycles=state.cycles + 1, dropped=dropped, expect=state.expect)
        return new_state, egress, to_host

    # ------------------------------------------------------------- host API
    def write_expect(self, state: NICState, idx: int,
                     msg_id: int) -> NICState:
        """Host MMIO: arm (or disarm, msg_id=0) one slot of the expected
        msg_id table."""
        expect = state.expect.clone()
        expect[idx] = int(msg_id) & pkt.U32_MASK
        return dataclasses.replace(state, expect=expect)

    def read_host(self, state: NICState, base: int, nbytes: int
                  ) -> np.ndarray:
        """Host read of the DMA window (the /dev/pspin0 mmap view)."""
        trace.count("host_syncs")
        return state.host[base:base + nbytes].cpu().numpy()

    def pop_counters(self, state: NICState, queue: int
                     ) -> Tuple[np.ndarray, NICState]:
        """Drain a counter FIFO (host side).

        Returns ``(values, state)`` where the returned state has the queue
        count cleared: a second pop yields nothing until handlers push
        again.  The host reads the count, and when there are entries the
        values, and clears the count with a host value (``host_syncs``
        counts each of the three).
        """
        with trace.span("spin_nic.pop_counters"):
            trace.count("host_syncs")
            cnt = int(state.counter_count[queue])
            if cnt == 0:
                return np.zeros(0, np.int32), state
            trace.count("host_syncs")
            vals = state.counters[queue].cpu().numpy()
            start = max(0, cnt - H.COUNTER_QUEUE_LEN)  # older overwritten
            drained = np.array([vals[(start + i) % H.COUNTER_QUEUE_LEN]
                                for i in range(cnt - start)], np.int32)
            counter_count = state.counter_count.clone()
            trace.count("host_syncs")     # a host value copied in
            counter_count[queue] = 0
            return drained, dataclasses.replace(state,
                                                counter_count=counter_count)
