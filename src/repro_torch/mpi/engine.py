"""The per-rank MPI host engine — MPI's progress engine as a fabric node.

One :class:`MpiHostEngine` rides on each rank's
:class:`~repro_torch.net.node.Node` and implements the host half of the
messaging layer:

  * **tag matching** with MPI semantics: posted receives match in post
    order, arrivals match in arrival order, ``ANY_SOURCE`` / ``ANY_TAG``
    wildcards, and an unexpected-message queue for sends that beat their
    receive;
  * **eager protocol** (small messages): payload goes straight out over
    the SLMP sender state machine to the peer's NIC eager context, which
    reassembles it into a per-sender staging slot; a FIN control message
    (sent once every segment is ACKed, so the data is known to be in host
    memory) carries the envelope and triggers matching;
  * **rendezvous protocol** (registered datatypes at/above the eager
    threshold): RTS → match → CTS (carrying a receive slot *and a credit
    count*) → SLMP data to the NIC *DDT-unpack* context — the receive-side
    datatype processing runs entirely on the NIC, scattering payload bytes
    through the committed index map into the posted region — → FIN
    completes the receive with a masked copy-out (no host unpack on the
    critical path).

**Credit-managed rendezvous.** Receive slots are *credits*: the receiver
owns ``n_rdv_slots`` leases, debits one per CTS, and returns it the
moment the FIN lands — no time-based quarantine.  Safe reuse is
end-to-end, not clock-based: each grant hands out a *generation-tagged*
virtual slot and arms the NIC's expected-msg_id table
(:meth:`~repro_torch.net.node.Node.write_expect`) before the CTS leaves, so a
stale retransmit of a previous occupant — even one that sat queued in a
congested link arbitrarily long — is dropped on the device instead of
scribbling the recycled region.  Every CTS carries the receiver's
remaining credit, and the sender pipelines its queued rendezvous sends
per destination against that window (at least one RTS is always
outstanding as a probe, so a collapsed window reopens as soon as a grant
arrives).  K concurrent segmented collectives therefore share the slot
pool by grant order without deadlock and without flooding the control
wire with RTSs that cannot be granted: ``credit_stalls`` (receiver had a
matched RTS but no lease) and ``window_stalls`` (sender held an RTS
back) in :attr:`stats` show where the pipeline throttles.

All control traffic uses the reliable
:class:`~repro_torch.mpi.wire.CtlEndpoint`; all bulk data uses SLMP
retransmission — the whole layer survives loss, duplication and
reordering.

**Checkpointing.** Every continuation in the engine is a plain-data
record, never a closure: send-side transfers carry their protocol fields
in the in-flight entry and are finished by :meth:`_sender_done`; control
acks dispatch serializable tokens through :meth:`_on_tok_acked`; live
:class:`Request` handles are tracked by integer id in a registry.  That
makes :meth:`snapshot` / :meth:`restore` total — an engine checkpointed
mid-collective restores into a fresh object graph and continues
bit-identically (the fabric's :meth:`~repro_torch.net.fabric.Fabric.checkpoint`
path calls straight into these).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import packet as pkt
from repro_torch.core import slmp
from repro_torch.mpi import wire
from repro_torch.mpi.datatypes import DatatypeRegistry
from repro_torch.net.node import HostEngine

ANY_SOURCE = wire.ANY_SOURCE
ANY_TAG = wire.ANY_TAG
MAX_TAG = (1 << 30) - 1


@dataclasses.dataclass(frozen=True)
class MpiParams:
    """Resolved, rank-independent parameters (built by the Communicator)."""
    n_ranks: int
    macs: Tuple[bytes, ...]
    eager_threshold: int
    eager_slots_per_src: int
    eager_slot_bytes: int
    eager_base: int
    n_rdv_slots: int
    rdv_region_bytes: int
    rdv_base: int
    slot_quarantine: int          # ticks before a freed *eager* staging
    #                               slot is reusable (rdv slots recycle
    #                               instantly via the expect table)
    mtu_payload: int
    slmp_window: int
    slmp_timeout: int
    slmp_max_retries: int
    ctl_timeout: int
    ctl_max_retries: int


class Request:
    """Nonblocking operation handle (MPI_Request).

    ``test()`` probes completion without ticking the fabric; ``wait()``
    drives the owning communicator until done.  For receives,
    ``source``/``tag``/``nbytes`` report the matched envelope (MPI_Status)
    after completion.  ``rid`` is the engine-local id live requests are
    checkpointed under; ``ctoken`` names the collective-plan step this
    request belongs to (plain data — restored plans re-attach their
    callbacks by token).
    """

    def __init__(self, kind: str, buf: Optional[np.ndarray] = None,
                 source: int = ANY_SOURCE, tag: int = ANY_TAG):
        self.kind = kind                  # "send" | "recv" | "coll"
        self.buf = buf
        self.buf_id: Optional[int] = None  # BufferPool binding (checkpoint)
        self.source = source              # recv: match filter, then sender
        self.tag = tag
        self.done = False
        self.error: Optional[str] = None
        self.nbytes = 0
        self.rid = -1
        self.ctoken: Optional[tuple] = None  # (plan_id, step_key)
        self._comm = None                 # set by the Communicator
        self._cbs: List[Callable[["Request"], None]] = []

    def test(self) -> bool:
        """MPI_Test: completion probe — never blocks, never ticks."""
        return self.done

    def wait(self, max_ticks: int = 100_000) -> "Request":
        """MPI_Wait: tick the owning communicator until complete."""
        assert self._comm is not None, \
            "request has no communicator: use comm.wait(req)"
        self._comm.wait(self, max_ticks=max_ticks)
        return self

    def add_done_callback(self, cb: Callable[["Request"], None]) -> None:
        if self.done:
            cb(self)
        else:
            self._cbs.append(cb)

    def _complete(self, source: Optional[int] = None,
                  tag: Optional[int] = None, nbytes: int = 0,
                  error: Optional[str] = None) -> None:
        assert not self.done
        if source is not None:
            self.source = source
        if tag is not None:
            self.tag = tag
        self.nbytes = nbytes
        self.error = error
        self.done = True
        cbs, self._cbs = self._cbs, []
        for cb in cbs:
            cb(self)

    def __repr__(self):
        state = "done" if self.done else "pending"
        return (f"Request({self.kind}, {state}, src={self.source}, "
                f"tag={self.tag}, nbytes={self.nbytes})")


@dataclasses.dataclass
class _Envelope:
    """Unexpected-queue entry: an arrived eager message (payload already
    copied out of the staging slot) or a pending rendezvous RTS."""
    kind: str                 # "eager" | "rts"
    ctl: wire.Ctl
    payload: Optional[np.ndarray] = None


def _u8view(buf: np.ndarray) -> np.ndarray:
    assert buf.flags["C_CONTIGUOUS"], "MPI buffers must be C-contiguous"
    return buf.reshape(-1).view(np.uint8)


def _env_snap(e: _Envelope) -> tuple:
    return (e.kind, dataclasses.astuple(e.ctl),
            None if e.payload is None else e.payload.copy())


def _env_restore(t: tuple) -> _Envelope:
    kind, ctl, payload = t
    return _Envelope(kind, wire.Ctl(*ctl),
                     None if payload is None else payload.copy())


class MpiHostEngine(HostEngine):
    def __init__(self, rank: int, registry: DatatypeRegistry,
                 params: MpiParams, pool=None):
        self.rank = rank
        self.registry = registry
        self.p = params
        self.pool = pool                        # BufferPool (checkpointing)
        self._node = None                       # set by attach()
        self.ctl = wire.CtlEndpoint(rank, list(params.macs),
                                    timeout=params.ctl_timeout,
                                    max_retries=params.ctl_max_retries)
        self.ctl.deliver = self._on_ctl
        self.ctl.on_acked = self._on_tok_acked
        self.ctl.on_give_up = self._on_ctl_give_up
        self._now = 0
        # ---- request registry (live, incomplete requests by id)
        self._reqs: Dict[int, Request] = {}
        self._next_rid = 0
        # ---- send side.  Entries are plain-data dicts carrying every
        # field their continuation needs (no closures anywhere).
        self._eager_seq: Dict[int, int] = {}
        self._msg_seq: Dict[int, int] = {}
        self._mseq_tx: Dict[int, int] = {}      # matching seq per dest
        self._eager_queue: Dict[int, Deque[dict]] = {}
        self._eager_inflight: Dict[int, Dict[int, dict]] = {}
        # (dest, slot) -> tick before which the staging slot must not be
        # reused: a duplicated/reorder-delayed data frame of the previous
        # message (same msg_id — the NIC addresses purely by slot) could
        # still be in flight right after its FIN is acked
        self._eager_cooldown: Dict[Tuple[int, int], int] = {}
        self._rdv_sends: Dict[Tuple[int, int], dict] = {}
        # credit-window RTS pipeline: queued rendezvous sends per dest,
        # the per-dest window learned from CTS credits, and the number of
        # transfers between RTS and FIN-ack per dest
        self._rdv_queue: Dict[int, Deque[dict]] = {}
        self._rdv_window: Dict[int, int] = {}
        self._rdv_outstanding: Dict[int, int] = {}
        self._active: List[dict] = []           # live SLMP data senders
        # ---- receive side
        self._posted: List[Request] = []
        self._unexpected: Deque[_Envelope] = deque()
        # MPI non-overtaking: envelopes from one sender enter tag matching
        # in *send* order (mseq), even though an RTS datagram can beat an
        # earlier eager message's FIN onto the wire
        self._mseq_rx: Dict[int, int] = {}
        self._mseq_pending: Dict[int, Dict[int, _Envelope]] = {}
        self._rdv_recv: Dict[int, Tuple[int, wire.Ctl]] = {}   # vslot -> rid
        self._free_slots: List[int] = list(range(params.n_rdv_slots))
        # per-physical-slot generation: the CTS hands out the *virtual*
        # slot gen·n_slots+phys, the NIC is armed with the full expected
        # msg_id, and stale frames of earlier generations are dropped on
        # the device — so a FIN'd slot recycles immediately (no time-based
        # quarantine on the rendezvous path)
        self._slot_gen: List[int] = [0] * params.n_rdv_slots
        self._cts_waiting: Deque[Tuple[int, wire.Ctl]] = deque()  # (rid, rts)
        # ---- accounting
        self.stats = dict(eager_sent=0, rdv_sent=0, bytes_sent=0,
                          bytes_recv=0, unexpected=0, retransmits=0,
                          credit_stalls=0, window_stalls=0)
        self.errors: List[str] = []

    def attach(self, node) -> None:
        """Bind to the Node whose NIC host window we read (the mmap view)."""
        self._node = node

    # ----------------------------------------------------- request registry
    def _new_request(self, kind: str, **kw) -> Request:
        req = Request(kind, **kw)
        req.rid = self._next_rid
        self._next_rid += 1
        self._reqs[req.rid] = req
        return req

    def _complete_req(self, req: Request, **kw) -> None:
        self._reqs.pop(req.rid, None)
        req._complete(**kw)

    def _complete_rid(self, rid: int, **kw) -> None:
        req = self._reqs.pop(rid, None)
        if req is not None:
            req._complete(**kw)

    # ------------------------------------------------------------- public
    def isend(self, dest: int, data: np.ndarray, tag: int = 0,
              datatype=None) -> Request:
        assert 0 <= dest < self.p.n_ranks, f"bad destination {dest}"
        assert 0 <= tag <= MAX_TAG, f"bad tag {tag}"
        data = np.ascontiguousarray(data)
        if datatype is not None:
            dtype_id = self.registry.resolve(datatype)
            payload = self.registry.pack(dtype_id, data)
        else:
            dtype_id = wire.NO_DTYPE
            payload = _u8view(data).copy()
        req = self._new_request("send", source=self.rank, tag=tag)
        req.nbytes = payload.size
        self.stats["bytes_sent"] += payload.size
        if dest == self.rank:
            env = _Envelope("eager", wire.Ctl(
                wire.FIN_EAGER, src=self.rank, tag=tag, seq=0,
                nbytes=payload.size, dtype_id=dtype_id), payload)
            self._route_envelope(env)
            self._complete_req(req, nbytes=payload.size)
            return req
        mseq = self._mseq_tx.get(dest, 0)
        self._mseq_tx[dest] = mseq + 1
        use_rdv = (dtype_id != wire.NO_DTYPE
                   and payload.size >= self.p.eager_threshold)
        if use_rdv:
            self._rdv_queue.setdefault(dest, deque()).append(dict(
                rid=req.rid, dest=dest, payload=payload,
                dtype_id=dtype_id, tag=tag, mseq=mseq))
            self._pump_rdv(dest)
        else:
            assert payload.size <= self.p.eager_slot_bytes, (
                f"eager message of {payload.size}B exceeds the "
                f"{self.p.eager_slot_bytes}B staging slot — register the "
                f"datatype for rendezvous or raise eager_slot_bytes")
            seq = self._eager_seq.get(dest, 0)
            self._eager_seq[dest] = seq + 1
            self._eager_queue.setdefault(dest, deque()).append(dict(
                rid=req.rid, dest=dest, seq=seq, payload=payload,
                dtype_id=dtype_id, tag=tag, mseq=mseq))
        return req

    def irecv(self, buf: np.ndarray, source: int = ANY_SOURCE,
              tag: int = ANY_TAG, buf_id: Optional[int] = None) -> Request:
        assert source == ANY_SOURCE or 0 <= source < self.p.n_ranks
        req = self._new_request("recv", buf=buf, source=source, tag=tag)
        req.buf_id = buf_id
        env = self._match_unexpected(source, tag)
        if env is None:
            self._posted.append(req)
        elif env.kind == "eager":
            self._deliver_eager(req, env.ctl, env.payload)
        else:
            self._grant_rdv(req, env.ctl)
        return req

    @property
    def done(self) -> bool:
        return not (any(self._eager_queue.values())
                    or any(self._eager_inflight.values())
                    or any(self._rdv_queue.values())
                    or self._rdv_sends or self._active
                    or self._cts_waiting or not self.ctl.idle)

    @property
    def failed(self) -> bool:
        return bool(self.errors)

    # -------------------------------------------------------- fabric hooks
    def poll(self, now: int) -> List[np.ndarray]:
        self._now = now
        out: List[np.ndarray] = []
        # start eligible queued eager sends (per-destination slot gating:
        # seq's staging slot must be free, i.e. seq - slots_per_src FINed)
        for dest, queue in self._eager_queue.items():
            inflight = self._eager_inflight.setdefault(dest, {})
            while queue:
                ent = queue[0]
                slot_key = (dest, ent["seq"] % self.p.eager_slots_per_src)
                if (len(inflight) >= self.p.eager_slots_per_src
                        or ent["seq"] - self.p.eager_slots_per_src
                        in inflight
                        or now < self._eager_cooldown.get(slot_key, 0)):
                    break
                queue.popleft()
                inflight[ent["seq"]] = ent
                self._launch_eager(ent)
        # rendezvous grants waiting for a receive slot
        while self._cts_waiting and self._slot_available():
            rid, ctl = self._cts_waiting.popleft()
            req = self._reqs.get(rid)
            if req is not None:
                self._grant_rdv(req, ctl)
        # drive the SLMP data senders
        for ent in list(self._active):
            sender: slmp.SlmpSender = ent["sender"]
            out.extend(sender.poll(now))
            if sender.failed:
                self._active.remove(ent)
                msg = (f"rank{self.rank}: SLMP data to rank {ent['dest']} "
                       f"exhausted retries (msg_id={ent['msg_id']:#x})")
                self.errors.append(msg)
                self._complete_rid(ent["rid"], error=msg)
            elif sender.done:
                self._active.remove(ent)
                self.stats["retransmits"] += sender.retransmits
                self._sender_done(ent)
        out.extend(self.ctl.poll(now))
        return out

    def on_host_frames(self, frames: List[np.ndarray], now: int) -> None:
        self._now = now
        for f in frames:
            if len(f) < pkt.SLMP_BASE:
                continue
            if wire.frame_dport(f) == wire.CTRL_PORT:
                self.ctl.on_frame(f, now)
                continue
            ack = wire.parse_slmp_ack(f)
            if ack is None:
                continue
            msg_id, off, peer_mac = ack
            for ent in self._active:
                if (ent["msg_id"] == msg_id
                        and self.p.macs[ent["dest"]] == peer_mac):
                    ent["sender"].on_ack(msg_id, off)
                    break

    # ---------------------------------------------------------- send paths
    def _slmp_cfg(self, dest: int, port: int) -> slmp.SlmpSenderConfig:
        return slmp.SlmpSenderConfig(
            window=self.p.slmp_window, mtu_payload=self.p.mtu_payload,
            timeout=self.p.slmp_timeout,
            max_retries=self.p.slmp_max_retries, port=port,
            src_mac=self.p.macs[self.rank], dst_mac=self.p.macs[dest])

    def _launch_eager(self, ent: dict) -> None:
        dest, seq = ent["dest"], ent["seq"]
        slot = self.rank * self.p.eager_slots_per_src \
            + seq % self.p.eager_slots_per_src
        msg_id = wire.pack_msg_id(wire.MPI_KIND_EAGER, 0, slot)
        sender = slmp.SlmpSender(ent["payload"], msg_id,
                                 self._slmp_cfg(dest, wire.EAGER_PORT))
        self.stats["eager_sent"] += 1
        self._active.append(dict(ent, kind="eager", slot=slot,
                                 msg_id=msg_id, sender=sender))

    def _pump_rdv(self, dest: int) -> None:
        """Launch queued rendezvous sends up to the destination's credit
        window (RTS pipelining: always at least one outstanding probe)."""
        queue = self._rdv_queue.get(dest)
        if not queue:
            return
        window = max(1, self._rdv_window.get(dest, 1))
        while queue and self._rdv_outstanding.get(dest, 0) < window:
            ent = queue.popleft()
            seq = self._msg_seq.get(dest, 0)
            self._msg_seq[dest] = seq + 1
            ent["seq"] = seq
            self._rdv_sends[(dest, seq)] = ent
            self._rdv_outstanding[dest] = \
                self._rdv_outstanding.get(dest, 0) + 1
            self.stats["rdv_sent"] += 1
            self.ctl.send(dest, wire.Ctl(
                wire.RTS, src=self.rank, tag=ent["tag"], seq=seq,
                nbytes=ent["payload"].size, dtype_id=ent["dtype_id"],
                mseq=ent["mseq"]))
        if queue:
            self.stats["window_stalls"] += 1

    def _on_cts(self, ctl: wire.Ctl) -> None:
        # the grant carries the receiver's remaining credit: resize the
        # RTS pipeline window toward it (the granted transfer itself is
        # still outstanding, hence the +1)
        self._rdv_window[ctl.src] = max(1, ctl.credit + 1)
        ent = self._rdv_sends.pop((ctl.src, ctl.seq), None)
        if ent is None:
            return                              # stale duplicate
        msg_id = wire.pack_msg_id(wire.MPI_KIND_RDV, ent["dtype_id"],
                                  ctl.slot)
        sender = slmp.SlmpSender(ent["payload"], msg_id,
                                 self._slmp_cfg(ent["dest"], wire.DATA_PORT))
        self._active.append(dict(ent, kind="rdv", slot=ctl.slot, mseq=0,
                                 msg_id=msg_id, sender=sender))
        self._pump_rdv(ctl.src)

    def _sender_done(self, ent: dict) -> None:
        """An SLMP data transfer fully ACKed: send the FIN whose ack token
        completes the request (eager additionally frees its staging slot)."""
        nbytes = int(ent["payload"].size)
        if ent["kind"] == "eager":
            fin = wire.Ctl(wire.FIN_EAGER, src=self.rank, tag=ent["tag"],
                           seq=ent["seq"], nbytes=nbytes,
                           dtype_id=ent["dtype_id"], slot=ent["slot"],
                           mseq=ent["mseq"])
            token = ("eafin", ent["dest"], ent["seq"], ent["rid"], nbytes)
        else:
            fin = wire.Ctl(wire.FIN_RDV, src=self.rank, tag=ent["tag"],
                           seq=ent["seq"], nbytes=nbytes,
                           dtype_id=ent["dtype_id"], slot=ent["slot"])
            token = ("rdvfin", ent["rid"], nbytes, ent["dest"])
        self.ctl.send(ent["dest"], fin, token=token)

    def _on_tok_acked(self, tok: tuple) -> None:
        """Dispatch a control-ack continuation token (plain data)."""
        if tok[0] == "eafin":
            _, dest, seq, rid, nbytes = tok
            self._eager_inflight.get(dest, {}).pop(seq, None)
            self._eager_cooldown[(dest, seq % self.p.eager_slots_per_src)] \
                = self._now + self.p.slot_quarantine
            self._complete_rid(rid, nbytes=nbytes)
        elif tok[0] == "rdvfin":
            _, rid, nbytes, dest = tok
            self._rdv_outstanding[dest] = \
                max(0, self._rdv_outstanding.get(dest, 0) - 1)
            self._complete_rid(rid, nbytes=nbytes)
            self._pump_rdv(dest)

    # ------------------------------------------------------- receive paths
    def _on_ctl_give_up(self, dst: int, body: wire.Ctl) -> None:
        self.errors.append(
            f"rank{self.rank}: control message kind={body.kind} to rank "
            f"{dst} (tag={body.tag}, seq={body.seq}) exhausted "
            f"{self.p.ctl_max_retries} retries")

    def _on_ctl(self, ctl: wire.Ctl, now: int) -> None:
        self._now = now
        if ctl.kind == wire.CTS:
            self._on_cts(ctl)
        elif ctl.kind == wire.RTS:
            self._enqueue_matching(_Envelope("rts", ctl))
        elif ctl.kind == wire.FIN_EAGER:
            slot = ctl.src * self.p.eager_slots_per_src \
                + ctl.seq % self.p.eager_slots_per_src
            base = self.p.eager_base + slot * self.p.eager_slot_bytes
            payload = np.array(self._node.read_host(base, ctl.nbytes),
                               np.uint8)
            self._enqueue_matching(_Envelope("eager", ctl, payload))
        elif ctl.kind == wire.FIN_RDV:
            self._finish_rdv_recv(ctl)

    def _enqueue_matching(self, env: _Envelope) -> None:
        """Admit wire envelopes to tag matching in per-sender send order
        (mseq) — MPI's non-overtaking guarantee.  An envelope whose
        predecessors have not arrived waits here."""
        src = env.ctl.src
        pending = self._mseq_pending.setdefault(src, {})
        pending[env.ctl.mseq] = env
        expected = self._mseq_rx.get(src, 0)
        while expected in pending:
            self._route_envelope(pending.pop(expected))
            expected += 1
        self._mseq_rx[src] = expected

    def _route_envelope(self, env: _Envelope) -> None:
        req = self._match_posted(env.ctl.src, env.ctl.tag)
        if req is None:
            self.stats["unexpected"] += 1
            self._unexpected.append(env)
        elif env.kind == "eager":
            self._deliver_eager(req, env.ctl, env.payload)
        else:
            self._grant_rdv(req, env.ctl)

    def _match_posted(self, src: int, tag: int) -> Optional[Request]:
        for i, req in enumerate(self._posted):
            if ((req.source in (ANY_SOURCE, src))
                    and (req.tag in (ANY_TAG, tag))):
                return self._posted.pop(i)
        return None

    def _match_unexpected(self, source: int, tag: int
                          ) -> Optional[_Envelope]:
        for i, env in enumerate(self._unexpected):
            if ((source in (ANY_SOURCE, env.ctl.src))
                    and (tag in (ANY_TAG, env.ctl.tag))):
                del self._unexpected[i]
                return env
        return None

    def _deliver_eager(self, req: Request, ctl: wire.Ctl,
                       payload: np.ndarray) -> None:
        view = _u8view(req.buf)
        if ctl.dtype_id != wire.NO_DTYPE:
            self.registry.unpack_into(ctl.dtype_id, payload, req.buf)
        else:
            assert view.size >= ctl.nbytes, (
                f"recv buffer {view.size}B < message {ctl.nbytes}B")
            view[:ctl.nbytes] = payload[:ctl.nbytes]
        self.stats["bytes_recv"] += ctl.nbytes
        self._complete_req(req, source=ctl.src, tag=ctl.tag,
                           nbytes=ctl.nbytes)

    # --- rendezvous receive (credit-managed, generation-armed slots)
    def _slot_available(self) -> bool:
        return bool(self._free_slots)

    def _grant_rdv(self, req: Request, ctl: wire.Ctl) -> None:
        if not self._slot_available():
            # no lease: the grant queues until a slot FINs
            self.stats["credit_stalls"] += 1
            self._cts_waiting.append((req.rid, ctl))
            return
        phys = self._free_slots.pop()
        mem_bytes = self.registry.mem_bytes(ctl.dtype_id)
        assert mem_bytes <= self.p.rdv_region_bytes
        assert _u8view(req.buf).size >= mem_bytes, (
            f"recv buffer {req.buf.size}B < datatype extent {mem_bytes}B")
        # virtual slot = generation · n_slots + phys (16-bit wire field);
        # arm the NIC with the exact msg_id before the sender learns the
        # slot — frames of any other occupant are dropped on the device
        gens = max(1, (1 << 16) // self.p.n_rdv_slots)
        vslot = (self._slot_gen[phys] % gens) * self.p.n_rdv_slots + phys
        self._node.write_expect(
            phys, wire.pack_msg_id(wire.MPI_KIND_RDV, ctl.dtype_id, vslot))
        self._rdv_recv[vslot] = (req.rid, ctl)
        self.ctl.send(ctl.src, wire.Ctl(
            wire.CTS, src=self.rank, tag=ctl.tag, seq=ctl.seq,
            nbytes=ctl.nbytes, dtype_id=ctl.dtype_id, slot=vslot,
            credit=len(self._free_slots)))

    def _finish_rdv_recv(self, fin: wire.Ctl) -> None:
        entry = self._rdv_recv.pop(fin.slot, None)
        if entry is None:
            return                              # duplicate FIN
        rid, rts = entry
        req = self._reqs.get(rid)
        phys = fin.slot % self.p.n_rdv_slots
        if req is not None:
            base = self.p.rdv_base + phys * self.p.rdv_region_bytes
            mem_bytes = self.registry.mem_bytes(rts.dtype_id)
            window = np.array(self._node.read_host(base, mem_bytes),
                              np.uint8)
            mask = self.registry.mem_mask(rts.dtype_id)
            view = _u8view(req.buf)
            # the NIC already unpacked: copy only the bytes the datatype
            # wrote (holes keep the buffer's contents — MPI unpack)
            view[:mem_bytes][mask] = window[mask]
        # disarm and recycle the slot immediately: late duplicates of this
        # (or any earlier) occupant no longer match the expect table
        self._node.write_expect(phys, 0)
        self._slot_gen[phys] += 1
        self._free_slots.append(phys)
        self.stats["bytes_recv"] += fin.nbytes
        if req is not None:
            self._complete_req(req, source=rts.src, tag=rts.tag,
                               nbytes=fin.nbytes)

    # ----------------------------------------------------------- checkpoint
    def _snap_ent(self, ent: dict) -> dict:
        """Plain copy of a send-side entry (without any live sender)."""
        out = {k: v for k, v in ent.items() if k != "sender"}
        out["payload"] = ent["payload"].copy()
        return out

    def _snap_request(self, req: Request) -> dict:
        if req.buf is None:
            buf = None
        elif req.buf_id is not None and self.pool is not None \
                and self.pool.has(req.buf_id):
            buf = ("pool", req.buf_id)
        else:
            # aliasing into user arrays cannot survive a fresh object
            # graph: the restored request owns a copy (read results off
            # the request / the restored plan, not the original array)
            buf = ("copy", np.array(req.buf))
        return dict(rid=req.rid, kind=req.kind, source=req.source,
                    tag=req.tag, nbytes=req.nbytes, ctoken=req.ctoken,
                    buf=buf)

    def _restore_request(self, s: dict) -> Request:
        buf = None
        buf_id = None
        if s["buf"] is not None:
            how, val = s["buf"]
            if how == "pool":
                assert self.pool is not None, \
                    "pool-bound request needs a BufferPool to restore into"
                buf, buf_id = self.pool.get(val), val
            else:
                buf = np.array(val)
        req = Request(s["kind"], buf=buf, source=s["source"], tag=s["tag"])
        req.nbytes = s["nbytes"]
        req.rid = s["rid"]
        req.buf_id = buf_id
        req.ctoken = None if s["ctoken"] is None else \
            (s["ctoken"][0], tuple(s["ctoken"][1]))
        return req

    def snapshot(self) -> dict:
        ctl_t = dataclasses.astuple
        return dict(
            now=self._now,
            next_rid=self._next_rid,
            requests=[self._snap_request(r) for r in self._reqs.values()],
            eager_seq=list(self._eager_seq.items()),
            msg_seq=list(self._msg_seq.items()),
            mseq_tx=list(self._mseq_tx.items()),
            eager_queue=[(d, [self._snap_ent(e) for e in q])
                         for d, q in self._eager_queue.items()],
            eager_inflight=[(d, [(s, self._snap_ent(e))
                                 for s, e in m.items()])
                            for d, m in self._eager_inflight.items()],
            eager_cooldown=list(self._eager_cooldown.items()),
            rdv_sends=[(k, self._snap_ent(e))
                       for k, e in self._rdv_sends.items()],
            rdv_queue=[(d, [self._snap_ent(e) for e in q])
                       for d, q in self._rdv_queue.items()],
            rdv_window=list(self._rdv_window.items()),
            rdv_outstanding=list(self._rdv_outstanding.items()),
            active=[dict(self._snap_ent(e),
                         sender=e["sender"].snapshot())
                    for e in self._active],
            posted=[r.rid for r in self._posted],
            unexpected=[_env_snap(e) for e in self._unexpected],
            mseq_rx=list(self._mseq_rx.items()),
            mseq_pending=[(s, [(m, _env_snap(e)) for m, e in p.items()])
                          for s, p in self._mseq_pending.items()],
            rdv_recv=[(slot, rid, ctl_t(c))
                      for slot, (rid, c) in self._rdv_recv.items()],
            free_slots=list(self._free_slots),
            slot_gen=list(self._slot_gen),
            cts_waiting=[(rid, ctl_t(c)) for rid, c in self._cts_waiting],
            stats=dict(self.stats),
            errors=list(self.errors),
            ctl=self.ctl.snapshot(),
        )

    def restore(self, snap: dict) -> None:
        self._now = snap["now"]
        self._next_rid = snap["next_rid"]
        self._reqs = {}
        for rs in snap["requests"]:
            req = self._restore_request(rs)
            self._reqs[req.rid] = req
        self._eager_seq = dict(snap["eager_seq"])
        self._msg_seq = dict(snap["msg_seq"])
        self._mseq_tx = dict(snap["mseq_tx"])
        self._eager_queue = {
            d: deque(self._snap_ent(e) for e in q)
            for d, q in snap["eager_queue"]}
        self._eager_inflight = {
            d: {s: self._snap_ent(e) for s, e in m}
            for d, m in snap["eager_inflight"]}
        self._eager_cooldown = dict(snap["eager_cooldown"])
        self._rdv_sends = {tuple(k): self._snap_ent(e)
                           for k, e in snap["rdv_sends"]}
        self._rdv_queue = {d: deque(self._snap_ent(e) for e in q)
                           for d, q in snap["rdv_queue"]}
        self._rdv_window = dict(snap["rdv_window"])
        self._rdv_outstanding = dict(snap["rdv_outstanding"])
        self._active = []
        for es in snap["active"]:
            ent = {k: v for k, v in es.items() if k != "sender"}
            ent["payload"] = es["payload"].copy()
            port = wire.EAGER_PORT if ent["kind"] == "eager" \
                else wire.DATA_PORT
            sender = slmp.SlmpSender(ent["payload"], ent["msg_id"],
                                     self._slmp_cfg(ent["dest"], port))
            sender.restore(es["sender"])
            ent["sender"] = sender
            self._active.append(ent)
        self._posted = [self._reqs[rid] for rid in snap["posted"]]
        self._unexpected = deque(_env_restore(t) for t in snap["unexpected"])
        self._mseq_rx = dict(snap["mseq_rx"])
        self._mseq_pending = {
            s: {m: _env_restore(t) for m, t in p}
            for s, p in snap["mseq_pending"]}
        self._rdv_recv = {slot: (rid, wire.Ctl(*c))
                          for slot, rid, c in snap["rdv_recv"]}
        self._free_slots = list(snap["free_slots"])
        self._slot_gen = list(snap["slot_gen"])
        self._cts_waiting = deque((rid, wire.Ctl(*c))
                                  for rid, c in snap["cts_waiting"])
        self.stats = dict(snap["stats"])
        self.errors = list(snap["errors"])
        self.ctl.restore(snap["ctl"])
