"""Wire formats of the MPI messaging layer.

Three UDP ports per rank, all carried over the fabric:

  * ``EAGER_PORT`` — SLMP data, matched by the NIC eager context
    (:func:`repro_torch.core.apps.make_mpi_eager_context`): small messages,
    reassembled into per-sender staging slots of the host window.
  * ``DATA_PORT`` — SLMP data, matched by the NIC DDT-unpack context:
    rendezvous payloads, scattered through the committed datatype map
    straight into the posted receive region (the §V-C offload).
  * ``CTRL_PORT`` — plain UDP control datagrams (RTS / CTS / FIN).  These
    match no execution context, so they take the Corundum/host datapath
    and are consumed by the host engine — exactly where MPI's matching
    logic lives on a real FPsPIN host.

The wire is lossy, so control datagrams get their own reliability:
:class:`CtlEndpoint` is a tiny ack/retransmit/dedup layer (per-peer
sequence numbers, at-most-once delivery to the engine).  SLMP data needs
none of this — the SLMP sender state machine already retransmits.

msg_id packing for SLMP data messages re-exports the NIC-side constants
from :mod:`repro_torch.core.apps` — host library and NIC handlers must agree.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core import packet as pkt
from repro_torch.core.apps import (MPI_KIND_EAGER, MPI_KIND_RDV,
                                   MPI_MSGID_DTYPE_MASK,
                                   MPI_MSGID_DTYPE_SHIFT,
                                   MPI_MSGID_KIND_SHIFT, MPI_MSGID_SLOT_MASK)

EAGER_PORT = 9340
DATA_PORT = 9341
CTRL_PORT = 9350

ANY_SOURCE = -1
ANY_TAG = -1

NO_DTYPE = 0xFFFF            # dtype_id wire value for raw-byte messages

# control transport kinds
CTL_MSG = 1
CTL_ACK = 2
CTL_HDR_BYTES = 7            # kind u8 | src u16 | ctl_seq u32

# control message (body) kinds
RTS = 1                      # rendezvous request-to-send
CTS = 2                      # rendezvous clear-to-send (carries the slot)
FIN_EAGER = 3                # eager message fully ACKed: envelope delivery
FIN_RDV = 4                  # rendezvous payload fully ACKed
BODY_BYTES = 25              # kind u8 | src u16 | tag u32 | seq u32 |
#                              nbytes u32 | dtype u16 | slot u16 | mseq u32 |
#                              credit u16


def pack_msg_id(kind: int, dtype_id: int, slot: int) -> int:
    """SLMP msg_id encoding read back by the NIC handlers (28-bit)."""
    assert 0 <= slot <= MPI_MSGID_SLOT_MASK
    assert 0 <= dtype_id <= MPI_MSGID_DTYPE_MASK
    return (kind << MPI_MSGID_KIND_SHIFT) | (dtype_id << MPI_MSGID_DTYPE_SHIFT) \
        | slot


def unpack_msg_id(msg_id: int) -> Tuple[int, int, int]:
    return ((msg_id >> MPI_MSGID_KIND_SHIFT) & 0xF,
            (msg_id >> MPI_MSGID_DTYPE_SHIFT) & MPI_MSGID_DTYPE_MASK,
            msg_id & MPI_MSGID_SLOT_MASK)


# --------------------------------------------------------------- envelopes
@dataclasses.dataclass(frozen=True)
class Ctl:
    """One MPI control message (the body of a reliable control datagram)."""
    kind: int                # RTS | CTS | FIN_EAGER | FIN_RDV
    src: int                 # rank of the *message* originator
    tag: int
    seq: int                 # per-protocol sequence (eager slot / CTS key)
    nbytes: int              # serialized payload size
    dtype_id: int = NO_DTYPE
    slot: int = 0
    mseq: int = 0            # per (src, dst) *matching* sequence: RTS and
    #                          FIN_EAGER must enter tag matching in send
    #                          order (MPI non-overtaking), regardless of
    #                          which control datagram lands first
    credit: int = 0          # CTS: receiver's remaining free rendezvous
    #                          slot leases after this grant — the sender
    #                          sizes its per-destination RTS pipeline
    #                          window from it (end-to-end flow control)


def encode_body(c: Ctl) -> np.ndarray:
    b = np.zeros(BODY_BYTES, np.uint8)
    b[0] = c.kind
    b[1:3] = divmod(c.src, 256)[0], c.src & 0xFF
    b[3:7] = np.frombuffer(int(c.tag).to_bytes(4, "big"), np.uint8)
    b[7:11] = np.frombuffer(int(c.seq).to_bytes(4, "big"), np.uint8)
    b[11:15] = np.frombuffer(int(c.nbytes).to_bytes(4, "big"), np.uint8)
    b[15:17] = divmod(c.dtype_id, 256)[0], c.dtype_id & 0xFF
    b[17:19] = divmod(c.slot, 256)[0], c.slot & 0xFF
    b[19:23] = np.frombuffer(int(c.mseq).to_bytes(4, "big"), np.uint8)
    b[23:25] = divmod(c.credit, 256)[0], c.credit & 0xFF
    return b


def decode_body(b: np.ndarray) -> Ctl:
    def u16(o):
        return (int(b[o]) << 8) | int(b[o + 1])

    def u32(o):
        return int.from_bytes(bytes(b[o:o + 4]), "big")

    return Ctl(kind=int(b[0]), src=u16(1), tag=u32(3), seq=u32(7),
               nbytes=u32(11), dtype_id=u16(15), slot=u16(17),
               mseq=u32(19), credit=u16(23))


def _u16(frame: np.ndarray, off: int) -> int:
    return (int(frame[off]) << 8) | int(frame[off + 1])


def frame_dport(frame: np.ndarray) -> int:
    return _u16(frame, pkt.UDP_DPORT)


def parse_slmp_ack(frame: np.ndarray
                   ) -> Optional[Tuple[int, int, bytes]]:
    """If ``frame`` is an SLMP ACK, return (msg_id, offset, peer_mac) —
    peer_mac (the frame's ETH_SRC) disambiguates senders that reuse a
    msg_id toward different destinations."""
    if len(frame) < pkt.SLMP_PAYLOAD:
        return None
    flags = _u16(frame, pkt.SLMP_FLAGS)
    if not flags & pkt.SLMP_FLAG_ACK:
        return None
    msg_id = int.from_bytes(bytes(frame[pkt.SLMP_MSGID:pkt.SLMP_MSGID + 4]),
                            "big")
    off = int.from_bytes(bytes(frame[pkt.SLMP_OFFSET:pkt.SLMP_OFFSET + 4]),
                         "big")
    return msg_id, off, bytes(frame[pkt.ETH_SRC:pkt.ETH_SRC + 6])


# ------------------------------------------------------- reliable control
class CtlEndpoint:
    """Reliable, deduplicated control datagrams over the lossy wire.

    Every outgoing :class:`Ctl` gets a per-destination ``ctl_seq`` and is
    retransmitted until the peer's CTL_ACK arrives; incoming datagrams are
    ACKed always and delivered to ``self.deliver`` at most once.  This is
    the host-side analogue of SLMP's per-segment reliability, sized for
    single-frame control traffic.

    Ack continuations are *tokens* (plain tuples dispatched through
    ``self.on_acked``), not closures, so the whole endpoint — including
    in-flight messages and their continuations — round-trips through
    :meth:`snapshot` / :meth:`restore` for fabric checkpointing.
    """

    def __init__(self, rank: int, macs: List[bytes], timeout: int = 12,
                 max_retries: int = 400):
        self.rank = rank
        self.macs = macs
        self.timeout = timeout
        self.max_retries = max_retries
        self.deliver: Optional[Callable[[Ctl, int], None]] = None
        # dispatcher for ack tokens (set by the owning engine)
        self.on_acked: Optional[Callable[[tuple], None]] = None
        # called when a message exhausts its retries — the owner must
        # surface this as a hard failure (a silently dropped RTS/CTS/FIN
        # would otherwise hang its request until a generic timeout)
        self.on_give_up: Optional[Callable[[int, Ctl], None]] = None
        self._next_seq: Dict[int, int] = {}
        # (dst, ctl_seq) -> [frame, last_sent, retries, token, body]
        self._unacked: Dict[Tuple[int, int], list] = {}
        self._seen: Dict[int, Set[int]] = {}
        self._ack_outbox: List[np.ndarray] = []
        self.give_ups = 0

    @property
    def idle(self) -> bool:
        return not self._unacked and not self._ack_outbox

    def send(self, dst: int, body: Ctl,
             token: Optional[tuple] = None) -> None:
        seq = self._next_seq.get(dst, 0)
        self._next_seq[dst] = seq + 1
        hdr = np.zeros(CTL_HDR_BYTES, np.uint8)
        hdr[0] = CTL_MSG
        hdr[1:3] = (self.rank >> 8) & 0xFF, self.rank & 0xFF
        hdr[3:7] = np.frombuffer(int(seq).to_bytes(4, "big"), np.uint8)
        frame = pkt.make_udp(np.concatenate([hdr, encode_body(body)]),
                             sport=CTRL_PORT, dport=CTRL_PORT,
                             src_mac=self.macs[self.rank],
                             dst_mac=self.macs[dst])
        self._unacked[(dst, seq)] = [frame, None, 0, token, body]

    def poll(self, now: int) -> List[np.ndarray]:
        out = self._ack_outbox
        self._ack_outbox = []
        for key, ent in list(self._unacked.items()):
            frame, last_sent, retries, _, body = ent
            if last_sent is not None and now - last_sent < self.timeout:
                continue
            if last_sent is not None:
                if retries >= self.max_retries:
                    del self._unacked[key]
                    self.give_ups += 1
                    if self.on_give_up is not None:
                        self.on_give_up(key[0], body)
                    continue
                ent[2] = retries + 1
            ent[1] = now
            out.append(frame)
        return out

    def on_frame(self, frame: np.ndarray, now: int) -> None:
        p = frame[pkt.SLMP_BASE:]                 # UDP payload
        if len(p) < CTL_HDR_BYTES:
            return
        kind = int(p[0])
        src = (int(p[1]) << 8) | int(p[2])
        seq = int.from_bytes(bytes(p[3:7]), "big")
        if kind == CTL_ACK:
            ent = self._unacked.pop((src, seq), None)
            if ent is not None and ent[3] is not None \
                    and self.on_acked is not None:
                self.on_acked(ent[3])              # dispatch the ack token
            return
        if kind != CTL_MSG or len(p) < CTL_HDR_BYTES + BODY_BYTES:
            return
        # always ACK (the first ACK may have been lost)
        ack = np.zeros(CTL_HDR_BYTES, np.uint8)
        ack[0] = CTL_ACK
        ack[1:3] = (self.rank >> 8) & 0xFF, self.rank & 0xFF
        ack[3:7] = p[3:7]
        self._ack_outbox.append(pkt.make_udp(
            ack, sport=CTRL_PORT, dport=CTRL_PORT,
            src_mac=self.macs[self.rank], dst_mac=self.macs[src]))
        seen = self._seen.setdefault(src, set())
        if seq in seen:
            return                                 # duplicate: ACKed only
        seen.add(seq)
        body = decode_body(p[CTL_HDR_BYTES:CTL_HDR_BYTES + BODY_BYTES])
        if self.deliver is not None:
            self.deliver(body, now)

    # ----------------------------------------------------------- checkpoint
    def snapshot(self) -> dict:
        """Full endpoint state as plain data (insertion orders preserved —
        retransmission order is part of fabric determinism)."""
        return dict(
            next_seq=list(self._next_seq.items()),
            unacked=[(dst, seq, frame.copy(), last, retries, token,
                      dataclasses.astuple(body))
                     for (dst, seq), (frame, last, retries, token, body)
                     in self._unacked.items()],
            seen=[(src, sorted(s)) for src, s in self._seen.items()],
            ack_outbox=[f.copy() for f in self._ack_outbox],
            give_ups=self.give_ups)

    def restore(self, snap: dict) -> None:
        self._next_seq = dict(snap["next_seq"])
        self._unacked = {
            (dst, seq): [frame.copy(), last, retries,
                         None if token is None else tuple(token),
                         Ctl(*body)]
            for dst, seq, frame, last, retries, token, body
            in snap["unacked"]}
        self._seen = {src: set(s) for src, s in snap["seen"]}
        self._ack_outbox = [f.copy() for f in snap["ack_outbox"]]
        self.give_ups = snap["give_ups"]
