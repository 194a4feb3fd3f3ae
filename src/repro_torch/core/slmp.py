"""SLMP, the Simple Lossy Message Protocol of paper §V-B; PyTorch port of
``repro.core.slmp``.

10-byte header inside the UDP payload: FLAGS u16 {SYN, ACK, EOM},
MSG_ID u32, OFFSET u32.  The receiver side is implemented *entirely in
sPIN handlers* (as in the paper), here written over a batch of packets:

  header handler : sets up the message context (marks active in the
                   per-message state);
  packet handler : DMAs the payload to host memory at ``OFFSET`` (the
                   byte-granular, unaligned-capable hostmem path), counts
                   received bytes, and answers SYN segments with an ACK;
  tail handler   : pushes ``msg_id`` into counter queue 0, the host
                   completion notification.

The sender side (segmentation, the windowed retransmitting ``SlmpSender``,
``parse_acks``) is host-side numpy, copied from the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import handlers as H
from repro_torch.core import matching
from repro_torch.core import packet as pkt

COMPLETION_QUEUE = 0


# ------------------------------------------------------------ receiver side
def _mk_ack(data: torch.Tensor, length: torch.Tensor):
    """Build ACKs from received segments (N, MTU): swap L2/L3/L4 endpoints,
    set the ACK flag, drop the payload (header-only segment)."""
    d = pkt.swap_bytes(data, pkt.ETH_DST, pkt.ETH_SRC, 6)
    d = pkt.swap_bytes(d, pkt.IP_SRC, pkt.IP_DST, 4)
    d = pkt.swap_bytes(d, pkt.UDP_SPORT, pkt.UDP_DPORT, 2)
    flags = pkt.read_u16(d, pkt.SLMP_FLAGS)
    d = pkt.write_u16(d, pkt.SLMP_FLAGS, flags | pkt.SLMP_FLAG_ACK)
    d = pkt.write_u16(d, pkt.UDP_LEN, 8 + pkt.SLMP_HDR_BYTES)
    d = pkt.write_u16(d, pkt.IP_TOTLEN, 20 + 8 + pkt.SLMP_HDR_BYTES)
    # zero stale payload bytes beyond the new length
    d[:, pkt.SLMP_PAYLOAD:] = 0
    ack_len = torch.full((d.shape[0],), pkt.SLMP_PAYLOAD, dtype=torch.int32,
                         device=d.device)
    return d, ack_len


def _payload_lanes(args: H.HandlerArgs):
    """``(offset, lane, live)``: the SLMP offset per packet (int32, as the
    JAX package casts it), the byte lanes, and the payload lanes of each
    packet."""
    offset = pkt.u32_to_i32(pkt.read_u32(args.pkt, pkt.SLMP_OFFSET))
    lane = torch.arange(pkt.MTU, dtype=torch.int32, device=args.pkt.device)
    live = (lane[None, :] >= pkt.SLMP_PAYLOAD) \
        & (lane[None, :] < args.pkt_len[:, None])
    return offset, lane, live


def ack_if_syn(out: H.HandlerOut, args: H.HandlerArgs) -> H.HandlerOut:
    """Per-packet SLMP ACK when the SYN flag is set (window-mode
    reliability, paper §V-B); shared by every SLMP-transported handler."""
    flags = pkt.read_u16(args.pkt, pkt.SLMP_FLAGS)
    ack_data, ack_len = _mk_ack(args.pkt, args.pkt_len)
    syn = (flags & pkt.SLMP_FLAG_SYN) != 0
    return dataclasses.replace(out, egress_data=ack_data,
                               egress_len=torch.where(syn, ack_len, 0),
                               egress_valid=syn)


def slmp_header_handler(args: H.HandlerArgs, user) -> H.HandlerOut:
    out = H.none_out(args.n, args.pkt.device)
    # state[0] = active flag, state[1] = bytes received (assoc. counters)
    return H.add_msg_state(out, 0, 1)


def slmp_packet_handler(args: H.HandlerArgs, user) -> H.HandlerOut:
    out = H.none_out(args.n, args.pkt.device)
    offset, lane, live = _payload_lanes(args)
    # payload -> host[offset : offset+plen]  (window=1 gives in-order)
    dma_off = torch.where(
        live, offset[:, None] + (lane[None, :] - pkt.SLMP_PAYLOAD), -1)
    out = H.spin_dma_scatter(out, dma_off, args.pkt)
    out = H.add_msg_state(out, 1, args.pkt_len - pkt.SLMP_PAYLOAD)
    return ack_if_syn(out, args)


def slmp_tail_handler(args: H.HandlerArgs, user) -> H.HandlerOut:
    out = H.none_out(args.n, args.pkt.device)
    # Completion notification: msg_id to the host FIFO, at-least-once and
    # EOM-triggered (see repro.core.slmp.slmp_tail_handler).
    return H.push_counter(out, COMPLETION_QUEUE, pkt.u32_to_i32(args.msg_id))


def make_slmp_context(port: int = 9330, host_base: int = 0,
                      host_size: int = 1 << 20, name: str = "slmp",
                      packet_handler=slmp_packet_handler,
                      user=None) -> H.ExecutionContext:
    return H.ExecutionContext(
        name=name, ruleset=matching.ruleset_slmp(port),
        header=slmp_header_handler, packet=packet_handler,
        tail=slmp_tail_handler, user=user,
        host_base=host_base, host_size=host_size, message_mode=True)


# ------------------------------------------------------------- sender side
@dataclasses.dataclass
class SlmpSenderConfig:
    window: int = 16            # segments in flight before waiting for ACKs
    mtu_payload: int = pkt.MAX_SLMP_PAYLOAD
    syn_every_packet: bool = True   # window-mode: every segment SYN+ACKed
    port: int = 9330
    timeout: int = 8            # ticks before an unACKed segment retransmits
    max_retries: int = 32       # per-segment retransmit budget
    src_mac: Optional[bytes] = None
    dst_mac: Optional[bytes] = None


def segment_message(msg: np.ndarray, msg_id: int,
                    cfg: SlmpSenderConfig) -> List[np.ndarray]:
    """Split a message into SLMP segments (wire frames, numpy)."""
    frames = []
    n = len(msg)
    nseg = max(1, (n + cfg.mtu_payload - 1) // cfg.mtu_payload)
    for s in range(nseg):
        off = s * cfg.mtu_payload
        payload = msg[off:off + cfg.mtu_payload]
        flags = 0
        if cfg.syn_every_packet or s == 0 or s == nseg - 1:
            flags |= pkt.SLMP_FLAG_SYN
        if s == nseg - 1:
            flags |= pkt.SLMP_FLAG_EOM
        frames.append(pkt.make_slmp(msg_id, off, flags, payload,
                                    dport=cfg.port, src_mac=cfg.src_mac,
                                    dst_mac=cfg.dst_mac))
    return frames


class SlmpSender:
    """Windowed, reliable SLMP sender as a tick-steppable state machine.

    The paper's sender (§V-B) keeps up to ``window`` segments in flight;
    each SYN segment is ACKed by the sPIN packet handler on the receiver.
    A segment whose ACK has not arrived ``timeout`` ticks after its last
    transmission is retransmitted (up to ``max_retries`` times) — the
    retransmission path that makes SLMP survive a lossy link.

    Drive it with ``poll(now)`` (frames to put on the wire this tick) and
    ``on_ack(msg_id, offset)`` for every ACK observed.  Retransmission
    needs per-segment ACKs, so the state machine forces SYN on every
    segment (``syn_every_packet``).
    """

    def __init__(self, msg: np.ndarray, msg_id: int,
                 cfg: Optional[SlmpSenderConfig] = None):
        cfg = dataclasses.replace(cfg or SlmpSenderConfig(),
                                  syn_every_packet=True)
        self.cfg = cfg
        self.msg_id = msg_id
        self.nbytes = len(msg)
        self.frames = segment_message(msg, msg_id, cfg)
        self.nseg = len(self.frames)
        self.acked = np.zeros(self.nseg, bool)
        self.last_sent = np.full(self.nseg, -1, np.int64)
        self.retries = np.zeros(self.nseg, np.int32)
        self.sent_frames = 0
        self.retransmits = 0

    @property
    def done(self) -> bool:
        return bool(self.acked.all())

    @property
    def failed(self) -> bool:
        return bool((self.retries > self.cfg.max_retries).any())

    def on_ack(self, msg_id: int, offset: int) -> None:
        if msg_id != self.msg_id:
            return
        seg = offset // self.cfg.mtu_payload
        if 0 <= seg < self.nseg:
            self.acked[seg] = True

    def poll(self, now: int) -> List[np.ndarray]:
        """Frames to transmit at tick ``now`` (new segments fill the window,
        timed-out segments retransmit)."""
        if self.done or self.failed:
            return []
        sent = self.last_sent >= 0
        timed_out = sent & ~self.acked & (
            now - self.last_sent >= self.cfg.timeout)
        inflight = int((sent & ~self.acked & ~timed_out).sum())
        budget = max(0, self.cfg.window - inflight)
        # retransmissions first (oldest data unblocks the receiver), then
        # new segments in offset order
        segs = (np.flatnonzero(timed_out).tolist()
                + np.flatnonzero(~sent).tolist())[:budget]
        out = []
        for s in segs:
            if self.last_sent[s] >= 0:
                self.retries[s] += 1
                if self.retries[s] > self.cfg.max_retries:
                    continue               # budget exhausted: nothing sent
                self.retransmits += 1
            self.last_sent[s] = now
            self.sent_frames += 1
            out.append(self.frames[s])
        return out

    # -- checkpoint support (net fabric snapshots) ------------------------
    def snapshot(self) -> dict:
        return dict(acked=self.acked.copy(), last_sent=self.last_sent.copy(),
                    retries=self.retries.copy(),
                    sent_frames=self.sent_frames,
                    retransmits=self.retransmits)

    def restore(self, snap: dict) -> None:
        self.acked = snap["acked"].copy()
        self.last_sent = snap["last_sent"].copy()
        self.retries = snap["retries"].copy()
        self.sent_frames = snap["sent_frames"]
        self.retransmits = snap["retransmits"]


def parse_acks(batch) -> List[tuple]:
    """Host-side: extract (msg_id, offset) from ACK segments in a batch
    (a ``PacketBatch`` or its ``(data, length, valid)`` numpy arrays)."""
    if isinstance(batch, pkt.PacketBatch):
        batch = batch.numpy()
    data, _, valid = (np.asarray(a) for a in batch)
    acks = []
    for i in range(len(valid)):
        if not valid[i]:
            continue
        flags = (int(data[i, pkt.SLMP_FLAGS]) << 8) | int(
            data[i, pkt.SLMP_FLAGS + 1])
        if flags & pkt.SLMP_FLAG_ACK:
            msg_id = int.from_bytes(bytes(data[i, pkt.SLMP_MSGID:
                                               pkt.SLMP_MSGID + 4]), "big")
            off = int.from_bytes(bytes(data[i, pkt.SLMP_OFFSET:
                                            pkt.SLMP_OFFSET + 4]), "big")
            acks.append((msg_id, off))
    return acks
