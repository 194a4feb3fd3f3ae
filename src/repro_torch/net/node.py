"""A fabric node: one SpinNIC plus the host software beside it; PyTorch
port of ``repro.net.node``.

A :class:`Node` bundles a :class:`~repro_torch.core.spin_nic.SpinNIC`
(+ its ``NICState``, on the NIC's device) with a list of *host engines*
that generate and consume traffic from inside the simulation:

  * handler egress (ACKs, echo replies) leaves through the node's wire;
  * frames the matcher does not claim are forwarded ``to_host`` and the
    engines consume them there (ACKs at the SLMP sender, pongs at the
    ping-pong client);
  * completion notifications (counter queue 0) are drained every tick.

The host engines are numpy, copied from the JAX package.  Every read of
device state back to the host is a synchronisation on the card, so the
node counts them (``host_reads``) beside its NIC steps (``steps``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import handlers as H
from repro_torch.core import packet as pkt
from repro_torch.core import slmp
from repro_torch.core import spin_nic


class HostEngine:
    """Host-side traffic generator/consumer stepped by the fabric tick."""

    def poll(self, now: int) -> List[np.ndarray]:
        """Frames this engine puts on the wire at tick ``now``."""
        return []

    def on_host_frames(self, frames: List[np.ndarray], now: int) -> None:
        """Frames forwarded to the host datapath (non-matching ingress)."""

    def on_completions(self, values: np.ndarray, now: int) -> None:
        """Values drained from the completion counter FIFO."""

    @property
    def done(self) -> bool:
        return True

    def snapshot(self) -> dict:
        return {}

    def restore(self, snap: dict) -> None:
        pass


class SlmpSenderEngine(HostEngine):
    """Host half of a reliable SLMP transfer (wraps core.slmp.SlmpSender)."""

    def __init__(self, msg: np.ndarray, msg_id: int,
                 cfg: Optional[slmp.SlmpSenderConfig] = None):
        self.sender = slmp.SlmpSender(msg, msg_id, cfg)

    def poll(self, now: int) -> List[np.ndarray]:
        return self.sender.poll(now)

    def on_host_frames(self, frames: List[np.ndarray], now: int) -> None:
        for msg_id, off in slmp.parse_acks(pkt.stack_frames_np(frames)) \
                if frames else []:
            self.sender.on_ack(msg_id, off)

    @property
    def done(self) -> bool:
        # "done" = generates no more traffic: delivered OR gave up
        return self.sender.done or self.sender.failed

    @property
    def failed(self) -> bool:
        return self.sender.failed

    def snapshot(self) -> dict:
        return self.sender.snapshot()

    def restore(self, snap: dict) -> None:
        self.sender.restore(snap)


class PingPongClient(HostEngine):
    """Fires ``count`` pings at a peer, one outstanding, recording the RTT
    of each pong in fabric ticks (the Fig-7 client, ICMP or UDP)."""

    def __init__(self, count: int, payload: int = 56, proto: str = "udp",
                 dport: int = 9999, src_mac: Optional[bytes] = None,
                 dst_mac: Optional[bytes] = None, timeout: int = 64):
        assert proto in ("icmp", "udp")
        assert payload >= 2, "seq stamp needs two payload bytes"
        self.count = count
        self.proto = proto
        self.dport = dport
        self.src_mac = src_mac
        self.dst_mac = dst_mac
        self.timeout = timeout
        self.payload = np.arange(payload, dtype=np.uint8)
        self.seq = 0
        self.sent_at = -1          # -1: nothing outstanding
        self.first_sent = -1       # first transmission of the current seq
        self.rtts: List[int] = []
        self.timeouts = 0

    def _frame(self, seq: int) -> np.ndarray:
        # the responder echoes the payload verbatim, so a seq stamped into
        # the first two payload bytes identifies which ping a pong answers
        payload = self.payload.copy()
        payload[0], payload[1] = (seq >> 8) & 0xFF, seq & 0xFF
        if self.proto == "icmp":
            return pkt.make_icmp_echo(payload, seq=seq,
                                      src_mac=self.src_mac,
                                      dst_mac=self.dst_mac)
        return pkt.make_udp(payload, dport=self.dport,
                            src_mac=self.src_mac, dst_mac=self.dst_mac)

    def poll(self, now: int) -> List[np.ndarray]:
        if self.seq >= self.count and self.sent_at < 0:
            return []
        if self.sent_at >= 0:
            if now - self.sent_at < self.timeout:
                return []
            self.timeouts += 1                 # lost ping or pong: refire
        else:
            self.first_sent = now
        self.sent_at = now
        return [self._frame(self.seq)]

    def on_host_frames(self, frames: List[np.ndarray], now: int) -> None:
        if self.sent_at < 0:
            return
        for f in frames:
            is_pong = (f[pkt.IP_PROTO] == pkt.IPPROTO_ICMP
                       and f[pkt.ICMP_TYPE] == pkt.ICMP_ECHO_REPLY) \
                if self.proto == "icmp" else \
                (f[pkt.IP_PROTO] == pkt.IPPROTO_UDP)
            # both echo payloads start at byte 42: the stamped seq ties the
            # pong to the outstanding ping (duplicates/late pongs ignored)
            echoed = (int(f[42]) << 8) | int(f[43]) if len(f) >= 44 else -1
            if is_pong and echoed == self.seq:
                # completion latency: measured from the FIRST transmission,
                # so retry delay after loss shows up in the number
                self.rtts.append(now - self.first_sent)
                self.seq += 1
                self.sent_at = -1
                break

    @property
    def done(self) -> bool:
        return self.seq >= self.count

    def snapshot(self) -> dict:
        return dict(seq=self.seq, sent_at=self.sent_at,
                    first_sent=self.first_sent,
                    rtts=list(self.rtts), timeouts=self.timeouts)

    def restore(self, snap: dict) -> None:
        self.seq = snap["seq"]
        self.sent_at = snap["sent_at"]
        self.first_sent = snap["first_sent"]
        self.rtts = list(snap["rtts"])
        self.timeouts = snap["timeouts"]


class Node:
    """One endpoint of the fabric: NIC + host engines + a MAC address.

    Pass ``nic`` to share one :class:`SpinNIC` between several nodes with
    identical contexts (a ``SpinNIC`` holds no per-node mutable state).
    ``contexts``/``host_bytes``/``batch``/``device`` are ignored when
    ``nic`` is given; otherwise the NIC is built on ``device`` (default
    ``"cuda"``, which raises without a GPU).
    """

    def __init__(self, name: str, mac: bytes,
                 contexts: Optional[Sequence] = None,
                 host_bytes: int = 1 << 20,
                 batch: int = 32,
                 engines: Sequence[HostEngine] = (),
                 nic: Optional[spin_nic.SpinNIC] = None,
                 device="cuda"):
        self.name = name
        self.mac = bytes(mac)
        if nic is None:
            assert contexts is not None, "need contexts or a prebuilt nic"
            nic = spin_nic.SpinNIC(list(contexts), host_bytes=host_bytes,
                                   batch=batch, device=device)
        self.nic = nic
        self.device = nic.device
        contexts = nic.contexts
        self.batch = nic.batch
        # any installed handler may push_counter; skip the per-tick FIFO
        # drain only when no context runs handlers at all (null-context
        # sender/client nodes)
        self._completes = any(
            c.message_mode or c.header is not H.default_handler
            or c.packet is not H.default_handler
            or c.tail is not H.default_handler
            for c in contexts)
        self.state = self.nic.init_state()
        self.engines: List[HostEngine] = list(engines)
        # drained completion FIFO values, in arrival order (SLMP pushes are
        # at-least-once, so duplicates appear under loss)
        self.completions: List[int] = []
        self.steps = 0           # NIC steps run (one K1 launch each)
        self.host_reads = 0      # device-to-host reads (syncs on the card)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        self.host_reads += 1
        return t.cpu().numpy()

    def tick_idle(self, now: int) -> List[np.ndarray]:
        """Advance one tick with an empty ingress batch.  The NIC step is
        skipped: with no valid frames the datapath changes nothing but the
        cycle counter (which nothing reads), as in the JAX package.  Host
        engines still poll (timers, retransmits)."""
        out: List[np.ndarray] = []
        for e in self.engines:
            out.extend(e.poll(now))
        return out

    def tick(self, ingress: pkt.PacketBatch, now: int) -> List[np.ndarray]:
        """Advance one tick: run the NIC on the delivered ingress batch,
        hand host-path frames and completions to the engines, and return
        every frame this node puts on the wire.

        One read brings back the validity and lengths of both output
        batches and the completion count; the to-host and egress bytes are
        read only when a lane is valid, the FIFO only when it holds
        values."""
        self.state, egress, to_host = self.nic.step(self.state, ingress)
        self.steps += 1
        n = to_host.valid.shape[0]
        q = slmp.COMPLETION_QUEUE
        head = self._host(torch.cat([
            to_host.valid.to(torch.int32), to_host.length,
            egress.valid.to(torch.int32), egress.length,
            self.state.counter_count[q:q + 1]]))
        th_valid, th_len = head[:n].astype(bool), head[n:2 * n]
        eg_valid, eg_len = head[2 * n:3 * n].astype(bool), head[3 * n:4 * n]

        # host datapath: deliver non-matching frames to the engines
        if th_valid.any():
            data = self._host(to_host.data)
            host_frames = [data[i, :th_len[i]].copy()
                           for i in np.flatnonzero(th_valid)]
            for e in self.engines:
                e.on_host_frames(host_frames, now)

        # completion notifications
        if self._completes and head[4 * n] > 0:
            self.host_reads += 2                 # the count and the FIFO
            comp, self.state = self.nic.pop_counters(self.state, q)
            if len(comp):
                self.completions.extend(int(c) for c in comp)
                for e in self.engines:
                    e.on_completions(comp, now)

        # outbound = handler egress + engine-generated frames
        out: List[np.ndarray] = []
        if eg_valid.any():
            data = self._host(egress.data)
            out.extend(data[i, :eg_len[i]].copy()
                       for i in np.flatnonzero(eg_valid))
        for e in self.engines:
            out.extend(e.poll(now))
        return out

    @property
    def done(self) -> bool:
        return all(e.done for e in self.engines)

    def reset(self, engines: Optional[Sequence[HostEngine]] = None) -> None:
        """Fresh NIC state, counts (and optionally new engines), same
        NIC."""
        self.state = self.nic.init_state()
        self.completions = []
        self.steps = self.host_reads = 0
        if engines is not None:
            self.engines = list(engines)

    def read_host(self, base: int, nbytes: int) -> np.ndarray:
        self.host_reads += 1
        return self.nic.read_host(self.state, base, nbytes)

    def write_expect(self, idx: int, msg_id: int) -> None:
        """Host MMIO write into the NIC's expected-msg_id slot table."""
        self.state = self.nic.write_expect(self.state, idx, msg_id)

    def snapshot(self) -> dict:
        # the NIC step updates its state in place: snapshots own copies
        return dict(nic=self.state.clone(),
                    engines=[e.snapshot() for e in self.engines],
                    completions=list(self.completions))

    def restore(self, snap: dict) -> None:
        self.state = snap["nic"].clone()
        for e, s in zip(self.engines, snap["engines"]):
            e.restore(s)
        self.completions = list(snap["completions"])
