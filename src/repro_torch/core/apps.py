"""Built-in sPIN handler applications (paper Listings 1-2 and §V-C);
PyTorch port of ``repro.core.apps``.

* ICMP echo responder: the Listing 1/2 example, full-payload RFC1071
  checksum inside the packet handler.
* UDP ping-pong responder: checksum-free (UDP checksum omitted).
* ICMP host path: the frame is DMA'd to the host, which answers.
* MPI DDT receive context: SLMP transport + datatype scatter into host
  memory through the committed index map (dataloop engine offload).
* MPI eager and MPI DDT (rendezvous) receive contexts of ``repro.mpi``.

Every handler is written over a batch of packets.  A context's constant
tables (DDT maps) are uploaded to ``device`` when the context is built.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import checksum as ck
from repro_torch.core import ddt as ddtlib
from repro_torch.core import handlers as H
from repro_torch.core import matching
from repro_torch.core import packet as pkt
from repro_torch.core import slmp


# ---------------------------------------------------------- host-only node
def make_null_context() -> H.ExecutionContext:
    """Matches nothing: the whole ingress stream takes the host datapath."""
    return H.ExecutionContext(name="null", ruleset=matching.ruleset_none())


# ------------------------------------------------------------- ICMP echo
def icmp_echo_packet_handler(args: H.HandlerArgs, user) -> H.HandlerOut:
    """Listing 1: swap MAC/IP, type=EchoReply, recompute full checksum."""
    out = H.none_out(args.n, args.pkt.device)
    d = pkt.swap_bytes(args.pkt, pkt.ETH_DST, pkt.ETH_SRC, 6)
    d = pkt.swap_bytes(d, pkt.IP_SRC, pkt.IP_DST, 4)
    d[:, pkt.ICMP_TYPE] = pkt.ICMP_ECHO_REPLY
    d = pkt.write_u16(d, pkt.ICMP_CSUM, 0)
    c = ck.internet_checksum_1(d, args.pkt_len, pkt.L4_BASE)
    d = pkt.write_u16(d, pkt.ICMP_CSUM, c)
    return H.spin_send_packet(out, d, args.pkt_len)


def make_icmp_context() -> H.ExecutionContext:
    return H.ExecutionContext(
        name="icmp_echo", ruleset=matching.ruleset_icmp_echo(),
        packet=icmp_echo_packet_handler)


# ---------------------------------------------------------- UDP ping-pong
def udp_pingpong_packet_handler(args: H.HandlerArgs, user) -> H.HandlerOut:
    out = H.none_out(args.n, args.pkt.device)
    d = pkt.swap_bytes(args.pkt, pkt.ETH_DST, pkt.ETH_SRC, 6)
    d = pkt.swap_bytes(d, pkt.IP_SRC, pkt.IP_DST, 4)
    d = pkt.swap_bytes(d, pkt.UDP_SPORT, pkt.UDP_DPORT, 2)
    return H.spin_send_packet(out, d, args.pkt_len)


def make_udp_pingpong_context(port: int = 9999) -> H.ExecutionContext:
    return H.ExecutionContext(
        name="udp_pingpong", ruleset=matching.ruleset_udp_pingpong(port),
        packet=udp_pingpong_packet_handler)


# -------------------------------------------------- Host+FPsPIN ping mode
def icmp_to_host_packet_handler(args: H.HandlerArgs, user) -> H.HandlerOut:
    """Host+FPsPIN mode: DMA the frame to host memory and notify; the host
    computes the checksum and injects the reply."""
    out = H.none_out(args.n, args.pkt.device)
    lane = torch.arange(pkt.MTU, dtype=torch.int32,
                        device=args.pkt.device)[None, :]
    off = torch.where(lane < args.pkt_len[:, None], lane, -1)
    out = H.spin_dma_scatter(out, off, args.pkt)
    return H.push_counter(out, slmp.COMPLETION_QUEUE, args.pkt_len)


def make_icmp_host_context(host_base: int = 0) -> H.ExecutionContext:
    return H.ExecutionContext(
        name="icmp_hostpath", ruleset=matching.ruleset_icmp_echo(),
        packet=icmp_to_host_packet_handler, host_base=host_base)


# --------------------------------------------------------- shared helpers
def _slmp_payload_lanes(args: H.HandlerArgs):
    """Per-lane view of each SLMP segment's payload: ``(msg_pos, live)``,
    both (N, MTU), where ``msg_pos`` is the message byte position a lane
    carries and ``live`` masks the payload lanes of its packet."""
    offset, lane, live = slmp._payload_lanes(args)
    msg_pos = offset[:, None] + (lane[None, :] - pkt.SLMP_PAYLOAD)
    return msg_pos, live


# ------------------------------------------------------ MPI DDT processing
def make_ddt_packet_handler(committed: ddtlib.CommittedDDT,
                            msgs_in_flight: int = 16, device="cuda"):
    """Packet handler for DDT receive: scatter payload bytes through the
    committed datatype's msg->mem map.  Parallel messages are placed at
    ``msg_id * mem_bytes`` (disjoint regions, as the paper's 16 concurrent
    messages)."""
    msg_to_mem = torch.as_tensor(committed.msg_to_mem,
                                 device=resolve_device(device))
    mem_bytes = committed.mem_bytes
    msg_len = committed.msg_bytes

    def ddt_packet_handler(args: H.HandlerArgs, user) -> H.HandlerOut:
        out = H.none_out(args.n, args.pkt.device)
        msg_pos, live = _slmp_payload_lanes(args)
        live = live & (msg_pos < msg_len)
        mem_off = msg_to_mem[msg_pos.clamp(0, msg_len - 1).to(torch.int64)]
        region = (pkt.u32_to_i32(args.msg_id) % msgs_in_flight) * mem_bytes
        dma_off = torch.where(live, region[:, None] + mem_off, -1)
        out = H.spin_dma_scatter(out, dma_off, args.pkt)
        out = H.add_msg_state(out, 1, args.pkt_len - pkt.SLMP_PAYLOAD)
        # per-packet ACK when SYN set (window=1 mode in the paper's runs)
        return slmp.ack_if_syn(out, args)

    return ddt_packet_handler


def make_ddt_context(committed: ddtlib.CommittedDDT, port: int = 9331,
                     msgs_in_flight: int = 16, host_base: int = 0,
                     device="cuda") -> H.ExecutionContext:
    return slmp.make_slmp_context(
        port=port, host_base=host_base,
        host_size=committed.mem_bytes * msgs_in_flight,
        name="mpi_ddt",
        packet_handler=make_ddt_packet_handler(committed, msgs_in_flight,
                                               device))


# ----------------------------------------------- MPI messaging (repro.mpi)
# msg_id bit layout shared between the host MPI library and the NIC
# handlers below.  The MPQ masks msg_id to 28 bits, so the whole encoding
# must stay below bit 28:
#
#     [25:24] kind (1 = eager, 2 = rendezvous)
#     [23:16] datatype id (rendezvous only)
#     [15:0]  staging / rendezvous slot on the receiver
MPI_KIND_EAGER = 1
MPI_KIND_RDV = 2
MPI_MSGID_KIND_SHIFT = 24
MPI_MSGID_DTYPE_SHIFT = 16
MPI_MSGID_DTYPE_MASK = 0xFF
MPI_MSGID_SLOT_MASK = 0xFFFF


# How many times each MPI NIC context (and its device tables) has been
# built this job.  A context build uploads the committed index maps to the
# device, so regression tests assert this stays flat when a second
# communicator reuses the same datatype tables (the repro_torch.mpi NIC
# cache).
MPI_CONTEXT_BUILDS = dict(eager=0, ddt=0)


def make_mpi_eager_context(port: int, n_slots: int, slot_bytes: int,
                           host_base: int = 0) -> H.ExecutionContext:
    """Eager-protocol receive context: each message lands in a per-sender
    staging slot of the host window (slot index in the low msg_id bits);
    the host matches tags and copies out after the sender's FIN.  The NIC
    does reassembly + per-packet ACK."""
    MPI_CONTEXT_BUILDS["eager"] += 1

    def eager_packet_handler(args: H.HandlerArgs, user) -> H.HandlerOut:
        out = H.none_out(args.n, args.pkt.device)
        slot = (pkt.u32_to_i32(args.msg_id) & MPI_MSGID_SLOT_MASK)[:, None]
        rel, live = _slmp_payload_lanes(args)
        live = live & (rel < slot_bytes) & (slot < n_slots)
        dma_off = torch.where(live, slot * slot_bytes + rel, -1)
        out = H.spin_dma_scatter(out, dma_off, args.pkt)
        out = H.add_msg_state(out, 1, args.pkt_len - pkt.SLMP_PAYLOAD)
        return slmp.ack_if_syn(out, args)

    return slmp.make_slmp_context(
        port=port, host_base=host_base, host_size=n_slots * slot_bytes,
        name="mpi_eager", packet_handler=eager_packet_handler)


def make_mpi_ddt_context(maps, msg_lens, region_bytes: int, n_slots: int,
                         port: int, host_base: int = 0, device="cuda"
                         ) -> H.ExecutionContext:
    """Rendezvous receive context with *offloaded datatype processing*:
    payload bytes scatter through the committed msg->mem index map of the
    datatype named in the msg_id, straight into the posted receive region
    (``phys_slot * region_bytes``) of host memory.

    The msg_id's 16-bit slot field carries a *virtual* slot
    ``gen * n_slots + phys``: the host arms ``expect[phys]`` with the full
    msg_id before granting the CTS, and the handler drops any frame whose
    msg_id does not match, so a stale retransmit of the region's previous
    occupant can never scribble a recycled slot.

    ``maps``: (D, Mmax) int32, msg->mem byte map per datatype, -1-padded;
    ``msg_lens``: (D,) int32 serialized size per datatype.
    """
    MPI_CONTEXT_BUILDS["ddt"] += 1
    dev = resolve_device(device)
    maps = torch.as_tensor(np.asarray(maps, np.int32), device=dev)
    msg_lens = torch.as_tensor(np.asarray(msg_lens, np.int32), device=dev)
    n_types, max_msg = maps.shape
    if n_types < 1 or max_msg < 1:
        raise ValueError("make_mpi_ddt_context: empty datatype table")

    def mpi_ddt_packet_handler(args: H.HandlerArgs, user) -> H.HandlerOut:
        out = H.none_out(args.n, args.pkt.device)
        msg_id = pkt.u32_to_i32(args.msg_id)
        phys = (msg_id & MPI_MSGID_SLOT_MASK) % n_slots
        dtype = (msg_id >> MPI_MSGID_DTYPE_SHIFT) & MPI_MSGID_DTYPE_MASK
        dt = dtype.clamp(0, n_types - 1).to(torch.int64)
        msg_len = msg_lens[dt]
        msg_pos, live = _slmp_payload_lanes(args)
        armed = args.expect[phys.to(torch.int64)] == args.msg_id
        live = live & (msg_pos < msg_len[:, None]) \
            & (dtype < n_types)[:, None] & armed[:, None]
        mem_off = maps[dt[:, None],
                       msg_pos.clamp(0, max_msg - 1).to(torch.int64)]
        dma_off = torch.where(live & (mem_off >= 0),
                              (phys * region_bytes)[:, None] + mem_off, -1)
        out = H.spin_dma_scatter(out, dma_off, args.pkt)
        out = H.add_msg_state(out, 1, args.pkt_len - pkt.SLMP_PAYLOAD)
        return slmp.ack_if_syn(out, args)

    ctx = slmp.make_slmp_context(
        port=port, host_base=host_base, host_size=n_slots * region_bytes,
        name="mpi_ddt_unpack", packet_handler=mpi_ddt_packet_handler)
    return dataclasses.replace(ctx, n_expect=n_slots)
