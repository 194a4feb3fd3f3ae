"""Packet representation and protocol header layouts (PyTorch port of
``repro.core.packet``).

A batch of frames is a ``PacketBatch``: ``(N, MTU) uint8`` bytes, an
``int32`` length vector and a ``bool`` validity mask.  Header fields sit at
the fixed byte offsets of paper Fig. 6 and are big-endian:

    Ethernet   bytes  0..13   (dst MAC 0:6, src MAC 6:12, ethertype 12:14)
    IPv4       bytes 14..33   (proto @23, src @26:30, dst @30:34, csum @24:26)
    ICMP       bytes 34..     (type @34, code @35, csum @36:38)
    UDP        bytes 34..41   (sport @34:36, dport @36:38, len @38:40,
                               csum @40:42)
    SLMP       bytes 42..51   (flags u16 @42, msg_id u32 @44, offset u32 @48)
    SLMP data  bytes 52..

The torch helpers return unsigned fields as ``int64`` masked to 32 bits
(``torch.uint32`` has no shift or compare on the CPU).  The numpy frame
builders are copied from the JAX package unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device, trace

# ---------------------------------------------------------------------------
# Constants (paper §IV: bimodal slot sizes; Ethernet MTU-sized frames).
MTU = 1536                      # large-slot size == max frame we carry
SMALL_SLOT = 128                # small-slot size
WORDS = MTU // 4                # 32-bit words per packet, for the matcher

# Header offsets (bytes).
ETH_DST, ETH_SRC, ETH_TYPE = 0, 6, 12
IP_BASE = 14
IP_VER_IHL = 14
IP_TOTLEN = 16
IP_ID = 18
IP_TTL = 22
IP_PROTO = 23
IP_CSUM = 24
IP_SRC = 26
IP_DST = 30
L4_BASE = 34
ICMP_TYPE = 34
ICMP_CODE = 35
ICMP_CSUM = 36
UDP_SPORT = 34
UDP_DPORT = 36
UDP_LEN = 38
UDP_CSUM = 40
SLMP_BASE = 42
SLMP_FLAGS = 42
SLMP_MSGID = 44
SLMP_OFFSET = 48
SLMP_PAYLOAD = 52
SLMP_HDR_BYTES = 10

ETH_P_IP = 0x0800
IPPROTO_ICMP = 1
IPPROTO_UDP = 17
ICMP_ECHO_REQUEST = 8
ICMP_ECHO_REPLY = 0

# SLMP flag bits (paper §V-B).
SLMP_FLAG_SYN = 1 << 0
SLMP_FLAG_ACK = 1 << 1
SLMP_FLAG_EOM = 1 << 2

MAX_SLMP_PAYLOAD = MTU - SLMP_PAYLOAD


U32_MASK = 0xFFFFFFFF


@dataclasses.dataclass
class PacketBatch:
    """A batch of raw frames. ``data[i, :length[i]]`` are the live bytes."""

    data: torch.Tensor      # (N, MTU) uint8
    length: torch.Tensor    # (N,) int32
    valid: torch.Tensor     # (N,) bool

    @property
    def n(self) -> int:
        return self.data.shape[0]

    def words(self) -> torch.Tensor:
        """(N, WORDS) big-endian u32 words as int64."""
        return bytes_to_u32be(self.data)

    def numpy(self):
        """``(data, length, valid)`` as numpy arrays."""
        return (self.data.cpu().numpy(), self.length.cpu().numpy(),
                self.valid.cpu().numpy())

    @staticmethod
    def from_numpy(data: np.ndarray, length: np.ndarray, valid: np.ndarray,
                   device="cuda") -> "PacketBatch":
        """The arrays copied to ``device``: on CUDA each copy from pageable
        host memory waits for the stream (``host_syncs`` counts three)."""
        dev = resolve_device(device)
        trace.count("host_syncs", 3)
        return PacketBatch(
            torch.as_tensor(np.asarray(data, np.uint8), device=dev),
            torch.as_tensor(np.asarray(length, np.int32), device=dev),
            torch.as_tensor(np.asarray(valid, bool), device=dev))


# ---------------------------------------------------------------------------
# Integer helpers.  u32 values live in int64 tensors masked to 32 bits.

def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret u32 values (int64, masked) as int32 (two's complement),
    as ``jnp.astype(jnp.int32)`` does on a uint32 array."""
    x = x.to(torch.int64) & U32_MASK
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _as_u32(val, like: torch.Tensor) -> torch.Tensor:
    if not isinstance(val, torch.Tensor):
        return torch.full((), int(val) & U32_MASK, dtype=torch.int64,
                          device=like.device)
    return val.to(device=like.device, dtype=torch.int64) & U32_MASK


# ---------------------------------------------------------------------------
# Endian helpers over uint8 tensors (any leading batch shape).

def bytes_to_u32be(data: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 4k) -> int64 (..., k) big-endian u32 words."""
    b = data.to(torch.int64).reshape(*data.shape[:-1], -1, 4)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) \
        | b[..., 3]


def bytes_to_u16be(data: torch.Tensor) -> torch.Tensor:
    b = data.to(torch.int64).reshape(*data.shape[:-1], -1, 2)
    return (b[..., 0] << 8) | b[..., 1]


def read_u16(data: torch.Tensor, off: int) -> torch.Tensor:
    """Big-endian u16 at static byte offset, as int64.  data: (..., bytes)."""
    return (data[..., off].to(torch.int64) << 8) \
        | data[..., off + 1].to(torch.int64)


def read_u32(data: torch.Tensor, off: int) -> torch.Tensor:
    """Big-endian u32 at static byte offset, as int64."""
    return bytes_to_u32be(data[..., off:off + 4])[..., 0]


def write_u16(data: torch.Tensor, off: int, val) -> torch.Tensor:
    """Copy of ``data`` with the big-endian u16 ``val`` at ``off``
    (``val`` broadcasts over the leading dims)."""
    val = _as_u32(val, data)
    out = data.clone()
    out[..., off] = ((val >> 8) & 0xFF).to(torch.uint8)
    out[..., off + 1] = (val & 0xFF).to(torch.uint8)
    return out


def write_u32(data: torch.Tensor, off: int, val) -> torch.Tensor:
    val = _as_u32(val, data)
    out = data.clone()
    for i in range(4):
        out[..., off + i] = ((val >> (24 - 8 * i)) & 0xFF).to(torch.uint8)
    return out


def swap_bytes(data: torch.Tensor, a: int, b: int, n: int) -> torch.Tensor:
    """Copy of ``data`` with byte ranges [a, a+n) and [b, b+n) swapped
    (used to swap MAC/IP/ports)."""
    out = data.clone()
    out[..., a:a + n] = data[..., b:b + n]
    out[..., b:b + n] = data[..., a:a + n]
    return out


# ---------------------------------------------------------------------------
# Frame builders (host-side, numpy) — used by tests, benchmarks, examples
# and the packetized data pipeline.  These produce wire-correct frames so
# the matcher rules from the paper apply verbatim.

def _np_u16(buf: np.ndarray, off: int, val: int) -> None:
    buf[off] = (val >> 8) & 0xFF
    buf[off + 1] = val & 0xFF


def _np_u32(buf: np.ndarray, off: int, val: int) -> None:
    for i in range(4):
        buf[off + i] = (val >> (24 - 8 * i)) & 0xFF


def internet_checksum_np(data: np.ndarray) -> int:
    """RFC1071 ones-complement checksum of a byte array (numpy oracle)."""
    if len(data) % 2:
        data = np.concatenate([data, np.zeros(1, np.uint8)])
    words = (data[0::2].astype(np.uint32) << 8) | data[1::2]
    s = int(words.sum())
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


def node_mac(node_id: int) -> bytes:
    """Locally-administered MAC for simulated node ``node_id`` (net fabric)."""
    return bytes([0x02, 0, 0, 0, (node_id >> 8) & 0xFF, node_id & 0xFF])


def build_eth_ip(buf: np.ndarray, proto: int, payload_len: int,
                 src_ip: int = 0x0A000001, dst_ip: int = 0x0A000002,
                 src_mac: Optional[bytes] = None,
                 dst_mac: Optional[bytes] = None) -> None:
    buf[ETH_DST:ETH_DST + 6] = np.frombuffer(
        dst_mac, np.uint8) if dst_mac is not None else \
        np.arange(6, dtype=np.uint8) + 0x10
    buf[ETH_SRC:ETH_SRC + 6] = np.frombuffer(
        src_mac, np.uint8) if src_mac is not None else \
        np.arange(6, dtype=np.uint8) + 0x20
    _np_u16(buf, ETH_TYPE, ETH_P_IP)
    buf[IP_VER_IHL] = 0x45
    _np_u16(buf, IP_TOTLEN, 20 + payload_len)
    _np_u16(buf, IP_ID, 1)
    buf[IP_TTL] = 64
    buf[IP_PROTO] = proto
    _np_u32(buf, IP_SRC, src_ip)
    _np_u32(buf, IP_DST, dst_ip)
    _np_u16(buf, IP_CSUM, 0)
    _np_u16(buf, IP_CSUM, internet_checksum_np(buf[IP_BASE:IP_BASE + 20]))


def make_icmp_echo(payload: np.ndarray, seq: int = 0,
                   src_mac: Optional[bytes] = None,
                   dst_mac: Optional[bytes] = None) -> np.ndarray:
    """Wire-correct ICMP Echo-Request frame (numpy uint8, len 42+payload)."""
    n = ICMP_CSUM + 6 + len(payload)
    buf = np.zeros(n, np.uint8)
    build_eth_ip(buf, IPPROTO_ICMP, 8 + len(payload),
                 src_mac=src_mac, dst_mac=dst_mac)
    buf[ICMP_TYPE] = ICMP_ECHO_REQUEST
    _np_u16(buf, ICMP_CSUM + 2, 0x1234)      # identifier
    _np_u16(buf, ICMP_CSUM + 4, seq)
    buf[L4_BASE + 8:] = payload
    _np_u16(buf, ICMP_CSUM, 0)
    _np_u16(buf, ICMP_CSUM, internet_checksum_np(buf[L4_BASE:]))
    return buf


def make_udp(payload: np.ndarray, sport: int = 9999, dport: int = 9999,
             src_mac: Optional[bytes] = None,
             dst_mac: Optional[bytes] = None) -> np.ndarray:
    n = SLMP_BASE + len(payload)
    buf = np.zeros(n, np.uint8)
    build_eth_ip(buf, IPPROTO_UDP, 8 + len(payload),
                 src_mac=src_mac, dst_mac=dst_mac)
    _np_u16(buf, UDP_SPORT, sport)
    _np_u16(buf, UDP_DPORT, dport)
    _np_u16(buf, UDP_LEN, 8 + len(payload))
    _np_u16(buf, UDP_CSUM, 0)                # paper: UDP csum omitted
    buf[SLMP_BASE:] = payload
    return buf


def make_slmp(msg_id: int, offset: int, flags: int, payload: np.ndarray,
              dport: int = 9330,
              src_mac: Optional[bytes] = None,
              dst_mac: Optional[bytes] = None) -> np.ndarray:
    """SLMP segment: 10-byte header inside the UDP payload (paper §V-B)."""
    body = np.zeros(SLMP_HDR_BYTES + len(payload), np.uint8)
    _np_u16(body, 0, flags)
    _np_u32(body, 2, msg_id)
    _np_u32(body, 6, offset)
    body[SLMP_HDR_BYTES:] = payload
    return make_udp(body, dport=dport, src_mac=src_mac, dst_mac=dst_mac)


def stack_frames_np(frames: list, n: Optional[int] = None):
    """Pad a list of numpy frames into ``(data, length, valid)`` numpy
    arrays of a batch of ``n`` rows."""
    n = n if n is not None else len(frames)
    data = np.zeros((n, MTU), np.uint8)
    length = np.zeros((n,), np.int32)
    valid = np.zeros((n,), bool)
    for i, f in enumerate(frames):
        data[i, :len(f)] = f
        length[i] = len(f)
        valid[i] = True
    return data, length, valid


def stack_frames(frames: list, n: Optional[int] = None,
                 device="cuda") -> PacketBatch:
    """Pad a list of numpy frames into a PacketBatch on ``device``."""
    return PacketBatch.from_numpy(*stack_frames_np(frames, n), device=device)
