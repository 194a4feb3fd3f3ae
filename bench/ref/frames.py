"""SLMP framing (paper §V-B): a frozen, vectorised copy of the wire format
the NIC receives.

A frame is Ethernet (dst MAC 0:6, src MAC 6:12, type 12:14), IPv4 (14:34,
header checksum at 24), UDP (34:42, checksum 0 as in the paper) and the
10-byte SLMP header (flags u16 at 42, msg_id u32 at 44, offset u32 at
48), then at most ``MAX_PAYLOAD`` message bytes; fields are big-endian.
The sender of the paper's runs sets SYN on every segment (window 1, each
segment ACKed) and EOM on the last.
"""
from __future__ import annotations

import numpy as np

MTU = 1536
SLMP_FLAGS, SLMP_MSGID, SLMP_OFFSET, SLMP_PAYLOAD = 42, 44, 48, 52
MAX_PAYLOAD = MTU - SLMP_PAYLOAD
FLAG_SYN, FLAG_ACK, FLAG_EOM = 1, 2, 4


def _put(rows: np.ndarray, off: int, val, nbytes: int) -> None:
    val = np.asarray(val, np.int64)
    for i in range(nbytes):
        rows[:, off + i] = (val >> (8 * (nbytes - 1 - i))) & 0xFF


def _ip_checksum(hdr: np.ndarray) -> np.ndarray:
    """RFC 1071 checksum of each row of (n, 20) IPv4 headers."""
    words = (hdr[:, 0::2].astype(np.int64) << 8) | hdr[:, 1::2]
    s = words.sum(axis=1)
    while (s >> 16).any():
        s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


def segment(msg: np.ndarray, msg_id: int, port: int,
            payload: int = MAX_PAYLOAD):
    """The SLMP frames of one message: ``(data (n, MTU) uint8, length (n,)
    int32, offset (n,) int64)``, SYN on every segment, EOM on the last."""
    nbytes = len(msg)
    n = max(1, -(-nbytes // payload))
    offset = np.arange(n, dtype=np.int64) * payload
    plen = np.minimum(payload, nbytes - offset)
    data = np.zeros((n, MTU), np.uint8)
    data[:, 0:6] = np.arange(6, dtype=np.uint8) + 0x10
    data[:, 6:12] = np.arange(6, dtype=np.uint8) + 0x20
    _put(data, 12, 0x0800, 2)
    data[:, 14] = 0x45
    _put(data, 16, 20 + 8 + 10 + plen, 2)
    _put(data, 18, 1, 2)
    data[:, 22] = 64
    data[:, 23] = 17
    _put(data, 26, 0x0A000001, 4)
    _put(data, 30, 0x0A000002, 4)
    _put(data, 24, _ip_checksum(data[:, 14:34]), 2)
    _put(data, 34, 9999, 2)
    _put(data, 36, port, 2)
    _put(data, 38, 8 + 10 + plen, 2)
    flags = np.full(n, FLAG_SYN, np.int64)
    flags[-1] |= FLAG_EOM
    _put(data, SLMP_FLAGS, flags, 2)
    _put(data, SLMP_MSGID, msg_id, 4)
    _put(data, SLMP_OFFSET, offset, 4)
    padded = np.zeros(n * payload, np.uint8)
    padded[:nbytes] = msg
    body = padded.reshape(n, payload)
    data[:, SLMP_PAYLOAD:SLMP_PAYLOAD + payload] = body
    for i in np.flatnonzero(plen < payload):
        data[i, SLMP_PAYLOAD + plen[i]:] = 0
    length = (SLMP_PAYLOAD + plen).astype(np.int32)
    return data, length, offset


def read_field(rows: np.ndarray, off: int, nbytes: int) -> np.ndarray:
    """A big-endian field of each row of (n, >= off + nbytes) bytes."""
    out = np.zeros(rows.shape[0], np.int64)
    for i in range(nbytes):
        out = (out << 8) | rows[:, off + i].astype(np.int64)
    return out
