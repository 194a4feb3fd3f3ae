"""MPI derived datatypes, committed to index maps: a frozen copy of the
semantics the NIC's datatype handler must follow (paper §V-C, Fig 9).

``commit`` flattens a datatype into its serialization-ordered memory
offsets, ``pack`` gathers a message out of memory, and ``unpack`` writes a
message into memory in serialization order, so that where blocks overlap
the *last* message byte wins (MPI's sequential unpack).  The winner of
each memory byte is computed explicitly (``np.maximum.at`` over message
positions), not left to the order of a fancy assignment.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Primitive:
    nbytes: int

    size = property(lambda self: self.nbytes)
    extent = property(lambda self: self.nbytes)

    def offsets(self, base: int, out: List[Tuple[int, int]]) -> None:
        out.append((base, self.nbytes))


@dataclasses.dataclass(frozen=True)
class Vector:
    """``count`` blocks of ``blocklen`` base elements, ``stride`` in base
    extents (MPI_Type_vector)."""
    count: int
    blocklen: int
    stride: int
    base: object

    @property
    def size(self) -> int:
        return self.count * self.blocklen * self.base.size

    @property
    def extent(self) -> int:
        if self.count == 0:
            return 0
        return ((self.count - 1) * self.stride + self.blocklen) \
            * self.base.extent

    def offsets(self, base: int, out) -> None:
        for i in range(self.count):
            for j in range(self.blocklen):
                self.base.offsets(
                    base + (i * self.stride + j) * self.base.extent, out)


@dataclasses.dataclass(frozen=True)
class HVector:
    """Like ``Vector`` with the stride in bytes (MPI_Type_hvector)."""
    count: int
    blocklen: int
    stride_bytes: int
    base: object

    @property
    def size(self) -> int:
        return self.count * self.blocklen * self.base.size

    @property
    def extent(self) -> int:
        if self.count == 0:
            return 0
        return (self.count - 1) * self.stride_bytes \
            + self.blocklen * self.base.extent

    def offsets(self, base: int, out) -> None:
        for i in range(self.count):
            for j in range(self.blocklen):
                self.base.offsets(
                    base + i * self.stride_bytes + j * self.base.extent, out)


FLOAT = Primitive(4)


def fig9(kind: str):
    """The paper's Fig 9 datatypes: ``simple``, a strided vector of float
    pairs; ``complex``, a vector of vectors whose outer byte stride is
    smaller than the inner extent, so blocks overlap."""
    if kind == "simple":
        return Vector(count=8, blocklen=2, stride=4, base=FLOAT)
    if kind == "complex":
        inner = Vector(count=2, blocklen=3, stride=4, base=FLOAT)
        return HVector(count=5, blocklen=1, stride_bytes=16, base=inner)
    raise ValueError(f"unknown Fig 9 datatype {kind!r}")


def batch_layout(nbytes: int) -> Vector:
    """The training feed's application layout: 256-byte blocks of 64
    floats at a stride of 80 floats (a row-strided array section)."""
    if nbytes % 256:
        raise ValueError(f"{nbytes} bytes is not a multiple of 256")
    return Vector(count=nbytes // 256, blocklen=64, stride=80, base=FLOAT)


@dataclasses.dataclass(frozen=True)
class Committed:
    msg_bytes: int
    mem_bytes: int
    msg_to_mem: np.ndarray     # (msg_bytes,) int64: memory byte of each
    #                            message byte
    winner: np.ndarray         # (mem_bytes,) int64: the message byte that
    #                            lands last in each memory byte, -1 = hole


def commit(ddt, count: int = 1) -> Committed:
    raw: List[Tuple[int, int]] = []
    for i in range(count):
        ddt.offsets(i * ddt.extent, raw)
    msg_to_mem = np.concatenate(
        [np.arange(off, off + n, dtype=np.int64) for off, n in raw])
    mem_bytes = ddt.extent * count
    if msg_to_mem.size != ddt.size * count:
        raise AssertionError("datatype offsets do not cover its size")
    winner = np.full(mem_bytes, -1, np.int64)
    np.maximum.at(winner, msg_to_mem, np.arange(msg_to_mem.size))
    return Committed(msg_to_mem.size, mem_bytes, msg_to_mem, winner)


def pack(c: Committed, mem: np.ndarray) -> np.ndarray:
    """The message: memory bytes in serialization order."""
    return mem[c.msg_to_mem]


def unpack(c: Committed, msg: np.ndarray, mem: np.ndarray) -> np.ndarray:
    """``mem`` with ``msg`` written into it, the last write winning."""
    out = mem.copy()
    hit = c.winner >= 0
    out[hit] = msg[c.winner[hit]]
    return out
