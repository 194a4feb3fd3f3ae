"""MPI Derived Datatypes and the dataloop engine (paper §V-C).

A numpy copy of ``repro.core.ddt``: the port keeps its own.  It adds
``compose_maps``, which folds two gathers by index maps into one.

Supports the constructors the paper uses — ``MPI_Type_contiguous``,
``MPI_Type_vector``, ``MPI_Type_hvector`` — arbitrarily nested, plus
primitive types.  A datatype is *committed* by flattening it into the
serialization-ordered segment list ``[(mem_offset, length), ...]`` (the
MPICH dataloop representation) and then into **byte/element index maps**:

    msg_to_mem[k]  = memory byte offset of message byte k       (pack map)
    mem_to_msg[b]  = message position unpacked into memory byte b, -1=hole

This commit step is the *runtime code specialization* of Schneider et al.
[44] (which the paper names as the expected next optimization): instead of
interpreting the dataloop tree per byte on a 40 MHz HPU, the layout is
compiled once and (un)pack becomes a flat gather executed by the gather
kernel in :mod:`repro_torch.kernels.ddt`.

Overlapping layouts (stride smaller than the block, paper Fig 9 "complex")
are supported: pack repeats the overlapped bytes; unpack applies message
bytes in serialization order, so the *last* occurrence wins — MPI's
sequential-unpack semantics.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


class DDT:
    """Base class. ``size`` = serialized bytes, ``extent`` = memory span."""
    size: int
    extent: int

    def _segments(self, base_off: int, out: List[Tuple[int, int]]) -> None:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Primitive(DDT):
    nbytes: int

    @property
    def size(self) -> int:
        return self.nbytes

    @property
    def extent(self) -> int:
        return self.nbytes

    def _segments(self, base_off, out):
        out.append((base_off, self.nbytes))


MPI_FLOAT = Primitive(4)
MPI_DOUBLE = Primitive(8)
MPI_INT = Primitive(4)
MPI_BYTE = Primitive(1)


@dataclasses.dataclass(frozen=True)
class Contiguous(DDT):
    count: int
    base: DDT

    @property
    def size(self):
        return self.count * self.base.size

    @property
    def extent(self):
        return self.count * self.base.extent

    def _segments(self, base_off, out):
        for i in range(self.count):
            self.base._segments(base_off + i * self.base.extent, out)


@dataclasses.dataclass(frozen=True)
class Vector(DDT):
    """count blocks of blocklen base elements, stride in base-extents."""
    count: int
    blocklen: int
    stride: int
    base: DDT

    @property
    def size(self):
        return self.count * self.blocklen * self.base.size

    @property
    def extent(self):
        if self.count == 0:
            return 0
        return ((self.count - 1) * self.stride + self.blocklen) \
            * self.base.extent

    def _segments(self, base_off, out):
        for i in range(self.count):
            for j in range(self.blocklen):
                self.base._segments(
                    base_off + (i * self.stride + j) * self.base.extent, out)


@dataclasses.dataclass(frozen=True)
class HVector(DDT):
    """Like Vector but the stride is given in bytes (MPI_Type_hvector)."""
    count: int
    blocklen: int
    stride_bytes: int
    base: DDT

    @property
    def size(self):
        return self.count * self.blocklen * self.base.size

    @property
    def extent(self):
        if self.count == 0:
            return 0
        return (self.count - 1) * self.stride_bytes \
            + self.blocklen * self.base.extent

    def _segments(self, base_off, out):
        for i in range(self.count):
            for j in range(self.blocklen):
                self.base._segments(
                    base_off + i * self.stride_bytes + j * self.base.extent,
                    out)


# ------------------------------------------------------------------ commit
def segments(ddt: DDT, count: int = 1) -> List[Tuple[int, int]]:
    """Flatten ``count`` instances into merged (offset, length) segments in
    serialization order (the dataloop contig-merge optimization)."""
    raw: List[Tuple[int, int]] = []
    for i in range(count):
        ddt._segments(i * ddt.extent, raw)
    merged: List[Tuple[int, int]] = []
    for off, ln in raw:
        if merged and merged[-1][0] + merged[-1][1] == off:
            merged[-1] = (merged[-1][0], merged[-1][1] + ln)
        else:
            merged.append((off, ln))
    return merged


@dataclasses.dataclass(frozen=True)
class CommittedDDT:
    """Index-map ("specialized") form of `count` instances of a datatype."""
    ddt: DDT
    count: int
    msg_bytes: int                 # serialized message size
    mem_bytes: int                 # memory extent covered
    msg_to_mem: np.ndarray         # (msg_bytes,) int32
    mem_to_msg: np.ndarray         # (mem_bytes,) int32, -1 = hole
    n_segments: int


def commit(ddt: DDT, count: int = 1) -> CommittedDDT:
    segs = segments(ddt, count)
    msg_bytes = ddt.size * count
    mem_bytes = ddt.extent * count
    msg_to_mem = np.empty(msg_bytes, np.int32)
    k = 0
    for off, ln in segs:
        msg_to_mem[k:k + ln] = np.arange(off, off + ln, dtype=np.int32)
        k += ln
    assert k == msg_bytes, (k, msg_bytes)
    mem_to_msg = np.full(mem_bytes, -1, np.int32)
    # serialization order: later message bytes overwrite earlier on overlap
    mem_to_msg[msg_to_mem] = np.arange(msg_bytes, dtype=np.int32)
    return CommittedDDT(ddt=ddt, count=count, msg_bytes=msg_bytes,
                        mem_bytes=mem_bytes, msg_to_mem=msg_to_mem,
                        mem_to_msg=mem_to_msg, n_segments=len(segs))


def element_maps(c: CommittedDDT, elem_bytes: int = 4):
    """Element-granular maps (all offsets must be elem-aligned) for the
    gather kernel fast path.  Returns (pack_idx, unpack_idx) int32 arrays:
    message[i] = mem[pack_idx[i]];  mem[j] = message[unpack_idx[j]] | hole.
    """
    if c.msg_bytes % elem_bytes or c.mem_bytes % elem_bytes:
        raise ValueError("size not element-aligned")
    m2m = c.msg_to_mem.reshape(-1, elem_bytes)
    if (np.diff(m2m, axis=1) != 1).any() or (m2m[:, 0] % elem_bytes).any():
        raise ValueError("layout not element-aligned")
    pack_idx = (m2m[:, 0] // elem_bytes).astype(np.int32)
    unpack = c.mem_to_msg.reshape(-1, elem_bytes)
    first = unpack[:, 0]
    unpack_idx = np.where(first >= 0, first // elem_bytes, -1).astype(np.int32)
    return pack_idx, unpack_idx


def compose_maps(outer: torch.Tensor, inner: torch.Tensor, n_src: int
                 ) -> torch.Tensor:
    """The one index map that does two gathers, for a source of ``n_src``
    elements and one fill value at both levels:
    ``gather(src, m) == gather(gather(src, inner), outer)``, bit for bit,
    under the gather's rules (a negative index yields the fill, an index
    past the end reads the last element).  ``outer`` indexes the
    ``len(inner)`` elements of the first gather's result.  Returns int32,
    shaped as ``outer``, -1 where either level yields the fill."""
    mid = inner[outer.to(torch.int64).clamp(0, inner.shape[0] - 1)]
    m = torch.where(outer >= 0, mid.to(torch.int64), -1)
    return torch.where(m >= 0, m.clamp(max=n_src - 1), -1).to(torch.int32)


# ------------------------------------------------------- paper Fig 9 types
def simple_ddt() -> DDT:
    """Fig 9 "simple": a strided vector of float pairs (gaps, no overlap)."""
    return Vector(count=8, blocklen=2, stride=4, base=MPI_FLOAT)


def complex_ddt() -> DDT:
    """Fig 9 "complex": nested vector-of-vectors with overlapping blocks
    (outer hvector stride < inner extent => data repeats in the message)."""
    inner = Vector(count=2, blocklen=3, stride=4, base=MPI_FLOAT)
    return HVector(count=5, blocklen=1, stride_bytes=16, base=inner)


# ------------------------------------------------------------ numpy oracle
def pack_np(c: CommittedDDT, mem: np.ndarray) -> np.ndarray:
    """Serialize: message bytes gathered from memory (numpy oracle)."""
    return mem[c.msg_to_mem]


def unpack_np(c: CommittedDDT, msg: np.ndarray, mem: np.ndarray
              ) -> np.ndarray:
    """De-serialize in serialization order (last write wins on overlap)."""
    out = mem.copy()
    out[c.msg_to_mem] = msg
    return out
