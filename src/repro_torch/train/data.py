"""Packetized training-data pipeline, the paper's §V-C as a data layer;
PyTorch port of ``repro.train.data``.

The training corpus arrives the way FPsPIN receives it: as **SLMP messages
whose payloads are MPI-DDT-packed tensors**.  The pipeline has two halves:

* host half (numpy + background thread, copied from the JAX package):
  synthesizes the token stream, lays it out in a non-contiguous
  "application buffer" described by an MPI datatype, packs it, segments it
  into SLMP frames, and hands raw packet arrays to the device;
* device half (``SpinIngest``): match (kernel K1), SLMP offset parsing and
  reassembly, and one gather (kernel K2) from the message to the tokens by
  the committed-DDT unpack map composed with the token map,
  double-buffered against the train step (core/overlap.py).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, trace
from repro_torch.core import ddt as ddtlib
from repro_torch.core import matching
from repro_torch.core import packet as pkt
from repro_torch.core.scatter import scatter_set_
from repro_torch.kernels.ddt import ops as ddt_ops


# --------------------------------------------------------- synthetic corpus
@dataclasses.dataclass
class SyntheticCorpus:
    """Deterministic bigram-ish token stream (learnable structure)."""
    vocab: int
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # each token deterministically prefers a successor: t -> perm[t]
        self.perm = rng.permutation(self.vocab)

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        first = rng.integers(0, self.vocab, size=(batch, 1))
        toks = [first]
        cur = first
        for _ in range(seq):
            follow = self.perm[cur]
            noise = rng.integers(0, self.vocab, size=cur.shape)
            use_noise = rng.random(cur.shape) < 0.25
            cur = np.where(use_noise, noise, follow)
            toks.append(cur)
        full = np.concatenate(toks, axis=1)          # (B, seq+1)
        return full.astype(np.int32)


# ---------------------------------------------------------- sender (host)
@dataclasses.dataclass
class PacketizedBatch:
    """Raw packet tensors for one training batch (device-ready)."""
    data: np.ndarray       # (n_packets, MTU) uint8
    length: np.ndarray     # (n_packets,) int32
    valid: np.ndarray      # (n_packets,) bool
    tokens_shape: Tuple[int, int]


def _batch_ddt(nbytes: int) -> ddtlib.DDT:
    """The datatype describing the application's strided batch layout:
    a vector of 256-byte blocks with 64-byte gaps (a typical row-strided
    array section).  nbytes must be a multiple of 256."""
    assert nbytes % 256 == 0
    return ddtlib.Vector(count=nbytes // 256, blocklen=64, stride=80,
                         base=ddtlib.MPI_FLOAT)


class PacketizedPipeline:
    """Host half: corpus -> DDT pack -> SLMP segments -> packet tensors."""

    def __init__(self, vocab: int, batch: int, seq: int, port: int = 9332,
                 seed: int = 0, payload: int = pkt.MAX_SLMP_PAYLOAD):
        self.corpus = SyntheticCorpus(vocab, seed)
        self.batch, self.seq = batch, seq
        self.port = port
        self.payload = payload
        msg_bytes = batch * (seq + 1) * 4
        pad = (-msg_bytes) % 256
        self.msg_bytes = msg_bytes + pad
        self.ddt = _batch_ddt(self.msg_bytes)
        self.committed = ddtlib.commit(self.ddt, count=1)
        self.n_packets = (self.msg_bytes + payload - 1) // payload
        # device-side unpack index map (element granular, 4-byte tokens)
        pack_idx, unpack_idx = ddtlib.element_maps(self.committed, 4)
        self.pack_idx = pack_idx            # msg elem -> mem elem
        self.unpack_idx = unpack_idx        # mem elem -> msg elem
        self.mem_elems = self.committed.mem_bytes // 4

    def packets_for_step(self, step: int) -> PacketizedBatch:
        toks = self.corpus.batch(step, self.batch, self.seq)   # (B, S+1)
        flat = np.zeros(self.msg_bytes // 4, np.int32)
        flat[: toks.size] = toks.reshape(-1)
        # application buffer: tokens scattered at their DDT memory offsets
        mem = np.zeros(self.mem_elems, np.int32)
        mem[self.pack_idx] = flat                              # app layout
        # sender-side pack (serialization) — gather by the pack map
        message = mem[self.pack_idx].view(np.uint8)            # packed msg
        frames = []
        for s in range(self.n_packets):
            off = s * self.payload
            seg = message[off: off + self.payload]
            flags = pkt.SLMP_FLAG_EOM if s == self.n_packets - 1 else 0
            frames.append(pkt.make_slmp(step & 0x0FFFFFFF, off, flags,
                                        np.asarray(seg), dport=self.port))
        data, length, valid = pkt.stack_frames_np(frames, n=self.n_packets)
        return PacketizedBatch(data, length, valid, toks.shape)


# --------------------------------------------------------- device ingest
class SpinIngest:
    """Device half: packets -> token batch, on ``device`` (default CUDA).

    This is the sPIN offload: U32 match (SLMP ruleset, kernel K1),
    per-packet offset parse, payload scatter into the message buffer (SLMP
    reassembly; a repeated message offset takes the last packet's byte),
    then one gather (kernel K2) of the tokens out of the message.  The JAX
    package gathers twice, the committed-DDT unpack into the application
    buffer and the tokens back out of it; both maps are fixed, so
    ``tok_idx`` composes them once, cut to the tokens returned, and the
    buffer is never built.
    """

    def __init__(self, pipeline: PacketizedPipeline, device="cuda"):
        self.pl = pipeline
        self.device = resolve_device(device)
        self.tables = matching.MatchTables.build(
            [matching.ruleset_slmp(pipeline.port)], device=self.device)
        n_tok = pipeline.batch * (pipeline.seq + 1)
        self.tok_idx = ddtlib.compose_maps(
            torch.as_tensor(pipeline.pack_idx[:n_tok]),
            torch.as_tensor(pipeline.unpack_idx),
            pipeline.msg_bytes // 4).to(self.device)

    def ingest(self, batch: pkt.PacketBatch) -> Dict[str, torch.Tensor]:
        """Traced as ``ingest.call`` with ``ingest.match``,
        ``ingest.reassemble`` and ``ingest.gather`` inside."""
        with trace.span("ingest.call"):
            return self._ingest(batch)

    def _ingest(self, batch: pkt.PacketBatch) -> Dict[str, torch.Tensor]:
        pl = self.pl
        data, length = batch.data, batch.length
        with trace.span("ingest.match"):
            ctx, _eom = matching.match_batch(batch, self.tables)
            live = batch.valid & (ctx == 0)
        with trace.span("ingest.reassemble"):
            offsets = pkt.u32_to_i32(pkt.read_u32(data, pkt.SLMP_OFFSET))
            plen = length - pkt.SLMP_PAYLOAD
            lane = torch.arange(pkt.MTU, dtype=torch.int32,
                                device=data.device)
            msg_pos = offsets[:, None] + (lane - pkt.SLMP_PAYLOAD)[None, :]
            ok = live[:, None] & (lane >= pkt.SLMP_PAYLOAD)[None, :] \
                & ((lane - pkt.SLMP_PAYLOAD)[None, :] < plen[:, None])
            dst = torch.where(ok, msg_pos, pl.msg_bytes)
            msg = torch.zeros((pl.msg_bytes,), dtype=torch.uint8,
                              device=data.device)
            scatter_set_(msg, dst, data)
        # DDT unpack into the app buffer and the token gather, as one
        with trace.span("ingest.gather"):
            toks = ddt_ops.gather(msg.view(torch.int32), self.tok_idx)
            toks = toks.reshape(pl.batch, pl.seq + 1)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __call__(self, raw: PacketizedBatch) -> Dict[str, torch.Tensor]:
        return self.ingest(pkt.PacketBatch.from_numpy(
            raw.data, raw.length, raw.valid, device=self.device))


def prefetch_iterator(pipeline: PacketizedPipeline, steps: int,
                      depth: int = 2) -> Iterator[PacketizedBatch]:
    """Background-thread host prefetch (overlaps packet synthesis with
    device compute — the host half of the paper's overlap story)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        for i in range(steps):
            q.put(pipeline.packets_for_step(i))
        q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
