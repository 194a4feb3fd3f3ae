"""The training corpus and the sender's half of the packetized feed: a
frozen copy of what the trainer's ingest must turn back into tokens.

``Corpus.batch(step)`` is a deterministic bigram-ish stream (each token
prefers one successor, a quarter of positions are noise), so the rows of
every step differ.  ``feed`` lays a step's ``(batch, seq + 1)`` tokens out
in the application buffer described by ``ddt.batch_layout``, packs it,
and cuts the message into SLMP frames (no SYN: the trainer's feed is not
ACKed; EOM on the last frame).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bench.ref import ddt, frames


@dataclasses.dataclass
class Corpus:
    vocab: int
    seed: int

    def __post_init__(self):
        self.perm = np.random.default_rng(self.seed).permutation(self.vocab)

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        """(batch, seq + 1) int32 tokens of ``step``."""
        rng = np.random.default_rng([self.seed, step])
        cur = rng.integers(0, self.vocab, size=(batch, 1))
        toks = [cur]
        for _ in range(seq):
            noise = rng.integers(0, self.vocab, size=cur.shape)
            cur = np.where(rng.random(cur.shape) < 0.25, noise,
                           self.perm[cur])
            toks.append(cur)
        return np.concatenate(toks, axis=1).astype(np.int32)


class Packetizer:
    """Tokens -> DDT-packed message -> SLMP frames, as the sender makes
    them."""

    def __init__(self, batch: int, seq: int, port: int):
        self.batch, self.seq, self.port = batch, seq, port
        nbytes = batch * (seq + 1) * 4
        self.msg_bytes = nbytes + (-nbytes) % 256
        c = ddt.commit(ddt.batch_layout(self.msg_bytes))
        # element granular: message element k comes from memory element
        # pack_idx[k] (the layout is 4-byte aligned)
        self.pack_idx = c.msg_to_mem[0::4] // 4
        self.mem_elems = c.mem_bytes // 4
        self.n_frames = -(-self.msg_bytes // frames.MAX_PAYLOAD)

    def feed(self, tokens: np.ndarray, msg_id: int):
        """The frames of one step's tokens: ``(data, length, valid)``."""
        flat = np.zeros(self.msg_bytes // 4, np.int32)
        flat[:tokens.size] = tokens.reshape(-1)
        mem = np.zeros(self.mem_elems, np.int32)
        mem[self.pack_idx] = flat                 # the application buffer
        msg = mem[self.pack_idx].view(np.uint8)   # packed for the wire
        data, length, _ = frames.segment(msg, msg_id & 0x0FFFFFFF,
                                         self.port)
        flags = frames.read_field(data, frames.SLMP_FLAGS, 2) \
            & ~frames.FLAG_SYN
        data[:, frames.SLMP_FLAGS] = (flags >> 8) & 0xFF
        data[:, frames.SLMP_FLAGS + 1] = flags & 0xFF
        return data, length, np.ones(len(length), bool)
