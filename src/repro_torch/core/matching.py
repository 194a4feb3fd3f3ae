"""Execution contexts and the FPsPIN matching engine (paper §IV, block 1);
PyTorch port of ``repro.core.matching``.

A *rule* is ``(idx, mask, start, end)``: it matches a packet iff the 32-bit
big-endian word at byte index ``4*idx .. 4*idx+3``, AND-ed with ``mask``,
lies in ``[start, end]``.  Three rules are combined with AND or OR to decide
whether a packet belongs to an execution context; a fourth rule (same
format) marks the packet as end-of-message (EOM).  The rule and ruleset
data model is plain Python/numpy, copied from the JAX package; the batched
evaluation is kernel K1 in :mod:`repro_torch.kernels.matcher`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import packet as pkt
from repro_torch.kernels.matcher import ops as matcher_ops

MODE_AND = 0
MODE_OR = 1
RULES_PER_SET = 4            # 3 match rules + 1 EOM rule (paper §IV-C)
RULE_FIELDS = 4              # idx, mask, start, end


@dataclasses.dataclass(frozen=True)
class Rule:
    idx: int                 # 32-bit word index (byte offset / 4)
    mask: int
    start: int
    end: int

    def as_row(self) -> np.ndarray:
        return np.array([self.idx, self.mask, self.start, self.end],
                        np.uint32)


# Predefined rules, mirroring fpspin.h ------------------------------------
def RULE_FALSE() -> Rule:
    # never matches: empty range on a masked-out word
    return Rule(idx=0, mask=0, start=1, end=0)


def RULE_TRUE() -> Rule:
    return Rule(idx=0, mask=0, start=0, end=0)


def RULE_IP() -> Rule:
    # ethertype == 0x0800: bytes 12:14 live in word 3 (bytes 12..15), top half
    return Rule(idx=3, mask=0xFFFF0000, start=0x08000000, end=0x08000000)


def RULE_IP_PROTO(proto: int) -> Rule:
    # IP proto is byte 23 -> word 5 (bytes 20..23), lowest byte
    return Rule(idx=5, mask=0x000000FF, start=proto, end=proto)


def RULE_ICMP_ECHO_REQ() -> Rule:
    # Listing 2: byte 34 == 8 -> word 8 (bytes 32..35), mask 0xff00 on the
    # upper half-word... byte 34 is the third byte of word 8 -> bits 15:8.
    return Rule(idx=8, mask=0x0000FF00, start=0x0800, end=0x0800)


def RULE_UDP_DPORT(port: int) -> Rule:
    # UDP dst port bytes 36:38 -> word 9 (bytes 36..39), top half
    return Rule(idx=9, mask=0xFFFF0000, start=port << 16, end=port << 16)


def RULE_SLMP_EOM() -> Rule:
    # SLMP flags u16 at bytes 42:44 -> word 10 holds bytes 40..43; flags'
    # first byte (42) sits at bits 15:8, second (43) at bits 7:0.  EOM bit
    # (0x0004) is in the low byte => match (word & 0x4) == 0x4.
    return Rule(idx=10, mask=pkt.SLMP_FLAG_EOM, start=pkt.SLMP_FLAG_EOM,
                end=pkt.SLMP_FLAG_EOM)


@dataclasses.dataclass(frozen=True)
class Ruleset:
    """``fpspin_ruleset_t``: mode + 3 match rules + 1 EOM rule."""
    mode: int
    rules: Sequence[Rule]            # exactly 3
    eom: Rule

    def __post_init__(self):
        assert len(self.rules) == RULES_PER_SET - 1, "need exactly 3 rules"

    def as_array(self) -> np.ndarray:
        rows = [r.as_row() for r in self.rules] + [self.eom.as_row()]
        return np.stack(rows).astype(np.uint32)


def ruleset_none() -> Ruleset:
    """Matches nothing: every frame forwards to the Corundum/host datapath.
    Used by fabric nodes whose traffic is all host-side (e.g. senders)."""
    return Ruleset(mode=MODE_AND,
                   rules=[RULE_FALSE(), RULE_FALSE(), RULE_FALSE()],
                   eom=RULE_FALSE())


def ruleset_icmp_echo() -> Ruleset:
    """The paper's Listing-2 example: match ICMP Echo-Requests, no EOM."""
    return Ruleset(mode=MODE_AND,
                   rules=[RULE_IP(), RULE_IP_PROTO(pkt.IPPROTO_ICMP),
                          RULE_ICMP_ECHO_REQ()],
                   eom=RULE_FALSE())


def ruleset_udp_pingpong(port: int = 9999) -> Ruleset:
    return Ruleset(mode=MODE_AND,
                   rules=[RULE_IP(), RULE_IP_PROTO(pkt.IPPROTO_UDP),
                          RULE_UDP_DPORT(port)],
                   eom=RULE_FALSE())


def ruleset_slmp(port: int = 9330) -> Ruleset:
    """Match SLMP segments; EOM taken from the SLMP flags EOM bit."""
    return Ruleset(mode=MODE_AND,
                   rules=[RULE_IP(), RULE_IP_PROTO(pkt.IPPROTO_UDP),
                          RULE_UDP_DPORT(port)],
                   eom=RULE_SLMP_EOM())


@dataclasses.dataclass
class MatchTables:
    """Device-side form of all installed execution contexts' rulesets.

    rules: (C, 4, 4) int64 holding u32  (context, rule, [idx,mask,start,end])
    modes: (C,) int32
    """
    rules: torch.Tensor
    modes: torch.Tensor

    @staticmethod
    def build(rulesets: List[Ruleset], device="cuda") -> "MatchTables":
        dev = resolve_device(device)
        rules = np.stack([rs.as_array() for rs in rulesets]).astype(np.int64)
        modes = np.array([rs.mode for rs in rulesets], np.int32)
        return MatchTables(torch.as_tensor(rules, device=dev),
                           torch.as_tensor(modes, device=dev))

    @property
    def n_ctx(self) -> int:
        return self.rules.shape[0]


def match_batch(batch: pkt.PacketBatch, tables: MatchTables):
    """Run the matching engine (kernel K1 on CUDA, one launch) over a batch.

    Returns ``(ctx_id, eom)``: ctx_id (N,) int32, -1 when no context matches
    (packet is forwarded to the Corundum/host datapath); eom (N,) bool, the
    EOM rule of the winning context.  Lowest-numbered matching context wins
    (priority order, as in hardware rule tables).
    """
    return matcher_ops.match_first(batch.data, tables.rules, tables.modes,
                                   batch.valid)
