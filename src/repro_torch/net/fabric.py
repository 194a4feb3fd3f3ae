"""The fabric: N nodes wired together through lossy links, MAC-routed;
PyTorch port of ``repro.net.fabric``.

Every node owns one *ingress link*.  A frame leaving any node is routed
by destination MAC onto the target node's ingress link, where the link
model applies loss / duplication / latency / reordering; ``latency``
ticks later the frame surfaces in the target's ingress batch.  One
:meth:`Fabric.tick` advances every node by one NIC step plus one link
round.

**Uniform path.** When every link shares one config and every node one
batch size, the link states are stacked on the device as (N, CAP, MTU):
one ``pop`` drains all N links, one read brings the validity of the
delivered lanes to the host, each busy node's NIC steps on its rows of
the popped batch where they lie, and all routed traffic lands through
one ``push`` with ``keys = split(sub, N)`` after ``key, sub =
split(key)`` (every node consumes its key, busy or not).  Nodes whose
link delivered nothing skip the NIC step (``Node.tick_idle``).
Heterogeneous ``link_cfgs`` / batch sizes take the per-link loop, which
steps every node's NIC every tick and splits the key once per link that
has frames, as the JAX package does.

The whole state (NIC states, link states, host-engine counters, the
clock, the key) is captured by :meth:`checkpoint` and restored by
:meth:`restore`; :func:`snapshot_to_numpy` / :func:`snapshot_from_numpy`
carry a checkpoint to and from plain arrays, in which form one taken
from the JAX package's fabric restores into this one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import packet as pkt
from repro_torch.core import spin_nic
from repro_torch.net import link as linklib
from repro_torch.net import prng
from repro_torch.net.node import Node


class Fabric:
    def __init__(self, nodes: Sequence[Node],
                 link_cfg: linklib.LinkConfig = linklib.LinkConfig(),
                 link_cfgs: Optional[Sequence[linklib.LinkConfig]] = None,
                 seed: int = 0, device="cuda"):
        """``link_cfgs`` (one per node, ingress side) overrides the shared
        ``link_cfg``.  Links, the key and every node's NIC live on
        ``device``."""
        self.device = resolve_device(device)
        self.nodes: List[Node] = list(nodes)
        for n in self.nodes:
            if n.device != self.device:
                raise ValueError(f"node {n.name} is on {n.device}, the "
                                 f"fabric on {self.device}")
        cfgs = list(link_cfgs) if link_cfgs is not None else \
            [link_cfg] * len(self.nodes)
        assert len(cfgs) == len(self.nodes)
        self.links = [linklib.Link(c, self.device) for c in cfgs]
        self.key = prng.PRNGKey(seed, self.device)
        self.now = 0
        self.unroutable = 0
        self.host_reads = 0      # device-to-host reads of the fabric's own
        # (N, 6) MAC matrix for the vectorized routing compare
        self._mac_mat = np.stack(
            [np.frombuffer(n.mac, np.uint8) for n in self.nodes])
        # uniform path: identical link cfgs + identical node batches
        self._uniform = (len(set(cfgs)) == 1
                         and len({n.batch for n in self.nodes}) == 1)
        if self._uniform:
            self._cfg0 = cfgs[0]
            self._batch0 = self.nodes[0].batch
        self._init_links()

    def _init_links(self) -> None:
        states = [l.init_state() for l in self.links]
        if self._uniform:
            self._stack = linklib.stack(states)
            self.link_states = None
        else:
            self._stack = None
            self.link_states = states

    # ---------------------------------------------------------------- tick
    def tick(self) -> None:
        if self._uniform:
            self._tick_batched()
        else:
            self._tick_loop()
        self.now += 1

    def _route(self, frames: List[np.ndarray],
               outbound: List[List[np.ndarray]]) -> None:
        """Vectorized MAC routing: match every frame's destination MAC
        against the node matrix in one compare."""
        if not frames:
            return
        dst6 = np.stack([f[pkt.ETH_DST:pkt.ETH_DST + 6] for f in frames])
        hit = (dst6[:, None, :] == self._mac_mat[None, :, :]).all(-1)
        dest = hit.argmax(1)
        ok = hit.any(1)
        self.unroutable += int((~ok).sum())
        for i in np.flatnonzero(ok):
            outbound[dest[i]].append(frames[i])

    def _tick_batched(self) -> None:
        now = self.now
        self._stack, ing = linklib.pop(self._stack, now, self._batch0)
        # one host read for the whole fabric; busy nodes step on their
        # rows of the popped batch on the device
        busy = ing.valid.any(1).cpu().numpy()
        self.host_reads += 1
        outbound: List[List[np.ndarray]] = [[] for _ in self.nodes]
        for i, node in enumerate(self.nodes):
            if busy[i]:
                frames = node.tick(pkt.PacketBatch(
                    ing.data[i], ing.length[i], ing.valid[i]), now)
            else:
                frames = node.tick_idle(now)
            self._route(frames, outbound)
        self._flush_outbound(outbound)

    def _flush_outbound(self, outbound: List[List[np.ndarray]]) -> None:
        """Admit routed per-node egress onto all links in one push,
        stacked to (N, P, MTU) with P a power of two, as the JAX package
        pads (the draws' shapes are part of the stream)."""
        counts = [len(o) for o in outbound]
        if not any(counts):
            return
        n_nodes = len(self.nodes)
        p = 1 << max(0, (max(counts) - 1).bit_length())
        data = np.zeros((n_nodes, p, pkt.MTU), np.uint8)
        length = np.zeros((n_nodes, p), np.int32)
        ok = np.zeros((n_nodes, p), bool)
        for j, frames in enumerate(outbound):
            for k, f in enumerate(frames):
                data[j, k, :len(f)] = f
                length[j, k] = len(f)
                ok[j, k] = True
        self.key, sub = prng.split(self.key)
        keys = prng.split(sub, n_nodes)
        self._stack = linklib.push(
            self._cfg0, self._stack, keys,
            pkt.PacketBatch.from_numpy(data, length, ok, self.device),
            self.now)

    def _tick_loop(self) -> None:
        """Per-link path for heterogeneous link configs/batches."""
        now = self.now
        outbound: List[List[np.ndarray]] = [[] for _ in self.nodes]
        for i, node in enumerate(self.nodes):
            self.link_states[i], ingress = self.links[i].pop(
                self.link_states[i], now, node.batch)
            frames = node.tick(ingress, now)
            self._route(frames, outbound)
        for j, frames in enumerate(outbound):
            if not frames:
                continue
            n = 1 << max(0, (len(frames) - 1).bit_length())
            self.key, sub = prng.split(self.key)
            self.link_states[j] = self.links[j].push(
                self.link_states[j], sub,
                pkt.stack_frames(frames, n=n, device=self.device), now)

    def _occupied(self) -> bool:
        self.host_reads += 1
        if self._uniform:
            return bool(self._stack.occupied.any())
        return any(bool(s.occupied.any()) for s in self.link_states)

    def run(self, max_ticks: int = 10_000, until=None) -> int:
        """Tick until ``until()`` (default: every node's engines done and
        all links drained) or ``max_ticks``.  Returns ticks executed."""
        if until is None:
            def until():
                return all(n.done for n in self.nodes) \
                    and not self._occupied()
        t0 = self.now
        while self.now - t0 < max_ticks and not until():
            self.tick()
        return self.now - t0

    def reset(self, seed: int = 0) -> None:
        """Fresh links/clock/key (node NIC states reset via Node.reset)."""
        self._init_links()
        self.key = prng.PRNGKey(seed, self.device)
        self.now = 0
        self.unroutable = 0

    # ---------------------------------------------------------- observability
    def node(self, name: str) -> Node:
        return next(n for n in self.nodes if n.name == name)

    def _per_link_states(self) -> List[linklib.LinkState]:
        if self._uniform:
            return [self._stack[i] for i in range(len(self.nodes))]
        return self.link_states

    def link_stats(self) -> List[dict]:
        if self._uniform:
            # one transfer for the whole fabric
            cols = torch.stack([getattr(self._stack, k)
                                for k in linklib.COUNTERS]).cpu().numpy()
            return [{k: int(cols[j, i])
                     for j, k in enumerate(linklib.COUNTERS)}
                    for i in range(len(self.nodes))]
        return [l.stats(s) for l, s in zip(self.links, self.link_states)]

    def stats(self) -> dict:
        """Fabric-wide health: unroutable frames plus per-link wire and
        stall counters."""
        links = self.link_stats()
        totals = {f"{k}_total": sum(l[k] for l in links)
                  for k in ("lost", "overflowed", "deferred", "delivered")}
        return dict(unroutable=self.unroutable, links=links, **totals)

    # ------------------------------------------------------------ checkpoint
    def checkpoint(self) -> dict:
        return dict(
            now=self.now,
            key=self.key.clone(),
            unroutable=self.unroutable,
            links=[s.clone() for s in self._per_link_states()],
            nodes=[n.snapshot() for n in self.nodes],
        )

    def restore(self, snap: dict) -> None:
        self.now = snap["now"]
        self.key = snap["key"].clone()
        self.unroutable = snap["unroutable"]
        if self._uniform:
            self._stack = linklib.stack(snap["links"])
        else:
            self.link_states = [s.clone() for s in snap["links"]]
        for n, s in zip(self.nodes, snap["nodes"]):
            n.restore(s)


# ------------------------------------------------------------ carrying state
def _flat(obj, prefix="") -> Dict[str, np.ndarray]:
    """A NIC state as the flat dict of ``NICState.to_numpy``: from that
    dict itself, or from a (nested) dataclass with array leaves, such as
    the JAX package's ``NICState`` after ``np.asarray`` of every leaf."""
    if isinstance(obj, dict):
        return {prefix + k: v for k, v in obj.items()}
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = np.asarray(v)
    return out


def snapshot_to_numpy(snap: dict) -> dict:
    """A :meth:`Fabric.checkpoint` with every tensor as numpy: ``key`` as
    its two u32 words (uint32), each link as a dict of its fields, each
    node's ``nic`` as the flat dict of ``NICState.to_numpy``."""
    return dict(
        now=snap["now"],
        key=snap["key"].cpu().numpy().astype(np.uint32),
        unroutable=snap["unroutable"],
        links=[s.to_numpy() for s in snap["links"]],
        nodes=[dict(nic=n["nic"].to_numpy(), engines=n["engines"],
                    completions=list(n["completions"]))
               for n in snap["nodes"]])


def snapshot_from_numpy(snap: dict, device="cuda") -> dict:
    """Inverse of :func:`snapshot_to_numpy`, onto ``device``.  It also
    takes a JAX ``Fabric.checkpoint()`` converted leaf by leaf with
    ``np.asarray`` (the key is then its two u32 words)."""
    dev = resolve_device(device)
    return dict(
        now=int(snap["now"]),
        key=torch.as_tensor(np.asarray(snap["key"]).astype(np.int64),
                            device=dev),
        unroutable=int(snap["unroutable"]),
        links=[linklib.LinkState.from_numpy(s, dev) for s in snap["links"]],
        nodes=[dict(nic=spin_nic.NICState.from_numpy(_flat(n["nic"]), dev),
                    engines=n["engines"],
                    completions=list(n["completions"]))
               for n in snap["nodes"]])
