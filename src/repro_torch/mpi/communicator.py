"""The Communicator: N MPI ranks as nodes of a lossy fabric; PyTorch port
of ``repro.mpi.communicator``, with a ``device`` (default ``"cuda"``) on
which the NIC contexts, their tables, the NIC states and the links live.

Builds one shared :class:`~repro_torch.core.spin_nic.SpinNIC` (every rank
runs identical execution contexts — eager staging + DDT-unpack offload —
so the datapath and its tables are built once for the whole job), wires
one :class:`MpiHostEngine` per rank into a
:class:`~repro_torch.net.fabric.Fabric`, and maps rank *i* to MAC
``node_mac(i)``.  NICs are cached job-wide by (device, table digest,
geometry): a second communicator over the same committed datatypes
reuses the datapath and its uploaded index maps instead of rebuilding
them.

Progress is explicit, like any discrete-event co-simulation: nonblocking
``isend``/``irecv`` return :class:`Request` handles with ``test``/``wait``,
and :meth:`wait` / :meth:`waitall` / :meth:`run_until` tick the fabric
until they complete.  The blocking ``send``/``recv`` wrappers do the
ticking themselves.  Nonblocking collectives register *plans*
(:mod:`repro_torch.mpi.collectives`) whose reactive state rides the same
request layer.

The whole MPI state — fabric, NIC windows, engines mid-protocol, buffer
pool, and active collective plans — is captured by :meth:`checkpoint` and
revived by :meth:`restore`, which accepts a snapshot taken from a
*different* communicator object (same shape) and returns fresh handles
for the collectives that were in flight.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import apps
from repro_torch.core import ddt as ddtlib
from repro_torch.core import packet as pkt
from repro_torch.core import spin_nic
from repro_torch.mpi import wire
from repro_torch.mpi.datatypes import DatatypeRegistry
from repro_torch.mpi.engine import (ANY_SOURCE, ANY_TAG, MpiHostEngine,
                                    MpiParams, Request)
from repro_torch.net import Fabric, LinkConfig, Node

# Collectives reserve tags at/above this — keep user tags below it.  Each
# plan owns a block of _PLAN_TAG_SPAN tags (one per algorithm round, or
# one per pipeline segment for the segmented long-message algorithms).
COLL_TAG_BASE = 1 << 20
_PLAN_TAG_SPAN = 4096
_PLAN_TAG_SLOTS = 4096


@dataclasses.dataclass(frozen=True)
class MpiConfig:
    """Tunables of the messaging layer (defaults sized for simulation)."""
    eager_threshold: int = 4096      # >= this (packed, typed) → rendezvous
    eager_slots_per_src: int = 4
    eager_slot_bytes: int = 1 << 15
    n_rdv_slots: int = 4
    slot_quarantine: int = 32        # ticks before a freed eager/rdv slot
    #                                  is reused (late duplicate frames)
    mtu_payload: int = 1024
    slmp_window: int = 16
    slmp_timeout: int = 12
    slmp_max_retries: int = 64
    ctl_timeout: int = 16
    ctl_max_retries: int = 400
    batch: int = 16                  # NIC ingress batch per tick
    coll_seg_bytes: int = 16384      # segment size of the large-message
    #                                  collective fast path: vectors above
    #                                  the eager slot travel as committed
    #                                  contiguous chunks of this size over
    #                                  the credit-managed rendezvous path
    #                                  (0 disables segmentation)


class BufferPool:
    """Identity-preserving buffer registry for checkpointable state.

    Collective plans and posted receives reference numpy buffers by id;
    a snapshot stores one copy per id and a restore rebinds every
    reference to the same fresh array — aliasing (a plan reading the
    buffer an in-flight receive will write) survives the round trip.
    """

    def __init__(self):
        self._bufs: Dict[int, np.ndarray] = {}
        self._next = 0

    def adopt(self, arr: np.ndarray) -> int:
        """Register ``arr`` (stored by reference, not copied)."""
        bid = self._next
        self._next += 1
        self._bufs[bid] = arr
        return bid

    def get(self, bid: int) -> np.ndarray:
        return self._bufs[bid]

    def has(self, bid: int) -> bool:
        return bid in self._bufs

    def release(self, bid: int) -> None:
        self._bufs.pop(bid, None)

    def snapshot(self) -> dict:
        return dict(next=self._next,
                    bufs=[(bid, np.array(a))
                          for bid, a in self._bufs.items()])

    def restore(self, snap: dict) -> None:
        self._next = snap["next"]
        self._bufs = {bid: np.array(a) for bid, a in snap["bufs"]}


# Job-wide NIC cache: a SpinNIC holds no per-node mutable state (NICState
# lives in the Node), so communicators with identical context geometry
# and datatype tables share one datapath — and the device index maps
# upload once per job (apps.MPI_CONTEXT_BUILDS stays flat).  The device is
# part of the key: a CPU and a CUDA communicator never share a NIC whose
# tables live on the other device.
_NIC_CACHE: Dict[tuple, spin_nic.SpinNIC] = {}


def clear_nic_cache() -> None:
    _NIC_CACHE.clear()


class PersistentRequest:
    """A reusable operation binding (MPI_Send_init / MPI_Recv_init).

    ``start()`` posts a fresh :class:`Request` for the bound buffer each
    time it is called; the datatype was resolved to its committed id at
    init time, so repeated ``start()`` calls touch neither the commit
    cache nor the NIC context cache (guarded by a regression test).  The
    buffer is bound by reference — like MPI, the caller refills it
    between ``start()`` calls.
    """

    def __init__(self, comm: "Communicator", kind: str, rank: int,
                 buf: np.ndarray, peer: int, tag: int,
                 dtype_id: Optional[int]):
        self.comm = comm
        self.kind = kind                  # "send" | "recv"
        self.rank = rank
        self.buf = buf
        self.peer = peer                  # dest (send) / source (recv)
        self.tag = tag
        self.dtype_id = dtype_id
        self.active: Optional[Request] = None
        self.starts = 0

    def start(self) -> Request:
        assert self.active is None or self.active.done, \
            "persistent request restarted while still in flight"
        self.starts += 1
        if self.kind == "send":
            req = self.comm.isend(self.rank, self.peer, self.buf,
                                  tag=self.tag, datatype=self.dtype_id)
        else:
            req = self.comm.irecv(self.rank, self.buf, source=self.peer,
                                  tag=self.tag)
        self.active = req
        return req

    def wait(self, max_ticks: int = 100_000) -> Request:
        assert self.active is not None, "start() before wait()"
        self.comm.wait(self.active, max_ticks=max_ticks)
        return self.active


class Communicator:
    def __init__(self, n_ranks: int,
                 registry: Optional[DatatypeRegistry] = None,
                 link_cfg: LinkConfig = LinkConfig(latency=2),
                 link_cfgs: Optional[Sequence[LinkConfig]] = None,
                 seed: int = 0, cfg: MpiConfig = MpiConfig(),
                 device="cuda"):
        assert n_ranks >= 1
        self.device = resolve_device(device)
        self.n_ranks = n_ranks
        self.cfg = cfg
        self.registry = registry if registry is not None \
            else DatatypeRegistry()
        # the large-message collective fast path ships vector segments as
        # committed contiguous chunks through the rendezvous path (NIC
        # unpacks them straight into the destination region) — register
        # the chunk type before the registry freezes so the NIC table has
        # it.  A frozen registry that already carries it is reused; a
        # frozen registry without it disables segmentation.
        self.seg_dtype: Optional[int] = None
        if cfg.coll_seg_bytes:
            seg_ddt = ddtlib.Contiguous(cfg.coll_seg_bytes, ddtlib.MPI_BYTE)
            try:
                self.seg_dtype = self.registry.resolve(seg_ddt)
            except KeyError:
                if not self.registry._frozen:
                    self.seg_dtype = self.registry.register(
                        seg_ddt, name="__coll_seg__")
        self.registry.freeze()

        macs = tuple(pkt.node_mac(r) for r in range(n_ranks))
        eager_total = n_ranks * cfg.eager_slots_per_src \
            * cfg.eager_slot_bytes
        rdv_region = max(8, -(-self.registry.max_mem_bytes // 8) * 8)
        host_bytes = eager_total + cfg.n_rdv_slots * rdv_region

        maps = lens = None
        if len(self.registry):
            maps, lens = self.registry.tables()
        nic_key = (str(self.device), n_ranks, cfg.eager_slots_per_src,
                   cfg.eager_slot_bytes, cfg.n_rdv_slots, cfg.batch,
                   rdv_region, host_bytes,
                   None if maps is None else
                   (maps.tobytes(), lens.tobytes()))
        nic = _NIC_CACHE.get(nic_key)
        if nic is None:
            contexts = [apps.make_mpi_eager_context(
                wire.EAGER_PORT,
                n_slots=n_ranks * cfg.eager_slots_per_src,
                slot_bytes=cfg.eager_slot_bytes, host_base=0)]
            if maps is not None:
                contexts.append(apps.make_mpi_ddt_context(
                    maps, lens, region_bytes=rdv_region,
                    n_slots=cfg.n_rdv_slots, port=wire.DATA_PORT,
                    host_base=eager_total, device=self.device))
            nic = spin_nic.SpinNIC(contexts, host_bytes=host_bytes,
                                   batch=cfg.batch, device=self.device)
            _NIC_CACHE[nic_key] = nic

        self.params = MpiParams(
            n_ranks=n_ranks, macs=macs,
            eager_threshold=cfg.eager_threshold,
            eager_slots_per_src=cfg.eager_slots_per_src,
            eager_slot_bytes=cfg.eager_slot_bytes, eager_base=0,
            n_rdv_slots=cfg.n_rdv_slots, rdv_region_bytes=rdv_region,
            rdv_base=eager_total, slot_quarantine=cfg.slot_quarantine,
            mtu_payload=cfg.mtu_payload, slmp_window=cfg.slmp_window,
            slmp_timeout=cfg.slmp_timeout,
            slmp_max_retries=cfg.slmp_max_retries,
            ctl_timeout=cfg.ctl_timeout,
            ctl_max_retries=cfg.ctl_max_retries)

        # one NIC (and one datapath) shared by every rank
        self.nic = nic
        self.pool = BufferPool()
        self._plans: Dict[int, "object"] = {}
        self._next_plan_id = 0
        self.engines: List[MpiHostEngine] = []
        self.nodes: List[Node] = []
        for r in range(n_ranks):
            engine = MpiHostEngine(r, self.registry, self.params,
                                   pool=self.pool)
            node = Node(f"rank{r}", macs[r], nic=self.nic,
                        engines=[engine])
            engine.attach(node)
            self.engines.append(engine)
            self.nodes.append(node)
        self.link_cfg = link_cfg
        self.link_cfgs = list(link_cfgs) if link_cfgs is not None else None
        self.fabric = Fabric(self.nodes, link_cfg=link_cfg,
                             link_cfgs=self.link_cfgs, seed=seed,
                             device=self.device)

    # ------------------------------------------------------------ plumbing
    @property
    def now(self) -> int:
        return self.fabric.now

    def rewire(self, link_cfg: Optional[LinkConfig] = None,
               link_cfgs: Optional[Sequence[LinkConfig]] = None,
               seed: int = 0) -> None:
        """Fresh engines/NIC-states/links (optionally new link configs)
        without recompiling the shared datapath — sweeps reuse one comm."""
        if link_cfg is not None:
            self.link_cfg = link_cfg
            self.link_cfgs = None
        if link_cfgs is not None:
            self.link_cfgs = list(link_cfgs)
        self.pool = BufferPool()
        self._plans = {}
        self._next_plan_id = 0
        self.engines = []
        for r, node in enumerate(self.nodes):
            engine = MpiHostEngine(r, self.registry, self.params,
                                   pool=self.pool)
            node.reset(engines=[engine])
            engine.attach(node)
            self.engines.append(engine)
        self.fabric = Fabric(self.nodes, link_cfg=self.link_cfg,
                             link_cfgs=self.link_cfgs, seed=seed,
                             device=self.device)

    def reset(self, seed: int = 0) -> None:
        self.rewire(seed=seed)

    # ------------------------------------------------------- point-to-point
    def isend(self, src: int, dest: int, data: np.ndarray, tag: int = 0,
              datatype=None) -> Request:
        req = self.engines[src].isend(dest, data, tag=tag,
                                      datatype=datatype)
        req._comm = self
        return req

    def irecv(self, rank: int, buf: np.ndarray, source: int = ANY_SOURCE,
              tag: int = ANY_TAG, buf_id: Optional[int] = None) -> Request:
        req = self.engines[rank].irecv(buf, source=source, tag=tag,
                                       buf_id=buf_id)
        req._comm = self
        return req

    # -------------------------------------------------- persistent requests
    def send_init(self, src: int, dest: int, data: np.ndarray,
                  tag: int = 0, datatype=None) -> "PersistentRequest":
        """MPI_Send_init: bind (buffer, peer, tag, datatype) once; every
        :meth:`PersistentRequest.start` posts a fresh transfer reusing the
        committed datatype plan (resolved here, once) and the job-cached
        NIC contexts — no recommit, no re-upload, no registry lookup on
        the per-iteration path."""
        dtype_id = None if datatype is None \
            else self.registry.resolve(datatype)
        return PersistentRequest(self, "send", src, data, dest, tag,
                                 dtype_id)

    def recv_init(self, rank: int, buf: np.ndarray,
                  source: int = ANY_SOURCE,
                  tag: int = ANY_TAG) -> "PersistentRequest":
        """MPI_Recv_init: the receive-side half of a persistent pair."""
        return PersistentRequest(self, "recv", rank, buf, source, tag,
                                 None)

    def start_all(self, preqs: Sequence["PersistentRequest"]
                  ) -> List[Request]:
        """MPI_Startall over persistent handles."""
        return [p.start() for p in preqs]

    def send(self, src: int, dest: int, data: np.ndarray, tag: int = 0,
             datatype=None, max_ticks: int = 100_000) -> Request:
        req = self.isend(src, dest, data, tag=tag, datatype=datatype)
        self.wait(req, max_ticks=max_ticks)
        return req

    def recv(self, rank: int, buf: np.ndarray, source: int = ANY_SOURCE,
             tag: int = ANY_TAG, max_ticks: int = 100_000) -> Request:
        req = self.irecv(rank, buf, source=source, tag=tag)
        self.wait(req, max_ticks=max_ticks)
        return req

    # -------------------------------------------------------------- progress
    def progress(self, ticks: int = 1) -> None:
        for _ in range(ticks):
            self.fabric.tick()

    def run_until(self, predicate: Callable[[], bool],
                  max_ticks: int = 100_000) -> int:
        """Tick the fabric until ``predicate()`` holds.  Raises on engine
        failure (exhausted retries) or timeout."""
        t0 = self.fabric.now
        while not predicate():
            if self.fabric.now - t0 >= max_ticks:
                raise RuntimeError(
                    f"MPI progress timed out after {max_ticks} ticks; "
                    f"engines: " + "; ".join(
                        f"rank{e.rank} done={e.done} stats={e.stats}"
                        for e in self.engines))
            self.fabric.tick()
            for e in self.engines:
                if e.failed:
                    raise RuntimeError("; ".join(e.errors))
        return self.fabric.now - t0

    def test(self, *reqs: Request) -> bool:
        """MPI_Testall: True iff every request is complete.  Never ticks."""
        return all(r.done for r in reqs)

    def wait(self, *reqs: Request, max_ticks: int = 100_000) -> int:
        return self.waitall(list(reqs), max_ticks=max_ticks)

    def waitall(self, reqs: List[Request],
                max_ticks: int = 100_000) -> int:
        """Wait on a (possibly growing) list of requests — collective
        algorithms append follow-on requests from completion callbacks."""
        ticks = self.run_until(lambda: all(r.done for r in reqs),
                               max_ticks=max_ticks)
        errs = [r.error for r in reqs if r.error]
        if errs:
            raise RuntimeError("; ".join(errs))
        return ticks

    # kept as an alias — collective plans and older call sites use it
    wait_list = waitall

    # ------------------------------------------------------ collective plans
    def _new_plan_slot(self):
        pid = self._next_plan_id
        self._next_plan_id += 1
        tag_base = COLL_TAG_BASE \
            + (pid % _PLAN_TAG_SLOTS) * _PLAN_TAG_SPAN
        return pid, tag_base

    def _register_plan(self, pid: int, plan) -> None:
        self._plans[pid] = plan

    def _unregister_plan(self, pid: int) -> None:
        self._plans.pop(pid, None)

    # --------------------------------------------------------- observability
    def stats(self) -> List[dict]:
        return [dict(e.stats) for e in self.engines]

    def link_stats(self) -> List[dict]:
        return self.fabric.link_stats()

    # ------------------------------------------------------------ checkpoint
    def checkpoint(self) -> dict:
        """Snapshot the whole MPI state: fabric (links, NIC windows, clock,
        PRNG) via its existing checkpoint path — which recurses into every
        engine's closure-free snapshot — plus the buffer pool and every
        active collective plan.  Read-only: the live run is unperturbed."""
        return dict(
            fabric=self.fabric.checkpoint(),
            pool=self.pool.snapshot(),
            plans=[(pid, p.snapshot()) for pid, p in self._plans.items()],
            next_plan_id=self._next_plan_id,
        )

    def restore(self, snap: dict) -> Dict[int, Request]:
        """Revive a checkpoint into *this* communicator (freshly built with
        the same shape, or the original).  Returns fresh collective handles
        keyed by plan id — the collectives that were in flight at snapshot
        time complete on these."""
        from repro_torch.mpi import collectives as coll   # avoid import cycle
        self.pool.restore(snap["pool"])
        self.fabric.restore(snap["fabric"])
        self._next_plan_id = snap["next_plan_id"]
        self._plans = {}
        handles: Dict[int, Request] = {}
        for pid, ps in snap["plans"]:
            plan = coll.PLAN_TYPES[ps["name"]].from_snapshot(self, pid, ps)
            self._plans[pid] = plan
            handles[pid] = plan.request
        # re-attach plan completion callbacks to the live requests the
        # engine snapshots revived (matched by collective token)
        for e in self.engines:
            for req in list(e._reqs.values()):
                req._comm = self
                if req.ctoken is None:
                    continue
                pid, key = req.ctoken
                plan = self._plans.get(pid)
                if plan is not None:
                    req.add_done_callback(
                        lambda q, plan=plan, key=key: plan._step(key, q))
        return handles
