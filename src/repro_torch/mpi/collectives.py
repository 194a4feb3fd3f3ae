"""Collectives composed from point-to-point (MPI Chapter 5 over the fabric).

Every collective is a *plan*: a reactive, whole-communicator state machine
that posts point-to-point requests and advances from their completion
callbacks — the natural shape for a tick-driven fabric, and exactly how
tree collectives overlap under loss (a subtree whose link is clean makes
progress while another subtree retransmits).  The nonblocking entry
points (``ibcast`` / ``ireduce`` / ``iallreduce`` / ``ialltoall`` /
``ialltoallv`` / ``ibarrier``) register the plan with the communicator
and return a :class:`CollRequest` handle supporting ``test``/``wait`` and
mixing freely with p2p handles in ``waitall``; the blocking wrappers keep
their historical signatures by posting and waiting.

Plan state is plain data (numpy arrays, ints, buffer-pool ids — never a
closure), so an in-flight collective checkpoints with the fabric and
restores into a fresh object graph: completion callbacks are re-derived
from each live request's ``ctoken`` and the algorithm resumes where the
snapshot left it.

Algorithms (selected per message size when ``algorithm="auto"``):

  bcast       "binomial"   binomial tree (⌈log₂ n⌉ rounds)
              "pipelined"  binomial tree over fixed-size segments — every
                           relay forwards segment s the moment it lands,
                           so the tree streams (⌈log₂ n⌉ + S − 1 rounds)
  reduce      binomial tree combine toward the root
  allreduce   "rd"     recursive doubling, non-power-of-two ranks folded
                       in by a pre/post exchange — ⌈log₂ n⌉ rounds
              "tree"   binomial reduce + binomial bcast (fewer messages)
              "rab"    Rabenseifner: reduce-scatter (recursive halving)
                       + allgather (recursive doubling) — each rank moves
                       ~2·(n−1)/n vectors instead of ⌈log₂ n⌉, the
                       bandwidth-optimal schedule for large vectors
              "linear" gather + fan-out at the root (n−1 rounds; the
                       baseline the log-step algorithms are measured
                       against)
  alltoall(v) "bruck"  store-and-forward, ⌈log₂ n⌉ rounds of ⌈n/2⌉
                       coalesced blocks (message-count optimal)
              "pairwise"  direct exchange, n−1 messages per rank

**Large-message fast path.**  Any plan message larger than the eager
staging slot is transparently *segmented*: the payload travels as
committed contiguous chunks (``MpiConfig.coll_seg_bytes``) through the
credit-managed rendezvous path, where the NIC's DDT-unpack context
scatters each segment straight into the posted receive region — no
staging-slot cap, and the segments of concurrent collectives pipeline
against the receiver's slot credits.  Handles carry ``rounds`` /
``msgs_total`` / ``bytes_wire`` so benchmarks can attribute wins to the
schedule, not the wire.

Reduction ``op`` must be commutative (np.add / np.maximum / ...): the
log-step schedules combine partial results in rank-dependent order.
Buffers are numpy arrays (any dtype, C-contiguous); messages travel as
raw bytes, so ``op`` runs on the typed views.  Collectives reserve tags
at/above ``COLL_TAG_BASE`` — keep user tags below it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.mpi.communicator import COLL_TAG_BASE, Communicator
from repro_torch.mpi.engine import Request

# ---- algorithm selection thresholds (bytes) ----
# Recursive doubling sends the full vector every round; past this size the
# lower-message-count tree wins.  Past ALLREDUCE_RAB_MIN_BYTES the
# bandwidth term dominates and Rabenseifner's reduce-scatter+allgather
# (2·(n−1)/n vectors on the wire per rank) beats both.  Bruck coalesces
# ~n/2 blocks per send, so it pays only while blocks are small
# (latency-bound regime).  Long broadcasts switch to the pipelined
# segment tree at BCAST_PIPELINE_MIN_BYTES.
ALLREDUCE_RD_MAX_BYTES = 32 * 1024
ALLREDUCE_RAB_MIN_BYTES = 64 * 1024
BCAST_PIPELINE_MIN_BYTES = 64 * 1024
ALLTOALL_BRUCK_MAX_BLOCK = 4 * 1024

# Reduction ops a checkpoint can name (plain-data snapshots store the
# name, not the callable).
OPS: Dict[str, Callable] = {
    "add": np.add, "max": np.maximum, "min": np.minimum,
    "prod": np.multiply,
}


def _op_name(op: Callable) -> Optional[str]:
    for k, v in OPS.items():
        if op is v:
            return k
    return None


def _vrank(r: int, root: int, n: int) -> int:
    return (r - root) % n


def _prank(v: int, root: int, n: int) -> int:
    return (v + root) % n


def _children(v: int, n: int) -> List[int]:
    """Binomial-tree children of virtual rank ``v``."""
    m = 1 if v == 0 else 1 << v.bit_length()
    out = []
    while v + m < n:
        out.append(v + m)
        m <<= 1
    return out


def _parent(v: int) -> int:
    return v - (1 << (v.bit_length() - 1))


def _log2floor(n: int) -> int:
    return n.bit_length() - 1


# rank <-> power-of-two participant mapping for the non-power-of-two fold
# (MPICH scheme: the first 2·rem ranks collapse pairwise into rem
# participants; even ranks sit out after handing their vector to the odd
# neighbour and take the result back in a post phase)
def _fold_newrank(r: int, rem: int) -> int:
    if r < 2 * rem:
        return -1 if r % 2 == 0 else r // 2
    return r - rem


def _fold_realrank(nr: int, rem: int) -> int:
    return 2 * nr + 1 if nr < rem else nr + rem


def _rab_schedule(nr: int, pof2: int, nelems: int) -> List[tuple]:
    """Rabenseifner round schedule for participant ``nr``: reduce-scatter
    by recursive halving, then allgather by recursive doubling in reverse.
    Each entry is ``(phase, partner_nr, (send_lo, send_hi),
    (recv_lo, recv_hi))`` in element offsets; partners always derive the
    same split point (it depends only on the shared higher address bits),
    so the ranges pair up exactly.  Ranges may be empty for tiny vectors."""
    rounds: List[tuple] = []
    hist: List[tuple] = []
    lo, hi = 0, nelems
    mask = pof2 >> 1
    while mask >= 1:
        pn = nr ^ mask
        mid = lo + (hi - lo) // 2
        if nr & mask:
            snd, rcv = (lo, mid), (mid, hi)
            lo = mid
        else:
            snd, rcv = (mid, hi), (lo, mid)
            hi = mid
        rounds.append(("rs", pn, snd, rcv))
        hist.append((pn, snd, rcv))
        mask >>= 1
    # allgather walks the halving tree back up: send what this rank now
    # owns fully reduced (the kept range), receive what it gave away
    for pn, snd, rcv in reversed(hist):
        rounds.append(("ag", pn, rcv, snd))
    return rounds


class CollRequest(Request):
    """Handle for a nonblocking collective: a :class:`Request` whose
    completion is the whole plan's; ``result`` carries the collective's
    return value (allreduce outputs, alltoall receive blocks, ...)."""

    def __init__(self, algorithm: str):
        super().__init__("coll")
        self.algorithm = algorithm
        self.result = None
        self.rounds = 0              # sequential communication rounds
        self.msgs_total = 0          # point-to-point messages posted
        self.bytes_wire = 0          # payload bytes put on the wire
        #                              (incl. segment padding — what the
        #                              fabric actually carries)


# --------------------------------------------------------------- plan base
class Plan:
    """A whole-communicator collective as a reactive state machine.

    Subclasses implement ``start`` (post the first wave of requests) and
    ``on_step`` (advance a rank when one of its requests completes), keep
    *all* algorithm state serializable, and produce ``result()`` when the
    last request drains.  Request↔plan linkage is the serializable step
    key: ``req.ctoken == (plan_id, key)``.
    """

    NAME = "plan"

    def __init__(self, comm: Communicator, pid: int, tag_base: int,
                 algorithm: Optional[str] = None):
        self.comm = comm
        self.pid = pid
        self.tag_base = tag_base
        self.pending = set()
        self.finished = False
        self._depth = 0        # posting re-entrancy depth (self-sends can
        #                        complete synchronously mid-start/on_step)
        self.owned_bids: List[int] = []
        # segmented-transport bookkeeping: base step key -> segments left,
        # and per-segment receive key -> (target bid, scratch bid, byte
        # offset, byte length) — all plain data, checkpoints with the plan
        self._seg_left: Dict[tuple, int] = {}
        self._seg_recv: Dict[tuple, tuple] = {}
        self.request = CollRequest(algorithm or self.NAME)
        self.request._comm = comm

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> None:
        raise NotImplementedError

    def on_step(self, key: tuple, req: Request) -> None:
        pass

    def on_drain(self) -> None:
        self._finish()

    def result(self):
        return None

    # ---- posting helpers -------------------------------------------------
    def _adopt(self, arr: np.ndarray) -> int:
        bid = self.comm.pool.adopt(arr)
        self.owned_bids.append(bid)
        return bid

    def _buf(self, bid: int) -> np.ndarray:
        return self.comm.pool.get(bid)

    def _segmented(self, nbytes: int, a: int, b: int) -> bool:
        """Sender and receiver must agree: a plan message is segmented iff
        it exceeds the eager staging slot, the chunk datatype exists, and
        the endpoints differ (self-delivery never touches a slot)."""
        return (a != b and self.comm.seg_dtype is not None
                and nbytes > self.comm.cfg.eager_slot_bytes)

    def _send(self, src: int, dest: int, data: np.ndarray, key: tuple,
              round_: int = 0) -> None:
        data = np.ascontiguousarray(data)
        nbytes = int(data.nbytes)
        if not self._segmented(nbytes, src, dest):
            if src != dest:
                _check_eager_fit(self.comm, nbytes, "collective message")
                self.request.bytes_wire += nbytes
            req = self.comm.isend(src, dest, data,
                                  tag=self.tag_base + round_)
            self._track(req, key)
            return
        # large-message fast path: committed contiguous chunks through the
        # credit-managed rendezvous, NIC-unpacked into the posted region
        seg = self.comm.cfg.coll_seg_bytes
        u8 = data.reshape(-1).view(np.uint8)
        nseg = -(-nbytes // seg)
        self._seg_left[key] = nseg
        for i in range(nseg):
            ln = min(seg, nbytes - i * seg)
            chunk = np.zeros(seg, np.uint8)
            chunk[:ln] = u8[i * seg:i * seg + ln]
            req = self.comm.isend(src, dest, chunk,
                                  tag=self.tag_base + round_,
                                  datatype=self.comm.seg_dtype)
            self._track(req, ("sg",) + key + (i,))
            self.request.bytes_wire += seg

    def _recv(self, rank: int, bid: int, source: int, key: tuple,
              round_: int = 0) -> None:
        buf = self._buf(bid)
        nbytes = int(buf.nbytes)
        if not self._segmented(nbytes, rank, source):
            req = self.comm.irecv(rank, buf, source=source,
                                  tag=self.tag_base + round_, buf_id=bid)
            self._track(req, key)
            return
        seg = self.comm.cfg.coll_seg_bytes
        nseg = -(-nbytes // seg)
        self._seg_left[key] = nseg
        for i in range(nseg):
            ln = min(seg, nbytes - i * seg)
            sbid = self._adopt(np.zeros(seg, np.uint8))
            skey = ("rg",) + key + (i,)
            self._seg_recv[skey] = (bid, sbid, i * seg, ln)
            req = self.comm.irecv(rank, self._buf(sbid), source=source,
                                  tag=self.tag_base + round_, buf_id=sbid)
            self._track(req, skey)

    def _track(self, req: Request, key: tuple) -> None:
        assert key not in self.pending, f"duplicate plan step {key}"
        self.pending.add(key)
        self.request.msgs_total += 1
        req.ctoken = (self.pid, key)
        req.add_done_callback(lambda q, key=key: self._step(key, q))

    # ---- completion plumbing --------------------------------------------
    def _step(self, key: tuple, req: Request) -> None:
        if self.finished:
            return
        self.pending.discard(key)
        if req.error:
            self._abort(req.error)
            return
        deliver = True
        if key[0] in ("sg", "rg"):
            key = self._seg_step(key)
            deliver = key is not None
        if deliver:
            self._depth += 1
            try:
                self.on_step(key, req)
            finally:
                self._depth -= 1
        # drain only at depth 0: a synchronously-completing self-send must
        # not finish the plan while an outer start()/on_step() is still
        # posting the rest of its wave
        if not self.pending and not self.finished and self._depth == 0:
            self.on_drain()

    def _seg_step(self, key: tuple) -> Optional[tuple]:
        """One segment of a segmented plan message completed: land receive
        chunks in the target buffer; when the last segment of the base
        step drains, return the base key for on_step dispatch."""
        base = tuple(key[1:-1])
        if key[0] == "rg":
            tbid, sbid, off, ln = self._seg_recv.pop(key)
            tview = self._buf(tbid).reshape(-1).view(np.uint8)
            tview[off:off + ln] = self._buf(sbid)[:ln]
            self.comm.pool.release(sbid)
        left = self._seg_left[base] - 1
        if left:
            self._seg_left[base] = left
            return None
        del self._seg_left[base]
        return base

    def _abort(self, err: str) -> None:
        self.finished = True
        for bid in self.owned_bids:
            self.comm.pool.release(bid)
        self.comm._unregister_plan(self.pid)
        self.request._complete(error=err)

    def _finish(self) -> None:
        self.finished = True
        self.request.result = self.result()
        for bid in self.owned_bids:
            self.comm.pool.release(bid)
        self.comm._unregister_plan(self.pid)
        self.request._complete()

    # ---- checkpoint ------------------------------------------------------
    def snapshot(self) -> dict:
        return dict(name=self.NAME, tag_base=self.tag_base,
                    algorithm=self.request.algorithm,
                    rounds=self.request.rounds,
                    msgs_total=self.request.msgs_total,
                    bytes_wire=self.request.bytes_wire,
                    pending=sorted(self.pending),
                    owned_bids=list(self.owned_bids),
                    seg_left=sorted(self._seg_left.items()),
                    seg_recv=sorted(self._seg_recv.items()),
                    state=self._snap_state())

    @classmethod
    def from_snapshot(cls, comm: Communicator, pid: int,
                      snap: dict) -> "Plan":
        plan = cls.__new__(cls)
        Plan.__init__(plan, comm, pid, snap["tag_base"],
                      algorithm=snap["algorithm"])
        plan.request.rounds = snap["rounds"]
        plan.request.msgs_total = snap["msgs_total"]
        plan.request.bytes_wire = snap["bytes_wire"]
        plan.pending = set(tuple(k) for k in snap["pending"])
        plan.owned_bids = list(snap["owned_bids"])
        plan._seg_left = {tuple(k): v for k, v in snap["seg_left"]}
        plan._seg_recv = {tuple(k): tuple(v)
                          for k, v in snap["seg_recv"]}
        plan._restore_state(snap["state"])
        return plan

    def _snap_state(self) -> dict:
        return {}

    def _restore_state(self, state: dict) -> None:
        pass


# ------------------------------------------------------------------- bcast
class BcastPlan(Plan):
    """Binomial-tree broadcast of ``bufs[root]`` into every ``bufs[r]``."""

    NAME = "bcast"

    def __init__(self, comm, pid, tag_base, bufs: Sequence[np.ndarray],
                 root: int = 0):
        super().__init__(comm, pid, tag_base)
        self.n = comm.n_ranks
        self.root = root
        self.bids = [self._adopt(np.ascontiguousarray(b)) for b in bufs]
        self.request.rounds = max(1, self.n - 1).bit_length()

    def start(self) -> None:
        for r in range(self.n):
            v = _vrank(r, self.root, self.n)
            if v == 0:
                self._fanout(r)
            else:
                parent = _prank(_parent(v), self.root, self.n)
                self._recv(r, self.bids[r], source=parent, key=("br", r, 0))

    def _fanout(self, r: int) -> None:
        v = _vrank(r, self.root, self.n)
        for c in _children(v, self.n):
            self._send(r, _prank(c, self.root, self.n), self._buf(self.bids[r]),
                       key=("bs", r, c))

    def on_step(self, key, req) -> None:
        if key[0] == "br":
            self._fanout(key[1])

    def result(self):
        return [self._buf(b) for b in self.bids]

    def _snap_state(self):
        return dict(n=self.n, root=self.root, bids=list(self.bids))

    def _restore_state(self, s):
        self.n, self.root, self.bids = s["n"], s["root"], list(s["bids"])


class BcastPipelinedPlan(Plan):
    """Pipelined-segment binomial-tree broadcast for long messages: the
    payload is cut into ``MpiConfig.coll_seg_bytes`` segments, each relay
    forwards segment ``s`` to its children the moment it lands (distinct
    tag per segment, so segments overtake freely), and every segment
    travels as one committed chunk over the credit-managed rendezvous —
    the tree streams instead of storing-and-forwarding the whole vector:
    ⌈log₂ n⌉ + S − 1 pipeline rounds instead of ⌈log₂ n⌉ · S.
    """

    NAME = "bcast_pipelined"

    def __init__(self, comm, pid, tag_base, bufs: Sequence[np.ndarray],
                 root: int = 0):
        super().__init__(comm, pid, tag_base)
        assert comm.seg_dtype is not None, (
            "pipelined bcast needs the collective segment datatype "
            "(MpiConfig.coll_seg_bytes > 0, unfrozen registry)")
        self.n = comm.n_ranks
        self.root = root
        self.bids = [self._adopt(np.ascontiguousarray(b)) for b in bufs]
        self.nbytes = int(self._buf(self.bids[root]).nbytes)
        self.seg = comm.cfg.coll_seg_bytes
        self.nseg = max(1, -(-self.nbytes // self.seg))
        from repro_torch.mpi.communicator import _PLAN_TAG_SPAN
        assert self.nseg <= _PLAN_TAG_SPAN, (
            f"{self.nseg} segments exceed the plan tag block "
            f"({_PLAN_TAG_SPAN}) — raise MpiConfig.coll_seg_bytes")
        self.scratch: Dict[tuple, int] = {}      # (rank, seg) -> bid
        self.request.rounds = max(1, self.n - 1).bit_length() \
            + self.nseg - 1

    def _seg_span(self, s: int) -> Tuple[int, int]:
        off = s * self.seg
        return off, min(self.seg, self.nbytes - off)

    def start(self) -> None:
        for r in range(self.n):
            v = _vrank(r, self.root, self.n)
            if v == 0:
                for s in range(self.nseg):
                    self._fan_seg(r, s)
            else:
                parent = _prank(_parent(v), self.root, self.n)
                for s in range(self.nseg):
                    sbid = self._adopt(np.zeros(self.seg, np.uint8))
                    self.scratch[(r, s)] = sbid
                    req = self.comm.irecv(r, self._buf(sbid),
                                          source=parent,
                                          tag=self.tag_base + s,
                                          buf_id=sbid)
                    self._track(req, ("pr", r, s))

    def _fan_seg(self, r: int, s: int) -> None:
        v = _vrank(r, self.root, self.n)
        children = _children(v, self.n)
        if not children:
            return
        off, ln = self._seg_span(s)
        u8 = self._buf(self.bids[r]).reshape(-1).view(np.uint8)
        chunk = np.zeros(self.seg, np.uint8)
        chunk[:ln] = u8[off:off + ln]
        for c in children:
            req = self.comm.isend(r, _prank(c, self.root, self.n), chunk,
                                  tag=self.tag_base + s,
                                  datatype=self.comm.seg_dtype)
            self._track(req, ("ps", r, c, s))
            self.request.bytes_wire += self.seg

    def on_step(self, key, req) -> None:
        if key[0] != "pr":
            return
        _, r, s = key
        sbid = self.scratch.pop((r, s))
        off, ln = self._seg_span(s)
        u8 = self._buf(self.bids[r]).reshape(-1).view(np.uint8)
        u8[off:off + ln] = self._buf(sbid)[:ln]
        self.comm.pool.release(sbid)
        self._fan_seg(r, s)

    def result(self):
        return [self._buf(b) for b in self.bids]

    def _snap_state(self):
        return dict(n=self.n, root=self.root, bids=list(self.bids),
                    nbytes=self.nbytes, seg=self.seg, nseg=self.nseg,
                    scratch=sorted(self.scratch.items()))

    def _restore_state(self, s):
        self.n, self.root = s["n"], s["root"]
        self.bids = list(s["bids"])
        self.nbytes, self.seg, self.nseg = s["nbytes"], s["seg"], s["nseg"]
        self.scratch = {tuple(k): v for k, v in s["scratch"]}


def _check_eager_fit(comm: Communicator, nbytes: int, what: str) -> None:
    """Only reachable when segmentation is unavailable (a frozen registry
    without the chunk type, or ``coll_seg_bytes=0``): unsegmented plan
    messages ship raw bytes through the eager path and must fit a staging
    slot — fail at post time with an actionable message."""
    assert nbytes <= comm.cfg.eager_slot_bytes, (
        f"{what} of {nbytes}B exceeds the {comm.cfg.eager_slot_bytes}B "
        f"eager staging slot and the communicator has no collective "
        f"segment datatype (frozen registry without '__coll_seg__', or "
        f"MpiConfig.coll_seg_bytes=0) — enable segmentation or raise "
        f"eager_slot_bytes")


# ------------------------------------------------------- binomial reduce
class _ReduceState:
    """Shared acc/tmp/op state for the reduction plans: buffer adoption at
    construction and named-op (de)serialization for checkpoints."""

    def _init_reduce_state(self, sendbufs, op) -> None:
        self._op = op
        self.op_name = _op_name(op)
        accs = [np.ascontiguousarray(b).copy() for b in sendbufs]
        self.acc_bids = [self._adopt(a) for a in accs]
        self.tmp_bids = [self._adopt(np.empty_like(a)) for a in accs]

    def _snap_reduce_state(self) -> dict:
        assert self.op_name is not None, (
            "cannot checkpoint a collective with an unregistered reduction "
            "op — use one of repro_torch.mpi.collectives.OPS or register "
            "yours")
        return dict(n=self.n, op=self.op_name, acc=list(self.acc_bids),
                    tmp=list(self.tmp_bids))

    def _restore_reduce_state(self, s: dict) -> None:
        self.n = s["n"]
        self.op_name = s["op"]
        self._op = OPS[s["op"]]
        self.acc_bids, self.tmp_bids = list(s["acc"]), list(s["tmp"])


class _TreeReduce:
    """Shared binomial-combine logic (used by ReducePlan and the tree
    allreduce).  Host class must provide masks/acc_bids/tmp_bids/_op and
    the plan posting helpers."""

    def _tree_kick(self, r: int, round_: int = 0) -> None:
        n, root = self.n, self.root
        v = _vrank(r, root, n)
        mask = self.masks[r]
        while mask < n:
            if v & mask:
                peer = _prank(v - mask, root, n)
                self.masks[r] = n            # this rank's combine is done
                self._send(r, peer, self._buf(self.acc_bids[r]),
                           key=("rs", r, mask), round_=round_)
                return
            if v + mask < n:
                peer = _prank(v + mask, root, n)
                self.masks[r] = mask
                self._recv(r, self.tmp_bids[r], source=peer,
                           key=("rr", r, mask), round_=round_)
                return
            mask <<= 1
            self.masks[r] = mask

    def _tree_combine(self, key, round_: int = 0) -> None:
        _, r, mask = key
        acc, tmp = self._buf(self.acc_bids[r]), self._buf(self.tmp_bids[r])
        acc[...] = self._op(acc, tmp)
        self.masks[r] = mask << 1
        self._tree_kick(r, round_=round_)


class ReducePlan(Plan, _ReduceState, _TreeReduce):
    """Binomial-tree reduce toward ``root``; result() is the root's
    combined array (like MPI_Reduce, only meaningful there)."""

    NAME = "reduce"

    def __init__(self, comm, pid, tag_base, sendbufs, root=0, op=np.add):
        super().__init__(comm, pid, tag_base)
        self.n = comm.n_ranks
        self.root = root
        self._init_reduce_state(sendbufs, op)
        self.masks = [1] * self.n
        self.request.rounds = max(1, self.n - 1).bit_length()

    def start(self) -> None:
        for r in range(self.n):
            self._tree_kick(r)

    def on_step(self, key, req) -> None:
        if key[0] == "rr":
            self._tree_combine(key)

    def result(self):
        return self._buf(self.acc_bids[self.root])

    def _snap_state(self):
        return dict(self._snap_reduce_state(), root=self.root,
                    masks=list(self.masks))

    def _restore_state(self, s):
        self._restore_reduce_state(s)
        self.root = s["root"]
        self.masks = list(s["masks"])


# --------------------------------------------------------------- allreduce
class AllreduceTreePlan(ReducePlan):
    """reduce-to-0 then binomial bcast of the result (the low-message-count
    algorithm for large vectors: ≤ 2·⌈log₂ n⌉ rounds, 2(n−1) messages)."""

    NAME = "allreduce_tree"

    def __init__(self, comm, pid, tag_base, sendbufs, op=np.add):
        super().__init__(comm, pid, tag_base, sendbufs, root=0, op=op)
        self.phase = "reduce"
        self.request.rounds = 2 * max(1, self.n - 1).bit_length()

    def on_drain(self) -> None:
        if self.phase == "reduce":
            self.phase = "bcast"
            for r in range(self.n):
                if r == 0:
                    self._bcast_fanout(r)
                else:
                    v = _vrank(r, 0, self.n)
                    self._recv(r, self.acc_bids[r],
                               source=_prank(_parent(v), 0, self.n),
                               key=("br", r, 0), round_=1)
            if not self.pending:
                self._finish()
        else:
            self._finish()

    def _bcast_fanout(self, r: int) -> None:
        v = _vrank(r, 0, self.n)
        for c in _children(v, self.n):
            self._send(r, _prank(c, 0, self.n),
                       self._buf(self.acc_bids[r]),
                       key=("bs", r, c), round_=1)

    def on_step(self, key, req) -> None:
        if key[0] == "rr":
            self._tree_combine(key)
        elif key[0] == "br":
            self._bcast_fanout(key[1])

    def result(self):
        return [self._buf(b) for b in self.acc_bids]

    def _snap_state(self):
        s = super()._snap_state()
        s["phase"] = self.phase
        return s

    def _restore_state(self, s):
        super()._restore_state(s)
        self.phase = s["phase"]


class AllreduceRDPlan(Plan, _ReduceState):
    """Recursive-doubling allreduce — the latency-optimal ⌈log₂ n⌉-round
    schedule (MPICH's short-vector algorithm).  Non-power-of-two rank
    counts fold the first ``2·rem`` ranks pairwise into ``pof2``
    participants, run the doubling, and fan the result back out."""

    NAME = "allreduce_rd"

    def __init__(self, comm, pid, tag_base, sendbufs, op=np.add):
        super().__init__(comm, pid, tag_base)
        self.n = comm.n_ranks
        self._init_reduce_state(sendbufs, op)
        self.pof2 = 1 << _log2floor(self.n)
        self.rem = self.n - self.pof2
        self.nrounds = _log2floor(self.pof2)
        self.request.rounds = self.nrounds + (2 if self.rem else 0)

    # rank <-> recursive-doubling participant mapping (MPICH scheme)
    def _newrank(self, r: int) -> int:
        return _fold_newrank(r, self.rem)

    def _realrank(self, nr: int) -> int:
        return _fold_realrank(nr, self.rem)

    def start(self) -> None:
        post_round = 1 + self.nrounds
        for r in range(self.n):
            if self.rem and r < 2 * self.rem:
                if r % 2 == 0:
                    # fold into the odd neighbour; take the result back in
                    # the post phase (recv posted now, tag-disambiguated)
                    self._send(r, r + 1, self._buf(self.acc_bids[r]),
                               key=("pres", r, 0), round_=0)
                    self._recv(r, self.acc_bids[r], source=r + 1,
                               key=("postr", r, 0), round_=post_round)
                else:
                    self._recv(r, self.tmp_bids[r], source=r - 1,
                               key=("prer", r, 0), round_=0)
            else:
                self._rd_round(r, 0)

    def _rd_round(self, r: int, ki: int) -> None:
        if ki >= self.nrounds:
            if self.rem and r < 2 * self.rem:
                # odd fold-rank hands the result back to its even partner
                self._send(r, r - 1, self._buf(self.acc_bids[r]),
                           key=("posts", r, 0), round_=1 + self.nrounds)
            return
        nr = self._newrank(r)
        partner = self._realrank(nr ^ (1 << ki))
        self._send(r, partner, self._buf(self.acc_bids[r]),
                   key=("rds", r, ki), round_=1 + ki)
        self._recv(r, self.tmp_bids[r], source=partner,
                   key=("rdr", r, ki), round_=1 + ki)

    def on_step(self, key, req) -> None:
        kind, r = key[0], key[1]
        if kind == "prer":
            self._combine(r)
            self._rd_round(r, 0)
        elif kind == "rdr":
            self._combine(r)
            self._rd_round(r, key[2] + 1)

    def _combine(self, r: int) -> None:
        acc, tmp = self._buf(self.acc_bids[r]), self._buf(self.tmp_bids[r])
        acc[...] = self._op(acc, tmp)

    def result(self):
        return [self._buf(b) for b in self.acc_bids]

    def _snap_state(self):
        return self._snap_reduce_state()

    def _restore_state(self, s):
        self._restore_reduce_state(s)
        self.pof2 = 1 << _log2floor(self.n)
        self.rem = self.n - self.pof2
        self.nrounds = _log2floor(self.pof2)


class AllreduceRabenseifnerPlan(Plan, _ReduceState):
    """Rabenseifner's allreduce: reduce-scatter by recursive halving, then
    allgather by recursive doubling — ⌈log₂ n⌉ + ⌈log₂ n⌉ rounds moving
    only ~2·(n−1)/n of the vector per rank, the bandwidth-optimal schedule
    for the large reductions that dominate a data-parallel training step.
    Non-power-of-two rank counts fold the first ``2·rem`` ranks pairwise
    into ``pof2`` participants (full-vector pre/post exchange, as in the
    recursive-doubling plan).  Every half-vector message above the eager
    slot rides the segmented rendezvous fast path.
    """

    NAME = "allreduce_rab"

    def __init__(self, comm, pid, tag_base, sendbufs, op=np.add):
        super().__init__(comm, pid, tag_base)
        self.n = comm.n_ranks
        self._init_reduce_state(sendbufs, op)
        self.nelems = int(self._buf(self.acc_bids[0]).size)
        self._derive()
        self.ridx = [0] * self.n      # per-rank position in its schedule
        self.scratch = [-1] * self.n  # per-rank in-flight recv buffer
        self.request.rounds = 2 * self.nrounds + (2 if self.rem else 0)

    def _derive(self) -> None:
        self.pof2 = 1 << _log2floor(self.n)
        self.rem = self.n - self.pof2
        self.nrounds = _log2floor(self.pof2)
        self.post_round = 1 + 2 * self.nrounds
        self._scheds: Dict[int, List[tuple]] = {}

    def _sched(self, r: int) -> List[tuple]:
        s = self._scheds.get(r)
        if s is None:
            nr = _fold_newrank(r, self.rem)
            assert nr >= 0
            s = self._scheds[r] = _rab_schedule(nr, self.pof2, self.nelems)
        return s

    def start(self) -> None:
        for r in range(self.n):
            if self.rem and r < 2 * self.rem:
                if r % 2 == 0:
                    # fold into the odd neighbour; the final vector comes
                    # back in the post phase (recv posted now)
                    self._send(r, r + 1, self._buf(self.acc_bids[r]),
                               key=("fps", r), round_=0)
                    self._recv(r, self.acc_bids[r], source=r + 1,
                               key=("por", r), round_=self.post_round)
                else:
                    self._recv(r, self.tmp_bids[r], source=r - 1,
                               key=("fpr", r), round_=0)
            else:
                self._kick(r)

    def _kick(self, r: int) -> None:
        """Advance rank ``r`` through its schedule: post the round's send
        and receive; rounds whose receive range is empty (vectors shorter
        than pof2) complete immediately."""
        sched = self._sched(r)
        flat = self._buf(self.acc_bids[r]).reshape(-1)
        while self.ridx[r] < len(sched):
            k = self.ridx[r]
            _, pn, (slo, shi), (rlo, rhi) = sched[k]
            partner = _fold_realrank(pn, self.rem)
            if shi > slo:
                self._send(r, partner, flat[slo:shi], key=("ks", r, k),
                           round_=1 + k)
            if rhi > rlo:
                sbid = self._adopt(np.empty(rhi - rlo, flat.dtype))
                self.scratch[r] = sbid
                self._recv(r, sbid, source=partner, key=("kr", r, k),
                           round_=1 + k)
                return
            self.ridx[r] = k + 1
        if self.rem and r < 2 * self.rem:
            # odd fold rank hands the full result back to its even partner
            self._send(r, r - 1, self._buf(self.acc_bids[r]),
                       key=("pos", r), round_=self.post_round)

    def on_step(self, key, req) -> None:
        kind, r = key[0], key[1]
        if kind == "fpr":
            acc = self._buf(self.acc_bids[r])
            acc[...] = self._op(acc, self._buf(self.tmp_bids[r]))
            self._kick(r)
        elif kind == "kr":
            k = key[2]
            phase, _, _, (rlo, rhi) = self._sched(r)[k]
            flat = self._buf(self.acc_bids[r]).reshape(-1)
            data = self._buf(self.scratch[r])
            if phase == "rs":
                flat[rlo:rhi] = self._op(flat[rlo:rhi], data)
            else:
                flat[rlo:rhi] = data
            self.comm.pool.release(self.scratch[r])
            self.scratch[r] = -1
            self.ridx[r] = k + 1
            self._kick(r)

    def result(self):
        return [self._buf(b) for b in self.acc_bids]

    def _snap_state(self):
        return dict(self._snap_reduce_state(), nelems=self.nelems,
                    ridx=list(self.ridx), scratch=list(self.scratch))

    def _restore_state(self, s):
        self._restore_reduce_state(s)
        self.nelems = s["nelems"]
        self._derive()
        self.ridx = list(s["ridx"])
        self.scratch = list(s["scratch"])


class AllreduceLinearPlan(Plan, _ReduceState):
    """Naive gather + fan-out at rank 0 — n−1 sequentialized rounds at the
    root.  The baseline the log-step schedules are benchmarked against."""

    NAME = "allreduce_linear"

    def __init__(self, comm, pid, tag_base, sendbufs, op=np.add):
        super().__init__(comm, pid, tag_base)
        self.n = comm.n_ranks
        self._init_reduce_state(sendbufs, op)
        self.gathered = 0
        self.request.rounds = max(1, self.n - 1)

    def start(self) -> None:
        for i in range(1, self.n):
            self._send(i, 0, self._buf(self.acc_bids[i]),
                       key=("gs", i, 0), round_=0)
            self._recv(0, self.tmp_bids[i], source=i,
                       key=("gr", 0, i), round_=0)
            self._recv(i, self.acc_bids[i], source=0,
                       key=("br", i, 0), round_=1)

    def on_step(self, key, req) -> None:
        if key[0] != "gr":
            return
        acc = self._buf(self.acc_bids[0])
        acc[...] = self._op(acc, self._buf(self.tmp_bids[key[2]]))
        self.gathered += 1
        if self.gathered == self.n - 1:
            for i in range(1, self.n):
                self._send(0, i, acc, key=("bs", 0, i), round_=1)

    def result(self):
        return [self._buf(b) for b in self.acc_bids]

    def _snap_state(self):
        return dict(self._snap_reduce_state(), gathered=self.gathered)

    def _restore_state(self, s):
        self._restore_reduce_state(s)
        self.gathered = s["gathered"]


# ------------------------------------------------------------- alltoall(v)
def _blocks_meta(blocks):
    """(sizes, meta) matrices for an n×n block exchange: byte size and
    (dtype, shape) of every ``blocks[i][j]``."""
    n = len(blocks)
    sizes = [[int(np.ascontiguousarray(blocks[i][j]).nbytes)
              for j in range(n)] for i in range(n)]
    meta = [[(str(blocks[i][j].dtype), tuple(blocks[i][j].shape))
             for j in range(n)] for i in range(n)]
    return sizes, meta


def _block_u8(arr) -> np.ndarray:
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8).copy()


def _u8_as(arr_u8: np.ndarray, dtype: str, shape) -> np.ndarray:
    return arr_u8.view(np.dtype(dtype)).reshape(shape)


class _ExchangeResult:
    """Shared result assembly for the alltoall plans: ``final(r, i)`` must
    return the uint8 bytes rank ``r`` received from rank ``i``."""

    def result(self):
        n = self.n
        if self.mode == "a2av":
            return [[_u8_as(self.final(r, i), *self.meta[i][r])
                     for i in range(n)] for r in range(n)]
        outs = []
        for r in range(n):
            # container dtype/shape follow rank r's send array, matching
            # the historical np.empty_like(sends[r]) semantics
            dtype, shape = self.meta[r][0]
            out = np.empty((n,) + shape, np.dtype(dtype))
            for i in range(n):
                out[i] = _u8_as(self.final(r, i), dtype, shape)
            outs.append(out)
        return outs


class AlltoallPairwisePlan(_ExchangeResult, Plan):
    """Direct personalized exchange: every pair trades one message —
    n−1 sends per rank, one round, bandwidth-optimal for large blocks."""

    NAME = "alltoall_pairwise"

    def __init__(self, comm, pid, tag_base, blocks, mode="a2av"):
        super().__init__(comm, pid, tag_base)
        self.n = comm.n_ranks
        self.mode = mode
        self.sizes, self.meta = _blocks_meta(blocks)
        self.send_u8 = [[_block_u8(blocks[i][j]) for j in range(self.n)]
                        for i in range(self.n)]
        self.recv_bids = [[self._adopt(np.zeros(self.sizes[i][r], np.uint8))
                           for i in range(self.n)] for r in range(self.n)]
        self.request.rounds = max(1, self.n - 1)

    def start(self) -> None:
        for r in range(self.n):
            for j in range(self.n):
                self._recv(r, self.recv_bids[r][j], source=j,
                           key=("ar", r, j))
                self._send(r, j, self.send_u8[r][j], key=("as", r, j))

    def final(self, r: int, i: int) -> np.ndarray:
        return self._buf(self.recv_bids[r][i])

    def _snap_state(self):
        return dict(n=self.n, mode=self.mode, sizes=self.sizes,
                    meta=self.meta, recv=self.recv_bids,
                    send=[[b.copy() for b in row] for row in self.send_u8])

    def _restore_state(self, s):
        self.n, self.mode = s["n"], s["mode"]
        self.sizes = [list(row) for row in s["sizes"]]
        self.meta = [[(d, tuple(sh)) for d, sh in row] for row in s["meta"]]
        self.recv_bids = [list(row) for row in s["recv"]]
        self.send_u8 = [[b.copy() for b in row] for row in s["send"]]


class AlltoallBruckPlan(_ExchangeResult, Plan):
    """Bruck's store-and-forward alltoall: ⌈log₂ n⌉ rounds, each sending
    one coalesced message of the ⌈n/2⌉ blocks whose slot index has the
    round's bit set — the message-count-optimal schedule for small blocks
    (PsPIN's regime, where collective *message count* dominates).

    Slot invariant: after the local rotation ``slot[i] = block(r → r+i)``,
    a block needing to travel distance ``i`` rides exactly the rounds
    whose bit is set in ``i``, and always occupies slot ``i`` — so at the
    end, rank r's slot i holds the block *from* rank (r−i) mod n.  Slot
    sizes along the way follow from the same invariant, which is how the
    receiver of a coalesced message knows where to cut it.
    """

    NAME = "alltoall_bruck"

    def __init__(self, comm, pid, tag_base, blocks, mode="a2av"):
        super().__init__(comm, pid, tag_base)
        n = self.n = comm.n_ranks
        self.mode = mode
        self.sizes, self.meta = _blocks_meta(blocks)
        self.ks = [1 << i for i in range(max(1, n - 1).bit_length())
                   if (1 << i) < n]
        # local rotation: slot i of rank r starts as the block r → (r+i)%n
        self.slots = [[_block_u8(blocks[r][(r + i) % n]) for i in range(n)]
                      for r in range(n)]
        self.scratch = [-1] * n           # per-rank in-flight recv buffer
        self.request.rounds = max(1, len(self.ks))

    def _occupant(self, rank: int, i: int, pm: int):
        """(src, dst) of the block in ``rank``'s slot ``i`` after the
        rounds whose bits lie in ``pm`` have been processed."""
        src = (rank - (i & pm)) % self.n
        return src, (src + i) % self.n

    def start(self) -> None:
        if self.n == 1:
            return
        for r in range(self.n):
            self._post_round(r, 0)

    def _post_round(self, r: int, ki: int) -> None:
        n, k = self.n, self.ks[ki]
        pm = k - 1
        idxs = [i for i in range(1, n) if i & k]
        dest, src = (r + k) % n, (r - k) % n
        payload = np.concatenate([self.slots[r][i] for i in idxs]) \
            if idxs else np.zeros(0, np.uint8)
        self._send(r, dest, payload, key=("xs", r, ki), round_=ki)
        in_bytes = sum(self.sizes[s][d] for s, d in
                       (self._occupant(src, i, pm) for i in idxs))
        bid = self._adopt(np.zeros(in_bytes, np.uint8))
        self.scratch[r] = bid
        self._recv(r, bid, source=src, key=("xr", r, ki), round_=ki)

    def on_step(self, key, req) -> None:
        if key[0] != "xr":
            return
        _, r, ki = key
        n, k = self.n, self.ks[ki]
        pm = k - 1
        src = (r - k) % n
        data = self._buf(self.scratch[r])
        off = 0
        for i in (i for i in range(1, n) if i & k):
            s, d = self._occupant(src, i, pm)
            ln = self.sizes[s][d]
            self.slots[r][i] = data[off:off + ln].copy()
            off += ln
        self.comm.pool.release(self.scratch[r])
        self.scratch[r] = -1
        if ki + 1 < len(self.ks):
            self._post_round(r, ki + 1)

    def final(self, r: int, i: int) -> np.ndarray:
        return self.slots[r][(r - i) % self.n]

    def _snap_state(self):
        return dict(n=self.n, mode=self.mode, sizes=self.sizes,
                    meta=self.meta, scratch=list(self.scratch),
                    slots=[[b.copy() for b in row] for row in self.slots])

    def _restore_state(self, s):
        self.n, self.mode = s["n"], s["mode"]
        self.sizes = [list(row) for row in s["sizes"]]
        self.meta = [[(d, tuple(sh)) for d, sh in row] for row in s["meta"]]
        self.scratch = list(s["scratch"])
        self.slots = [[b.copy() for b in row] for row in s["slots"]]
        self.ks = [1 << i for i in range(max(1, self.n - 1).bit_length())
                   if (1 << i) < self.n]


PLAN_TYPES: Dict[str, type] = {
    p.NAME: p for p in (BcastPlan, BcastPipelinedPlan, ReducePlan,
                        AllreduceTreePlan, AllreduceRDPlan,
                        AllreduceRabenseifnerPlan, AllreduceLinearPlan,
                        AlltoallPairwisePlan, AlltoallBruckPlan)
}


# ----------------------------------------------------- nonblocking entries
def _start(comm: Communicator, cls, *args, **kw) -> CollRequest:
    pid, tag_base = comm._new_plan_slot()
    plan = cls(comm, pid, tag_base, *args, **kw)
    comm._register_plan(pid, plan)
    plan._depth += 1
    try:
        plan.start()
    finally:
        plan._depth -= 1
    if not plan.pending and not plan.finished:
        plan.on_drain()        # degenerate (n == 1) or all-local case
    return plan.request


def ibcast(comm: Communicator, bufs: Sequence[np.ndarray],
           root: int = 0, algorithm: str = "auto") -> CollRequest:
    """Nonblocking broadcast of ``bufs[root]`` into every ``bufs[r]``
    (in place); ``result`` is the buffer list.  ``algorithm``:
    "binomial", "pipelined" (segment-streaming tree for long messages),
    or "auto" by message size."""
    nbytes = int(np.ascontiguousarray(bufs[root]).nbytes)
    if algorithm == "auto":
        algorithm = "pipelined" if (nbytes >= BCAST_PIPELINE_MIN_BYTES
                                    and comm.seg_dtype is not None) \
            else "binomial"
    cls = {"binomial": BcastPlan,
           "pipelined": BcastPipelinedPlan}[algorithm]
    return _start(comm, cls, bufs, root)


def ireduce(comm: Communicator, sendbufs: Sequence[np.ndarray],
            root: int = 0, op: Callable = np.add) -> CollRequest:
    """Nonblocking reduce toward ``root``; ``result`` is the combined
    array (meaningful at the root, like MPI_Reduce)."""
    return _start(comm, ReducePlan, sendbufs, root, op)


def iallreduce(comm: Communicator, sendbufs: Sequence[np.ndarray],
               op: Callable = np.add,
               algorithm: str = "auto") -> CollRequest:
    """Nonblocking allreduce; ``result`` is the per-rank output list.
    ``algorithm``: "rd" (recursive doubling), "tree" (reduce+bcast),
    "rab" (Rabenseifner reduce-scatter+allgather, the large-vector
    bandwidth winner), "linear" (baseline), or "auto" by message size."""
    nbytes = int(np.ascontiguousarray(sendbufs[0]).nbytes)
    if algorithm == "auto":
        if nbytes <= ALLREDUCE_RD_MAX_BYTES:
            algorithm = "rd"
        elif nbytes < ALLREDUCE_RAB_MIN_BYTES or comm.seg_dtype is None:
            algorithm = "tree"
        else:
            algorithm = "rab"
    cls = {"rd": AllreduceRDPlan, "tree": AllreduceTreePlan,
           "rab": AllreduceRabenseifnerPlan,
           "linear": AllreduceLinearPlan}[algorithm]
    return _start(comm, cls, sendbufs, op)


def _a2a_blocks(sends: Sequence[np.ndarray], n: int):
    blocks = []
    for r in range(n):
        s = np.ascontiguousarray(sends[r])
        assert s.shape[0] == n, "alltoall sends need one block per rank"
        blocks.append([s[j] for j in range(n)])
    return blocks


def ialltoall(comm: Communicator, sends: Sequence[np.ndarray],
              algorithm: str = "auto") -> CollRequest:
    """Nonblocking personalized exchange (``result[r][i] == sends[i][r]``).
    ``algorithm``: "bruck", "pairwise", or "auto" by block size."""
    blocks = _a2a_blocks(sends, comm.n_ranks)
    cls = _pick_a2a(comm, blocks, algorithm)
    return _start(comm, cls, blocks, mode="a2a")


def ialltoallv(comm: Communicator,
               blocks: Sequence[Sequence[np.ndarray]],
               algorithm: str = "auto") -> CollRequest:
    """Nonblocking variable-size exchange; ``result[r][i]`` is the block
    received at r from i (zero-size blocks allowed)."""
    cls = _pick_a2a(comm, blocks, algorithm)
    return _start(comm, cls, blocks, mode="a2av")


def _pick_a2a(comm, blocks, algorithm: str):
    n = comm.n_ranks
    max_block = max((int(np.ascontiguousarray(b).nbytes)
                     for row in blocks for b in row), default=0)
    if algorithm == "auto":
        # Bruck coalesces ~n/2 blocks per message; keep the coalesced
        # payload inside the eager staging slot with room to spare
        coalesced = max_block * ((n + 1) // 2)
        algorithm = "bruck" if (max_block <= ALLTOALL_BRUCK_MAX_BLOCK
                                and coalesced <= comm.cfg.eager_slot_bytes
                                // 2) else "pairwise"
    return {"bruck": AlltoallBruckPlan,
            "pairwise": AlltoallPairwisePlan}[algorithm]


def ibarrier(comm: Communicator) -> CollRequest:
    """Nonblocking barrier: 1-byte recursive-doubling allreduce — no rank's
    handle completes before every rank has entered."""
    return iallreduce(comm, [np.zeros(1, np.uint8)
                             for _ in range(comm.n_ranks)], op=np.add,
                      algorithm="rd")


# ------------------------------------------------------- blocking wrappers
def bcast(comm: Communicator, bufs: Sequence[np.ndarray], root: int = 0,
          max_ticks: int = 200_000, algorithm: str = "auto") -> None:
    """Broadcast ``bufs[root]`` into every rank's ``bufs[r]`` (in place)."""
    comm.wait(ibcast(comm, bufs, root=root, algorithm=algorithm),
              max_ticks=max_ticks)


def reduce(comm: Communicator, sendbufs: Sequence[np.ndarray],
           root: int = 0, op: Callable = np.add,
           max_ticks: int = 200_000) -> np.ndarray:
    """Combine every rank's array with ``op`` toward ``root``; returns the
    reduced array (meaningful at the root, like MPI_Reduce)."""
    req = ireduce(comm, sendbufs, root=root, op=op)
    comm.wait(req, max_ticks=max_ticks)
    return req.result


def allreduce(comm: Communicator, sendbufs: Sequence[np.ndarray],
              op: Callable = np.add, max_ticks: int = 200_000,
              algorithm: str = "auto") -> List[np.ndarray]:
    """Allreduce; returns the per-rank result arrays."""
    req = iallreduce(comm, sendbufs, op=op, algorithm=algorithm)
    comm.wait(req, max_ticks=max_ticks)
    return req.result


def alltoall(comm: Communicator, sends: Sequence[np.ndarray],
             max_ticks: int = 200_000,
             algorithm: str = "auto") -> List[np.ndarray]:
    """``sends[r][j]`` goes to rank ``j``; returns ``recvs`` with
    ``recvs[r][i] == sends[i][r]`` (personalized exchange)."""
    req = ialltoall(comm, sends, algorithm=algorithm)
    comm.wait(req, max_ticks=max_ticks)
    return req.result


def alltoallv(comm: Communicator,
              blocks: Sequence[Sequence[np.ndarray]],
              max_ticks: int = 200_000,
              algorithm: str = "auto") -> List[List[np.ndarray]]:
    """Variable-size exchange: ``blocks[r][j]`` goes from rank r to rank j;
    returns ``recvs[r][i]`` = block received at r from i (zero-size blocks
    allowed)."""
    req = ialltoallv(comm, blocks, algorithm=algorithm)
    comm.wait(req, max_ticks=max_ticks)
    return req.result


def barrier(comm: Communicator, max_ticks: int = 200_000) -> None:
    """No rank leaves before every rank arrived."""
    comm.wait(ibarrier(comm), max_ticks=max_ticks)
