"""Parity of the PyTorch port's MPI collectives (``repro_torch.mpi``) with
the JAX package's on the CPU.

Every collective of ``tests/test_mpi.py`` runs at its sizes (5 ranks,
loss, latency 2, jitter 2) on both packages, with each algorithm the
layer offers: the results, ``algorithm``, ``rounds``, ``msgs_total``,
``bytes_wire``, the ticks and every link counter must be equal, and the
results must equal numpy's.  Rabenseifner and the pipelined bcast run at
``tests/test_mpi_large.py``'s small-segment configuration (segments over
the rendezvous path, unpacked by the NIC).  A port checkpoint taken
mid-``iallreduce`` (with a typed rendezvous in flight) restores into a
fresh port communicator and finishes equal to the uninterrupted run and
to the JAX package; ``MPI_CONTEXT_BUILDS`` stays flat across re-commits.
Tolerance: exact (0) - the reductions run the same numpy ops in the same
order on both sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import mpi as jmpi  # noqa: E402
from repro.core import ddt as jddt  # noqa: E402
from repro.net import LinkConfig as JLinkConfig  # noqa: E402
from repro_torch import mpi as tmpi  # noqa: E402
from repro_torch.core import apps as tapps  # noqa: E402
from repro_torch.core import ddt as tddt  # noqa: E402
from repro_torch.net import LinkConfig as TLinkConfig  # noqa: E402

N_RANKS = 5
JAX = dict(mpi=jmpi, ddt=jddt, Link=JLinkConfig, kw={})
PORT = dict(mpi=tmpi, ddt=tddt, Link=TLinkConfig, kw=dict(device="cpu"))
LOSSY = dict(loss=0.05, latency=2, jitter=2)


def _small_seg_cfg(P):
    return P["mpi"].MpiConfig(eager_threshold=1024, eager_slot_bytes=4096,
                              coll_seg_bytes=2048, n_rdv_slots=4)


@pytest.fixture(scope="module")
def worlds():
    """Per package: ``tests/test_mpi.py``'s world and
    ``tests/test_mpi_large.py``'s small-segment one."""
    out = {}
    for P in (JAX, PORT):
        reg = P["mpi"].DatatypeRegistry()
        ids = dict(simple=reg.register(P["ddt"].simple_ddt(), count=64,
                                       name="simple"),
                   big=reg.register(P["ddt"].simple_ddt(), count=1024,
                                    name="big"))
        out[id(P)] = dict(
            std=(P["mpi"].Communicator(N_RANKS, registry=reg, seed=0,
                                       **P["kw"]), ids),
            seg=P["mpi"].Communicator(N_RANKS, seed=0, cfg=_small_seg_cfg(P),
                                      link_cfg=P["Link"](**LOSSY),
                                      **P["kw"]))
    return out


def flatten(x):
    if x is None:
        return []
    if isinstance(x, np.ndarray):
        return [x]
    return [a for sub in x for a in flatten(sub)]


def run_both(comms, start, link):
    """Start the collective ``start(P, comm, rng)`` on each package's
    rewired communicator, drive it to completion as an overlapping caller
    would, and check the handles and the fabric agree; returns the JAX and
    port results, flattened."""
    ends = []
    for P in (JAX, PORT):
        comm = comms[id(P)]
        comm.rewire(link_cfg=P["Link"](**link["cfg"]), seed=link["seed"])
        h, inp = start(P, comm, np.random.default_rng(99))
        while not h.test():
            comm.progress(3)
        out = inp if h.result is None or link.get("in_place") else h.result
        ends.append((flatten(out), h.algorithm, h.rounds, h.msgs_total,
                     h.bytes_wire, comm.now, comm.link_stats(),
                     comm.stats()))
    j, t = ends
    assert t[1:] == j[1:], "algorithm/rounds/msgs/bytes/ticks/stats differ"
    assert len(t[0]) == len(j[0])
    for a, b in zip(t[0], j[0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    return j[0], t[0], t[1:]


def _vals(rng, dtype, size):
    if dtype == np.float32 or dtype == np.float64:
        return [rng.normal(size=size).astype(dtype) for _ in range(N_RANKS)]
    return [rng.integers(0, 1000, size).astype(dtype)
            for _ in range(N_RANKS)]


# ------------------------------------------------------------ collectives
@pytest.mark.parametrize("algorithm", ["auto", "binomial"])
def test_bcast(worlds, algorithm):
    data = np.random.default_rng(3).normal(size=300).astype(np.float32)

    def start(P, comm, rng):
        bufs = [data.copy() if r == 2 else np.zeros(300, np.float32)
                for r in range(N_RANKS)]
        return P["mpi"].ibcast(comm, bufs, root=2,
                               algorithm=algorithm), bufs

    _, out, _ = run_both({k: v["std"][0] for k, v in worlds.items()}, start,
                         dict(cfg=dict(LOSSY, loss=0.06), seed=5,
                              in_place=True))
    for b in out:
        np.testing.assert_array_equal(b, data)


@pytest.mark.parametrize("op,dtype,loss", [("add", np.float64, 0.06),
                                           ("maximum", np.int64, 0.0)])
def test_reduce(worlds, op, dtype, loss):
    vals = _vals(np.random.default_rng(6), dtype, 128)

    def start(P, comm, rng):
        return P["mpi"].ireduce(comm, [v.copy() for v in vals], root=1,
                                op=getattr(np, op)), None

    _, out, meta = run_both({k: v["std"][0] for k, v in worlds.items()},
                            start, dict(cfg=dict(LOSSY, loss=loss), seed=6))
    want = getattr(np, op).reduce(np.stack(vals), axis=0)
    np.testing.assert_allclose(out[0], want, rtol=1e-12)


@pytest.mark.parametrize("algorithm", ["auto", "rd", "tree", "linear"])
def test_allreduce(worlds, algorithm):
    vals = _vals(np.random.default_rng(7), np.float32, 200)

    def start(P, comm, rng):
        return P["mpi"].iallreduce(comm, [v.copy() for v in vals],
                                   algorithm=algorithm), None

    _, out, meta = run_both({k: v["std"][0] for k, v in worlds.items()},
                            start, dict(cfg=dict(LOSSY, loss=0.06), seed=7))
    ref = np.sum(np.stack(vals).astype(np.float64), axis=0)
    for o in out:
        np.testing.assert_allclose(o, ref, rtol=1e-4)
    if algorithm == "linear":
        assert meta[1] == N_RANKS - 1                 # rounds


@pytest.mark.parametrize("algorithm", ["auto", "bruck", "pairwise"])
def test_alltoall(worlds, algorithm):
    rng = np.random.default_rng(8)
    mats = [rng.integers(0, 1 << 30, (N_RANKS, 50)).astype(np.int64)
            for _ in range(N_RANKS)]

    def start(P, comm, rng):
        return P["mpi"].ialltoall(comm, mats, algorithm=algorithm), None

    run_both({k: v["std"][0] for k, v in worlds.items()}, start,
             dict(cfg=dict(LOSSY, loss=0.06), seed=8))


def test_alltoallv_variable_and_zero_blocks(worlds):
    rng = np.random.default_rng(10)
    blocks = [[rng.integers(0, 256, ((r + 3 * j) % 7) * 40).astype(np.uint8)
               for j in range(N_RANKS)] for r in range(N_RANKS)]

    def start(P, comm, rng):
        return P["mpi"].ialltoallv(comm, blocks), None

    _, out, _ = run_both({k: v["std"][0] for k, v in worlds.items()}, start,
                         dict(cfg=LOSSY, seed=10))
    want = flatten([[blocks[i][r] for i in range(N_RANKS)]
                    for r in range(N_RANKS)])
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a, b)


def test_barrier(worlds):
    def start(P, comm, rng):
        return P["mpi"].ibarrier(comm), None

    run_both({k: v["std"][0] for k, v in worlds.items()}, start,
             dict(cfg=LOSSY, seed=11))


# ----------------------------------------- the segmented large-message path
def test_rabenseifner_small_segments(worlds):
    """Segments of 2 KiB travel as committed chunks over the rendezvous
    path and the NIC unpacks them: 32 KiB of int64 per rank."""
    vals = [np.random.default_rng(11 + r).integers(0, 1 << 20, 4096)
            .astype(np.int64) for r in range(N_RANKS)]

    def start(P, comm, rng):
        return P["mpi"].iallreduce(comm, [v.copy() for v in vals],
                                   algorithm="rab"), None

    _, out, meta = run_both({k: v["seg"] for k, v in worlds.items()}, start,
                            dict(cfg=LOSSY, seed=11))
    assert meta[0] == "allreduce_rab"
    for o in out:
        np.testing.assert_array_equal(o, np.sum(np.stack(vals), axis=0))


def test_pipelined_bcast_small_segments(worlds):
    data = np.random.default_rng(17).integers(0, 256, 20_000).astype(
        np.uint8)

    def start(P, comm, rng):
        bufs = [data.copy() if r == 1 else np.zeros_like(data)
                for r in range(N_RANKS)]
        return P["mpi"].ibcast(comm, bufs, root=1,
                               algorithm="pipelined"), bufs

    _, out, meta = run_both({k: v["seg"] for k, v in worlds.items()}, start,
                            dict(cfg=LOSSY, seed=17, in_place=True))
    assert meta[0] == "bcast_pipelined"
    for b in out:
        np.testing.assert_array_equal(b, data)


# ----------------------------------------------------------- checkpoint
def _ckpt_comm(P, registry):
    return P["mpi"].Communicator(
        N_RANKS, registry=registry, seed=17,
        link_cfg=P["Link"](loss=0.08, latency=2, jitter=2, duplicate=0.03,
                           reorder=0.1), **P["kw"])


def test_port_checkpoint_mid_iallreduce_restores_equal(worlds):
    """A port snapshot taken mid-``iallreduce`` with a typed rendezvous in
    flight, restored into a fresh port communicator, finishes with the
    uninterrupted run's results, ticks and link counters - which equal the
    JAX package's uninterrupted run."""
    rng = np.random.default_rng(5)
    vals = [rng.integers(0, 1 << 20, 512).astype(np.int64)
            for _ in range(N_RANKS)]
    ref = np.sum(vals, axis=0)
    ends = {}
    for P in (JAX, PORT):
        comm, ids = worlds[id(P)]["std"]
        c = comm.registry.committed(ids["big"])
        mem = np.random.default_rng(6).integers(0, 256, c.mem_bytes).astype(
            np.uint8)
        c1 = _ckpt_comm(P, comm.registry)
        buf = np.zeros(c.mem_bytes, np.uint8)
        r = c1.irecv(3, buf, source=1, tag=2)
        s = c1.isend(1, 3, mem, tag=2, datatype=ids["big"])
        h = P["mpi"].iallreduce(c1, [v.copy() for v in vals],
                                algorithm="rd")
        c1.progress(20)
        assert not h.done and not r.done
        snap = c1.checkpoint() if P is PORT else None
        rids = (r.rid, s.rid)
        c1.waitall([h, r, s], max_ticks=300_000)
        for o in h.result:
            np.testing.assert_array_equal(o, ref)
        oracle = P["ddt"].unpack_np(c, P["ddt"].pack_np(c, mem),
                                    np.zeros(c.mem_bytes, np.uint8))
        np.testing.assert_array_equal(buf, oracle)
        ends[id(P)] = (c1.now, c1.link_stats(), h.rounds, h.bytes_wire,
                       buf.copy())
    jend, tend = ends[id(JAX)], ends[id(PORT)]
    assert tend[:4] == jend[:4]
    np.testing.assert_array_equal(tend[4], jend[4])

    # a fresh port object graph, revived from the port's snapshot
    comm, ids = worlds[id(PORT)]["std"]
    c2 = _ckpt_comm(PORT, comm.registry)
    handles = c2.restore(snap)
    assert list(handles) and not any(x.done for x in handles.values())
    h2 = next(iter(handles.values()))
    r2, s2 = c2.engines[3]._reqs[rids[0]], c2.engines[1]._reqs[rids[1]]
    c2.run_until(lambda: h2.done and r2.done and s2.done,
                 max_ticks=300_000)
    for o in h2.result:
        np.testing.assert_array_equal(o, ref)
    assert (c2.now, c2.link_stats(), h2.rounds, h2.bytes_wire) == tend[:4]
    np.testing.assert_array_equal(r2.buf, tend[4])


# ------------------------------------------------------- the build counters
def test_mpi_context_builds_stay_flat_across_recommits(worlds):
    """A second registry over the same (ddt, count) does not recommit, a
    second communicator over the same tables reuses the cached NIC (no
    context rebuilt), and persistent requests touch neither cache."""
    vec = tddt.Vector(count=16, blocklen=2, stride=4, base=tddt.MPI_FLOAT)
    reg1 = tmpi.DatatypeRegistry()
    reg1.register(vec, count=8, name="v")
    commits = tmpi.COMMIT_COUNTERS["commits"]
    reg2 = tmpi.DatatypeRegistry()
    reg2.register(vec, count=8, name="v")
    assert tmpi.COMMIT_COUNTERS["commits"] == commits
    comm_a = tmpi.Communicator(2, registry=reg1, seed=0, device="cpu")
    builds = dict(tapps.MPI_CONTEXT_BUILDS)
    assert builds["eager"] >= 1 and builds["ddt"] >= 1
    comm_b = tmpi.Communicator(2, registry=reg2, seed=1, device="cpu")
    assert tapps.MPI_CONTEXT_BUILDS == builds
    assert comm_b.nic is comm_a.nic

    comm = worlds[id(PORT)]["seg"]
    comm.rewire(link_cfg=TLinkConfig(**LOSSY), seed=31)
    seg = comm.cfg.coll_seg_bytes
    rng = np.random.default_rng(31)
    mem = rng.integers(0, 256, seg).astype(np.uint8)
    buf = np.zeros(seg, np.uint8)
    ps = comm.send_init(0, 3, mem, tag=5, datatype=comm.seg_dtype)
    pr = comm.recv_init(3, buf, source=0, tag=5)
    commits0 = dict(tmpi.COMMIT_COUNTERS)
    builds0 = dict(tapps.MPI_CONTEXT_BUILDS)
    for _ in range(2):
        mem[:] = rng.integers(0, 256, seg)
        buf[:] = 0
        comm.waitall(comm.start_all([pr, ps]), max_ticks=300_000)
        np.testing.assert_array_equal(buf, mem)
    assert tmpi.COMMIT_COUNTERS == commits0
    assert tapps.MPI_CONTEXT_BUILDS == builds0
