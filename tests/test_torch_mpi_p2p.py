"""Parity of the PyTorch port's MPI layer (``repro_torch.mpi``) with the JAX
package's (``repro.mpi``) on the CPU: point-to-point.

``tests/test_mpi.py``'s world (5 ranks; the Fig 9 simple and complex
datatypes and a small vector registered; loss, latency 2, jitter) is
built in both packages, and each scenario makes the same calls on both:
eager round trips, wildcards, the unexpected queue, non-overtaking,
staging-slot reuse, and rendezvous receives whose datatype unpack runs on
the NIC.  Receive buffers must equal the JAX buffers and the numpy
dataloop oracle, and the request fields, ticks, engine stats and link
counters must be equal.  Tolerance: exact (0).
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import mpi as jmpi  # noqa: E402
from repro.core import ddt as jddt  # noqa: E402
from repro.net import LinkConfig as JLinkConfig  # noqa: E402
from repro_torch import mpi as tmpi  # noqa: E402
from repro_torch.core import ddt as tddt  # noqa: E402
from repro_torch.net import LinkConfig as TLinkConfig  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
N_RANKS = 5
JAX = dict(mpi=jmpi, ddt=jddt, Link=JLinkConfig, kw={})
PORT = dict(mpi=tmpi, ddt=tddt, Link=TLinkConfig, kw=dict(device="cpu"))


def _world(P):
    ddt = P["ddt"]
    reg = P["mpi"].DatatypeRegistry()
    ids = dict(
        simple=reg.register(ddt.simple_ddt(), count=64, name="simple"),
        complex=reg.register(ddt.complex_ddt(), count=256, name="complex"),
        small=reg.register(ddt.Vector(8, 2, 4, ddt.MPI_FLOAT), count=4,
                           name="small"),
    )
    return P["mpi"].Communicator(N_RANKS, registry=reg, seed=0,
                                 **P["kw"]), ids


@pytest.fixture(scope="module")
def worlds():
    return {id(P): _world(P) for P in (JAX, PORT)}


def both(worlds, scenario, loss=0.05, seed=0, jitter=2, duplicate=0.0,
         reorder=0.0):
    """Rewire each package's world, run ``scenario(P, comm, ids, rng)`` on
    it with the same rng stream, and check the common end state; returns
    the two scenario results (JAX, port)."""
    out = []
    for P in (JAX, PORT):
        comm, ids = worlds[id(P)]
        comm.rewire(link_cfg=P["Link"](loss=loss, latency=2, jitter=jitter,
                                       duplicate=duplicate,
                                       reorder=reorder), seed=seed)
        res = scenario(P, comm, ids, np.random.default_rng(1234))
        out.append((res, comm.now, comm.stats(), comm.link_stats()))
    (jres, jnow, jstats, jlinks), (tres, tnow, tstats, tlinks) = out
    assert tnow == jnow, "ticks differ"
    assert tstats == jstats
    assert tlinks == jlinks
    return jres, tres


def assert_same(jres, tres):
    assert type(jres) is type(tres)
    if isinstance(jres, (list, tuple)):
        assert len(jres) == len(tres)
        for a, b in zip(jres, tres):
            assert_same(a, b)
    elif isinstance(jres, np.ndarray):
        assert jres.dtype == tres.dtype
        np.testing.assert_array_equal(tres, jres)
    else:
        assert tres == jres


def status(reqs):
    return [(r.source, r.tag, r.nbytes) for r in reqs]


def oracle(ddt, c, mem, fill=0):
    return ddt.unpack_np(c, ddt.pack_np(c, mem),
                         np.full(c.mem_bytes, fill, np.uint8))


# ------------------------------------------------------------------- p2p
def test_p2p_eager_roundtrip(worlds):
    def scenario(P, comm, ids, rng):
        a = rng.integers(0, 256, 2000).astype(np.uint8)
        b = rng.integers(0, 256, 999).astype(np.uint8)
        buf_a, buf_b = np.zeros(4096, np.uint8), np.zeros(4096, np.uint8)
        reqs = [comm.irecv(1, buf_a, source=0, tag=5),
                comm.irecv(0, buf_b, source=1, tag=6),
                comm.isend(0, 1, a, tag=5), comm.isend(1, 0, b, tag=6)]
        comm.wait(*reqs)
        np.testing.assert_array_equal(buf_a[:2000], a)
        np.testing.assert_array_equal(buf_b[:999], b)
        return [buf_a, buf_b, status(reqs[:2])]
    assert_same(*both(worlds, scenario, loss=0.0, jitter=0))


def test_p2p_wildcard_source_and_tag(worlds):
    def scenario(P, comm, ids, rng):
        msgs = {s: rng.integers(0, 256, 100 + s).astype(np.uint8)
                for s in (1, 2, 3, 4)}
        bufs = [np.zeros(256, np.uint8) for _ in range(4)]
        recvs = [comm.irecv(0, bufs[i], source=P["mpi"].ANY_SOURCE,
                            tag=P["mpi"].ANY_TAG) for i in range(4)]
        sends = [comm.isend(s, 0, msgs[s], tag=10 + s) for s in msgs]
        comm.wait(*recvs, *sends)
        assert sorted(r.source for r in recvs) == [1, 2, 3, 4]
        for r, buf in zip(recvs, bufs):
            np.testing.assert_array_equal(buf[:r.nbytes], msgs[r.source])
        return [bufs, status(recvs)]
    assert_same(*both(worlds, scenario, loss=0.08, seed=3))


def test_p2p_out_of_order_posting_under_loss(worlds):
    def scenario(P, comm, ids, rng):
        msgs = [rng.integers(0, 256, 1500).astype(np.uint8)
                for _ in range(3)]
        bufs = [np.zeros(1500, np.uint8) for _ in range(3)]
        recvs = {t: comm.irecv(1, bufs[t], source=0, tag=t)
                 for t in (2, 1, 0)}
        sends = [comm.isend(0, 1, msgs[t], tag=t) for t in (0, 1, 2)]
        comm.wait(*recvs.values(), *sends, max_ticks=50_000)
        for t in range(3):
            assert recvs[t].tag == t
            np.testing.assert_array_equal(bufs[t], msgs[t])
        return [bufs, status(recvs.values())]
    assert_same(*both(worlds, scenario, loss=0.1, jitter=4, reorder=0.2,
                      seed=9))


def test_p2p_unexpected_message_queue(worlds):
    def scenario(P, comm, ids, rng):
        msg = rng.integers(0, 256, 800).astype(np.uint8)
        send = comm.isend(2, 3, msg, tag=77)
        comm.progress(60)                  # arrives, no receive posted
        assert comm.engines[3].stats["unexpected"] == 1
        buf = np.zeros(800, np.uint8)
        recv = comm.irecv(3, buf, source=P["mpi"].ANY_SOURCE, tag=77)
        assert recv.done
        comm.wait(send)
        np.testing.assert_array_equal(buf, msg)
        return [buf, status([recv])]
    assert_same(*both(worlds, scenario, loss=0.0, jitter=0))


def test_p2p_self_send(worlds):
    def scenario(P, comm, ids, rng):
        msg = rng.integers(0, 256, 64).astype(np.uint8)
        buf = np.zeros(64, np.uint8)
        s = comm.isend(2, 2, msg, tag=1)
        r = comm.irecv(2, buf, source=2, tag=1)
        assert s.done and r.done
        return [buf, status([r])]
    assert_same(*both(worlds, scenario, loss=0.0))


def test_p2p_many_messages_reuse_staging_slots(worlds):
    def scenario(P, comm, ids, rng):
        n_msgs = 3 * comm.cfg.eager_slots_per_src
        msgs = [rng.integers(0, 256, 600 + i).astype(np.uint8)
                for i in range(n_msgs)]
        bufs = [np.zeros(1024, np.uint8) for _ in range(n_msgs)]
        recvs = [comm.irecv(4, bufs[i], source=0, tag=i)
                 for i in range(n_msgs)]
        sends = [comm.isend(0, 4, msgs[i], tag=i) for i in range(n_msgs)]
        comm.wait(*recvs, *sends, max_ticks=100_000)
        for i in range(n_msgs):
            np.testing.assert_array_equal(bufs[i][:600 + i], msgs[i])
        return [bufs, status(recvs)]
    assert_same(*both(worlds, scenario, loss=0.05, seed=4))


def test_p2p_non_overtaking_same_source_and_tag(worlds):
    def scenario(P, comm, ids, rng):
        c = comm.registry.committed(ids["simple"])
        small = rng.integers(0, 256, 512).astype(np.uint8)
        mem = rng.integers(0, 256, c.mem_bytes).astype(np.uint8)
        buf1 = np.zeros(512, np.uint8)
        buf2 = np.zeros(c.mem_bytes, np.uint8)
        r1 = comm.irecv(1, buf1, source=0, tag=5)
        r2 = comm.irecv(1, buf2, source=0, tag=5)
        s1 = comm.isend(0, 1, small, tag=5)
        s2 = comm.isend(0, 1, mem, tag=5, datatype=ids["simple"])
        comm.wait(r1, r2, s1, s2, max_ticks=100_000)
        np.testing.assert_array_equal(buf1, small)
        np.testing.assert_array_equal(buf2, oracle(P["ddt"], c, mem))
        return [buf1, buf2, status([r1, r2])]
    assert_same(*both(worlds, scenario, loss=0.0, jitter=0))


# ------------------------------------------------- offloaded datatype recv
@pytest.mark.parametrize("name", ["simple", "complex"])
def test_rendezvous_nic_unpack_equals_oracle_and_jax(worlds, name):
    """Rendezvous: the port's NIC scatters the payload through the
    committed index map into the posted region; the buffer (holes keep
    0xAA; the complex layout's overlaps take the last occurrence) must
    equal the numpy oracle and the JAX buffer, under loss and
    duplication."""
    def scenario(P, comm, ids, rng):
        c = comm.registry.committed(ids[name])
        assert c.msg_bytes >= comm.cfg.eager_threshold
        mem = rng.integers(0, 256, c.mem_bytes).astype(np.uint8)
        buf = np.full(c.mem_bytes, 0xAA, np.uint8)
        r = comm.irecv(3, buf, source=1, tag=2)
        s = comm.isend(1, 3, mem, tag=2, datatype=ids[name])
        comm.wait(r, s, max_ticks=100_000)
        np.testing.assert_array_equal(buf, oracle(P["ddt"], c, mem, 0xAA))
        assert comm.engines[1].stats["rdv_sent"] == 1
        assert sum(l["lost"] for l in comm.link_stats()) > 0
        return [buf, status([r])]
    assert_same(*both(worlds, scenario, loss=0.12, jitter=3,
                      duplicate=0.05, seed=21))


def test_eager_typed_message_host_unpack(worlds):
    def scenario(P, comm, ids, rng):
        c = comm.registry.committed(ids["small"])
        assert c.msg_bytes < comm.cfg.eager_threshold
        mem = rng.integers(0, 256, c.mem_bytes).astype(np.uint8)
        buf = np.zeros(c.mem_bytes, np.uint8)
        r = comm.irecv(0, buf, source=2, tag=9)
        s = comm.isend(2, 0, mem, tag=9, datatype=ids["small"])
        comm.wait(r, s)
        np.testing.assert_array_equal(buf, oracle(P["ddt"], c, mem))
        assert comm.engines[2].stats["eager_sent"] == 1
        return [buf, status([r])]
    assert_same(*both(worlds, scenario, loss=0.0))


def test_concurrent_rendezvous_receives(worlds):
    def scenario(P, comm, ids, rng):
        c = comm.registry.committed(ids["simple"])
        mems = {s: rng.integers(0, 256, c.mem_bytes).astype(np.uint8)
                for s in (1, 2, 3)}
        bufs = {s: np.zeros(c.mem_bytes, np.uint8) for s in (1, 2, 3)}
        reqs = [comm.irecv(0, bufs[s], source=s, tag=4) for s in (1, 2, 3)]
        reqs += [comm.isend(s, 0, mems[s], tag=4, datatype=ids["simple"])
                 for s in (1, 2, 3)]
        comm.wait(*reqs, max_ticks=100_000)
        for s in (1, 2, 3):
            np.testing.assert_array_equal(bufs[s],
                                          oracle(P["ddt"], c, mems[s]))
        return [list(bufs.values()), status(reqs[:3])]
    assert_same(*both(worlds, scenario, loss=0.05, seed=13))


def test_nic_cache_is_keyed_by_device(worlds):
    """The job-wide NIC cache holds the port's NIC on the CPU; a second
    CPU communicator over the same tables shares it, and its key names the
    device, so a CUDA communicator could never be handed it."""
    comm, ids = worlds[id(PORT)]
    keys = [k for k, v in tmpi.communicator._NIC_CACHE.items()
            if v is comm.nic]
    assert keys and all(k[0] == "cpu" for k in keys)
    assert comm.nic.device.type == "cpu"
    assert all(n.state.l2.device.type == "cpu" for n in comm.nodes)
    again = tmpi.Communicator(N_RANKS, registry=comm.registry, seed=1,
                              device="cpu")
    assert again.nic is comm.nic


def test_communicator_raises_for_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        tmpi.Communicator(2)


def test_net_and_mpi_import_neither_jax_nor_repro():
    """In a fresh interpreter that refuses ``jax`` and ``repro``, the
    port's fabric and MPI layer import and run a lossless 2-rank send."""
    code = textwrap.dedent(f"""
        import importlib.abc, sys
        sys.path.insert(0, {str(SRC)!r})

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        import repro_torch.net, repro_torch.mpi
        from repro_torch import mpi
        comm = mpi.Communicator(2, device="cpu")
        msg = np.arange(300, dtype=np.uint8)
        buf = np.zeros(300, np.uint8)
        comm.wait(comm.irecv(1, buf, source=0), comm.isend(0, 1, msg))
        assert (buf == msg).all()
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
