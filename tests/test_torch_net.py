"""Parity of the PyTorch port's fabric (``repro_torch.net``) with the JAX
package's (``repro.net``) on the CPU.

Every scenario of ``tests/test_net.py`` runs at its own sizes through both
packages: the link model alone (lossless, loss 0.5 and 1.0, duplication
with capacity overflow, jitter reordering) with the whole ``LinkState``
and the popped batch compared after every push and pop; and fabrics
(unroutable frames, ping-pong, the counter drain, an SLMP transfer on the
per-link loop of a heterogeneous fabric) ticked in lockstep with every
link's state compared after every tick and, at the end, ticks,
``stats()``, host bytes, completions, RTTs and the NIC states.  The SLMP
transfers on the uniform tick path are in ``test_torch_net_slmp.py``,
which uses the helpers here.  A JAX checkpoint carried across by
``snapshot_from_numpy`` finishes equal.  Tolerance: exact (0) - bytes,
integers and draws.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.net as jnet  # noqa: E402
import repro_torch.net as tnet  # noqa: E402
from repro.core import apps as japps  # noqa: E402
from repro.core import packet as jpkt  # noqa: E402
from repro.core import slmp as jslmp  # noqa: E402
from repro_torch.core import apps as tapps  # noqa: E402
from repro_torch.core import packet as tpkt  # noqa: E402
from repro_torch.core import slmp as tslmp  # noqa: E402
from repro_torch.net import prng  # noqa: E402

CPU = "cpu"
JAX = dict(net=jnet, apps=japps, pkt=jpkt, slmp=jslmp, kw={})
PORT = dict(net=tnet, apps=tapps, pkt=tpkt, slmp=tslmp, kw=dict(device=CPU))


# ------------------------------------------------------------------ helpers
def _frames(n, nbytes=32):
    return [tpkt.make_udp(np.arange(nbytes, dtype=np.uint8))
            for _ in range(n)]


def assert_link_equal(jst, tst, what=""):
    got = tst.to_numpy()
    for f in dataclasses.fields(jst):
        np.testing.assert_array_equal(got[f.name],
                                      np.asarray(getattr(jst, f.name)),
                                      err_msg=f"{what} {f.name}")


def assert_batch_equal(jb, tb):
    for name, t in zip(("data", "length", "valid"), tb.numpy()):
        np.testing.assert_array_equal(t, np.asarray(getattr(jb, name)),
                                      err_msg=name)


def nic_dict(st) -> dict:
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                out[f"{f.name}.{g.name}"] = np.asarray(getattr(v, g.name))
        else:
            out[f.name] = np.asarray(v)
    return out


class LinkPair:
    """One JAX and one port link fed the same batches and keys."""

    def __init__(self, **cfg):
        self.j = jnet.Link(jnet.LinkConfig(**cfg))
        self.t = tnet.Link(tnet.LinkConfig(**cfg), device=CPU)
        self.js, self.ts = self.j.init_state(), self.t.init_state()

    def push(self, frames, seed, now, n=None):
        data, length, valid = tpkt.stack_frames_np(frames, n=n)
        jk = jax.random.PRNGKey(seed)
        self.js = self.j.push(self.js, jk, jpkt.PacketBatch(
            jnp.asarray(data), jnp.asarray(length), jnp.asarray(valid)), now)
        self.ts = self.t.push(self.ts, prng.PRNGKey(seed, CPU),
                              tpkt.PacketBatch.from_numpy(data, length,
                                                          valid, CPU), now)
        assert_link_equal(self.js, self.ts, f"push@{now}")
        assert self.j.stats(self.js) == self.t.stats(self.ts)

    def pop(self, now, n):
        self.js, jout = self.j.pop(self.js, now, n)
        self.ts, tout = self.t.pop(self.ts, now, n)
        assert_link_equal(self.js, self.ts, f"pop@{now}")
        assert_batch_equal(jout, tout)
        return tout


def lockstep(jfab, tfab, max_ticks):
    """Tick both fabrics until the JAX one's default ``run`` condition
    holds, comparing every link's state after every tick."""
    for _ in range(max_ticks):
        jt, tt = jfab.run(max_ticks=1), tfab.run(max_ticks=1)
        assert jt == tt, "one fabric stopped before the other"
        if jt == 0:
            break
        for i, (a, b) in enumerate(zip(jfab._per_link_states(),
                                       tfab._per_link_states())):
            assert_link_equal(a, b, f"tick {jfab.now} link {i}")
    assert jfab.now == tfab.now
    assert jfab.stats() == tfab.stats()
    assert jfab.unroutable == tfab.unroutable
    for jn, tn in zip(jfab.nodes, tfab.nodes):
        assert jn.completions == tn.completions
        want, got = nic_dict(jn.state), tn.state.to_numpy()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{jn.name} {k}")
    return jfab.now


# -------------------------------------------------------------------- link
def test_link_lossless_delivers_everything():
    lp = LinkPair(loss=0.0, latency=2, capacity=64)
    lp.push(_frames(16), seed=0, now=0)
    assert int(lp.pop(now=1, n=16).valid.sum()) == 0   # latency not elapsed
    out = lp.pop(now=2, n=16)
    assert int(out.valid.sum()) == 16
    assert lp.t.stats(lp.ts)["lost"] == 0


def test_link_total_loss_delivers_nothing():
    lp = LinkPair(loss=1.0, latency=1, capacity=64)
    lp.push(_frames(8), seed=0, now=0)
    assert lp.t.stats(lp.ts)["lost"] == 8
    assert int(lp.pop(now=10, n=8).valid.sum()) == 0


@pytest.mark.parametrize("seed", [7, 8])
def test_link_half_loss_follows_the_key(seed):
    lp = LinkPair(loss=0.5, latency=1, capacity=64)
    lp.push(_frames(32), seed=seed, now=0)
    assert 0 < lp.t.stats(lp.ts)["lost"] < 32
    lp.pop(now=1, n=32)


def test_link_duplication_and_capacity_overflow():
    lp = LinkPair(loss=0.0, duplicate=1.0, latency=1, capacity=12)
    lp.push(_frames(8), seed=0, now=0)
    s = lp.t.stats(lp.ts)
    assert s["duplicated"] == 8 and s["overflowed"] == 4
    assert int(lp.pop(now=5, n=16).valid.sum()) == 12
    # a second push into the part-full buffer: free slots fill in order
    lp.push(_frames(5, 40), seed=3, now=5)
    lp.pop(now=7, n=4)


def test_link_jitter_reorders():
    lp = LinkPair(loss=0.0, latency=1, jitter=6, capacity=128)
    frames = [tpkt.make_udp(np.full(16, i, np.uint8)) for i in range(32)]
    lp.push(frames, seed=1, now=0)
    seen = []
    for t in range(1, 12):
        out = lp.pop(now=t, n=32)
        data, _, valid = out.numpy()
        seen += [int(data[i, tpkt.SLMP_BASE]) for i in np.flatnonzero(valid)]
    assert sorted(seen) == list(range(32)) and seen != list(range(32))


def test_link_reorder_penalty_and_partial_batches():
    """The reorder draw (only made when ``reorder > 0``), jitter, loss and
    duplication together, with batches padded past their frames and pops
    smaller than what is ready (``deferred``)."""
    lp = LinkPair(loss=0.2, duplicate=0.3, latency=2, jitter=3, reorder=0.4,
                  reorder_delay=4, capacity=12)
    for t in range(10):
        lp.push(_frames(1 + t % 5, 20 + t), seed=100 + t, now=t, n=8)
        lp.pop(now=t, n=2)
    s = lp.t.stats(lp.ts)
    assert s["reordered"] > 0 and s["deferred"] > 0 and s["overflowed"] > 0


# ------------------------------------------------------------------ fabric
_NODES = {}


def slmp_pair(P, nbytes, loss, seed=7, window=8, timeout=10, jitter=2,
              duplicate=0.0, reorder=0.0, link_cfgs=None):
    """``tests/test_net.py``'s two-node SLMP transfer.  The two nodes of
    each package are built once and reset per fabric, so the JAX side
    compiles its datapath once for the file."""
    net, pkt, slmp, kw = P["net"], P["pkt"], P["slmp"], P["kw"]
    msg = np.random.default_rng(0).integers(0, 256, nbytes).astype(np.uint8)
    cfg = slmp.SlmpSenderConfig(
        window=window, mtu_payload=1024, timeout=timeout,
        src_mac=pkt.node_mac(0), dst_mac=pkt.node_mac(1))
    sender = net.SlmpSenderEngine(msg, msg_id=42, cfg=cfg)
    if net not in _NODES:
        _NODES[net] = (
            net.Node("sender", pkt.node_mac(0),
                     [P["apps"].make_null_context()], batch=16, **kw),
            net.Node("recv", pkt.node_mac(1), [slmp.make_slmp_context()],
                     batch=16, host_bytes=1 << 17, **kw))
    a, b = _NODES[net]
    a.reset(engines=[sender])
    b.reset()
    cfgs = None if link_cfgs is None else [net.LinkConfig(**c)
                                           for c in link_cfgs]
    fab = net.Fabric([a, b], link_cfg=net.LinkConfig(
        loss=loss, latency=2, jitter=jitter, duplicate=duplicate,
        reorder=reorder), link_cfgs=cfgs, seed=seed, **kw)
    return fab, sender, b, msg


def test_fabric_per_link_loop_equals_jax():
    """A heterogeneous fabric (one config per link) takes the per-link
    loop: every node steps every tick, one key split per link with
    frames, each batch padded to its own power of two."""
    cfgs = [dict(loss=0.1, latency=1, jitter=3),
            dict(loss=0.2, latency=2, jitter=2, duplicate=0.1,
                 reorder=0.2)]
    jfab, jsender, jb, msg = slmp_pair(JAX, 20_000, 0.0, link_cfgs=cfgs)
    tfab, tsender, tb, _ = slmp_pair(PORT, 20_000, 0.0, link_cfgs=cfgs)
    assert not tfab._uniform
    lockstep(jfab, tfab, 5000)
    assert tsender.sender.retransmits == jsender.sender.retransmits > 0
    assert tb.steps == tfab.now                 # no idle skip on this path
    np.testing.assert_array_equal(tb.read_host(0, len(msg)), msg)


def test_fabric_unroutable_frames_counted():
    fabs = []
    for P in (JAX, PORT):
        pkt = P["pkt"]
        cfg = P["slmp"].SlmpSenderConfig(
            window=2, mtu_payload=512, src_mac=pkt.node_mac(0),
            dst_mac=b"\xff\xff\xff\xff\xff\xff")
        sender = P["net"].SlmpSenderEngine(np.zeros(1024, np.uint8), 1, cfg)
        a = P["net"].Node("a", pkt.node_mac(0),
                          [P["apps"].make_null_context()], engines=[sender],
                          batch=8, **P["kw"])
        fab = P["net"].Fabric([a], seed=0, **P["kw"])
        for _ in range(3):
            fab.tick()
        fabs.append(fab)
    assert fabs[1].unroutable == fabs[0].unroutable > 0
    assert fabs[1].stats() == fabs[0].stats()


def _pingpong(P, proto, server_ctx, count, ticks=None):
    pkt, net = P["pkt"], P["net"]
    client = net.PingPongClient(count=count, proto=proto,
                                src_mac=pkt.node_mac(0),
                                dst_mac=pkt.node_mac(1), timeout=8)
    a = net.Node("client", pkt.node_mac(0), [P["apps"].make_null_context()],
                 engines=[client], batch=8, **P["kw"])
    b = net.Node("server", pkt.node_mac(1), [server_ctx(P["apps"])],
                 batch=8, **P["kw"])
    fab = net.Fabric([a, b], link_cfg=net.LinkConfig(loss=0.0, latency=1),
                     seed=0, **P["kw"])
    return fab, client, b


def test_fabric_pingpong_rtt():
    (jfab, jc, _), (tfab, tc, _) = (
        _pingpong(P, "udp", lambda A: A.make_udp_pingpong_context(), 3)
        for P in (JAX, PORT))
    lockstep(jfab, tfab, 100)
    assert tc.done and tc.rtts == jc.rtts == [2, 2, 2]
    assert tc.timeouts == jc.timeouts


def test_node_drains_counters_from_packet_mode_contexts():
    """icmp-host mode pushes a completion per matched frame; no replies
    come back, so the client refires after its timeout."""
    (jfab, jc, jb), (tfab, tc, tb) = (
        _pingpong(P, "icmp", lambda A: A.make_icmp_host_context(), 2)
        for P in (JAX, PORT))
    for _ in range(20):
        jfab.tick()
        tfab.tick()
        assert tb.completions == jb.completions
    assert len(tb.completions) >= 2 and tc.timeouts == jc.timeouts > 0
    for a, b in zip(jfab._per_link_states(), tfab._per_link_states()):
        assert_link_equal(a, b)


def test_slmp_sender_gives_up_after_max_retries():
    ends = []
    for slmp in (jslmp, tslmp):
        cfg = slmp.SlmpSenderConfig(window=2, mtu_payload=512, timeout=2,
                                    max_retries=3)
        sender = slmp.SlmpSender(np.zeros(2048, np.uint8), 9, cfg)
        now, sent = 0, []
        while not (sender.done or sender.failed):
            sent.append(len(sender.poll(now)))   # frames vanish: 100% loss
            now += 1
            assert now < 1000
        assert sender.failed and not sender.done
        ends.append((now, sent, sender.retransmits))
    assert ends[0] == ends[1]


def _tick(fab, n):
    for _ in range(n):
        fab.tick()


def test_jax_checkpoint_restores_into_the_port():
    """A JAX fabric checkpointed mid-run, converted leaf by leaf with
    ``np.asarray``, carried across by ``snapshot_from_numpy`` and restored
    into a port fabric of the same shape finishes equal to the JAX fabric
    run to its end; the port's own checkpoint at that tick, through
    ``snapshot_to_numpy``, equals the JAX one."""
    kw = dict(nbytes=20_000, loss=0.15, seed=5)
    jfab, jsender, jb, msg = slmp_pair(JAX, **kw)
    _tick(jfab, 10)
    jsnap = jax.tree.map(np.asarray, jfab.checkpoint())

    tfab, tsender, tb, _ = slmp_pair(PORT, **kw)
    _tick(tfab, 10)
    own = tnet.snapshot_to_numpy(tfab.checkpoint())
    assert own["now"] == jsnap["now"] == 10
    np.testing.assert_array_equal(own["key"], jsnap["key"])
    assert own["key"].dtype == jsnap["key"].dtype == np.uint32
    for a, b in zip(own["links"], jsnap["links"]):
        for k in a:
            np.testing.assert_array_equal(a[k], getattr(b, k), err_msg=k)
    for a, b in zip(own["nodes"], jsnap["nodes"]):
        want = nic_dict(b["nic"])
        for k in want:
            np.testing.assert_array_equal(a["nic"][k], want[k], err_msg=k)
        assert a["completions"] == b["completions"]

    # a fresh port fabric (the same nodes, reset), restored from the JAX
    # snapshot
    rfab, rsender, rb, _ = slmp_pair(PORT, **kw)
    rfab.restore(tnet.snapshot_from_numpy(jsnap, device=CPU))
    lockstep(jfab, rfab, 2000)
    assert rsender.sender.retransmits == jsender.sender.retransmits > 0
    np.testing.assert_array_equal(rb.read_host(0, len(msg)), msg)
    end = (rfab.now, rfab.stats(), rsender.sender.retransmits)

    # and the port's own snapshot, through numpy and back, finishes equal
    tfab, tsender, tb, _ = slmp_pair(PORT, **kw)
    tfab.restore(tnet.snapshot_from_numpy(own, device=CPU))
    tfab.run(max_ticks=2000)
    assert (tfab.now, tfab.stats(), tsender.sender.retransmits) == end
    np.testing.assert_array_equal(tb.read_host(0, len(msg)), msg)


def test_port_checkpoint_restore_is_deterministic():
    fab, sender, b, msg = slmp_pair(PORT, 20_000, 0.15, seed=5)
    _tick(fab, 10)
    snap = fab.checkpoint()
    fab.run(max_ticks=2000)
    end1 = (fab.now, sender.sender.retransmits, fab.stats())
    fab.restore(snap)
    fab.run(max_ticks=2000)
    assert (fab.now, sender.sender.retransmits, fab.stats()) == end1
    np.testing.assert_array_equal(b.read_host(0, len(msg)), msg)


def test_fabric_and_node_raise_for_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA defaults are valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        tnet.Node("n", tpkt.node_mac(0), [tapps.make_null_context()])
    node = tnet.Node("n", tpkt.node_mac(0), [tapps.make_null_context()],
                     device=CPU)
    with pytest.raises(RuntimeError, match="cuda"):
        tnet.Fabric([node])
    with pytest.raises(RuntimeError, match="cuda"):
        prng.PRNGKey(0)
