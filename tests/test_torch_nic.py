"""Parity of the PyTorch port's ``SpinNIC.step`` with the JAX package's.

The same numpy frames go through ``repro.core.spin_nic.SpinNIC`` and
``repro_torch.core.spin_nic.SpinNIC`` (on the CPU).  After every step the
whole ``NICState``, the egress batch (whole MTU rows) and the to-host batch
must be equal, bit for bit: everything in this slice is bytes and
integers, so the stated tolerance is exact (0).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import apps as japps  # noqa: E402
from repro.core import ddt as jddt  # noqa: E402
from repro.core import packet as jpkt  # noqa: E402
from repro.core import slmp as jslmp  # noqa: E402
from repro.core import spin_nic as jnic  # noqa: E402
from repro_torch.core import apps as tapps  # noqa: E402
from repro_torch.core import ddt as tddt  # noqa: E402
from repro_torch.core import packet as tpkt  # noqa: E402
from repro_torch.core import slmp as tslmp  # noqa: E402
from repro_torch.core import spin_nic as tnic  # noqa: E402
from repro_torch.kernels.matcher import ops as tmatch_ops  # noqa: E402

CPU = "cpu"
B = 8                                    # frames per batch


# ------------------------------------------------------------------ helpers
def jax_state_dict(st) -> dict:
    """The JAX NICState flattened with NICState.to_numpy's keys."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                out[f"{f.name}.{g.name}"] = np.asarray(getattr(v, g.name))
        else:
            out[f.name] = np.asarray(v)
    return out


def assert_state_equal(jst, tst):
    want, got = jax_state_dict(jst), tst.to_numpy()
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_batch_equal(jb, tb):
    for name, t in zip(("data", "length", "valid"), tb.numpy()):
        np.testing.assert_array_equal(t, np.asarray(getattr(jb, name)),
                                      err_msg=name)


class Pair:
    """One JAX and one port NIC fed the same batches."""

    def __init__(self, jctxs, tctxs, **kw):
        self.j = jnic.SpinNIC(jctxs, batch=B, **kw)
        self.t = tnic.SpinNIC(tctxs, batch=B, device=CPU, **kw)
        self.reset()

    def reset(self):
        self.js, self.ts = self.j.init_state(), self.t.init_state()
        assert_state_equal(self.js, self.ts)

    def step(self, frames):
        data, length, valid = tpkt.stack_frames_np(frames, n=B)
        self.js, jeg, jth = self.j.step(
            self.js, jpkt.PacketBatch(jnp.asarray(data), jnp.asarray(length),
                                      jnp.asarray(valid)))
        self.ts, teg, tth = self.t.step(
            self.ts, tpkt.PacketBatch.from_numpy(data, length, valid, CPU))
        assert_state_equal(self.js, self.ts)
        assert_batch_equal(jeg, teg)
        assert_batch_equal(jth, tth)
        return teg, tth

    def write_expect(self, idx, msg_id):
        self.js = self.j.write_expect(self.js, idx, msg_id)
        self.ts = self.t.write_expect(self.ts, idx, msg_id)
        assert_state_equal(self.js, self.ts)

    def read_host(self, base, nbytes):
        got = self.t.read_host(self.ts, base, nbytes)
        np.testing.assert_array_equal(got,
                                      self.j.read_host(self.js, base, nbytes))
        return got

    def pop_counters(self, q):
        jv, self.js = self.j.pop_counters(self.js, q)
        tv, self.ts = self.t.pop_counters(self.ts, q)
        np.testing.assert_array_equal(tv, jv)
        assert_state_equal(self.js, self.ts)
        return tv


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------ ICMP / UDP
@pytest.fixture(scope="module")
def pingpong():
    return Pair([japps.make_icmp_context(), japps.make_udp_pingpong_context()],
                [tapps.make_icmp_context(), tapps.make_udp_pingpong_context()])


def test_icmp_echo_and_udp_pingpong_stream(pingpong):
    """Echo replies (checksums computed over L2 bytes, odd lengths
    included), UDP replies and to-host passthrough, over several steps."""
    p = pingpong
    p.reset()
    rng = _rng(0)
    replies = 0
    for s in range(4):
        frames = []
        for i in range(B - 1):
            k = (s + i) % 3
            payload = rng.integers(0, 256, int(rng.integers(1, 200))
                                   ).astype(np.uint8)
            if k == 0:
                frames.append(tpkt.make_icmp_echo(payload, seq=s * B + i))
            elif k == 1:
                frames.append(tpkt.make_udp(payload, dport=9999))
            else:
                frames.append(tpkt.make_udp(payload, dport=53))
        eg, th = p.step(frames)
        replies += int(eg.valid.sum())
    assert replies > 0
    assert int(p.ts.cycles) == 4


def test_icmp_echo_reply_checksum_verifies(pingpong):
    p = pingpong
    p.reset()
    payload = np.arange(64, dtype=np.uint8)
    eg, _ = p.step([tpkt.make_icmp_echo(payload, seq=1)])
    data, length, valid = eg.numpy()
    assert valid.sum() == 1
    f, ln = data[np.argmax(valid)], int(length[np.argmax(valid)])
    assert f[tpkt.ICMP_TYPE] == tpkt.ICMP_ECHO_REPLY
    assert tpkt.internet_checksum_np(f[tpkt.L4_BASE:ln]) == 0


def test_alloc_exhaustion_drops_match_reference():
    """Large frames beyond the 170 large slots drop in both packages."""
    j = jnic.SpinNIC([japps.make_udp_pingpong_context()], batch=200)
    t = tnic.SpinNIC([tapps.make_udp_pingpong_context()], batch=200,
                     device=CPU)
    frames = [tpkt.make_udp(np.full(1400, i % 251, np.uint8), dport=9999)
              for i in range(200)]
    data, length, valid = tpkt.stack_frames_np(frames)
    js, jeg, _ = j.step(j.init_state(), jpkt.PacketBatch(
        jnp.asarray(data), jnp.asarray(length), jnp.asarray(valid)))
    ts, teg, _ = t.step(t.init_state(),
                        tpkt.PacketBatch.from_numpy(data, length, valid, CPU))
    assert int(ts.dropped) == 200 - 170
    assert_state_equal(js, ts)
    assert_batch_equal(jeg, teg)


# ------------------------------------------------------- ICMP host path
def test_icmp_host_path_dma_and_counters():
    p = Pair([japps.make_icmp_host_context(host_base=64)],
             [tapps.make_icmp_host_context(host_base=64)],
             host_bytes=1 << 12)
    rng = _rng(1)
    for s in range(3):
        frames = [tpkt.make_icmp_echo(
            rng.integers(0, 256, 20 + 7 * i + s).astype(np.uint8), seq=i)
            for i in range(3)]
        p.step(frames)
        got = p.pop_counters(jslmp.COMPLETION_QUEUE)
        assert got.tolist() == [len(f) for f in frames]
        # frames share host offsets from 64: the last lane's bytes win
        host = p.read_host(64, 200)
        last = frames[-1]
        np.testing.assert_array_equal(host[:len(last)], last)
    assert p.pop_counters(jslmp.COMPLETION_QUEUE).tolist() == []


# ------------------------------------------------------------------ SLMP
@pytest.fixture(scope="module")
def slmp_pair():
    return Pair([jslmp.make_slmp_context()], [tslmp.make_slmp_context()],
                host_bytes=1 << 14)


def test_slmp_receive_stream_acks_and_completion(slmp_pair):
    p = slmp_pair
    p.reset()
    msg = _rng(3).integers(0, 256, 5000).astype(np.uint8)
    frames = tslmp.segment_message(
        msg, 77, tslmp.SlmpSenderConfig(window=4, mtu_payload=512))
    order = [3, 0, 5, 1, 8, 2, 9, 4, 6, 7]            # out of order
    frames = [frames[i] for i in order]
    acks = 0
    for i in range(0, len(frames), 3):
        eg, _ = p.step(frames[i:i + 3])
        acks += len(tslmp.parse_acks(eg))
    assert acks == len(frames)
    np.testing.assert_array_equal(p.read_host(0, len(msg)), msg)
    assert p.pop_counters(jslmp.COMPLETION_QUEUE).tolist() == [77]
    assert p.pop_counters(jslmp.COMPLETION_QUEUE).tolist() == []


def test_slmp_duplicate_host_offsets_last_lane_wins(slmp_pair):
    """Hazard: two frames of one batch write overlapping host offsets with
    *different* bytes; the later lane must win, as in the JAX package."""
    p = slmp_pair
    p.reset()
    a = np.full(600, 0xAA, np.uint8)
    b = _rng(4).integers(0, 256, 600).astype(np.uint8)
    c = np.full(300, 0x55, np.uint8)
    frames = [tpkt.make_slmp(5, 0, 0, a, dport=9330),
              tpkt.make_slmp(5, 100, 0, b, dport=9330),
              tpkt.make_slmp(5, 50, 0, c, dport=9330)]
    p.step(frames)
    want = np.zeros(700, np.uint8)
    want[0:600] = a
    want[100:700] = b
    want[50:350] = c
    np.testing.assert_array_equal(p.read_host(0, 700), want)


def test_mpq_collision_in_one_batch(slmp_pair):
    """Hazard: messages 1 and 17 hash to MPQ slot 1 in the same batch (16
    entries); the later lane's key wins, and the next header evicts."""
    p = slmp_pair
    p.reset()
    pay = np.arange(40, dtype=np.uint8)
    p.step([tpkt.make_slmp(1, 0, 0, pay, dport=9330),
            tpkt.make_slmp(17, 0, 0, pay, dport=9330),
            tpkt.make_slmp(33, 64, 0, pay, dport=9330)])
    key = int(p.ts.mpq.key[1])
    assert key == 33 and bool(p.ts.mpq.active[1])
    p.step([tpkt.make_slmp(1, 40, tpkt.SLMP_FLAG_EOM, pay, dport=9330)])
    assert int(p.ts.mpq.evictions) == 1
    assert p.pop_counters(jslmp.COMPLETION_QUEUE).tolist() == [1]


def test_state_carried_across_mid_stream(slmp_pair):
    """NICState.from_numpy of a JAX state lets the port continue a stream
    the JAX package started; to_numpy round-trips."""
    p = slmp_pair
    p.reset()
    msg = _rng(6).integers(0, 256, 3000).astype(np.uint8)
    frames = tslmp.segment_message(
        msg, 9, tslmp.SlmpSenderConfig(window=4, mtu_payload=400))
    p.step(frames[:3])
    d = jax_state_dict(p.js)
    p.ts = tnic.NICState.from_numpy(d, device=CPU)
    assert_state_equal(p.js, p.ts)
    rt = tnic.NICState.from_numpy(p.ts.to_numpy(), device=CPU).to_numpy()
    for k, v in p.ts.to_numpy().items():
        np.testing.assert_array_equal(rt[k], v, err_msg=k)
    p.step(frames[3:6])
    p.step(frames[6:])
    np.testing.assert_array_equal(p.read_host(0, len(msg)), msg)


def test_clone_keeps_state_that_step_consumes(slmp_pair):
    p = slmp_pair
    st = p.t.init_state()
    keep = st.clone()
    frame = tpkt.make_slmp(2, 0, 0, np.full(64, 7, np.uint8), dport=9330)
    p.t.step(st, tpkt.stack_frames([frame], n=B, device=CPU))
    assert int(keep.host.sum()) == 0 and int(keep.l2.sum()) == 0


# ------------------------------------------------------------------- DDT
def _ddt_pair(msgs_in_flight=4):
    cs = jddt.commit(jddt.simple_ddt(), count=4)
    cc = jddt.commit(jddt.complex_ddt(), count=3)
    base_c = cs.mem_bytes * msgs_in_flight
    jctx = [japps.make_ddt_context(cs, port=9331,
                                   msgs_in_flight=msgs_in_flight),
            japps.make_ddt_context(cc, port=9332,
                                   msgs_in_flight=msgs_in_flight,
                                   host_base=base_c)]
    tcs = tddt.commit(tddt.simple_ddt(), count=4)
    tcc = tddt.commit(tddt.complex_ddt(), count=3)
    tctx = [tapps.make_ddt_context(tcs, port=9331,
                                   msgs_in_flight=msgs_in_flight,
                                   device=CPU),
            tapps.make_ddt_context(tcc, port=9332,
                                   msgs_in_flight=msgs_in_flight,
                                   host_base=base_c, device=CPU)]
    return Pair(jctx, tctx, host_bytes=1 << 14), tcs, tcc, base_c


@pytest.fixture(scope="module")
def ddt_pair():
    return _ddt_pair()


@pytest.mark.parametrize("which", ["simple", "complex"])
def test_ddt_offload_stream(ddt_pair, which):
    """Fig 10 path at small size: two messages in flight, interleaved,
    window=1 ACKs; host regions equal the MPI unpack oracle."""
    p, cs, cc, base_c = ddt_pair
    p.reset()
    c, port, base = (cs, 9331, 0) if which == "simple" else \
        (cc, 9332, base_c)
    rng = _rng(7)
    msgs = {}
    lists = []
    for mid in (1, 2):
        mem = rng.integers(0, 256, c.mem_bytes).astype(np.uint8)
        msgs[mid] = tddt.pack_np(c, mem)
        lists.append(tslmp.segment_message(
            msgs[mid], mid, tslmp.SlmpSenderConfig(window=1, port=port,
                                                   mtu_payload=96)))
    frames = [f for pair in zip(*lists) for f in pair]
    for i in range(0, len(frames), 4):
        eg, _ = p.step(frames[i:i + 4])
        assert len(tslmp.parse_acks(eg)) == len(frames[i:i + 4])
    for mid, msg in msgs.items():
        got = p.read_host(base + (mid % 4) * c.mem_bytes, c.mem_bytes)
        want = tddt.unpack_np(c, msg, np.zeros(c.mem_bytes, np.uint8))
        np.testing.assert_array_equal(got, want)
    done = sorted(p.pop_counters(jslmp.COMPLETION_QUEUE).tolist())
    assert done == [1, 2]


def test_ddt_complex_repeated_offsets_different_bytes(ddt_pair):
    """Hazard: the complex datatype maps several message bytes to one
    memory byte.  Random message bytes (not a pack of memory) put
    *different* values on repeated host offsets, within a frame and across
    frames of one batch; the last serialized byte must win."""
    p, cs, cc, base_c = ddt_pair
    p.reset()
    msg = _rng(8).integers(0, 256, cc.msg_bytes).astype(np.uint8)
    frames = tslmp.segment_message(
        msg, 3, tslmp.SlmpSenderConfig(window=1, port=9332, mtu_payload=80))
    for i in range(0, len(frames), B):
        p.step(frames[i:i + B])
    want = tddt.unpack_np(cc, msg, np.zeros(cc.mem_bytes, np.uint8))
    got = p.read_host(base_c + 3 * cc.mem_bytes, cc.mem_bytes)
    np.testing.assert_array_equal(got, want)
    assert (np.bincount(cc.msg_to_mem) > 1).any()


# ------------------------------------------------------------------- MPI
N_RDV = 2
REGION = 512
EAGER_SLOTS, EAGER_BYTES = 4, 1024


def _mpi_maps():
    cs = tddt.commit(tddt.simple_ddt(), count=2)
    cc = tddt.commit(tddt.complex_ddt(), count=2)
    mmax = max(cs.msg_bytes, cc.msg_bytes)
    maps = np.full((2, mmax), -1, np.int32)
    for i, c in enumerate((cs, cc)):
        maps[i, :c.msg_bytes] = c.msg_to_mem
    return maps, np.array([cs.msg_bytes, cc.msg_bytes], np.int32), (cs, cc)


@pytest.fixture(scope="module")
def mpi_pair():
    maps, lens, _ = _mpi_maps()
    base = EAGER_SLOTS * EAGER_BYTES
    j = [japps.make_mpi_eager_context(9400, EAGER_SLOTS, EAGER_BYTES),
         japps.make_mpi_ddt_context(maps, lens, REGION, N_RDV, 9401,
                                    host_base=base)]
    t = [tapps.make_mpi_eager_context(9400, EAGER_SLOTS, EAGER_BYTES),
         tapps.make_mpi_ddt_context(maps, lens, REGION, N_RDV, 9401,
                                    host_base=base, device=CPU)]
    return Pair(j, t, host_bytes=1 << 14)


def _msg_id(kind, dtype, vslot):
    return (kind << tapps.MPI_MSGID_KIND_SHIFT) \
        | (dtype << tapps.MPI_MSGID_DTYPE_SHIFT) | vslot


def test_mpi_eager_stream(mpi_pair):
    p = mpi_pair
    p.reset()
    rng = _rng(9)
    msgs = {s: rng.integers(0, 256, 700 + 50 * s).astype(np.uint8)
            for s in range(EAGER_SLOTS + 1)}     # slot 4 is out of range
    frames = []
    for s, m in msgs.items():
        frames += tslmp.segment_message(
            m, _msg_id(tapps.MPI_KIND_EAGER, 0, s),
            tslmp.SlmpSenderConfig(window=1, port=9400, mtu_payload=300))
    for i in range(0, len(frames), B):
        p.step(frames[i:i + B])
    for s in range(EAGER_SLOTS):
        got = p.read_host(s * EAGER_BYTES, len(msgs[s]))
        np.testing.assert_array_equal(got, msgs[s])
    assert len(p.pop_counters(jslmp.COMPLETION_QUEUE)) == len(msgs)


def test_mpi_ddt_armed_and_stale_msg_ids(mpi_pair):
    """The expect table: frames of the armed msg_id unpack into the posted
    region; a stale generation of the same physical slot is dropped."""
    p = mpi_pair
    p.reset()
    _, _, (cs, cc) = _mpi_maps()
    base = EAGER_SLOTS * EAGER_BYTES
    rng = _rng(10)
    armed = _msg_id(tapps.MPI_KIND_RDV, 1, N_RDV + 1)    # gen 1, phys 1
    stale = _msg_id(tapps.MPI_KIND_RDV, 1, 1)            # gen 0, phys 1
    p.write_expect(1, armed)
    good = tddt.pack_np(cc, rng.integers(0, 256, cc.mem_bytes
                                         ).astype(np.uint8))
    bad = rng.integers(0, 256, cc.msg_bytes).astype(np.uint8)
    cfg = tslmp.SlmpSenderConfig(window=1, port=9401, mtu_payload=100)
    fg = tslmp.segment_message(good, armed, cfg)
    fb = tslmp.segment_message(bad, stale, cfg)
    frames = [f for pair in zip(fg, fb) for f in pair]
    for i in range(0, len(frames), B):
        p.step(frames[i:i + B])
    got = p.read_host(base + 1 * REGION, cc.mem_bytes)
    want = tddt.unpack_np(cc, good, np.zeros(cc.mem_bytes, np.uint8))
    np.testing.assert_array_equal(got, want)
    # slot 0 was never armed: a frame for it writes nothing
    p.step(tslmp.segment_message(
        tddt.pack_np(cs, np.ones(cs.mem_bytes, np.uint8)),
        _msg_id(tapps.MPI_KIND_RDV, 0, 0), cfg)[:1])
    assert not p.read_host(base, REGION).any()
    p.write_expect(1, 0)


def test_step_launch_count_on_cpu_is_zero(pingpong):
    """On CPU tensors the wrappers take the plain version: no launch."""
    before = tmatch_ops.launches
    pingpong.reset()
    pingpong.step([tpkt.make_udp(np.zeros(8, np.uint8), dport=9999)])
    assert tmatch_ops.launches == before
