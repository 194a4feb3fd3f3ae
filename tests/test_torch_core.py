"""Unit-level parity of the PyTorch port's core modules with the JAX
package: packet helpers, alloc, HER/MPQ, the handler runtime and every
handler app, run on shared numpy inputs on the CPU.  Tolerance: exact (0).
Also the port's import hygiene: no ``jax``, no ``repro``, and no silent
CPU fallback when CUDA is asked for.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import alloc as jalloc  # noqa: E402
from repro.core import apps as japps  # noqa: E402
from repro.core import checksum as jck  # noqa: E402
from repro.core import handlers as jH  # noqa: E402
from repro.core import her as jher  # noqa: E402
from repro.core import packet as jpkt  # noqa: E402
from repro.core import slmp as jslmp  # noqa: E402
from repro_torch.core import alloc as talloc  # noqa: E402
from repro_torch.core import apps as tapps  # noqa: E402
from repro_torch.core import checksum as tck  # noqa: E402
from repro_torch.core import ddt as tddt  # noqa: E402
from repro_torch.core import handlers as tH  # noqa: E402
from repro_torch.core import her as ther  # noqa: E402
from repro_torch.core import packet as tpkt  # noqa: E402
from repro_torch.core import slmp as tslmp  # noqa: E402
from repro_torch.core.scatter import scatter_set_  # noqa: E402

CPU = "cpu"
SRC = Path(__file__).resolve().parents[1] / "src"


def eq(t, j, msg=""):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    if j.dtype == np.uint32:
        t = t.astype(np.uint32)
    np.testing.assert_array_equal(t, j, err_msg=msg)


# ------------------------------------------------------------------ packet
def test_packet_words_and_field_reads():
    data = np.random.default_rng(0).integers(0, 256, (5, tpkt.MTU)
                                             ).astype(np.uint8)
    t, j = torch.as_tensor(data), jnp.asarray(data)
    b = tpkt.PacketBatch.from_numpy(data, np.zeros(5, np.int32),
                                    np.ones(5, bool), CPU)
    eq(b.words(), jpkt.bytes_to_u32be(j))
    eq(tpkt.bytes_to_u16be(t), jpkt.bytes_to_u16be(j))
    for off in (0, 13, 42, 44, 1532):
        eq(tpkt.read_u32(t, off), jpkt.read_u32(j, off), f"u32@{off}")
        eq(tpkt.read_u16(t, off), jpkt.read_u16(j, off), f"u16@{off}")


def test_packet_writes_and_swaps():
    data = np.random.default_rng(1).integers(0, 256, (3, tpkt.MTU)
                                             ).astype(np.uint8)
    vals = np.array([0xDEADBEEF, 7, 0xFFFF0001], np.uint32)
    t, j = torch.as_tensor(data), jnp.asarray(data)
    tv = torch.as_tensor(vals.astype(np.int64))
    jv = jnp.asarray(vals)
    eq(tpkt.write_u32(t, 44, tv), jax.vmap(
        lambda d, v: jpkt.write_u32(d, 44, v))(j, jv))
    eq(tpkt.write_u16(t, 42, tv), jax.vmap(
        lambda d, v: jpkt.write_u16(d, 42, v))(j, jv))
    eq(tpkt.swap_bytes(t, 0, 6, 6), jpkt.swap_bytes(j, 0, 6, 6))
    assert (t.numpy() == data).all()          # helpers do not mutate


def test_u32_to_i32_wraps_like_astype():
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    eq(tpkt.u32_to_i32(torch.as_tensor(vals.astype(np.int64))),
       jnp.asarray(vals).astype(jnp.int32))


def test_stack_frames_matches_jax():
    frames = [tpkt.make_icmp_echo(np.arange(9, dtype=np.uint8)),
              tpkt.make_slmp(3, 10, 1, np.arange(30, dtype=np.uint8))]
    tb = tpkt.stack_frames(frames, n=4, device=CPU)
    jb = jpkt.stack_frames(frames, n=4)
    for a, b in zip(tb.numpy(), (jb.data, jb.length, jb.valid)):
        eq(a, b)


def test_scatter_set_matches_jax_drop_mode():
    rng = np.random.default_rng(2)
    for size, k in ((8, 40), (100, 7), (5, 0), (1, 9)):
        dst = rng.integers(0, 100, size).astype(np.int32)
        idx = rng.integers(-size - 3, size + 3, k).astype(np.int64)
        val = rng.integers(0, 100, k).astype(np.int32)
        got = scatter_set_(torch.as_tensor(dst.copy()), torch.as_tensor(idx),
                           torch.as_tensor(val))
        want = jnp.asarray(dst).at[jnp.asarray(idx)].set(jnp.asarray(val),
                                                         mode="drop")
        eq(got, want, f"size={size} k={k}")


# ------------------------------------------------------------------- alloc
def _alloc_equal(ts, js):
    for f in ("small_fifo", "small_head", "small_count", "large_fifo",
              "large_head", "large_count"):
        eq(getattr(ts, f), getattr(js, f), f)


def test_alloc_free_random_sequences():
    rng = np.random.default_rng(3)
    ts = talloc.make_state(n_small=12, n_large=5, device=CPU)
    js = jalloc.make_state(n_small=12, n_large=5)
    held = []
    for it in range(30):
        n = 8
        sizes = rng.choice([64, 128, 129, 1500], n).astype(np.int32)
        valid = rng.random(n) < 0.7
        ts, taddr, tok = talloc.alloc(ts, torch.as_tensor(sizes),
                                      torch.as_tensor(valid))
        js, jaddr, jok = jalloc.alloc(js, jnp.asarray(sizes),
                                      jnp.asarray(valid))
        eq(taddr, jaddr)
        eq(tok, jok)
        _alloc_equal(ts, js)
        held += [int(a) for a in taddr.numpy() if a >= 0]
        rng.shuffle(held)
        k = int(rng.integers(0, len(held) + 1))
        addr = np.full(n + 4, -1, np.int32)
        take = held[:min(k, n + 4)]
        held = held[len(take):]
        addr[:len(take)] = take
        do = addr >= 0
        do[0] = do[0] and rng.random() < 0.8
        if not do[0] and addr[0] >= 0:
            held.append(int(addr[0]))
        ts = talloc.free(ts, torch.as_tensor(addr), torch.as_tensor(do))
        js = jalloc.free(js, jnp.asarray(addr), jnp.asarray(do))
        _alloc_equal(ts, js)


# --------------------------------------------------------------------- her
def test_her_generate_random_sequences_with_collisions():
    rng = np.random.default_rng(4)
    tm, jm = ther.make_mpq(8, device=CPU), jher.make_mpq(8)
    for it in range(25):
        n = 8
        ctx = rng.integers(-1, 3, n).astype(np.int32)
        msg = rng.choice(np.array([1, 9, 17, 2, 0xFFFFFFF1, 3], np.uint32), n)
        eom = rng.random(n) < 0.3
        valid = rng.random(n) < 0.8
        addr = np.arange(n, dtype=np.int32)
        size = np.full(n, 100, np.int32)
        tm, th = ther.generate(
            tm, torch.as_tensor(ctx), torch.as_tensor(addr),
            torch.as_tensor(size), torch.as_tensor(msg.astype(np.int64)),
            torch.as_tensor(eom), torch.as_tensor(valid))
        jm, jh = jher.generate(jm, jnp.asarray(ctx), jnp.asarray(addr),
                               jnp.asarray(size), jnp.asarray(msg),
                               jnp.asarray(eom), jnp.asarray(valid))
        for f in ("key", "active", "evictions"):
            eq(getattr(tm, f), getattr(jm, f), f)
        for f in ("lane", "slot", "run_header", "run_tail"):
            eq(getattr(th, f), getattr(jh, f), f)
    assert int(tm.evictions) > 0


# ---------------------------------------------------------------- handlers
N = 6


def _args(seed, expect=None, ports=None):
    """Random HandlerArgs in both packages.  Frames are wire-correct SLMP
    segments (or ICMP echoes) followed by random L2 bytes past length."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (N, tpkt.MTU)).astype(np.uint8)
    length = np.zeros(N, np.int32)
    msg_id = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    for i in range(N):
        pay = rng.integers(0, 256, int(rng.integers(1, 300))).astype(np.uint8)
        if ports is None:
            f = tpkt.make_icmp_echo(pay, seq=i)
        else:
            # odd lanes: any u32; even lanes: an MPI-style id with a small
            # datatype (0..2) and slot (0..7) field
            mid = int(msg_id[i]) if i % 2 else \
                (int(rng.integers(0, 3)) << 16) | int(rng.integers(0, 8))
            f = tpkt.make_slmp(mid, int(rng.integers(0, 400)),
                               int(rng.integers(0, 8)), pay,
                               dport=ports[i % len(ports)])
            msg_id[i] = mid
        data[i, :len(f)] = f
        length[i] = len(f)
    eom = rng.random(N) < 0.5
    ctx = rng.integers(0, 2, N).astype(np.int32)
    ms = rng.integers(-5, 5, (N, jH.MSG_STATE_DIM)).astype(np.int32)
    cycles = np.full(N, 11, np.int32)
    expect = np.zeros(1, np.uint32) if expect is None else expect
    t = tH.HandlerArgs(
        pkt=torch.as_tensor(data), pkt_len=torch.as_tensor(length),
        msg_id=torch.as_tensor(msg_id.astype(np.int64)),
        eom=torch.as_tensor(eom), ctx=torch.as_tensor(ctx),
        msg_state=torch.as_tensor(ms), cycles=torch.as_tensor(cycles),
        expect=torch.as_tensor(expect.astype(np.int64)))
    j = jH.HandlerArgs(
        pkt=jnp.asarray(data), pkt_len=jnp.asarray(length),
        msg_id=jnp.asarray(msg_id), eom=jnp.asarray(eom),
        ctx=jnp.asarray(ctx), msg_state=jnp.asarray(ms),
        cycles=jnp.asarray(cycles), expect=jnp.asarray(expect))
    mask = rng.random(N) < 0.7
    return t, j, mask


def _out_equal(tout, jout):
    for f in ("egress_data", "egress_len", "egress_valid", "dma_off",
              "dma_val", "state_delta", "counter_queue", "counter_val"):
        eq(getattr(tout, f), getattr(jout, f), f)


def _c_ddt():
    return tddt.commit(tddt.complex_ddt(), count=4)


def _mpi_tables():
    cs = tddt.commit(tddt.simple_ddt(), count=2)
    cc = tddt.commit(tddt.complex_ddt(), count=3)
    maps = np.full((2, cc.msg_bytes), -1, np.int32)
    maps[0, :cs.msg_bytes] = cs.msg_to_mem
    maps[1, :cc.msg_bytes] = cc.msg_to_mem
    return maps, np.array([cs.msg_bytes, cc.msg_bytes], np.int32)


def _handler_pairs():
    c = _c_ddt()
    maps, lens = _mpi_tables()
    t_ddt = tapps.make_ddt_context(c, msgs_in_flight=4, device=CPU)
    j_ddt = japps.make_ddt_context(c, msgs_in_flight=4)
    t_eag = tapps.make_mpi_eager_context(9400, 4, 512)
    j_eag = japps.make_mpi_eager_context(9400, 4, 512)
    t_mpi = tapps.make_mpi_ddt_context(maps, lens, 1024, 3, 9401, device=CPU)
    j_mpi = japps.make_mpi_ddt_context(maps, lens, 1024, 3, 9401)
    return {
        "icmp_echo": (tapps.icmp_echo_packet_handler,
                      japps.icmp_echo_packet_handler, None),
        "udp_pingpong": (tapps.udp_pingpong_packet_handler,
                         japps.udp_pingpong_packet_handler, None),
        "icmp_host": (tapps.icmp_to_host_packet_handler,
                      japps.icmp_to_host_packet_handler, None),
        "slmp_header": (tslmp.slmp_header_handler,
                        jslmp.slmp_header_handler, [9330]),
        "slmp_packet": (tslmp.slmp_packet_handler,
                        jslmp.slmp_packet_handler, [9330]),
        "slmp_tail": (tslmp.slmp_tail_handler, jslmp.slmp_tail_handler,
                      [9330]),
        "ddt": (t_ddt.packet, j_ddt.packet, [9331]),
        "mpi_eager": (t_eag.packet, j_eag.packet, [9400]),
        "mpi_ddt": (t_mpi.packet, j_mpi.packet, [9401]),
    }


@pytest.mark.parametrize("name", ["icmp_echo", "udp_pingpong", "icmp_host",
                                  "slmp_header", "slmp_packet", "slmp_tail",
                                  "ddt", "mpi_eager", "mpi_ddt"])
def test_handler_app_run_phase_matches_jax(name):
    tfn, jfn, ports = _handler_pairs()[name]
    dma_lanes = 0
    for seed in range(3):
        expect = None
        if name == "mpi_ddt":
            expect = np.zeros(3, np.uint32)
        t, j, mask = _args(seed, expect, ports)
        if name == "mpi_ddt":
            # arm some lanes' slots with their msg_id (others stay stale)
            mids = t.msg_id.numpy()
            for i in range(0, N, 2):
                expect[(mids[i] & 0xFFFF) % 3] = mids[i]
            t.expect = torch.as_tensor(expect.astype(np.int64))
            j = j._replace(expect=jnp.asarray(expect))
        tout = tH.run_phase(tfn, t, None, torch.as_tensor(mask))
        jout = jH.run_phase(jfn, j, None, jnp.asarray(mask))
        _out_equal(tout, jout)
        dma_lanes += int((tout.dma_off >= 0).any(dim=1).sum())
    if name in ("icmp_host", "slmp_packet", "ddt", "mpi_eager", "mpi_ddt"):
        assert dma_lanes > 0


def test_internet_checksum_1_reads_past_odd_length():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (N, tpkt.MTU)).astype(np.uint8)
    length = rng.integers(34, 400, N).astype(np.int32)
    got = tck.internet_checksum_1(torch.as_tensor(data),
                                  torch.as_tensor(length), tpkt.L4_BASE)
    want = jax.vmap(lambda d, ln: jck.internet_checksum_1(
        d, ln, jpkt.L4_BASE))(jnp.asarray(data), jnp.asarray(length))
    eq(got, want)


def test_runtime_helpers_match_jax():
    t, j, _ = _args(6)
    vals = np.array([1, 0xFFFFFFFF, 5, 7, 2**31, 9], np.int64)
    offs = np.array([0, 3, 100, 7, 9, 11], np.int32)

    def jrun(fn):
        return jax.vmap(fn)(jnp.asarray(offs), jnp.asarray(vals.astype(
            np.uint32)), j.pkt)

    tout = tH.none_out(N, CPU)
    tout = tH.write_u64_to_host(tout, torch.as_tensor(offs),
                                torch.as_tensor(vals))
    tout = tH.spin_dma_to_host(tout, torch.as_tensor(offs) + 4, t.pkt, 20,
                               src_start=10)
    tout = tH.push_counter(tout, 2, torch.as_tensor(offs))
    tout = tH.add_msg_state(tout, 3, torch.as_tensor(offs))
    tout = tH.spin_send_packet(tout, t.pkt, t.pkt_len)

    def jfn(off, v, pk):
        o = jH.none_out()
        o = jH.write_u64_to_host(o, off, v)
        o = jH.spin_dma_to_host(o, off + 4, pk, 20, src_start=10)
        o = jH.push_counter(o, 2, off)
        o = jH.add_msg_state(o, 3, off)
        return jH.spin_send_packet(o, pk, 0)

    jout = jrun(jfn)
    jout = jout._replace(egress_len=jnp.asarray(t.pkt_len.numpy()))
    _out_equal(tout, jout)


# ------------------------------------------------------------ import rules
def test_port_imports_neither_jax_nor_repro():
    code = textwrap.dedent(f"""
        import importlib.abc, pkgutil, importlib, sys
        sys.path.insert(0, {str(SRC)!r})

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "repro", "triton")]
        assert not bad, bad
        print(len(names))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20
    for f in (SRC / "repro_torch").rglob("*.py"):
        text = f.read_text()
        assert "import jax" not in text and "from repro." not in text, f
        assert "from repro import" not in text and "import repro\n" \
            not in text, f


def test_cuda_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        nic = tapps.make_icmp_context()
        from repro_torch.core.spin_nic import SpinNIC
        assert SpinNIC([nic]).device.type == "cuda"
        return
    from repro_torch.core.spin_nic import SpinNIC
    from repro_torch.train.data import PacketizedPipeline, SpinIngest
    with pytest.raises(RuntimeError, match="cuda"):
        SpinNIC([tapps.make_icmp_context()])
    with pytest.raises(RuntimeError, match="cuda"):
        SpinIngest(PacketizedPipeline(vocab=50, batch=1, seq=8))
    with pytest.raises(RuntimeError, match="cuda"):
        tpkt.stack_frames([tpkt.make_udp(np.zeros(4, np.uint8))])
