"""The packetized training-data ingest (Fig 10's device half) and the
overlap engine of the PyTorch port, against the JAX package on the CPU.
Tolerance: exact (0) for packets and tokens; the overlap report is an
observation, checked for sanity only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ddt import ops as jddt_ops  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro_torch.core import ddt as tddt  # noqa: E402
from repro_torch.core import overlap as toverlap  # noqa: E402
from repro_torch.core import packet as tpkt  # noqa: E402
from repro_torch.kernels.ddt import ops as tddt_ops  # noqa: E402
from repro_torch.kernels.matcher import ops as tmatch_ops  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def pipes():
    j = jdata.PacketizedPipeline(vocab=97, batch=3, seq=40)
    t = tdata.PacketizedPipeline(vocab=97, batch=3, seq=40)
    return j, t, jdata.SpinIngest(j), tdata.SpinIngest(t, device=CPU)


def test_pipeline_host_half_is_identical(pipes):
    j, t, _, _ = pipes
    assert (t.msg_bytes, t.n_packets) == (j.msg_bytes, j.n_packets)
    np.testing.assert_array_equal(t.pack_idx, j.pack_idx)
    np.testing.assert_array_equal(t.unpack_idx, j.unpack_idx)
    for step in (0, 3):
        a, b = t.packets_for_step(step), j.packets_for_step(step)
        for f in ("data", "length", "valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.tokens_shape == b.tokens_shape


@pytest.mark.parametrize("step", [0, 1, 5])
def test_spin_ingest_tokens_equal_jax_and_corpus(pipes, step):
    j, t, ji, ti = pipes
    raw = t.packets_for_step(step)
    got = ti(raw)
    want = ji(raw)
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    toks = t.corpus.batch(step, t.batch, t.seq)
    np.testing.assert_array_equal(got["tokens"].numpy(), toks[:, :-1])
    np.testing.assert_array_equal(got["targets"].numpy(), toks[:, 1:])


def test_spin_ingest_repeated_offsets_and_foreign_frames(pipes):
    """Hazard: a retransmitted segment with different bytes and a frame
    for another port in the same batch; the later lane wins a repeated
    message offset, exactly as in the JAX package."""
    j, t, ji, ti = pipes
    raw = t.packets_for_step(2)
    data, length, valid = raw.data.copy(), raw.length.copy(), \
        raw.valid.copy()
    bogus = tpkt.make_slmp(2, 100, 0, np.full(300, 0x5A, np.uint8),
                           dport=t.port)
    other = tpkt.make_slmp(2, 0, 0, np.full(300, 0x11, np.uint8), dport=1)
    extra = tpkt.stack_frames_np([bogus, other])
    raw.data = np.concatenate([data, extra[0]])
    raw.length = np.concatenate([length, extra[1]])
    raw.valid = np.concatenate([valid, extra[2]])
    got, want = ti(raw), ji(raw)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    toks = t.corpus.batch(2, t.batch, t.seq)
    assert not np.array_equal(got["tokens"].numpy(), toks[:, :-1])


def _fig9_maps(kind, count=5):
    base = tddt.complex_ddt() if kind == "complex" else tddt.simple_ddt()
    return tddt.element_maps(tddt.commit(base, count=count), 4)


@pytest.mark.parametrize("maps", ["pipeline", "simple", "complex",
                                  "complex_reversed"])
def test_compose_maps_equals_two_level_jax_gather(pipes, maps):
    """compose_maps against two gathers of the JAX package (its reference
    gather, fill 0 at both levels): the ingest's own maps, and Fig 9 maps
    with holes, with indices past either source and with -1 in the outer
    map."""
    _, t, _, ti = pipes
    if maps == "pipeline":
        n_tok = t.batch * (t.seq + 1)
        outer, inner, n_src = t.pack_idx[:n_tok], t.unpack_idx, \
            t.msg_bytes // 4
    else:
        pack, unpack = _fig9_maps(maps.split("_")[0])
        outer, inner = (pack, unpack) if maps != "complex_reversed" else \
            (unpack, pack)
        n_src = int(inner.max()) - 3             # some inner idx >= n_src
        outer = np.concatenate([outer, [len(inner) + 4, -1, len(inner) - 1,
                                        0]]).astype(np.int32)
    assert (inner < 0).any() or maps == "complex_reversed" or \
        maps == "pipeline"
    rng = np.random.default_rng(len(outer))
    src = rng.normal(size=n_src).astype(np.float32)
    src[::5] = -0.0
    src.view(np.uint32)[1::7] = 0x7FC01234              # NaN payloads
    m = tddt.compose_maps(torch.as_tensor(outer), torch.as_tensor(inner),
                          n_src)
    assert m.dtype == torch.int32 and m.shape == (len(outer),)
    assert int(m.max()) < n_src          # the map stays inside the source
    got = tddt_ops.gather(torch.as_tensor(src), m).numpy()
    want = np.asarray(jddt_ops.gather(jddt_ops.gather(
        jnp.asarray(src), jnp.asarray(inner)), jnp.asarray(outer)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if maps == "pipeline":
        assert torch.equal(m, ti.tok_idx)


@pytest.mark.parametrize("kind", ["simple", "complex"])
def test_one_gather_ingest_equals_jax_on_fig9_maps(kind):
    """SpinIngest's one gather by the composed map against the JAX
    package's two gathers, with the pipeline's maps swapped for Fig 9 maps:
    holes in the unpack map, unpack indices past the message, a token index
    past the buffer and a -1."""
    j = jdata.PacketizedPipeline(vocab=97, batch=3, seq=40, seed=4)
    t = tdata.PacketizedPipeline(vocab=97, batch=3, seq=40, seed=4)
    raw = t.packets_for_step(1)
    pack, unpack = _fig9_maps(kind, count=10 if kind == "simple" else 5)
    assert len(pack) >= t.batch * (t.seq + 1) and (unpack < 0).any()
    assert unpack.max() >= t.msg_bytes // 4
    pack = pack.copy()
    pack[5], pack[9] = len(unpack) + 7, -1
    for pl in (j, t):
        pl.pack_idx, pl.unpack_idx, pl.mem_elems = pack, unpack, len(unpack)
    got = tdata.SpinIngest(t, device=CPU)(raw)
    want = jdata.SpinIngest(j)(raw)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["tokens"][0, 9] == 0          # the -1 token index: fill


def test_spin_ingest_on_cpu_launches_no_kernel(pipes):
    _, t, _, ti = pipes
    m, g = tmatch_ops.launches, tddt_ops.launches
    ti(t.packets_for_step(0))
    assert (tmatch_ops.launches, tddt_ops.launches) == (m, g)


def test_prefetch_iterator_order(pipes):
    _, t, _, ti = pipes
    feeds = list(tdata.prefetch_iterator(t, steps=4))
    assert len(feeds) == 4
    for i, f in enumerate(feeds):
        np.testing.assert_array_equal(
            ti(f)["tokens"].numpy(), t.corpus.batch(i, t.batch, t.seq)[:, :-1])


def test_overlap_loops_agree_and_report(pipes):
    _, t, _, ti = pipes
    feeds = [t.packets_for_step(i) for i in range(4)]
    w = torch.as_tensor(np.random.default_rng(0).normal(size=(32, 32))
                        .astype(np.float32))

    def compute(state, batch):
        return state @ w * 1e-2 + batch["tokens"].sum().to(torch.float32)

    s0 = torch.eye(32)
    seq_out, seq = toverlap.sequential_loop(ti, compute, feeds, s0,
                                            device=CPU)
    ovl_out, ovl = toverlap.overlapped_loop(ti, compute, feeds, s0,
                                            device=CPU)
    assert torch.equal(seq_out, ovl_out)
    for rep in (seq, ovl):
        assert rep.steps == 4 and 0.0 <= rep.overlap_ratio <= 1.0
        assert rep.wall_s > 0


def test_fuse_ingest_into_step():
    fused = toverlap.fuse_ingest_into_step(lambda x: x + 1.0,
                                           lambda s, b: s + b.sum())
    assert float(fused(torch.zeros(()), torch.ones(4))) == 8.0
