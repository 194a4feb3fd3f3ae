"""The benchmark's frozen references against the port they stand beside,
at small sizes on the CPU: the DDT maps and unpack, the SLMP framing, the
training feed's packetizer, and the plain float32 mamba2 with its AdamW.
These tests may import the port; the references themselves may not."""
import dataclasses

import numpy as np
import pytest
import torch

from bench import program
from bench.ref import corpus as rcorpus
from bench.ref import ddt as rddt
from bench.ref import flops, frames as rf, mamba2 as R

SMALL = dict(n_layers=2, d_model=64, d_inner=128, ssm_state=16,
             ssm_heads=8, ssm_head_dim=16, conv_width=4, vocab=256,
             norm_eps=1e-5, dtype="float32", ssm_chunk=8)


def _port_cfg(m):
    return program.model_config(dict(
        name="small", family="ssm", n_layers=m["n_layers"],
        d_model=m["d_model"], n_heads=1, n_kv_heads=1, head_dim=16, d_ff=0,
        vocab=m["vocab"], layer_pattern=["ssm"], ssm_state=m["ssm_state"],
        d_inner=m["d_inner"], ssm_heads=m["ssm_heads"],
        ssm_head_dim=m["ssm_head_dim"], conv_width=m["conv_width"],
        ssm_chunk=m["ssm_chunk"], remat="none", dtype=m["dtype"],
        norm_eps=m["norm_eps"], tie_embeddings=True))


@pytest.mark.parametrize("kind,count", [("simple", 3), ("complex", 5),
                                        ("complex", 64)])
def test_ddt_maps_and_unpack_match_the_port(kind, count):
    from repro_torch.core import ddt as pddt
    c = rddt.commit(rddt.fig9(kind), count)
    p = pddt.commit(getattr(pddt, f"{kind}_ddt")(), count)
    assert (c.msg_bytes, c.mem_bytes) == (p.msg_bytes, p.mem_bytes)
    np.testing.assert_array_equal(c.msg_to_mem, p.msg_to_mem)
    np.testing.assert_array_equal(c.winner, p.mem_to_msg)
    rng = np.random.default_rng(count)
    msg = rng.integers(0, 256, c.msg_bytes, dtype=np.uint8)
    prior = rng.integers(0, 256, c.mem_bytes, dtype=np.uint8)
    np.testing.assert_array_equal(rddt.unpack(c, msg, prior),
                                  pddt.unpack_np(p, msg, prior))
    np.testing.assert_array_equal(rddt.pack(c, prior), pddt.pack_np(p, prior))


def test_overlap_needs_the_last_write():
    c = rddt.commit(rddt.fig9("complex"), 4)
    msg = np.arange(c.msg_bytes, dtype=np.int64) % 251
    first = np.full(c.mem_bytes, -1, np.int64)
    for k in range(c.msg_bytes - 1, -1, -1):       # first write wins
        first[c.msg_to_mem[k]] = msg[k]
    last = rddt.unpack(c, msg, np.full(c.mem_bytes, -1, np.int64))
    assert (first != last).any()


@pytest.mark.parametrize("nbytes", [1, 1484, 1485, 7680, 122880])
def test_slmp_framing_matches_the_port(nbytes):
    from repro_torch.core import packet as ppkt, slmp
    msg = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                 dtype=np.uint8)
    data, length, offset = rf.segment(msg, 0x0123457, 9331)
    want = slmp.segment_message(msg, 0x0123457,
                                slmp.SlmpSenderConfig(window=1, port=9331))
    wd, wl, _ = ppkt.stack_frames_np(want)
    np.testing.assert_array_equal(data, wd)
    np.testing.assert_array_equal(length, wl)
    np.testing.assert_array_equal(offset, np.arange(len(want)) * 1484)


def test_packetizer_matches_the_port_and_ingest_returns_the_rows():
    from repro_torch.train import data as tdata
    rows = rcorpus.Corpus(vocab=500, seed=7).batch(3, 2, 100)
    pk = rcorpus.Packetizer(2, 100, 9332)
    data, length, valid = pk.feed(rows, 3)
    pipe = tdata.PacketizedPipeline(vocab=500, batch=2, seq=100)
    pipe.corpus = dataclasses.replace(pipe.corpus)
    pipe.corpus.batch = lambda step, b, s: rows
    want = pipe.packets_for_step(3)
    np.testing.assert_array_equal(data, want.data)
    np.testing.assert_array_equal(length, want.length)
    out = tdata.SpinIngest(pipe, device="cpu")(want)
    np.testing.assert_array_equal(out["tokens"].numpy(), rows[:, :-1])
    np.testing.assert_array_equal(out["targets"].numpy(), rows[:, 1:])


def test_corpus_rows_differ_between_steps_and_seeds():
    c = rcorpus.Corpus(vocab=50280, seed=2 ** 31 + 5)
    a, b = c.batch(0, 4, 64), c.batch(1, 4, 64)
    assert a.shape == (4, 65) and (a != b).any()
    assert (a != rcorpus.Corpus(50280, 2 ** 31 + 6).batch(0, 4, 64)).any()
    assert len({tuple(r) for r in a}) == 4


def _loaded(m, seed):
    from repro_torch.models.model import build_model
    model = build_model(_port_cfg(m))
    params = model.init(torch.Generator().manual_seed(0))
    w = R.make_weights(m, seed, "cpu")
    program.load_weights(params, w)
    return model, params, w


@pytest.mark.parametrize("seq", [40, 70])
def test_reference_forward_matches_the_port(seq):
    model, params, w = _loaded(SMALL, 3)
    tok = torch.randint(0, SMALL["vocab"], (2, seq),
                        generator=torch.Generator().manual_seed(seq))
    got, _ = model.forward(params, {"tokens": tok})
    want = R.forward(w, SMALL, tok, block=16)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_reference_loss_grads_and_adamw_match_the_port():
    from repro_torch.train import optimizer as popt
    model, params, w = _loaded(SMALL, 4)
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, SMALL["vocab"], (2, 33), generator=g)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    from repro_torch.train import tree as T
    name_of = {id(p): k for k, p in program.leaves(params.tree())}
    leaves = T.leaves(params.tree())            # the optimizer's order
    names = [name_of[id(p)] for p in leaves]
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    ref_loss, ref_g = R.loss_and_grads(w, SMALL, *batch.values(), rows=1)
    assert abs(float(loss.detach()) - ref_loss) < 1e-5 * abs(ref_loss)
    for k, gk in zip(names, grads):
        torch.testing.assert_close(gk, ref_g[k], rtol=1e-3, atol=1e-6)
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=100, schedule="cosine",
               b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=0.5)
    ost = popt.init(params.tree())
    with torch.no_grad():
        popt.apply_updates(params.tree(), ost, list(grads),
                           popt.OptConfig(**opt))
    _, first, w1 = R.train(w, SMALL, opt, [tuple(batch.values())])
    # Adam divides by sqrt(v): where an element's gradient is near 0 the
    # two gradients' float32 rounding moves its update by up to ~0.3 % of
    # lr (3e-3), so 2e-5 absolute
    for k, p in zip(names, leaves):
        torch.testing.assert_close(p.detach(), w1[k], rtol=1e-4, atol=2e-5)
    mu = dict(program.leaves(ost.mu))
    for k in names:
        assert abs(float(mu[k].norm()) / 0.1 - first[k]) <= \
            1e-4 * max(first[k], 1e-6)


def test_fp8_control_rounds_products_and_keeps_gradients():
    m = dict(SMALL, dtype="float32")
    w = R.make_weights(m, 5, "cpu")
    tok = torch.randint(0, m["vocab"], (2, 33),
                        generator=torch.Generator().manual_seed(2))
    l32, g32 = R.loss_and_grads(w, m, tok[:, :-1], tok[:, 1:])
    l8, g8 = R.loss_and_grads(w, m, tok[:, :-1], tok[:, 1:],
                              mm=R.fp8_matmul)
    assert l8 != l32 and abs(l8 - l32) < 0.05 * l32
    for k in g32:
        n32, n8 = float(g32[k].norm()), float(g8[k].norm())
        assert n8 > 0.5 * n32 and n8 != n32


def test_weights_are_the_ports_leaves_at_full_width():
    from bench.harness import BENCH, load_json
    from repro_torch.models.model import build_model
    m = load_json(BENCH / "configs" / "mamba2-780m.json")["model"]
    params = build_model(program.model_config(m)).init_eval()
    port = {k: tuple(v.shape) for k, v in program.leaves(params.tree())}
    assert port == {k: tuple(s) for k, s in R.shapes(m).items()}
    assert "embed.lm_head" not in port              # tied, as published
    # the products' parameters: the projections and the output product
    assert flops.matmul_params(m) == 48 * (1536 * 6448 + 3072 * 1536) \
        + 1536 * 50288
    # three forwards: the products, and a layer's SSD at chunk 256 (four
    # products) and depthwise convolution, a token
    ssd = 2 * 256 * 128 + 2 * 256 * 64 * 48 + 4 * 128 * 64 * 48
    conv = 2 * 4 * (3072 + 2 * 128)
    assert flops.train_step(m, 8192) == 3 * 8192 * (
        2 * flops.matmul_params(m) + 48 * (ssd + conv))
