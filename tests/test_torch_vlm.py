"""The vlm family (qwen2-vl) of the PyTorch port against the JAX package, on
the CPU: ``apply_mrope``, the image embeddings prepended to the text, the
M-RoPE positions of the batch and of decode, the q/k/v biases, the vlm
branch of ``loss_fn`` (image positions carry no loss) with every gradient,
``ServeEngine`` (a prompt's position counts the image tokens) and the
serving CLI, on the qwen2-vl-2b smoke config (3 layers, d_model 64, 4
heads over 2 KV heads of 16, 8 image tokens).  Helpers come from
tests/test_torch_encdec.py.

Two things the serving inputs alone would hide, tested here:
* ``shapes`` gives all three M-RoPE components the same positions, and
  with equal components ``apply_mrope`` is ``apply_rope`` bit for bit;
  the sections (in frequency pairs) only show with components that
  differ, so the model tests draw temporal, height and width apart.
* The JAX init makes the q/k/v biases zero, which would hide a missing
  bias add: the tests set them nonzero in the JAX tree before conversion.

Tolerances, float32: ``apply_mrope`` 1e-5; logits atol and rtol 1e-4,
tokens equal; ``loss_fn`` 1e-5 relative, gradients 1e-5 absolute plus
1e-4 relative (as tests/test_torch_encdec.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jL  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from test_torch_encdec import (_f32, batch_arrays, both, loss_vs_jax,  # noqa: E402,E501
                               model_pair, serve_vs_jax, to_port)
from test_torch_moe import serve_cli  # noqa: E402

ARCH = "qwen2-vl-2b"
F32_TOL = 1e-5
LOGIT_TOL = 1e-4


def _distinct_positions(b, s, seed):
    """(3, B, S) M-RoPE positions whose components differ: temporal
    0..S-1, height and width as for an image of rows of 4 patches, then
    random offsets per batch row."""
    rng = np.random.default_rng(seed)
    i = np.arange(s)
    pos = np.stack([np.broadcast_to(i, (b, s)),
                    np.broadcast_to(i // 4, (b, s)) + rng.integers(
                        0, 50, (b, 1)),
                    np.broadcast_to(i % 4, (b, s)) + rng.integers(
                        0, 50, (b, 1))])
    return pos.astype(np.int32)


def _with_biases(jp, seed):
    """The JAX tree with every q/k/v bias drawn nonzero."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(f"['{b}']" in name for b in ("bq", "bk", "bv")):
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.5,
                               leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, jp)


# ------------------------------------------------------------ M-RoPE
@pytest.mark.parametrize("d,sections", [(16, None), (128, None),
                                        (32, (4, 4, 8))])
def test_apply_mrope_distinct_components_vs_jax(d, sections):
    """Distinct (temporal, height, width) components: the port equals JAX;
    each component moves only its own section's frequency pairs."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 12, 3, d)).astype(np.float32)
    pos = _distinct_positions(2, 12, seed=d)
    want = jL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = tL.apply_mrope(torch.tensor(x), torch.tensor(pos), 1e6, sections)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=F32_TOL,
                               rtol=F32_TOL)
    secs = sections or tL.mrope_sections(d)
    if sections is None:
        assert secs == (d // 8, (d // 2 - d // 8) // 2,
                        d // 2 - d // 8 - (d // 2 - d // 8) // 2)
        if d == 128:
            assert secs == (16, 24, 24)
    edges = np.cumsum((0,) + tuple(secs))
    for c in range(3):                      # move one component alone
        moved = pos.copy()
        moved[c] += 7
        diff = (tL.apply_mrope(torch.tensor(x), torch.tensor(moved), 1e6,
                               sections) - got).abs().amax(dim=(0, 1, 2))
        pairs = torch.maximum(diff[:d // 2], diff[d // 2:]).numpy()
        lo, hi = edges[c], edges[c + 1]
        assert pairs[lo:hi].min() > 0
        assert pairs[:lo].max(initial=0) == pairs[hi:].max(initial=0) == 0


def test_apply_mrope_with_equal_components_is_apply_rope():
    x = torch.tensor(np.random.default_rng(1).normal(size=(2, 9, 2, 128)),
                     dtype=torch.float32)
    p = torch.arange(9).expand(2, 9)
    assert torch.equal(tL.apply_mrope(x, p.expand(3, 2, 9), 1e6),
                       tL.apply_rope(x, p, 1e6))
    with pytest.raises(ValueError, match="sections"):
        tL.apply_mrope(x, p.expand(3, 2, 9), 1e6, (16, 24, 23))


# ------------------------------------------------------------ whole model
def test_shapes_vlm_inputs_vs_jax():
    """``img = min(img_tokens, seq // 2)``, ``text = seq - img``; the same
    arrays from one seed (checked inside ``batch_arrays``)."""
    jc, tc, *_ = model_pair(ARCH)
    for seq, img in ((24, 8), (10, 5)):
        nb = batch_arrays(jc, tc, seq, 3, seed=seq, train=True)
        assert nb["tokens"].shape == nb["targets"].shape == (3, seq - img)
        assert nb["img_embeds"].shape == (3, img, jc.d_model)
        assert nb["positions"].shape == (3, 3, seq)
        assert (nb["positions"] == np.arange(seq)).all()


@pytest.mark.parametrize("positions", ["shapes", "distinct"])
def test_forward_prefill_decode_generate_vs_jax(positions):
    """Nonzero q/k/v biases; M-RoPE positions from ``shapes`` (equal
    components) or drawn apart; forward logits, prefill, 4 teacher-forced
    decode steps (positions (3, B, 1) = pos) and ``ServeEngine`` tokens."""
    jc, tc, jm, tm, jp = model_pair(ARCH, seed=2)
    jp = _with_biases(jp, seed=3)
    pair = (jc, tc, jm, tm, jp)
    tp = to_port(tc, jp)
    nb = batch_arrays(jc, tc, 24, 2, seed=4)
    if positions == "distinct":
        nb["positions"] = _distinct_positions(2, 24, seed=5)
    jb, tb = both(dict(nb, targets=np.zeros_like(nb["tokens"])))
    want, _ = jax.jit(jm.forward)(jp, jb)
    with torch.inference_mode():
        got, _ = tm.forward(tp, tb)
    assert got.shape == (2, 24, jc.padded_vocab)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    serve_vs_jax(pair, tp, nb)


def test_biases_and_positions_reach_the_logits():
    """The port's logits move with the biases and with the M-RoPE
    components: neither is silently dropped."""
    jc, tc, jm, tm, jp = model_pair(ARCH, seed=6)
    tp_bias = to_port(tc, _with_biases(jp, seed=7))
    tp_zero = to_port(tc, jp)
    nb = batch_arrays(jc, tc, 24, 2, seed=8)
    _, tb = both(nb)
    _, tb_moved = both(dict(nb, positions=_distinct_positions(2, 24, 9)))
    with torch.inference_mode():
        base, _ = tm.forward(tp_bias, tb)
        for other in (tm.forward(tp_zero, tb)[0],
                      tm.forward(tp_bias, tb_moved)[0]):
            assert (other - base).abs().max() > 1e-3


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_gradient_vs_jax(remat):
    """The vlm branch of ``loss_fn``: targets padded with 0 over the image
    positions, which carry no loss; nonzero biases, distinct positions."""
    jc, tc, jm, tm, jp = model_pair(ARCH, seed=10, remat=remat)
    jp = _with_biases(jp, seed=11)
    pair = (jc, tc, jm, tm, jp)
    nb = batch_arrays(jc, tc, 20, 2, seed=12, train=True)
    nb["positions"] = _distinct_positions(2, 20, seed=13)
    names = loss_vs_jax(pair, to_port(tc, jp), nb)
    assert any("bq" in n for n in names)
    # image positions carry no loss: their logits get no gradient
    tp = to_port(tc, jp)
    _, tb = both(nb)
    logits, _ = tm.forward(tp, tb)
    logits = logits.detach().requires_grad_(True)
    tm_forward = tm.forward
    tm.forward = lambda p, b: (logits, torch.zeros(()))
    try:
        loss, _ = tm.loss_fn(tp, tb)
    finally:
        tm.forward = tm_forward
    (g,) = torch.autograd.grad(loss, logits)
    n_img = nb["img_embeds"].shape[1]
    assert not g[:, :n_img].any() and g[:, n_img:].abs().sum() > 0


def test_serve_cli_smoke_on_cpu():
    serve_cli(ARCH)
