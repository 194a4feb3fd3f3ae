"""The encdec family (whisper) of the PyTorch port against the JAX package,
on the CPU: K4's per-batch key length ``kv_len``, the padded-key rule of
``models/attention.py``, ``sinusoid_positions``, the encoder, the
cross-attention and its caches, ``encode_for_decode``, ``loss_fn`` and
every gradient, ``ServeEngine`` and the serving CLI, on the whisper-tiny
smoke config (2 encoder + 2 decoder layers, d_model 48, head_dim 24).
Inputs are drawn with numpy by both packages' ``shapes``; JAX weights
come across through ``convert.params_from_numpy``.  The JAX side runs its
plain ``blockwise_attention``, as its own tests run the models.

Risks of the reference that the tests pin on both sides:
* ``blockwise_attention`` pads K/V with zero rows up to a multiple of
  ``min(block_k, Sk)`` and masks them only under ``causal`` or
  ``kv_len``, so whisper's encoder softmax (block 512) takes them in.  At
  ``enc_seq`` 600 (a 424-row pad) the port equals JAX, and JAX is more
  than 1e-2 off exact attention.
* The prefill's cross-attention masks keys past the batch's ``enc_len``,
  then sets the cache's ``enc_len`` to the full length, so decode attends
  to every frame.  With ragged ``enc_len`` both packages do that.

Tolerances, float32: K4's plain version and layers 1e-5 (the same
arithmetic up to summation order); whole model logits atol and rtol 1e-4
(through four to six layers; as tests/test_torch_models.py); generated
tokens equal; ``loss_fn`` 1e-5 relative, gradients 1e-5 absolute plus
1e-4 relative (as tests/test_torch_train_model.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tfa_ref  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402
from test_torch_moe import serve_cli  # noqa: E402

ARCH = "whisper-tiny"
F32_TOL = 1e-5
LOGIT_TOL = 1e-4


def _f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ------------------------------------------------------------ shared helpers
def model_pair(arch, seed=0, **over):
    """(jc, tc, jm, tm, jp) for the float32 smoke config of ``arch`` with
    ``over`` replaced in both packages' configs; JAX weights from
    ``seed``."""
    jc = dataclasses.replace(jconfigs.get_smoke_config(arch),
                             dtype="float32", **over)
    tc = dataclasses.replace(tconfigs.get_smoke_config(arch),
                             dtype="float32", **over)
    jm, tm = jbuild(jc), tbuild(tc)
    return jc, tc, jm, tm, jm.init(jax.random.key(seed))


def to_port(tc, jp):
    """The JAX weights as the port's ``Params`` on the CPU."""
    return convert.params_from_numpy(
        tc, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        device="cpu")


def batch_arrays(jc, tc, seq, batch, seed=0, train=False):
    """One seed through both packages' ``shapes``: the arrays must be
    equal.  Returns the port's numpy batch."""
    jfn, tfn = ((jshapes.train_batch_specs, tshapes.train_batch_specs)
                if train else (jshapes.prefill_batch_specs,
                               tshapes.prefill_batch_specs))
    jb = jfn(jc, seq, batch, concrete=True, rng=np.random.default_rng(seed))
    tb = tfn(tc, seq, batch, rng=np.random.default_rng(seed))
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert tb[k].shape == jb[k].shape, k
        np.testing.assert_array_equal(tb[k], np.asarray(jb[k], tb[k].dtype),
                                      err_msg=k)
    return tb


def both(nb):
    """A numpy batch as (JAX batch, port batch)."""
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.tensor(v) for k, v in nb.items()})


def prompt_len(nb):
    return nb["tokens"].shape[1] + (nb["img_embeds"].shape[1]
                                    if "img_embeds" in nb else 0)


def serve_vs_jax(pair, tp, nb, steps=4, gen=6, seed=7):
    """Float32 ``prefill``, ``steps`` teacher-forced ``decode_step``s and
    ``ServeEngine.generate`` of the port against the JAX package's on the
    batch ``nb`` (logits within LOGIT_TOL, tokens equal).  Returns the
    port's prefill cache."""
    jc, tc, jm, tm, jp = pair
    jb, tb = both(nb)
    s, batch = prompt_len(nb), nb["tokens"].shape[0]
    max_len = s + max(steps, gen) + 8
    jlog, jcache = jax.jit(lambda p, b: jm.prefill(p, b, max_len))(jp, jb)
    with torch.inference_mode():
        tlog, tcache = tm.prefill(tp, tb, max_len)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    forced = np.random.default_rng(seed).integers(
        0, jc.vocab, (batch, steps)).astype(np.int32)
    jdecode = jax.jit(jm.decode_step)
    for i in range(steps):
        jl, jcache = jdecode(jp, jnp.asarray(forced[:, i:i + 1]), jcache,
                             jnp.int32(s + i))
        with torch.inference_mode():
            tl, _ = tm.decode_step(tp, torch.tensor(forced[:, i:i + 1]),
                                   tcache, s + i)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"step {i}")
    jeng, teng = JEngine(jm, jp, max_len), TEngine(tm, tp, max_len)
    jtoks, _ = jeng.generate(jeng.prefill(jb), gen)
    tstate = teng.prefill(tb)
    assert tstate.pos == s
    ttoks, tstate = teng.generate(tstate, gen)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    return tcache


def loss_vs_jax(pair, tp, nb):
    """``loss_fn`` (loss, ce) and every parameter's gradient of the port
    (autograd through K4's plain version and its plain backward) against
    ``jax.value_and_grad`` of the JAX package's."""
    jc, tc, jm, tm, jp = pair
    jb, tb = both(nb)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, jb)
    leaves = T.leaves(tp.tree())
    for p in leaves:
        p.requires_grad_(True)
    loss, met = tm.loss_fn(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(met["ce"]) == pytest.approx(float(jmet["ce"]), rel=1e-5)
    want = T.leaves(convert.port_layout(tc, jax.tree.map(np.asarray, jg)))
    names = [n for n, _ in T.flatten_with_names(tp.tree())]
    assert len(want) == len(grads) == len(names)
    for name, g, w in zip(names, grads, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    assert max(float(np.abs(w).max()) for w in want) > 1e-2
    return names


# ---------------------------------------------------- K4 with kv_len (plain)
KV_CASES = [  # B, Sq, Sk, H, KV, D, causal, kv_len
    (4, 24, 150, 4, 2, 32, False, (150, 100, 64, 1)),   # within/across 64
    (2, 70, 130, 2, 2, 64, False, (65, 130)),
    (3, 96, 96, 4, 1, 16, True, (96, 40, 63)),          # on top of causal
]


def _kv_inputs(case, seed):
    b, sq, sk, h, kv, d, causal, lens = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    return q, k, v, causal, np.asarray(lens, np.int32)


@pytest.mark.parametrize("case", KV_CASES)
def test_k4_plain_kv_len_vs_blockwise(case):
    """K4's plain version with ``kv_len`` (int32 and int64) against the JAX
    package's ``blockwise_attention(..., kv_len=)`` at blocks of 32, and
    its lse against a masked logsumexp in numpy."""
    q, k, v, causal, lens = _kv_inputs(case, seed=len(case[-1]))
    want = jA.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal=causal, kv_len=jnp.asarray(lens),
                                  block_q=32, block_k=32)
    for dt in (torch.int32, torch.int64):
        got, lse = tfa_ops.flash_attention_with_lse(
            *(torch.tensor(a) for a in (q, k, v)), causal=causal,
            kv_len=torch.tensor(lens).to(dt))
        np.testing.assert_allclose(_f32(got), _f32(want), atol=F32_TOL,
                                   rtol=F32_TOL)
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    s = np.einsum("bqkgd,btkd->bkgqt", q.reshape(b, sq, kvh, h // kvh, d),
                  k).astype(np.float64) / np.sqrt(d)
    live = np.arange(k.shape[1])[None, :] < lens[:, None, None]
    if causal:
        live = live & (np.arange(k.shape[1])[None, :]
                       <= np.arange(sq)[:, None])
    s = np.where(live[:, None, None], s, -np.inf)
    want_lse = np.logaddexp.reduce(s, axis=-1).reshape(b, h, sq)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("case", KV_CASES[:2])
def test_k4_plain_backward_with_kv_len_vs_jax_grad(case):
    """The plain backward with ``kv_len`` (the CPU path of the autograd
    function) against ``jax.grad`` of ``blockwise_attention``; masked keys
    get no gradient."""
    q, k, v, causal, lens = _kv_inputs(case, seed=3)
    do = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)

    def jfn(q, k, v):
        o = jA.blockwise_attention(q, k, v, causal=causal,
                                   kv_len=jnp.asarray(lens), block_q=32,
                                   block_k=32)
        return (o * jnp.asarray(do)).sum()
    want = jax.grad(jfn, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tfa_ops.flash_attention(tq, tk, tv, causal=causal,
                                  kv_len=torch.tensor(lens))
    got = torch.autograd.grad((out * torch.tensor(do)).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _f32(w), atol=F32_TOL,
                                   rtol=1e-4)
    for i, n in enumerate(lens):
        assert not got[1][i, n:].any() and not got[2][i, n:].any()


def test_k4_kv_len_is_checked():
    """Shape, dtype and range are checked on the CPU as on the card: no
    path sends a length of 0 (risk: the reference's row would be the mean
    of V over the padded length) or past Sk."""
    q, k, v = (torch.zeros(s) for s in ((2, 8, 2, 16), (2, 10, 1, 16),
                                        (2, 10, 1, 16)))
    for bad in (torch.tensor([0, 5]), torch.tensor([11, 5]),
                torch.tensor([5]), torch.tensor([5.0, 5.0]),
                torch.tensor([[5, 5]])):
        with pytest.raises(ValueError, match="kv_len"):
            tfa_ops.flash_attention(q, k, v, causal=False, kv_len=bad)
    tfa_ops.flash_attention(q, k, v, causal=False,
                            kv_len=torch.tensor([1, 10]))
    # the range is read once per tensor and version: an in-place change is
    # read again, and an inference tensor every call
    lens = torch.tensor([3, 10])
    tfa_ops.flash_attention(q, k, v, causal=False, kv_len=lens)
    lens[0] = 0
    with pytest.raises(ValueError, match="kv_len"):
        tfa_ops.flash_attention(q, k, v, causal=False, kv_len=lens)
    with torch.inference_mode():
        frozen = torch.tensor([4, 4])
        tfa_ops.flash_attention(q, k, v, causal=False, kv_len=frozen)
        frozen[1] = 11
        with pytest.raises(ValueError, match="kv_len"):
            tfa_ops.flash_attention(q, k, v, causal=False, kv_len=frozen)


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("seq,d", [(1500, 384), (600, 48), (7, 10)])
def test_sinusoid_positions_vs_jax(seq, d):
    np.testing.assert_array_equal(tL.sinusoid_positions(seq, d),
                                  jL.sinusoid_positions(seq, d))
    t = tL.sinusoid_on(seq, d, torch.bfloat16, torch.device("cpu"))
    np.testing.assert_array_equal(
        _f32(t), _f32(jnp.asarray(jL.sinusoid_positions(seq, d),
                                  jnp.bfloat16)))


def test_encoder_padded_keys_follow_jax_not_exact_softmax():
    """Risk 1 of the reference, both sides: at enc_seq 600 (block 512, a
    424-row zero pad) the port's encoder attention equals JAX's
    ``blockwise_attention(causal=False)``, and that is more than 1e-2 off
    exact attention (the plain K4 on the unpadded keys)."""
    jc, tc, jm, tm, jp = model_pair(ARCH, seed=1, enc_seq=600)
    tp = to_port(tc, jp)
    x = np.random.default_rng(5).normal(size=(2, 600, jc.d_model)
                                        ).astype(np.float32)
    jq, jk, jv = jA._project_qkv(jp["encoder"][0]["attn"], jc,
                                 jnp.asarray(x), jnp.asarray(x), None, None)
    want = _f32(jA.blockwise_attention(jq, jk, jv, causal=False))
    tq, tk, tv = tA._project_qkv(tp.encoder[0]["attn"], tc, torch.tensor(x),
                                 torch.tensor(x), None, None)
    got = _f32(tA.bidirectional(tq, tk, tv, block=tA.ENCODER_BLOCK))
    exact = _f32(tfa_ref.flash_attention_ref(tq, tk, tv, causal=False))
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    assert np.abs(want - exact).max() > 1e-2
    # the block decides the pad: at Sk 512 nothing is padded
    assert np.abs(_f32(tA.bidirectional(tq[:, :512], tk[:, :512],
                                        tv[:, :512], block=512)) - _f32(
        tfa_ref.flash_attention_ref(tq[:, :512], tk[:, :512], tv[:, :512],
                                    causal=False))).max() <= F32_TOL


def test_params_from_numpy_encoder_and_cross_leaves():
    """The encoder list and each decoder block's ``normx``/``xattn`` (no
    q/k/v biases, as ``attn_init(cross=True)``), in absolute layer order;
    the port's tree holds as many parameters as the JAX package's."""
    jc, tc, jm, tm, jp = model_pair(ARCH)
    tree = jax.tree.map(np.asarray, jp)
    tp = to_port(tc, jp)
    assert len(tp.encoder) == jc.enc_layers == len(tree["encoder"])
    for i, blk in enumerate(tp.blocks):
        assert sorted(blk) == ["attn", "mlp", "norm1", "norm2", "normx",
                               "xattn"]
        assert sorted(blk["xattn"]) == ["wk", "wo", "wq", "wv"]
        per, pos = divmod(i, len(jc.layer_pattern))
        want = tree["scan_blocks"][pos]["xattn"]
        np.testing.assert_array_equal(_f32(blk["xattn"]["wq"]),
                                      want["wq"][per])
    for blk, want in zip(tp.encoder, tree["encoder"]):
        np.testing.assert_array_equal(_f32(blk["attn"]["wk"]),
                                      want["attn"]["wk"])
    assert sum(p.numel() for p in tp.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))
    fresh = tm.init(torch.Generator().manual_seed(0))
    assert sorted(fresh.tree()) == sorted(tp.tree()) == [
        "blocks", "embed", "encoder", "final_norm"]
    assert [n for n, _ in T.flatten_with_names(fresh.tree())] == [
        n for n, _ in T.flatten_with_names(tp.tree())]


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("enc_seq", [None, 600], ids=["smoke", "enc600"])
def test_forward_prefill_decode_generate_vs_jax(enc_seq):
    """Forward logits, prefill, 4 teacher-forced decode steps and
    ``ServeEngine`` tokens; at enc_seq 600 the encoder's zero pad is
    live (a port without it is more than 1e-4 off)."""
    over = {} if enc_seq is None else {"enc_seq": enc_seq}
    pair = model_pair(ARCH, seed=2, **over)
    jc, tc, jm, tm, jp = pair
    tp = to_port(tc, jp)
    nb = batch_arrays(jc, tc, 20, 2, seed=3)
    assert nb["enc_frames"].shape == (2, jc.enc_seq, jc.d_model)
    assert (nb["enc_len"] == jc.enc_seq).all()
    jb, tb = both(batch_arrays(jc, tc, 20, 2, seed=3, train=True))
    want, _ = jax.jit(jm.forward)(jp, jb)
    with torch.inference_mode():
        got, _ = tm.forward(tp, tb)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    cache = serve_vs_jax(pair, tp, nb)
    assert all(torch.equal(c["enc_len"], torch.full((2,), jc.enc_seq,
                                                    dtype=torch.int32))
               for c in cache)


def test_ragged_enc_len_prefill_masks_decode_attends_to_all():
    """Risk 2: with ragged ``enc_len`` the prefill's cross-attention masks
    keys past each row's length (the logits differ from the full-length
    prefill's) and the cache's ``enc_len`` becomes the full length, so
    decode attends to every frame: both packages, step for step."""
    pair = model_pair(ARCH, seed=4)
    jc, tc, jm, tm, jp = pair
    tp = to_port(tc, jp)
    nb = batch_arrays(jc, tc, 16, 4, seed=5)
    full = {k: torch.tensor(v) for k, v in nb.items()}
    nb["enc_len"] = np.array([jc.enc_seq, 20, 7, 1], np.int32)
    cache = serve_vs_jax(pair, tp, nb)
    assert int(cache[0]["enc_len"].min()) == jc.enc_seq
    assert all(c["enc_len"] is cache[0]["enc_len"] for c in cache)
    with torch.inference_mode():
        ragged, _ = tm.prefill(tp, both(nb)[1], 24)
        whole, _ = tm.prefill(tp, full, 24)
    assert torch.equal(ragged[0], whole[0])          # row 0: full length
    assert (ragged[1:] - whole[1:]).abs().amax(dim=-1).min() > 1e-3


def test_encode_for_decode_vs_jax():
    """``encode_for_decode`` on a fresh cache: every layer's ``xk``/``xv``
    and ``enc_len`` as the JAX package's, then two decode steps."""
    pair = model_pair(ARCH, seed=6, enc_seq=40)
    jc, tc, jm, tm, jp = pair
    tp = to_port(tc, jp)
    nb = batch_arrays(jc, tc, 8, 2, seed=8)
    jb, tb = both(nb)
    jcache = jax.jit(jm.encode_for_decode)(jp, jb, jm.init_cache(2, 16))
    with torch.inference_mode():
        tcache = tm.encode_for_decode(tp, tb, tm.init_cache(2, 16, "cpu"))
    for i, c in enumerate(tcache):
        per, pos = divmod(i, len(jc.layer_pattern))
        for key in ("xk", "xv"):
            np.testing.assert_allclose(
                _f32(c[key]), _f32(jcache["scan"][pos][key][per]),
                atol=F32_TOL, rtol=F32_TOL, err_msg=f"{i}{key}")
    np.testing.assert_array_equal(tcache[0]["enc_len"].numpy(),
                                  np.asarray(jcache["enc_len"]))
    tok = np.array([[3], [9]], np.int32)
    for pos_ in (0, 1):
        jl, jcache = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jcache,
                                              jnp.int32(pos_))
        with torch.inference_mode():
            tl, tcache = tm.decode_step(tp, torch.tensor(tok), tcache, pos_)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_and_every_gradient_vs_jax(remat):
    """Through the encoder's padded keys (enc_seq 600), the causal decoder
    and the cross-attention with ragged ``enc_len``; under remat "dots"
    the encoder's output and ``enc_len`` cross each checkpointed block."""
    pair = model_pair(ARCH, seed=9, enc_seq=600, remat=remat)
    jc, tc, jm, tm, jp = pair
    nb = batch_arrays(jc, tc, 12, 2, seed=10, train=True)
    nb["enc_len"] = np.array([600, 333], np.int32)
    names = loss_vs_jax(pair, to_port(tc, jp), nb)
    assert any("encoder" in n for n in names)
    assert any("xattn" in n for n in names)


def test_serve_cli_smoke_on_cpu():
    serve_cli(ARCH)
