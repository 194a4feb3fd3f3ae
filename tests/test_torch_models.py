"""The dense model and serving engine of the PyTorch port against the JAX
package, on the CPU, with the JAX weights carried across by
``convert.params_from_numpy`` and the prompts drawn from one seed by both
packages' ``prefill_batch_specs``.

* Layers: ``rmsnorm``, ``apply_rope``, the four MLP kinds and
  ``lm_logits`` with a padded vocab.  Tolerance 1e-5 in float32 (same
  arithmetic up to summation order); a bfloat16 ``rmsnorm`` may differ by
  one bfloat16 step (rtol 2**-7), since both round a float32 result.
* ``params_from_numpy`` on the gemma3-1b smoke config (8 layers: 2
  periods of 3 + 2 tail layers), checked per layer and end to end; a pair
  of swapped layers must change the logits.
* Whole model in float32 on the gemma3-1b smoke config (prompt 40 > window
  16, so the local ring buffers wrap) and the qwen3-1.7b smoke config:
  ``prefill`` last logits, six ``decode_step``s teacher-forced on the same
  tokens, and ``ServeEngine.generate`` tokens equal to the JAX engine's.
  Logits: atol and rtol 1e-4 (float32 through a few layers; the attention
  and matmul sums run in another order).
* One bfloat16 prefill on the gemma3-1b smoke config: logits atol 0.1,
  against logits of standard deviation about 1: both packages round every
  activation to bfloat16, but at different places (the JAX attention
  scales q in bfloat16, the port's in float32; XLA fuses across ops).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402

F32_TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_LOGIT_ATOL = 0.1


def _f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _cfgs(arch, dtype):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope_vs_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    jdt, tdt = jnp.dtype(dtype), tL.dtype_of(dtype)
    jx, tx = jnp.asarray(x, jdt), torch.tensor(x).to(tdt)
    tol = dict(atol=F32_TOL, rtol=F32_TOL) if dtype == "float32" else \
        dict(atol=0, rtol=2.0 ** -7)
    got = tL.rmsnorm({"scale": torch.tensor(scale).to(tdt)}, tx, 1e-6)
    want = jL.rmsnorm({"scale": jnp.asarray(scale, jdt)}, jx, 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    got = tL.apply_rope(tx, torch.tensor(pos), 1_000_000.0)
    want = jL.apply_rope(jx, jnp.asarray(pos), 1_000_000.0)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_mlp_kinds_vs_jax(kind):
    jc, tc = _cfgs("qwen3-1.7b", "float32")
    jc = dataclasses.replace(jc, mlp_kind=kind)
    jp = jL.mlp_init(jax.random.key(1), jc, jc.d_ff)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(2).normal(size=(2, 7, jc.d_model)
                                        ).astype(np.float32)
    got = tL.mlp_apply(tp, torch.tensor(x), kind)
    want = jL.mlp_apply(jp, jnp.asarray(x), kind)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("tie", [False, True])
def test_embed_and_lm_logits_padded_vocab_vs_jax(tie):
    jc, _ = _cfgs("qwen3-1.7b", "float32")
    jc = dataclasses.replace(jc, vocab=250, pad_vocab_multiple=64,
                             tie_embeddings=tie)            # padded to 256
    jp = jL.embed_init(jax.random.key(3), jc)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    tok = np.random.default_rng(4).integers(0, 250, (2, 5)).astype(np.int32)
    h = tL.embed_tokens(tp, torch.tensor(tok))
    np.testing.assert_array_equal(_f32(h), _f32(jL.embed_tokens(
        jp, jnp.asarray(tok))))
    got = tL.lm_logits(tp, h, tie, true_vocab=250)
    want = jL.lm_logits(jp, jnp.asarray(_f32(h)), tie, true_vocab=250)
    assert got.shape == (2, 5, 256) and float(got[..., 250:].max()) == -1e9
    np.testing.assert_allclose(_f32(got), _f32(want), atol=F32_TOL,
                               rtol=F32_TOL)


# ----------------------------------------------------------------- weights
def _model_pair(arch, dtype, seed=0):
    jc, tc = _cfgs(arch, dtype)
    jm, tm = jbuild(jc), tbuild(tc)
    jp = jm.init(jax.random.key(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jc, tc, jm, tm, jp, tree, convert.params_from_numpy(
        tc, tree, device="cpu")


def _prompt(jc, tc, seq, batch):
    jb = jshapes.prefill_batch_specs(jc, seq, batch, concrete=True,
                                     rng=np.random.default_rng(0))
    tb = tshapes.prefill_batch_specs(tc, seq, batch,
                                     rng=np.random.default_rng(0))
    np.testing.assert_array_equal(tb["tokens"], np.asarray(jb["tokens"]))
    return jb, {"tokens": torch.tensor(tb["tokens"])}


def test_params_from_numpy_layer_order():
    jc, tc, jm, tm, jp, tree, tp = _model_pair("gemma3-1b", "float32")
    assert jm.n_periods == 2 and len(tree["tail_blocks"]) == 2
    assert len(tp.blocks) == tc.n_layers == 8
    for i, blk in enumerate(tp.blocks):
        per, pos = divmod(i, len(tc.layer_pattern))
        want = (tree["tail_blocks"][i - 6] if i >= 6 else
                jax.tree.map(lambda a: a[per], tree["scan_blocks"][pos]))
        for part in ("norm1", "attn", "norm2", "mlp"):
            for name, arr in want[part].items():
                np.testing.assert_array_equal(_f32(blk[part][name]), arr)
    np.testing.assert_array_equal(_f32(tp.embed["tok"]),
                                  tree["embed"]["tok"])
    jb, tb = _prompt(jc, tc, 24, 2)
    want, _ = jax.jit(jm.forward)(jp, jb)
    got, _ = tm.forward(tp, tb)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    # a layer-order mistake shows: swap two local layers
    tp.blocks[0], tp.blocks[6] = tp.blocks[6], tp.blocks[0]
    swapped, _ = tm.forward(tp, tb)
    assert np.abs(_f32(swapped) - _f32(want)).max() > 1e-2


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("arch,prompt", [("gemma3-1b", 40),
                                         ("qwen3-1.7b", 24)])
def test_prefill_decode_generate_vs_jax(arch, prompt):
    serve_vs_jax(arch, prompt)


def serve_vs_jax(arch, prompt, seed=1):
    """Float32 ``prefill``, six teacher-forced ``decode_step``s and
    ``ServeEngine.generate`` of the smoke config of ``arch`` against the
    JAX package's (logits within LOGIT_TOL, tokens equal)."""
    jc, tc, jm, tm, jp, _, tp = _model_pair(arch, "float32", seed=seed)
    batch, gen = 2, 6
    max_len = prompt + gen + 8
    jb, tb = _prompt(jc, tc, prompt, batch)
    jeng, teng = JEngine(jm, jp, max_len), TEngine(tm, tp, max_len)

    jlog, jcache = jeng._prefill(jp, jb)
    with torch.inference_mode():
        tlog, tcache = tm.prefill(tp, tb, max_len)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)

    forced = np.random.default_rng(7).integers(0, jc.vocab, (batch, 6)
                                               ).astype(np.int32)
    jdecode = jax.jit(jm.decode_step)
    for i in range(6):
        jl, jcache = jdecode(jp, jnp.asarray(forced[:, i:i + 1]), jcache,
                             jnp.int32(prompt + i))
        with torch.inference_mode():
            tl, tcache = tm.decode_step(tp, torch.tensor(forced[:, i:i + 1]),
                                        tcache, prompt + i)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"step {i}")

    jtoks, _ = jeng.generate(jeng.prefill(jb), gen)
    ttoks, state = teng.generate(teng.prefill(tb), gen)
    assert state.pos == prompt + gen - 1
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_bf16_prefill_vs_jax():
    jc, tc, jm, tm, jp, _, tp = _model_pair("gemma3-1b", "bfloat16", seed=2)
    jb, tb = _prompt(jc, tc, 40, 2)
    want, _ = jax.jit(lambda p, b: jm.prefill(p, b, max_len=48))(jp, jb)
    with torch.inference_mode():
        got, _ = tm.prefill(tp, tb, 48)
    assert got.dtype == torch.float32 and got.shape == (2, jc.vocab)
    assert float(_f32(want).std()) > 0.5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=BF16_LOGIT_ATOL,
                               rtol=0)
