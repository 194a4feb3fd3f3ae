"""The PyTorch port's ssm family (``models/ssm.py``, mamba2 blocks in
``models/model.py``) against the JAX package, on the CPU: ``ssd_chunked``
against ``repro.models.ssm.ssd_chunked`` and against a sequential
recurrence written here, the block's full-sequence and decode paths, and
the mamba2-780m smoke config end to end.  Inputs are drawn with numpy;
JAX weights come across through ``convert.params_from_numpy``.

Tolerances:
* float32 ``ssd_chunked`` against JAX: 1e-5 absolute and relative (the
  same chunked algorithm; the port contracts the three-operand einsums in
  two steps, so sums run in another order); against the sequential
  recurrence 2e-4, as ``tests/test_models.py`` holds the JAX function.
* float32 block and model: layers 1e-5, logits 1e-4 (atol and rtol),
  greedy tokens equal; ``loss_fn`` 1e-5 relative and every gradient 1e-5
  absolute plus 1e-4 relative, under remat "none" and "dots".
* One bfloat16 prefill: logits atol 0.1, against logits of standard
  deviation about 1; both round activations to bfloat16 at different
  places (XLA fuses across ops, and decides the order of the einsums'
  contractions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jS  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import ssm as tS  # noqa: E402
from test_torch_models import _cfgs, _f32, _model_pair, _prompt, serve_vs_jax  # noqa: E402,E501
from test_torch_moe import loss_vs_jax, serve_cli  # noqa: E402

ARCH = "mamba2-780m"
F32_TOL = 1e-5
BF16_LOGIT_ATOL = 0.1


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            (np.abs(rng.normal(size=(b, s, h))) * 0.1).astype(np.float32),
            -np.linspace(0.5, 2.0, h).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32))


@pytest.mark.parametrize("s", [24, 21, 5], ids=["multiple", "padded",
                                                "below_chunk"])
def test_ssd_chunked_vs_jax(s):
    """S a multiple of the chunk (8), S not a multiple (padding with
    dt = 0), and S below one chunk."""
    args = _ssd_inputs(2, s, 3, 4, 8, seed=s)
    y, final = tS.ssd_chunked(*map(torch.tensor, args), chunk=8)
    jy, jfinal = jS.ssd_chunked(*map(jnp.asarray, args), chunk=8)
    assert y.shape == (2, s, 3, 4) and final.shape == (2, 3, 8, 4)
    np.testing.assert_allclose(_f32(y), _f32(jy), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(_f32(final), _f32(jfinal), atol=F32_TOL,
                               rtol=F32_TOL)


def test_ssd_chunked_matches_sequential_recurrence():
    xh, dt, a, bm, cm = _ssd_inputs(2, 24, 3, 4, 8, seed=0)
    y, final = tS.ssd_chunked(*map(torch.tensor, (xh, dt, a, bm, cm)),
                              chunk=8)
    st = np.zeros((2, 3, 8, 4), np.float32)
    ys = np.zeros((2, 24, 3, 4), np.float32)
    for t in range(24):
        dec = np.exp(dt[:, t] * a)                            # (b, h)
        upd = np.einsum("bn,bh,bhp->bhnp", bm[:, t], dt[:, t], xh[:, t])
        st = st * dec[..., None, None] + upd
        ys[:, t] = np.einsum("bn,bhnp->bhp", cm[:, t], st)
    np.testing.assert_allclose(_f32(y), ys, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_f32(final), st, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s", [16, 13])
def test_ssm_block_train_state_and_decode_vs_jax(s):
    """``ssm_apply_train(return_state=True)`` (output, conv tail and SSD
    state), then four ``ssm_apply_decode`` steps from that state, which
    writes the port's cache in place."""
    jc, tc = _cfgs(ARCH, "float32")
    jp = jS.ssm_init(jax.random.key(0), jc)
    tp = convert._pdict(jax.tree.map(np.asarray, jp), torch.float32,
                        torch.device("cpu"), tS.FLOAT32)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, s + 4, jc.d_model)).astype(np.float32)
    jy, jst = jS.ssm_apply_train(jp, jc, jnp.asarray(x[:, :s]),
                                 return_state=True)
    ty, tst = tS.ssm_apply_train(tp, tc, torch.tensor(x[:, :s]),
                                 return_state=True)
    np.testing.assert_allclose(_f32(ty), _f32(jy), atol=F32_TOL,
                               rtol=F32_TOL)
    for k in ("conv", "ssd"):
        np.testing.assert_allclose(_f32(tst[k]), _f32(jst[k]), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=k)
    cache = tS.ssm_decode_init(tc, 2, torch.float32, "cpu")
    ssd_buf = cache["ssd"]
    for k in cache:
        cache[k].copy_(tst[k])
    for t in range(s, s + 4):
        jy, jst = jS.ssm_apply_decode(jp, jc, jnp.asarray(x[:, t:t + 1]),
                                      jst)
        ty, cache = tS.ssm_apply_decode(tp, tc, torch.tensor(x[:, t:t + 1]),
                                        cache)
        np.testing.assert_allclose(_f32(ty), _f32(jy), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"step {t}")
        np.testing.assert_allclose(_f32(cache["ssd"]), _f32(jst["ssd"]),
                                   atol=F32_TOL, rtol=F32_TOL)
    assert cache["ssd"] is ssd_buf


def test_params_from_numpy_keeps_float32_leaves():
    jc, tc, jm, tm, jp, tree, tp = _model_pair(ARCH, "bfloat16")
    assert len(tp.blocks) == tc.n_layers == 3
    for blk in tp.blocks:
        assert set(blk) == {"norm1", "ssm"}                 # mixer only
        for name, leaf in blk["ssm"].items():
            assert leaf.dtype == (torch.float32 if name in tS.FLOAT32
                                  else torch.bfloat16), name
    np.testing.assert_array_equal(
        _f32(tp.blocks[2]["ssm"]["a_log"]),
        np.asarray(tree["scan_blocks"][0]["ssm"]["a_log"][2]))


def test_prefill_decode_generate_vs_jax():
    serve_vs_jax(ARCH, prompt=21)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_and_every_gradient_vs_jax(remat):
    met = loss_vs_jax(ARCH, remat)
    assert float(met["aux"]) == 0.0


def test_bf16_prefill_vs_jax():
    jc, tc, jm, tm, jp, _, tp = _model_pair(ARCH, "bfloat16", seed=2)
    jb, tb = _prompt(jc, tc, 21, 2)
    want, _ = jax.jit(lambda p, b: jm.prefill(p, b, max_len=32))(jp, jb)
    with torch.inference_mode():
        got, cache = tm.prefill(tp, tb, 32)
    assert got.dtype == torch.float32 and got.shape == (2, jc.vocab)
    assert cache[0]["ssd"].dtype == torch.float32
    assert float(_f32(want).std()) > 0.5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=BF16_LOGIT_ATOL,
                               rtol=0)


def test_serve_cli_smoke_on_cpu():
    serve_cli(ARCH)
