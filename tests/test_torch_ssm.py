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
* The decode mixer's wrapper (K5's CPU path) against the unfused
  sequence the port ran before it: bit for bit (the same arithmetic).
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
from repro_torch.kernels.ssm_decode import ops as K5  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import ssm as tS  # noqa: E402
from test_torch_cuda import k5_cfg, k5_args, ssm_decode_inputs  # noqa: E402,E501
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


def _unfused_decode(p, cfg, x, cache):
    """The decode step as the port computed it before K5, expression for
    expression: (the gated norm's output (B, 1, di), the block's output);
    both caches updated in place."""
    import torch.nn.functional as F
    b = x.shape[0]
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = (x @ p["in_proj"])[:, 0]
    z, xbc, dt_raw = (proj[..., :di], proj[..., di:2 * di + 2 * ns],
                      proj[..., 2 * di + 2 * ns:])
    win = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)
    conv = F.silu(torch.einsum("bkc,kc->bc", win, p["conv_w"])
                  + p["conv_b"])
    xs = conv[..., :di].reshape(b, nh, cfg.ssm_head_dim)
    bmat = conv[..., di:di + ns].to(torch.float32)
    cmat = conv[..., di + ns:].to(torch.float32)
    dt = dt_raw.to(torch.float32) + p["dt_bias"]
    dt = torch.logaddexp(dt, dt.new_zeros(()))
    dec = torch.exp(dt * -torch.exp(p["a_log"]))
    xf = xs.to(torch.float32)
    upd = bmat[:, None, :, None] * (dt[..., None] * xf)[:, :, None, :]
    s_new = cache["ssd"] * dec[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", cmat, s_new)
    y = y + p["d_skip"][None, :, None] * xf
    y = y.reshape(b, 1, di).to(x.dtype)
    y = y * F.silu(z[:, None, :])
    var = y.to(torch.float32).square().mean(-1, keepdim=True)
    y = (y.to(torch.float32) * torch.rsqrt(var + cfg.norm_eps)
         ).to(y.dtype) * p["norm"]
    cache["conv"].copy_(win[:, 1:])
    cache["ssd"].copy_(s_new)
    return y, y @ p["out_proj"]


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("name, dtype", [("mamba2-smoke", "bfloat16"),
                                         ("mamba2-780m", "bfloat16"),
                                         ("mamba2-smoke", "float32")])
def test_decode_mixer_on_the_cpu_equals_the_unfused_sequence(name, dtype,
                                                             batch):
    """``ssm_decode_mixer`` on CPU tensors, and ``ssm_apply_decode``
    through it, against the unfused sequence over 4 steps that carry
    state (at the smoke width and at one 780m-wide layer): outputs and
    both caches bit for bit, the caches updated in place."""
    cfg = k5_cfg(name, dtype)
    p, cache, xs = ssm_decode_inputs(cfg, batch, seed=batch)
    old, mix = ({k: v.clone() for k, v in cache.items()} for _ in range(2))
    held = {k: (v, v.data_ptr()) for k, v in mix.items()}
    start = cache["ssd"].clone()
    with torch.inference_mode():
        for x in xs:
            want_y, want_out = _unfused_decode(p, cfg, x, old)
            y = K5.ssm_decode_mixer(*k5_args(p, mix, x), cfg.norm_eps)
            out, blk = tS.ssm_apply_decode(p, cfg, x, cache)
            assert blk is cache
            assert torch.equal(y, want_y[:, 0])
            assert torch.equal(out, want_out)
            for k in old:
                assert torch.equal(mix[k], old[k]), k
                assert torch.equal(cache[k], old[k]), k
    assert not torch.equal(old["ssd"], start)
    for k, (t, ptr) in held.items():
        assert mix[k] is t and t.data_ptr() == ptr, k


@pytest.mark.parametrize("bad", ["dtype", "state_shape", "non_contiguous"])
def test_decode_mixer_raises_on_bad_inputs(bad):
    """A float32 state the wrapper was handed as bfloat16, a state of the
    wrong shape (N 17 for the projection's 16) and a conv cache that is
    not contiguous raise, naming what is wrong."""
    cfg = k5_cfg("mamba2-smoke", "bfloat16")
    p, cache, xs = ssm_decode_inputs(cfg, 2, seed=0)
    args = list(k5_args(p, cache, xs[0]))
    if bad == "dtype":
        args[2] = args[2].to(torch.bfloat16)
    elif bad == "state_shape":
        b, h, n, d = args[2].shape
        args[2] = torch.zeros((b, h, n + 1, d))
    else:
        b, k, c = args[1].shape
        args[1] = torch.zeros((b, c, k), dtype=args[1].dtype).transpose(1, 2)
    match = {"dtype": "ssd_cache is torch.bfloat16",
             "state_shape": "do not fit H 8, N 17, P 16", "non_contiguous":
             "conv_cache must be contiguous"}[bad]
    with pytest.raises(ValueError, match=match):
        K5.ssm_decode_mixer(*args, cfg.norm_eps)


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
