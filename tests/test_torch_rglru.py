"""The PyTorch port's hybrid family (``models/rglru.py``, the rglru and
local blocks of ``models/model.py``) against the JAX package, on the
CPU: the log-depth scan against ``jax.lax.associative_scan`` and against
a sequential loop, the RG-LRU block's full-sequence and decode paths,
and the recurrentgemma-9b smoke config end to end (a prompt of 40 over a
window of 16, so the local layers' ring buffers wrap; 5 layers: one
period of (rglru, rglru, local) and 2 tail rglru layers).  Inputs are
drawn with numpy; JAX weights come across through
``convert.params_from_numpy``.

Tolerances:
* float32 scan against ``associative_scan`` and the sequential loop:
  1e-5 absolute and relative (the same combine on other trees: JAX's
  odd-even tree, the port's Hillis-Steele doubling, the loop's chain; a
  few float32 roundings per level of the ceil(log2 S) levels).
* float32 block and model: layers 1e-5, logits 1e-4 (atol and rtol),
  greedy tokens equal; ``loss_fn`` 1e-5 relative and every gradient 1e-5
  absolute plus 1e-4 relative.
* ``softplus``: the port's ``logaddexp(x, 0)`` is within 2e-7 absolute
  of ``jax.nn.softplus`` over [-100, 88] (one float32 ulp near 1; torch's
  ``F.softplus``, which returns x from its threshold of 20, differs by up
  to 1e-6 there).
* One bfloat16 prefill: logits atol 0.2, against logits of standard
  deviation about 1.  Both packages round every activation to bfloat16,
  at different places, and the gates and the scan carry those roundings
  through the recurrence: the JAX package's own bfloat16 prefill differs
  from its float32 prefill of the same weights by up to 0.106 on seeds
  2-4 (the port's by up to 0.143), and the two packages' bfloat16 errors
  add.  The float32 tests hold the arithmetic.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import rglru as jR  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import rglru as tR  # noqa: E402
from test_torch_models import _cfgs, _f32, _model_pair, _prompt, serve_vs_jax  # noqa: E402,E501
from test_torch_moe import loss_vs_jax, serve_cli  # noqa: E402

ARCH = "recurrentgemma-9b"
F32_TOL = 1e-5
BF16_LOGIT_ATOL = 0.2


def _scan_inputs(s, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32),
            rng.normal(size=(2, s, 8)).astype(np.float32))


@pytest.mark.parametrize("s", [1, 7, 16, 40, 1000])
def test_linear_scan_vs_associative_scan_and_loop(s):
    a, b = _scan_inputs(s, seed=s)
    got = _f32(tR.linear_scan(torch.tensor(a), torch.tensor(b)))

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]
    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    np.testing.assert_allclose(got, _f32(want), atol=F32_TOL, rtol=F32_TOL)
    h = np.zeros((2, 8), np.float32)
    loop = np.zeros_like(b)
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        loop[:, t] = h
    np.testing.assert_allclose(got, loop, atol=F32_TOL, rtol=F32_TOL)


def test_softplus_matches_jax():
    x = np.concatenate([np.linspace(-30, 30, 2001),
                        [-100.0, 19.99, 20.0, 20.01, 25.0, 88.0]]
                       ).astype(np.float32)
    got = _f32(tL.softplus(torch.tensor(x)))
    want = _f32(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-7, rtol=0)
    assert got[-1] == want[-1] == np.float32(88.0)


@pytest.mark.parametrize("s", [16, 3])
def test_rglru_block_train_state_and_decode_vs_jax(s):
    """``rglru_apply_train(return_state=True)`` (output, conv tail and last
    h; S = 3 is shorter than the conv's tail of 3 + 1), then four
    ``rglru_apply_decode`` steps from that state, in place."""
    jc, tc = _cfgs(ARCH, "float32")
    jp = jR.rglru_init(jax.random.key(0), jc)
    jp = dict(jp, b_r=jp["b_r"] + 0.3, b_i=jp["b_i"] - 0.2)  # non-zero
    tp = convert._pdict(jax.tree.map(np.asarray, jp), torch.float32,
                        torch.device("cpu"), tR.FLOAT32)
    x = np.random.default_rng(1).normal(size=(2, s + 4, jc.d_model)
                                        ).astype(np.float32)
    jy, jst = jR.rglru_apply_train(jp, jc, jnp.asarray(x[:, :s]),
                                   return_state=True)
    ty, tst = tR.rglru_apply_train(tp, tc, torch.tensor(x[:, :s]),
                                   return_state=True)
    np.testing.assert_allclose(_f32(ty), _f32(jy), atol=F32_TOL,
                               rtol=F32_TOL)
    for k in ("conv", "h"):
        np.testing.assert_allclose(_f32(tst[k]), _f32(jst[k]), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=k)
    cache = tR.rglru_decode_init(tc, 2, torch.float32, "cpu")
    h_buf = cache["h"]
    for k in cache:
        cache[k].copy_(tst[k])
    for t in range(s, s + 4):
        jy, jst = jR.rglru_apply_decode(jp, jc, jnp.asarray(x[:, t:t + 1]),
                                        jst)
        ty, cache = tR.rglru_apply_decode(tp, tc,
                                          torch.tensor(x[:, t:t + 1]), cache)
        np.testing.assert_allclose(_f32(ty), _f32(jy), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"step {t}")
        np.testing.assert_allclose(_f32(cache["h"]), _f32(jst["h"]),
                                   atol=F32_TOL, rtol=F32_TOL)
    assert cache["h"] is h_buf


def test_params_from_numpy_layer_order_and_float32_leaves():
    """One period (rglru, rglru, local), then 2 tail rglru layers; under
    bfloat16 ``b_r``, ``b_i`` and ``lam`` stay float32 (``lam`` is the
    JAX package's numpy draw in both packages' init)."""
    jc, tc, jm, tm, jp, tree, tp = _model_pair(ARCH, "bfloat16")
    assert tm.kinds == ("rglru", "rglru", "local", "rglru", "rglru")
    assert len(tree["tail_blocks"]) == 2
    np.testing.assert_array_equal(_f32(tp.blocks[3]["rglru"]["w_x"]),
                                  tree["tail_blocks"][0]["rglru"]["w_x"])
    np.testing.assert_array_equal(
        _f32(tp.blocks[1]["rglru"]["w_r"]),
        tree["scan_blocks"][1]["rglru"]["w_r"][0])
    for i in (0, 1, 3, 4):
        for name, leaf in tp.blocks[i]["rglru"].items():
            assert leaf.dtype == (torch.float32 if name in tR.FLOAT32
                                  else torch.bfloat16), name
    own = tm.init(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(_f32(own.blocks[0]["rglru"]["lam"]),
                                  tree["tail_blocks"][0]["rglru"]["lam"])


def test_prefill_decode_generate_vs_jax():
    serve_vs_jax(ARCH, prompt=40)


def test_loss_and_every_gradient_vs_jax():
    loss_vs_jax(ARCH, "dots")


def test_bf16_prefill_vs_jax():
    jc, tc, jm, tm, jp, _, tp = _model_pair(ARCH, "bfloat16", seed=2)
    jb, tb = _prompt(jc, tc, 40, 2)
    want, _ = jax.jit(lambda p, b: jm.prefill(p, b, max_len=48))(jp, jb)
    with torch.inference_mode():
        got, cache = tm.prefill(tp, tb, 48)
    assert got.dtype == torch.float32 and got.shape == (2, jc.vocab)
    assert cache[0]["h"].dtype == torch.float32
    assert cache[2]["k"].shape[1] == jc.window
    assert float(_f32(want).std()) > 0.5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=BF16_LOGIT_ATOL,
                               rtol=0)


def test_serve_cli_smoke_on_cpu():
    serve_cli(ARCH)
