"""The PyTorch port's MoE family (``models/moe.py`` and the moe branches
of ``models/model.py`` and ``models/convert.py``) against the JAX package,
on the CPU, on the qwen2-moe-a2.7b smoke config (6 experts padded to 16,
top-2, 2 shared experts) and the kimi-k2-1t-a32b smoke config (a dense
head layer, then MoE layers with 1 shared expert).  Inputs are drawn
with numpy; JAX weights come across through ``convert.params_from_numpy``.

Tolerances, float32 only:
* ``moe_apply``: outputs 1e-5 (the same arithmetic; the port adds each
  token's top-k contributions in another order than the JAX scatter-add),
  aux loss 1e-6 relative; which assignments drop at capacity factor 1.0
  is compared exactly, as sets of (token, expert).
* Whole model: logits atol and rtol 1e-4 for ``prefill`` and six
  teacher-forced ``decode_step``s, ``ServeEngine.generate`` tokens equal;
  ``loss_fn``'s loss, ce and aux 1e-5 relative, gradients 1e-5 absolute
  plus 1e-4 relative (as ``tests/test_torch_train_model.py``).

No bfloat16 comparison of the MoE against JAX: a router probability one
bfloat16 step apart can pick another expert, and the port's expert
products round ``h`` and ``u`` to bfloat16 where JAX keeps them in
float32.  The float32 tests hold the arithmetic; ``params_from_numpy``
is checked under bfloat16 for its dtypes (``router`` stays float32).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tM  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402
from test_torch_models import _cfgs, _f32, _model_pair, serve_vs_jax  # noqa: E402,E501

ROOT = Path(__file__).resolve().parents[1]
MOE_ARCHS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]
F32_TOL = 1e-5


def _moe_pair(arch, seed=0):
    jc, tc = _cfgs(arch, "float32")
    jp = jM.moe_init(jax.random.key(seed), jc)
    tp = convert._pdict(jax.tree.map(np.asarray, jp), torch.float32,
                        torch.device("cpu"), tM.FLOAT32)
    return jc, tc, jp, tp


def _jax_kept(jc, jp, x, capacity_factor):
    """The JAX layer's kept (token, expert) pairs, rebuilt in numpy from
    its router: a stable sort by expert, rank < capacity."""
    t = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(t, -1)) @ jp["router"])
    _, top_e = jax.lax.top_k(probs, jc.top_k)
    flat_e = np.asarray(top_e).reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    counts = np.bincount(flat_e, minlength=jp["up"].shape[0])
    rank = np.arange(flat_e.size) - (np.cumsum(counts) - counts)[
        flat_e[order]]
    cap = int(np.ceil(flat_e.size / jc.n_experts * capacity_factor))
    kept = order[rank < cap]
    return {(int(i) // jc.top_k, int(flat_e[i])) for i in kept}, cap


@pytest.mark.parametrize("n", [6, 8, 16, 17, 60, 384])
def test_padded_experts_vs_jax(n):
    assert tM.padded_experts(n) == jM.padded_experts(n)
    assert tM.padded_experts(n) % tM.EP_PAD_MULTIPLE == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("factor", [None, 1.0], ids=["drop_free", "cf1"])
def test_moe_apply_and_drops_vs_jax(arch, factor):
    """Drop-free (the smoke configs' factor 8.0) and at capacity factor
    1.0, where some assignments drop: the same ones in both packages."""
    jc, tc, jp, tp = _moe_pair(arch, seed=1)
    x = np.random.default_rng(2).normal(size=(2, 16, jc.d_model)
                                        ).astype(np.float32)
    want, jaux = jM.moe_apply(jp, jc, jnp.asarray(x), capacity_factor=factor)
    got, aux = tM.moe_apply(tp, tc, torch.tensor(x), capacity_factor=factor)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=F32_TOL,
                               rtol=F32_TOL)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)

    cf = tc.moe_capacity_factor if factor is None else factor
    jkept, cap = _jax_kept(jc, jp, x, cf)
    xt = torch.tensor(x).reshape(-1, tc.d_model)
    _, _, top_e = tM.route(tp, tc, xt)
    assert tM.capacity_of(tc, xt.shape[0], cf) == cap
    order, keep, slot = tM.dispatch(top_e, tp["up"].shape[0], cap)
    flat_e = top_e.reshape(-1)
    kept = {(int(i) // tc.top_k, int(flat_e[i])) for i in order[keep]}
    n_assign = xt.shape[0] * tc.top_k
    n_dropped = n_assign - len(kept)
    assert kept == jkept
    assert int((slot == tp["up"].shape[0] * cap).sum()) == n_dropped
    if factor is None:
        assert n_dropped == 0
    else:
        assert 0 < n_dropped < n_assign // 4, n_dropped


def test_moe_aux_loss_vs_jax_on_skewed_routing():
    """A router biased towards two experts: the aux loss (which grows
    with the skew) against JAX's, and against its formula in numpy."""
    jc, tc, jp, tp = _moe_pair("qwen2-moe-a2.7b", seed=3)
    router = np.asarray(jp["router"]).copy()
    router[:, :2] += 0.5
    jp = dict(jp, router=jnp.asarray(router))
    tp["router"] = torch.nn.Parameter(torch.tensor(router),
                                      requires_grad=False)
    x = np.abs(np.random.default_rng(4).normal(size=(3, 8, jc.d_model))
               ).astype(np.float32)
    _, jaux = jM.moe_apply(jp, jc, jnp.asarray(x))
    _, aux = tM.moe_apply(tp, tc, torch.tensor(x))
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    logits = x.reshape(-1, jc.d_model).astype(np.float64) @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = np.argsort(-probs, -1)[:, :jc.top_k]
    density = np.bincount(top.reshape(-1), minlength=jc.n_experts) \
        / top.shape[0]
    want = jc.router_aux_coef * jc.n_experts * np.sum(
        density / jc.top_k * probs.mean(0))
    assert float(aux) == pytest.approx(want, rel=1e-5)
    assert float(aux) > 1.5 * jc.router_aux_coef      # balanced: coef


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_numpy_moe_trees(arch):
    """Head blocks (kimi-k2), stacked scan blocks with ``moe/shared``
    three levels down, in absolute layer order; under a bfloat16 config
    ``router`` stays float32 and every other leaf is bfloat16."""
    jc, tc, jm, tm, jp, tree, tp = _model_pair(arch, "bfloat16")
    n_head = jc.first_k_dense
    assert len(tree["head_blocks"]) == n_head
    assert [("moe" in b) for b in tp.blocks] == [
        i >= n_head for i in range(tc.n_layers)]
    for i, blk in enumerate(tp.blocks):
        want = (tree["head_blocks"][i] if i < n_head else jax.tree.map(
            lambda a: a[i - n_head], tree["scan_blocks"][0]))
        got = T.map_tree(lambda t: t.to(torch.float32).numpy(),
                         tmodel._tree(blk))
        got, want = T.flatten_with_names(got), T.flatten_with_names(want)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{i}{name}")
    for name, leaf in T.flatten_with_names(tp.tree()):
        want = torch.float32 if name.endswith("['router']") \
            else torch.bfloat16
        assert leaf.dtype == want, name
    assert "shared" in tp.blocks[-1]["moe"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_generate_vs_jax(arch):
    serve_vs_jax(arch, prompt=24)


@pytest.mark.parametrize("arch,remat", [("qwen2-moe-a2.7b", "none"),
                                        ("kimi-k2-1t-a32b", "dots")])
def test_loss_ce_aux_and_every_gradient_vs_jax(arch, remat):
    """``loss_fn`` = ce + aux summed over the MoE layers (the head layer
    adds none); remat "dots" carries aux out of the checkpointed block."""
    met = loss_vs_jax(arch, remat)
    assert float(met["aux"]) > 0


def loss_vs_jax(arch, remat):
    """``loss_fn`` (loss, ce, aux) and every parameter's gradient of the
    float32 smoke config of ``arch`` under ``remat`` against
    ``jax.value_and_grad`` of the JAX package's; returns the port's
    metrics."""
    jc, tc, jm, tm, jp, _, tp = _model_pair(arch, "float32", seed=3)
    jm.cfg = jc = dataclasses.replace(jc, remat=remat)
    tm.cfg = tc = dataclasses.replace(tc, remat=remat)
    rng = np.random.default_rng(5)
    b = {k: rng.integers(0, jc.vocab, (2, 20)).astype(np.int32)
         for k in ("tokens", "targets")}
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, {k: jnp.asarray(v)
                                        for k, v in b.items()})
    leaves = T.leaves(tp.tree())
    for p in leaves:
        p.requires_grad_(True)
    loss, met = tm.loss_fn(tp, {k: torch.tensor(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for k in ("ce", "aux"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5), k
    want = T.leaves(convert.port_layout(tc, jax.tree.map(np.asarray, jg)))
    names = [n for n, _ in T.flatten_with_names(tp.tree())]
    assert len(want) == len(grads) == len(names)
    for name, g, w in zip(names, grads, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    assert max(float(np.abs(w).max()) for w in want) > 1e-2
    return met


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_param_count_quirk_vs_the_trees(arch):
    """The port's tree holds as many parameters as the JAX package's, and
    both differ from the analytic ``ModelConfig.param_count`` (a reference
    quirk): moe counts the real experts, not the 16-multiple padding; ssm
    counts two norms a block where mamba2 has one, and omits conv_b and
    d_skip; rglru omits the w_r and w_i gates (2 w**2 a layer) and counts
    4 w of vectors too many."""
    jc, tc, jm, tm, jp, tree, tp = _model_pair(arch, "float32")
    n = sum(p.numel() for p in tp.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(tree))
    d, w = tc.d_model, tc.lru_width
    kinds = tm.kinds
    if tc.family == "moe":
        extra = sum(tc.moe_layer(i) for i in range(tc.n_layers)) * 3 * d \
            * tc.d_ff_expert * (tM.padded_experts(tc.n_experts)
                                - tc.n_experts)
    elif tc.family == "ssm":
        extra = tc.n_layers * (-d + tc.d_inner + 2 * tc.ssm_state
                               + tc.ssm_heads)
    else:
        extra = kinds.count("rglru") * (2 * w * w - 4 * w)
    assert n - tc.param_count() == extra != 0


def serve_cli(arch):
    """The serving command line on the smoke config of ``arch``, on the
    CPU; returns the generated tokens of the first prompt."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", arch, "--smoke", "--device", "cpu",
                        "--gen", "6"], capture_output=True, text=True,
                       timeout=120, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    line = [s for s in r.stdout.splitlines() if "tokens[0]" in s][0]
    toks = [int(t) for t in line.split("=")[1].strip(" []").split(",")]
    assert len(toks) == 6
    assert all(0 <= t < tconfigs.get_smoke_config(arch).vocab for t in toks)
    return toks


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_smoke_on_cpu(arch):
    serve_cli(arch)
