"""The dropless MoE path and the options qwen2-moe publishes
(``moe_dropless``, ``moe_norm_topk``, ``moe_shared_gate``) on the CPU, in
float32: the layer against a per-token loop over its chosen experts on a
router skewed so that one expert takes most rows and some take none;
the router's top-k weights with and without renormalising; the shared
expert's gate; the dropless dispatch against the capacity-bounded one at
a capacity that drops nothing (output and aux loss); a prefill and
decode through the cache against the full forward; the serving engine's
states, which carry their logits, with and without ``cuda_graph`` (which
off the card changes nothing); and autograd through the plain path.
``tests/test_torch_moe.py`` holds the default path to the JAX package."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.models import moe as M
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServeEngine

TOL = 1e-5


def _cfg(**kw):
    base = configs.get_smoke_config("qwen2-moe-a2.7b")
    kw = dict(dict(n_experts=12, top_k=4, n_shared_experts=1, d_ff_shared=48,
                   moe_dropless=True, moe_norm_topk=False,
                   moe_shared_gate=True, dtype="float32"), **kw)
    return dataclasses.replace(base, **kw)


def _params(cfg, seed=0):
    return M.moe_init(torch.Generator().manual_seed(seed), cfg)


def _x(cfg, b=3, s=11, seed=1):
    return torch.randn((b, s, cfg.d_model),
                       generator=torch.Generator().manual_seed(seed))


def _swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def _per_token(p, cfg, x):
    """Each token through its top-k experts one at a time, weighted as the
    router gives them, and the shared expert, gated where the config
    says."""
    xt = x.reshape(-1, cfg.d_model)
    _, top_w, top_e = M.route(p, cfg, xt)
    rows = []
    for t in range(xt.shape[0]):
        y = sum(top_w[t, j] * _swiglu(xt[t], p["gate"][e], p["up"][e],
                                      p["down"][e])
                for j, e in enumerate(top_e[t].tolist()))
        sh = _swiglu(xt[t], p["shared"]["gate"], p["shared"]["up"],
                     p["shared"]["down"])
        if cfg.moe_shared_gate:
            sh = torch.sigmoid(xt[t] @ p["shared_gate"]) * sh
        rows.append(y + sh)
    return torch.stack(rows).reshape(x.shape)


@pytest.mark.parametrize("skew", [False, True])
def test_dropless_layer_equals_a_per_token_loop(skew):
    cfg = _cfg()
    p = _params(cfg)
    if skew:
        # one expert takes every token; the others' scores fall away
        with torch.no_grad():
            p["router"][:, 7:] -= 50.0
    x = _x(cfg)
    if skew:
        x = x.abs()
        with torch.no_grad():
            p["router"][:, 3] = 5.0
    with torch.no_grad():
        y, aux = M.moe_apply(p, cfg, x)
        want = _per_token(p, cfg, x)
    _, _, top_e = M.route(p, cfg, x.reshape(-1, cfg.d_model))
    counts = torch.bincount(top_e.reshape(-1), minlength=cfg.n_experts)
    if skew:
        assert counts[3] == x.shape[0] * x.shape[1]
        assert (counts == 0).any()
    assert torch.allclose(y, want, atol=TOL, rtol=TOL)
    assert aux is not None and torch.isfinite(aux)


@pytest.mark.parametrize("norm", [False, True])
def test_route_keeps_or_renormalises_the_top_k(norm):
    cfg = _cfg(moe_norm_topk=norm)
    p = _params(cfg)
    xt = _x(cfg).reshape(-1, cfg.d_model)
    probs, top_w, top_e = M.route(p, cfg, xt)
    picked = probs.gather(-1, top_e)
    if norm:
        assert torch.allclose(top_w.sum(-1), torch.ones(len(xt)), atol=TOL)
        assert torch.allclose(top_w, picked / picked.sum(-1, keepdim=True))
    else:
        assert torch.equal(top_w, picked)
        assert (top_w.sum(-1) < 1).all()


@pytest.mark.parametrize("dropless", [False, True])
def test_shared_gate_scales_the_shared_expert(dropless):
    gated = _cfg(moe_dropless=dropless)
    p = _params(gated)
    x = _x(gated)
    xt = x.reshape(-1, gated.d_model)
    with torch.no_grad():
        y1, _ = M.moe_apply(p, gated, x, capacity_factor=float(
            gated.n_experts))
        y0, _ = M.moe_apply(p, dataclasses.replace(
            gated, moe_shared_gate=False), x, capacity_factor=float(
                gated.n_experts))
        sh = _swiglu(xt, p["shared"]["gate"], p["shared"]["up"],
                     p["shared"]["down"])
        want = (torch.sigmoid(xt @ p["shared_gate"]) - 1) * sh
    assert p["shared_gate"].shape == (gated.d_model, 1)
    assert torch.allclose((y1 - y0).reshape(xt.shape), want, atol=TOL)


def test_dropless_equals_the_capacity_path_where_nothing_drops():
    cfg = _cfg()
    p = _params(cfg)
    x = _x(cfg)
    with torch.no_grad():
        y, aux = M.moe_apply(p, cfg, x)
        y_cap, aux_cap = M.moe_apply(
            p, dataclasses.replace(cfg, moe_dropless=False), x,
            capacity_factor=float(cfg.n_experts))
        _, none = M.moe_apply(p, cfg, x, with_aux=False)
    assert torch.allclose(y, y_cap, atol=TOL, rtol=TOL)
    assert torch.equal(aux, aux_cap) and none is None


def _model(seed=0):
    cfg = dataclasses.replace(_cfg(), n_layers=2, qkv_bias=True,
                              rope_theta=1e6)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for blk in params.blocks:                # biases not zero
            for b in ("bq", "bk", "bv"):
                blk["attn"][b].normal_(0, 0.1)
    return model, params


def test_prefill_and_decode_equal_the_full_forward():
    model, params = _model()
    tokens = torch.randint(0, model.cfg.vocab, (3, 14),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": tokens})
        last, cache = model.prefill(params, {"tokens": tokens[:, :9]}, 14)
        steps = [last]
        for pos in range(9, 13):
            logits, cache = model.decode_step(
                params, tokens[:, pos:pos + 1], cache, pos)
            steps.append(logits)
    got = torch.stack(steps, dim=1)
    assert torch.allclose(got, full[:, 8:13], atol=1e-4, rtol=1e-4)


def test_autograd_goes_through_the_plain_path_on_the_cpu():
    model, params = _model()
    params.requires_grad_(True)
    tokens = torch.randint(0, model.cfg.vocab, (2, 10),
                           generator=torch.Generator().manual_seed(3))
    loss, metrics = model.loss_fn(params, {"tokens": tokens,
                                           "targets": tokens})
    loss.backward()
    moe = params.blocks[0]["moe"]
    for leaf in ("gate", "up", "down", "router", "shared_gate"):
        g = moe[leaf].grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
    assert float(metrics["aux"]) > 0


def test_engine_states_carry_their_logits_and_the_graph_flag_is_eager_here():
    model, params = _model()
    tokens = torch.randint(0, model.cfg.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(4))
    runs = []
    for graph in (False, True):
        eng = ServeEngine(model, params, max_len=14, cuda_graph=graph)
        st = eng.prefill({"tokens": tokens})
        toks, logits = [st.last_tokens], [st.logits]
        for _ in range(4):
            nxt, st = eng.step(st)
            toks.append(nxt)
            logits.append(st.logits)
        assert not eng._graphs
        runs.append((torch.cat(toks, 1), torch.stack(logits, 1)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    # each state's tokens are its logits' greedy choice
    assert torch.equal(runs[0][1].argmax(-1), runs[0][0])
