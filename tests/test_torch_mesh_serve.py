"""Serving on a mesh: the PyTorch port's ``Model.prefill`` and
``Model.decode_step`` on DTensor parameters (placed by
``Trainer.param_placements``), a batch placed by ``batch_shardings`` and
caches placed by ``cache_shardings``, against the unsharded port, on the
CPU; and two repairs of the port against the JAX package
(``ablate_mixer``, ``attn_scores_dtype``).

The mesh side runs in one spawn of four gloo ranks on (data 2, model 2)
(tests/test_torch_parallel.py's harness), each rank also running the
unsharded model on the same inputs.  Cases, float32, one per family's
smoke config: gemma3 (local and global layers, one KV head: K/V whole
over ``model``, the caches split on their sequence over ``model``) with
FSDP off and on, qwen2-moe (experts over ``model``), mamba2 (FSDP),
recurrentgemma, whisper (ragged ``enc_len``) and qwen2-vl (M-RoPE
components drawn apart).  Each: a prefill of 4 x 20 tokens (past
gemma3's window of 16, so its ring buffers wrap), then three greedy
decode steps.  One more: gemma3 at batch 1 decoding from a
``long_context`` cache (its sequence split over ``data``), written from
an unsharded prefill.

Tolerances: logits within 1e-4 absolute (float32 through a few layers,
sums in another order; the runs here differ by about 5e-6), greedy
tokens equal; the ``ablate_mixer`` logits within 1e-4 of the JAX
package's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from test_torch_parallel import _spawn  # noqa: E402
from test_torch_vlm import _distinct_positions  # noqa: E402

LOGIT_TOL = 1e-4
PROMPT, BATCH, MAX_LEN, STEPS = 20, 4, 28, 3
CASES = [
    {"name": "gemma3", "arch": "gemma3-1b", "fsdp": False},
    {"name": "gemma3-fsdp", "arch": "gemma3-1b", "fsdp": True},
    {"name": "qwen2-moe", "arch": "qwen2-moe-a2.7b", "fsdp": False},
    {"name": "mamba2-fsdp", "arch": "mamba2-780m", "fsdp": True},
    {"name": "recurrentgemma", "arch": "recurrentgemma-9b", "fsdp": False},
    {"name": "whisper-ragged", "arch": "whisper-tiny", "fsdp": False},
    {"name": "qwen2-vl-mrope", "arch": "qwen2-vl-2b", "fsdp": False},
]
IDS = [c["name"] for c in CASES]


def _cfg(arch, **over):
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype="float32", **over)


def _batch(cfg, batch=BATCH):
    b = tshapes.prefill_batch_specs(cfg, PROMPT, batch,
                                    np.random.default_rng(1))
    if cfg.family == "encdec":
        e = cfg.enc_seq
        b["enc_len"] = np.array([e, e * 4 // 5, e * 7 // 15, e // 3][:batch],
                                np.int32)
    if cfg.family == "vlm":
        b["positions"] = _distinct_positions(batch, PROMPT, seed=3)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _serve(model, params, batch, place=None):
    """Prefill logits, each decode step's logits and the greedy tokens;
    with ``place`` (a function of a plain batch) the inputs are placed on
    the mesh and the outputs gathered."""
    put = place or (lambda b: b)
    whole = (lambda t: t.full_tensor()) if place else (lambda t: t)
    pos = PROMPT                       # vlm's image tokens included
    with torch.no_grad():
        logits, cache = model.prefill(params, put(batch), max_len=MAX_LEN)
        logits = [whole(logits)]
        toks = [logits[0].argmax(-1)[:, None]]
        for i in range(STEPS):
            lg, cache = model.decode_step(
                params, put({"tokens": toks[-1]})["tokens"], cache, pos + i)
            logits.append(whole(lg))
            toks.append(logits[-1].argmax(-1)[:, None])
    return logits, toks, cache


def serve_rank(rank, n):
    """Every case on (data 2, model 2): errors against the unsharded port,
    whether the tokens agree, and each cache leaf's placement."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shlib
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    mesh = make_host_mesh(2, device_type="cpu")
    out = {}
    for case in CASES:
        cfg = _cfg(case["arch"])
        model = tbuild(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        batch = _batch(cfg)
        ref_logits, ref_toks, _ = _serve(model, params, batch)
        tr = Trainer(model, opt.OptConfig(),
                     TrainerConfig(fsdp=case["fsdp"]), mesh=mesh)
        tr.place_params(params)

        def place(b):
            pl = tr.batch_placements(b)
            return {k: distribute_tensor(v, mesh, pl[k])
                    for k, v in b.items()}
        logits, toks, cache = _serve(model, params, batch, place)
        specs = shlib.cache_shardings(
            model.init_cache(BATCH, MAX_LEN, "meta"), cfg, mesh)
        placed = [[isinstance(t, DTensor) and list(t.placements)
                   == shlib.placements(spec[k], mesh)
                   for k, t in layer.items()]
                  for layer, spec in zip(cache, specs)]
        out[case["name"]] = {
            "errs": [float((a - b).abs().max())
                     for a, b in zip(logits, ref_logits)],
            "tokens_equal": all(torch.equal(a, b)
                                for a, b in zip(toks, ref_toks)),
            "cache_placed": placed,
            "enc_len_shared": (cfg.family != "encdec" or all(
                c["enc_len"] is cache[0]["enc_len"] for c in cache))}

    out["long_context"] = _long_context(mesh)
    return out


def _long_context(mesh):
    """gemma3 at batch 1: three decode steps from a long-context cache
    (its sequence over ``data``), written from an unsharded prefill,
    against the same steps unsharded."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = _cfg("gemma3-1b")
    model = tbuild(cfg)
    plain_params = model.init(torch.Generator().manual_seed(0))
    params = model.init(torch.Generator().manual_seed(0))
    Trainer(model, opt.OptConfig(), TrainerConfig(),
            mesh=mesh).place_params(params)
    errs = []
    with torch.no_grad():
        _, plain = model.prefill(plain_params,
                                 {"tokens": _batch(cfg, 1)["tokens"]},
                                 max_len=MAX_LEN)
        placed = model.init_cache(1, MAX_LEN, "cpu", mesh=mesh,
                                  long_context=True)
        for lp, lc in zip(plain, placed):
            for k in lp:
                lc[k].to_local().copy_(distribute_tensor(
                    lp[k], mesh, lc[k].placements).to_local())
        nxt = torch.tensor([[5]])
        for i in range(STEPS):
            want, plain = model.decode_step(plain_params, nxt, plain,
                                            PROMPT + i)
            got, placed = model.decode_step(
                params, distribute_tensor(nxt, mesh, [Replicate()] * 2),
                placed, PROMPT + i)
            errs.append(float((got.full_tensor() - want).abs().max()))
            nxt = want.argmax(-1)[:, None]
        whole = [float((lc["k"].full_tensor() - lp["k"]).abs().max())
                 for lp, lc in zip(plain, placed)]
    return {"errs": errs, "cache_errs": whole,
            "seq_split": [[p.is_shard(1) for p in lc["k"].placements]
                          for lc in placed]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _spawn(serve_rank, 4, tmp_path_factory.mktemp("serve"))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_prefill_and_decode_equal_the_unsharded_port(ranks, case):
    for r in ranks:
        got = r[case["name"]]
        assert len(got["errs"]) == 1 + STEPS
        assert max(got["errs"]) <= LOGIT_TOL, got["errs"]
        assert got["tokens_equal"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_caches_placed_by_cache_shardings(ranks, case):
    """Every cache tensor a DTensor placed as ``cache_shardings`` says;
    whisper's ``enc_len`` one tensor shared by every layer."""
    for r in ranks:
        got = r[case["name"]]
        assert all(all(layer) for layer in got["cache_placed"])
        assert got["enc_len_shared"]


def test_mesh_decode_from_a_long_context_cache(ranks):
    """The caches' sequence split over ``data`` (mesh dim 0) and gathered
    for attention; the new keys written on the rank that holds their
    slot: logits and the gathered caches equal the unsharded port's
    (layer 0's keys exactly: its input is the embedding alone)."""
    for r in ranks:
        got = r["long_context"]
        assert all(split == [True, False] for split in got["seq_split"])
        assert max(got["errs"]) <= LOGIT_TOL, got["errs"]
        assert got["cache_errs"][0] == 0.0
        assert max(got["cache_errs"]) <= LOGIT_TOL


# -------------------------------------------------- repairs against JAX
ABLATE = ["gemma3-1b", "mamba2-780m", "recurrentgemma-9b", "whisper-tiny"]


@pytest.mark.parametrize("arch", ABLATE)
def test_ablate_mixer_logits_equal_jax(arch):
    """``ablate_mixer`` skips the sequence mixer (attention, SSM, RG-LRU)
    as the JAX package does (whisper keeps its cross-attention): the
    forward's logits and the prefill's last logits equal JAX's, the
    mixers' caches stay zero, and they differ from the model's with its
    mixers."""
    jc = dataclasses.replace(jconfigs.get_smoke_config(arch),
                             dtype="float32", ablate_mixer=True)
    tc = _cfg(arch, ablate_mixer=True)
    jm, tm = jbuild(jc), tbuild(tc)
    jp = jm.init(jax.random.key(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = convert.params_from_numpy(tc, tree, device="cpu")
    jb = jshapes.prefill_batch_specs(jc, PROMPT, 2, concrete=True,
                                     rng=np.random.default_rng(0))
    tb = {k: torch.from_numpy(v) for k, v in tshapes.prefill_batch_specs(
        tc, PROMPT, 2, np.random.default_rng(0)).items()}
    want, _ = jax.jit(jm.forward)(jp, jb)
    with torch.no_grad():
        got, _ = tm.forward(tp, tb)
        last, cache = tm.prefill(tp, tb, MAX_LEN)
        full, _ = tbuild(_cfg(arch)).forward(tp, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    jlast, _ = jax.jit(lambda p, b: jm.prefill(p, b, max_len=MAX_LEN))(jp,
                                                                       jb)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast, np.float32),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    mixers = ("k", "v", "conv", "h", "ssd")
    assert all(not layer[k].any() for layer in cache for k in mixers
               if k in layer)
    assert (full - got).abs().max() > 1e-3


def test_attn_scores_dtype_other_than_float32_is_refused():
    with pytest.raises(ValueError, match="float32"):
        tbuild(_cfg("gemma3-1b", attn_scores_dtype="bfloat16"))
    tbuild(_cfg("gemma3-1b", attn_scores_dtype="float32"))
