"""The PyTorch port's mesh path against the JAX package, on the CPU:
``Trainer(mesh=...)`` (DTensor parameters, moments and batch; FSDP;
tensor parallelism), ``manual_dp.build`` on a model axis, checkpoints of
a sharded state, and ``launch/mesh.py``.

The JAX side runs in one ``python -c`` subprocess with four fake host
devices (``--xla_force_host_platform_device_count=4``): the JAX
``Trainer(mesh=...).build_step(batch)`` (pjit) of every case for three
steps, then the JAX ``manual_dp.build`` on (data 2, model 2).  Its meshes
have ``AxisType.Auto`` axes (JAX 0.9's default Explicit axes refuse the
model code).  The port side runs in a single spawn of four gloo ranks
(tests/test_torch_parallel.py's harness: ``SPAWN_TIMEOUT``, the ranks
killed after), which runs every case in turn.  Inputs are drawn with
numpy and handed to both.

Cases, float32, on (data 2, model 2) unless named: gemma3-smoke (local
and global layers; 2 query heads over 1 KV head, so ``wk``/``wv`` are
whole while ``wq`` is split) with FSDP off and on, qwen3-smoke (qk-norm;
KV heads over ``model``) with 2 microbatches, and qwen3-smoke with FSDP
on (pod 2, data 1, model 2).

Tolerances: each of three steps runs from the JAX package's state before
it (so that a step's last-bit differences do not carry into the next);
loss and grad norm within 1e-5 relative, parameters within 1e-4 absolute
and moments within 1e-6 absolute plus 1e-4 relative, as
tests/test_torch_train_model.py holds the single-device trainer; the
parameter elements whose gradient nearly vanishes (nonzero and below
1e-6, at most 0.1 %)
within one step of the learning rate (``check_forced_steps`` says why).
Placements and checkpoint files: exact.
"""
import dataclasses
import filecmp
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.parallel import sharding as shlib  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402
from test_torch_parallel import (JAX_MANUAL_DP, MDP_ARCH, MDP_STEPS,  # noqa: E402,E501
                                 _by_prefix, _manual_dp_rank, _port_named,
                                 _run, _spawn, check_manual_dp)

from torch.distributed.tensor import _dispatch, _redistribute  # noqa: E402

REDIST = (_dispatch, _redistribute)   # modules that bind the redistributor
STEPS = 3
OPT = dict(lr=5e-3, warmup_steps=1, total_steps=20)
VANISHING = 1e-6    # gradient elements below it: see check_forced_steps
CASES = [
    {"name": "gemma3", "arch": "gemma3-1b", "micro": 1, "fsdp": False,
     "mesh": {"data": 2, "model": 2}},
    {"name": "gemma3-fsdp", "arch": "gemma3-1b", "micro": 1, "fsdp": True,
     "mesh": {"data": 2, "model": 2}},
    {"name": "qwen3-mb2", "arch": "qwen3-1.7b", "micro": 2, "fsdp": False,
     "mesh": {"data": 2, "model": 2}},
    {"name": "qwen3-pod", "arch": "qwen3-1.7b", "micro": 1, "fsdp": True,
     "mesh": {"pod": 2, "data": 1, "model": 2}},
]

JAX_MESH_TRAINER = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.models.model import build_model
from repro.train import optimizer as opt
from repro.train.trainer import Trainer, TrainerConfig

outdir, cases, steps = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
ocfg = opt.OptConfig(**json.loads(sys.argv[4]))
for case in cases:
    cfg = dataclasses.replace(configs.get_smoke_config(case["arch"]),
                              dtype="float32", **case.get("over", {}))
    model = build_model(cfg)
    sizes = case["mesh"]
    n = int(np.prod(list(sizes.values())))
    mesh = jax.make_mesh(tuple(sizes.values()), tuple(sizes),
                         devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(sizes))
    with np.load(f"{outdir}/{case['name']}-batch.npz") as z:
        batch = {k: jnp.asarray(v) for k, v in z.items()}
    tr = Trainer(model, ocfg, TrainerConfig(
        microbatches=case["micro"], fsdp=case["fsdp"], donate=False), mesh)
    fn = tr.build_step(batch)
    params = model.init(jax.random.key(0))
    ost = opt.init(params)
    out = {}

    def save(t, params, ost):
        for tag, tree in (("params", params), ("mu", ost.mu), ("nu", ost.nu)):
            for name, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                out[f"{t}/{tag}" + jax.tree_util.keystr(name)] = \
                    np.asarray(leaf)
        out[f"{t}/step"] = np.asarray(ost.step)

    save(0, params, ost)
    losses, norms = [], []
    for t in range(1, steps + 1):
        params, ost, met = fn(params, ost, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        save(t, params, ost)
    out["losses"], out["norms"] = np.array(losses), np.array(norms)
    np.savez(f"{outdir}/{case['name']}-jax.npz", **out)
if len(sys.argv) > 5:           # then the manual-DP reference, as its own
    sys.argv = [sys.argv[0]] + sys.argv[5:]
"""


def _cfg(case):
    return dataclasses.replace(tconfigs.get_smoke_config(case["arch"]),
                               dtype="float32", **case.get("over", {}))


def dense_batch(cfg, seed=1, batch=4, seq=20):
    """tokens and targets (batch, seq) int32; seq 20 > gemma3-smoke's
    window 16, so its local layers mask."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(
        np.int32),
        "targets": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}


def run_jax(cases, outdir, batch_of, manual_dp=False):
    """Write each case's batch (``batch_of(case)``) and run the JAX side:
    ``<name>-jax.npz`` per case, and with ``manual_dp`` ``mdp.npz``."""
    for case in cases:
        np.savez(outdir / f"{case['name']}-batch.npz", **batch_of(case))
    args = [outdir, json.dumps(cases), STEPS, json.dumps(OPT)]
    code = JAX_MESH_TRAINER
    if manual_dp:
        code += JAX_MANUAL_DP
        args += [outdir / "mdp.npz", MDP_ARCH, MDP_STEPS, "2,2"]
    _run(code, 4, *args)


# ------------------------------------------------------------ port ranks
def trainer_case(rank, case, outdir):
    """One case on this rank: each of STEPS steps of the port's mesh
    Trainer from the JAX state before it.  Returns (on every rank) the
    placements and local shapes of every parameter and moment and the
    local q/k shapes attention saw; on rank 0 also the losses, grad norms
    and whole parameters and moments after each step."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from torch.distributed.device_mesh import init_device_mesh
    cfg = _cfg(case)
    model = build_model(cfg)
    sizes = case["mesh"]
    mesh = init_device_mesh("cpu", tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))
    with np.load(outdir / f"{case['name']}-jax.npz") as z:
        arrays = dict(z)
    with np.load(outdir / f"{case['name']}-batch.npz") as z:
        batch = {k: torch.from_numpy(v) for k, v in z.items()}
    tr = Trainer(model, opt.OptConfig(**OPT), TrainerConfig(
        microbatches=case["micro"], fsdp=case["fsdp"]), mesh=mesh)
    step = tr.build_step(batch)
    seen, drops = set(), []
    plain_ref, plain_dispatch = fa_ref.flash_attention_ref, moe.dispatch

    def ref(q, k, v, **kw):
        seen.add((tuple(q.shape), tuple(k.shape)))
        return plain_ref(q, k, v, **kw)

    def dispatch(top_e, e_pad, capacity):
        order, keep, slot = plain_dispatch(top_e, e_pad, capacity)
        drops.append((int(keep.numel()), int(keep.sum())))
        return order, keep, slot
    fa_ref.flash_attention_ref, moe.dispatch = ref, dispatch
    # every redistribution of a parameter's own shard that makes a dim
    # the model axis split whole (a weight gathered over "model")
    gathered, owners = [], {}
    plain_redist = {m: m.redistribute_local_tensor for m in REDIST}

    def spy(plain):
        def redistribute_local_tensor(local, src, dst, *a, **kw):
            names = src.mesh.mesh_dim_names
            if local.data_ptr() in owners and any(
                    n == "model" and p.is_shard() and not q.is_shard()
                    for n, p, q in zip(names, src.placements,
                                       dst.placements)):
                gathered.append(owners[local.data_ptr()])
            return plain(local, src, dst, *a, **kw)
        return redistribute_local_tensor
    for m, plain in plain_redist.items():
        m.redistribute_local_tensor = spy(plain)
    out = {"forced": []}
    try:
        for t in range(1, STEPS + 1):
            params = convert.params_from_numpy(
                cfg, _by_prefix(arrays, f"{t - 1}/params"), device="cpu")
            ost = convert.opt_state_from_numpy(cfg, {
                "mu": _by_prefix(arrays, f"{t - 1}/mu"),
                "nu": _by_prefix(arrays, f"{t - 1}/nu"),
                "step": arrays[f"{t - 1}/step"]}, device="cpu")
            ost = tr.place(params, ost)
            owners.update((v.to_local().data_ptr(), n) for n, v in
                          T.flatten_with_names(params.tree()))
            params, ost, met = step(params, ost, batch)
            owners.clear()
            whole = {key: {n: v.full_tensor().detach() for n, v in
                           T.flatten_with_names(tree)}
                     for key, tree in (("params", params.tree()),
                                       ("mu", ost.mu), ("nu", ost.nu))}
            if rank == 0:
                out["forced"].append(dict(
                    whole, loss=float(met["loss"]),
                    grad_norm=float(met["grad_norm"]),
                    step=int(ost.step.full_tensor())))
    finally:
        fa_ref.flash_attention_ref, moe.dispatch = plain_ref, plain_dispatch
        for m, plain in plain_redist.items():
            m.redistribute_local_tensor = plain
    out["gathered_over_model"] = sorted(set(gathered))
    out["attention"] = sorted(seen)
    out["drops"] = drops
    out["leaves"] = {key: {n: (list(v.placements),
                               tuple(v.to_local().shape), tuple(v.shape))
                           for n, v in T.flatten_with_names(tree)}
                     for key, tree in (("params", params.tree()),
                                       ("mu", ost.mu), ("nu", ost.nu))}
    out["step_placements"] = list(ost.step.placements)
    return out


def checkpoint_case(rank, case, outdir):
    """``fit`` on the mesh with ``ckpt_every=1`` for 2 steps from the JAX
    initial state, an unsharded save of the state it ends with (rank 0),
    a resume from LATEST for one more step beside the same step run on
    from memory."""
    import torch.distributed as dist
    from repro_torch.models.model import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from torch.distributed.device_mesh import init_device_mesh
    cfg = _cfg(case)
    model = build_model(cfg)
    sizes = case["mesh"]
    mesh = init_device_mesh("cpu", tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))
    with np.load(outdir / f"{case['name']}-jax.npz") as z:
        arrays = dict(z)
    with np.load(outdir / f"{case['name']}-batch.npz") as z:
        batch = {k: torch.from_numpy(v) for k, v in z.items()}

    def fresh():
        return (convert.params_from_numpy(
            cfg, _by_prefix(arrays, "0/params"), device="cpu"),
            convert.opt_state_from_numpy(cfg, {
                "mu": _by_prefix(arrays, "0/mu"),
                "nu": _by_prefix(arrays, "0/nu"),
                "step": arrays["0/step"]}, device="cpu"))

    def trainer(steps):
        return Trainer(model, opt.OptConfig(**OPT), TrainerConfig(
            steps=steps, log_every=1, ckpt_every=1, fsdp=case["fsdp"],
            ckpt_dir=str(outdir / "ckpt-mesh")), mesh=mesh)
    tr = trainer(2)
    params, ost, hist = tr.fit(*fresh(), iter([batch] * 2), resume=False)
    full = T.map_tree(lambda v: v.full_tensor().detach(),
                      (params.tree(), ost))
    if rank == 0:
        ckpt.save(str(outdir / "ckpt-plain"), 2, full)
    dist.barrier()
    params, ost, more = tr.build_step()(params, ost, batch)
    p2, o2, hist2 = trainer(1).fit(*fresh(), iter([batch]), resume=True)
    same = all(torch.equal(a.to_local(), b.to_local()) for a, b in
               zip(T.leaves((params.tree(), ost)), T.leaves((p2.tree(),
                                                              o2))))
    return {"hist": hist, "hist2": hist2, "more": float(more["loss"]),
            "same": same}


def meshes_case(rank):
    from repro_torch.launch import mesh as lmesh
    m = lmesh.make_host_mesh(2, device_type="cpu")
    out = {"shape": tuple(m.shape), "names": m.mesh_dim_names}
    for multi in (False, True):
        try:
            lmesh.make_production_mesh(multi_pod=multi, device_type="cpu")
            out[multi] = None
        except RuntimeError as e:
            out[multi] = str(e)
    return out


def remat_case(rank):
    """The matrix products the backward of gemma3-smoke's loss runs under
    remat "dots" on the (data 2, model 2) mesh with FSDP and on plain
    tensors, and under "full" on plain tensors (which recomputes them)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from torch.distributed.device_mesh import init_device_mesh
    dots = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in dots
            return func(*args, **(kwargs or {}))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    batch = {k: torch.from_numpy(v) for k, v in dense_batch(
        _cfg(CASES[0])).items()}
    out = {}
    for remat, meshed in (("dots", True), ("dots", False), ("full", False)):
        cfg = dataclasses.replace(_cfg(CASES[0]), remat=remat)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        b = batch
        if meshed:
            tr = Trainer(model, opt.OptConfig(), TrainerConfig(fsdp=True),
                         mesh=mesh)
            tr.place(params, opt.init(params.tree()))
            b = tr._batches(batch, None)[0]
        leaves = T.leaves(params.tree())
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss_fn(params, b)
        with Count() as c:
            torch.autograd.grad(loss, leaves)
        out[(remat, meshed)] = c.n
    return out


def mesh_rank(rank, n, outdir, cases, checkpoint):
    """Every case of one test file on this rank, in turn."""
    outdir = Path(outdir)
    out = {"cases": {c["name"]: trainer_case(rank, c, outdir)
                     for c in cases}}
    if checkpoint:
        out["ckpt"] = checkpoint_case(rank, cases[1], outdir)
        out["meshes"] = meshes_case(rank)
        out["remat"] = remat_case(rank)
        # last: it swaps the compressed mean's quantiser for a recorder
        out["manual_dp"] = _manual_dp_rank(rank, n, str(outdir / "mdp.npz"),
                                           (2, 2))
    return out


# ------------------------------------------------------------------ checks
@pytest.fixture(scope="module")
def results(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("mesh")
    run_jax(CASES, outdir, lambda c: dense_batch(_cfg(c)), manual_dp=True)
    ranks = _spawn(mesh_rank, 4, outdir, str(outdir), CASES, True)
    return outdir, ranks


def check_forced_steps(outdir, ranks, case):
    """Each step from the JAX state before it against the JAX step.  The
    parameters are held within 1e-4, but for elements whose gradient is
    nonzero and below VANISHING (at most 0.1 % of all), which are held
    within one step of the learning rate each way: AdamW divides by
    sqrt(v) + eps, so on a first step (v = (1 - b2) g^2) an element's
    update is lr g / (|g| + eps), and for |g| near eps = 1e-8 the float32
    rounding of the gradient, which the two frameworks' different sums
    leave (5e-10 there where other elements are 1e-2), moves the update
    by up to 4e5 times as much."""
    with np.load(outdir / f"{case['name']}-jax.npz") as z:
        arrays = dict(z)
    tc = _cfg(case)
    forced = ranks[0]["cases"][case["name"]]["forced"]
    assert len(forced) == STEPS
    vanishing = [0, 0]
    for t, f in enumerate(forced, start=1):
        assert f["loss"] == pytest.approx(float(arrays["losses"][t - 1]),
                                          rel=1e-5)
        assert f["grad_norm"] == pytest.approx(float(arrays["norms"][t - 1]),
                                               rel=1e-5)
        assert f["step"] == int(arrays[f"{t}/step"])
        mu0, mu1 = (_port_named(tc, _by_prefix(arrays, f"{s}/mu"))
                    for s in (t - 1, t))
        for key in ("params", "mu", "nu"):
            want = _port_named(tc, _by_prefix(arrays, f"{t}/{key}"))
            assert sorted(want) == sorted(f[key])
            for name, w in want.items():
                got = f[key][name].numpy()
                if key != "params":
                    np.testing.assert_allclose(got, w, atol=1e-6, rtol=1e-4,
                                               err_msg=f"{t} {key} {name}")
                    continue
                # the step's clipped gradient, from the JAX moments
                g = (mu1[name] - 0.9 * mu0[name]) / 0.1
                off = np.abs(got - w) > 1e-4
                assert np.all((np.abs(g[off]) < VANISHING) & (g[off] != 0)), \
                    (t, name, np.abs(got - w).max(), g[off][:4])
                assert np.abs(got - w).max() <= 2 * OPT["lr"], (t, name)
                vanishing[0] += int(off.sum())
                vanishing[1] += off.size
    assert vanishing[0] <= 1e-3 * vanishing[1], vanishing
    assert arrays["losses"][-1] < arrays["losses"][0]


def check_placements(ranks, case):
    """Every parameter and moment a DTensor with the rules' placements
    and the sharded local shape, on every rank; the step replicated."""
    from torch.distributed.tensor import Replicate
    tc = _cfg(case)
    sizes = case["mesh"]
    model_tree = _port_model_tree(tc)
    specs = dict(zip((n for n, _ in T.flatten_with_names(model_tree)),
                     T.leaves_like(shlib.map_with_path(
                         lambda path, leaf: shlib.param_spec(
                             path, leaf.shape, tc, sizes, case["fsdp"]),
                         model_tree), model_tree)))
    for r in ranks:
        res = r["cases"][case["name"]]
        assert res["step_placements"] == [Replicate()] * len(sizes)
        for key in ("params", "mu", "nu"):
            leaves = res["leaves"][key]
            assert sorted(leaves) == sorted(specs)
            for name, (place, local, shape) in leaves.items():
                assert place == shlib.placements(specs[name], sizes), \
                    (key, name)
                want = list(shape)
                for axis, p in zip(sizes, place):
                    if p.is_shard():
                        want[p.dim] //= sizes[axis]
                assert local == tuple(want), (key, name)


def _port_model_tree(tc):
    from repro_torch.models.model import build_model
    return build_model(tc).init_eval().tree()


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_mesh_trainer_forced_steps_vs_jax(results, case):
    """Three steps of ``Trainer(mesh=...)`` on 4 gloo ranks, each from the
    JAX package's state before it, against the JAX pjit ``Trainer``'s:
    loss and grad norm 1e-5 relative, parameters 1e-4, moments 1e-6 plus
    1e-4 relative."""
    outdir, ranks = results
    check_forced_steps(outdir, ranks, case)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_mesh_trainer_placements_and_local_heads(results, case):
    """After the steps every parameter and moment is a DTensor placed by
    ``parallel/sharding.py``'s rules with the sharded local shape, the
    step replicated; no parameter's shard was gathered over ``model``;
    attention ran on each rank's local heads."""
    _, ranks = results
    check_placements(ranks, case)
    tc = _cfg(case)
    dp = case["mesh"].get("pod", 1) * case["mesh"]["data"]
    for r in ranks:
        assert r["cases"][case["name"]]["gathered_over_model"] == []
    tp = case["mesh"]["model"]
    rows = 4 // case["micro"] // dp
    s = 20
    kv = tc.n_heads // tp // (tc.n_heads // tc.n_kv_heads) or 1
    for r in ranks:
        seen = r["cases"][case["name"]]["attention"]
        assert seen == [((rows, s, tc.n_heads // tp, tc.head_dim),
                         (rows, s, kv, tc.head_dim))], seen


def test_gemma3_whole_kv_heads_serve_each_ranks_query_heads(results):
    """gemma3-smoke: 2 query heads over 1 KV head on a model axis of 2, so
    ``wk`` and ``wv`` are whole on every rank while ``wq`` and ``wo`` are
    split; each rank attends its one query head with the KV head."""
    _, ranks = results
    leaves = ranks[0]["cases"]["gemma3"]["leaves"]["params"]
    wq = leaves["['blocks'][0]['attn']['wq']"]
    wk = leaves["['blocks'][0]['attn']['wk']"]
    assert wq[1] == (48, 24) and wk[1] == (48, 24)
    assert [p.is_shard(1) for p in wq[0]] == [False, True]
    assert all(p.is_replicate() for p in wk[0])


def test_manual_dp_build_on_a_model_axis_vs_jax(results):
    """``manual_dp.build`` on (data 2, model 2) against the JAX ``build``
    on a (2, 2) mesh, with the checks and tolerances of
    tests/test_torch_parallel.py's two-rank test; each leaf's int8 scale
    is the maximum over the whole leaf (the recorded scales are the same
    on every rank)."""
    outdir, ranks = results
    with np.load(outdir / "mdp.npz") as z:
        arrays = dict(z)
    results_mdp = [r["manual_dp"] for r in ranks]
    check_manual_dp(results_mdp, arrays)
    for t in range(MDP_STEPS):
        scales = [r["forced"][t]["scales"] for r in results_mdp]
        assert all(s == scales[0] for s in scales[1:])


def test_mesh_checkpoint_is_the_unsharded_files_and_resumes(results):
    """``fit(ckpt_every=1)`` on the mesh (gemma3-smoke, FSDP) writes the
    files an unsharded save of the same state writes, byte for byte, and
    a new ``fit`` resumes from LATEST onto the mesh: its step is the one
    run on from memory."""
    outdir, ranks = results
    mine = outdir / "ckpt-mesh" / "step-00000002"
    plain = outdir / "ckpt-plain" / "step-00000002"
    files = sorted(os.listdir(plain))
    assert sorted(os.listdir(mine)) == files and len(files) > 10
    _, mismatch, errors = filecmp.cmpfiles(mine, plain, files, shallow=False)
    assert not mismatch and not errors
    for r in ranks:
        c = r["ckpt"]
        assert [h["step"] for h in c["hist"]] == [1, 2]
        assert [h["step"] for h in c["hist2"]] == [3]
        assert c["hist2"][0]["loss"] == c["more"]
        assert c["same"]


def test_launch_meshes_on_four_ranks(results):
    """``make_host_mesh(2)`` over 4 ranks is (data 2, model 2);
    ``make_production_mesh`` needs 256 (or 512) ranks and says so."""
    _, ranks = results
    for r in ranks:
        m = r["meshes"]
        assert m["shape"] == (2, 2) and m["names"] == ("data", "model")
        assert "256" in m[False] and "512" in m[True]
        assert "XLA" not in m[False] + m[True]


def test_remat_dots_saves_the_dtensor_products(results):
    """Under remat "dots" the mesh step's backward runs as many matrix
    products as the plain step's (the selective-checkpoint policy saves
    the DTensor products, as it saves plain ones), and fewer than under
    "full", which recomputes them."""
    _, ranks = results
    for r in ranks:
        n = r["remat"]
        assert n[("dots", True)] == n[("dots", False)] < n[("full", False)]
