"""The PyTorch port's training substrate against the JAX package, on the
CPU: the optimizer, checkpoints (the same files from the same tree, and a
JAX trainer's checkpoint resumed in the port), the fault supervisor and
``FabricGradSync``.  Every test feeds the same numpy inputs to both
packages.

Tolerances:
* optimizer in float32: 1e-6 (the same float32 operations in the same
  order; XLA may fuse them).  bfloat16 parameters: one bfloat16 step
  (both round the same float32 update, which may differ in its last bit).
* checkpoint files and manifests, restart counts and ``FabricGradSync``'s
  means and counts: exact (bytes, integers, the same numpy reductions).
* a JAX checkpoint resumed in the port, float32: losses 1e-5 relative,
  parameters 2e-5 absolute (a few float32 training steps through both
  frameworks' autodiff, in other summation orders).
"""
import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import mpi as jmpi  # noqa: E402
from repro.launch import faults as jfaults  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.net import LinkConfig as JLinkConfig  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.manual_dp import FabricGradSync as JSync  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import mpi as tmpi  # noqa: E402
from repro_torch.launch import faults  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.net import LinkConfig as TLinkConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402
from repro_torch.train.manual_dp import FabricGradSync as TSync  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

F32_TOL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _trees(seed, dtype="float32"):
    """The same random tree as JAX arrays and as torch tensors."""
    rng = np.random.default_rng(seed)
    raw = {"w": rng.normal(size=(6, 5)).astype(np.float32),
           "layers": [{"b": rng.normal(size=(5,)).astype(np.float32)},
                      rng.normal(size=(3, 2, 2)).astype(np.float32)]}
    jdt = jnp.dtype(dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return (jax.tree.map(lambda a: jnp.asarray(a, jdt), raw),
            T.map_tree(lambda a: torch.tensor(a).to(tdt), raw), raw)


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_vs_jax(schedule):
    cfg = dict(lr=3e-3, warmup_steps=7, total_steps=50, schedule=schedule)
    for s in (0, 1, 3, 7, 8, 20, 49, 50, 60):
        want = float(jopt.schedule_lr(jopt.OptConfig(**cfg), jnp.asarray(s)))
        got = float(opt.schedule_lr(opt.OptConfig(**cfg),
                                    torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=F32_TOL, abs=1e-12), s


@pytest.mark.parametrize("scale", [1e-3, 50.0])
def test_global_norm_and_clip_vs_jax(scale):
    jt, tt, _ = _trees(1)
    jt = jax.tree.map(lambda a: a * scale, jt)
    tt = T.map_tree(lambda a: a * scale, tt)
    assert float(opt.global_norm(tt)) == pytest.approx(
        float(jopt.global_norm(jt)), rel=F32_TOL)
    jc, jn = jopt.clip_by_global_norm(jt, 1.0)
    tc, tn = opt.clip_by_global_norm(tt, 1.0)
    assert float(tn) == pytest.approx(float(jn), rel=F32_TOL)
    for a, b in zip(T.leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=F32_TOL,
                                   atol=F32_TOL)


def _bf16_steps(a, b):
    """|a - b| in units of the bfloat16 spacing at max(|a|, |b|)."""
    mag = np.maximum(np.abs(a), np.abs(b))
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return np.abs(a - b) / spacing


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_vs_jax(dtype):
    jp, tp, _ = _trees(2, dtype)
    js, ts = jopt.init(jp), opt.init(tp)
    assert all(m.dtype == torch.float32 for m in T.leaves(ts.mu))
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=8, weight_decay=0.1)
    rng = np.random.default_rng(3)
    for step in range(6):
        graw = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 2)
                            .astype(np.float32), jax.tree.map(np.asarray, jp))
        jdt = jnp.dtype(dtype)
        jp, js, jm = jopt.apply_updates(
            jp, js, jax.tree.map(lambda a: jnp.asarray(a, jdt), graw),
            jopt.OptConfig(**cfg))
        tdt = tp["w"].dtype
        tp, ts, tm = opt.apply_updates(
            tp, ts, T.map_tree(lambda a: torch.tensor(a).to(tdt), graw),
            opt.OptConfig(**cfg))
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        for k in ("lr", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=F32_TOL)
        for a, b in zip(T.leaves((ts.mu, ts.nu)),
                        jax.tree.leaves((js.mu, js.nu))):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5,
                                       atol=F32_TOL)
        for a, b in zip(T.leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == tdt
            if dtype == "float32":
                np.testing.assert_allclose(_np(a), _np(b), rtol=F32_TOL,
                                           atol=F32_TOL)
            else:
                assert _bf16_steps(_np(a), _np(b)).max() <= 1.0


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    ost = opt.init(params)
    cfg = opt.OptConfig(lr=0.1, warmup_steps=0, total_steps=100,
                        weight_decay=0.0, schedule="constant")
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, ost, _ = opt.apply_updates(params, ost, g, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert abs(float(opt.global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) == pytest.approx(200.0)


def test_lr_schedule_shapes():
    cfg = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        schedule="cosine")
    lrs = [float(opt.schedule_lr(cfg, torch.tensor(s))) for s in
           (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.0, abs=1e-6)


# ------------------------------------------------------------ checkpoint
def _ckpt_tree():
    return {"a": torch.arange(10, dtype=torch.float32),
            "nested": [{"b": torch.ones((3, 4), dtype=torch.bfloat16)},
                       torch.tensor(7, dtype=torch.int32)]}


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = _ckpt_tree()
    d = str(tmp_path)
    ckpt.save(d, 5, tree)
    ckpt.save(d, 10, T.map_tree(lambda x: x * 2, tree))
    assert ckpt.latest_step(d) == 10
    restored, step = ckpt.restore(d, tree, device="cpu")
    assert step == 10
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(10) * 2)
    assert restored["nested"][0]["b"].dtype == torch.bfloat16
    assert float(restored["nested"][0]["b"][0, 0]) == 2.0
    assert restored["nested"][1].shape == () and \
        int(restored["nested"][1]) == 14
    # older checkpoint still restorable
    restored5, _ = ckpt.restore(d, tree, step=5, device="cpu")
    np.testing.assert_array_equal(restored5["a"].numpy(), np.arange(10))
    # a save that fails half-way leaves no partial step and LATEST as it was
    with pytest.raises(TypeError):
        ckpt.save(d, 15, {"a": tree["a"], "z": object()})
    assert ckpt.latest_step(d) == 10
    assert sorted(os.listdir(d)) == ["LATEST", "step-00000005",
                                     "step-00000010"]


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError):
        ckpt.restore(d, {"w": torch.zeros((5,))}, device="cpu")


def test_checkpoint_files_equal_jax(tmp_path):
    """The same tree saved by both packages: byte-identical leaf files
    and equal manifests; each package restores the other's."""
    rng = np.random.default_rng(4)
    raw = {"emb": rng.normal(size=(7, 3)).astype(np.float32),
           "layers": [{"w": rng.normal(size=(3, 3)).astype(np.float32)},
                      {"w": rng.normal(size=(3, 3)).astype(np.float32)}],
           "step": np.int32(12), "mask": np.array([True, False, True]),
           "count": np.arange(5, dtype=np.int32)}
    bf16 = {"emb", "layers"}

    def jleaf(path, a):
        top = path[0].key
        return jnp.asarray(a, jnp.bfloat16 if top in bf16 else a.dtype)

    def tleaf(name, a):
        t = torch.tensor(a)
        return t.to(torch.bfloat16) if name.split("'")[1] in bf16 else t
    jt = jax.tree_util.tree_map_with_path(jleaf, raw)
    tt = T.map_with_names(tleaf, raw)
    jd, td = tmp_path / "jax", tmp_path / "port"
    jckpt.save(str(jd), 3, (jt, jopt.init(jt)))
    ckpt.save(str(td), 3, (tt, opt.init(tt)))
    js, ts = jd / "step-00000003", td / "step-00000003"
    files = sorted(os.listdir(js))
    assert files == sorted(os.listdir(ts)) and len(files) > 10
    for f in files:
        assert filecmp.cmp(js / f, ts / f, shallow=False), f
    assert json.loads((js / "manifest.json").read_text()) == \
        json.loads((ts / "manifest.json").read_text())
    # the port restores the JAX files bit for bit
    back, _ = ckpt.restore(str(jd), (tt, opt.init(tt)), device="cpu")
    for a, b in zip(T.leaves(back), T.leaves((tt, opt.init(tt)))):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------- trainer and resumption
def _cfgs(arch="qwen3-1.7b"):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch),
                                dtype="float32"),
            dataclasses.replace(tconfigs.get_smoke_config(arch),
                                dtype="float32"))


def _jbatches(cfg, n, start=0, batch=4, seq=24):
    corpus = jdata.SyntheticCorpus(cfg.vocab, seed=1)
    for i in range(start, start + n):
        toks = corpus.batch(i, batch, seq)
        yield {"tokens": jnp.asarray(toks[:, :-1]),
               "targets": jnp.asarray(toks[:, 1:])}


def _tbatches(cfg, n, start=0, batch=4, seq=24):
    for b in _jbatches(cfg, n, start, batch, seq):
        yield {k: torch.tensor(np.asarray(v)) for k, v in b.items()}


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A JAX trainer checkpoints its smoke model after 3 steps and goes on
    for 3 more; the port reads the checkpoint (``read_numpy``), carries it
    over (``convert.state_from_checkpoint``) and takes the same 3 steps on
    the same batches: the same losses and parameters."""
    jc, tc = _cfgs()
    jm, tm = jbuild(jc), tbuild(tc)
    ocfg = dict(lr=5e-3, warmup_steps=2, total_steps=20)
    d = str(tmp_path / "jax")
    jtr = JTrainer(jm, jopt.OptConfig(**ocfg), JTrainerConfig(
        steps=3, log_every=1, ckpt_every=3, ckpt_dir=d, donate=False))
    jp = jm.init(jax.random.key(0))
    jp, js, _ = jtr.fit(jp, jopt.init(jp), _jbatches(jc, 3), resume=False)
    jtr2 = JTrainer(jm, jopt.OptConfig(**ocfg), JTrainerConfig(
        steps=3, log_every=1, donate=False))
    jp, js, jhist = jtr2.fit(jp, js, _jbatches(jc, 3, start=3),
                             resume=False)

    arrays = ckpt.read_numpy(d)
    assert ckpt.latest_step(d) == 3
    tp, ts = convert.state_from_checkpoint(tc, arrays, device="cpu")
    assert int(ts.step) == 3 and ts.step.dtype == torch.int32
    tr = Trainer(tm, opt.OptConfig(**ocfg), TrainerConfig(steps=3,
                                                          log_every=1))
    tp, ts, thist = tr.fit(tp, ts, _tbatches(tc, 3, start=3), resume=False)
    assert [h["step"] for h in thist] == [h["step"] for h in jhist]
    for a, b in zip(thist, jhist):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
    want = convert.port_layout(tc, jax.tree.map(np.asarray, jp))
    for a, b in zip(T.leaves(tp.tree()), T.leaves(want)):
        np.testing.assert_allclose(_np(a), b, atol=2e-5, rtol=0)
    assert int(ts.step) == int(js.step) == 6


def test_trainer_checkpoint_restart(tmp_path):
    """As ``tests/test_train.py``: a restart resumes from LATEST and runs
    ``steps`` more steps (the batch iterator starts again from its
    beginning, as in the JAX trainer)."""
    _, tc = _cfgs()
    tm = tbuild(tc)

    def trainer():
        return Trainer(tm, opt.OptConfig(lr=5e-3, warmup_steps=2,
                                         total_steps=200),
                       TrainerConfig(steps=6, log_every=2, ckpt_every=3,
                                     ckpt_dir=str(tmp_path)))
    params = tm.init(torch.Generator().manual_seed(0))
    trainer().fit(params, opt.init(params.tree()), _tbatches(tc, 6),
                  resume=False)
    assert ckpt.latest_step(str(tmp_path)) == 6
    saved, _ = ckpt.restore(str(tmp_path), (params.tree(),
                                            opt.init(params.tree())),
                            device="cpu")
    fresh = tm.init(torch.Generator().manual_seed(9))     # wrong params
    tr = trainer()
    calls = []
    step_fn = tr.build_step()

    def spy(p, o, b):
        if not calls:       # the first step starts from the checkpoint
            for a, w in zip(T.leaves((p.tree(), o)), T.leaves(saved)):
                assert torch.equal(a, w)
        calls.append(1)
        return step_fn(p, o, b)
    tr._step_fn = spy
    tr.fit(fresh, opt.init(fresh.tree()), _tbatches(tc, 12), resume=True)
    assert ckpt.latest_step(str(tmp_path)) == 12 and len(calls) == 6


def test_trainer_mesh_path_waits_for_parallel():
    """The Trainer's mesh branch no longer raises: it takes a mesh (here
    an {axis: size} mapping, which needs no process group) and places
    every parameter by ``param_shardings`` with its ``fsdp`` flag, the
    moments like them and the step replicated.  The mesh step itself,
    and ``manual_dp.build`` on a model axis above 1, are held to the JAX
    package on gloo ranks in tests/test_torch_mesh.py."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel import sharding as shlib
    _, tc = _cfgs()
    sizes = {"data": 2, "model": 2}
    for fsdp in (False, True):
        tr = Trainer(tbuild(tc), opt.OptConfig(), TrainerConfig(fsdp=fsdp),
                     mesh=sizes)
        pp, op = tr.state_placements()
        tree = tbuild(tc).init_eval().tree()
        specs = T.leaves_like(shlib.param_shardings(tree, tc, sizes,
                                                    fsdp=fsdp), tree)
        got = T.leaves_like(pp, tree)
        assert got == [shlib.placements(s, sizes) for s in specs]
        assert T.leaves_like(op.mu, tree) == got
        assert op.step == [Replicate(), Replicate()]
        wq = dict(zip((n for n, _ in T.flatten_with_names(tree)),
                      got))["['blocks'][0]['attn']['wq']"]
        assert wq == [Shard(0) if fsdp else Replicate(), Shard(1)]


# ---------------------------------------------------------------- faults
def test_run_with_restarts_recovers():
    for F in (jfaults, faults):
        calls = {"n": 0}

        def make_state():
            return {"value": calls["n"]}

        def run(state, attempt):
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError(f"simulated node failure #{calls['n']}")
            return "done"

        result, report = F.run_with_restarts(make_state, run,
                                             max_restarts=5)
        assert result == "done"
        assert report.restarts == 2
        assert report.errors == ["RuntimeError: simulated node failure #1",
                                 "RuntimeError: simulated node failure #2"]
    result, report = faults.run_with_restarts(
        dict, lambda s, a: 1 / 0, max_restarts=1)
    assert result is None and not report.succeeded and report.restarts == 1


def test_nan_guard():
    g = faults.NaNGuard()
    g.check(1.0)
    with pytest.raises(FloatingPointError):
        g.check(float("nan"))
    g2 = faults.NaNGuard(patience=2)
    g2.check(float("inf"))
    g2.check(0.5)                     # a finite loss resets the strikes
    g2.check(float("inf"))
    with pytest.raises(FloatingPointError):
        g2.check(float("nan"))


def test_fault_tolerant_training_resumes_like_jax(tmp_path):
    """``tests/test_train.py``'s story in both packages from one state:
    crash at the sixth batch, restart, resume from the checkpoint at step
    4, run 10 more steps; the same restarts, errors, checkpoints and
    losses."""
    jc, tc = _cfgs()
    jm, tm = jbuild(jc), tbuild(tc)
    jp0 = jm.init(jax.random.key(0))
    tree0 = jax.tree.map(np.asarray, jp0)
    out = {}
    for name, pkg in (("jax", True), ("port", False)):
        crash = {"armed": True}
        d = str(tmp_path / name)

        def make_state():
            if pkg:
                return jp0, jopt.init(jp0)
            p = convert.params_from_numpy(tc, tree0, device="cpu")
            return p, opt.init(p.tree())

        def run(state, attempt):
            params, ost = state
            if pkg:
                tr = JTrainer(jm, jopt.OptConfig(lr=1e-3, warmup_steps=0,
                                                 total_steps=100),
                              JTrainerConfig(steps=10, ckpt_every=2,
                                             log_every=1, ckpt_dir=d,
                                             donate=False))
                src = _jbatches(jc, 10)
            else:
                tr = Trainer(tm, opt.OptConfig(lr=1e-3, warmup_steps=0,
                                               total_steps=100),
                             TrainerConfig(steps=10, ckpt_every=2,
                                           log_every=1, ckpt_dir=d))
                src = _tbatches(tc, 10)

            def batches():
                for i, b in enumerate(src):
                    if crash["armed"] and i == 5:
                        crash["armed"] = False
                        raise RuntimeError("preemption")
                    yield b
            return tr.fit(params, ost, batches(), resume=True)

        F = jfaults if pkg else faults
        result, report = F.run_with_restarts(make_state, run,
                                             max_restarts=2)
        assert result is not None and report.succeeded
        out[name] = (report, result[2], sorted(os.listdir(d)))
    (jr, jh, jfiles), (tr_, th, tfiles) = out["jax"], out["port"]
    assert tr_.restarts == jr.restarts == 1
    assert tr_.errors == jr.errors == ["RuntimeError: preemption"]
    assert tfiles == jfiles and "step-00000014" in tfiles
    assert [h["step"] for h in th] == [h["step"] for h in jh] == \
        list(range(5, 15))
    for a, b in zip(th, jh):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)


# ------------------------------------------------------- FabricGradSync
def test_fabric_grad_sync_equals_jax():
    """``tests/test_mpi_large.py``'s 3-rank gradient sync on both
    packages: bit-equal means on every shard, the same ``last_stats``."""
    out = []
    for mpi, Link, Sync, kw in ((jmpi, JLinkConfig, JSync, {}),
                                (tmpi, TLinkConfig, TSync,
                                 dict(device="cpu"))):
        cfg = mpi.MpiConfig(eager_threshold=1024, eager_slot_bytes=4096,
                            coll_seg_bytes=2048, n_rdv_slots=4)
        comm = mpi.Communicator(3, seed=5, cfg=cfg,
                                link_cfg=Link(loss=0.02, latency=1), **kw)
        rng = np.random.default_rng(7)
        grads = [dict(w=rng.normal(size=(64, 32)).astype(np.float32),
                      b=rng.normal(size=(64,)).astype(np.float32))
                 for _ in range(3)]
        sync = Sync(comm)
        sync.post([{k: g[k].copy() for k in g} for g in grads])
        hooks = 1
        while not sync.progress(8):       # the backprop hook
            hooks += 1
        out.append((sync.wait(), sync.last_stats, hooks, comm.now, grads))
    (jm, js, jh, jn, grads), (tm, ts, th, tn, _) = out
    assert ts == js and (th, tn) == (jh, jn)
    assert ts["grad_bytes"] == 64 * 32 * 4 + 64 * 4
    for key in ("w", "b"):
        ref = np.mean(np.stack([g[key] for g in grads]), axis=0,
                      dtype=np.float64)
        for a, b in zip(tm, jm):
            assert a[key].dtype == np.float32
            np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_allclose(a[key], ref, rtol=1e-5, atol=1e-6)


def test_fabric_grad_sync_takes_tensor_trees():
    """Tensor leaves (the port's gradients) come back as tensors of their
    dtype, equal to the numpy path's means."""
    comm = tmpi.Communicator(2, seed=3, device="cpu")
    rng = np.random.default_rng(8)
    raw = [{"w": rng.normal(size=(8, 4)).astype(np.float32),
            "s": [rng.normal(size=(3,)).astype(np.float32)]}
           for _ in range(2)]
    sync = TSync(comm)
    sync.post([T.map_tree(torch.tensor, g) for g in raw])
    while not sync.progress(4):
        pass
    means = sync.wait()
    for m in means:
        assert isinstance(m["w"], torch.Tensor) and m["w"].dtype == \
            torch.float32
        np.testing.assert_allclose(m["s"][0].numpy(),
                                   (raw[0]["s"][0] + raw[1]["s"][0]) / 2,
                                   rtol=1e-6)
    with pytest.raises(RuntimeError):
        sync.post([raw[0], raw[1]])
        sync.post([raw[0], raw[1]])
