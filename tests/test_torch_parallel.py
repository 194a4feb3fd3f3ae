"""The PyTorch port's ``parallel/`` (sharding rules, the int8
error-feedback gradient mean), ``train/manual_dp.build`` and
``checkpoint.restore(shardings=)`` against the JAX package, on the CPU.

The JAX side runs in subprocesses with fake host devices
(``--xla_force_host_platform_device_count``, as tests/test_sharding.py
does): 512 for the sharding rules at (data 16, model 16), (pod 2, data 16,
model 16) and (data 8, model 1), 4 for the compressed mean and the
manual-DP step.  The port's multi-rank side runs in spawned CPU processes
on a gloo process group (a ``file://`` store in the test's directory),
one per rank; each spawned test joins its processes within its own
timeout, so a
hung rendezvous fails the test instead of stalling the suite.  Inputs
are drawn with numpy and handed to both.

Tolerances:
* sharding specs: equal, leaf by leaf, for every arch of ``configs``.
* compressed mean, n = 1, 2, 4 ranks, 3 steps of error feedback: the int8
  codes and the error state bit for bit, the mean bit for bit (the same
  float32 operations in the same order on each element).
* manual-DP step, 2 ranks at qwen3-1.7b's smoke config in float32: the
  losses of 3 free steps 1e-5 relative.  Each step again from the JAX
  package's state before it: the loss 1e-5 relative; the error state
  1e-5 absolute (the residual is the gradient less its code, and the
  gradients agree to 1e-5 in tests/test_torch_train_model.py), or one
  whole code away, on at most 0.5 % of the elements, where the two
  frameworks' gradients round to neighbouring int8 codes; where no code
  differs, parameters 1e-4 absolute and moments 1e-6 absolute plus 1e-4
  relative (the trainer limits of that file), elsewhere parameters within
  one step of the learning rate.
* restore: each rank's local shard equal to the slice of the full array.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.parallel import compression as jcomp  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.parallel import compression as comp  # noqa: E402
from repro_torch.parallel import sharding as shlib  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 180          # seconds, per spawned test
MESHES = {  # name: axis sizes, in mesh-dim order
    "data16-model16": {"data": 16, "model": 16},
    "pod2-data16-model16": {"pod": 2, "data": 16, "model": 16},
    "data8-model1": {"data": 8, "model": 1},
}
DATA_BATCH_CASES = [(256, 2, 0), (1, 2, 0), (128, 3, 1), (48, 3, 1),
                    (32, 4, 0)]
# leaves of the compressed-mean test: shape and scale of the draws (one
# leaf of tiny values beside large ones, one of zeros)
COMP_LEAVES = {"w": ((64,), 1.0), "b": ((3, 5), 0.1), "big": ((4096,), 3.0),
               "tiny": ((7,), 1e-6), "zero": ((4,), 0.0)}
COMP_STEPS = 3
MDP_ARCH = "qwen3-1.7b"
MDP_STEPS = 3


def _env(devices=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


def _run(code, devices, *args, timeout=600):
    r = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                       env=_env(devices), capture_output=True, text=True,
                       timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


# ------------------------------------------------------------ sharding
JAX_SHARDING = r"""
import json, sys
import jax, numpy as np
from repro import configs
from repro.configs import shapes as shp
from repro.models.model import build_model
from repro.parallel import sharding as shlib

MESHES, CASES = json.loads(sys.argv[2]), json.loads(sys.argv[3])


def js(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def dump(tree, shardings):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    outs = [jax.tree.leaves(s) for s in shardings]
    return {jax.tree_util.keystr(p): [list(leaf.shape)]
            + [js(o[i].spec) for o in outs]
            for i, (p, leaf) in enumerate(flat)}


out = {}
for arch in configs.ARCHS:
    cfg = configs.get_config(arch)
    model = build_model(cfg)
    params = model.init_eval()
    cache = jax.eval_shape(lambda: model.init_cache(128, 1024))
    cache1 = jax.eval_shape(lambda: model.init_cache(1, 1024))
    batch = shp.train_batch_specs(cfg, 4096, 256)
    for name, sizes in MESHES.items():
        n = int(np.prod(list(sizes.values())))
        mesh = jax.make_mesh(tuple(sizes.values()), tuple(sizes),
                             devices=jax.devices()[:n])
        out[f"{arch}|{name}"] = {
            "params": dump(params, [
                shlib.param_shardings(params, cfg, mesh, fsdp=False),
                shlib.param_shardings(params, cfg, mesh, fsdp=True),
                shlib.param_shardings_puredp(params, cfg, mesh)]),
            "batch": dump(batch, [shlib.batch_shardings(batch, mesh),
                                  shlib.batch_shardings_puredp(batch, mesh)]),
            "cache": dump(cache, [shlib.cache_shardings(cache, cfg, mesh)]),
            "cache_long": dump(cache1, [shlib.cache_shardings(
                cache1, cfg, mesh, long_context=True)]),
            "data_batch_spec": [js(shlib.data_batch_spec(mesh, *c))
                                for c in CASES],
            "batch_axes": list(shlib.batch_axes(mesh)),
            "replicated": js(shlib.replicated(mesh).spec)}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_sharding(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharding") / "jax.json"
    _run(JAX_SHARDING, 512, path, json.dumps(MESHES),
         json.dumps(DATA_BATCH_CASES))
    return json.loads(path.read_text())


def _tree_of(dumped):
    """The JAX tree's structure with zero-size stand-in leaves of each
    leaf's shape."""
    return T.nest_by_name({name: np.broadcast_to(np.int8(0), tuple(v[0]))
                           for name, v in dumped.items()})


def _port_specs(tree, *spec_trees):
    """{leaf name: [shape, spec of each tree]} as the JAX dump has it."""
    cols = [T.leaves_like(s, tree) for s in spec_trees]
    return {n: [list(leaf.shape)] + [_spec_json(c[i]) for c in cols]
            for i, (n, leaf) in enumerate(T.flatten_with_names(tree))}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_sharding_rules_equal_jax(jax_sharding, arch, mesh):
    """param_shardings (fsdp off and on), param_shardings_puredp,
    batch_shardings(_puredp) of a train_4k batch, cache_shardings of a
    decode cache at batch 128 and a long-context one at batch 1,
    data_batch_spec, batch_axes and replicated: the JAX package's specs,
    leaf by leaf, on the same trees."""
    want = jax_sharding[f"{arch}|{mesh}"]
    cfg = tconfigs.get_config(arch)
    sizes = MESHES[mesh]
    params = _tree_of(want["params"])
    got = _port_specs(params,
                      shlib.param_shardings(params, cfg, sizes, fsdp=False),
                      shlib.param_shardings(params, cfg, sizes, fsdp=True),
                      shlib.param_shardings_puredp(params, cfg, sizes))
    assert got == want["params"]
    batch = _tree_of(want["batch"])
    assert _port_specs(batch, shlib.batch_shardings(batch, sizes),
                       shlib.batch_shardings_puredp(batch, sizes)) \
        == want["batch"]
    for key, long in (("cache", False), ("cache_long", True)):
        cache = _tree_of(want[key])
        assert _port_specs(cache, shlib.cache_shardings(
            cache, cfg, sizes, long_context=long)) == want[key], key
    assert [_spec_json(shlib.data_batch_spec(sizes, *c))
            for c in DATA_BATCH_CASES] == want["data_batch_spec"]
    assert list(shlib.batch_axes(sizes)) == want["batch_axes"]
    assert _spec_json(shlib.replicated(sizes)) == want["replicated"]
    # the rules read every kind of leaf the archs have
    assert any(s != [None] * len(v[0]) for v in got.values() for s in v[1:])


def test_param_spec_on_the_port_layout_drops_the_stacking_dim():
    """On the port's tree (one block per layer) a leaf's spec is the JAX
    tree's spec of its stacked leaf less the leading ``periods`` dim."""
    from repro_torch.models.model import build_model
    cfg = tconfigs.get_config("gemma3-1b")
    sizes = MESHES["data16-model16"]
    port = build_model(cfg).init_eval().tree()
    got = dict(zip((n for n, _ in T.flatten_with_names(port)),
                   T.leaves_like(shlib.param_shardings(port, cfg, sizes,
                                                       fsdp=True), port)))
    attn = got["['blocks'][5]['attn']['wq']"]
    stacked = shlib.param_spec("scan_blocks/5/attn/wq",
                               (4,) + tuple(port["blocks"][5]["attn"]["wq"]
                                            .shape), cfg, sizes, fsdp=True)
    assert stacked == (None,) + attn == (None, "data", None)
    assert got["['embed']['tok']"] == ("model", "data")


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    sizes = {"pod": 2, "data": 4, "model": 2}
    assert shlib.placements((("pod", "data"), None, "model"), sizes) == [
        Shard(0), Shard(0), Shard(2)]
    assert shlib.placements((), sizes) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        shlib.placements((("data", "pod"),), sizes)


# ------------------------------------------------- spawned gloo ranks
def _spawn(task, n, outdir, *args):
    """Run ``_worker(task)`` on ``n`` gloo ranks; each writes
    ``outdir/rank<r>.pt``.  Returns the ranks' results.  The ranks meet at
    a file store in ``outdir`` (a fresh name each call), so that tests
    spawning at once in other processes never share a rendezvous, as two
    picks of a free TCP port could."""
    import uuid
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = Path(outdir).resolve() / f"store-{uuid.uuid4().hex}"
    procs = [ctx.Process(target=_worker, args=(task, r, n, str(store),
                                               str(outdir), *args))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(SPAWN_TIMEOUT)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"{task}: ranks {hung} still running after " \
                     f"{SPAWN_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * n, \
        f"{task}: exit codes {[p.exitcode for p in procs]}"
    return [torch.load(Path(outdir) / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


def _worker(task, rank, n, store, outdir, *args):
    """``task``: a name of this file's, or a module-level function of
    another test file's, called as ``task(rank, n, *args)``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        fn = task if callable(task) else {
            "compress": _compress_rank, "manual_dp": _manual_dp_rank,
            "restore": _restore_rank}[task]
        out = fn(rank, n, *args)
        torch.save(out, Path(outdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------- compressed mean
def _comp_grads(n, t):
    """Step ``t``'s gradients, (n, *shape) float32 a leaf: rank r's row r."""
    rng = np.random.default_rng(1000 + 10 * n + t)
    return {k: (rng.normal(size=(n,) + s) * scale).astype(np.float32)
            for k, (s, scale) in COMP_LEAVES.items()}


JAX_COMPRESS = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.parallel import compression as comp

leaves, steps = json.loads(sys.argv[2]), int(sys.argv[3])
out = {}
for n in (1, 2, 4):
    mesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])
    # called as tests/test_train.py calls it, not under jit (which fuses
    # the float32 steps into other roundings)
    fn = comp.make_compressed_allreduce(mesh, {k: P("data") for k in leaves})
    err = {k: np.zeros([n] + s, np.float32) for k, (s, _) in leaves.items()}
    for t in range(steps):
        rng = np.random.default_rng(1000 + 10 * n + t)
        g = {k: (rng.normal(size=[n] + s) * scale).astype(np.float32)
             for k, (s, scale) in leaves.items()}
        mean, new = fn({k: jnp.asarray(v) for k, v in g.items()},
                       {k: jnp.asarray(v) for k, v in err.items()})
        for k in leaves:
            out[f"{n}/{t}/{k}/mean"] = np.asarray(mean[k])
            out[f"{n}/{t}/{k}/err"] = np.asarray(new[k])
        err = {k: np.asarray(v) for k, v in new.items()}
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_compress(tmp_path_factory):
    path = tmp_path_factory.mktemp("compress") / "jax.npz"
    _run(JAX_COMPRESS, 4, path, json.dumps(
        {k: [list(s), sc] for k, (s, sc) in COMP_LEAVES.items()}),
        COMP_STEPS)
    with np.load(path) as z:
        return dict(z)


def _compress_rank(rank, n):
    """Rank ``rank`` of ``n``: COMP_STEPS steps of ``compressed_pmean`` on
    its rows, with the codes read back (``quantize`` at the world's
    shared max)."""
    import torch.distributed as dist
    world = [dist.group.WORLD]
    err = {k: torch.zeros(s) for k, (s, _) in COMP_LEAVES.items()}
    out = {}
    for t in range(COMP_STEPS):
        g = {k: torch.from_numpy(v[rank]) for k, v in _comp_grads(n, t)
             .items()}
        mean, new = comp.compressed_pmean(g, err, world)
        for k in COMP_LEAVES:
            g32 = g[k] + err[k]
            gmax = g32.abs().max()
            dist.all_reduce(gmax, op=dist.ReduceOp.MAX)
            out[f"{t}/{k}/codes"] = comp.quantize(g32, gmax, n)[0]
            out[f"{t}/{k}/mean"] = mean[k]
            out[f"{t}/{k}/err"] = new[k]
            out[f"{t}/{k}/g32"] = g32
        err = new
    return out


def _jax_codes(g32, new_err, n):
    """The codes the JAX package sent, read back from its error state:
    q = (g32 - err') / scale, which lies within 1e-3 of an integer."""
    gmax = np.float32(max(np.abs(g32).max(), np.float32(1e-12)))
    scale = gmax / np.float32(127.0 / n)
    q = (g32.astype(np.float64) - new_err) / scale
    r = np.round(q)
    assert np.abs(q - r).max() < 1e-3
    return r.astype(np.int8)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_compressed_pmean_vs_jax_on_gloo_ranks(jax_compress, tmp_path, n):
    """n gloo ranks against the JAX ``make_compressed_allreduce`` on n fake
    devices, over 3 steps of error feedback: int8 codes, error state and
    mean bit for bit; every rank gets the same mean."""
    ranks = _spawn("compress", n, tmp_path)
    for t in range(COMP_STEPS):
        for k in COMP_LEAVES:
            g32 = np.stack([r[f"{t}/{k}/g32"].numpy() for r in ranks])
            jerr = jax_compress[f"{n}/{t}/{k}/err"]
            jmean = jax_compress[f"{n}/{t}/{k}/mean"]
            want_codes = _jax_codes(g32, jerr, n)
            for rank, r in enumerate(ranks):
                assert r[f"{t}/{k}/codes"].dtype == torch.int8
                np.testing.assert_array_equal(r[f"{t}/{k}/codes"].numpy(),
                                              want_codes[rank])
                np.testing.assert_array_equal(r[f"{t}/{k}/err"].numpy(),
                                              jerr[rank])
                np.testing.assert_array_equal(r[f"{t}/{k}/mean"].numpy(),
                                              jmean[rank])
            # the sum of n payloads stays within int8
            assert np.abs(want_codes.astype(np.int32).sum(0)).max() <= 127


def test_compress_psum_leaf_without_a_group_vs_jax():
    """No group (the JAX ``axis_names=()``): n = 1, no collective; the
    mean and error bit for bit over 3 steps of error feedback."""
    rng = np.random.default_rng(3)
    jerr, terr = jnp.zeros((50,), jnp.float32), torch.zeros(50)
    for _ in range(3):
        g = (rng.normal(size=50) * 0.3).astype(np.float32)
        jm, jerr = jcomp.compress_psum_leaf(jnp.asarray(g), jerr, ())
        tm, terr = comp.compress_psum_leaf(torch.from_numpy(g), terr)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))


def test_compressed_allreduce_close_to_exact():
    """tests/test_train.py's property on the port, one rank: the mean is
    the value up to int8 quantization, and the error holds the residual;
    the state starts at ``init_state``'s zeros."""
    rng = np.random.default_rng(0)
    grads = {"w": torch.tensor(rng.normal(size=(64,)).astype(np.float32))}
    state = comp.init_state(grads)
    assert torch.equal(state.error["w"], torch.zeros(64))
    out, new_err = comp.compressed_pmean(grads, state.error)
    scale = float(grads["w"].abs().max()) / 127
    np.testing.assert_allclose(out["w"].numpy(), grads["w"].numpy(),
                               atol=scale)
    resid = grads["w"].numpy() - out["w"].numpy()
    np.testing.assert_allclose(new_err["w"].numpy(), resid, atol=1e-6)


def test_compression_error_feedback_unbiased_over_time():
    """tests/test_train.py's property on the port: with error feedback,
    tiny gradients beside a large one average out to their values."""
    g = torch.tensor([1e-4, -3e-5, 2e-4, 0.5])
    err = torch.zeros_like(g)
    total = np.zeros(4)
    for _ in range(200):
        out, err = comp.compress_psum_leaf(g, err)
        total += out.numpy()
    np.testing.assert_allclose(total / 200, g.numpy(), rtol=0.05,
                               atol=2.5e-5)


# ------------------------------------------------------ manual_dp.build
JAX_MANUAL_DP = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.models.model import build_model
from repro.train import manual_dp, optimizer as opt

arch, steps = sys.argv[2], int(sys.argv[3])
shape = tuple(int(x) for x in sys.argv[4].split(","))
cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
model = build_model(cfg)
# Auto axes: the step is manual over "data" only, and the model axis is
# left to XLA, as the JAX package's build was written for
mesh = jax.make_mesh(shape, ("data", "model"),
                     devices=jax.devices()[:shape[0] * shape[1]],
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
toks = np.random.default_rng(7).integers(0, cfg.vocab, (4, 17)).astype(
    np.int32)
batch = {"tokens": jnp.asarray(toks[:, :-1]),
         "targets": jnp.asarray(toks[:, 1:])}
ocfg = opt.OptConfig(lr=5e-3, warmup_steps=1, total_steps=20)
fn, _ = manual_dp.build(model, mesh, ocfg, batch)
params = model.init(jax.random.key(0))
ost = opt.init(params)
err = jax.tree.map(lambda p: jnp.zeros((shape[0],) + p.shape, jnp.float32),
                   params)
out = {"tokens": toks}


def save(t, params, ost, err):
    for tag, tree in (("params", params), ("mu", ost.mu), ("nu", ost.nu),
                      ("err", err)):
        for name, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[f"{t}/{tag}" + jax.tree_util.keystr(name)] = np.asarray(leaf)
    out[f"{t}/step"] = np.asarray(ost.step)


save(0, params, ost, err)
losses = []
for t in range(1, steps + 1):
    params, ost, err, loss = fn(params, ost, err, batch)
    losses.append(float(loss))
    save(t, params, ost, err)
out["losses"] = np.array(losses)
np.savez(sys.argv[1], **out)
"""


def _by_prefix(arrays, prefix):
    return T.nest_by_name({k[len(prefix):]: v for k, v in arrays.items()
                           if k.startswith(prefix + "[")})


def _manual_dp_rank(rank, n, jax_path, shape=(2, 1)):
    """Rank ``rank`` of a (data, model) = ``shape`` mesh: MDP_STEPS steps
    of ``manual_dp.build``'s step from the JAX package's initial state,
    and each step again from the JAX package's state before it, with the
    scale of each leaf that the compressed mean used.  On a model axis
    above 1 the error state is placed as ``build`` says, and the state
    comes back whole (each rank's error row whole)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.models.model import build_model
    from repro_torch.train import manual_dp
    from repro_torch.train import optimizer as opt
    with np.load(jax_path) as z:
        arrays = dict(z)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(MDP_ARCH),
                              dtype="float32")
    model = build_model(cfg)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    data_row = mesh.get_coordinate()[0]
    toks = torch.from_numpy(arrays["tokens"])
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    step, (pplace, oplace, eplace, bplace) = manual_dp.build(
        model, mesh, opt.OptConfig(lr=5e-3, warmup_steps=1, total_steps=20),
        batch)
    scales = []
    plain_quantize = comp.quantize

    def recording(g32, gmax, n):
        q, s = plain_quantize(g32, gmax, n)
        scales.append(float(s))
        return q, s
    comp.quantize = recording

    def state(t):
        """The JAX package's state after step t, in the port's layout;
        the error state as this rank's rows."""
        params = convert.params_from_numpy(
            cfg, _by_prefix(arrays, f"{t}/params"), device="cpu")
        ost = convert.opt_state_from_numpy(cfg, {
            "mu": _by_prefix(arrays, f"{t}/mu"),
            "nu": _by_prefix(arrays, f"{t}/nu"),
            "step": arrays[f"{t}/step"]}, device="cpu")
        if shape[1] > 1:
            jerr = _by_prefix(arrays, f"{t}/err")
            rows = [dict(T.flatten_with_names(convert.port_layout(
                cfg, T.map_tree(lambda e: e[r], jerr))))
                for r in range(shape[0])]
            return params, ost, T.map_with_names(
                lambda n, _: distribute_tensor(torch.from_numpy(np.stack(
                    [row[n] for row in rows])), mesh, eplaces[n]),
                model.init_eval().tree())
        rows = T.map_tree(lambda e: e[rank], _by_prefix(arrays, f"{t}/err"))
        err = T.map_tree(lambda e: torch.from_numpy(e[None].copy()),
                         convert.port_layout(cfg, rows))
        return params, ost, err

    def whole(v):
        return v.full_tensor() if isinstance(v, DTensor) else v

    def named(params, ost, err):
        return {"params": {k: whole(v).detach() for k, v in
                           T.flatten_with_names(params.tree())},
                "mu": {k: whole(v) for k, v in T.flatten_with_names(ost.mu)},
                "nu": {k: whole(v) for k, v in T.flatten_with_names(ost.nu)},
                "err": {k: (v.full_tensor()[data_row] if shape[1] > 1 else
                            (v.to_local() if isinstance(v, DTensor)
                             else v)[0])
                        for k, v in T.flatten_with_names(err)}}

    out = {"forced": [], "data_row": data_row}
    eplaces = dict(zip((n for n, _ in T.flatten_with_names(
        model.init_eval().tree())),
        T.leaves_like(eplace, model.init_eval().tree())))
    params, ost, err = state(0)
    # the free run holds the error state as DTensors placed as build says
    if shape[1] == 1:
        err = T.map_with_names(
            lambda n, e: DTensor.from_local(e, mesh, eplaces[n]), err)
    free = []
    for _ in range(MDP_STEPS):
        params, ost, err, loss = step(params, ost, err, batch)
        free.append(float(loss))
    out["free_losses"] = free
    out["free"] = named(params, ost, err)
    for t in range(1, MDP_STEPS + 1):
        del scales[:]
        params, ost, err, loss = step(*state(t - 1), batch)
        out["forced"].append(dict(named(params, ost, err), loss=float(loss),
                                  scales=list(scales)))
    out["placements"] = {
        "embed": T.leaves_like(pplace, params.tree())[0],
        "err": T.leaves_like(eplace, params.tree())[0],
        "tokens": bplace["tokens"]}
    return out


def _port_named(tc, jax_tree):
    """{leaf name: array} of a JAX parameter-shaped tree in the port's
    layout."""
    return dict(T.flatten_with_names(convert.port_layout(tc, jax_tree)))


def test_manual_dp_build_vs_jax_on_two_gloo_ranks(tmp_path):
    """``manual_dp.build``'s step on 2 gloo ranks against the JAX
    ``build`` on a 2-device mesh at qwen3-1.7b's smoke config.

    Three steps run freely, the error state held as DTensors placed as
    ``build`` says: the losses within 1e-5, and the replicated parameters
    and moments equal on both ranks.  Then each of the three
    steps again from the JAX package's state before it (so that a step's
    differences do not carry into the next): the loss within 1e-5; each
    rank's error state within 1e-5 of the JAX package's (the gradients'
    absolute limit: the residual is the gradient less its code), or one
    whole code (the leaf's scale) away where the two frameworks'
    gradients, equal but for float32 sums in other orders, round to
    neighbouring int8 codes, on at most 0.5 % of the elements; where no
    rank's code
    differs, the parameters within 1e-4 and the moments within 1e-6 plus
    1e-4 relative, and elsewhere the parameters within one step of the
    learning rate (5e-3)."""
    jax_path = tmp_path / "jax.npz"
    _run(JAX_MANUAL_DP, 4, jax_path, MDP_ARCH, MDP_STEPS, "2,1")
    with np.load(jax_path) as z:
        arrays = dict(z)
    check_manual_dp(_spawn("manual_dp", 2, tmp_path, str(jax_path)), arrays)


def check_manual_dp(ranks, arrays):
    """The checks of ``test_manual_dp_build_vs_jax_on_two_gloo_ranks`` on
    the ranks' results of ``_manual_dp_rank`` against the JAX ``build``'s
    ``arrays``; each rank's error row is its data row's."""
    from torch.distributed.tensor import Replicate, Shard
    tc = dataclasses.replace(tconfigs.get_smoke_config(MDP_ARCH),
                             dtype="float32")
    for r in ranks:
        np.testing.assert_allclose(r["free_losses"], arrays["losses"],
                                   rtol=1e-5)
    assert arrays["losses"][-1] < arrays["losses"][0]
    for key in ("params", "mu", "nu"):
        for name, v in ranks[0]["free"][key].items():
            for r in ranks[1:]:
                assert torch.equal(v, r["free"][key][name]), (key, name)
    flips = total = 0
    for t in range(1, MDP_STEPS + 1):
        forced = [r["forced"][t - 1] for r in ranks]
        for f in forced:
            assert f["loss"] == pytest.approx(arrays["losses"][t - 1],
                                              rel=1e-5)
        want = {key: _port_named(tc, _by_prefix(arrays, f"{t}/{key}"))
                for key in ("params", "mu", "nu")}
        jerr = _by_prefix(arrays, f"{t}/err")     # leaves (n, *shape)
        names = list(forced[0]["params"])
        assert sorted(names) == sorted(want["params"])
        moved = {}
        for r, f in zip(ranks, forced):
            werr = _port_named(tc, T.map_tree(lambda e: e[r["data_row"]],
                                              jerr))
            for name, s in zip(names, f["scales"]):
                d = werr[name] - f["err"][name].numpy()
                k = np.round(d / s)
                assert np.abs(k).max() <= 1, (t, name)
                np.testing.assert_allclose(d, k * s, atol=1e-5, rtol=0,
                                           err_msg=f"err {t} {name}")
                moved[name] = moved.get(name, 0) + (k != 0)
                flips += int((k != 0).sum())
                total += k.size
        for name in names:
            same = ~moved[name].astype(bool)
            got = forced[0]["params"][name].numpy()
            np.testing.assert_allclose(got[same], want["params"][name][same],
                                       atol=1e-4, rtol=0,
                                       err_msg=f"params {t} {name}")
            assert np.abs(got - want["params"][name]).max() <= 5e-3
            for key in ("mu", "nu"):
                np.testing.assert_allclose(
                    forced[0][key][name].numpy()[same], want[key][name][same],
                    atol=1e-6, rtol=1e-4, err_msg=f"{key} {t} {name}")
    assert flips <= 0.005 * total, (flips, total)
    p = ranks[0]["placements"]
    assert p["tokens"] == [Shard(0), Replicate()]
    assert p["embed"][0] == Replicate()
    assert p["err"][0] == Shard(0)


# ------------------------------------------------------------ restore
RESTORE_SIZES = {"pod": 2, "data": 2, "model": 1}
RESTORE_SPECS = {"err": (("pod", "data"), None), "w": (None, "data"),
                 "b": ("pod",), "r": ()}


def _restore_tree():
    rng = np.random.default_rng(5)
    return {"err": torch.tensor(rng.normal(size=(8, 3)).astype(np.float32)),
            "w": torch.tensor(rng.normal(size=(3, 6))).to(torch.bfloat16),
            "b": torch.arange(6, dtype=torch.int32),
            "r": torch.tensor(rng.normal(size=(5,)).astype(np.float32))}


def _restore_rank(rank, n, ckpt_dir):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.train import checkpoint as ckpt
    mesh = init_device_mesh("cpu", tuple(RESTORE_SIZES.values()),
                            mesh_dim_names=tuple(RESTORE_SIZES))
    template = _restore_tree()
    places = {k: shlib.placements(s, mesh) for k, s in RESTORE_SPECS.items()}
    tree, step = ckpt.restore(ckpt_dir, template, shardings=(mesh, places))
    return {"step": step, "coord": mesh.get_coordinate(),
            "local": {k: v.to_local() for k, v in tree.items()},
            "placements": {k: list(v.placements) for k, v in tree.items()}}


def test_restore_with_shardings_on_four_gloo_ranks(tmp_path):
    """A checkpoint restored onto a (pod 2, data 2, model 1) mesh: each
    rank's local shard is the slice of the full leaf that the JAX spec
    gives its device (a dim over (pod, data): pod major)."""
    from repro_torch.train import checkpoint as ckpt
    full = _restore_tree()
    ckpt.save(str(tmp_path), 7, full)
    ranks = _spawn("restore", 4, tmp_path, str(tmp_path))
    for r in ranks:
        assert r["step"] == 7
        p, d, _ = r["coord"]
        want = {"err": full["err"][(2 * p + d) * 2:(2 * p + d + 1) * 2],
                "w": full["w"][:, d * 3:(d + 1) * 3],
                "b": full["b"][p * 3:(p + 1) * 3], "r": full["r"]}
        for k, w in want.items():
            assert r["local"][k].dtype == w.dtype
            assert torch.equal(r["local"][k], w), (k, r["coord"])
