"""Explicit data-parallel training: the int8 error-feedback gradient mean
(``build``) and the gradient mean over the simulated FPsPIN fabric
(:class:`FabricGradSync`); PyTorch port of ``repro.train.manual_dp``.

``build`` is the JAX package's ``shard_map`` train step, with the data
axes of a ``DeviceMesh`` as process groups: every rank runs the same
step on its shard of the batch, and the gradient mean runs through the
int8 error-feedback collective of ``repro_torch.parallel.compression``
(1 B an element on the wire).  Parameters and optimizer state are
replicated over the data axes (the compressed mean gives every rank the
same update bit for bit); the error-feedback residuals are per shard, a
(n_shards, *shape) float32 state of which a rank holds its row.  With a
model axis above 1 the parameters and moments are ``DTensor``s split over
``model`` by the sharding rules (replicated over the data axes) and the
loss runs with tensor and expert parallelism inside it, as the Trainer's
mesh branch runs it; the data axes stay manual, as in the JAX package's
partial-manual ``shard_map``: a rank's batch rows enter as a DTensor
replicated over them, so no collective of the loss crosses a data axis,
and the gradient mean over them is the compressed one.

:class:`FabricGradSync` routes a gradient mean through the port's
nonblocking MPI layer (``repro_torch.mpi``): post the reduction, keep
ticking the fabric from inside the backprop window (the progress hook),
and the multi-MiB gradient vector rides the segmented Rabenseifner fast
path with NIC-side unpack.  That is what the ``grad_allreduce`` benchmark
measures: the overlap ratio of a gradient-sized reduction hidden behind
compute.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.train import tree as T


def _f32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(torch.float32).cpu().numpy()
    return np.asarray(leaf, np.float32)


def _like(leaf):
    """float32 numpy -> the leaf's kind: a tensor of its dtype on its
    device, or a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        dt, dev = leaf.dtype, leaf.device
        return lambda a: torch.from_numpy(a).to(device=dev, dtype=dt)
    dt = np.asarray(leaf).dtype
    return lambda a: a.astype(dt)


class FabricGradSync:
    """Data-parallel gradient mean over the simulated FPsPIN fabric.

    One instance serves a whole job: every shard's gradient tree (tensors
    or numpy arrays, ``repro_torch.train.tree``) is flattened into one
    contiguous float32 vector (layout captured once, on the first post),
    the vectors allreduce through ``repro_torch.mpi`` — at gradient sizes
    the auto-selector picks segmented Rabenseifner over the
    credit-managed rendezvous path — and the mean is unflattened back into
    per-shard trees of the leaves' kind and dtype (a tensor on its
    device, or a numpy array).

    The point is *overlap*: :meth:`post` returns immediately with the
    collective in flight, :meth:`progress` is the hook the training loop
    calls from inside backprop (each call ticks the fabric forward while
    host compute runs), and :meth:`wait` drains the tail.  ``last_stats``
    reports how much of the transfer the compute window hid.
    """

    def __init__(self, comm, algorithm: str = "auto"):
        self.comm = comm
        self.algorithm = algorithm
        self.handle = None
        self._template = None
        self._layout = None
        self._posted_at = 0
        self._compute_ticks = 0
        self.last_stats: dict = {}

    def _flatten(self, grads) -> np.ndarray:
        named = T.flatten_with_names(grads)
        if self._template is None:
            self._template = grads
            self._layout = [(n, tuple(leaf.shape), _like(leaf))
                            for n, leaf in named]
        if [n for n, _ in named] != [n for n, _, _ in self._layout]:
            raise ValueError("FabricGradSync: gradient tree changed shape")
        return np.concatenate(
            [_f32(leaf).reshape(-1) for _, leaf in named]) \
            if named else np.zeros(0, np.float32)

    def _unflatten(self, vec: np.ndarray) -> Any:
        leaves, off = {}, 0
        for name, shape, like in self._layout:
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            leaves[name] = like(vec[off:off + size].reshape(shape))
            off += size
        return T.map_with_names(lambda n, _: leaves[n], self._template)

    def post(self, shard_grads) -> None:
        """Post the nonblocking mean of one gradient tree per shard."""
        from repro_torch import mpi
        if not (self.handle is None or self.handle.done):
            raise RuntimeError("FabricGradSync: the previous gradient sync "
                               "is still in flight")
        vecs = [self._flatten(g) for g in shard_grads]
        self.grad_bytes = int(vecs[0].nbytes)
        self.handle = mpi.iallreduce(self.comm, vecs,
                                     algorithm=self.algorithm)
        self._posted_at = self.comm.now
        self._compute_ticks = 0

    def progress(self, ticks: int = 1) -> bool:
        """The backprop progress hook: advance the fabric ``ticks`` while
        the caller's compute runs.  Returns True once the sync is done."""
        self._compute_ticks += ticks
        self.comm.progress(ticks)
        return self.handle.test()

    def wait(self, max_ticks: int = 2_000_000):
        """Drain the reduction; returns the per-shard *mean* trees and
        records overlap instrumentation in ``last_stats``."""
        t0 = self.comm.now
        self.comm.wait(self.handle, max_ticks=max_ticks)
        t_poll = self.comm.now - t0
        n = self.comm.n_ranks
        total = self.comm.now - self._posted_at
        self.last_stats = dict(
            algorithm=self.handle.algorithm,
            rounds=self.handle.rounds,
            msgs_total=self.handle.msgs_total,
            bytes_wire=self.handle.bytes_wire,
            grad_bytes=self.grad_bytes,
            compute_ticks=self._compute_ticks,
            poll_ticks=t_poll,
            total_ticks=total,
            overlap_ratio=(self._compute_ticks
                           / max(1, self._compute_ticks + t_poll)),
        )
        return [self._unflatten(v / n) for v in self.handle.result]


def error_state_init(params_shapes, n_shards: int, device="meta"):
    """Per-shard error-feedback residuals: a float32 zero tensor of
    (n_shards, *leaf.shape) for every leaf of ``params_shapes``, on
    ``device`` ("meta": shapes only, as the JAX package's abstract
    arrays).  A rank passes ``build``'s step its row: a (1, *shape) local
    tensor, or a DTensor placed as ``build`` says."""
    return T.map_tree(lambda p: torch.zeros(
        (n_shards,) + tuple(p.shape), dtype=torch.float32, device=device),
        params_shapes)


def build(model, mesh, ocfg, batch_example):
    """The manual data-parallel train step on ``mesh`` (a ``DeviceMesh``
    with dims named from ``pod``, ``data``, ``model``).  Returns (step,
    placements).

    ``step(params, opt_state, err, batch) -> (params, opt_state, err,
    loss)``, called by every rank with the same ``params`` and
    ``opt_state`` (replicated), its own rows of the error state ``err``
    (leaves (1, *shape) float32, or DTensors of (n_shards, *shape)
    sharded over the data axes) and the global ``batch``.  Each rank takes
    its shard of the batch (rows over pod x data, pod major; ``positions``
    (3, B, S) on dim 1), its loss and gradients, the compressed mean of
    the gradients over the data groups and the mean of the loss, and runs
    AdamW; the parameters, moments and error rows are updated in place.
    ``loss`` is the mean loss over the shards.  With a model axis above 1
    the parameters and moments are placed on ``mesh`` on entry as
    ``placements`` says (plain leaves are distributed, and the
    parameters swapped into the ``Params`` module), the error rows are
    this rank's shards ((1, *local shape), or DTensors placed so), and
    each leaf's int8 scale is the maximum over the whole leaf.

    ``placements``: DTensor placements on ``mesh``, as trees of lists,
    of the parameters (``param_shardings`` with ``fsdp`` off), the
    optimizer state (moments as their parameters, the step replicated),
    the error state (its first dim over the data axes, then its
    parameter's) and the batch (``batch_shardings``) — the JAX step's
    ``in_shardings``."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models import convert
    from repro_torch.parallel import compression as comp
    from repro_torch.parallel import dtensor as D
    from repro_torch.parallel import sharding as shlib
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import place_state

    sizes = shlib.axis_sizes(mesh)
    tp = sizes.get("model", 1)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    if not data_axes:
        raise ValueError("manual_dp.build: the mesh has no data axis")
    groups = comp.data_groups(mesh)
    n_shards = 1
    for a in data_axes:
        n_shards *= sizes[a]
    coord = dict(zip(sizes, mesh.get_coordinate()))
    shard = 0
    for a in data_axes:
        shard = shard * sizes[a] + coord[a]

    # one scale per tensor of the JAX package's tree: the layers of a
    # period-scan position share one
    ptree = model.init_eval().tree()
    scale_of = convert.jax_leaf_names(
        model.cfg, [n for n, _ in T.flatten_with_names(ptree)])
    rep = [Replicate() for _ in sizes]

    def local_batch(batch):
        out = {}
        for k, v in batch.items():
            dim = 1 if (v.dim() == 3 and k == "positions") else 0
            b = v.shape[dim]
            if b % n_shards:
                raise ValueError(f"manual_dp: batch {k} of {b} rows does "
                                 f"not split over {n_shards} data shards")
            n = b // n_shards
            out[k] = v.narrow(dim, shard * n, n)
            if tp > 1:     # manual over the data axes: replicated there
                out[k] = DTensor.from_local(out[k], mesh, rep,
                                            run_check=False)
        return out

    def step(params, opt_state, err, batch):
        if tp > 1:
            opt_state = place_state(params, opt_state, mesh, pplace)
        tree = params.tree()
        leaves = T.leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss_fn(params, local_batch(batch))
        grads = torch.autograd.grad(loss, leaves)
        if tp > 1:
            loss = D.settle(loss).to_local()
            grads = [g.redistribute(placements=p.placements)
                     for p, g in zip(leaves, grads)]
        rows = [(e.to_local() if isinstance(e, DTensor) else e)
                for e in T.leaves(err)]
        if any(r.shape[0] != 1 for r in rows):
            raise ValueError("manual_dp: err must hold this rank's row "
                             "(1, *shape) of each leaf")
        means, new_err = comp.compressed_pmean(
            list(grads), [r[0] for r in rows], groups, scale_of=scale_of)
        del grads
        with torch.no_grad():
            for r, e in zip(rows, new_err):
                r[0].copy_(e)
            loss = loss.detach().clone()
            for g in groups:
                dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=g)
            loss = loss / torch.full((), float(n_shards),
                                     dtype=torch.float32, device=loss.device)
        _, opt_state, _ = opt.apply_updates(tree, opt_state, means, ocfg)
        return params, opt_state, err, loss

    dentry = data_axes if len(data_axes) > 1 else data_axes[0]

    def pspec(path, leaf):
        return shlib.param_spec(path, leaf.shape, model.cfg, sizes)
    pplace = shlib.map_with_path(
        lambda path, leaf: shlib.placements(pspec(path, leaf), mesh), ptree)
    oplace = opt.OptState(mu=pplace, nu=pplace, step=rep)
    eplace = shlib.map_with_path(lambda path, leaf: shlib.placements(
        (dentry,) + pspec(path, leaf), mesh), ptree)
    bplace = {k: shlib.placements(spec, mesh) for k, spec in
              shlib.batch_shardings(batch_example, sizes).items()}
    return step, (pplace, oplace, eplace, bplace)
