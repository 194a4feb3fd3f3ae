"""Trainer: train step (loss -> grads -> clip -> AdamW), microbatch
accumulation, checkpoint/restart, straggler watchdog; PyTorch port of
``repro.train.trainer``.

The step runs eagerly (PyTorch has no ``jit``):

  * gradients come from ``torch.autograd.grad`` of ``model.loss_fn``, in
    the parameters' dtype, as ``jax.value_and_grad`` gives them;
  * microbatches > 1 — a loop in place of the JAX ``lax.scan``: each
    microbatch takes consecutive batch rows (of ``positions``, dim 1, as
    the JAX trainer splits M-RoPE positions), its gradients are added into
    float32 buffers, which are then divided by the count (the loss too);
    the metrics are the last microbatch's;
  * ``opt.apply_updates`` writes the new parameters and moments into the
    tensors it is given, so a step keeps one copy of the state (the JAX
    trainer's donation: ``TrainerConfig`` has no ``donate``), and nothing
    in it waits for the device.

The parameters are the model's ``Params``; the step switches on their
``requires_grad``.  The state a checkpoint holds is ``(params.tree(),
opt_state)``.

With a mesh (a ``DeviceMesh`` with dims named ``("data", "model")`` or
``("pod", "data", "model")``, as ``launch/mesh.py`` makes them) the step
is the JAX trainer's pjit step in PyTorch's idiom: the parameters are
``DTensor``s placed by ``parallel.sharding.param_shardings`` (``fsdp``
adds ZeRO-3's split of d_model over ``data``), the moments like their
parameters, the step count replicated, and the batch by
``batch_shardings`` (``positions`` on dim 1); a leaf that is not yet a
DTensor is distributed on entry (``in_shardings``: the parameters are
swapped into the ``Params`` module, which keeps them), and the step
leaves every leaf with those placements (``out_shardings``).  The model
then runs on each rank's local shards: tensor parallelism over
``model``, expert parallelism for MoE, FSDP's gathers over ``data``
(``models/``, ``parallel/dtensor.py``).  Microbatch i is the global
batch rows [i n, (i + 1) n), placed over the data axes.  The metrics
come back as plain tensors, the same on every rank.  The int8 gradient
compression runs in ``train/manual_dp.build``.

Fault tolerance: ``fit`` checkpoints every ``ckpt_every`` steps (atomic —
train/checkpoint.py; on a mesh rank 0 writes each leaf whole), resumes
from LATEST on restart (on a mesh, onto the same placements), and a
watchdog flags straggler steps (> ``straggler_factor`` x running median).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Iterator

import numpy as np
import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import Replicate, distribute_tensor

from repro_torch import trace
from repro_torch.models.model import Model, Params
from repro_torch.parallel import dtensor as D
from repro_torch.parallel import sharding as shlib
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import tree as T


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    microbatches: int = 1
    log_every: int = 10
    ckpt_every: int = 0                 # 0 = disabled
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro-torch-ckpt")
    straggler_factor: float = 3.0
    fsdp: bool = False
    pure_dp: bool = False     # mesh: no TP, batch over every axis + ZeRO-3


def _split(name: str, v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Batch rows [lo, hi) of batch entry ``name``: dim 1 of M-RoPE
    ``positions`` (3, B, S), dim 0 of every other entry."""
    return v[:, lo:hi] if name == "positions" else v[lo:hi]


def _distribute(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """``t`` placed ``place`` on ``mesh``: a plain tensor distributed from
    rank 0's value, a DTensor redistributed where it is placed otherwise.
    A fake tensor (``FakeTensorMode``: shapes only, no values to send)
    becomes a DTensor made from this rank's shard alone."""
    if D.is_dt(t):
        return (t if list(t.placements) == list(place)
                else t.redistribute(placements=place))
    if isinstance(t, FakeTensor):
        return D.zeros_placed(t.shape, t.dtype, mesh, place, t.device)
    return distribute_tensor(t.detach(), mesh, place)


def place_state(params: Params, opt_state: opt.OptState, mesh, pplace
                ) -> opt.OptState:
    """The parameters (swapped into the ``Params`` module) and the
    optimizer state on ``mesh``: each parameter and its moments placed by
    ``pplace`` (a tree of ``Params.tree()``'s structure with DTensor
    placement lists), the step replicated.  Leaves already placed so are
    kept.  Returns the placed state."""
    place = place_params(params, mesh, pplace)
    return opt.OptState(*(
        T.map_with_names(lambda n, m: _distribute(m, mesh, place[n]), ms)
        for ms in (opt_state.mu, opt_state.nu)),
        step=_distribute(opt_state.step, mesh, [Replicate()] * mesh.ndim))


def place_params(params: Params, mesh, pplace) -> dict:
    """The parameters alone placed on ``mesh`` by ``pplace``, swapped into
    the ``Params`` module (for serving); returns {leaf name: placements}."""
    place = dict(zip((n for n, _ in T.flatten_with_names(params.tree())),
                     T.leaves_like(pplace, params.tree())))
    for mname, mod in params.named_modules():
        if not isinstance(mod, nn.ParameterDict):
            continue
        for k, p in list(mod.items()):
            if not isinstance(p, torch.Tensor):
                continue                        # a nested dict: its own
            name = "".join(f"[{int(x)}]" if x.isdigit() else f"[{x!r}]"
                           for x in mname.split(".") + [k])
            new = _distribute(p if D.is_dt(p) else p.data, mesh,
                              place[name])
            if new is not p:
                mod[k] = nn.Parameter(new.detach(), requires_grad=False)
    return place


def _puredp_specs(cfg, tree, mesh):
    """spec(name, leaf) of ``param_shardings_puredp`` on the port's tree:
    a layer the JAX package stacks in a period-scan leaf takes the spec of
    that stacked leaf (its leading dim of ``periods`` counted in the
    rule), less the stacking dim; any other leaf its own."""
    from repro_torch.models import convert
    names = [n for n, _ in T.flatten_with_names(tree)]
    stacked = {n: j.startswith("['scan_blocks']") for n, j in
               zip(names, convert.jax_leaf_names(cfg, names))}
    periods = (cfg.n_layers - cfg.first_k_dense) // len(cfg.layer_pattern)

    def spec(name, leaf):
        if stacked[name]:
            return shlib.puredp_spec((periods,) + tuple(leaf.shape),
                                     mesh)[1:]
        return shlib.puredp_spec(leaf.shape, mesh)
    return spec


def _like_acc(g: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """A gradient placed like its buffer (its partial sums reduced)."""
    if D.is_dt(g) and list(g.placements) != list(acc.placements):
        return g.redistribute(placements=acc.placements)
    return g


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A 0-d metric as a plain tensor (a DTensor's value, replicated)."""
    return D.settle(t).to_local() if D.is_dt(t) else t


def block(t: torch.Tensor) -> None:
    """Wait until the device has computed ``t`` (``block_until_ready``)."""
    trace.count("host_syncs")
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


class Trainer:
    def __init__(self, model: Model, opt_cfg: opt.OptConfig,
                 tcfg: TrainerConfig, mesh=None):
        self.model = model
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self._step_fn = None
        self._pplace = None
        self.straggler_events = []

    # ------------------------------------------------------------ placing
    def param_placements(self):
        """The DTensor placements of every parameter on the mesh, a tree of
        ``Params.tree()``'s structure (``param_shardings`` with
        ``tcfg.fsdp``, or ``param_shardings_puredp`` with
        ``tcfg.pure_dp``)."""
        if self._pplace is None:
            cfg, mesh, fsdp = self.model.cfg, self.mesh, self.tcfg.fsdp
            tree = self.model.init_eval().tree()
            if self.tcfg.pure_dp:
                spec = _puredp_specs(cfg, tree, mesh)
            else:
                def spec(name, leaf):
                    path = "/".join(map(str, T.name_parts(name)))
                    return shlib.param_spec(path, leaf.shape, cfg, mesh,
                                            fsdp)
            self._pplace = T.map_with_names(
                lambda name, leaf: shlib.placements(spec(name, leaf), mesh),
                tree)
        return self._pplace

    def state_placements(self):
        """(parameter placements, ``OptState`` of the moments' and the
        step's), the trees ``checkpoint.restore(shardings=)`` takes."""
        pp = self.param_placements()
        return pp, opt.OptState(mu=pp, nu=pp,
                                step=[Replicate()] * len(
                                    shlib.axis_sizes(self.mesh)))

    def place(self, params: Params, opt_state: opt.OptState
              ) -> opt.OptState:
        """Put the parameters (swapped into the ``Params`` module) and the
        optimizer state on the mesh with their placements; returns the
        placed state.  Leaves already placed so are kept."""
        return place_state(params, opt_state, self.mesh,
                           self.param_placements())

    def place_params(self, params: Params) -> None:
        """Put the parameters alone on the mesh (swapped into the ``Params``
        module), placed as ``place`` places them: the serving path's
        state."""
        place_params(params, self.mesh, self.param_placements())

    def batch_placements(self, batch) -> Dict:
        """{name: DTensor placements} of a batch on the mesh
        (``batch_shardings``, or ``batch_shardings_puredp`` with
        ``tcfg.pure_dp``)."""
        specs = (shlib.batch_shardings_puredp if self.tcfg.pure_dp
                 else shlib.batch_shardings)(batch, self.mesh)
        return {k: shlib.placements(v, self.mesh) for k, v in specs.items()}

    def _batches(self, batch, batch_example):
        """The microbatches of ``batch``, each placed over the data axes
        (by ``batch_example``'s specs, where given, for a single one):
        the global rows [i n, (i + 1) n) of every entry."""
        mesh, mb = self.mesh, self.tcfg.microbatches
        n = batch["tokens"].shape[0] // mb
        out = []
        for i in range(mb):
            part = batch if mb == 1 else {
                k: _split(k, D.whole(v).to_local() if D.is_dt(v) else v,
                          i * n, (i + 1) * n) for k, v in batch.items()}
            place = self.batch_placements(
                batch_example if (mb == 1 and batch_example is not None)
                else part)
            out.append({k: _distribute(v, mesh, place[k])
                        for k, v in part.items()})
        return out

    # ------------------------------------------------------------ stepfn
    def build_step(self, batch_example=None) -> Callable:
        """step(params, opt_state, batch) -> (params, opt_state, metrics),
        updating ``params`` and the moments in place.  On a mesh the batch
        is placed by ``batch_example``'s specs where it is given (JAX's
        ``in_shardings``), else by the batch's own.  Traced as
        ``trainer.step`` with ``trainer.forward`` and ``trainer.backward``
        (each microbatch's) and ``trainer.optimizer`` inside."""
        model, ocfg, tcfg = self.model, self.opt_cfg, self.tcfg

        def grads_of(leaves, params, batch):
            with trace.span("trainer.forward"):
                loss, metrics = model.loss_fn(params, batch)
            with trace.span("trainer.backward"):
                return loss, metrics, torch.autograd.grad(loss, leaves)

        def step_body(params, opt_state, batch):
            mb = tcfg.microbatches
            b = batch["tokens"].shape[0]
            if b % mb:
                raise ValueError(f"batch {b} does not split into {mb} "
                                 f"microbatches")
            n = b // mb
            if self.mesh is not None:
                opt_state = self.place(params, opt_state)
                parts = self._batches(batch, batch_example)
            else:
                parts = [batch] if mb == 1 else [
                    {k: _split(k, v, i * n, (i + 1) * n)
                     for k, v in batch.items()} for i in range(mb)]
            tree = params.tree()
            leaves = T.leaves(tree)
            for p in leaves:
                p.requires_grad_(True)
            if mb > 1:
                acc = [torch.zeros_like(p, dtype=torch.float32)
                       for p in leaves]
                loss_sum = 0.0
                for mbatch in parts:
                    loss, metrics, grads = grads_of(leaves, params, mbatch)
                    for a, g in zip(acc, grads):
                        a.add_(_like_acc(g, a))
                    del grads
                    loss_sum = loss_sum + D.settle(loss.detach())
                torch._foreach_div_(acc, float(mb))
                grads, loss = acc, loss_sum / mb
            else:
                loss, metrics, grads = grads_of(leaves, params, parts[0])
                grads, loss = list(grads), loss.detach()
            metrics = {k: _plain(v.detach()) for k, v in metrics.items()}
            with trace.span("trainer.optimizer"):
                _, opt_state, om = opt.apply_updates(tree, opt_state, grads,
                                                     ocfg)
            return params, opt_state, dict(metrics, loss=_plain(loss), **om)

        def step(params: Params, opt_state: opt.OptState,
                 batch: Dict[str, torch.Tensor]):
            with trace.span("trainer.step"):
                return step_body(params, opt_state, batch)

        self._step_fn = step
        return step

    # -------------------------------------------------------------- fit
    def fit(self, params: Params, opt_state: opt.OptState,
            batches: Iterator, start_step: int = 0, resume: bool = True):
        """Run the training loop.  Returns (params, opt_state, history)."""
        tcfg = self.tcfg
        if self._step_fn is None:
            self.build_step()
        step_fn = self._step_fn

        if resume and tcfg.ckpt_every:
            last = ckpt.latest_step(tcfg.ckpt_dir)
            if last is not None and last > start_step:
                shardings = None
                if self.mesh is not None:
                    opt_state = self.place(params, opt_state)
                    shardings = (self.mesh, self.state_placements())
                (tree, opt_state), _ = ckpt.restore(
                    tcfg.ckpt_dir, (params.tree(), opt_state), step=last,
                    device=opt_state.step.device, shardings=shardings)
                with torch.no_grad():
                    for dst, src in zip(T.leaves(params.tree()),
                                        T.leaves(tree)):
                        dst.copy_(src)
                del tree
                start_step = last

        history = []
        durations = []
        t_step = start_step
        for batch in batches:
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            block(metrics["loss"])
            dt = time.perf_counter() - t0
            durations.append(dt)
            med = float(np.median(durations[-32:]))
            if len(durations) > 4 and dt > tcfg.straggler_factor * med:
                self.straggler_events.append((t_step, dt, med))
            t_step += 1
            if tcfg.log_every and t_step % tcfg.log_every == 0:
                history.append({"step": t_step,
                                "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"]),
                                "sec_per_step": dt})
            if tcfg.ckpt_every and t_step % tcfg.ckpt_every == 0:
                ckpt.save(tcfg.ckpt_dir, t_step, (params.tree(), opt_state))
            if t_step - start_step >= tcfg.steps:
                break
        return params, opt_state, history
