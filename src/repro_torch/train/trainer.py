"""Trainer: train step (loss -> grads -> clip -> AdamW), microbatch
accumulation, checkpoint/restart, straggler watchdog; PyTorch port of
``repro.train.trainer`` (its ``mesh=None`` path).

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
    trainer's donation), and nothing in it waits for the device.

The parameters are the model's ``Params``; the step switches on their
``requires_grad``.  The state a checkpoint holds is ``(params.tree(),
opt_state)``.  The mesh path (pjit with parameter, optimizer and batch
shardings, FSDP) waits for the Trainer's mesh branch, the next item of
ROADMAP.md's "Modules to port": it needs DTensor through the model, K4's
and K4b's autograd function included.  The int8 gradient compression
runs in ``train/manual_dp.build``.

Fault tolerance: ``fit`` checkpoints every ``ckpt_every`` steps (atomic —
train/checkpoint.py), resumes from LATEST on restart, and a watchdog flags
straggler steps (> ``straggler_factor`` x running median).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Iterator

import numpy as np
import torch

from repro_torch.models.model import Model, Params
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


def _split(name: str, v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Batch rows [lo, hi) of batch entry ``name``: dim 1 of M-RoPE
    ``positions`` (3, B, S), dim 0 of every other entry."""
    return v[:, lo:hi] if name == "positions" else v[lo:hi]


def block(t: torch.Tensor) -> None:
    """Wait until the device has computed ``t`` (``block_until_ready``)."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


class Trainer:
    def __init__(self, model: Model, opt_cfg: opt.OptConfig,
                 tcfg: TrainerConfig, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer: the mesh path (sharded parameters, optimizer and "
                "batch; FSDP) waits for the Trainer's mesh branch (ROADMAP.md,"
                " \"Modules to port\"; DTensor through the model); pass "
                "mesh=None, or train data-parallel with manual_dp.build")
        self.model = model
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self._step_fn = None
        self.straggler_events = []

    # ------------------------------------------------------------ stepfn
    def build_step(self) -> Callable:
        """step(params, opt_state, batch) -> (params, opt_state, metrics),
        updating ``params`` and the moments in place."""
        model, ocfg, tcfg = self.model, self.opt_cfg, self.tcfg

        def grads_of(leaves, params, batch):
            loss, metrics = model.loss_fn(params, batch)
            return loss, metrics, torch.autograd.grad(loss, leaves)

        def step(params: Params, opt_state: opt.OptState,
                 batch: Dict[str, torch.Tensor]):
            tree = params.tree()
            leaves = T.leaves(tree)
            for p in leaves:
                p.requires_grad_(True)
            mb = tcfg.microbatches
            if mb > 1:
                b = batch["tokens"].shape[0]
                if b % mb:
                    raise ValueError(f"batch {b} does not split into {mb} "
                                     f"microbatches")
                n = b // mb
                acc = [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in leaves]
                loss_sum = torch.zeros((), dtype=torch.float32,
                                       device=leaves[0].device)
                for i in range(mb):
                    mbatch = {k: _split(k, v, i * n, (i + 1) * n)
                              for k, v in batch.items()}
                    loss, metrics, grads = grads_of(leaves, params, mbatch)
                    for a, g in zip(acc, grads):
                        a.add_(g)
                    del grads
                    loss_sum = loss_sum + loss.detach()
                torch._foreach_div_(acc, float(mb))
                grads, loss = acc, loss_sum / mb
            else:
                loss, metrics, grads = grads_of(leaves, params, batch)
                grads, loss = list(grads), loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
            _, opt_state, om = opt.apply_updates(tree, opt_state, grads, ocfg)
            return params, opt_state, dict(metrics, loss=loss, **om)

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
                (tree, opt_state), _ = ckpt.restore(
                    tcfg.ckpt_dir, (params.tree(), opt_state), step=last,
                    device=opt_state.step.device)
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
