"""Explicit data-parallel gradient mean over the simulated FPsPIN fabric;
PyTorch port of ``FabricGradSync`` in ``repro.train.manual_dp``.

:class:`FabricGradSync` routes a gradient mean through the port's
nonblocking MPI layer (``repro_torch.mpi``): post the reduction, keep
ticking the fabric from inside the backprop window (the progress hook),
and the multi-MiB gradient vector rides the segmented Rabenseifner fast
path with NIC-side unpack.  That is what the ``grad_allreduce`` benchmark
measures: the overlap ratio of a gradient-sized reduction hidden behind
compute.

``build`` (the JAX package's ``shard_map`` train step whose gradient mean
runs through the int8 error-feedback collective of
``parallel/compression.py``) waits for ``parallel/`` (ROADMAP.md,
"Modules to port").
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

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


def build(*args, **kwargs):
    """The manual-DP train step of the JAX package (``shard_map`` over the
    data axes, int8 error-feedback gradient mean) waits for ``parallel/``
    (ROADMAP.md, "Modules to port")."""
    raise NotImplementedError(
        "manual_dp.build: the shard_map train step with the compressed "
        "gradient mean waits for parallel/ (ROADMAP.md, \"Modules to "
        "port\"); FabricGradSync is ported")
