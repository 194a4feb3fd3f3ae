"""Compute/communication overlap engine (paper §V-C); PyTorch port of
``repro.core.overlap``.

FPsPIN's headline result: offloaded MPI-datatype ingest overlaps ~96-98 %
with a host matrix multiplication (Fig 10, R = T_MM / (T_MM + T_Poll)).
Here, while compute step *t* runs, the ingest for step *t+1* (match, SLMP
reassembly, DDT unpack) is already in flight:

* ``overlapped_loop``: on CUDA, ingest runs on a side stream and compute
  on the current stream; the host waits for compute, then for whatever of
  the ingest is left, and that second wait is T_Poll.  CUDA streams and
  events take the place of JAX's asynchronous dispatch and
  ``block_until_ready``.  On the CPU the two run one after the other.
* ``fuse_ingest_into_step``: step'(state, raw) = step(state, ingest(raw))
  as plain composition; PyTorch has no program to fuse them into.

Both loops report the paper's metric, R = T_MM / (T_MM + T_Poll).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, List, Tuple

import torch

from repro_torch import resolve_device, trace


@dataclasses.dataclass
class OverlapReport:
    steps: int
    t_mm_s: float          # time attributable to compute (blocked on it)
    t_poll_s: float        # extra time blocked waiting for ingest
    overlap_ratio: float   # R = T_MM / (T_MM + T_Poll)
    wall_s: float

    def row(self) -> str:
        return (f"steps={self.steps} t_mm={self.t_mm_s * 1e3:.2f}ms "
                f"t_poll={self.t_poll_s * 1e3:.2f}ms "
                f"R={self.overlap_ratio:.4f}")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _report(steps, t_mm, t_poll, wall) -> OverlapReport:
    r = t_mm / max(t_mm + t_poll, 1e-12)
    return OverlapReport(steps, t_mm, t_poll, r, wall)


def _sync(dev: torch.device, stream=None) -> None:
    trace.count("host_syncs")
    if dev.type == "cuda":
        (stream or torch.cuda.current_stream(dev)).synchronize()


def sequential_loop(ingest: Callable, compute: Callable, feeds: List,
                    state: Any, device="cuda") -> Tuple[Any, OverlapReport]:
    """No overlap: ingest batch t, wait, compute batch t, wait."""
    dev = resolve_device(device)
    t_mm = t_poll = 0.0
    w0 = time.perf_counter()
    for feed in feeds:
        t0 = time.perf_counter()
        batch = ingest(feed)
        _sync(dev)
        t1 = time.perf_counter()
        state = compute(state, batch)
        _sync(dev)
        t2 = time.perf_counter()
        t_poll += t1 - t0
        t_mm += t2 - t1
    return state, _report(len(feeds), t_mm, t_poll, time.perf_counter() - w0)


def overlapped_loop(ingest: Callable, compute: Callable, feeds: List,
                    state: Any, device="cuda") -> Tuple[Any, OverlapReport]:
    """Double-buffered: ingest t+1 is issued on a side stream before the
    host blocks on compute t.  T_Poll counts only the time ingest was
    *not* hidden.  The two waits of step t are traced as
    ``overlap.wait_compute`` and ``overlap.wait_ingest`` (request t)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    main = torch.cuda.current_stream(dev) if cuda else None
    side = torch.cuda.Stream(dev) if cuda else None

    def on_side():
        return torch.cuda.stream(side) if cuda else contextlib.nullcontext()

    def issue_ingest(feed):
        with on_side():
            return ingest(feed)

    t_mm = t_poll = 0.0
    w0 = time.perf_counter()
    if cuda:
        side.wait_stream(main)           # feeds staged on the main stream
    batch = issue_ingest(feeds[0])       # prologue (unavoidable first fill)
    _sync(dev, side)
    for i in range(len(feeds)):
        if cuda:
            # the batch was made on the side stream and is read on main
            for t in _tensors(batch):
                t.record_stream(main)
        state = compute(state, batch)              # async on main
        nxt = issue_ingest(feeds[i + 1]) if i + 1 < len(feeds) else None
        t0 = time.perf_counter()
        with trace.span("overlap.wait_compute", request=i):
            _sync(dev, main)                       # wait for compute
        t1 = time.perf_counter()
        if nxt is not None:
            with trace.span("overlap.wait_ingest", request=i):
                _sync(dev, side)                   # leftover ingest time
            batch = nxt
        t2 = time.perf_counter()
        t_mm += t1 - t0
        t_poll += t2 - t1
    return state, _report(len(feeds), t_mm, t_poll, time.perf_counter() - w0)


def fuse_ingest_into_step(ingest_fn: Callable, step_fn: Callable
                          ) -> Callable:
    """Return step'(state, raw_feed) = step(state, ingest(raw_feed))."""

    def fused(state, raw_feed):
        return step_fn(state, ingest_fn(raw_feed))

    return fused
