"""Roofline terms of one step on NVIDIA H100 cards, and the counting mode
that totals a rank's work; PyTorch port of ``repro.launch.roofline``.

Per (arch x shape x mesh), per rank:

  compute term    = FLOPs            / PEAK_FLOPS
  memory term     = bytes accessed   / HBM_BW
  collective term = collective bytes / LINK_BW

Constants (one NVIDIA H100 SXM5, NVIDIA's data sheet, at its 700 W limit):

* ``PEAK_FLOPS`` 989e12 FLOP/s: dense bf16 on the tensor cores.
* ``HBM_BW`` 3.35e12 B/s: HBM3.
* ``NVLINK_BW`` 450e9 B/s a direction (NVLink 4, 900 GB/s both ways),
  between the 8 cards of one node.
* ``NIC_BW`` 50e9 B/s: one 400 Gb/s NDR InfiniBand NIC per card, between
  nodes.
* ``LINK_BW`` = ``NIC_BW``: both production meshes put 16 ranks on
  ``model`` (rank = data x 16 + model), so a ``model`` group spans two
  nodes of 8 and a ``data`` or ``pod`` group 16 or 32 nodes; every group
  crosses nodes, and its collectives run at a NIC's rate.

The JAX package reads its FLOPs and bytes from XLA's cost analysis and
parses collective bytes from the partitioned HLO.  Here the step runs
eagerly, op by op, and :class:`CountingMode` (a ``TorchDispatchMode``)
totals what one rank executes:

* FLOPs: ``torch.utils.flop_counter``'s formula of each op in its
  registry (the matrix products, convolutions, and K4 and K4b through
  their custom ops' formulas), for ops whose arguments hold no DTensor.
  An op on DTensors is handed back to DTensor (``NotImplemented``, as
  ``CommDebugMode`` does), so that the local op it runs on the rank's
  shards, and the collectives of any redistribution it makes, reach the
  mode as plain ops: each is counted once, at the rank's own shapes.
  The global-shape fake run by which DTensor infers an op's output shape
  is not counted.
* Bytes accessed: each local op's input and output tensor bytes; an op
  whose output is a view or alias of an input counts 0, an allocation
  without a write (``empty``) and a metadata query (``prim::device``)
  count 0.  This is the eager port's HBM
  traffic, op by op (no fusion).
* Collectives: each collective's max(input, output) bytes on this rank,
  by kind, in the JAX package's keys (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``, ``count``,
  ``total``): DTensor's functional collectives and ``torch.distributed``'s
  own.  A broadcast, a send and a receive count as ``collective-permute``.

``MODEL_FLOPS`` = 6 N D (train) or 2 N D (forward only), N the active
parameters (``ModelConfig.param_count``), and the useful ratio
MODEL_FLOPS / (FLOPs x ranks), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig

PEAK_FLOPS = 989e12          # H100 SXM5, dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # H100 SXM5 HBM3, bytes/s
NVLINK_BW = 450e9            # bytes/s a direction, within a node of 8
NIC_BW = 50e9                # bytes/s, one 400 Gb/s NIC per card
LINK_BW = NIC_BW             # every production mesh group crosses nodes

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
# DTensor's shape inference, by torch version: the first found is wrapped
_SHAPE_INFERENCE = ("_propagate_tensor_meta_non_cached",
                    "_propagate_tensor_meta")
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_local_scalar_dense"}


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _has_dtensor(tree) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in tree_leaves(tree))


def _aliases(func) -> bool:
    """Whether an output of ``func`` is a view or alias of an input (not an
    in-place write)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class CountingMode(TorchDispatchMode):
    """Totals one rank's FLOPs, bytes accessed and collective bytes over
    the ops it executes (module docstring).  ``flops``, ``bytes`` and
    ``collectives`` (a dict in the JAX package's keys) after the ``with``
    block; ``calls`` counts each op's calls by name (``repro::...`` for
    the kernels' custom ops)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.collectives.update(count=0, total=0)
        self.calls: Dict[str, int] = {}
        self._shadow = 0
        self._patched = None

    def __enter__(self):
        # DTensor infers an op's global output shape (once per op and
        # placements) by running it on fake tensors of the global shapes,
        # while this mode is active; those runs are not the rank's work
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as prop
        for name in _SHAPE_INFERENCE:
            orig = prop.__dict__.get(name)
            if orig is not None:
                def shadowed(*args, _orig=orig, **kwargs):
                    self._shadow += 1
                    try:
                        return _orig(*args, **kwargs)
                    finally:
                        self._shadow -= 1
                setattr(prop, name, shadowed)
                self._patched = (prop, name, orig)
                break
        return super().__enter__()

    def __exit__(self, *exc):
        if self._patched is not None:
            prop, name, orig = self._patched
            setattr(prop, name, orig)
            self._patched = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator) or self._shadow:
            return func(*args, **kwargs)
        if _has_dtensor((args, kwargs)):
            # let DTensor run first: its local ops and the collectives of
            # its redistributions then come back here, as plain ops
            return NotImplemented
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "prim":                 # metadata (device, layout)
            return out
        name = func._schema.name.split("::")[-1]
        self.calls[f"{ns}::{name}"] = self.calls.get(f"{ns}::{name}", 0) + 1
        if ns in ("_c10d_functional", "c10d"):
            kind = _KIND.get(name)
            if kind is not None:
                self._collective(func, kind, args, kwargs, out)
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if name not in _NO_TRAFFIC and not _aliases(func):
            self.bytes += _bytes((args, kwargs)) + _bytes(out)
        return out

    def _collective(self, func, kind, args, kwargs, out) -> None:
        """max(input, output) bytes; for ``torch.distributed``'s ops the
        arguments named ``output...`` are the outputs, and an op without
        them reduces in place."""
        if func.namespace == "c10d":
            names = [a.name for a in func._schema.arguments]
            named = dict(zip(names, args), **kwargs)
            outs = [v for n, v in named.items() if n.startswith("output")]
            ins = [v for n, v in named.items() if not n.startswith("output")]
            n_in, n_out = _bytes(ins), _bytes(outs)
        else:
            n_in, n_out = _bytes((args, kwargs)), _bytes(out)
        n = max(n_in, n_out)
        self.collectives[kind] += n
        self.collectives["count"] += 1
        self.collectives["total"] += n


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                  # the counting mode's FLOPs a rank
    hlo_bytes: float                  # its bytes accessed
    collective_bytes: float           # its collective bytes
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    useful_ratio: float
    bottleneck: str
    bytes_per_device: Optional[float] = None
    note: str = ""

    def row(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, tokens: int, fwd_only: bool = False
                ) -> float:
    """6·N·D (train: fwd 2ND + bwd 4ND) or 2·N·D (prefill/decode, forward
    only), N = active params (MoE: routed top-k + shared only)."""
    n_active = cfg.param_count(active_only=True)
    return (2.0 if fwd_only else 6.0) * n_active * tokens


def derive(arch: str, shape: str, mesh_name: str, chips: int,
           flops: float, byt: float, collective_bytes: float,
           cfg: ModelConfig, tokens: int,
           bytes_per_device: Optional[float] = None,
           note: str = "", fwd_only: bool = False) -> RooflineTerms:
    """The terms from one rank's counts: per-rank work over one card's
    rates."""
    compute_s = flops / PEAK_FLOPS
    memory_s = byt / HBM_BW
    collective_s = collective_bytes / LINK_BW
    mf = model_flops(cfg, tokens, fwd_only=fwd_only)
    useful = mf / max(flops * chips, 1.0)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byt, collective_bytes=collective_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=mf, useful_ratio=useful, bottleneck=bottleneck,
        bytes_per_device=bytes_per_device, note=note)


def to_markdown_table(rows) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "bottleneck | MODEL_FLOPS/HLO | note |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | {r['bottleneck']} "
            f"| {r['useful_ratio']:.3f} | {r.get('note','')} |")
    return "\n".join(lines)
