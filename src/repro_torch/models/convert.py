"""Carry the JAX package's model parameters, optimizer state and
checkpoints into the port (every model family).

The JAX tree holds the layers as ``head_blocks`` (``cfg.first_k_dense``
dense layers; empty but for kimi-k2), ``scan_blocks`` (one entry per
position in the layer pattern, each stacked over the periods, to any
depth: ``moe/shared/up`` is three levels down), then ``tail_blocks`` (the
pattern's leftover layers).  The port keeps one block per layer in
absolute order: the head layers, then layer ``n_head + period *
len(pattern) + pos`` from slice ``period`` of ``scan_blocks[pos]``, then
the tail.  An encdec tree's decoder blocks hold ``normx`` and ``xattn``
(stacked like the rest) and its ``encoder`` is a list of blocks, which
the port keeps as ``Params.encoder`` in the same order.  Leaves the JAX
package holds in float32 whatever
``cfg.dtype`` is (``moe/router``, ``rglru/{b_r,b_i,lam}``,
``ssm/{a_log,dt_bias,d_skip}``) stay float32; the rest take
``cfg.dtype``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.model import Params
from repro_torch.train import tree as T
from repro_torch.train.optimizer import OptState


# per block part, the leaves held in float32 at any cfg.dtype
_FLOAT32 = {"moe": M.FLOAT32, "rglru": R.FLOAT32, "ssm": S.FLOAT32}


def _pdict(tree: Dict[str, Any], dtype, dev, f32=frozenset()
           ) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: _pdict(v, dtype, dev) if isinstance(v, dict) else
        L.param(_tensor(v, torch.float32 if k in f32 else dtype, dev))
        for k, v in tree.items()})


def _tensor(x, dtype, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=dev).to(dtype)


def _slice(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Slice ``i`` of every leaf of a nested dict of stacked arrays."""
    return {k: _slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def port_layout(cfg: ModelConfig, tree: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX tree's leaves in the port's layout, ``Params.tree()``'s:
    {"embed", "blocks": [one per layer, absolute order], "final_norm"},
    and for encdec "encoder": [one per encoder layer]."""
    period = len(cfg.layer_pattern)
    n_periods = (cfg.n_layers - cfg.first_k_dense) // period
    scan = tree.get("scan_blocks", [])
    blocks = list(tree.get("head_blocks", []))
    for layer in range(n_periods * period):
        per, pos = divmod(layer, period)
        blocks.append(_slice(scan[pos], per))
    blocks += list(tree.get("tail_blocks", []))
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"params_from_numpy: {len(blocks)} blocks for "
                         f"{cfg.n_layers} layers")
    out = {"embed": tree["embed"], "blocks": blocks,
           "final_norm": tree["final_norm"]}
    if cfg.family == "encdec":
        if len(tree["encoder"]) != cfg.enc_layers:
            raise ValueError(f"params_from_numpy: {len(tree['encoder'])} "
                             f"encoder blocks for {cfg.enc_layers} layers")
        out["encoder"] = list(tree["encoder"])
    return out


def jax_leaf_names(cfg: ModelConfig, names) -> list:
    """For each leaf name of the port's tree (``Params.tree()``, as
    ``tree.flatten_with_names`` gives them), the name of the JAX tree's
    leaf that holds it: a layer of a period-scan position lives in the
    stacked ``scan_blocks`` leaf of that position."""
    import re
    period = len(cfg.layer_pattern)
    n_head = cfg.first_k_dense
    n_scan = (cfg.n_layers - n_head) // period * period
    out = []
    for name in names:
        m = re.fullmatch(r"\['blocks'\]\[(\d+)\](.*)", name)
        if m is None:
            out.append(name)
            continue
        i, rest = int(m.group(1)), m.group(2)
        if i < n_head:
            out.append(f"['head_blocks'][{i}]{rest}")
        elif i < n_head + n_scan:
            out.append(f"['scan_blocks'][{(i - n_head) % period}]{rest}")
        else:
            out.append(f"['tail_blocks'][{i - n_head - n_scan}]{rest}")
    return out


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device="cuda") -> Params:
    """``tree``: the JAX parameter tree with numpy leaves.  Returns the
    port's parameters on ``device``, in ``cfg.dtype`` but for the leaves
    the JAX package holds in float32."""
    dev = resolve_device(device)
    dt = L.dtype_of(cfg.dtype)
    t = port_layout(cfg, tree)

    def blocks(trees):
        return [nn.ModuleDict({k: _pdict(v, dt, dev, _FLOAT32.get(k, ()))
                               for k, v in b.items()}) for b in trees]
    return Params(_pdict(t["embed"], dt, dev), blocks(t["blocks"]),
                  _pdict(t["final_norm"], dt, dev),
                  blocks(t["encoder"]) if "encoder" in t else None)


def opt_state_from_numpy(cfg: ModelConfig, state: Dict[str, Any],
                         device="cuda") -> OptState:
    """``state``: the JAX ``OptState`` as {"mu", "nu", "step"} with numpy
    leaves (``mu`` and ``nu`` trees like the parameters').  Returns the
    port's ``OptState``: moments in float32 in ``Params.tree()``'s layout,
    the step an int32 scalar, on ``device``."""
    dev = resolve_device(device)

    def moments(tree):
        return T.map_tree(lambda x: _tensor(x, torch.float32, dev),
                          port_layout(cfg, tree))
    return OptState(moments(state["mu"]), moments(state["nu"]),
                    _tensor(np.asarray(state["step"]).reshape(()),
                            torch.int32, dev))


def state_from_checkpoint(cfg: ModelConfig, arrays: Dict[str, np.ndarray],
                          device="cuda") -> Tuple[Params, OptState]:
    """A JAX trainer's checkpoint of ``(params, opt_state)``, as
    ``checkpoint.read_numpy`` returns it ({leaf name: array}), carried into
    the port: (Params, OptState) on ``device``."""
    params, ost = T.nest_by_name(arrays)
    return (params_from_numpy(cfg, params, device),
            opt_state_from_numpy(cfg, ost, device))
