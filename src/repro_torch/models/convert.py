"""Carry the JAX package's dense-model parameters, optimizer state and
checkpoints into the port.

The JAX tree holds the layers as ``scan_blocks`` (one entry per position
in the layer pattern, each stacked over the periods), then ``tail_blocks``
(the pattern's leftover layers); ``head_blocks`` is empty for the dense
family.  The port keeps one block per layer in absolute order, so layer
``period * len(pattern) + pos`` takes slice ``period`` of
``scan_blocks[pos]`` and the tail layers follow.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.model import Params
from repro_torch.train import tree as T
from repro_torch.train.optimizer import OptState


def _pdict(tree: Dict[str, Any], dtype, dev) -> nn.ParameterDict:
    return nn.ParameterDict({k: L.param(_tensor(v, dtype, dev))
                             for k, v in tree.items()})


def _tensor(x, dtype, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=dev).to(dtype)


def port_layout(cfg: ModelConfig, tree: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX tree's leaves in the port's layout, ``Params.tree()``'s:
    {"embed", "blocks": [one per layer, absolute order], "final_norm"}."""
    if cfg.family != "dense" or tree.get("head_blocks"):
        raise NotImplementedError(
            "params_from_numpy: only the dense family is ported "
            "(ROADMAP.md, \"Modules to port\")")
    period = len(cfg.layer_pattern)
    scan = tree.get("scan_blocks", [])
    blocks = []
    for layer in range(cfg.n_periods * period):
        per, pos = divmod(layer, period)
        blocks.append({k: {kk: vv[per] for kk, vv in v.items()}
                       for k, v in scan[pos].items()})
    blocks += list(tree.get("tail_blocks", []))
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"params_from_numpy: {len(blocks)} blocks for "
                         f"{cfg.n_layers} layers")
    return {"embed": tree["embed"], "blocks": blocks,
            "final_norm": tree["final_norm"]}


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device="cuda") -> Params:
    """``tree``: the JAX parameter tree with numpy float32 leaves.  Returns
    the port's parameters in ``cfg.dtype`` on ``device``."""
    dev = resolve_device(device)
    dt = L.dtype_of(cfg.dtype)
    t = port_layout(cfg, tree)
    blocks = [nn.ModuleDict({k: _pdict(v, dt, dev) for k, v in b.items()})
              for b in t["blocks"]]
    return Params(_pdict(t["embed"], dt, dev), blocks,
                  _pdict(t["final_norm"], dt, dev))


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
