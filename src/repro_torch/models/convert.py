"""Carry the JAX package's dense-model parameters into the port.

The JAX tree holds the layers as ``scan_blocks`` (one entry per position
in the layer pattern, each stacked over the periods), then ``tail_blocks``
(the pattern's leftover layers); ``head_blocks`` is empty for the dense
family.  The port keeps one block per layer in absolute order, so layer
``period * len(pattern) + pos`` takes slice ``period`` of
``scan_blocks[pos]`` and the tail layers follow.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.model import Params


def _pdict(tree: Dict[str, Any], dtype, dev) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: L.param(torch.tensor(np.asarray(v), device=dev).to(dtype))
        for k, v in tree.items()})


def _block(tree: Dict[str, Any], dtype, dev) -> nn.ModuleDict:
    return nn.ModuleDict({k: _pdict(v, dtype, dev) for k, v in tree.items()})


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device="cuda") -> Params:
    """``tree``: the JAX parameter tree with numpy float32 leaves.  Returns
    the port's parameters in ``cfg.dtype`` on ``device``."""
    if cfg.family != "dense" or tree["head_blocks"]:
        raise NotImplementedError(
            "params_from_numpy: only the dense family is ported "
            "(ROADMAP.md, \"Modules to port\")")
    dev = resolve_device(device)
    dt = L.dtype_of(cfg.dtype)
    period = len(cfg.layer_pattern)
    scan = tree["scan_blocks"]
    n_periods = cfg.n_periods
    blocks = []
    for layer in range(n_periods * period):
        per, pos = divmod(layer, period)
        blocks.append(_block({k: {kk: vv[per] for kk, vv in v.items()}
                              for k, v in scan[pos].items()}, dt, dev))
    blocks += [_block(t, dt, dev) for t in tree["tail_blocks"]]
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"params_from_numpy: {len(blocks)} blocks for "
                         f"{cfg.n_layers} layers")
    return Params(_pdict(tree["embed"], dt, dev), blocks,
                  _pdict(tree["final_norm"], dt, dev))
