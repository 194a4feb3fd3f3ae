"""Handing the benchmark's inputs to the program: a configuration file's
``model`` as the port's ``ModelConfig``, and weights made by the
benchmark copied into the port's parameters, leaf by leaf by name."""
from __future__ import annotations

from typing import Dict, Iterator, Tuple


def model_config(m: dict):
    from repro_torch.configs.base import ModelConfig
    kw = dict(m)
    kw["layer_pattern"] = tuple(kw["layer_pattern"])
    return ModelConfig(**kw)


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(dotted name, leaf) of a tree of dicts and lists:
    ``blocks.3.ssm.in_proj``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def load_weights(params, weights: Dict[str, object]) -> None:
    """Copy ``weights`` into the program's parameters (same names, shapes
    and dtypes, or an error)."""
    import torch
    mine = dict(leaves(params.tree()))
    if set(mine) != set(weights):
        raise ValueError(f"weights differ from the program's leaves: "
                         f"{sorted(set(mine) ^ set(weights))[:8]}")
    with torch.no_grad():
        for k, p in mine.items():
            w = weights[k]
            if p.shape != w.shape or p.dtype != w.dtype:
                raise ValueError(f"{k}: program {tuple(p.shape)} {p.dtype}, "
                                 f"weights {tuple(w.shape)} {w.dtype}")
            p.copy_(w)
