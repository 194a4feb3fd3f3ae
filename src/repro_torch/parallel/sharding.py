"""Sharding rules: parameter / optimizer / activation / cache partitioning;
PyTorch port of ``repro.parallel.sharding``.

Mesh axes: ``("pod", "data", "model")`` multi-pod or ``("data", "model")``
single-pod.  ``pod`` and ``data`` are both data-parallel (batch shards over
their product); ``model`` carries tensor/expert parallelism.

Policy (MaxText-style, divisibility-gated), as the JAX package's:
  * embeddings / lm_head        : vocab over ``model`` when divisible
  * attention q/o               : head dim (as q_dim columns) over ``model``
                                  when n_heads divides the axis
  * attention k/v               : over ``model`` when n_kv_heads divides
  * MLP up/gate/down            : d_ff over ``model`` when divisible
  * MoE experts                 : expert dim over ``model`` (EP)
  * mamba2 / rg-lru mixers      : lru/inner width over ``model`` where
                                  divisible, else replicated
  * FSDP (flag)                 : additionally shard the d_model dim of
                                  matrices over ``data`` (ZeRO-3)
  * optimizer moments           : same spec as their parameter
  * activations                 : batch over (pod, data)
  * KV caches                   : batch over (pod, data) when divisible;
                                  long-context (batch 1): cache sequence
                                  over ``data``

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), an
axis name, or a tuple of axis names (the dim split over their product,
the first the major one); it equals ``tuple(PartitionSpec)`` of the JAX
rule.  The rules are pure functions of a leaf's path, its shape, the
config and the mesh's axis sizes.  ``mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``, or
an ordered {axis name: size} mapping (``AxisSizes``), which holds the
rules at meshes of hundreds of devices without a process group.  Where
the JAX functions return ``NamedSharding`` trees, these return trees of
specs; ``placements`` turns a spec into DTensor placements on a mesh.

A leaf's path is the JAX package's: dict keys and sequence indices joined
with "/" (``scan_blocks/0/attn/wq``).  On the JAX tree, period-scan
parameters carry a leading ``periods`` dim and the specs right-align
against the trailing dims; on the port's tree (``Params.tree()``, one
block per layer, ``blocks/3/attn/wq``) ``param_spec`` gives the same spec
less that dim.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.train import tree as T

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]
AxisSizes = Dict[str, int]       # ordered {axis name: size}


def axis_sizes(mesh) -> AxisSizes:
    """{axis name: size}, in mesh-dim order, of a ``DeviceMesh`` (which
    must name its dims) or of an ``AxisSizes`` mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("sharding: the DeviceMesh needs mesh_dim_names")
    return dict(zip(names, tuple(mesh.shape)))


def _axis_size(sizes: AxisSizes, name: str) -> int:
    return sizes.get(name, 1)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _prod(sizes: AxisSizes, axes) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def map_with_path(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """The same structure with ``fn(path, leaf)`` in place of every leaf;
    ``path`` as ``_path_str`` of the JAX package writes it: the steps
    joined with "/" (a NamedTuple field as ".name")."""
    return T.map_with_names(
        lambda name, leaf: fn("/".join(map(str, T.name_parts(name))), leaf),
        tree)


def param_spec(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
               mesh, fsdp: bool = False) -> Spec:
    """The spec of one parameter leaf, by path suffix + shape."""
    sizes = axis_sizes(mesh)
    tp = _axis_size(sizes, "model")
    dp = _axis_size(sizes, "data")
    shape = tuple(shape)

    def fs(dim: int) -> Optional[str]:
        """FSDP-shard helper for a d_model-sized dim."""
        return "data" if (fsdp and _div(dim, dp)) else None

    def model_if(ok: bool) -> Optional[str]:
        return "model" if ok else None

    leaf = path.split("/")[-1]
    # ---- embeddings
    if leaf == "tok":
        v, d = shape[-2:]
        base = (model_if(_div(v, tp)), fs(d))
    elif leaf == "lm_head":
        d, v = shape[-2:]
        base = (fs(d), model_if(_div(v, tp)))
    # ---- attention
    elif leaf in ("wq", "wo", "bq"):
        heads_ok = _div(cfg.n_heads, tp)
        if leaf == "wq":
            base = (fs(shape[-2]), model_if(heads_ok))
        elif leaf == "wo":
            base = (model_if(heads_ok), fs(shape[-1]))
        else:                                     # bq
            base = (model_if(heads_ok),)
    elif leaf in ("wk", "wv", "bk", "bv"):
        kv_ok = _div(cfg.n_kv_heads, tp)
        if leaf in ("wk", "wv"):
            base = (fs(shape[-2]), model_if(kv_ok))
        else:
            base = (model_if(kv_ok),)
    elif leaf in ("q_norm", "k_norm"):
        base = (None,)
    # ---- MoE (shared-expert rules precede the generic expert rule: their
    #      path also contains "moe/")
    elif "shared/" in path and leaf in ("up", "gate"):
        base = (fs(shape[-2]), model_if(_div(shape[-1], tp)))
    elif "shared/" in path and leaf == "down":
        base = (model_if(_div(shape[-2], tp)), fs(shape[-1]))
    elif "moe/" in path and leaf in ("up", "gate"):
        base = ("model", fs(shape[-2]), None)     # EP over experts
    elif "moe/" in path and leaf == "down":
        base = ("model", None, fs(shape[-1]))
    elif leaf == "router":
        base = (None, None)
    # ---- dense MLP
    elif "mlp/" in path and leaf in ("up", "gate"):
        base = (fs(shape[-2]), model_if(_div(shape[-1], tp)))
    elif "mlp/" in path and leaf == "down":
        base = (model_if(_div(shape[-2], tp)), fs(shape[-1]))
    # ---- mamba2
    elif leaf == "in_proj":
        base = (fs(shape[-2]), None)              # mixed segments: replicate
    elif leaf == "out_proj":
        base = (model_if(_div(shape[-2], tp)), fs(shape[-1]))
    elif leaf in ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm"):
        base = (None,) * min(len(shape), 2)
    # ---- rg-lru
    elif leaf in ("w_x", "w_gate"):
        base = (fs(shape[-2]), model_if(_div(cfg.lru_width, tp)))
    elif leaf in ("w_r", "w_i"):
        base = (None, model_if(_div(cfg.lru_width, tp)))
    elif leaf in ("b_r", "b_i", "lam"):
        base = (model_if(_div(cfg.lru_width, tp)),)
    elif leaf == "out":
        base = (model_if(_div(cfg.lru_width, tp)), fs(shape[-1]))
    # ---- norms & scalars
    elif leaf == "scale" or len(shape) <= 1:
        base = (None,) * min(len(shape), 1)
    else:
        base = (None,) * len(shape)

    # right-align against the leaf's rank (period-scan stacking dim etc.)
    pad = len(shape) - len(base)
    if pad < 0:
        raise ValueError(f"param_spec: {path} {shape} has fewer dims than "
                         f"its rule {base}")
    return (None,) * pad + tuple(base)


def param_shardings(params_tree, cfg: ModelConfig, mesh,
                    fsdp: bool = False):
    """A tree of specs matching ``params_tree`` (leaves with a ``shape``)."""
    sizes = axis_sizes(mesh)
    return map_with_path(lambda p, leaf: param_spec(p, leaf.shape, cfg,
                                                    sizes, fsdp),
                         params_tree)


def param_shardings_puredp(params_tree, cfg: ModelConfig, mesh):
    """Pure data-parallel + ZeRO-3 layout: no tensor parallelism, every
    parameter fully sharded across whichever axes its dims divide.
    Greedy: the largest dim takes 'data', another divisible dim takes
    'model'; dim 0 of a leaf of rank 3 or more (the period-scan stacking
    dim of the JAX tree) is skipped."""
    sizes = axis_sizes(mesh)
    return map_with_path(lambda _, leaf: puredp_spec(leaf.shape, sizes),
                         params_tree)


def puredp_spec(shape: Tuple[int, ...], mesh) -> Spec:
    """The spec ``param_shardings_puredp`` gives one leaf of ``shape``."""
    sizes = axis_sizes(mesh)
    dp = _axis_size(sizes, "data")
    tp = _axis_size(sizes, "model")
    shape = tuple(shape)
    spec = [None] * len(shape)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    used = []
    for dim in order:
        if len(spec) >= 3 and dim == 0:
            continue
        if "data" not in used and _div(shape[dim], dp):
            spec[dim] = "data"
            used.append("data")
        elif "model" not in used and _div(shape[dim], tp) \
                and spec[dim] is None:
            spec[dim] = "model"
            used.append("model")
        if len(used) == 2:
            break
    return tuple(spec)


def batch_shardings_puredp(batch_tree, mesh):
    """Batch over (pod, data, model): every device takes samples."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data", "model") if a in sizes)
    n = _prod(sizes, axes)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        bdim = 1 if (path.endswith("positions") and len(shape) == 3) else 0
        spec = [None] * len(shape)
        if _div(shape[bdim], n):
            spec[bdim] = axes
        return tuple(spec)

    return map_with_path(one, batch_tree)


# -------------------------------------------------------------- activations
def data_batch_spec(mesh, batch: int, rank: int, batch_dim: int = 0) -> Spec:
    """Batch-sharded activation spec; replicated when the batch does not
    divide the data axes (long-context batch 1)."""
    sizes = axis_sizes(mesh)
    axes = batch_axes(sizes)
    spec = [None] * rank
    if _div(batch, _prod(sizes, axes)):
        spec[batch_dim] = axes if len(axes) > 1 else axes[0]
    return tuple(spec)


def batch_shardings(batch_tree, mesh):
    """Input-batch specs: leading dim over (pod, data); M-RoPE positions
    (3, B, S) shard dim 1."""
    sizes = axis_sizes(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if path.endswith("positions") and len(shape) == 3:
            return data_batch_spec(sizes, shape[1], 3, 1)
        if not shape:
            return ()
        return data_batch_spec(sizes, shape[0], len(shape))

    return map_with_path(one, batch_tree)


# -------------------------------------------------------------- KV caches
def cache_shardings(cache_tree, cfg: ModelConfig, mesh,
                    long_context: bool = False):
    """Decode-cache specs.  Normal decode: batch over (pod, data), KV heads
    over model when divisible, else the cache sequence over model.
    Long-context (batch 1): the cache sequence over ``data`` for
    full-attention layers."""
    sizes = axis_sizes(mesh)
    tp = _axis_size(sizes, "model")
    dp = _axis_size(sizes, "data")
    kv_ok = _div(cfg.n_kv_heads, tp)
    offsets = {"conv": 3, "h": 2, "ssd": 4}

    def one(path, leaf):
        shape = tuple(leaf.shape)
        name = path.split("/")[-1]
        if name in ("k", "v", "xk", "xv"):
            b, c = shape[-4], shape[-3]
            spec = [None] * len(shape)
            bspec = data_batch_spec(sizes, b, 1, 0)[0]
            spec[-4] = bspec
            if long_context and bspec is None and _div(c, dp):
                spec[-3] = "data"
            if kv_ok:
                spec[-2] = "model"
            elif _div(c, tp) and spec[-3] is None:
                spec[-3] = "model"
            return tuple(spec)
        if name in offsets:
            bdim = len(shape) - offsets[name]
            spec = [None] * len(shape)
            spec[bdim] = data_batch_spec(sizes, shape[bdim], 1, 0)[0]
            if name == "h" and _div(shape[-1], tp):
                spec[-1] = "model"               # recurrent width
            if name == "ssd" and _div(shape[-3], tp):
                spec[-3] = "model"               # SSD heads
            return tuple(spec)
        return (None,) * len(shape)

    return map_with_path(one, cache_tree)


def replicated(mesh) -> Spec:
    """The spec of a leaf held whole on every device."""
    return ()


# -------------------------------------------------------------- DTensor
def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``):
    ``Shard(dim)`` on each mesh dim that names tensor dim ``dim``,
    ``Replicate()`` on the others.  A dim sharded over several mesh dims
    (``("pod", "data")``) is split by them in mesh-dim order, the first
    the major one, which is the order of the spec's tuple in JAX; a tuple
    in another order raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: {axes} is not in the mesh's "
                             f"dim order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out
