"""Checkpointing: atomic and manifest-based; PyTorch port of
``repro.train.checkpoint``, with the same files on disk.

Layout:  <dir>/step-<N>/leaf-<i>.npy + manifest.json, written to a temp
dir and atomically renamed (a crash mid-save never corrupts the latest
checkpoint); <dir>/LATEST names the newest complete step.  Each leaf file
holds the leaf's raw bytes as a flat uint8 array and the manifest its
name (``jax.tree_util.keystr`` of its path), file, shape and dtype name,
so the same tree saved by either package gives the same files (a tree
of DTensors too: rank 0 writes each leaf whole).  bfloat16
has no numpy dtype: its bytes are written through an int16 view under the
name ``"bfloat16"`` and read back the same way, without ``ml_dtypes``.

``restore`` takes a template tree (for its structure and shapes) and a
device, or, for an elastic rescale, a mesh and each leaf's DTensor
placements on it (``shardings``: every leaf is read whole and placed with
``distribute_tensor``, so a rank keeps its shard).  ``read_numpy``
returns a checkpoint as {name: ndarray}, the form
``models.convert.state_from_checkpoint`` takes to carry a checkpoint of the
JAX trainer into the port.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.parallel import dtensor as dt
from repro_torch.train import tree as T


def _as_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(an array with the leaf's bytes, its dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any, tag: str = "state") -> str:
    """Atomic save.  Returns the final checkpoint path.  A tree with
    DTensor leaves (the mesh path) is saved by every rank of their mesh
    together: each such leaf is gathered whole and rank 0 writes every
    file, so the files are those of the unsharded tree; the ranks meet at
    a barrier after the write."""
    named = T.flatten_with_names(tree)
    sharded = any(dt.is_dt(leaf) for _, leaf in named)
    writer = not sharded or dist.get_rank() == 0
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".tmp-ckpt-", dir=ckpt_dir)
    manifest = {"step": step, "tag": tag, "leaves": []}
    try:
        for i, (name, leaf) in enumerate(named):
            if dt.is_dt(leaf):
                leaf = leaf.full_tensor()      # a collective: every rank
            if not writer:
                continue
            arr, dtype = _as_numpy(leaf)
            shape = list(arr.shape)            # before ascontiguousarray
            arr = np.ascontiguousarray(arr)    # (promotes 0-d to 1-d)
            fn = f"leaf-{i:05d}.npy"
            np.save(os.path.join(tmp, fn), arr.view(np.uint8).reshape(-1))
            manifest["leaves"].append(
                {"name": name, "file": fn, "shape": shape, "dtype": dtype})
        if writer:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
    except BaseException:
        if writer:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    if writer:
        with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
                   os.path.join(ckpt_dir, "LATEST"))
    if sharded:
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        step = int(f.read().strip())
    if os.path.exists(os.path.join(ckpt_dir, f"step-{step:08d}",
                                   "manifest.json")):
        return step
    return None


def _open(ckpt_dir: str, step: Optional[int]):
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step-{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    return d, {m["name"]: m for m in manifest["leaves"]}, step


def _load(d: str, m: Dict) -> torch.Tensor:
    """One leaf as a CPU tensor of its manifest dtype and shape."""
    raw = np.load(os.path.join(d, m["file"]))
    if m["dtype"] == "bfloat16":
        t = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw.view(np.dtype(m["dtype"])).copy())
    return t.reshape(m["shape"])


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None,
            device="cuda", shardings=None) -> Tuple[Any, int]:
    """Load a checkpoint into the structure of ``template`` (a tree whose
    leaves have a ``shape``), on ``device``.  Returns (tree, step).

    ``shardings``, if given, is (mesh, placements): a ``DeviceMesh`` and a
    tree of ``template``'s structure whose leaves are DTensor placement
    lists (as ``manual_dp.build`` returns them); every leaf then comes
    back as a DTensor on ``mesh``'s device type, placed so (each rank of
    the mesh calls ``restore``), and ``device`` is not read."""
    d, by_name, step = _open(ckpt_dir, step)
    if shardings is None:
        dev, place = resolve_device(device), None
    else:
        from torch.distributed.tensor import distribute_tensor
        mesh, placements = shardings
        dev = resolve_device(mesh.device_type)
        place = dict(zip((n for n, _ in T.flatten_with_names(template)),
                         T.leaves_like(placements, template)))

    def leaf(name, tmpl):
        t = _load(d, by_name[name])
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"{name}: ckpt {tuple(t.shape)} != "
                             f"{tuple(tmpl.shape)}")
        t = t.to(dev)
        return t if place is None else distribute_tensor(t, mesh,
                                                         place[name])
    return T.map_with_names(leaf, template), step


def read_numpy(ckpt_dir: str, step: Optional[int] = None
               ) -> Dict[str, np.ndarray]:
    """{leaf name: array} of a checkpoint; bfloat16 leaves come back as
    float32 (exactly)."""
    d, by_name, _ = _open(ckpt_dir, step)
    out = {}
    for name, m in by_name.items():
        t = _load(d, m)
        out[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out
