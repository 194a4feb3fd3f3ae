"""Nested containers of tensors ("trees"), as the port's training modules
use them in place of ``jax.tree_util``.

A tree is a tensor (a leaf), a dict, a list or tuple, a NamedTuple or
None (no leaves).  Leaves come in the order ``jax.tree_util`` gives them:
dict keys sorted, sequences and NamedTuple fields in order.  A leaf's
name is the one ``jax.tree_util.keystr`` gives its path (``[0]['embed']
['tok']``, ``[1].mu['w']``), so that both packages name a checkpoint's
leaves alike.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_names(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(name, leaf)] in ``jax.tree_util`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_names(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten_with_names(getattr(tree, f),
                                             f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_names(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_names(tree)]


def map_tree(fn: Callable, tree: Any) -> Any:
    """The same structure with ``fn`` applied to every leaf."""
    return map_with_names(lambda _, leaf: fn(leaf), tree)


def map_with_names(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """The same structure with ``fn(name, leaf)`` in place of every leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_names(fn, getattr(tree, f),
                                           f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_names(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def leaves_like(tree: Any, template: Any) -> List[Any]:
    """The parts of ``tree`` at the places of ``template``'s leaves, in
    ``leaves(template)`` order: ``tree`` is walked along ``template``'s
    structure, so that its parts may themselves be containers (a leaf's
    DTensor placements, a list)."""
    if template is None:
        return []
    if isinstance(template, dict):
        return [x for k in sorted(template)
                for x in leaves_like(tree[k], template[k])]
    if _is_namedtuple(template):
        return [x for f in template._fields
                for x in leaves_like(getattr(tree, f), getattr(template, f))]
    if isinstance(template, (list, tuple)):
        return [x for i, t in enumerate(template)
                for x in leaves_like(tree[i], t)]
    return [tree]


_TOKEN = re.compile(r"\[(\d+)\]|\['((?:[^'\\]|\\.)*)'\]|\.(\w+)")


def name_parts(name: str) -> List[Any]:
    """The steps of a leaf's name (as ``flatten_with_names`` gives it):
    an int for a sequence index, a str for a dict key, ".field" for a
    NamedTuple field."""
    parts, pos = [], 0
    for m in _TOKEN.finditer(name):
        if m.start() != pos:
            raise ValueError(f"cannot parse the leaf name {name!r}")
        pos = m.end()
        parts.append(int(m.group(1)) if m.group(1) is not None
                     else (m.group(2) if m.group(2) is not None
                           else "." + m.group(3)))
    if pos != len(name) or not parts:
        raise ValueError(f"cannot parse the leaf name {name!r}")
    return parts


def nest_by_name(named: Dict[str, Any]) -> Any:
    """Rebuild a tree from ``{name: leaf}`` (names as
    ``flatten_with_names`` gives them): string keys and fields become
    dicts, integer indices lists.  A list or dict that had no leaves
    leaves no name, so it is absent from the result."""
    root: Dict = {}
    for name, leaf in named.items():
        toks = [t[1:] if isinstance(t, str) and t.startswith(".") else t
                for t in name_parts(name)]
        node = root
        for t in toks[:-1]:
            node = node.setdefault(t, {})
        node[toks[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            if sorted(out) != list(range(len(out))):
                raise ValueError("nest_by_name: indices with gaps")
            return [out[i] for i in range(len(out))]
        return out
    return lists(root)

