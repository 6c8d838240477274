"""Nested-dict parameter trees: flatten with paths, map, rebuild.

The port keeps params, grads and optimizer moments as nested dicts of
tensors. These helpers walk them in sorted-key order, the order JAX
flattens a dict pytree in, and name each leaf by JAX's ``keystr`` form
(``"['layers']['b0_attn']['mlp']['wi']"``), which the regularizer
predicates and ``sparse.compress.make_plan_prox`` parse.
"""
from __future__ import annotations

import re
from typing import Any, Callable

PyTree = Any


def keystr(keys) -> str:
    return "".join(f"[{k!r}]" for k in keys)


def keypath(path: str) -> str:
    """The keystr "['layers']['b0_attn']['mlp']['wi']" as the path
    "layers/b0_attn/mlp/wi"."""
    return "/".join(re.findall(r"\['([^']+)'\]", path))


def flatten_with_path(tree: PyTree) -> list:
    """[(keys tuple, leaf)] in sorted-key order. ``None`` is an empty
    subtree, as in JAX."""
    out: list = []

    def walk(node, keys):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], keys + (k,))
            return
        out.append((keys, node))

    walk(tree, ())
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Map ``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same nesting)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def map_with_keystr(fn: Callable, tree: PyTree, *rest: PyTree,
                    _keys: tuple = ()) -> PyTree:
    """As ``tree_map``, with the leaf's ``keystr`` as first argument."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_keystr(fn, tree[k], *(r[k] for r in rest),
                                   _keys=_keys + (k,))
                for k in tree}
    return fn(keystr(_keys), tree, *rest)


def unflatten_like(like: PyTree, flat: list) -> PyTree:
    """A tree shaped like ``like`` with the leaves ``flat``, in the order
    ``flatten_with_path`` gives."""
    it = iter(flat)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    return walk(like)
