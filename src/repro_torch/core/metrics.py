"""Compression-rate and model-size reporting (port of
``repro.core.metrics``): compression_rate = #zeros / #total over the
regularized leaves; the paper's 'x' factor is total / nnz.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core.prox import default_regularized_predicate
from repro_torch.core.tree import flatten_with_path, keystr

PyTree = Any


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (the order JAX flattens
    a dict pytree in)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def layer_compression(params: PyTree,
                      predicate: Optional[Callable] = None) -> dict[str, dict]:
    """Per-leaf nnz / total table (the paper's Tables A1-A4)."""
    predicate = predicate or default_regularized_predicate
    table: dict[str, dict] = {}
    for keys, leaf in flatten_with_path(params):
        name = keystr(keys)
        if not predicate(name, leaf):
            continue
        nnz = int(torch.count_nonzero(leaf))
        total = int(leaf.numel())
        table[name] = {"nnz": nnz, "total": total,
                       "compression_rate": 1.0 - nnz / total,
                       "x_factor": (total / nnz) if nnz else float("inf")}
    return table


def total_compression(params: PyTree,
                      predicate: Optional[Callable] = None) -> dict:
    table = layer_compression(params, predicate)
    nnz = sum(v["nnz"] for v in table.values())
    total = sum(v["total"] for v in table.values())
    return {"nnz": nnz, "total": total,
            "compression_rate": 1.0 - nnz / max(total, 1),
            "x_factor": (total / nnz) if nnz else float("inf")}


def compression_rate(params: PyTree,
                     predicate: Optional[Callable] = None) -> float:
    return total_compression(params, predicate)["compression_rate"]


def format_table(table: dict[str, dict], title: str = "") -> str:
    lines = [title] if title else []
    lines.append(f"{'layer':48s} {'nnz/total':>24s} {'rate':>8s} {'x':>8s}")
    for k, v in table.items():
        x = v["x_factor"]
        xs = f"{x:.0f}x" if x != float("inf") else "inf"
        lines.append(f"{k:48s} {v['nnz']:>11d}/{v['total']:<12d} "
                     f"{100*v['compression_rate']:7.2f}% {xs:>8s}")
    return "\n".join(lines)


def model_size_bytes(params, sparse: bool = False,
                     index_bytes: int = 4) -> int:
    """Dense vs CSR-compressed model size (the paper's Table 3 'Model
    Size').

    Dense: every leaf's elements times its item size; no value is read, so
    params on the meta device will do (``launch/serve``'s size line).
    ``sparse=True`` follows the CSR accounting: nnz * (value + column
    index) + (rows + 1) * row pointer per regularized leaf
    (``default_regularized_predicate``); other leaves stay dense."""
    total = 0
    for keys, leaf in flatten_with_path(params):
        if not isinstance(leaf, torch.Tensor):
            continue
        itemsize = leaf.element_size()
        if sparse and default_regularized_predicate(keystr(keys), leaf):
            nnz = int(torch.count_nonzero(leaf))
            rows = leaf.shape[0] if leaf.dim() >= 1 else 1
            total += nnz * (itemsize + index_bytes) + (rows + 1) * index_bytes
        else:
            total += leaf.numel() * itemsize
    return total
