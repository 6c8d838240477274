"""Model size reporting (port of ``repro.core.metrics.model_size_bytes``).

Only the dense accounting is ported: it is what ``launch/serve`` prints.
The CSR accounting (``sparse=True``) comes with the training slice.
"""
from __future__ import annotations

import torch


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (the order JAX flattens
    a dict pytree in)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def model_size_bytes(params) -> int:
    """Dense model size: every leaf's elements times its item size."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(params)
               if isinstance(t, torch.Tensor))
