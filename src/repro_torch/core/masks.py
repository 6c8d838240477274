"""Zero masks for debiasing (paper section 2.4, port of ``repro.core.masks``).

Debiasing retrains the surviving weights with the zero pattern frozen:
``mask = (w != 0)`` multiplies the grads before and the params after each
optimizer step.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core.prox import default_regularized_predicate
from repro_torch.core.metrics import tree_leaves
from repro_torch.core.tree import map_with_keystr, tree_map

PyTree = Any


def zero_mask(params: PyTree, predicate: Optional[Callable] = None) -> PyTree:
    """f32 mask leaf: 1 where the weight is nonzero, or everywhere for a
    leaf the predicate does not regularize."""
    predicate = predicate or default_regularized_predicate
    return map_with_keystr(
        lambda name, leaf: (leaf != 0).float() if predicate(name, leaf)
        else torch.ones_like(leaf, dtype=torch.float32), params)


def apply_mask(params: PyTree, mask: PyTree) -> PyTree:
    return tree_map(lambda p, m: p * m.to(p.dtype), params, mask)


def mask_density(mask: PyTree) -> torch.Tensor:
    """Fraction of kept entries across the mask's leaves."""
    ms = tree_leaves(mask)
    return sum(m.sum() for m in ms) / sum(m.numel() for m in ms)
