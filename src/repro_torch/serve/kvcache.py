"""Serving-side cache utilities."""
from __future__ import annotations

from repro_torch.core.metrics import tree_leaves


def cache_bytes(cache) -> int:
    """Bytes held by a cache tree (``Model.init_cache``)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(cache))
