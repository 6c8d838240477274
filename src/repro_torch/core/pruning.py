"""Pru baseline: magnitude pruning + retraining (Han et al. 2015, paper
section 4; port of ``repro.core.pruning``).

Pipeline (as the paper evaluates it):
  1. train the dense reference model,
  2. threshold: zero every regularized weight with |w| below a per-layer
     threshold chosen from a quality parameter q (threshold = q * std(w),
     Han et al.'s rule) OR from a target global sparsity,
  3. optional retraining with the zero mask frozen (Pru(Retrain)).

Step 3 reuses the debias machinery (``core.masks`` + the optimizer's mask
argument), so Pru and SpC(Retrain) share one code path. Thresholds are
computed on the params' own device; nothing is copied to the host.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core.prox import default_regularized_predicate, hard_threshold
from repro_torch.core.tree import flatten_with_path, keystr, map_with_keystr

PyTree = Any


def magnitude_prune_std(params: PyTree, quality: float,
                        predicate: Optional[Callable] = None) -> PyTree:
    """Han et al. rule: per-layer threshold = quality * std(layer), the
    population std (``jnp.std``'s ddof 0)."""
    predicate = predicate or default_regularized_predicate

    def prune(name, leaf):
        if not predicate(name, leaf):
            return leaf
        tau = quality * torch.std(leaf.float(), correction=0)
        return hard_threshold(leaf, tau)

    return map_with_keystr(prune, params)


def magnitude_prune_global(params: PyTree, sparsity: float,
                           predicate: Optional[Callable] = None) -> PyTree:
    """Zero the smallest-|w| fraction ``sparsity`` across all regularized
    leaves: the threshold is the sorted concatenated |w| at index
    ``int(sparsity * size)`` clipped to ``size - 1``, and a weight is kept
    where |w| is strictly above it."""
    predicate = predicate or default_regularized_predicate
    mags = [leaf.float().abs().reshape(-1)
            for keys, leaf in flatten_with_path(params)
            if predicate(keystr(keys), leaf)]
    if not mags:
        return params
    allmag = torch.cat(mags)
    # the reference casts sparsity * size to int32, truncating toward zero
    k = min(max(int(sparsity * allmag.numel()), 0), allmag.numel() - 1)
    tau = torch.sort(allmag).values[k]
    return map_with_keystr(
        lambda name, leaf: hard_threshold(leaf, tau) if predicate(name, leaf)
        else leaf, params)
