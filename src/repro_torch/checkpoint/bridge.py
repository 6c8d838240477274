"""Carry weights across to the port: numpy trees -> torch params on a device.

Two inputs are accepted, both plain numpy (no JAX object crosses over):
  * a dense param tree: nested dicts of arrays, in the reference's layout;
  * a compressed model: the dense residue as such a tree, plus the sparse
    map with every BlockCSR / PaletteBCSR leaf given as a dict of its
    array fields and its metadata (``shape``, ``block``, ``n_blocks`` and,
    for a palette leaf, ``bits``) -- the same shape as a checkpoint
    manifest entry. A leaf with ``codes`` is a PaletteBCSR.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.sparse.compress import CompressedParams, CompressionPlan
from repro_torch.sparse.formats import BlockCSR, PaletteBCSR

_META = ("shape", "block", "n_blocks", "bits")


def _tensor(a, device) -> torch.Tensor:
    # torch shares the buffer: copy when it is read-only or not contiguous
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)


def _dense_from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _dense_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree), device)


def params_from_numpy(tree, device=None) -> dict:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (default ``cuda``)."""
    return _dense_from_numpy(tree, resolve_device(device))


def _is_format_dict(node) -> bool:
    return isinstance(node, dict) and "gather_idx" in node and "shape" in node


def format_from_fields(fields: dict, device=None):
    """One BlockCSR / PaletteBCSR from its array fields plus metadata."""
    device = resolve_device(device)
    cls = PaletteBCSR if "codes" in fields else BlockCSR
    kw = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        if f.name in ("shape", "block"):
            kw[f.name] = tuple(int(i) for i in v)
        elif f.name in _META:
            kw[f.name] = int(v)
        else:
            kw[f.name] = _tensor(np.asarray(v), device)
    return cls(**kw)


def _sparse_from_numpy(tree, device):
    if _is_format_dict(tree):
        return format_from_fields(tree, device)
    return {k: _sparse_from_numpy(v, device) for k, v in tree.items()}


def compressed_from_numpy(dense, sparse, plan: Optional[CompressionPlan] = None,
                          device=None) -> CompressedParams:
    """A ``CompressedParams`` on ``device`` (default ``cuda``) from a
    numpy residue and sparse map."""
    device = resolve_device(device)
    return CompressedParams(dense=_dense_from_numpy(dense, device),
                            sparse=_sparse_from_numpy(sparse, device),
                            plan=plan or CompressionPlan())


def plan_from_json(spec: Optional[dict]) -> CompressionPlan:
    """A ``CompressionPlan`` from its JSON form (a checkpoint's
    ``extra['plan']``); missing quantization fields take their defaults."""
    if not spec:
        return CompressionPlan()
    return CompressionPlan(
        block=tuple(spec["block"]),
        min_sparsity=spec["min_sparsity"],
        min_size=spec["min_size"],
        overrides=tuple((s, tuple(b)) for s, b in spec["overrides"]),
        quantize_bits=spec.get("quantize_bits"),
        quantize_overrides=tuple(
            (s, int(b)) for s, b in spec.get("quantize_overrides", ())),
        slot_multiple=spec.get("slot_multiple"))
