"""Logical-axis placement rules (DP / FSDP / TP / EP) on a rank mesh.

Port of ``repro.distributed.sharding``. Params get logical axes from
path-based rules (``param_logical_axes``); a mesh maps logical axes to
mesh axes ("pod", "data", "model") with the reference's two-pass
divisibility rule: an axis that does not divide replicates, which is what
makes e.g. 15 heads run on a model axis of 2.

    batch              -> ("pod", "data")   data parallelism
    heads/kv/mlp/
    vocab/experts/lru  -> "model"           tensor / expert parallelism
    embed (params)     -> "data"            FSDP weight sharding

A compressed (BlockCSR / PaletteBCSR) leaf splits like its dense
counterpart's OUTPUT dim: by contiguous block rows
(``sparse.formats.split_rows``), each rank's part a self-contained store.
The reference tests the slot count for divisibility; the port tests the
block-row count, which is what a row split must divide.

``shard_params(full, mesh)`` gives this rank its part of a full tree and
records each leaf's placement on the mesh (``mesh.layout``), where the
model (``distributed.parallel``), the train step and the prox read it;
``gather_params(local, mesh)`` is the reverse. A spec is a tuple with one
entry per dim: None, a mesh axis name, or a tuple of names.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.tree import keystr
from repro_torch.sparse.compress import CompressedParams
from repro_torch.sparse.formats import (compact_rows, is_bcsr, join_rows,
                                        join_tables, split_rows)

PyTree = Any

ACT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "capacity": "data",
    "cache_seq": "model",
    "lru": "model",
    "rwkv_heads": "model",
    "conv": None,
    "res_seq": "model",
    "seq_fb": "model",
}

_FALLBACK_AXES = {"seq_fb"}

PARAM_RULES: dict[str, Any] = {
    "layers": None,
    "embed": "data",          # FSDP axis for weight matrices
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "lru": "model",
    "rwkv_heads": "model",
    "lora": None,
    "conv": None,
    "none": None,
    # lets square (d, d) matrices shard their output dim over model
    "embed2": "model",
}

_MESH: Optional[Any] = None


@contextlib.contextmanager
def use_mesh(mesh):
    """Context under which the model runs its collectives on ``mesh``."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def current_mesh():
    return _MESH


def _axes_to_spec(logical: Sequence[Optional[str]], shape, mesh,
                  rules: dict) -> tuple:
    """Two-pass assignment: primary logical axes claim mesh axes first;
    fallback axes (seq_fb) only take what remains unclaimed. Reads only
    ``mesh.shape``."""
    taken: set[str] = set()
    spec: list = [None] * len(logical)

    def assign(i, dim, ax):
        phys = rules.get(ax) if ax else None
        if phys is None:
            return
        phys_t = (phys,) if isinstance(phys, str) else tuple(phys)
        phys_t = tuple(a for a in phys_t if a in mesh.shape and a not in taken)
        size = 1
        for a in phys_t:
            size *= mesh.shape[a]
        if phys_t and dim % size == 0 and dim > 0:
            spec[i] = phys_t if len(phys_t) > 1 else phys_t[0]
            taken.update(phys_t)

    for i, (dim, ax) in enumerate(zip(shape, logical)):
        if ax not in _FALLBACK_AXES:
            assign(i, dim, ax)
    for i, (dim, ax) in enumerate(zip(shape, logical)):
        if ax in _FALLBACK_AXES:
            assign(i, dim, ax)
    return tuple(spec)


# ---------------------------------------------------------------------------
# Param logical axes by path pattern (matched against keystr paths, first
# hit wins; a leading "layers" axis is added for stacked leaves)
# ---------------------------------------------------------------------------

_PARAM_PATTERNS: list[tuple[str, tuple]] = [
    (r"embedding",                ("vocab", "embed")),
    (r"head",                     ("embed", "vocab")),
    (r"\bwq\b|'wq'",              ("embed", "heads", "head_dim")),
    (r"'wk'|'wv'",                ("embed", "kv_heads", "head_dim")),
    (r"'wo'",                     ("heads", "head_dim", "embed")),
    (r"'wi'|'wg'",                ("embed", "mlp")),
    (r"'w_down'",                 ("mlp", "embed")),
    (r"router",                   ("embed", "experts")),
    (r"experts.*'wi'|'ewi'|'ewg'", ("experts", "embed", "mlp")),
    (r"'ewo'",                    ("experts", "mlp", "embed")),
    (r"conv1d",                   ("conv", "lru")),
    (r"lru_in|lru_gate",          ("embed", "lru")),
    (r"lru_out",                  ("lru", "embed")),
    (r"rwkv_(r|k|v|g)",           ("embed", "embed2")),
    (r"rwkv_o",                   ("embed2", "embed")),
    (r"cm_(k)",                   ("embed", "mlp")),
    (r"cm_(v)",                   ("mlp", "embed")),
    (r"cm_(r)",                   ("embed", "embed2")),
    (r"lora_(a|b)",               ("lora", "lora")),
]


def _leaf_axes(path: str, leaf) -> tuple:
    ndim = len(leaf.shape)
    for pat, axes in _PARAM_PATTERNS:
        if re.search(pat, path):
            if len(axes) == ndim:
                return axes
            if len(axes) == ndim - 1:
                return ("layers",) + axes      # stacked
    return tuple([None] * ndim)


def param_logical_axes(params) -> Any:
    """The logical axes of every leaf of a dense param tree."""
    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        return _leaf_axes(keystr(keys), node)
    return walk(params, ())


# Leaf name -> logical axis of a compressed leaf's (out, in) row dim,
# matched against keystr paths and split_trainable's "<path>" keys.
_BCSR_ROW_PATTERNS: list[tuple[str, str]] = [
    (r"\bwq\b|\bwk\b|\bwv\b",                         "heads"),
    (r"\bewi\b|\bewg\b|\bwi\b|\bwg\b|\bcm_k\b",       "mlp"),
    (r"\bewo\b|\bwo\b|\bcm_v\b|\brwkv_o\b|\blru_out\b", "embed"),
    (r"\brwkv_[rkvg]\b|\bcm_r\b",                     "embed2"),
    (r"\blru_in\b|\blru_gate\b",                      "lru"),
    (r"\bhead\b",                                     "vocab"),
]


def _bcsr_logical(path: str) -> Optional[str]:
    for pat, ax in _BCSR_ROW_PATTERNS:
        if re.search(pat, path):
            return ax
    return None


def bcsr_row_axis(path: str, block_rows: int, mesh,
                  rules: Optional[dict] = None):
    """Mesh axis of a compressed leaf's block rows (None: replicated): the
    dense out-dim rule of its path, kept only where ``block_rows``
    divides."""
    return _axes_to_spec([_bcsr_logical(path)], (block_rows,), mesh,
                         rules or PARAM_RULES)[0]


def _dense_spec(path: str, shape, mesh) -> tuple:
    return _axes_to_spec(_leaf_axes(path, torch.empty(shape, device="meta")),
                         tuple(shape), mesh, PARAM_RULES)


def param_specs(params, mesh) -> Any:
    """The spec of every leaf of a full tree on ``mesh``: a per-dim tuple
    for a tensor, the block-row axis for a compressed leaf."""
    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        path = keystr(keys)
        if is_bcsr(node):
            return bcsr_row_axis(path, node.block_grid[0], mesh)
        return _dense_spec(path, tuple(node.shape), mesh)
    if isinstance(params, CompressedParams):
        return CompressedParams(dense=walk(params.dense, ()),
                                sparse=walk(params.sparse, ()),
                                plan=params.plan)
    return walk(params, ())


# ---------------------------------------------------------------------------
# Decode-cache logical axes (the port keeps its pools replicated over
# "model"; these are the reference's rules, for placement reports)
# ---------------------------------------------------------------------------

_CACHE_PATTERNS: list[tuple[str, tuple]] = [
    (r"'k_scale'|'v_scale'",
     ("batch", "cache_seq", "kv_heads", "head_dim")),
    (r"'k'|'v'",   ("batch", "cache_seq", "kv_heads", "head_dim")),
    (r"'S'",       ("batch", "rwkv_heads", "head_dim", "head_dim2")),
    (r"'shift'",   ("batch", "embed")),
    (r"'h'",       ("batch", "lru")),
    (r"'conv'",    ("batch", "conv", "lru")),
]


def _cache_leaf_axes(path: str, leaf) -> tuple:
    ndim = len(leaf.shape)
    for pat, axes in _CACHE_PATTERNS:
        if re.search(pat, path):
            if len(axes) == ndim:
                return axes
            if len(axes) == ndim - 1:
                return ("layers",) + axes
    return tuple([None] * ndim)


def cache_specs(cache, mesh) -> Any:
    rules = dict(ACT_RULES)
    rules.update({"layers": None, "head_dim2": None})

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        return _axes_to_spec(_cache_leaf_axes(keystr(keys), node),
                             tuple(node.shape), mesh, rules)
    return walk(cache, ())


# ---------------------------------------------------------------------------
# Placement: full tree -> this rank's part, and back
# ---------------------------------------------------------------------------

def _split_dim(t: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    n = mesh.axis_size(axes)
    return t.chunk(n, dim)[mesh.axis_index(axes)]


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.require(np.asarray(x),
                                       requirements=["C", "W"])).to(device)


def _is_format_dict(node) -> bool:
    return isinstance(node, dict) and "gather_idx" in node and "shape" in node


def _to_formats(tree, device):
    """numpy BlockCSR field dicts (the bridge's form) as formats."""
    from repro_torch.checkpoint.bridge import format_from_fields
    if _is_format_dict(tree):
        return format_from_fields(tree, device)
    if isinstance(tree, dict):
        return {k: _to_formats(v, device) for k, v in tree.items()}
    return tree


def shard_params(full: PyTree, mesh) -> PyTree:
    """This rank's part of ``full`` (a dense tree or a
    ``CompressedParams``, its leaves tensors or numpy arrays, numpy
    compressed leaves as the bridge's field dicts), copied to the mesh's
    device. Each leaf's spec is recorded in ``mesh.layout``."""
    dev = mesh.device

    def dense(node, keys):
        if isinstance(node, dict):
            return {k: dense(v, keys + (k,)) for k, v in node.items()}
        t = _as_tensor(node, dev)
        spec = _dense_spec(keystr(keys), tuple(t.shape), mesh)
        mesh.layout[("dense", "/".join(keys), t.dim())] = spec
        for i, axes in enumerate(spec):
            if axes is not None:
                t = _split_dim(t, i, axes, mesh)
        # a copy: the steps update a rank's part in place
        return t.clone(memory_format=torch.contiguous_format)

    def sparse(node, keys):
        if isinstance(node, dict):
            return {k: sparse(v, keys + (k,)) for k, v in node.items()}
        path = "/".join(keys)
        axes = bcsr_row_axis(keystr(keys), node.block_grid[0], mesh)
        mesh.layout[("bcsr", path)] = axes
        if axes is not None:
            shards = split_rows(node, mesh.axis_size(axes))
            if axes != "model":
                # stored split: joined for use (distributed.parallel), with
                # the tables of the whole joined here once
                mesh.layout[("joined", path)] = {
                    k: v.to(dev) if isinstance(v, torch.Tensor) else v
                    for k, v in join_tables(shards).items()}
            node = shards[mesh.axis_index(axes)]
        return node.map(lambda t: t.to(dev, copy=True))

    if isinstance(full, CompressedParams):
        return CompressedParams(dense=dense(full.dense, ()),
                                sparse=sparse(_to_formats(full.sparse, dev),
                                              ()),
                                plan=full.plan)
    return dense(full, ())


def leaf_spec(mesh, path: str, leaf) -> tuple:
    """The recorded per-dim spec of a local leaf at ``path`` ("a/b/c"):
    a dense leaf by its path; ``dense/<p>`` and ``bcsr_data/<p>`` of
    ``split_trainable``'s tree by ``p``, a block store split on its slot
    axis. A leaf with no record is replicated."""
    ndim = leaf.dim()
    root, _, rest = path.partition("/")
    if root == "bcsr_data":
        axes = mesh.layout.get(("bcsr", rest))
        spec = [None] * ndim
        spec[ndim - 3] = axes
        return tuple(spec)
    if root == "dense" and ("dense", rest, ndim) in mesh.layout:
        path = rest
    return mesh.layout.get(("dense", path, ndim), (None,) * ndim)


def _gather_dim(t: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    from repro_torch.distributed import parallel
    return parallel.all_gather_cat(t, dim, mesh.group(
        (axes,) if isinstance(axes, str) else tuple(axes)))


def gather_bcsr(m, axes, mesh):
    """The whole store of a leaf split by block rows over ``axes``: every
    array field of every shard gathered, joined and compacted."""
    from repro_torch.distributed import parallel
    group = mesh.group((axes,) if isinstance(axes, str) else tuple(axes))
    n = mesh.axis_size(axes)
    fields = {f.name: parallel.all_gather_list(getattr(m, f.name), group)
              for f in dataclasses.fields(m)
              if isinstance(getattr(m, f.name), torch.Tensor)}
    shapes = [None] * n
    dist.all_gather_object(shapes, m.shape, group=group)
    shards = [dataclasses.replace(m, shape=tuple(shapes[j]),
                                  **{k: v[j] for k, v in fields.items()})
              for j in range(n)]
    return compact_rows(join_rows(shards))


def gather_params(local: PyTree, mesh) -> PyTree:
    """The full tree from every rank's part (a collective: every rank
    calls it and gets the whole tree), compressed leaves compacted."""
    def dense(node, keys):
        if isinstance(node, dict):
            return {k: dense(v, keys + (k,)) for k, v in node.items()}
        spec = leaf_spec(mesh, "/".join(keys), node)
        for i, axes in enumerate(spec):
            if axes is not None:
                node = _gather_dim(node, i, axes, mesh)
        return node

    def sparse(node, keys):
        if isinstance(node, dict):
            return {k: sparse(v, keys + (k,)) for k, v in node.items()}
        axes = mesh.layout.get(("bcsr", "/".join(keys)))
        return node if axes is None else gather_bcsr(node, axes, mesh)

    if isinstance(local, CompressedParams):
        return CompressedParams(dense=dense(local.dense, ()),
                                sparse=sparse(local.sparse, ()),
                                plan=local.plan)
    return dense(local, ())


def _state_map(fn, tree):
    """``fn`` on each param-shaped part of a ``TrainState`` (params,
    moments, mask), or on the tree itself."""
    from repro_torch.core.optimizers import ProxState
    from repro_torch.train.state import TrainState
    if isinstance(tree, TrainState):
        o = tree.opt_state
        return TrainState(
            params=fn(tree.params),
            opt_state=ProxState(step=o.step, m=fn(o.m), v=fn(o.v)),
            mask=None if tree.mask is None else fn(tree.mask),
            step=tree.step)
    return fn(tree)


def shard_state(full, mesh):
    """``shard_params`` of a tree or of each part of a ``TrainState``."""
    return _state_map(lambda t: shard_params(t, mesh), full)


def gather_state(local, mesh):
    """``gather_params`` of a tree or of each part of a ``TrainState``."""
    return _state_map(lambda t: gather_params(t, mesh), local)


def on_whole_leaf(fn, t: torch.Tensor, path: str, mesh) -> torch.Tensor:
    """``fn`` of the whole leaf of which ``t`` is this rank's part, cut
    back to this rank's part."""
    spec = leaf_spec(mesh, path, t)
    split = [(i, axes) for i, axes in enumerate(spec)
             if axes is not None and mesh.axis_size(axes) > 1]
    if not split:
        return fn(t)
    whole = t
    for i, axes in split:
        whole = _gather_dim(whole, i, axes, mesh)
    out = fn(whole)
    for i, axes in split:
        out = _split_dim(out, i, axes, mesh)
    return out
