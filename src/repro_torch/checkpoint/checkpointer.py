"""Checkpointer: the JAX package's checkpoint format, written and read.

Port of ``repro.checkpoint.checkpointer``. The format, byte-compatible
both ways (the JAX ``Checkpointer`` reads what the port writes, and the
port reads what JAX writes):
  * ``<dir>/step_NNNNNNNNN/manifest.json``: ``step``, ``time``, ``extra``
    (for a compressed model: ``plan``, ``arch``, ``reduced``) and
    ``leaves``, one entry per leaf: ``name``, ``format`` in dense | csr |
    bcsr | palette_bcsr, ``shape``, ``dtype``, and for compressed leaves
    ``block``, ``n_blocks`` and ``bits``;
  * ``arrays.npz``: one array per dense leaf; ``<name>__<field>`` per
    BlockCSR / PaletteBCSR field; ``<name>__data|indices|indptr`` per CSR
    leaf. A ``/`` in a name is stored as ``|``.
Leaf names join the tree keys with ``/``: ``params/...``,
``opt_state/step``, ``opt_state/m/...``, ``opt_state/v/...``, ``mask/...``
and ``step`` for a ``TrainState``; ``dense/...`` and ``sparse/...`` for a
``CompressedParams``.

Writes are atomic (a temporary directory, then ``os.replace``); the
newest ``keep_n`` checkpoints are kept. A regularized 2D dense leaf that is
at least 70% zero is stored as elementwise CSR (densified on restore);
BlockCSR and PaletteBCSR leaves are stored verbatim and restore without
densifying.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.bridge import (compressed_from_numpy,
                                           format_from_fields, plan_from_json)
from repro_torch.core.optimizers import ProxState
from repro_torch.core.prox import default_regularized_predicate
from repro_torch.sparse.compress import CompressedParams
from repro_torch.sparse.formats import PaletteBCSR, dense_to_csr, is_bcsr
from repro_torch.train.state import TrainState

PyTree = Any
_SPARSE_THRESHOLD = 0.7      # store CSR when >= 70% zero
_INDEX_FIELDS = ("col_idx", "row_ptr",
                 "gather_idx", "gather_blk", "gather_nnz",
                 "gather_t_idx", "gather_t_blk", "gather_t_nnz")
_FIELDS = {"bcsr": ("data",) + _INDEX_FIELDS,
           "palette_bcsr": ("codes", "palette") + _INDEX_FIELDS}


def _key(name: str) -> str:
    return name.replace("/", "|")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _children(node):
    """(key, child) pairs of an interior node, in the reference's flatten
    order; None for a leaf."""
    if isinstance(node, TrainState):
        return [("params", node.params), ("opt_state", node.opt_state),
                ("mask", node.mask), ("step", node.step)]
    if isinstance(node, ProxState):
        return [("step", node.step), ("m", node.m), ("v", node.v)]
    if isinstance(node, CompressedParams):
        return [("dense", node.dense), ("sparse", node.sparse)]
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return None


def _flatten(tree, prefix: str = "") -> list:
    """[(name, leaf)]; None subtrees (a TrainState without a mask) have no
    leaves, as in JAX."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, child in kids:
        out += _flatten(child, f"{prefix}/{k}" if prefix else k)
    return out


def _csr_restore(npz, name: str, shape, dtype) -> np.ndarray:
    data = npz[_key(f"{name}__data")]
    indices = npz[_key(f"{name}__indices")]
    indptr = npz[_key(f"{name}__indptr")]
    dense = np.zeros(shape, dtype)
    rows = np.repeat(np.arange(shape[0]), indptr[1:] - indptr[:-1])
    dense[rows, indices] = data
    return dense


def _read_leaf(npz, e: dict):
    """A leaf as numpy: an array, or a format field dict for the bridge."""
    name, fmt = e["name"], e["format"]
    if fmt in _FIELDS:
        leaf = {f: npz[_key(f"{name}__{f}")] for f in _FIELDS[fmt]}
        leaf.update(shape=e["shape"], block=e["block"], n_blocks=e["n_blocks"])
        if fmt == "palette_bcsr":
            leaf["bits"] = e["bits"]
        return leaf
    if fmt == "csr":
        return _csr_restore(npz, name, tuple(e["shape"]), np.dtype(e["dtype"]))
    return npz[_key(name)]


class Checkpointer:
    """Writes and reads ``step_*`` checkpoints under ``directory``."""

    def __init__(self, directory: str, keep_n: int = 3,
                 sparse_storage: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.sparse_storage = sparse_storage
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree: PyTree, extra: Optional[dict] = None):
        arrays: dict = {}
        manifest = {"step": step, "time": time.time(), "extra": extra or {},
                    "leaves": []}
        for name, leaf in _flatten(tree):
            if is_bcsr(leaf):
                quant = isinstance(leaf, PaletteBCSR)
                fmt = "palette_bcsr" if quant else "bcsr"
                entry = {"name": name, "format": fmt,
                         "shape": list(leaf.shape), "block": list(leaf.block),
                         "n_blocks": int(leaf.n_blocks),
                         "dtype": str(_np(leaf.palette if quant
                                          else leaf.data[:0]).dtype)}
                if quant:
                    entry["bits"] = int(leaf.bits)
                for f in _FIELDS[fmt]:
                    arrays[f"{name}__{f}"] = _np(getattr(leaf, f))
                manifest["leaves"].append(entry)
                continue
            arr = (np.asarray(leaf, np.int32) if isinstance(leaf, int)
                   else _np(leaf))
            entry = {"name": name, "shape": list(arr.shape),
                     "dtype": str(arr.dtype), "format": "dense"}
            if (self.sparse_storage and arr.ndim == 2
                    and default_regularized_predicate(name, torch.empty(
                        arr.shape, device="meta"))
                    and arr.size > 4096
                    and 1.0 - np.count_nonzero(arr) / arr.size
                    >= _SPARSE_THRESHOLD):
                csr = dense_to_csr(arr)
                entry["format"] = "csr"
                for f in ("data", "indices", "indptr"):
                    arrays[f"{name}__{f}"] = getattr(csr, f).numpy()
                manifest["leaves"].append(entry)
                continue
            arrays[name] = arr
            manifest["leaves"].append(entry)

        final = self._path(step)
        tmp = tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=self.dir)
        try:
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{_key(k): v for k, v in arrays.items()})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)          # atomic publish
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self._path(step), "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, like: PyTree, mesh=None) -> PyTree:
        """Restore into the structure of ``like`` (a ``TrainState``, a dict
        tree or a ``CompressedParams``): each tensor leaf comes back on the
        device and in the dtype of ``like``'s leaf, each int leaf as an
        int. With a rank ``mesh`` each rank keeps only its part
        (``distributed.sharding.shard_state``): the checkpoint holds whole
        arrays, so any mesh shape restores it."""
        if mesh is not None:
            from repro_torch.distributed import sharding
            return sharding.shard_state(self.restore(step, like), mesh)
        by_name = {e["name"]: e for e in self.manifest(step)["leaves"]}
        with np.load(os.path.join(self._path(step), "arrays.npz")) as npz:
            def build(node, prefix):
                if node is None:
                    return None
                kids = _children(node)
                if kids is None:
                    return _restore_leaf(npz, by_name[prefix], node)
                vals = {k: build(c, f"{prefix}/{k}" if prefix else k)
                        for k, c in kids}
                if isinstance(node, TrainState):
                    return TrainState(**vals)
                if isinstance(node, ProxState):
                    return ProxState(**vals)
                if isinstance(node, CompressedParams):
                    return CompressedParams(plan=node.plan, **vals)
                return vals
            return build(like, "")

    def restore_compressed(self, step: Optional[int] = None,
                           device=None, mesh=None) -> CompressedParams:
        """The ``CompressedParams`` of a checkpoint, on ``device``, without
        a template and without densifying a compressed leaf. With a rank
        ``mesh`` each rank gets only its part, on the mesh's device: the
        whole model is read on the host and split there."""
        if mesh is not None:
            from repro_torch.distributed import sharding
            return sharding.shard_params(
                self.restore_compressed(step, device="cpu"), mesh)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        manifest = self.manifest(step)
        roots: dict = {"dense": {}, "sparse": {}}
        with np.load(os.path.join(self._path(step), "arrays.npz")) as npz:
            for e in manifest["leaves"]:
                name = e["name"]
                root, _, rest = name.partition("/")
                if root not in roots or not rest:
                    raise ValueError(
                        f"step {step} in {self.dir} is not a CompressedParams "
                        f"checkpoint (leaf {name!r})")
                node = roots[root]
                keys = rest.split("/")
                for k in keys[:-1]:
                    node = node.setdefault(k, {})
                node[keys[-1]] = _read_leaf(npz, e)
        plan = plan_from_json((manifest.get("extra") or {}).get("plan"))
        return compressed_from_numpy(roots["dense"], roots["sparse"], plan,
                                     device)


def _restore_leaf(npz, e: dict, like):
    if isinstance(like, int):
        return int(_read_leaf(npz, e))
    if is_bcsr(like):
        return format_from_fields(_read_leaf(npz, e), like.gather_idx.device)
    arr = _read_leaf(npz, e)
    if list(arr.shape) != e["shape"]:
        raise ValueError(f"{e['name']}: stored {arr.shape}, manifest "
                         f"{e['shape']}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        device=like.device, dtype=like.dtype)
