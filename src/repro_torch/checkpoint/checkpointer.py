"""Read half of the checkpointer: restore a compressed checkpoint written by
the JAX package's ``Checkpointer``.

The format, as ``repro.checkpoint.checkpointer`` writes it:
  * ``<dir>/step_NNNNNNNNN/manifest.json``: ``leaves`` (one entry per leaf:
    ``name``, ``format`` in dense | csr | bcsr | palette_bcsr, ``shape``,
    ``dtype``, and for compressed leaves ``block``, ``n_blocks``, ``bits``)
    and ``extra`` (``plan``, ``arch``, ``reduced``);
  * ``arrays.npz``: one array per dense leaf; ``<name>__<field>`` per
    BlockCSR / PaletteBCSR field; ``<name>__data|indices|indptr`` per CSR
    leaf. A ``/`` in a name is stored as ``|``.
Leaf names start with ``dense/`` or ``sparse/`` for a ``CompressedParams``.
The write half comes with the training slice.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from repro_torch.checkpoint.bridge import compressed_from_numpy, plan_from_json
from repro_torch.sparse.compress import CompressedParams

_INDEX_FIELDS = ("col_idx", "row_ptr",
                 "gather_idx", "gather_blk", "gather_nnz",
                 "gather_t_idx", "gather_t_blk", "gather_t_nnz")
_FIELDS = {"bcsr": ("data",) + _INDEX_FIELDS,
           "palette_bcsr": ("codes", "palette") + _INDEX_FIELDS}


def _key(name: str) -> str:
    return name.replace("/", "|")


def _csr_restore(npz, name: str, shape, dtype) -> np.ndarray:
    data = npz[_key(f"{name}__data")]
    indices = npz[_key(f"{name}__indices")]
    indptr = npz[_key(f"{name}__indptr")]
    dense = np.zeros(shape, dtype)
    rows = np.repeat(np.arange(shape[0]), indptr[1:] - indptr[:-1])
    dense[rows, indices] = data
    return dense


class Checkpointer:
    """Reads ``step_*`` checkpoints under ``directory``."""

    def __init__(self, directory: str):
        self.dir = directory

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

    def restore_compressed(self, step: Optional[int] = None,
                           device=None) -> CompressedParams:
        """The ``CompressedParams`` of a checkpoint, on ``device``, without
        a template and without densifying a compressed leaf."""
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
                fmt = e["format"]
                if fmt in _FIELDS:
                    leaf = {f: npz[_key(f"{name}__{f}")] for f in _FIELDS[fmt]}
                    leaf.update(shape=e["shape"], block=e["block"],
                                n_blocks=e["n_blocks"])
                    if fmt == "palette_bcsr":
                        leaf["bits"] = e["bits"]
                elif fmt == "csr":
                    leaf = _csr_restore(npz, name, tuple(e["shape"]),
                                        np.dtype(e["dtype"]))
                else:
                    leaf = npz[_key(name)]
                node = roots[root]
                keys = rest.split("/")
                for k in keys[:-1]:
                    node = node.setdefault(k, {})
                node[keys[-1]] = leaf
        plan = plan_from_json((manifest.get("extra") or {}).get("plan"))
        return compressed_from_numpy(roots["dense"], roots["sparse"], plan,
                                     device)
