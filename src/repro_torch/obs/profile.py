"""Training telemetry: the phase-tagged JSONL stream and the block-sparsity
measurements on the serving grid (the training half of
``repro.obs.profile``). Everything here runs on the host. The kernel
profiler of the reference comes with ROADMAP Queue 1 item 8b.
"""
from __future__ import annotations

import json

import numpy as np


class TrainTelemetry:
    """Append-only JSONL stream of training records: ``emit`` writes one
    line and flushes, so the stream can be tailed while training runs."""

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self.n_records = 0

    def emit(self, record: dict) -> None:
        if self._f is None:
            self._f = open(self.path, "w")
        self._f.write(json.dumps(record, default=_json_default) + "\n")
        self._f.flush()
        self.n_records += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def _json_default(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if hasattr(x, "item") and getattr(x, "ndim", None) == 0:
        return x.item()
    return float(x)


def _iter_target_mats(params):
    """Yield (path, 2D (out, in) float64 matrix) for every compressible
    weight, on the orientation ``sparse.compress`` uses; each slice of a
    stacked weight is yielded on its own."""
    from repro_torch.sparse.compress import (_LAYER_TARGETS, _as_out_in,
                                             _lead_axes)

    def per_layer(layer, path, stacked):
        for sub, names in _LAYER_TARGETS.items():
            if sub not in layer:
                continue
            for name in names:
                if name not in layer[sub]:
                    continue
                arr = layer[sub][name].detach().float().cpu().numpy()
                p = f"{path}/{sub}/{name}"
                lead = _lead_axes(name, stacked)
                mats = (arr.reshape((-1,) + arr.shape[lead:]) if lead
                        else arr[None])
                for mat in mats:
                    view = _as_out_in(p, mat)
                    if view is not None:
                        yield p, view.astype(np.float64)

    for lkey, layer in (params.get("layers") or {}).items():
        yield from per_layer(layer, f"layers/{lkey}", stacked=True)
    for lkey, layer in (params.get("rem") or {}).items():
        yield from per_layer(layer, f"rem/{lkey}", stacked=False)
    if "head" in params:
        view = _as_out_in("head", params["head"].detach().float().cpu().numpy())
        if view is not None:
            yield "head", view.astype(np.float64)


def _block_norms(mat: np.ndarray, block: tuple) -> np.ndarray:
    br, bc = block
    r, c = mat.shape
    mp = np.pad(mat, ((0, (-r) % br), (0, (-c) % bc)))
    R, C = mp.shape[0] // br, mp.shape[1] // bc
    blocks = mp.reshape(R, br, C, bc).transpose(0, 2, 1, 3)
    return np.sqrt((blocks ** 2).sum(axis=(2, 3)))


def layer_block_sparsity(params, block: tuple = (8, 64)) -> dict:
    """Per-weight fraction of exactly-zero (br, bc) blocks on the serving
    (out, in) grid; stacked layers aggregate over the stack axis."""
    zero: dict[str, int] = {}
    total: dict[str, int] = {}
    for path, mat in _iter_target_mats(params):
        norms = _block_norms(mat, block)
        zero[path] = zero.get(path, 0) + int((norms == 0.0).sum())
        total[path] = total.get(path, 0) + int(norms.size)
    return {p: zero[p] / max(total[p], 1) for p in total}


def total_block_sparsity(params, block: tuple = (8, 64)) -> float:
    zero = tot = 0
    for _, mat in _iter_target_mats(params):
        norms = _block_norms(mat, block)
        zero += int((norms == 0.0).sum())
        tot += int(norms.size)
    return zero / max(tot, 1)


def group_l1_penalty(params, block: tuple = (8, 64),
                     lam: float = 1.0) -> float:
    """``lam * sum ||block||_2`` over the plan grid, on the live params."""
    total = 0.0
    for _, mat in _iter_target_mats(params):
        total += float(_block_norms(mat, block).sum())
    return lam * total


def sparsity_telemetry_fn(block: tuple, lam: float = 1.0):
    """An ``extra_fn`` for ``train_loop``: total and per-weight block
    sparsity on the serving grid and the group-l1 penalty."""
    def fn(params):
        return {"block_sparsity": total_block_sparsity(params, block),
                "group_l1_penalty": group_l1_penalty(params, block, lam),
                "layer_block_sparsity": layer_block_sparsity(params, block)}
    return fn
