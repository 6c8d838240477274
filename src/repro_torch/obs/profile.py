"""Profiling hooks: kernel and engine-tick timers, and the training
telemetry stream (port of ``repro.obs.profile``).

* ``Profiler``: every public kernel entry of ``repro_torch.kernels``
  routes through ``kernel_call(name, fn, ...)``, under the reference's
  names (``bsr_spmm/spmm``, ...), and the engine times its step as
  ``engine/tick_step``. With a profiler active, a kernel call on CUDA
  tensors is bracketed by two CUDA events recorded on the current stream,
  read only when the summary is asked for, so the hook never waits for the
  device; a call on CPU tensors (the plain versions) and the engine tick
  are timed on the host clock. With no profiler active the hook is one
  module-global load and a ``None`` check. ``trace_dir`` also records a
  ``torch.profiler`` run and writes its Chrome trace there. Its counts and
  sums are taken under a lock, so they stay exact when router replicas
  call kernels from several threads at once.
* ``TrainTelemetry``: the phase-tagged JSONL stream of training records.
* The block-sparsity measurements on the serving grid (host side).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

# the active profiler the kernel hooks consult; None is the free path
_ACTIVE: Optional["Profiler"] = None


def active() -> Optional["Profiler"]:
    return _ACTIVE


def kernel_call(name: str, fn: Callable, *args, **kwargs):
    """The kernel entry hook: each ``ops.py`` wrapper routes its call
    through this. With no profiler active it costs one global load and a
    ``None`` check."""
    p = _ACTIVE
    if p is None:
        return fn(*args, **kwargs)
    return p.call(name, fn, *args, **kwargs)


def _on_cuda(args, kwargs) -> bool:
    for a in (*args, *kwargs.values()):
        if isinstance(a, (list, tuple)) and a:
            a = a[0]                     # a list of leaves: the first
        if isinstance(a, torch.Tensor):
            return a.is_cuda
    return False


class Profiler:
    """Kernel-call and tick timers.

    Use as a context manager (``with Profiler() as p: ...; p.summary()``)
    or by ``start()`` / ``stop()``. One profiler is active at a time (the
    kernel hooks consult a module global)."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.records: dict[str, dict] = {}
        self.trace_dir = trace_dir
        self._events: list = []          # (name, start, end), read lazily
        self._torch_prof = None
        self._lock = threading.Lock()    # records and events, across threads

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Profiler":
        global _ACTIVE
        _ACTIVE = self
        if self.trace_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._torch_prof = profile(activities=acts)
            self._torch_prof.__enter__()
        return self

    def stop(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None
        if self._torch_prof is not None:
            prof, self._torch_prof = self._torch_prof, None
            prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.trace_dir,
                                                  "trace.json"))

    def __enter__(self) -> "Profiler":
        return self.start()

    def __exit__(self, *a) -> bool:
        self.stop()
        return False

    # -- measurement --------------------------------------------------------

    def _rec(self, name: str) -> dict:
        """The record of ``name``; the caller holds ``_lock``."""
        r = self.records.get(name)
        if r is None:
            r = self.records[name] = {"n_calls": 0, "total_ms": 0.0,
                                      "max_ms": 0.0, "n_traced": 0}
        return r

    def _count(self, name: str) -> None:
        with self._lock:
            self._rec(name)["n_calls"] += 1

    def _add(self, name: str, dt_ms: float) -> None:
        with self._lock:
            r = self._rec(name)
            r["total_ms"] += dt_ms
            if dt_ms > r["max_ms"]:
                r["max_ms"] = dt_ms

    def call(self, name: str, fn: Callable, *args, **kwargs):
        """Run ``fn(*args, **kwargs)``, timed by CUDA events on the current
        stream when its first tensor argument (a list of leaves counts by
        its first) lies on a card (read later, by ``summary``), else on
        the host clock. ``n_traced`` stays 0:
        PyTorch runs eagerly, there is no trace to count."""
        if not _on_cuda(args, kwargs):
            return self.wall(name, fn, *args, **kwargs)
        self._count(name)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        with self._lock:
            self._events.append((name, start, end))
        return out

    def wall(self, name: str, fn: Callable, *args, **kwargs):
        """Run ``fn`` timed on the host clock."""
        self._count(name)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self._add(name, (time.perf_counter() - t0) * 1e3)
        return out

    def wall_since(self, name: str, t0: float) -> None:
        """Count one ``name`` that began at ``t0`` (``time.perf_counter``)
        and ends now: the engine tick, which ends in its own device sync."""
        self._count(name)
        self._add(name, (time.perf_counter() - t0) * 1e3)

    def _drain(self) -> None:
        with self._lock:
            events, self._events = self._events, []
        for name, start, end in events:
            end.synchronize()
            self._add(name, start.elapsed_time(end))

    def summary(self) -> dict:
        """``{name: {n_calls, total_ms, mean_ms, max_ms, n_traced}}``."""
        self._drain()
        out = {}
        with self._lock:
            records = {name: dict(r) for name, r in self.records.items()}
        for name, r in records.items():
            out[name] = dict(r, mean_ms=(r["total_ms"] / r["n_calls"]
                                         if r["n_calls"] else 0.0))
        return out

    def format_summary(self) -> str:
        lines = ["profile (kernels: CUDA events on the stream; engine tick: "
                 "host clock):"]
        for name, r in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_ms"]):
            lines.append(
                f"  {name:<36} {r['n_calls']:>6} calls "
                f"{r['total_ms']:>9.1f} ms total {r['mean_ms']:>8.3f} ms/call")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# training telemetry stream
# ---------------------------------------------------------------------------

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
