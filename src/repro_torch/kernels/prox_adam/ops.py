"""Wrapper of the fused Prox-ADAM / Prox-RMSProp kernel
(``csrc/prox_adam.cu``).

``fused_update_leaf(w, g, m, v, scalars)`` runs one optimizer step and,
with ``apply_prox``, the soft threshold, updating ``w``, ``m`` and ``v``
IN PLACE (JAX returns new arrays and donates the old ones). For tensors on
the CPU it runs the plain version (``ref.py``) and copies the result back;
for CUDA tensors it launches the kernel or raises. There is no fallback
between the two.

The TPU wrapper tiled every leaf to (rows, 128); the CUDA kernel takes the
flat length, so no padding copy is made. The 8 scalars travel to the
kernel by value: no step copies them to the device, and nothing syncs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Callable, Optional

import torch

from repro_torch.core.prox import default_regularized_predicate
from repro_torch.core.tree import flatten_with_path, keystr
from repro_torch.kernels import _build, _counts
from repro_torch.kernels.prox_adam import ref
from repro_torch.obs.profile import kernel_call

launches = {"prox_adam": 0}
_RULES = {"adam": 0, "rmsprop": 1}
PyTree = Any


def reset_launches() -> None:
    _counts.reset(launches)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("prox_adam")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.prox_adam_update.argtypes = [p, i, p, p, p, ctypes.c_longlong, i, i] \
        + [f] * 7 + [p]
    lib.prox_adam_update.restype = i
    return lib


def make_scalars(lr, lam, b1, b2, eps, t) -> torch.Tensor:
    """f32[8] ``[lr, lam, b1, b2, eps, 1-b1^t, 1-b2^t, 0]`` on the host,
    the bias-correction terms computed in f32 as the reference does."""
    f = lambda a: torch.as_tensor(a, dtype=torch.float32).cpu()  # noqa: E731
    t, b1f, b2f = f(t), f(b1), f(b2)
    return torch.stack([f(lr), f(lam), b1f, b2f, f(eps),
                        1.0 - torch.pow(b1f, t), 1.0 - torch.pow(b2f, t),
                        torch.zeros((), dtype=torch.float32)])


def _check(w, g, m, v):
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.device != w.device:
            raise ValueError(f"{name} lies on {t.device}, w on {w.device}")
        if t.shape != w.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != w {tuple(w.shape)}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"prox_adam takes f32 or bf16 w, got {w.dtype}")
    if g.dtype != torch.float32 or m.dtype != torch.float32 \
            or v.dtype != torch.float32:
        raise TypeError("prox_adam takes f32 g, m and v")
    if not all(t.is_contiguous() for t in (w, g, m, v)):
        raise ValueError("prox_adam takes contiguous tensors (updated in place)")


def fused_update_leaf(w, g, m, v, scalars, *, rule: str = "adam",
                      apply_prox: bool = True):
    """Update (w, m, v) in place; returns them. ``scalars`` is
    ``make_scalars(...)`` (8 host f32 values)."""
    return kernel_call("prox_adam/fused_update_leaf", _fused_update_leaf, w,
                       g, m, v, scalars, rule=rule, apply_prox=apply_prox)


def _fused_update_leaf(w, g, m, v, scalars, *, rule: str, apply_prox: bool):
    if rule not in _RULES:
        raise ValueError(rule)
    if w.device.type == "cpu":
        w2, m2, v2 = ref.fused_prox_update_ref(w, g, m, v, scalars, rule=rule,
                                               apply_prox=apply_prox)
        w.copy_(w2)
        m.copy_(m2)
        v.copy_(v2)
        return w, m, v
    if w.device.type != "cuda":
        raise ValueError(f"prox_adam takes CUDA or CPU tensors, got {w.device}")
    g = g.float()
    _check(w, g, m, v)
    n = w.numel()
    if n == 0:
        return w, m, v
    sc = [float(s) for s in torch.as_tensor(scalars).cpu().tolist()[:7]]
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().prox_adam_update(
            w.data_ptr(), int(w.dtype == torch.bfloat16), g.data_ptr(),
            m.data_ptr(), v.data_ptr(), n, _RULES[rule], int(apply_prox),
            *sc, stream)
    if err:
        raise RuntimeError(f"prox_adam_update launch failed: CUDA error {err}")
    _counts.bump(launches, "prox_adam")
    return w, m, v


def fused_tree_update(params: PyTree, grads: PyTree, m: PyTree, v: PyTree,
                      scalars, *, rule: str = "adam",
                      predicate: Optional[Callable] = None):
    """Whole-tree fused update, in place; leaves the predicate does not
    regularize skip the prox. Returns (params, m, v)."""
    predicate = predicate or default_regularized_predicate
    fg = [x for _, x in flatten_with_path(grads)]
    fm = [x for _, x in flatten_with_path(m)]
    fv = [x for _, x in flatten_with_path(v)]
    for (keys, p), g, mm, vv in zip(flatten_with_path(params), fg, fm, fv):
        fused_update_leaf(p, g, mm, vv, scalars, rule=rule,
                          apply_prox=predicate(keystr(keys), p))
    return params, m, v


fused_prox_update_ref = ref.fused_prox_update_ref
