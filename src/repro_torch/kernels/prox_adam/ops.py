"""Wrapper of the fused Prox-ADAM / Prox-RMSProp kernel
(``csrc/prox_adam.cu``).

``fused_tree_update(ws, gs, ms, vs, scalars, prox=...)`` runs one
optimizer step over every leaf of a tree and, on the leaves whose prox
flag is set, the soft threshold, updating each ``w``, ``m`` and ``v`` IN
PLACE (JAX returns new arrays and donates the old ones). For CUDA tensors
it makes ``ceil(leaves / K)`` launches, K leaves each, in leaf order: one
launch per optimizer step for every tree the port trains. For tensors on
the CPU it runs the plain version (``ref.py``) leaf by leaf and copies the
results back. There is no fallback between the two.
``fused_update_leaf`` is the same entry on one leaf.

The TPU wrapper tiled every leaf to (rows, 128) and launched once a leaf;
the CUDA kernel takes each leaf's flat length from a table of up to K
leaves that travels by value in its parameters, with the 7 scalars: no
padding copy, no device allocation, nothing synced. ``launch_plan`` builds
that table on the host.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch.core.prox import default_regularized_predicate
from repro_torch.core.tree import flatten_with_path, keystr
from repro_torch.kernels import _build, _counts
from repro_torch.kernels.prox_adam import ref
from repro_torch.obs.profile import kernel_call

launches = {"prox_adam": 0}
_RULES = {"adam": 0, "rmsprop": 1}
PyTree = Any

# The kernel's constants (csrc/prox_adam.cu MAX_LEAVES, CHUNK), checked
# against the library when it loads: leaves a launch (the largest tree the
# port trains, recurrentgemma-9b's debias tree at full depth, has 98),
# elements a thread block.
K = 100
CHUNK = 512
# a leaf's flags in the table: bf16 w, the soft threshold, the vector path
# (every pointer 16-byte aligned, a bf16 w 8)
BF16_W, PROX, VEC = 1, 2, 4


def reset_launches() -> None:
    _counts.reset(launches)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("prox_adam")
    i, f = ctypes.c_int, ctypes.c_float
    lib.prox_adam_tree.argtypes = [ctypes.c_void_p, i, i, i] + [f] * 7 \
        + [ctypes.c_void_p]
    lib.prox_adam_tree.restype = i
    if (lib.prox_adam_chunk(), lib.prox_adam_max_leaves()) != (CHUNK, K):
        raise RuntimeError("csrc/prox_adam.cu's CHUNK / MAX_LEAVES differ "
                           "from the wrapper's")
    return lib


def make_scalars(lr, lam, b1, b2, eps, t) -> torch.Tensor:
    """f32[8] ``[lr, lam, b1, b2, eps, 1-b1^t, 1-b2^t, 0]`` on the host,
    the bias-correction terms computed in f32 as the reference does."""
    f = lambda a: torch.as_tensor(a, dtype=torch.float32).cpu()  # noqa: E731
    t, b1f, b2f = f(t), f(b1), f(b2)
    return torch.stack([f(lr), f(lam), b1f, b2f, f(eps),
                        1.0 - torch.pow(b1f, t), 1.0 - torch.pow(b2f, t),
                        torch.zeros((), dtype=torch.float32)])


class Launch(NamedTuple):
    """One kernel launch: ``leaves`` are positions in the caller's lists,
    ``rows`` the kernel's table (w, g, m, v pointers, length, flags, first
    thread block; one row a leaf), ``blocks`` its thread blocks."""
    leaves: list
    rows: list
    blocks: int


def launch_plan(ws, gs, ms, vs, prox: Sequence[bool], *, k: int = K,
                chunk: int = CHUNK) -> list:
    """The launches of one tree update: the non-empty leaves in order, at
    most ``k`` a launch; each leaf owns ``ceil(n / chunk)`` consecutive
    thread blocks of its launch, block b its elements [b chunk, (b + 1)
    chunk) up to n."""
    out, leaves, rows, blocks = [], [], [], 0
    for i, (w, g, m, v, p) in enumerate(zip(ws, gs, ms, vs, prox,
                                            strict=True)):
        n = w.numel()
        if n == 0:
            continue
        if len(rows) == k:
            out.append(Launch(leaves, rows, blocks))
            leaves, rows, blocks = [], [], 0
        ptrs = (w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
        bf16 = w.dtype == torch.bfloat16
        aligned = ptrs[0] % (8 if bf16 else 16) == 0 and \
            all(q % 16 == 0 for q in ptrs[1:])
        flags = BF16_W * bf16 | PROX * bool(p) | VEC * aligned
        leaves.append(i)
        rows.append((*ptrs, n, flags, blocks))
        blocks += -(-n // chunk)
    if rows:
        out.append(Launch(leaves, rows, blocks))
    return out


def _check(w, g, m, v):
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.shape != w.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != w {tuple(w.shape)}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"prox_adam takes f32 or bf16 w, got {w.dtype}")
    if g.dtype != torch.float32 or m.dtype != torch.float32 \
            or v.dtype != torch.float32:
        raise TypeError("prox_adam takes f32 g, m and v")
    if not all(t.is_contiguous() for t in (w, g, m, v)):
        raise ValueError("prox_adam takes contiguous tensors (updated in place)")
    if w.numel() >= 2**31:
        raise ValueError(f"prox_adam takes leaves of fewer than 2^31 "
                         f"elements, got {w.numel()}")


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for _, x in flatten_with_path(tree)]
    return list(tree)


def fused_tree_update(params: PyTree, grads: PyTree, m: PyTree, v: PyTree,
                      scalars, *, rule: str = "adam",
                      prox: Optional[Sequence[bool]] = None,
                      predicate: Optional[Callable] = None):
    """One fused step over every leaf, in place. ``params``, ``grads``,
    ``m`` and ``v`` are lists of tensors, a leaf each, or nested-dict trees
    of one structure; ``scalars`` is ``make_scalars(...)`` (8 host f32
    values), made once a step. ``prox`` holds one flag a leaf; without it
    a dict tree's leaves take the prox where ``predicate`` (default
    ``default_regularized_predicate``) holds on their path. Returns
    (params, m, v)."""
    ws = _flat(params)
    if prox is None:
        if not isinstance(params, dict):
            raise ValueError("a list of leaves needs its prox flags")
        predicate = predicate or default_regularized_predicate
        prox = [predicate(keystr(keys), p)
                for keys, p in flatten_with_path(params)]
    kernel_call("prox_adam/fused_tree_update", _tree_update, ws, _flat(grads),
                _flat(m), _flat(v), list(prox), scalars, rule=rule)
    return params, m, v


def _tree_update(ws, gs, ms, vs, prox, scalars, *, rule: str):
    if rule not in _RULES:
        raise ValueError(rule)
    if not ws:
        return
    device = ws[0].device
    for t in itertools.chain(ws, gs, ms, vs):
        if t.device != device:
            raise ValueError(f"a tensor lies on {t.device}, the first w on "
                             f"{device}: a tree update takes one device")
    if device.type == "cpu":
        for w, g, m, v, p in zip(ws, gs, ms, vs, prox, strict=True):
            out = ref.fused_prox_update_ref(w, g, m, v, scalars, rule=rule,
                                            apply_prox=p)
            for t, x in zip((w, m, v), out):
                t.copy_(x)
        return
    if device.type != "cuda":
        raise ValueError(f"prox_adam takes CUDA or CPU tensors, got {device}")
    # the f32 copies made here stay referenced until every launch that
    # reads them is queued: freed earlier, the caching allocator could hand
    # their memory to the next leaf's copy before the kernel has read it
    gs = [g.float().contiguous() for g in gs]
    for w, g, m, v in zip(ws, gs, ms, vs, strict=True):
        _check(w, g, m, v)
    sc = [float(s) for s in torch.as_tensor(scalars).cpu().tolist()[:7]]
    plan = launch_plan(ws, gs, ms, vs, prox, k=K, chunk=CHUNK)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in plan:
            table = (ctypes.c_longlong * (7 * len(launch.rows)))(
                *itertools.chain.from_iterable(launch.rows))
            err = lib.prox_adam_tree(table, len(launch.rows), launch.blocks,
                                     _RULES[rule], *sc, stream)
            if err:
                raise RuntimeError(
                    f"prox_adam_tree launch failed: CUDA error {err}")
            _counts.bump(launches, "prox_adam")


def fused_update_leaf(w, g, m, v, scalars, *, rule: str = "adam",
                      apply_prox: bool = True):
    """``fused_tree_update`` on one leaf; returns (w, m, v)."""
    fused_tree_update([w], [g], [m], [v], scalars, rule=rule,
                      prox=[apply_prox])
    return w, m, v


fused_prox_update_ref = ref.fused_prox_update_ref
fused_tree_update_ref = ref.fused_tree_update_ref
