"""Plain PyTorch version of the fused Prox-ADAM / Prox-RMSProp kernel.

``fused_prox_update_ref`` updates one leaf, ``fused_tree_update_ref`` a
list of leaves, one after another. ``ops.fused_tree_update`` runs the
latter for tensors on the CPU; the CPU tests hold both against the JAX
package, and ``chip_smoke.py`` holds every leaf of a kernel launch against
them on the card.
"""
from __future__ import annotations

import torch


def fused_prox_update_ref(w, g, m, v, scalars, *, rule: str = "adam",
                          apply_prox: bool = True):
    """One optimizer step then the soft threshold with tau = lr * lam.

    scalars: 8 f32 values ``[lr, lam, b1, b2, eps, 1-b1^t, 1-b2^t, pad]``
    (a tensor or a sequence). Returns new (w in w's dtype, m f32, v f32)."""
    # the scalar arithmetic in f32 on the host, as the kernel does it; the
    # results enter the tensor ops as Python floats (exact f32 values), so
    # nothing is copied to the device. The bias corrections multiply by
    # their f32 reciprocals: a tensor divided by a scalar rounds so on the
    # card and would not on the CPU, and the kernel does the same.
    sc = torch.as_tensor(scalars, dtype=torch.float32).cpu()
    lr, lam, b1, b2, eps = (float(x) for x in sc[:5])
    c1, c2 = float(1.0 - sc[2]), float(1.0 - sc[3])
    r1, r2 = float(1.0 / sc[5]), float(1.0 / sc[6])
    g32 = g.float()
    w32 = w.float()
    if rule == "adam":
        m2 = b1 * m + c1 * g32
        v2 = b2 * v + c2 * g32 * g32
        d = (m2 * r1) / (torch.sqrt(v2 * r2) + eps)
    elif rule == "rmsprop":
        m2 = m
        v2 = b2 * v + c2 * g32 * g32
        d = g32 / (torch.sqrt(v2) + eps)
    else:
        raise ValueError(rule)
    z = w32 - lr * d
    if apply_prox:
        tau = float(sc[0] * sc[1])
        z = torch.minimum(torch.clamp_min(z - tau, 0.0), z + tau)
    return z.to(w.dtype), m2, v2


def fused_tree_update_ref(ws, gs, ms, vs, scalars, *, rule: str = "adam",
                          prox=None):
    """``fused_prox_update_ref`` on each leaf in turn, the soft threshold
    where its flag in ``prox`` is set (default: every leaf). Returns a list
    of new (w, m, v), one a leaf; the inputs are left as they are."""
    prox = [True] * len(ws) if prox is None else prox
    return [fused_prox_update_ref(w, g, m, v, scalars, rule=rule,
                                  apply_prox=bool(p))
            for w, g, m, v, p in zip(ws, gs, ms, vs, prox, strict=True)]
