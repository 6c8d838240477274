"""Plain PyTorch version of the fused Prox-ADAM / Prox-RMSProp kernel.

``ops.fused_update_leaf`` runs it for tensors on the CPU; the CPU tests
hold it against the JAX package, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
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
