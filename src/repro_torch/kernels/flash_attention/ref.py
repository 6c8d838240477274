"""Plain PyTorch version of the flash-attention kernel.

Port of ``repro.kernels.flash_attention.ref.flash_attention_ref``: repeat
k / v over the GQA group, scores in f32 scaled by ``hd ** -0.5``, the
causal and window masks with the -1e30 sentinel, the softmax, and the
result in q's dtype. ``ops.py`` runs it for tensors on the CPU; the CPU
tests hold it against the JAX package's Pallas kernel (interpret mode),
and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (BH, S, hd); k, v: (BKV, S, hd). Naive masked softmax attention;
    q head h reads kv head h // (BH // BKV)."""
    bh, s, hd = q.shape
    g = bh // k.shape[0]
    kk = torch.repeat_interleave(k, g, dim=0).float()
    vv = torch.repeat_interleave(v, g, dim=0).float()
    scores = torch.einsum("hqd,hkd->hqk", q.float(), kk) * hd ** -0.5
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, vv).to(q.dtype)
