"""k-means palette for weight-sharing quantization (Deep Compression stage 2).

Port of ``repro.core.quantize.kmeans_palette``: Lloyd k-means over the
NONZERO entries of a weight, from a linspace init over their range, with a
chunked assignment step. It runs in torch on the weight's own device.
"""
from __future__ import annotations

import torch


def kmeans_palette(w: torch.Tensor, n_clusters: int, iters: int = 25,
                   chunk: int = 1 << 15):
    """Lloyd k-means over the nonzero entries of ``w``.

    Returns (palette (n_clusters,) f32, ``w`` quantized with zeros kept,
    per-entry cluster assignment (w.numel(),) int32). Assignment is chunked
    so peak memory is O(chunk * n_clusters).

    Edge cases, as in the reference: an all-zero ``w`` gives a zero palette,
    ``w`` unchanged and all assignments 0; with fewer nonzeros (or distinct
    values) than clusters the empty clusters keep their init.
    """
    flat = w.reshape(-1).float()
    nz_mask = flat != 0
    if not bool(nz_mask.any()):
        return (torch.zeros(n_clusters, dtype=torch.float32, device=w.device),
                w.clone(),
                torch.zeros(flat.shape, dtype=torch.int32, device=w.device))
    nz = flat[nz_mask]
    palette = torch.linspace(float(nz.min()), float(nz.max()), n_clusters,
                             dtype=torch.float32, device=w.device)

    def assign(vals, pal):
        return torch.cat([
            torch.argmin((vals[i:i + chunk, None] - pal[None, :]).abs(), dim=1)
            for i in range(0, vals.numel(), chunk)])

    for _ in range(iters):
        a = assign(nz, palette)
        sums = torch.zeros_like(palette).index_add_(0, a, nz)
        counts = torch.zeros_like(palette).index_add_(0, a, torch.ones_like(nz))
        palette = torch.where(counts > 0, sums / counts.clamp(min=1), palette)

    a = assign(flat, palette)
    q = torch.where(nz_mask, palette[a], torch.zeros_like(flat))
    return palette, q.reshape(w.shape).to(w.dtype), a.to(torch.int32)
