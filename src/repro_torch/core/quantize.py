"""k-means palette for weight-sharing quantization (Deep Compression stage 2).

Port of ``repro.core.quantize.kmeans_palette``: Lloyd k-means over the
NONZERO entries of a weight, from a linspace init over their range, with a
chunked assignment step. It runs in torch on the weight's own device.
``kmeans_palettes`` runs the same k-means for many slices at once (the
layers and experts of a stacked store), each with its own palette, in
groups of slices bounded in bytes.

The Deep-Compression size accounting rides on it (port of the rest of
``repro.core.quantize``): ``quantize_tree`` palette-quantizes every
regularized leaf of a param tree, ``huffman_bits_estimate`` is the entropy
bound on Huffman-coded palette indices, and ``quantized_size_bytes`` the
paper-style estimate (elementwise CSR structure + palette + coded values).
It is an offline estimate, not a serving artifact (``docs/
size_accounting.md``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.prox import default_regularized_predicate
from repro_torch.core.tree import flatten_with_path, keystr, map_with_keystr


def _init_palettes(vals: torch.Tensor, seg: torch.Tensor, n_slices: int,
                   n_clusters: int) -> torch.Tensor:
    """(n_slices, n_clusters) f32: each slice's ``torch.linspace`` over the
    range of its values (zeros for a slice with none). The ranges come to
    the host in one transfer; each linspace is made there, as the
    reference's init is made per slice."""
    inf = torch.full((n_slices,), float("inf"), device=vals.device)
    lo = inf.scatter_reduce(0, seg, vals, "amin")
    hi = (-inf).scatter_reduce(0, seg, vals, "amax")
    rows = [torch.linspace(a, b, n_clusters, dtype=torch.float32)
            if a != float("inf") else torch.zeros(n_clusters)
            for a, b in torch.stack([lo, hi], 1).cpu().tolist()]
    return torch.stack(rows).to(vals.device)


def nearest_sorted(v: torch.Tensor, pal: torch.Tensor) -> torch.Tensor:
    """argmin_j |v[s, i] - pal[s, j]| (the first j among equal distances)
    for palettes ``pal`` (S, P) sorted ascending, by a binary search: the
    nearest entry is one of the two around v's place, and equal entries
    resolve to the first of their run. Equal to the full argmin unless two
    distinct entries lie so close that v's distances to both round to the
    same float. v (S, n) -> (S, n) int64."""
    p = pal.shape[1]
    i = torch.searchsorted(pal, v)                 # entries below v
    lo, hi = (i - 1).clamp(min=0), i.clamp(max=p - 1)
    d_lo = (v - pal.gather(1, lo)).abs()
    d_hi = (v - pal.gather(1, hi)).abs()
    c = torch.where(d_lo <= d_hi, lo, hi)
    first = torch.searchsorted(pal, pal)           # first index of each value
    return first.gather(1, c)


# Device bytes that clustering takes per entry of a slice, counting every
# entry as nonzero: the f32 copy and its mask, the int64 slice and column of
# each nonzero, its value, its place in the padded row layout, its bucket
# and its assignment, and the search's temporaries.
_BYTES_PER_ENTRY = 64
GROUP_BYTES = 1 << 31


def kmeans_palettes(slices: torch.Tensor, n_clusters: int, iters: int = 25,
                    chunk: int = 1 << 15):
    """Lloyd k-means over the nonzero entries of each slice of ``slices``
    (S, ...) on its own, many slices at once.

    Returns (palettes (S, n_clusters) f32, per-entry assignment (S, n)
    int32 of the nonzero entries, 0 at the zeros). The slices are taken in
    groups of as many as fit ``GROUP_BYTES`` at ``_BYTES_PER_ENTRY`` an
    entry (at least one), so the working memory stays bounded however many
    (layer, expert) slices a stack holds. Each slice's sums take its values
    in the order they are stored, as one slice alone would, so on the CPU
    the result equals ``kmeans_palette`` slice by slice, whatever the
    grouping. On the card the sums are atomic, in no fixed order, and the
    assignment step is ``nearest_sorted`` on each slice's values laid out
    in a row (Lloyd steps keep a palette sorted; where rounding unsorts
    one, that step takes the full argmin): the full argmin materializes n
    x P distances a step, 5.5 TB over 25 steps for olmoe-1b-7b's experts
    at 8 bits. On the CPU the assignment is the full argmin, chunked."""
    s = slices.shape[0]
    per_slice = max(1, slices[0].numel() * _BYTES_PER_ENTRY) if s else 1
    g = max(1, GROUP_BYTES // per_slice)
    palettes = torch.empty((s, n_clusters), device=slices.device)
    out = torch.empty((s, slices[0].numel() if s else 0), dtype=torch.int32,
                      device=slices.device)
    for i in range(0, s, g):
        palettes[i:i + g], out[i:i + g] = _lloyd(slices[i:i + g], n_clusters,
                                                 iters, chunk)
    return palettes, out


def _lloyd(slices: torch.Tensor, n_clusters: int, iters: int, chunk: int):
    """``kmeans_palettes`` on one group of slices, all at once."""
    s = slices.shape[0]
    flat = slices.reshape(s, -1).float()
    nz_mask = flat != 0
    seg, col = nz_mask.nonzero(as_tuple=True)
    vals = flat[seg, col]
    cuda, shape = flat.is_cuda, flat.shape
    del flat, nz_mask
    palettes = _init_palettes(vals, seg, s, n_clusters)
    if cuda and vals.numel():
        # each slice's values in a row of a padded (S, n_max) layout
        counts = torch.bincount(seg, minlength=s)
        pos = torch.arange(seg.numel(), device=seg.device) \
            - (counts.cumsum(0) - counts)[seg]
        rows = vals.new_zeros(s, int(counts.max()))
        rows[seg, pos] = vals
        chunk = max(chunk, (1 << 25) // n_clusters)

    def assign(pal):
        if cuda and vals.numel() \
                and not bool((pal[:, 1:] < pal[:, :-1]).any()):
            return nearest_sorted(rows, pal)[seg, pos]
        return torch.cat([
            torch.argmin((vals[i:i + chunk, None]
                          - pal[seg[i:i + chunk]]).abs(), dim=1)
            for i in range(0, vals.numel(), chunk)]) if vals.numel() else \
            seg.clone()

    bucket = seg * n_clusters
    ones = torch.ones_like(vals)
    for _ in range(iters if vals.numel() else 0):
        a = bucket + assign(palettes)
        sums = vals.new_zeros(s * n_clusters).index_add_(0, a, vals)
        counts = vals.new_zeros(s * n_clusters).index_add_(0, a, ones)
        palettes = torch.where(counts > 0, sums / counts.clamp(min=1),
                               palettes.reshape(-1)).reshape(s, n_clusters)
    out = torch.zeros(shape, dtype=torch.int32, device=vals.device)
    out[seg, col] = assign(palettes).to(torch.int32)
    return palettes, out


def kmeans_palette(w: torch.Tensor, n_clusters: int, iters: int = 25,
                   chunk: int = 1 << 15):
    """Lloyd k-means over the nonzero entries of ``w``.

    Returns (palette (n_clusters,) f32, ``w`` quantized with zeros kept,
    per-entry cluster assignment (w.numel(),) int32). Assignment is chunked
    so peak memory is O(chunk * n_clusters); on the card a chunk holds up
    to 2**25 distances (128 MB). The assignment does not depend on the
    chunking.

    Edge cases, as in the reference: an all-zero ``w`` gives a zero palette,
    ``w`` unchanged and all assignments 0; with fewer nonzeros (or distinct
    values) than clusters the empty clusters keep their init.
    """
    palettes, _ = kmeans_palettes(w[None], n_clusters, iters, chunk)
    palette = palettes[0]
    flat = w.reshape(-1).float()
    nz_mask = flat != 0
    if not bool(nz_mask.any()):
        return (palette, w.clone(),
                torch.zeros(flat.shape, dtype=torch.int32, device=w.device))
    if flat.is_cuda:
        chunk = max(chunk, (1 << 25) // n_clusters)
    a = torch.cat([
        torch.argmin((flat[i:i + chunk, None] - palette[None, :]).abs(), dim=1)
        for i in range(0, flat.numel(), chunk)])
    q = torch.where(nz_mask, palette[a], torch.zeros_like(flat))
    return palette, q.reshape(w.shape).to(w.dtype), a.to(torch.int32)


def quantize_tree(params, bits: int = 4, predicate=None) -> tuple:
    """Palette-quantize every regularized leaf with more than 2^bits
    nonzeros to 2^bits clusters. Returns (quantized params, per-leaf report
    ``{name: {bits, rel_err, huffman_bits}}`` in the tree's sorted-key
    order)."""
    predicate = predicate or default_regularized_predicate
    quantized, report = {}, {}
    for keys, leaf in flatten_with_path(params):
        name = keystr(keys)
        if not (predicate(name, leaf)
                and int(torch.count_nonzero(leaf)) > 2 ** bits):
            continue
        _, q, assign = kmeans_palette(leaf, 2 ** bits)
        err = float(torch.linalg.vector_norm((q - leaf).float())
                    / max(float(torch.linalg.vector_norm(leaf.float())),
                          1e-12))
        report[name] = {"bits": bits, "rel_err": err,
                        "huffman_bits": huffman_bits_estimate(
                            assign.cpu().numpy(),
                            (leaf.reshape(-1) != 0).cpu().numpy())}
        quantized[name] = q
    return (map_with_keystr(lambda name, leaf: quantized.get(name, leaf),
                            params), report)


def huffman_bits_estimate(assign: np.ndarray, nz_mask: np.ndarray) -> float:
    """Entropy lower bound on Huffman-coded palette indices (nonzeros)."""
    idx = assign[nz_mask]
    if idx.size == 0:
        return 0.0
    _, counts = np.unique(idx, return_counts=True)
    p = counts / counts.sum()
    return float(idx.size * -(p * np.log2(p)).sum())


def quantized_size_bytes(params, bits: int = 4, index_bytes: int = 4,
                         reports: Optional[dict] = None) -> int:
    """Deep-Compression size accounting: CSR indices + palette +
    Huffman-coded value indices (``reports[name]['huffman_bits']``, else
    ``bits`` a nonzero) for regularized leaves, dense elsewhere."""
    total = 0
    for keys, leaf in flatten_with_path(params):
        name = keystr(keys)
        itemsize = leaf.element_size()
        if default_regularized_predicate(name, leaf):
            nnz = int(torch.count_nonzero(leaf))
            rows = leaf.shape[0] if leaf.dim() >= 1 else 1
            structure = nnz * index_bytes + (rows + 1) * index_bytes
            palette = (2 ** bits) * itemsize
            if reports and name in reports:
                values = math.ceil(reports[name]["huffman_bits"] / 8)
            else:
                values = math.ceil(nnz * bits / 8)
            total += structure + palette + values
        else:
            total += leaf.numel() * itemsize
    return total
