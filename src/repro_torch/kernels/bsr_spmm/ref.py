"""Plain PyTorch versions of the BCSR gather-block-matmul kernels.

The wrappers in ``ops.py`` run these for tensors on the CPU; the CPU tests
hold them against the JAX package, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.formats import BlockCSR, bcsr_to_dense


def spmm_fwd_ref(x: torch.Tensor, w: BlockCSR) -> torch.Tensor:
    """Y (M, N) f32 = X (M, K) @ W' with W (N, K) BlockCSR."""
    wd = bcsr_to_dense(w)[: w.shape[0], : w.shape[1]]
    return x.float() @ wd.float().T


def spmm_bwd_ref(dy: torch.Tensor, w: BlockCSR) -> torch.Tensor:
    """dX (M, K) f32 = dY (M, N) @ W with W (N, K) BlockCSR: densify, then
    a plain matmul."""
    wd = bcsr_to_dense(w)[: w.shape[0], : w.shape[1]]
    return dy.float() @ wd.float()


def spmm_palette_fwd_ref(x: torch.Tensor, w) -> torch.Tensor:
    """Quantized forward: Y = X @ dequant(W)' for a ``PaletteBCSR`` W."""
    return spmm_fwd_ref(x, w.dequantize())


def _occupied(y: torch.Tensor, rows) -> torch.Tensor:
    """Y (E, M, N) with the rows of expert e at or past ``rows[e]`` set to
    exact zeros (``rows``: (E,) int counts, or None for every row). The
    plain versions compute every row and then zero these, so the rows below
    each count are those of the call without counts, bit for bit."""
    if rows is None:
        return y
    keep = torch.arange(y.shape[1], device=y.device) < \
        rows.to(y.device, torch.long)[:, None]
    return torch.where(keep[..., None], y, torch.zeros((), device=y.device))


def spmm_experts_fwd_ref(x: torch.Tensor, w: BlockCSR,
                         rows=None) -> torch.Tensor:
    """Y (E, M, N) f32, Y[e] = X[e] @ W[e]' for X (E, M, K) and an E-stacked
    BlockCSR: ``spmm_fwd_ref`` on each expert's slice, as the reference
    maps one ``sparse_matmul`` per expert; with ``rows``, zeros at and past
    each expert's count (``_occupied``)."""
    return _occupied(torch.stack([spmm_fwd_ref(x[e], w[e])
                                  for e in range(x.shape[0])]), rows)


def spmm_experts_bwd_ref(dy: torch.Tensor, w: BlockCSR) -> torch.Tensor:
    """dX (E, M, K) f32, dX[e] = dY[e] @ W[e] for dY (E, M, N) and an
    E-stacked BlockCSR: ``spmm_bwd_ref`` on each expert's slice, as the
    reference's VJP runs per expert under its ``lax.map``."""
    return torch.stack([spmm_bwd_ref(dy[e], w[e]) for e in range(dy.shape[0])])


def spmm_palette_experts_fwd_ref(x: torch.Tensor, w, rows=None) -> torch.Tensor:
    """``spmm_experts_fwd_ref`` for an E-stacked ``PaletteBCSR`` (one
    palette per expert)."""
    return _occupied(torch.stack([spmm_palette_fwd_ref(x[e], w[e])
                                  for e in range(x.shape[0])]), rows)


def gather_block_matmul_ref(dense, data, idx, blk, nnz, *, out_cols: int,
                            transpose_block: bool) -> torch.Tensor:
    """Direct oracle of the gather-matmul-accumulate schedule: output
    block-row ``o`` sums ``dense[:, idx[o, j]-block] @ B(blk[o, j])`` over
    ``j < nnz[o]``."""
    _, br, bc = data.shape
    n_out, jmax = idx.shape
    b_in, b_out = (bc, br) if transpose_block else (br, bc)
    out = torch.zeros((dense.shape[0], out_cols), dtype=torch.float32,
                      device=dense.device)
    d32 = dense.float()
    for o in range(n_out):
        for j in range(int(nnz[o])):
            w = data[int(blk[o, j])].float()
            if transpose_block:
                w = w.T
            c = int(idx[o, j])
            out[:, o * b_out:(o + 1) * b_out] += \
                d32[:, c * b_in:(c + 1) * b_in] @ w
    return out
