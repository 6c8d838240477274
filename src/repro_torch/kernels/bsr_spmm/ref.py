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


def spmm_palette_fwd_ref(x: torch.Tensor, w) -> torch.Tensor:
    """Quantized forward: Y = X @ dequant(W)' for a ``PaletteBCSR`` W."""
    return spmm_fwd_ref(x, w.dequantize())


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
