"""Plain PyTorch version of the SDDMM block-gradient kernel.

Written per slot: the dY and X slabs of each resident block are gathered
and multiplied in one batched product, so no dense (N, K) weight gradient
is formed here either (the JAX oracle forms dense dY'X, then gathers).
"""
from __future__ import annotations

import torch


def sddmm_block_grad_ref(dy, x, slot_rows, slot_cols, n_slots: int, br: int,
                         bc: int) -> torch.Tensor:
    """dy: (M, R*br), x: (M, C*bc), both padded to the block grid;
    returns (n_slots, br, bc) f32 with dW[s] = dY[:, r_s block]' X[:, c_s block]."""
    m = dy.shape[0]
    dyb = dy.float().reshape(m, -1, br)[:, slot_rows.long()]   # (M, S, br)
    xb = x.float().reshape(m, -1, bc)[:, slot_cols.long()]     # (M, S, bc)
    assert dyb.shape[1] == n_slots
    return torch.einsum("msr,msc->src", dyb, xb)
