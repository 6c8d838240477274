"""Sparse op dispatch: the hand-written CUDA kernels vs the plain version.

Port of ``repro.sparse.ops``, forward only. ``sparse_matmul(x, w)`` is
``y = x @ w.T`` for a ``BlockCSR`` or ``PaletteBCSR`` weight.

Backends (``resolve_backend`` is the one point that decides):
  'cuda' -- the kernels of ``kernels/bsr_spmm`` (a CPU tensor there runs
            their plain version, as every kernel wrapper does),
  'ref'  -- densify, then a plain f32 matmul; the result in x's dtype,
  'auto' -- 'cuda' for a CUDA tensor, 'ref' for a CPU tensor. Decided by
            the tensor's device, never by whether a card is present.

The kernel path returns f32 and the ref path x's dtype, as in the
reference; every caller casts. An explicit 'ref' on a CUDA tensor is
allowed so the two can be compared on the card.

The backward (dx through the transposed tables, dw by SDDMM at the resident
slots) comes with the training slice (ROADMAP Queue 1 item 10); until then
differentiating through ``sparse_matmul`` raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bsr_spmm import ops as kops
from repro_torch.kernels.bsr_spmm import ref as kref
from repro_torch.sparse.formats import PaletteBCSR


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """'auto' -> 'cuda' for a CUDA tensor, 'ref' for a CPU one; validates
    explicit choices. The paged attention of the engine dispatches through
    it too, as in the reference."""
    if backend == "auto":
        return "cuda" if x.is_cuda else "ref"
    if backend not in ("cuda", "ref"):
        raise ValueError(f"unknown backend {backend!r}: 'auto', 'cuda' or "
                         "'ref'")
    return backend


def _forward(x: torch.Tensor, w, backend: str) -> torch.Tensor:
    quantized = isinstance(w, PaletteBCSR)
    if backend == "cuda":
        return kops.spmm_palette(x, w) if quantized else kops.spmm(x, w)
    y = kref.spmm_palette_fwd_ref(x, w) if quantized else kref.spmm_fwd_ref(x, w)
    return y.to(x.dtype)


class _SparseMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, backend):
        return _forward(x, w, backend)

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError(
            "sparse_matmul has no backward yet: dx via spmm_t and dw via "
            "SDDMM come with the training slice (ROADMAP Queue 1 item 10)")


def sparse_matmul(x: torch.Tensor, w, backend: str = "auto") -> torch.Tensor:
    """y = x @ w.T for a compressed w (the paper's dense x compressed')."""
    backend = resolve_backend(backend, x)
    if x.requires_grad and torch.is_grad_enabled():
        return _SparseMatmul.apply(x, w, backend)
    return _forward(x, w, backend)
