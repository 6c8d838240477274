"""Sparse op dispatch: the hand-written CUDA kernels vs the plain version.

Port of ``repro.sparse.ops``. ``sparse_matmul(x, w)`` is ``y = x @ w.T``
for a ``BlockCSR`` or ``PaletteBCSR`` weight, used by serving (forward
only) and by SpC-Retrain's debias phase, which trains the block store
itself. It is differentiable:

  forward   y  = x @ W'   (dense x compressed', the spmm kernel)
  backward  dx = dy @ W   (dense x compressed, ``spmm_t`` over the
                           transposed gather tables), cast to x's dtype
            dw = SDDMM    (``bsr_weight_grad``: gradients at the resident
                           slots only, never a dense (out, in) tensor),
                           cast to ``w.data``'s dtype

Backends (``resolve_backend`` is the one point that decides):
  'cuda' -- the kernels of ``kernels/bsr_spmm`` and ``kernels/bsr_sddmm``
            (a CPU tensor there runs their plain version, as every kernel
            wrapper does),
  'ref'  -- the plain versions: densify, then a plain f32 matmul (the
            result in x's dtype), and the per-slot SDDMM,
  'auto' -- 'cuda' for a CUDA tensor, 'ref' for a CPU tensor. Decided by
            the tensor's device, never by whether a card is present.

The kernel path returns f32 and the ref path x's dtype, as in the
reference, or f32 with ``f32=True``; every caller casts. An explicit 'ref' on a CUDA tensor is
allowed so the two can be compared on the card.

A ``PaletteBCSR`` is serving-only: dx goes through ``w.dequantize()`` and
the weight gets no gradient.

A 3-D x (E, M, K) with an E-stacked w (one (out, in) slice per expert, the
MoE FFN's compressed experts) gives ``y[e] = x[e] @ w[e].T``: one launch of
``spmm_experts`` / ``spmm_palette_experts`` for all E on the kernel path,
the reference's ``lax.map`` over experts on the plain path. ``rows`` (an
(E,) int32 tensor on x's device: the tokens the MoE dispatch gave each
expert, capped at its capacity) says that rows past ``rows[e]`` of x[e]
are zero and that nobody reads y there: the kernel computes rows ``[0,
rows[e])`` only and writes zeros below, the plain path zeros them after
its product, so y is the same with and without it. Its backward is the
expert form of each product, one launch for all E as well, over every
row: ``spmm_t_experts`` for dx and ``bsr_weight_grad_experts`` for dw
(each expert's padded slots get zero); dy is zero on the rows past the
counts, so their results do not change. The plain path loops the
single-matrix plain versions over the experts, as the reference maps its
VJP.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bsr_sddmm import ops as sddmm_kops
from repro_torch.kernels.bsr_spmm import ops as kops
from repro_torch.kernels.bsr_spmm import ref as kref
from repro_torch.sparse.formats import BlockCSR, PaletteBCSR


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


def _forward(x: torch.Tensor, w, backend: str, f32: bool = False,
             rows=None) -> torch.Tensor:
    quantized = isinstance(w, PaletteBCSR)
    if x.dim() == 3:
        if backend == "cuda":
            return (kops.spmm_palette_experts(x, w, rows) if quantized
                    else kops.spmm_experts(x, w, rows))
        y = (kref.spmm_palette_experts_fwd_ref(x, w, rows) if quantized
             else kref.spmm_experts_fwd_ref(x, w, rows))
    elif backend == "cuda":
        return kops.spmm_palette(x, w) if quantized else kops.spmm(x, w)
    else:
        y = (kref.spmm_palette_fwd_ref(x, w) if quantized
             else kref.spmm_fwd_ref(x, w))
    return y if f32 else y.to(x.dtype)


def _dx_product(dy: torch.Tensor, w: BlockCSR, backend: str) -> torch.Tensor:
    experts = dy.dim() == 3
    if backend == "cuda":
        return kops.spmm_t_experts(dy, w) if experts else kops.spmm_t(dy, w)
    dx = (kref.spmm_experts_bwd_ref(dy, w) if experts
          else kref.spmm_bwd_ref(dy, w))
    return dx.to(dy.dtype)


def _dw_product(x: torch.Tensor, dy: torch.Tensor, w: BlockCSR,
                backend: str) -> torch.Tensor:
    experts = x.dim() == 3
    if backend == "cuda":
        return (sddmm_kops.bsr_weight_grad_experts(x, dy, w) if experts
                else sddmm_kops.bsr_weight_grad(x, dy, w))
    return (sddmm_kops.bsr_weight_grad_experts_ref(x, dy, w) if experts
            else sddmm_kops.bsr_weight_grad_ref(x, dy, w))


class _SparseMatmul(torch.autograd.Function):
    """y = x @ W' with W a BlockCSR whose block store ``data`` is an input
    of its own (the BlockCSR is not a tensor, so autograd would not see
    it); the index and gather tables travel through ``ctx``. A 3-D x
    against an E-stacked W runs the expert forms of all three products."""

    @staticmethod
    def forward(ctx, x, data, w, backend, f32, rows):
        ctx.w, ctx.backend = w, backend
        ctx.save_for_backward(x)
        return _forward(x, w, backend, f32, rows)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        w, backend = ctx.w, ctx.backend
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _dx_product(dy, w, backend).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _dw_product(x, dy, w, backend).to(w.data.dtype)
        return dx, dw, None, None, None, None


class _PaletteMatmul(torch.autograd.Function):
    """y = x @ dequant(W)'; differentiable in x only."""

    @staticmethod
    def forward(ctx, x, w, backend, f32, rows):
        ctx.w, ctx.backend = w, backend
        ctx.x_dtype = x.dtype
        return _forward(x, w, backend, f32, rows)

    @staticmethod
    def backward(ctx, dy):
        dx = _dx_product(dy, ctx.w.dequantize(), ctx.backend)
        return dx.to(ctx.x_dtype), None, None, None, None


def sparse_matmul(x: torch.Tensor, w, backend: str = "auto",
                  f32: bool = False, rows=None) -> torch.Tensor:
    """y = x @ w.T for a compressed w (the paper's dense x compressed'), or
    y[e] = x[e] @ w[e].T for a 3-D x against E-stacked experts, computed
    on each expert's first ``rows[e]`` rows where ``rows`` is given (zeros
    below). Differentiable in x and, for a BlockCSR, in ``w.data``.
    ``f32``: the plain path returns its f32 product unrounded, as the
    kernels do."""
    backend = resolve_backend(backend, x)
    if rows is not None and x.dim() != 3:
        raise ValueError("rows counts an expert stack's rows: it needs a "
                         f"3-D x, got {tuple(x.shape)}")
    if torch.is_grad_enabled():
        if isinstance(w, PaletteBCSR):
            if x.requires_grad:
                return _PaletteMatmul.apply(x, w, backend, f32, rows)
        elif x.requires_grad or w.data.requires_grad:
            return _SparseMatmul.apply(x, w.data, w, backend, f32, rows)
    return _forward(x, w, backend, f32, rows)


def sparse_matmul_t(dy: torch.Tensor, w, backend: str = "auto") -> torch.Tensor:
    """dx = dy @ w (the paper's dense x compressed). A ``PaletteBCSR`` is
    dequantized first."""
    if isinstance(w, PaletteBCSR):
        w = w.dequantize()
    return _dx_product(dy, w, resolve_backend(backend, dy))
