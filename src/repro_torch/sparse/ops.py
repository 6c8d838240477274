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
  'ref'  -- the plain versions: densify, then a plain f32 matmul, and the
            per-slot SDDMM,
  'auto' -- 'cuda' for a CUDA tensor, 'ref' for a CPU tensor. Decided by
            the tensor's device, never by whether a card is present.

The product comes back in ``out_dtype``: the kernels' f32 sums, or the
plain version's, cast once (``None``: f32 on the kernel path, x's dtype on
the plain path, as in the reference). A caller that casts the product
straight to a 16-bit dtype passes that dtype instead (the MoE experts, the
projections of ``models/layers`` and ``models/attention``); one that keeps
the f32 product passes ``torch.float32`` (rwkv6's r, k, v and gate; the
compressed head runs on f32 x). The cast then happens inside the autograd
function, so its backward receives the cotangent in that dtype. The
cotangent of a cast to bf16 is a bf16 value (autograd's backward of
``.to(bfloat16)`` only widens it to f32), as in the reference, whose
``sparse_matmul`` VJP receives the widened cotangent of its
``.astype(dt)``. So the backward kernels run their bf16-dY forms on the
same values: no value changes, only the order of the f32 sums (an f32 dY
went as three bf16 parts, two of them zero here). An explicit 'ref' on a
CUDA tensor is allowed so the two can be compared on the card.

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
expert form of each product, one launch for all E as well, with the same
counts: ``spmm_t_experts`` for dx (rows past a count zero) and
``bsr_weight_grad_experts`` for dw (summed over the rows below each count;
each expert's padded slots zero). dy is zero on the rows past the counts
(nobody reads y there) and so is x, so neither result changes. The plain
path loops the single-matrix plain versions over the experts, as the
reference maps its VJP.
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


def _forward(x: torch.Tensor, w, backend: str, rows=None) -> torch.Tensor:
    """The f32 product: the kernel's, or the plain version's."""
    quantized = isinstance(w, PaletteBCSR)
    if x.dim() == 3:
        if backend == "cuda":
            return (kops.spmm_palette_experts(x, w, rows) if quantized
                    else kops.spmm_experts(x, w, rows))
        return (kref.spmm_palette_experts_fwd_ref(x, w, rows) if quantized
                else kref.spmm_experts_fwd_ref(x, w, rows))
    if backend == "cuda":
        return kops.spmm_palette(x, w) if quantized else kops.spmm(x, w)
    return (kref.spmm_palette_fwd_ref(x, w) if quantized
            else kref.spmm_fwd_ref(x, w))


def _dx_product(dy: torch.Tensor, w: BlockCSR, backend: str,
                rows=None) -> torch.Tensor:
    experts = dy.dim() == 3
    if backend == "cuda":
        return (kops.spmm_t_experts(dy, w, rows) if experts
                else kops.spmm_t(dy, w))
    dx = (kref.spmm_experts_bwd_ref(dy, w, rows) if experts
          else kref.spmm_bwd_ref(dy, w))
    return dx.to(dy.dtype)


def _dw_product(x: torch.Tensor, dy: torch.Tensor, w: BlockCSR,
                backend: str, rows=None) -> torch.Tensor:
    experts = x.dim() == 3
    if backend == "cuda":
        return (sddmm_kops.bsr_weight_grad_experts(x, dy, w, rows) if experts
                else sddmm_kops.bsr_weight_grad(x, dy, w))
    return (sddmm_kops.bsr_weight_grad_experts_ref(x, dy, w, rows) if experts
            else sddmm_kops.bsr_weight_grad_ref(x, dy, w))


class _SparseMatmul(torch.autograd.Function):
    """y = x @ W' with W a BlockCSR whose block store ``data`` is an input
    of its own (the BlockCSR is not a tensor, so autograd would not see
    it); the index and gather tables and the row counts travel through
    ``ctx``. A 3-D x against an E-stacked W runs the expert forms of all
    three products."""

    @staticmethod
    def forward(ctx, x, data, w, backend, out_dtype, rows):
        ctx.w, ctx.backend, ctx.rows = w, backend, rows
        ctx.save_for_backward(x)
        return _forward(x, w, backend, rows).to(out_dtype)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        w, backend, rows = ctx.w, ctx.backend, ctx.rows
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _dx_product(dy, w, backend, rows).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _dw_product(x, dy, w, backend, rows).to(w.data.dtype)
        return dx, dw, None, None, None, None


class _PaletteMatmul(torch.autograd.Function):
    """y = x @ dequant(W)'; differentiable in x only."""

    @staticmethod
    def forward(ctx, x, w, backend, out_dtype, rows):
        ctx.w, ctx.backend, ctx.rows = w, backend, rows
        ctx.x_dtype = x.dtype
        return _forward(x, w, backend, rows).to(out_dtype)

    @staticmethod
    def backward(ctx, dy):
        dx = _dx_product(dy, ctx.w.dequantize(), ctx.backend, ctx.rows)
        return dx.to(ctx.x_dtype), None, None, None, None


def sparse_matmul(x: torch.Tensor, w, backend: str = "auto",
                  out_dtype: torch.dtype | None = None,
                  rows=None) -> torch.Tensor:
    """y = x @ w.T for a compressed w (the paper's dense x compressed'), or
    y[e] = x[e] @ w[e].T for a 3-D x against E-stacked experts, computed
    on each expert's first ``rows[e]`` rows where ``rows`` is given (zeros
    below), in ``out_dtype`` (the f32 sums cast once; ``None``: f32 on the
    kernel path, x's dtype on the plain path). Differentiable in x and, for
    a BlockCSR, in ``w.data``; the backward receives the cotangent in that
    dtype."""
    backend = resolve_backend(backend, x)
    if out_dtype is None:
        out_dtype = torch.float32 if backend == "cuda" else x.dtype
    if rows is not None and x.dim() != 3:
        raise ValueError("rows counts an expert stack's rows: it needs a "
                         f"3-D x, got {tuple(x.shape)}")
    if torch.is_grad_enabled():
        if isinstance(w, PaletteBCSR):
            if x.requires_grad:
                return _PaletteMatmul.apply(x, w, backend, out_dtype, rows)
        elif x.requires_grad or w.data.requires_grad:
            return _SparseMatmul.apply(x, w.data, w, backend, out_dtype, rows)
    return _forward(x, w, backend, rows).to(out_dtype)


def sparse_matmul_t(dy: torch.Tensor, w, backend: str = "auto") -> torch.Tensor:
    """dx = dy @ w (the paper's dense x compressed). A ``PaletteBCSR`` is
    dequantized first."""
    if isinstance(w, PaletteBCSR):
        w = w.dequantize()
    return _dx_product(dy, w, resolve_backend(backend, dy))
