"""Compressed sparse weight formats: BlockCSR and PaletteBCSR, in torch.

Port of ``repro.sparse.formats``. A weight matrix of logical ``shape``
(out, in) is tiled into (br, bc) blocks and only blocks holding a nonzero
are stored. Beside the classic (data, col_idx, row_ptr) arrays each format
carries padded *gather tables*: per output block-row a fixed-width list of
(block-col, data-slot) pairs, which is what the spmm kernels walk. The
transposed (block-CSC) tables serve the backward product.

Construction (``dense_to_bcsr``) runs on the host in numpy and gives the
same tables as the JAX package, entry for entry. The formats hold torch
tensors and move with ``.to(device)``.

Invariants shared with the reference:
  * slot 0 of the block store is an all-zero pad block, so padded gather
    entries can point at it harmlessly;
  * ``PaletteBCSR.palette[0] == 0``, so code 0 is an exact zero and the
    sparsity pattern survives quantization.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


class _TensorFields:
    """Shared behaviour of the two formats: map a function over every
    tensor field (device moves, slicing a stacked layer store)."""

    def map(self, fn: Callable[[Tensor], Tensor]):
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), Tensor)})

    def to(self, device):
        return self.map(lambda t: t.to(device))

    def __getitem__(self, i):
        """Slice of a stacked store: every array field indexed on its
        leading (layer or expert) axis."""
        return self.map(lambda t: t[i])

    @property
    def block_grid(self) -> tuple[int, int]:
        br, bc = self.block
        return (-(-self.shape[0] // br), -(-self.shape[1] // bc))


def _nbytes(*ts: Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclasses.dataclass(frozen=True)
class BlockCSR(_TensorFields):
    """Block-CSR sparse matrix of logical ``shape`` with (br, bc) blocks.

    data:       (n_slots, br, bc) blocks; slot 0 is the all-zero pad.
    col_idx:    (n_slots,) int32 block column of each slot (0 for the pad).
    row_ptr:    (R+1,) int32 CSR pointers into slots 1..n_blocks.
    gather_*:   (R, Jmax) per-block-row tables of the forward kernel;
                gather_nnz (R,) is the valid prefix length of each row.
    gather_t_*: the transposed (block-CSC) tables, (C, Jmax_t).

    A stacked store (one slice per layer) carries a leading axis on every
    array field; ``m[i]`` is slice ``i``.
    """
    data: Tensor
    col_idx: Tensor
    row_ptr: Tensor
    gather_idx: Tensor
    gather_blk: Tensor
    gather_nnz: Tensor
    gather_t_idx: Tensor
    gather_t_blk: Tensor
    gather_t_nnz: Tensor
    shape: tuple[int, int]
    block: tuple[int, int]
    n_blocks: int

    @property
    def nbytes(self) -> int:
        return _nbytes(self.data, self.col_idx, self.row_ptr)

    def to_dense(self) -> Tensor:
        return bcsr_to_dense(self)


def dense_to_bcsr(w, block: tuple[int, int] = (128, 128),
                  pad_rows_to_multiple: bool = True) -> BlockCSR:
    """Convert a dense 2D matrix to BlockCSR, keeping blocks with any
    nonzero. Host-side numpy; the tensors of the result lie on the CPU."""
    w = np.asarray(w)
    if w.ndim != 2:
        raise ValueError(f"dense_to_bcsr wants a 2D matrix, got {w.shape}")
    br, bc = block
    r, c = w.shape
    pr, pc = (-r) % br, (-c) % bc
    if pr or pc:
        if not pad_rows_to_multiple:
            raise ValueError(f"shape {w.shape} not divisible by block {block}")
        w = np.pad(w, ((0, pr), (0, pc)))
    R, C = w.shape[0] // br, w.shape[1] // bc
    wb = w.reshape(R, br, C, bc).transpose(0, 2, 1, 3)  # (R, C, br, bc)
    nz = np.any(wb != 0, axis=(2, 3))                   # block occupancy

    rows, cols = np.nonzero(nz)                         # row-major order
    n_blocks = len(rows)
    data = np.zeros((n_blocks + 1, br, bc), dtype=w.dtype)
    data[1:] = wb[rows, cols]
    col_idx = np.zeros(n_blocks + 1, dtype=np.int32)
    col_idx[1:] = cols
    row_ptr = np.zeros(R + 1, dtype=np.int32)
    np.add.at(row_ptr, rows + 1, 1)
    row_ptr = np.cumsum(row_ptr).astype(np.int32)

    # forward gather tables (per block row)
    jmax = max(int(np.max(row_ptr[1:] - row_ptr[:-1])), 1) if R else 1
    g_idx = np.zeros((R, jmax), np.int32)
    g_blk = np.zeros((R, jmax), np.int32)
    g_nnz = np.zeros(R, np.int32)
    for rr in range(R):
        lo, hi = row_ptr[rr], row_ptr[rr + 1]
        g_idx[rr, :hi - lo] = cols[lo:hi]
        g_blk[rr, :hi - lo] = np.arange(lo + 1, hi + 1)  # +1: slot 0 is the pad
        g_nnz[rr] = hi - lo

    # transposed (block-CSC) gather tables (per block column)
    order = np.lexsort((rows, cols))
    t_rows, t_cols, t_slots = rows[order], cols[order], order + 1
    tn = np.zeros(C, np.int32)
    np.add.at(tn, t_cols, 1)
    jmax_t = max(int(tn.max()) if C else 1, 1)
    t_idx = np.zeros((C, jmax_t), np.int32)
    t_blk = np.zeros((C, jmax_t), np.int32)
    fill = np.zeros(C, np.int32)
    for rr, cc, ss in zip(t_rows, t_cols, t_slots):
        t_idx[cc, fill[cc]] = rr
        t_blk[cc, fill[cc]] = ss
        fill[cc] += 1

    t = torch.from_numpy
    return BlockCSR(
        data=t(data), col_idx=t(col_idx), row_ptr=t(row_ptr),
        gather_idx=t(g_idx), gather_blk=t(g_blk), gather_nnz=t(g_nnz),
        gather_t_idx=t(t_idx), gather_t_blk=t(t_blk), gather_t_nnz=t(tn),
        shape=(r, c), block=(br, bc), n_blocks=n_blocks)


def bcsr_to_dense(m: BlockCSR) -> Tensor:
    """Scatter the blocks back into a (R*br, C*bc) dense matrix (the block
    grid; slice ``[:shape[0], :shape[1]]`` for the logical matrix)."""
    br, bc = m.block
    R, C = m.block_grid
    jmax = m.gather_idx.shape[1]
    rr = torch.arange(R, device=m.data.device).repeat_interleave(jmax)
    cc = m.gather_idx.reshape(-1).long()
    blocks = m.data[m.gather_blk.reshape(-1).long()]   # pad entries give 0
    dense = torch.zeros((R, C, br, bc), dtype=m.data.dtype,
                        device=m.data.device)
    dense.index_put_((rr, cc), blocks, accumulate=True)
    return dense.permute(0, 2, 1, 3).reshape(R * br, C * bc)


def _pad_rows(t: Tensor, n: int, dim: int) -> Tensor:
    """Append zeros along ``dim`` up to size ``n``."""
    extra = n - t.shape[dim]
    if not extra:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def pad_bcsr(m: BlockCSR, n_slots: int, jmax: int, jmax_t: int) -> BlockCSR:
    """Pad a BlockCSR's slot store and gather tables to fixed widths.

    Extra slots are zero blocks and extra gather columns point at slot 0,
    so the product is unchanged. This makes the stores of differently
    pruned layers shape-compatible so they stack. ``n_blocks`` becomes the
    padded slot count, as in the reference."""
    cur_slots = m.data.shape[0]
    cur_j, cur_jt = m.gather_idx.shape[1], m.gather_t_idx.shape[1]
    if n_slots < cur_slots or jmax < cur_j or jmax_t < cur_jt:
        raise ValueError(f"pad_bcsr cannot shrink: asked {(n_slots, jmax, jmax_t)}"
                         f", have {(cur_slots, cur_j, cur_jt)}")
    return dataclasses.replace(
        m,
        data=_pad_rows(m.data, n_slots, 0),
        col_idx=_pad_rows(m.col_idx, n_slots, 0),
        gather_idx=_pad_rows(m.gather_idx, jmax, 1),
        gather_blk=_pad_rows(m.gather_blk, jmax, 1),
        gather_t_idx=_pad_rows(m.gather_t_idx, jmax_t, 1),
        gather_t_blk=_pad_rows(m.gather_t_blk, jmax_t, 1),
        n_blocks=n_slots - 1)


# ---------------------------------------------------------------------------
# PaletteBCSR: quantized block store (Deep Compression stage 2)
# ---------------------------------------------------------------------------

def pack_uint4(codes: Tensor) -> Tensor:
    """Pack uint8 codes < 16 two per byte along the last axis (even length).

    Byte k holds codes[2k] in the low nibble and codes[2k+1] in the high
    nibble, so ``unpack_uint4(pack_uint4(c)) == c``."""
    if codes.shape[-1] % 2:
        raise ValueError(f"pack_uint4 needs an even last axis, got {codes.shape}")
    c = codes.to(torch.uint8)
    return c[..., 0::2] | (c[..., 1::2] << 4)


def unpack_uint4(packed: Tensor) -> Tensor:
    """Inverse of ``pack_uint4``: (..., n) uint8 -> (..., 2n) uint8 codes."""
    p = packed.to(torch.uint8)
    return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(
        *p.shape[:-1], p.shape[-1] * 2)


def dequantize_codes(codes: Tensor, palette: Tensor, bits: int) -> Tensor:
    """Palette lookup: codes (uint8, nibble-packed at 4 bits) -> fp blocks.

    ``palette`` is (P,) for one matrix or (*lead, P) for a stacked store,
    with ``codes`` carrying the same leading axes."""
    if bits == 4:
        codes = unpack_uint4(codes)
    idx = codes.long()
    if palette.dim() == 1:
        return palette[idx]
    lead = palette.shape[:-1]
    n = int(np.prod(lead))
    pf = palette.reshape(n, palette.shape[-1])
    cf = idx.reshape(n, -1)
    return torch.gather(pf, 1, cf).reshape(codes.shape)


@dataclasses.dataclass(frozen=True)
class PaletteBCSR(_TensorFields):
    """Palette-quantized BlockCSR: the index and gather tables of a
    ``BlockCSR``, with block values stored as palette codes.

    codes:   (n_slots, br, bc) uint8 at bits=8; (n_slots, br, bc//2) uint8
             at bits=4, two codes per byte, low nibble first.
    palette: (2**bits,) fp32 with palette[0] == 0 exactly.
    bits:    4 or 8.
    """
    codes: Tensor
    palette: Tensor
    col_idx: Tensor
    row_ptr: Tensor
    gather_idx: Tensor
    gather_blk: Tensor
    gather_nnz: Tensor
    gather_t_idx: Tensor
    gather_t_blk: Tensor
    gather_t_nnz: Tensor
    shape: tuple[int, int]
    block: tuple[int, int]
    n_blocks: int
    bits: int

    @property
    def nbytes(self) -> int:
        """Serving bytes: packed codes + palette + block indices."""
        return _nbytes(self.codes, self.palette, self.col_idx, self.row_ptr)

    @property
    def bcsr_equiv_nbytes(self) -> int:
        """Bytes the same blocks take as an fp32 BlockCSR."""
        n_entries = self.codes.numel() * (2 if self.bits == 4 else 1)
        return n_entries * 4 + self.col_idx.numel() * 4 \
            + self.row_ptr.numel() * 4

    def dequantize(self) -> BlockCSR:
        """Expand to an fp BlockCSR with the same index/gather tables."""
        return BlockCSR(
            data=dequantize_codes(self.codes, self.palette, self.bits),
            col_idx=self.col_idx, row_ptr=self.row_ptr,
            gather_idx=self.gather_idx, gather_blk=self.gather_blk,
            gather_nnz=self.gather_nnz,
            gather_t_idx=self.gather_t_idx, gather_t_blk=self.gather_t_blk,
            gather_t_nnz=self.gather_t_nnz,
            shape=self.shape, block=self.block, n_blocks=self.n_blocks)

    def to_dense(self) -> Tensor:
        return bcsr_to_dense(self.dequantize())


def is_bcsr(x) -> bool:
    return isinstance(x, (BlockCSR, PaletteBCSR))
