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

``split_rows`` cuts a (stacked) BlockCSR / PaletteBCSR into contiguous
ranges of block rows, each a self-contained store with its own tables,
which the kernels run on unchanged (a device mesh's computed-split
leaves); ``join_rows`` puts such shards back together on the device,
differentiably in the block store, and ``compact_rows`` renumbers a
joined store's slots as ``dense_to_bcsr`` numbers them.

``CSR`` (``dense_to_csr`` / ``csr_to_dense``) is the paper's elementwise
CSR, which the checkpointer stores sparse dense leaves in and the size
accounting counts; ``bcsr_density`` is a BlockCSR's resident share of its
block grid.

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


def bcsr_density(m: BlockCSR) -> float:
    """Resident blocks over the blocks of the grid."""
    R, C = m.block_grid
    return m.n_blocks / max(R * C, 1)


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


# ---------------------------------------------------------------------------
# Block-row shards (a device mesh's split along the output)
# ---------------------------------------------------------------------------

def _store_name(m) -> str:
    return "codes" if isinstance(m, PaletteBCSR) else "data"


def _lead_shape(m) -> tuple:
    return tuple(m.gather_nnz.shape[:-1])


def _split_one(m, n: int) -> list:
    """Block-row shards of one (unstacked) store, unpadded; numpy tables,
    the store sliced as a tensor on its own device."""
    R = m.gather_idx.shape[0]
    rn = R // n
    br = m.block[0]
    rp = m.row_ptr.cpu().numpy().astype(np.int64)
    g_idx = m.gather_idx.cpu().numpy()
    g_blk = m.gather_blk.cpu().numpy()
    g_nnz = m.gather_nnz.cpu().numpy()
    t_idx = m.gather_t_idx.cpu().numpy()
    t_blk = m.gather_t_blk.cpu().numpy()
    t_nnz = m.gather_t_nnz.cpu().numpy()
    col = m.col_idx.cpu().numpy()
    jt = t_idx.shape[1]
    t_valid = np.arange(jt)[None, :] < t_nnz[:, None]
    store = getattr(m, _store_name(m))
    out = []
    for j in range(n):
        r0, r1 = j * rn, (j + 1) * rn
        lo, hi = int(rp[r0]), int(rp[r1])
        slots = np.concatenate([[0], np.arange(lo + 1, hi + 1)])
        blk = g_blk[r0:r1]
        blk = np.where(blk > 0, blk - lo, 0).astype(np.int32)
        # the transposed tables keep the entries of rows r0..r1 in order
        mine = t_valid & (t_idx >= r0) & (t_idx < r1)
        order = np.argsort(~mine, axis=1, kind="stable")
        keep = np.take_along_axis(mine, order, 1)
        ti = np.where(keep, np.take_along_axis(t_idx, order, 1) - r0, 0)
        tb = np.where(keep, np.take_along_axis(t_blk, order, 1) - lo, 0)
        rows = min(rn * br, m.shape[0] - r0 * br)
        fields = dict(
            col_idx=torch.from_numpy(col[slots].astype(np.int32)),
            row_ptr=torch.from_numpy((rp[r0:r1 + 1] - lo).astype(np.int32)),
            gather_idx=torch.from_numpy(np.ascontiguousarray(g_idx[r0:r1])),
            gather_blk=torch.from_numpy(blk),
            gather_nnz=torch.from_numpy(np.ascontiguousarray(g_nnz[r0:r1])),
            gather_t_idx=torch.from_numpy(ti.astype(np.int32)),
            gather_t_blk=torch.from_numpy(tb.astype(np.int32)),
            gather_t_nnz=torch.from_numpy(mine.sum(1).astype(np.int32)))
        fields = {k: v.to(m.gather_idx.device) for k, v in fields.items()}
        fields[_store_name(m)] = store[torch.as_tensor(slots,
                                                       device=store.device)]
        out.append(dataclasses.replace(m, shape=(rows, m.shape[1]),
                                       n_blocks=hi - lo, **fields))
    return out


def _pad_any(m, n_slots: int, jmax: int, jmax_t: int):
    """``pad_bcsr`` for either format (a palette store pads its codes)."""
    if isinstance(m, BlockCSR):
        return pad_bcsr(m, n_slots, jmax, jmax_t)
    padded = pad_bcsr(m.dequantize(), n_slots, jmax, jmax_t)
    return dataclasses.replace(
        m, codes=_pad_rows(m.codes, n_slots, 0),
        **{f: getattr(padded, f) for f in (
            "col_idx", "gather_idx", "gather_blk", "gather_t_idx",
            "gather_t_blk")}, n_blocks=n_slots - 1)


def _stack_formats(ms: list, lead: tuple):
    first = ms[0]
    fields = {f.name: torch.stack([getattr(m, f.name) for m in ms]).reshape(
        lead + tuple(getattr(first, f.name).shape))
        for f in dataclasses.fields(first)
        if isinstance(getattr(first, f.name), Tensor)}
    return dataclasses.replace(first, **fields)


def split_rows(m, n: int) -> list:
    """``n`` shards of ``m`` by contiguous block rows (``n`` must divide
    the block-row count). Each shard is a self-contained BlockCSR /
    PaletteBCSR of logical shape (its rows, in): its own ``row_ptr`` and
    ``col_idx``, its rows' gather tables and its block columns' transposed
    tables, with each row's blocks in the original order, so a kernel
    sums every output element over the same blocks in the same order as on
    the whole store. Stacked (layer / expert) stores are split slice by
    slice; every shard of every slice is padded to one slot count and to
    the whole store's gather width, so the shards stack and gather alike.
    A palette leaf keeps its palette whole."""
    R = m.block_grid[0]
    if R % n:
        raise ValueError(f"{R} block rows do not split into {n} shards")
    lead = _lead_shape(m)
    slices = [m.map(lambda t, i=i: t[i]) for i in np.ndindex(*lead)] \
        if lead else [m]
    parts = [_split_one(s, n) for s in slices]          # [slice][shard]
    flat = [p for ps in parts for p in ps]
    n_slots = max(getattr(p, _store_name(p)).shape[0] for p in flat)
    jmax = m.gather_idx.shape[-1]
    jmax_t = max(max(p.gather_t_idx.shape[1] for p in flat), 1)
    shards = []
    for j in range(n):
        ms = [_pad_any(parts[i][j], n_slots, jmax, jmax_t)
              for i in range(len(slices))]
        rows = ms[0].shape
        ms = [dataclasses.replace(x, shape=rows) for x in ms]
        shards.append(_stack_formats(ms, lead) if lead else ms[0])
    return shards


def _offset(t: Tensor, valid: Tensor, off: int) -> Tensor:
    return torch.where(valid, t + off, torch.zeros_like(t))


def join_rows(shards: list, tables=None):
    """The store ``split_rows`` cut into ``shards``, on their device.

    The block store is the pad slot followed by each shard's slots past
    its own pad, so shard ``j``'s slot ``s`` becomes ``1 + j * (S - 1) +
    s - 1``; the gather tables follow, and the transposed tables merge each
    block column's entries shard by shard. Slots that padding added stay
    in the store, unreferenced (``compact_rows`` drops them). The store is
    joined with ``torch.cat``, so a gradient reaches each shard's slots.
    ``tables``, the result of an earlier join of shards with the same
    tables, is reused as it is (the tables of a trained store never
    change)."""
    first = shards[0]
    name = _store_name(first)
    stores = [getattr(s, name) for s in shards]
    store = torch.cat([stores[0][..., :1, :, :]]
                      + [s[..., 1:, :, :] for s in stores], dim=-3)
    if tables is None:
        tables = join_tables(shards)
    return dataclasses.replace(first, **tables, **{name: store})


def join_tables(shards: list) -> dict:
    """Every field of ``join_rows(shards)`` but the store and the palette
    (index and gather tables, ``shape``, ``n_blocks``)."""
    first = shards[0]
    n = len(shards)
    s_pad = getattr(first, _store_name(first)).shape[-3]
    rn = first.gather_idx.shape[-2]
    jt = first.gather_t_idx.shape[-1]
    g_blk, t_idx, t_blk, t_ok, row_ptr = [], [], [], [], [first.row_ptr]
    for j, s in enumerate(shards):
        off = j * (s_pad - 1)
        g_blk.append(_offset(s.gather_blk, s.gather_blk > 0, off))
        ok = (torch.arange(jt, device=s.gather_t_nnz.device)
              < s.gather_t_nnz[..., None])
        t_ok.append(ok)
        t_idx.append(_offset(s.gather_t_idx, ok, j * rn))
        t_blk.append(_offset(s.gather_t_blk, ok, off))
        if j:
            row_ptr.append(s.row_ptr[..., 1:] + off)
    ok = torch.cat(t_ok, -1)
    order = torch.sort((~ok).to(torch.int8), dim=-1, stable=True).indices
    keep = torch.gather(ok, -1, order)

    def merged(parts):
        t = torch.gather(torch.cat(parts, -1), -1, order)
        return torch.where(keep, t, torch.zeros_like(t))

    col = torch.cat([first.col_idx[..., :1]]
                    + [s.col_idx[..., 1:] for s in shards], -1)
    return dict(
        col_idx=col, row_ptr=torch.cat(row_ptr, -1),
        gather_idx=torch.cat([s.gather_idx for s in shards], -2),
        gather_blk=torch.cat(g_blk, -2),
        gather_nnz=torch.cat([s.gather_nnz for s in shards], -1),
        gather_t_idx=merged(t_idx), gather_t_blk=merged(t_blk),
        gather_t_nnz=sum(s.gather_t_nnz for s in shards),
        shape=(sum(s.shape[0] for s in shards), first.shape[1]),
        n_blocks=n * (s_pad - 1))


def compact_rows(m):
    """``m`` with its slots renumbered in row-major order of the blocks
    its gather tables reference (those of ``dense_to_bcsr``): the slots a
    join left unreferenced go, and a stacked store is padded back to one
    slot count across its slices. Host-side; for checkpoints and tests."""
    lead = _lead_shape(m)
    slices = [m.map(lambda t, i=i: t[i]) for i in np.ndindex(*lead)] \
        if lead else [m]
    name = _store_name(m)
    out = []
    for s in slices:
        nnz = s.gather_nnz.cpu().numpy()
        blk = s.gather_blk.cpu().numpy()
        idx = s.gather_idx.cpu().numpy()
        used = np.concatenate([blk[r, :nnz[r]] for r in range(len(nnz))]
                              + [np.zeros(0, blk.dtype)]).astype(np.int64)
        remap = np.zeros(getattr(s, name).shape[0], np.int64)
        remap[used] = np.arange(1, len(used) + 1)
        t_blk = s.gather_t_blk.cpu().numpy()
        rp = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int32)
        cols = np.concatenate([idx[r, :nnz[r]] for r in range(len(nnz))]
                              + [np.zeros(0, idx.dtype)])
        dev = s.gather_idx.device
        store = getattr(s, name)
        fields = {
            name: store[torch.as_tensor(np.concatenate([[0], used]),
                                        device=store.device)],
            "col_idx": torch.from_numpy(np.concatenate(
                [[0], cols]).astype(np.int32)).to(dev),
            "row_ptr": torch.from_numpy(rp).to(dev),
            "gather_blk": torch.from_numpy(
                remap[blk].astype(np.int32)).to(dev),
            "gather_t_blk": torch.from_numpy(
                remap[t_blk].astype(np.int32)).to(dev)}
        jt = max(int(s.gather_t_nnz.max()) if s.gather_t_nnz.numel() else 1,
                 1)
        fields["gather_t_idx"] = s.gather_t_idx[..., :jt]
        fields["gather_t_blk"] = fields["gather_t_blk"][..., :jt]
        out.append(dataclasses.replace(s, n_blocks=len(used), **fields))
    if not lead:
        return out[0]
    n_slots = max(getattr(x, name).shape[0] for x in out)
    jmax = max(x.gather_idx.shape[-1] for x in out)
    jmax_t = max(x.gather_t_idx.shape[-1] for x in out)
    return _stack_formats([_pad_any(x, n_slots, jmax, jmax_t) for x in out],
                          lead)


# ---------------------------------------------------------------------------
# Elementwise CSR (the paper's Fig. 1(iii))
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CSR:
    """ptr / indices / data elementwise CSR: ``data`` (nnz,) the nonzeros
    in row-major order, ``indices`` (nnz,) int32 their columns, ``indptr``
    (rows + 1,) int32 each row's start."""
    data: Tensor
    indices: Tensor
    indptr: Tensor
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def nbytes(self) -> int:
        return (_nbytes(self.data) + self.indices.numel() * 4
                + self.indptr.numel() * 4)


def dense_to_csr(w) -> CSR:
    """A dense 2D matrix (numpy or tensor) as CSR, built on the host; the
    tensors of the result lie on the CPU. The same arrays as the
    reference's ``dense_to_csr``."""
    w = w.detach().cpu().numpy() if isinstance(w, Tensor) else np.asarray(w)
    if w.ndim != 2:
        raise ValueError(f"dense_to_csr wants a 2D matrix, got {w.shape}")
    rows, cols = np.nonzero(w)
    indptr = np.zeros(w.shape[0] + 1, np.int32)
    np.add.at(indptr, rows + 1, 1)
    return CSR(data=torch.from_numpy(w[rows, cols]),
               indices=torch.from_numpy(cols.astype(np.int32)),
               indptr=torch.from_numpy(np.cumsum(indptr).astype(np.int32)),
               shape=tuple(w.shape))


def csr_to_dense(m: CSR) -> Tensor:
    out = torch.zeros(m.shape, dtype=m.data.dtype, device=m.data.device)
    counts = (m.indptr[1:] - m.indptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(m.shape[0], device=m.data.device), counts)
    out[rows, m.indices.long()] = m.data
    return out
