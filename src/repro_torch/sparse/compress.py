"""Whole-model compression, serving half: dense params -> ``CompressedParams``.

Port of the serving half of ``repro.sparse.compress``. Each target weight
is viewed as the 2D (out, in) matrix ``sparse_matmul`` consumes:

    attention wq/wk/wv  (d, h, hd)  -> (h*hd, d)
    attention wo        (h, hd, d)  -> (d, h*hd)
    mlp wi/wg           (d, ff)     -> (ff, d)
    mlp wo              (ff, d)     -> (d, ff)
    head                (d, vocab)  -> (vocab, d)
    (and the MoE / RWKV / RG-LRU projections, as in the reference)

Weights of the stacked layers carry a leading ``n_super`` axis: each slice
is compressed on its own, padded to a common slot count and stacked, so the
layer loop slices the compressed store like the dense one. Matrices that
do not compress (too small, too dense, no byte win) stay in the dense
residue. Pruning and format construction run on the host in numpy (the
masks match the JAX package's bit for bit: ``argsort(kind="stable")`` on
float64 block norms); the results go back to the params' device. With
``quantize_bits`` the leaves become ``PaletteBCSR``; the k-means runs on
the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import quantize as quantize_lib
from repro_torch.core.metrics import tree_leaves
from repro_torch.sparse.formats import (BlockCSR, PaletteBCSR, dense_to_bcsr,
                                        is_bcsr, pack_uint4, pad_bcsr)

PyTree = Any

_LAYER_TARGETS = {"attn": ("wq", "wk", "wv", "wo"),
                  "mlp": ("wi", "wg", "wo"),
                  "moe": ("ewi", "ewg", "ewo"),          # per-expert stacks
                  "tm": ("rwkv_r", "rwkv_k", "rwkv_v", "rwkv_g", "rwkv_o"),
                  "cm": ("cm_k", "cm_v", "cm_r"),
                  "rec": ("lru_in", "lru_gate", "lru_out")}
_PER_EXPERT = ("ewi", "ewg", "ewo")


def _lead_axes(name: str, stacked: bool) -> int:
    """Leading stack axes ahead of the per-matrix layout."""
    return int(stacked) + int(name in _PER_EXPERT)


@dataclasses.dataclass(frozen=True)
class CompressionPlan:
    """What to compress and how (the fields of the reference's plan).

    block:        default (br, bc) tile on the (out, in) view.
    min_sparsity: minimum fraction of all-zero blocks (worst slice of a
                  stack); below it the matrix stays dense.
    min_size:     matrices with fewer elements stay dense.
    overrides:    ((path_substring, (br, bc)), ...), first match wins.
    quantize_bits: None keeps fp BlockCSR; 8 or 4 emits PaletteBCSR.
    quantize_overrides: ((path_substring, bits), ...), bits 0 keeps fp.
    slot_multiple: pad every slot count up to a multiple of this (the
                  reference derives it from a device mesh; the port has no
                  mesh yet, so None means 1).
    """
    block: tuple[int, int] = (8, 128)
    min_sparsity: float = 0.5
    min_size: int = 4096
    overrides: tuple = ()
    quantize_bits: Optional[int] = None
    quantize_overrides: tuple = ()
    slot_multiple: Optional[int] = None

    def block_for(self, path: str) -> tuple[int, int]:
        for sub, blk in self.overrides:
            if sub in path:
                return tuple(blk)
        return self.block

    def bits_for(self, path: str) -> Optional[int]:
        for sub, bits in self.quantize_overrides:
            if sub in path:
                return int(bits) or None
        return self.quantize_bits


@dataclasses.dataclass
class CompressedParams:
    """Dense residue + a ``sparse`` map mirroring the params nesting
    ("layers"/<layer>/("attn"|"mlp")/<name>, "rem"/..., "head") with
    BlockCSR / PaletteBCSR leaves, stacked over ``n_super`` for the stacked
    layers. Compressed leaves of the residue are zero-size placeholders."""
    dense: PyTree
    sparse: PyTree
    plan: CompressionPlan


# ---------------------------------------------------------------------------
# (out, in) orientation
# ---------------------------------------------------------------------------

def _as_out_in(path: str, arr: np.ndarray) -> Optional[np.ndarray]:
    """View a stored weight as the 2D (out, in) matrix the kernel consumes."""
    leaf = path.rsplit("/", 1)[-1]
    if arr.ndim == 2:
        return np.ascontiguousarray(arr.T)
    if arr.ndim == 3 and "/attn/" in f"/{path}/":
        if leaf in ("wq", "wk", "wv"):          # (d, heads, hd)
            return np.ascontiguousarray(arr.reshape(arr.shape[0], -1).T)
        if leaf == "wo":                        # (heads, hd, d)
            return np.ascontiguousarray(arr.reshape(-1, arr.shape[-1]).T)
    return None


def _from_out_in(path: str, mat: np.ndarray, orig_shape) -> np.ndarray:
    """Inverse of ``_as_out_in``: back to the stored layout."""
    return np.ascontiguousarray(mat.T).reshape(orig_shape)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Block pruning aligned to the plan
# ---------------------------------------------------------------------------

def _prune_blocks_2d(mat: np.ndarray, block: tuple[int, int],
                     sparsity: float) -> np.ndarray:
    """Zero the lowest-L2 fraction of (br, bc) blocks of a (out, in) view."""
    br, bc = block
    r, c = mat.shape
    pr, pc = (-r) % br, (-c) % bc
    mp = np.pad(mat, ((0, pr), (0, pc)))
    R, C = mp.shape[0] // br, mp.shape[1] // bc
    blocks = mp.reshape(R, br, C, bc).transpose(0, 2, 1, 3).copy()
    norms = np.sqrt((blocks.astype(np.float64) ** 2).sum(axis=(2, 3)))
    k = int(round(sparsity * norms.size))
    if k > 0:
        flat = norms.ravel()
        kill = np.zeros(flat.size, bool)
        kill[np.argsort(flat, kind="stable")[:k]] = True
        blocks[kill.reshape(R, C)] = 0
    mp = blocks.transpose(0, 2, 1, 3).reshape(R * br, C * bc)
    return mp[:r, :c]


def _copy_tree(t):
    return {k: _copy_tree(v) for k, v in t.items()} if isinstance(t, dict) else t


def _per_layer_targets(params: PyTree):
    """Yield (layer dict, sub, name, path, stacked) for every compressible
    projection, in the reference's walk order."""
    for group, stacked in (("layers", True), ("rem", False)):
        for lkey, layer in params.get(group, {}).items():
            for sub, names in _LAYER_TARGETS.items():
                for name in names:
                    if sub in layer and name in layer[sub]:
                        yield layer[sub], name, f"{group}/{lkey}/{sub}/{name}", stacked


def prune_blocks_for_plan(params: PyTree, plan: CompressionPlan,
                          sparsity: float) -> PyTree:
    """Magnitude-prune whole blocks on the plan's (out, in) BCSR grid.
    Returns a new tree; leaves stay on their device and dtype."""
    out = _copy_tree(params)

    def handle(path, arr):
        view = _as_out_in(path, arr)
        if view is None or view.size < plan.min_size:
            return arr
        pruned = _prune_blocks_2d(view, plan.block_for(path), sparsity)
        return _from_out_in(path, pruned, arr.shape)

    for holder, name, path, stacked in _per_layer_targets(out):
        t = holder[name]
        arr = _np(t)
        lead = _lead_axes(name, stacked)
        if lead:
            flat = arr.reshape((-1,) + arr.shape[lead:])
            arr = np.stack([handle(path, s) for s in flat]).reshape(arr.shape)
        else:
            arr = handle(path, arr)
        holder[name] = torch.as_tensor(arr, dtype=t.dtype, device=t.device)
    if "head" in out:
        t = out["head"]
        out["head"] = torch.as_tensor(handle("head", _np(t)), dtype=t.dtype,
                                      device=t.device)
    return out


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def _stack(ms: list, lead_shape: tuple):
    """Stack same-shaped formats field-wise under ``lead_shape``."""
    first = ms[0]
    fields = {f.name: torch.stack([getattr(m, f.name) for m in ms])
              for f in dataclasses.fields(first)
              if isinstance(getattr(first, f.name), torch.Tensor)}
    fields = {k: v.reshape(lead_shape + v.shape[1:]) for k, v in fields.items()}
    return dataclasses.replace(first, **fields)


def _try_compress(arr: np.ndarray, path: str, plan: CompressionPlan,
                  n_stack: int, device) -> Optional[BlockCSR]:
    """Compress each slice below the ``n_stack`` leading axes, pad them to
    common widths and stack them; None when the matrix stays dense."""
    slices = (list(arr.reshape((-1,) + arr.shape[n_stack:])) if n_stack
              else [arr])
    views = [_as_out_in(path, s) for s in slices]
    if views[0] is None or views[0].size < plan.min_size:
        return None
    block = plan.block_for(path)
    ms = [dense_to_bcsr(v, block) for v in views]
    grid = int(np.prod(ms[0].block_grid))
    if min(1.0 - m.n_blocks / max(grid, 1) for m in ms) < plan.min_sparsity:
        return None
    # an all-zero slice gives n_blocks == 0 (only the pad slot): a valid
    # empty BCSR, and padding it alongside the others only appends zeros
    mult = max(int(plan.slot_multiple or 1), 1)
    n_slots = max(m.data.shape[0] for m in ms)
    n_slots = -(-n_slots // mult) * mult
    jmax = max(m.gather_idx.shape[1] for m in ms)
    jmax_t = max(m.gather_t_idx.shape[1] for m in ms)
    ms = [pad_bcsr(m, n_slots, jmax, jmax_t) for m in ms]
    if ms[0].nbytes >= views[0].size * views[0].dtype.itemsize:
        return None                           # dense fallback: no byte win
    out = _stack(ms, arr.shape[:n_stack]) if n_stack else ms[0]
    return out.to(device)


def _placeholder(t: torch.Tensor, n_stack: int) -> torch.Tensor:
    return torch.zeros(t.shape[:n_stack], dtype=t.dtype, device=t.device)


def compress_params(params: PyTree,
                    plan: Optional[CompressionPlan] = None) -> CompressedParams:
    """Convert every plan-eligible projection to BlockCSR (PaletteBCSR when
    the plan quantizes). The compressed leaves lie on the params' device."""
    plan = plan or CompressionPlan()
    dense = _copy_tree(params)
    sparse: dict = {}
    for holder, name, path, stacked in _per_layer_targets(dense):
        t = holder[name]
        lead = _lead_axes(name, stacked)
        m = _try_compress(_np(t), path, plan, lead, t.device)
        if m is None:
            continue
        group, lkey, sub, _ = path.split("/")
        sparse.setdefault(group, {}).setdefault(lkey, {}).setdefault(
            sub, {})[name] = m
        holder[name] = _placeholder(t, lead)
    if "head" in dense:
        t = dense["head"]
        m = _try_compress(_np(t), "head", plan, 0, t.device)
        if m is not None:
            sparse["head"] = m
            dense["head"] = _placeholder(t, 0)
    cp = CompressedParams(dense=dense, sparse=sparse, plan=plan)
    if plan.quantize_bits or plan.quantize_overrides:
        cp = quantize_compressed(cp)
    return cp


# ---------------------------------------------------------------------------
# Palette quantization (BlockCSR -> PaletteBCSR)
# ---------------------------------------------------------------------------

def quantize_bcsr(m: BlockCSR, bits: int, iters: int = 25) -> PaletteBCSR:
    """k-means palette-quantize a BlockCSR's block store.

    Each leading-axis slice (layer, expert) gets its own palette: the
    nonzero entries are clustered to 2**bits - 1 values and code 0 is kept
    for exact zero, so intra-block zeros, the pad slot and padding slots
    reproduce exactly and the index tables are shared unchanged. At 4 bits
    the codes are nibble-packed two per byte."""
    if bits not in (4, 8):
        raise ValueError(f"palette bits must be 4 or 8, got {bits}")
    if bits == 4 and m.block[1] % 2:
        raise ValueError(f"bits=4 nibble packing needs even bc, got {m.block}")
    data = m.data
    lead = tuple(data.shape[:-3])
    slices = data.reshape((-1,) + tuple(data.shape[-3:])) if lead else data[None]
    n_levels = (1 << bits) - 1                  # code 0 is reserved for 0.0
    codes_l, pal_l = [], []
    for sl in slices:
        palette, _, assign = quantize_lib.kmeans_palette(sl, n_levels,
                                                         iters=iters)
        codes = torch.where(sl.reshape(-1) != 0, assign.long() + 1,
                            torch.zeros_like(assign, dtype=torch.long))
        codes_l.append(codes.to(torch.uint8).reshape(sl.shape))
        pal_l.append(torch.cat([palette.new_zeros(1), palette]))
    codes = torch.stack(codes_l).reshape(data.shape)
    pal = torch.stack(pal_l).reshape(lead + (1 << bits,))
    if bits == 4:
        codes = pack_uint4(codes)
    return PaletteBCSR(
        codes=codes.contiguous(), palette=pal,
        col_idx=m.col_idx, row_ptr=m.row_ptr,
        gather_idx=m.gather_idx, gather_blk=m.gather_blk,
        gather_nnz=m.gather_nnz,
        gather_t_idx=m.gather_t_idx, gather_t_blk=m.gather_t_blk,
        gather_t_nnz=m.gather_t_nnz,
        shape=m.shape, block=m.block, n_blocks=m.n_blocks, bits=bits)


def iter_bcsr(cp: CompressedParams):
    """Yield (path, BlockCSR | PaletteBCSR) over the sparse map, in the
    reference's (sorted-key) order."""
    def walk(node, prefix):
        if is_bcsr(node):
            yield prefix, node
        elif isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], f"{prefix}/{k}" if prefix else k)
    yield from walk(cp.sparse, "")


def _replace_leaves(tree, fn, prefix=""):
    if is_bcsr(tree):
        return fn(prefix, tree)
    return {k: _replace_leaves(v, fn, f"{prefix}/{k}" if prefix else k)
            for k, v in tree.items()}


def quantize_compressed(cp: CompressedParams,
                        bits: Optional[int] = None) -> CompressedParams:
    """Quantize every BlockCSR leaf to PaletteBCSR per the plan's
    ``bits_for`` (or a blanket ``bits``, which also updates the plan).
    Leaves already quantized pass through."""
    plan = cp.plan
    if bits is not None:
        plan = dataclasses.replace(plan, quantize_bits=bits)

    def one(path, leaf):
        b = plan.bits_for(path) if isinstance(leaf, BlockCSR) else None
        return quantize_bcsr(leaf, b) if b else leaf

    return CompressedParams(dense=cp.dense,
                            sparse=_replace_leaves(cp.sparse, one), plan=plan)


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------

def _dense_bytes(cp: CompressedParams) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(cp.dense))


def compressed_size_bytes(cp: CompressedParams) -> int:
    """Serving bytes: dense residue + real BCSR storage (data/codes +
    palette + col_idx + row_ptr)."""
    return _dense_bytes(cp) + sum(m.nbytes for _, m in iter_bcsr(cp))


def bcsr_equiv_size_bytes(cp: CompressedParams) -> int:
    """``compressed_size_bytes`` with every palette leaf counted as the
    fp32 BlockCSR it came from (the stage-1 baseline)."""
    return _dense_bytes(cp) + sum(
        m.bcsr_equiv_nbytes if isinstance(m, PaletteBCSR) else m.nbytes
        for _, m in iter_bcsr(cp))


def format_size_report(dense_bytes: int, bcsr_bytes: int,
                       palette_bytes: Optional[int] = None) -> str:
    """One-line dense-vs-compressed byte report."""
    line = (f"model size dense={dense_bytes/2**20:.2f}MB "
            f"bcsr={bcsr_bytes/2**20:.2f}MB "
            f"({dense_bytes/max(bcsr_bytes, 1):.1f}x)")
    if palette_bytes is not None:
        line += (f" palette={palette_bytes/2**20:.2f}MB "
                 f"({dense_bytes/max(palette_bytes, 1):.1f}x)")
    return line


def compression_summary(cp: CompressedParams) -> str:
    """Per-matrix format, block occupancy and stored bytes, plus a dense
    residue / total footer (the table ``launch/serve --sparse`` prints)."""
    lines = [f"{'weight':44s} {'(out, in)':>14s} {'block':>10s} "
             f"{'fmt':>6s} {'blocks':>14s} {'bytes':>10s}"]
    sparse_total = 0
    for name, m in iter_bcsr(cp):
        grid = int(np.prod(m.block_grid))
        store = m.codes if isinstance(m, PaletteBCSR) else m.data
        lead = store.dim() - 3
        n = int(np.prod(store.shape[:lead])) if lead else 1
        fmt = f"pal{m.bits}" if isinstance(m, PaletteBCSR) else "bcsr"
        sparse_total += m.nbytes
        lines.append(
            f"{name:44s} {str(m.shape):>14s} {str(m.block):>10s} "
            f"{fmt:>6s} {m.n_blocks:>6d}/{grid:<7d} {m.nbytes:>10d}"
            + (f"  x{n} slices" if lead else ""))
    dense_residue = _dense_bytes(cp)
    lines.append(f"{'dense residue (embeddings/norms/fallback)':92s} "
                 f"{dense_residue:>10d}")
    lines.append(f"{'total serving bytes':92s} "
                 f"{sparse_total + dense_residue:>10d}")
    return "\n".join(lines)
