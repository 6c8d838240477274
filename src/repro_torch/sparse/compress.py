"""Whole-model compression: dense params -> ``CompressedParams``, and the
SpC-Retrain helpers that train into it.

Port of ``repro.sparse.compress``. Each target weight
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
the device. ``init_compressed`` gives what ``compress_params(
prune_blocks_for_plan(model.init(gen), ...))`` gives for a random init,
part by part on the device, without the dense model or a host copy.

For training: ``make_plan_prox`` is the block group-l1 prox on the plan's
(out, in) grid in the stored layouts, so whole serving blocks hit zero
during training; ``split_trainable`` turns a ``CompressedParams`` into the
{dense residue, block stores} tree the debias phase trains, and
``densify_compressed`` scatters the blocks back into a dense tree.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import prox as prox_lib
from repro_torch.core import quantize as quantize_lib
from repro_torch.core.metrics import tree_leaves
from repro_torch.sparse.formats import (BlockCSR, PaletteBCSR, bcsr_to_dense,
                                        dense_to_bcsr, is_bcsr, pack_uint4,
                                        pad_bcsr)

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
    slot_multiple: pad every slot count up to a multiple of this (None:
                  the lcm of the active rank mesh's axis sizes, or 1
                  without a mesh, as the reference derives it).
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
    out = _pad_stack([dense_to_bcsr(v, block) for v in views], plan,
                     arr.shape[:n_stack],
                     views[0].size * views[0].dtype.itemsize)
    return None if out is None else out.to(device)


def _pad_stack(ms: list, plan: CompressionPlan, lead_shape: tuple,
               dense_nbytes: int) -> Optional[BlockCSR]:
    """The slices ``ms`` of one matrix padded to common widths and stacked
    under ``lead_shape``; None when the matrix stays dense: its sparsest
    slice is below ``plan.min_sparsity``, or the padded store saves nothing
    over the ``dense_nbytes`` of one dense slice."""
    grid = int(np.prod(ms[0].block_grid))
    if min(1.0 - m.n_blocks / max(grid, 1) for m in ms) < plan.min_sparsity:
        return None
    # an all-zero slice gives n_blocks == 0 (only the pad slot): a valid
    # empty BCSR, and padding it alongside the others only appends zeros
    mult = max(int(plan.slot_multiple or _mesh_slot_multiple()), 1)
    n_slots = max(m.data.shape[0] for m in ms)
    n_slots = -(-n_slots // mult) * mult
    jmax = max(m.gather_idx.shape[1] for m in ms)
    jmax_t = max(m.gather_t_idx.shape[1] for m in ms)
    ms = [pad_bcsr(m, n_slots, jmax, jmax_t) for m in ms]
    if ms[0].nbytes >= dense_nbytes:
        return None                           # dense fallback: no byte win
    return _stack(ms, tuple(lead_shape)) if len(lead_shape) else ms[0]


def _mesh_slot_multiple() -> int:
    """The lcm of the active rank mesh's axis sizes (1 without a mesh), as
    the reference pads slot counts under a mesh."""
    from repro_torch.distributed.sharding import current_mesh
    mesh = current_mesh()
    return int(np.lcm.reduce(list(mesh.shape.values()))) if mesh else 1


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


def _out_in_view(path: str, t: torch.Tensor) -> Optional[torch.Tensor]:
    """``_as_out_in`` for a tensor, as a view on its device."""
    if t.dim() == 2:
        return t.T
    if t.dim() == 3 and "/attn/" in f"/{path}/":
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("wq", "wk", "wv"):
            return t.reshape(t.shape[0], -1).T
        if leaf == "wo":
            return t.reshape(-1, t.shape[-1]).T
    return None


def _prune_to_bcsr(views: torch.Tensor, block: tuple[int, int],
                   sparsity: float) -> list:
    """``dense_to_bcsr(_prune_blocks_2d(v, block, sparsity), block)`` for
    each (out, in) view v of the stack ``views`` (n, out, in), in torch on
    their device: the same float64 block norms and stable sort (the masks
    agree up to ties closer than float64 rounding), one transfer of the
    (n, R, C) block occupancy to the host, where the index tables are
    built from it alone, and only the kept blocks copied. A stack is one
    layer's experts, or a single matrix."""
    br, bc = block
    n, r, c = views.shape
    n_r, n_c = -(-r // br), -(-c // bc)
    padded = torch.nn.functional.pad(views, (0, n_c * bc - c, 0, n_r * br - r))
    blocks = padded.reshape(n, n_r, br, n_c, bc).permute(0, 1, 3, 2, 4)
    sq = blocks.double()
    sq.square_()
    norms = sq.sum((3, 4)).sqrt_().reshape(n, -1)
    del sq
    keep = torch.ones(norms.shape, dtype=torch.bool, device=views.device)
    k = int(round(sparsity * norms.shape[1]))
    if k > 0:
        keep.scatter_(1, torch.argsort(norms, dim=1, stable=True)[:, :k],
                      False)
    # dense_to_bcsr keeps the blocks with any nonzero
    occupied = keep.reshape(n, n_r, n_c) & blocks.ne(0).flatten(3).any(3)
    host = occupied.cpu().numpy()
    # (slice, row, col) in row-major order within each slice, as np.nonzero
    kept = blocks[occupied.nonzero(as_tuple=True)]
    out, start = [], 0
    for occ in host:
        tables = dense_to_bcsr(occ, (1, 1))
        end = start + tables.n_blocks
        data = torch.cat([views.new_zeros(1, br, bc), kept[start:end]])
        start = end
        out.append(dataclasses.replace(tables.to(views.device), data=data,
                                       shape=(r, c), block=(br, bc)))
    return out


def init_compressed(model, plan: Optional[CompressionPlan] = None,
                    sparsity: float = 0.0,
                    gen: Optional[torch.Generator] = None) -> CompressedParams:
    """``compress_params(prune_blocks_for_plan(model.init(gen), plan,
    sparsity), plan)`` without the dense model: ``model.init`` hands over
    each super-block, remainder layer and the head as it draws them, and
    every projection in them is pruned and cut into BlockCSR slices on the
    params' device before the next part is drawn. The plan's rules apply as
    in ``compress_params`` (min_size, min_sparsity, the dense fallback,
    slot_multiple, quantize_bits); a matrix that stays dense is rebuilt,
    pruned, from its slices. At recurrentgemma-9b (8.5B parameters) one
    super-block is dense at a time, where the host path holds the f32
    model (34 GB) and walks it in numpy; an MoE layer's expert stacks are
    pruned as one batch each (olmoe-1b-7b: 64 slices of 1024 x 2048)."""
    plan = plan or CompressionPlan()
    slices: dict = {}        # path -> (stored shape of a slice, [BlockCSR])

    def prune(path: str, t: torch.Tensor, lead: int) -> torch.Tensor:
        flat = t.reshape((-1,) + t.shape[lead:]) if lead else t[None]
        views = [_out_in_view(path, s) for s in flat]
        if views[0] is None or views[0].numel() < plan.min_size:
            return t
        block = plan.block_for(path)
        slices.setdefault(path, (flat.shape[1:], []))[1].extend(
            _prune_to_bcsr(torch.stack(views), block, sparsity))
        return _placeholder(t, lead)

    def part(group: str, tree):
        if group == "head":
            return prune("head", tree, 0)
        for lkey, layer in tree.items():
            for sub, names in _LAYER_TARGETS.items():
                for name in names:
                    if sub in layer and name in layer[sub]:
                        layer[sub][name] = prune(
                            f"{group}/{lkey}/{sub}/{name}", layer[sub][name],
                            _lead_axes(name, False))
        return tree

    dense = model.init(gen, each_part=part)
    sparse: dict = {}
    for path, (shape, ms) in slices.items():
        *keys, leaf = path.split("/")
        holder = dense
        for key in keys:
            holder = holder[key]
        lead_shape = tuple(holder[leaf].shape)     # the placeholder's
        r, c = ms[0].shape
        m = _pad_stack(ms, plan, lead_shape, r * c * ms[0].data.element_size())
        if m is None:
            holder[leaf] = torch.stack(
                [bcsr_to_dense(s)[:r, :c].T.reshape(shape) for s in ms]
            ).reshape(lead_shape + tuple(shape))
            continue
        node = sparse
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = m
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
    reproduce exactly and the index tables are shared unchanged. The slices
    are clustered many at a time, in groups bounded in bytes
    (``kmeans_palettes``). At 4 bits the codes are nibble-packed two per
    byte."""
    if bits not in (4, 8):
        raise ValueError(f"palette bits must be 4 or 8, got {bits}")
    if bits == 4 and m.block[1] % 2:
        raise ValueError(f"bits=4 nibble packing needs even bc, got {m.block}")
    data = m.data
    lead = tuple(data.shape[:-3])
    slices = data.reshape((-1,) + tuple(data.shape[-3:])) if lead else data[None]
    n_levels = (1 << bits) - 1                  # code 0 is reserved for 0.0
    palettes, assign = quantize_lib.kmeans_palettes(slices, n_levels,
                                                    iters=iters)
    codes = assign.add_(1).masked_fill_(slices.reshape(assign.shape) == 0, 0)
    codes = codes.to(torch.uint8).reshape(data.shape)
    pal = torch.cat([palettes.new_zeros(palettes.shape[0], 1), palettes], 1)
    pal = pal.reshape(lead + (1 << bits,))
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


def dequantize_compressed(cp: CompressedParams) -> CompressedParams:
    """Expand every PaletteBCSR back to an fp BlockCSR (the palette values:
    lossless against the quantized model), e.g. to resume retraining."""
    return CompressedParams(
        dense=cp.dense,
        sparse=_replace_leaves(
            cp.sparse, lambda _, leaf: leaf.dequantize()
            if isinstance(leaf, PaletteBCSR) else leaf),
        plan=cp.plan)


# ---------------------------------------------------------------------------
# Plan-aligned training prox (SpC-Retrain: train *into* the BCSR grid)
# ---------------------------------------------------------------------------

_ATTN_QKV = ("wq", "wk", "wv")


def _norm_keystr(path: str) -> str:
    """keystr "['layers']['b0_attn']['mlp']['wi']" -> "layers/b0_attn/mlp/wi"
    (the path form ``CompressionPlan.block_for`` and this module use)."""
    parts = re.findall(r"\['([^']+)'\]", path)
    return "/".join(parts) if parts else path.strip("/").lstrip(".")


def make_plan_prox(plan: CompressionPlan) -> Callable:
    """Path-aware block group-l1 prox on the SAME (out, in) grid
    ``compress_params`` tiles.

    The optimizer sees weights in their stored layouts (stacked (L, d, ff)
    MLPs, (L, d, h, hd) attention, ...), while the BCSR grid lives on the
    2D (out, in) view. Block partitions map through the transpose, so
    shrinking (bc, br) tiles of the flattened (in, out) view is exactly the
    plan's (br, bc) group-l1 on (out, in): whole blocks of the serving grid
    hit exact zero during training and ``compress_params`` then needs no
    prune step. Leaves the plan does not compress (embeddings, matrices
    under ``min_size``, ...) are returned untouched: the group-l1 lambda is
    calibrated against block norms, so an elementwise l1 at the same lambda
    would wipe them out in one step.

    The returned ``prox_fn(z, tau, path="")`` takes the keystr path; the
    ``path`` keyword is how ``ProxOptimizer`` detects path-awareness. The
    stack (and expert) axes are a batch of the block reduction, where the
    reference vmaps."""

    def prox_fn(z, tau, path: str = ""):
        p = _norm_keystr(path)
        leaf = p.rsplit("/", 1)[-1]
        stacked = p.startswith("layers/")
        nd = z.dim() - (1 if stacked else 0)     # per-layer rank
        wrapped = f"/{p}/"

        def _in(sub, rank) -> bool:
            return (f"/{sub}/" in wrapped and leaf in _LAYER_TARGETS[sub]
                    and nd == rank)

        eligible = (
            ("/attn/" in wrapped and leaf in _LAYER_TARGETS["attn"]
             and nd in (2, 3))
            or _in("mlp", 2)
            or _in("moe", 3)                    # per-expert (E, in, out)
            or _in("tm", 2) or _in("cm", 2) or _in("rec", 2)
            or (leaf == "head" and nd == 2))
        if not eligible:
            return z
        br, bc = plan.block_for(p)
        lead = int(stacked) + int(leaf in _PER_EXPERT)
        shp = z.shape
        per = shp[lead:]                         # one matrix's stored shape
        if len(per) == 3 and leaf in _ATTN_QKV:  # (d, h, hd): in, out
            flat = z.reshape(*shp[:lead], per[0], per[1] * per[2])
        elif len(per) == 3:                      # attn wo (h, hd, d)
            flat = z.reshape(*shp[:lead], per[0] * per[1], per[2])
        else:                                    # 2D stored (in, out)
            flat = z
        if flat.shape[-2] * flat.shape[-1] < plan.min_size:
            return z
        # (in, out) view with transposed tiles == plan grid on (out, in)
        return prox_lib.group_l1_blocks(flat, tau, (bc, br)).reshape(shp)

    return prox_fn


# ---------------------------------------------------------------------------
# Mask-frozen retraining from a compressed model (paper section 2.4 debias)
# ---------------------------------------------------------------------------

def split_trainable(cp: CompressedParams):
    """(trainable tree, rebuild fn) of a ``CompressedParams``.

    ``trainable = {"dense": residue, "bcsr_data": {path: BlockCSR.data}}``
    holds only float tensors, for autograd and a ``ProxOptimizer``;
    ``rebuild(trainable)`` plants the block stores back into the BlockCSR
    structures. The index and gather tables are closure constants, so the
    sparsity pattern is frozen by construction, and
    ``masks.zero_mask(trainable)`` also freezes intra-block zeros and pad
    slots."""
    leaves = list(iter_bcsr(cp))
    for path, leaf in leaves:
        if isinstance(leaf, PaletteBCSR):
            raise TypeError(
                f"split_trainable got a PaletteBCSR at {path}: quantized "
                "weights are serving-only; debias before "
                "quantize_compressed(), or dequantize_compressed() first")
    trainable = {"dense": cp.dense,
                 "bcsr_data": {path: leaf.data for path, leaf in leaves}}
    plan = cp.plan
    # keep only the index structure in the closure (a zero-size data
    # slice): rebuild always overwrites data, and keeping the original
    # blocks would pin a second copy of the compressed weights
    skeleton = _replace_leaves(
        cp.sparse, lambda _, leaf: dataclasses.replace(leaf, data=leaf.data[:0]))

    def rebuild(tr) -> CompressedParams:
        data = tr["bcsr_data"]
        sparse = _replace_leaves(
            skeleton,
            lambda path, leaf: dataclasses.replace(leaf, data=data[path]))
        return CompressedParams(dense=tr["dense"], sparse=sparse, plan=plan)

    return trainable, rebuild


def densify_compressed(cp: CompressedParams, like: PyTree) -> PyTree:
    """Inverse of ``compress_params``: scatter the blocks back into a dense
    tree shaped like ``like`` (host-side, for tests and the dense-mask
    debias reference). Values come from ``cp``; ``like`` only supplies the
    stored shapes the zero-size placeholders erased. Leaves go back to
    ``like``'s devices."""
    def merge(l, d):
        if tuple(d.shape) != tuple(l.shape):      # placeholder: use like
            return _np(l).copy()
        return _np(d).copy()

    def walk(l, d):
        if isinstance(l, dict):
            return {k: walk(l[k], d[k]) for k in l}
        return merge(l, d)

    out = walk(like, cp.dense)
    for name, m in iter_bcsr(cp):
        keys = name.split("/")
        tgt = out
        for k in keys[:-1]:
            tgt = tgt[k]
        ref = tgt[keys[-1]]
        store = m.codes if isinstance(m, PaletteBCSR) else m.data
        lead = store.dim() - 3                  # layer and/or expert axes
        if lead:
            mats = []
            for i in np.ndindex(*store.shape[:lead]):
                sl = m.map(lambda t, i=i: t[i])
                mat = _np(sl.to_dense())[:sl.shape[0], :sl.shape[1]]
                mats.append(_from_out_in(name, mat, ref.shape[lead:]))
            tgt[keys[-1]] = np.stack(mats).reshape(ref.shape).astype(ref.dtype)
        else:
            mat = _np(m.to_dense())[:m.shape[0], :m.shape[1]]
            tgt[keys[-1]] = _from_out_in(name, mat, ref.shape).astype(ref.dtype)

    def back(l, a):
        if isinstance(l, dict):
            return {k: back(l[k], a[k]) for k in l}
        return torch.as_tensor(a, device=l.device)

    return back(like, out)


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
