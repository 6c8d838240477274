"""Wrapper of the SDDMM block-gradient kernel (``csrc/bsr_sddmm.cu``).

``bsr_weight_grad(x, dy, w)`` gives the (n_slots, br, bc) f32 gradient of a
BlockCSR's block store: ``dW[s] = dY[:, r_s block]' @ X[:, c_s block]``
summed over the M rows, at the resident slots only, aligned with
``w.data``. Slot 0 (the pad) and the slots ``pad_bcsr`` appended carry
zero. No dense (N, K) gradient is formed on either path.

``bsr_weight_grad_experts(x, dy, w, rows)`` takes E problems at once, x
(E, M, K) and dy (E, M, N) against an E-stacked BlockCSR (the MoE FFN's
compressed experts): the (E, n_slots, br, bc) f32 gradient of its store,
each expert's padded slots zero, in one launch of the expert backward's
SDDMM (``csrc/bsr_experts_bwd.cu``, ``bsr_experts_dw``; the reference maps
one VJP per expert). ``rows``, an optional (E,) int32 tensor on x's
device, is the count of each expert's occupied rows: the sums run over
rows ``[0, rows[e])`` only, read on the device (``None``: every row).

For tensors on the CPU they run the plain version (``ref.py``); for CUDA
tensors they launch the kernel or raise. There is no fallback. The
single-matrix kernel groups slots by block-column through the block-CSC
tables and, where the grid would leave SMs idle, splits M into
``m_split`` ranges whose partial sums a second pass adds in a fixed order
(bit-equal run to run); the expert kernel takes each block-column of each
expert in one thread block.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, _counts
from repro_torch.kernels._tiles import aligned16, sm_count
from repro_torch.kernels.bsr_sddmm import ref
from repro_torch.kernels.bsr_spmm import ops as spmm_ops
from repro_torch.kernels.bsr_spmm.ref import occupied
from repro_torch.obs.profile import kernel_call
from repro_torch.sparse.formats import BlockCSR, PaletteBCSR

launches = {"bsr_sddmm": 0, "bsr_sddmm_experts": 0}
_CHUNK = 64                     # rows of M staged per pass
_WARPS = 4                      # warps per thread block
# slot coordinates per gather table, newest last (see ``_coordinates``)
_COORDS: collections.OrderedDict = collections.OrderedDict()
_COORDS_MAX = 1024


def reset_launches() -> None:
    _counts.reset(launches)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("bsr_sddmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bsr_sddmm.argtypes = [p, i, p, i, p, p, p, p, p, p] + [i] * 11 + [p]
    lib.bsr_sddmm.restype = i
    return lib


def _reject_palette(w) -> None:
    """Palette weights are serving-only: there is no fp block store to
    take a gradient for. Debias before ``quantize_compressed``, or
    ``dequantize_compressed`` first."""
    if isinstance(w, PaletteBCSR):
        raise TypeError(
            "bsr_weight_grad got a PaletteBCSR: quantized weights are not "
            "trainable; debias before quantize_compressed(), or "
            "dequantize_compressed() to resume retraining")


def _key(t: torch.Tensor) -> tuple:
    # an inference tensor keeps no version counter
    version = -1 if t.is_inference() else t._version
    return (t.device, t.dtype, t.data_ptr(), tuple(t.shape), t.stride(),
            version)


def _coordinates(w: BlockCSR) -> tuple:
    """(rows, cols, valid, valid as int32) of ``w``'s gather tables,
    computed once per table. Debias freezes the tables for its whole phase,
    and every layer's tables are views of one stacked store that lives as
    long as the phase, so each backward finds them here instead of running
    the ten small ops of ``slot_coordinates`` again. The key is the tables'
    memory, layout and version counter; the entry holds the tables
    themselves, so their memory cannot be handed to other tables while the
    entry lives, and an in-place change to them misses."""
    key = (_key(w.gather_idx), _key(w.gather_blk), w.data.shape[-3])
    hit = _COORDS.get(key)
    if hit is not None:
        _COORDS.move_to_end(key)
        return hit[1]
    rows, cols, valid = _slot_coordinates(w)
    coords = (rows, cols, valid, valid.to(torch.int32))
    _COORDS[key] = ((w.gather_idx, w.gather_blk), coords)
    if len(_COORDS) > _COORDS_MAX:
        _COORDS.popitem(last=False)
    return coords


def slot_coordinates(w: BlockCSR):
    """Per-slot (block-row, block-col, valid) int32 / int32 / bool vectors,
    derived from the gather tables on their device (computed once per
    table, see ``_coordinates``; callers must not write to them). For a
    stacked store each is (*lead, n_slots): one row per slice.

    ``valid`` marks the slots a gather entry references: slot 0 and any
    trailing slots added by ``pad_bcsr`` are invalid and carry zero
    gradient. The scatter writes slot 0 many times (every padded gather
    entry points there), and which duplicate wins is undefined, so slot 0
    is reset afterwards, as in the reference. Nothing here waits for the
    device: no host scalar is copied over and no output is sized from
    device data."""
    return _coordinates(w)[:3]


def _slot_coordinates(w: BlockCSR):
    n_slots = w.data.shape[-3]
    lead = tuple(w.gather_idx.shape[:-2])
    r_grid, jmax = w.gather_idx.shape[-2:]
    dev = w.gather_idx.device
    n = math.prod(lead)
    slots = w.gather_blk.reshape(n, -1).long()
    entries = torch.arange(r_grid * jmax, device=dev).expand(n, -1)
    keep = (torch.arange(n_slots, device=dev) != 0).to(torch.int32)

    def scatter(src):
        out = torch.zeros((n, n_slots), dtype=torch.int32, device=dev)
        out = out.scatter_(1, slots, src.to(torch.int32)) * keep
        return out.reshape(lead + (n_slots,))

    rows = scatter(torch.div(entries, jmax, rounding_mode="floor"))
    cols = scatter(w.gather_idx.reshape(n, -1))
    valid = scatter(torch.ones_like(entries)) != 0
    return rows, cols, valid


def bsr_weight_grad_ref(x, dy, w: BlockCSR) -> torch.Tensor:
    """The plain version: pad x and dy to the block grid, then the
    per-slot product of ``ref.sddmm_block_grad_ref``."""
    _reject_palette(w)
    rows, cols, valid = slot_coordinates(w)
    br, bc = w.block
    r_grid, c_grid = w.block_grid
    dy = torch.nn.functional.pad(dy, (0, r_grid * br - dy.shape[1]))
    x = torch.nn.functional.pad(x, (0, c_grid * bc - x.shape[1]))
    out = ref.sddmm_block_grad_ref(dy, x, rows, cols, w.data.shape[0], br, bc)
    return out * valid[:, None, None].to(out.dtype)


def m_split(m: int, n_slots: int, block, sms: int) -> int:
    """Ranges of M (whole 64-row chunks) the single-matrix kernel splits the
    rows into: doubled while the thread blocks (4 / n-tiles slots each, per
    128 columns and 32 rows of the block) would leave SMs idle."""
    br, bc = block
    n_tiles = 1 if br <= 8 else 2 if br <= 16 else 4
    blocks = (-(-n_slots // (_WARPS // n_tiles)) * -(-bc // 128)
              * -(-br // 32))
    split = 1
    while 2 * split <= -(-m // _CHUNK) and blocks * split < sms:
        split *= 2
    return split


def bsr_weight_grad_experts_ref(x, dy, w: BlockCSR, rows=None) -> torch.Tensor:
    """The plain version of the expert form: ``bsr_weight_grad_ref`` on
    each expert's slice, as the reference's VJP runs per expert under its
    ``lax.map``; with ``rows``, over each expert's rows ``[0, rows[e])``
    (x and dy zeroed at and past the count, so the sums are those of the
    call without counts wherever the inputs are zero there)."""
    if rows is not None:
        x, dy = occupied(x, rows), occupied(dy, rows)
    return torch.stack([bsr_weight_grad_ref(x[e], dy[e], w[e])
                        for e in range(x.shape[0])])


def _check(x, dy, w: BlockCSR, experts: int):
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"bsr_sddmm takes x and dy on one CUDA device, got "
                         f"{x.device} and {dy.device}")
    n, k = w.shape
    lead = (experts,) if experts else ()
    if x.shape != lead + (dy.shape[-2], k) or dy.shape != lead + (
            x.shape[-2], n):
        raise ValueError(f"x {tuple(x.shape)} / dy {tuple(dy.shape)} do not "
                         f"match W {w.shape}" + (f" and {experts} experts"
                                                 if experts else ""))
    for t in (x, dy):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"bsr_sddmm takes f32 or bf16, got {t.dtype}")
    tables = (w.gather_idx, w.gather_t_idx, w.gather_t_blk, w.gather_t_nnz)
    if any(t.device != x.device or not t.is_contiguous() for t in tables):
        raise ValueError("W's gather tables must be contiguous, on x's device")
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError("gather tables must be int32")
    if w.gather_t_nnz.dim() != 1 + len(lead) or any(
            tuple(t.shape[:len(lead)]) != lead for t in tables + (w.data,)):
        raise ValueError(
            f"W's stack {tuple(w.data.shape[:-3])} does not match x "
            f"{tuple(x.shape)}: bsr_weight_grad takes one matrix, "
            "bsr_weight_grad_experts one slice per expert")
    if w.gather_t_idx.shape[-2] != w.block_grid[1]:
        raise ValueError("block-CSC table rows do not match the block grid")
    return x.contiguous(), dy.contiguous()


def bsr_weight_grad(x, dy, w: BlockCSR) -> torch.Tensor:
    """x: (M, K) activations; dy: (M, N) output cotangent; w: (N, K)
    BlockCSR. Returns (n_slots, br, bc) f32 gradient blocks for w.data."""
    return kernel_call("bsr_sddmm/bsr_weight_grad", _bsr_weight_grad, x, dy,
                       w)


def bsr_weight_grad_experts(x, dy, w: BlockCSR, rows=None) -> torch.Tensor:
    """x: (E, M, K); dy: (E, M, N); w: an E-stacked BlockCSR of (N, K)
    slices; rows: None or (E,) int32 on x's device, each expert's occupied
    rows. Returns (E, n_slots, br, bc) f32 gradient blocks for w.data
    summed over rows ``[0, rows[e])``, in one launch for all E."""
    return kernel_call("bsr_sddmm/bsr_weight_grad_experts",
                       _bsr_weight_grad_experts, x, dy, w, rows)


def _bsr_weight_grad(x, dy, w: BlockCSR) -> torch.Tensor:
    _reject_palette(w)
    if x.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)}: bsr_weight_grad takes a 2-D x, "
                         "bsr_weight_grad_experts a 3-D one")
    if x.device.type == "cpu":
        return bsr_weight_grad_ref(x, dy, w)
    x, dy = _check(x, dy, w, 0)
    valid = _coordinates(w)[3]
    n_slots = w.data.shape[0]
    br, bc = w.block
    m = x.shape[0]
    n_cols, jmax_t = w.gather_t_idx.shape
    out = torch.empty((n_slots, br, bc), dtype=torch.float32, device=x.device)
    split = m_split(m, n_slots, w.block, sm_count(x.device.index or 0))
    scratch = (torch.empty((split, n_slots, br, bc), dtype=torch.float32,
                           device=x.device) if split > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().bsr_sddmm(
            dy.data_ptr(), int(dy.dtype == torch.bfloat16), x.data_ptr(),
            int(x.dtype == torch.bfloat16), w.gather_t_idx.data_ptr(),
            w.gather_t_blk.data_ptr(), w.gather_t_nnz.data_ptr(),
            valid.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), m, w.shape[0],
            w.shape[1], n_cols, jmax_t, n_slots, br, bc, split,
            aligned16(x, w.shape[1], bc), aligned16(dy, w.shape[0], br), stream)
    if err:
        raise RuntimeError(f"bsr_sddmm launch failed: CUDA error {err}")
    _counts.bump(launches, "bsr_sddmm")
    return out


def _bsr_weight_grad_experts(x, dy, w: BlockCSR, rows=None) -> torch.Tensor:
    _reject_palette(w)
    if x.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)}: bsr_weight_grad takes a 2-D x, "
                         "bsr_weight_grad_experts a 3-D one")
    if x.device.type == "cpu":
        return bsr_weight_grad_experts_ref(x, dy, w, rows)
    n_exp = x.shape[0]
    x, dy = _check(x, dy, w, n_exp)
    if rows is not None:
        spmm_ops.check_rows(rows, x)
    br, bc = w.block
    if br not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"block rows must be a power of two up to 32, got "
                         f"{w.block}")
    valid = _coordinates(w)[3]
    n_slots = w.data.shape[-3]
    m = x.shape[1]
    n_cols, jmax_t = w.gather_t_idx.shape[-2:]
    out = torch.empty(w.data.shape[:-2] + (br, bc), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = spmm_ops.experts_bwd_lib().bsr_sddmm_experts(
            dy.data_ptr(), int(dy.dtype == torch.bfloat16), x.data_ptr(),
            int(x.dtype == torch.bfloat16), w.gather_t_idx.data_ptr(),
            w.gather_t_blk.data_ptr(), w.gather_t_nnz.data_ptr(),
            valid.data_ptr(), rows.data_ptr() if rows is not None else None,
            out.data_ptr(), m, w.shape[0], w.shape[1], n_cols, jmax_t,
            n_slots, br, bc, aligned16(x, w.shape[1], bc),
            aligned16(dy, w.shape[0], br), n_exp, stream)
    if err:
        raise RuntimeError(f"bsr_sddmm_experts launch failed: CUDA error "
                           f"{err}")
    _counts.bump(launches, "bsr_sddmm_experts")
    return out
