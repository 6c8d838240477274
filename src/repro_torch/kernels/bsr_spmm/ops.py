"""Wrappers of the BCSR / PaletteBCSR spmm kernels (``csrc/bsr_spmm.cu``).

``spmm(x, w)`` and ``spmm_palette(x, w)`` compute ``Y (M, N) f32 = X (M, K)
@ W'`` for a compressed W (N, K); ``spmm_t(dy, w)`` computes the backward
``dX (M, K) f32 = dY (M, N) @ W`` over the transposed tables. A BlockCSR
block store may be f32 or bf16 (training casts it to the compute dtype);
the kernels upcast it as they read. For a tensor on the CPU they run the
plain PyTorch version (``ref.py``); for a CUDA tensor they launch the
hand-written Hopper kernel or raise. There is no fallback between the two.

``launches`` counts kernel launches per wrapper, so a run can show that
its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmm import ref
from repro_torch.sparse.formats import BlockCSR, PaletteBCSR

launches = {"spmm": 0, "spmm_t": 0, "spmm_palette": 0}
_TILE = 32          # outputs per warp: (32 // br) rows x br columns
_WARPS = 8
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("bsr_spmm")
    lib.bsr_spmm_fwd.argtypes = [_P, _I, _P, _I, _P, _P, _P, _P] + [_I] * 7 \
        + [_P]
    lib.bsr_spmm_t.argtypes = [_P, _I, _P, _I, _P, _P, _P, _P] + [_I] * 7 \
        + [_P]
    lib.bsr_spmm_t.restype = _I
    lib.bsr_spmm_palette_fwd.argtypes = (
        [_P, _I, _P, _P, _I, _P, _P, _P, _P] + [_I] * 7 + [_P])
    lib.bsr_spmm_fwd.restype = _I
    lib.bsr_spmm_palette_fwd.restype = _I
    return lib


def _check(x: torch.Tensor, w, store: torch.Tensor, store_dtypes,
           store_cols: int, tables=None, in_dim: int = 1) -> torch.Tensor:
    """Validate what the kernel takes; returns x made contiguous. ``in_dim``
    is the axis of W that x's columns run along (1 forward, 0 backward)."""
    if x.device.type != "cuda":
        raise ValueError(f"spmm kernels take CUDA or CPU tensors, got {x.device}")
    if x.dim() != 2 or x.shape[1] != w.shape[in_dim]:
        raise ValueError(f"x {tuple(x.shape)} does not match W {w.shape}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"spmm kernels take f32 or bf16 x, got {x.dtype}")
    if store.dtype not in store_dtypes:
        raise TypeError(f"block store must be one of {store_dtypes}, got "
                        f"{store.dtype}")
    if store.dim() != 3 or tuple(store.shape[1:]) != (w.block[0], store_cols):
        raise ValueError(f"block store {tuple(store.shape)} does not match "
                         f"block {w.block}")
    tables = tables or (w.gather_idx, w.gather_blk, w.gather_nnz)
    for t in (store,) + tables:
        if t.device != x.device:
            raise ValueError(f"W lies on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError("W's block store and gather tables must be contiguous")
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError("gather tables must be int32")
    if w.block[0] not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"block rows must be a power of two up to {_TILE}, "
                         f"got {w.block}")
    if w.gather_idx.shape[0] != w.block_grid[0] \
            or w.gather_t_idx.shape[0] != w.block_grid[1]:
        raise ValueError("gather table rows do not match the block grid")
    return x.contiguous()


_FP_STORE = (torch.float32, torch.bfloat16)


def _launch_shape(x: torch.Tensor, w):
    m = x.shape[0]
    n_out, jmax = w.gather_idx.shape
    br, bc = w.block
    rows = _WARPS * _TILE // br          # rows of a thread block at large M
    if -(-m // rows) > 65535:
        raise ValueError(f"M = {m} exceeds the kernel's grid ({65535 * rows} rows)")
    return m, n_out, jmax, br, bc


def spmm(x: torch.Tensor, w: BlockCSR) -> torch.Tensor:
    """Y (M, N) f32 = X (M, K) @ W' for W (N, K) BlockCSR (f32 or bf16
    block store)."""
    if x.device.type == "cpu":
        return ref.spmm_fwd_ref(x, w)
    x = _check(x, w, w.data, _FP_STORE, w.block[1])
    m, n_out, jmax, br, bc = _launch_shape(x, w)
    y = torch.empty((m, w.shape[0]), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().bsr_spmm_fwd(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w.data.data_ptr(),
            int(w.data.dtype == torch.bfloat16),
            w.gather_idx.data_ptr(), w.gather_blk.data_ptr(),
            w.gather_nnz.data_ptr(), y.data_ptr(), m, x.shape[1], w.shape[0],
            n_out, jmax, br, bc, stream)
    if err:
        raise RuntimeError(f"bsr_spmm_fwd launch failed: CUDA error {err}")
    launches["spmm"] += 1
    return y


def spmm_t(dy: torch.Tensor, w: BlockCSR) -> torch.Tensor:
    """dX (M, K) f32 = dY (M, N) @ W for W (N, K) BlockCSR, over the
    block-CSC tables ``gather_t_*`` (the backward of ``spmm`` in x)."""
    if dy.device.type == "cpu":
        return ref.spmm_bwd_ref(dy, w)
    tables = (w.gather_t_idx, w.gather_t_blk, w.gather_t_nnz)
    dy = _check(dy, w, w.data, _FP_STORE, w.block[1], tables, in_dim=0)
    m = dy.shape[0]
    n_cols, jmax_t = w.gather_t_idx.shape
    br, bc = w.block
    if -(-m // 32) > 65535:
        raise ValueError(f"M = {m} exceeds the backward kernel's grid")
    dx = torch.empty((m, w.shape[1]), dtype=torch.float32, device=dy.device)
    if m == 0:
        return dx
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().bsr_spmm_t(
            dy.data_ptr(), int(dy.dtype == torch.bfloat16), w.data.data_ptr(),
            int(w.data.dtype == torch.bfloat16), w.gather_t_idx.data_ptr(),
            w.gather_t_blk.data_ptr(), w.gather_t_nnz.data_ptr(),
            dx.data_ptr(), m, w.shape[0], w.shape[1], n_cols, jmax_t, br, bc,
            stream)
    if err:
        raise RuntimeError(f"bsr_spmm_t launch failed: CUDA error {err}")
    launches["spmm_t"] += 1
    return dx


def spmm_palette(x: torch.Tensor, w: PaletteBCSR) -> torch.Tensor:
    """Y (M, N) f32 = X (M, K) @ dequant(W)' for W (N, K) PaletteBCSR; the
    palette lookup (and the nibble unpack at 4 bits) happens in the kernel."""
    if x.device.type == "cpu":
        return ref.spmm_palette_fwd_ref(x, w)
    if w.bits not in (4, 8):
        raise ValueError(f"palette bits must be 4 or 8, got {w.bits}")
    x = _check(x, w, w.codes, (torch.uint8,),
               w.block[1] // 2 if w.bits == 4 else w.block[1])
    if w.palette.shape != (1 << w.bits,) \
            or w.palette.dtype != torch.float32 or w.palette.device != x.device:
        raise ValueError(f"palette must be ({1 << w.bits},) f32 on {x.device}")
    m, n_out, jmax, br, bc = _launch_shape(x, w)
    y = torch.empty((m, w.shape[0]), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().bsr_spmm_palette_fwd(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w.codes.data_ptr(),
            w.palette.data_ptr(), w.bits, w.gather_idx.data_ptr(),
            w.gather_blk.data_ptr(), w.gather_nnz.data_ptr(), y.data_ptr(),
            m, x.shape[1], w.shape[0], n_out, jmax, br, bc, stream)
    if err:
        raise RuntimeError(f"bsr_spmm_palette_fwd launch failed: CUDA error {err}")
    launches["spmm_palette"] += 1
    return y
