"""Wrappers of the BCSR / PaletteBCSR spmm kernels (``csrc/bsr_spmm.cu``).

``spmm(x, w)`` and ``spmm_palette(x, w)`` compute ``Y (M, N) f32 = X (M, K)
@ W'`` for a compressed W (N, K); ``spmm_t(dy, w)`` computes the backward
``dX (M, K) f32 = dY (M, N) @ W`` over the transposed tables. A BlockCSR
block store may be f32 or bf16 (training casts it to the compute dtype);
the kernels upcast it as they read. For a tensor on the CPU they run the
plain PyTorch version (``ref.py``); for a CUDA tensor they launch the
hand-written Hopper kernel or raise. There is no fallback between the two.

The forward has two kernels, dispatched by M: the tensor-core tile kernel
for M > ``DECODE_MAX_M`` (prefill, training) and the decode kernel, an
f32 FMA kernel with a warp per resident block, for M <= ``DECODE_MAX_M``,
where a 16-row mma tile would be mostly padding. ``spmm_t`` runs on the
tensor-core tile core too (see ``csrc/bsr_spmm.cu``). A failure of any
raises. Each kernel's shape of grid is chosen here from shapes alone
(``decode_warps``, ``spmm_t_rows``), with no wait for the device.

``launches`` counts kernel launches per wrapper, so a run can show that
its path went through the kernels; ``variant_launches`` splits the
forward's counts by kernel (``spmm`` = ``spmm_decode`` + ``spmm_tile``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import aligned16, sm_count
from repro_torch.kernels.bsr_spmm import ref
from repro_torch.sparse.formats import BlockCSR, PaletteBCSR

launches = {"spmm": 0, "spmm_t": 0, "spmm_palette": 0}
variant_launches = {"spmm_decode": 0, "spmm_tile": 0,
                    "spmm_palette_decode": 0, "spmm_palette_tile": 0}
# The forward runs the decode kernel up to this many rows of X (one mma
# m-tile), the tile kernel above.
DECODE_MAX_M = 16
KERNELS = ("decode", "tile")
_DECODE_WARPS = 8   # decode kernel: warps per thread block
_T_COLS = 64        # spmm_t: columns of dX per thread block
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    for counts in (launches, variant_launches):
        for k in counts:
            counts[k] = 0


def pick_kernel(m: int) -> str:
    """The forward kernel for M rows of X."""
    return "decode" if m <= DECODE_MAX_M else "tile"


def decode_warps(jmax: int) -> int:
    """Warps the decode kernel gives each block-row: one per resident block
    up to the gather tables' width ``jmax`` (a power of two, at most the 8
    warps of a thread block, which then takes 8 / that many block-rows)."""
    warps = 1
    while warps < min(jmax, _DECODE_WARPS):
        warps *= 2
    return warps


def spmm_t_rows(m: int, k_blocks: int, bc: int, sms: int, dy_f32: bool) -> int:
    """Rows of dX a ``spmm_t`` thread block takes (64 or 32). f32 dY: 32,
    whose three parts make a slab of 64 rows cost more than SMs left idle
    (PERF.md); bf16 dY: 64 where the thread blocks of 64 rows (one per 64
    columns of each of the ``k_blocks`` block-columns) fill the SMs, else
    32."""
    blocks = k_blocks * -(-bc // _T_COLS)
    return 64 if not dy_f32 and blocks * -(-m // 64) >= sms else 32


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("bsr_spmm")
    lib.bsr_spmm_fwd.argtypes = [_P, _I, _P, _I, _P, _P, _P, _P] + [_I] * 11 \
        + [_P]
    lib.bsr_spmm_t.argtypes = [_P, _I, _P, _I, _P, _P, _P, _P] + [_I] * 10 \
        + [_P]
    lib.bsr_spmm_t.restype = _I
    lib.bsr_spmm_palette_fwd.argtypes = (
        [_P, _I, _P, _P, _I, _P, _P, _P, _P] + [_I] * 11 + [_P])
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
        raise ValueError(f"block rows must be a power of two up to 32, got "
                         f"{w.block}")
    if w.gather_idx.shape[0] != w.block_grid[0] \
            or w.gather_t_idx.shape[0] != w.block_grid[1]:
        raise ValueError("gather table rows do not match the block grid")
    return x.contiguous()


_FP_STORE = (torch.float32, torch.bfloat16)


def _count(wrapper: str, kernel: str) -> None:
    launches[wrapper] += 1
    variant_launches[f"{wrapper}_{kernel}"] += 1


def spmm(x: torch.Tensor, w: BlockCSR) -> torch.Tensor:
    """Y (M, N) f32 = X (M, K) @ W' for W (N, K) BlockCSR (f32 or bf16
    block store)."""
    if x.device.type == "cpu":
        return ref.spmm_fwd_ref(x, w)
    return _fwd(x, w)


def spmm_palette(x: torch.Tensor, w: PaletteBCSR) -> torch.Tensor:
    """Y (M, N) f32 = X (M, K) @ dequant(W)' for W (N, K) PaletteBCSR; the
    palette lookup (and the nibble unpack at 4 bits) happens in the kernel."""
    if x.device.type == "cpu":
        return ref.spmm_palette_fwd_ref(x, w)
    return _fwd(x, w)


def _fwd(x: torch.Tensor, w, kernel=None) -> torch.Tensor:
    """The forward of ``spmm`` (BlockCSR w) or ``spmm_palette`` (PaletteBCSR
    w) for a CUDA x, on the kernel ``pick_kernel`` chooses by M, or on
    ``kernel`` ("decode" or "tile"): the GPU tests and chip_smoke.py force
    each kernel to hold both to the plain version."""
    palette = isinstance(w, PaletteBCSR)
    if palette:
        if w.bits not in (4, 8):
            raise ValueError(f"palette bits must be 4 or 8, got {w.bits}")
        x = _check(x, w, w.codes, (torch.uint8,),
                   w.block[1] // 2 if w.bits == 4 else w.block[1])
        if w.palette.shape != (1 << w.bits,) \
                or w.palette.dtype != torch.float32 \
                or w.palette.device != x.device:
            raise ValueError(f"palette must be ({1 << w.bits},) f32 on "
                             f"{x.device}")
    else:
        x = _check(x, w, w.data, _FP_STORE, w.block[1])
    m = x.shape[0]
    n_out, jmax = w.gather_idx.shape
    br, bc = w.block
    kernel = pick_kernel(m) if kernel is None else kernel
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    y = torch.empty((m, w.shape[0]), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    shape = (m, x.shape[1], w.shape[0], n_out, jmax, br, bc,
             int(kernel == "tile"), decode_warps(jmax),
             aligned16(x, x.shape[1], bc))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if palette:
            err = _lib().bsr_spmm_palette_fwd(
                x.data_ptr(), int(x.dtype == torch.bfloat16),
                w.codes.data_ptr(), w.palette.data_ptr(), w.bits,
                w.gather_idx.data_ptr(), w.gather_blk.data_ptr(),
                w.gather_nnz.data_ptr(), y.data_ptr(), *shape,
                int(w.codes.data_ptr() % 16 == 0
                    and bc * w.bits // 8 % 16 == 0), stream)
        else:
            err = _lib().bsr_spmm_fwd(
                x.data_ptr(), int(x.dtype == torch.bfloat16),
                w.data.data_ptr(), int(w.data.dtype == torch.bfloat16),
                w.gather_idx.data_ptr(), w.gather_blk.data_ptr(),
                w.gather_nnz.data_ptr(), y.data_ptr(), *shape,
                aligned16(w.data, bc), stream)
    wrapper = "spmm_palette" if palette else "spmm"
    if err:
        raise RuntimeError(f"bsr_{wrapper}_fwd launch failed: CUDA error {err}")
    _count(wrapper, kernel)
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
    rows = spmm_t_rows(m, n_cols, bc, sm_count(dy.device.index or 0),
                       dy.dtype == torch.float32)
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
            rows // 32, aligned16(dy, w.shape[0], br), aligned16(w.data, bc),
            stream)
    if err:
        raise RuntimeError(f"bsr_spmm_t launch failed: CUDA error {err}")
    launches["spmm_t"] += 1
    return dx
