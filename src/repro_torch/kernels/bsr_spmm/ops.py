"""Wrappers of the BCSR / PaletteBCSR spmm kernels (``csrc/bsr_spmm.cu``).

``spmm(x, w)`` and ``spmm_palette(x, w)`` compute ``Y (M, N) f32 = X (M, K)
@ W'`` for a compressed W (N, K); ``spmm_t(dy, w)`` computes the backward
``dX (M, K) f32 = dY (M, N) @ W`` over the transposed tables.
``spmm_experts(x, w, rows)`` and ``spmm_palette_experts(x, w, rows)`` take
E problems at once, X (E, M, K) against an E-stacked W (one slice per
expert, the MoE FFN's (E, out, in) weights): ``Y (E, M, N) f32`` in one
launch of the expert forward (``csrc/bsr_spmm_experts.cu``, the expert on
the grid's z axis; the reference maps one ``sparse_matmul`` per expert).
``rows``, an optional (E,) int32 tensor on x's device, is the count of
occupied rows of each expert's buffer (the tokens the MoE dispatch gave
it): the kernel reads it on the device, computes rows ``[0, rows[e])`` and
writes exact zeros below, and an expert with none reads none of its
blocks; ``None`` computes every row. ``spmm_t_experts(dy, w)`` is the
backward's: ``dX (E, M, K) f32`` in one launch of the ``spmm_t`` kernel.
A BlockCSR block store may be f32 or bf16 (training casts it to the
compute dtype); the kernels upcast it as they read. For a tensor on the
CPU they run the plain PyTorch version (``ref.py``); for a CUDA tensor
they launch the hand-written Hopper kernel or raise. There is no fallback
between the two.

The single-matrix forward has two kernels, dispatched by M: the
tensor-core tile kernel for M > ``DECODE_MAX_M`` (prefill, training) and
the decode kernel, an f32 FMA kernel with a warp per resident block, for M
<= ``DECODE_MAX_M``, where a 16-row mma tile would be mostly padding. The
expert forward has two forms of one kernel, dispatched by M alike: a warp
takes one block-row of one expert and every occupied row of its m-chunk,
16 rows in the decode form and 32 in the tile form, loads its part of each
resident block and of X straight into registers and runs the products on
the tensor cores. ``spmm_t`` runs on the tensor-core tile core too (see
``csrc/bsr_spmm.cu``). A failure of any raises. Each kernel's shape of
grid is chosen here from shapes alone (``decode_warps``, ``spmm_t_rows``;
the expert forward's by its kernel), with no wait for the device.

``launches`` counts kernel launches per wrapper, so a run can show that
its path went through the kernels; ``variant_launches`` splits the
forward's counts by kernel (``spmm`` = ``spmm_decode`` + ``spmm_tile``,
``spmm_experts`` = ``spmm_experts_decode`` + ``spmm_experts_tile``). Every
public entry routes through ``obs.profile.kernel_call`` (``bsr_spmm/...``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _counts
from repro_torch.kernels._tiles import aligned16, sm_count
from repro_torch.kernels.bsr_spmm import ref
from repro_torch.obs.profile import kernel_call
from repro_torch.sparse.formats import BlockCSR, PaletteBCSR

FORWARD = ("spmm", "spmm_palette", "spmm_experts", "spmm_palette_experts")
launches = {"spmm": 0, "spmm_t": 0, "spmm_palette": 0, "spmm_experts": 0,
            "spmm_palette_experts": 0, "spmm_t_experts": 0}
# The forward runs the decode kernel up to this many rows of X (one mma
# m-tile), the tile kernel above.
DECODE_MAX_M = 16
KERNELS = ("decode", "tile")
variant_launches = {f"{w}_{k}": 0 for w in FORWARD for k in KERNELS}
_DECODE_WARPS = 8   # decode kernel: warps per thread block
_T_COLS = 64        # spmm_t: columns of dX per thread block
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    _counts.reset(launches, variant_launches)


def pick_kernel(m: int) -> str:
    """The forward kernel for M rows of X."""
    return "decode" if m <= DECODE_MAX_M else "tile"


def decode_warps(jmax: int) -> int:
    """Warps the single-matrix decode kernel gives each block-row: one per
    resident block up to the gather tables' width ``jmax`` (a power of
    two, at most the 8 warps of a thread block, which then takes 8 / that
    many block-rows). The expert forward gives each block-row one warp,
    whatever its width, so it has no such choice."""
    warps = 1
    while warps < min(jmax, _DECODE_WARPS):
        warps *= 2
    return warps


def spmm_t_rows(m: int, k_blocks: int, bc: int, sms: int, dy_f32: bool,
                experts: int = 1) -> int:
    """Rows of dX a ``spmm_t`` thread block takes (64 or 32). f32 dY: 32,
    whose three parts make a slab of 64 rows cost more than SMs left idle
    (PERF.md); bf16 dY: 64 where the thread blocks of 64 rows (one per 64
    columns of each of the ``k_blocks`` block-columns of each of the
    ``experts`` problems) fill the SMs, else 32."""
    blocks = experts * k_blocks * -(-bc // _T_COLS)
    return 64 if not dy_f32 and blocks * -(-m // 64) >= sms else 32


@functools.cache
def _lib(experts: bool = False) -> ctypes.CDLL:
    """``csrc/bsr_spmm.cu``'s library, or with ``experts`` its expert
    instantiations (``csrc/bsr_spmm_experts.cu``)."""
    lib = _build.load("bsr_spmm_experts" if experts else "bsr_spmm")
    tag = "_experts" if experts else ""
    # the expert entries take the rows pointer before y, no decode warps,
    # and E and n_slots after the single-matrix shape arguments
    rows, ints = ([_P], 12) if experts else ([], 11)
    fwd = getattr(lib, f"bsr_spmm{tag}_fwd")
    fwd.argtypes = [_P, _I, _P, _I, _P, _P, _P] + rows + [_P] + [_I] * ints + [_P]
    pal = getattr(lib, f"bsr_spmm_palette{tag}_fwd")
    pal.argtypes = [_P, _I, _P, _P, _I, _P, _P, _P] + rows + [_P] + [_I] * ints + [_P]
    bwd = getattr(lib, f"bsr_spmm_t{tag}")
    bwd.argtypes = [_P, _I, _P, _I, _P, _P, _P, _P] + [_I] * 12 + [_P]
    fwd.restype = pal.restype = bwd.restype = _I
    return lib


def _check(x: torch.Tensor, w, store: torch.Tensor, store_dtypes,
           store_cols: int, tables=None, in_dim: int = 1,
           experts: int = 0) -> torch.Tensor:
    """Validate what the kernel takes; returns x made contiguous. ``in_dim``
    is the axis of W that x's columns run along (1 forward, 0 backward);
    ``experts``: x is (E, M, K) and W an E-stacked store of as many slices
    (0: one matrix)."""
    lead = 1 if experts else 0
    if x.device.type != "cuda":
        raise ValueError(f"spmm kernels take CUDA or CPU tensors, got {x.device}")
    if x.dim() != 2 + lead or x.shape[-1] != w.shape[in_dim]:
        raise ValueError(f"x {tuple(x.shape)} does not match W {w.shape}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"spmm kernels take f32 or bf16 x, got {x.dtype}")
    if store.dtype not in store_dtypes:
        raise TypeError(f"block store must be one of {store_dtypes}, got "
                        f"{store.dtype}")
    if store.dim() != 3 + lead \
            or tuple(store.shape[lead + 1:]) != (w.block[0], store_cols):
        raise ValueError(f"block store {tuple(store.shape)} does not match "
                         f"block {w.block}" + (f" and {experts} experts"
                                               if experts else ""))
    tables = tables or (w.gather_idx, w.gather_blk, w.gather_nnz)
    if w.gather_nnz.dim() != 1 + lead or \
            any(t.shape[:lead] != store.shape[:lead] for t in tables) or \
            (experts and store.shape[0] != experts):
        raise ValueError(
            f"W's stack {tuple(store.shape[:-3])} does not match x "
            f"{tuple(x.shape)}: spmm / spmm_palette take one matrix, "
            "spmm_experts / spmm_palette_experts one slice per expert")
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
    if w.gather_idx.shape[lead] != w.block_grid[0] \
            or w.gather_t_idx.shape[lead] != w.block_grid[1]:
        raise ValueError("gather table rows do not match the block grid")
    return x.contiguous()


_FP_STORE = (torch.float32, torch.bfloat16)


def _count(wrapper: str, kernel: str) -> None:
    _counts.bump(launches, wrapper)
    _counts.bump(variant_launches, f"{wrapper}_{kernel}")


def spmm(x: torch.Tensor, w: BlockCSR) -> torch.Tensor:
    """Y (M, N) f32 = X (M, K) @ W' for W (N, K) BlockCSR (f32 or bf16
    block store)."""
    return kernel_call("bsr_spmm/spmm", _spmm, x, w, False)


def spmm_palette(x: torch.Tensor, w: PaletteBCSR) -> torch.Tensor:
    """Y (M, N) f32 = X (M, K) @ dequant(W)' for W (N, K) PaletteBCSR; the
    palette lookup (and the nibble unpack at 4 bits) happens in the kernel."""
    return kernel_call("bsr_spmm/spmm_palette", _spmm, x, w, False)


def spmm_experts(x: torch.Tensor, w: BlockCSR,
                 rows: torch.Tensor | None = None) -> torch.Tensor:
    """Y (E, M, N) f32, Y[e] = X[e] @ W[e]' for X (E, M, K) and an E-stacked
    BlockCSR W (every array field with a leading expert axis; ``w[e]`` is
    expert e's (N, K) matrix): one launch for all E. With ``rows`` ((E,)
    int32 on x's device), only rows ``[0, rows[e])`` of Y[e] are computed
    and the rest are zero; the kernel reads the counts on the device."""
    return kernel_call("bsr_spmm/spmm_experts", _spmm, x, w, True, rows)


def spmm_palette_experts(x: torch.Tensor, w: PaletteBCSR,
                         rows: torch.Tensor | None = None) -> torch.Tensor:
    """``spmm_experts`` for an E-stacked PaletteBCSR (one palette per
    expert, (E, 2**bits))."""
    return kernel_call("bsr_spmm/spmm_palette_experts", _spmm, x, w, True,
                       rows)


def _spmm(x: torch.Tensor, w, experts: bool, rows=None) -> torch.Tensor:
    if x.dim() != (3 if experts else 2):
        raise ValueError(f"x {tuple(x.shape)}: spmm / spmm_palette take a 2-D "
                         "x, spmm_experts / spmm_palette_experts a 3-D one")
    if x.device.type == "cpu":
        palette = isinstance(w, PaletteBCSR)
        if x.dim() == 3:
            return (ref.spmm_palette_experts_fwd_ref(x, w, rows) if palette
                    else ref.spmm_experts_fwd_ref(x, w, rows))
        return (ref.spmm_palette_fwd_ref(x, w) if palette
                else ref.spmm_fwd_ref(x, w))
    return _fwd(x, w, rows=rows)


def _check_rows(rows: torch.Tensor, x: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError("rows counts an expert stack's rows: spmm_experts "
                         "and spmm_palette_experts take it")
    if tuple(rows.shape) != (x.shape[0],) or rows.dtype != torch.int32 \
            or rows.device != x.device or not rows.is_contiguous():
        raise ValueError(f"rows must be ({x.shape[0]},) int32 on {x.device}, "
                         f"got {tuple(rows.shape)} {rows.dtype} on "
                         f"{rows.device}")


def _fwd(x: torch.Tensor, w, kernel=None, rows=None) -> torch.Tensor:
    """The forward of ``spmm`` (BlockCSR w) or ``spmm_palette`` (PaletteBCSR
    w), or of their expert forms for a 3-D x (``rows``: the occupied rows
    of each expert, or None), for a CUDA x, on the kernel ``pick_kernel``
    chooses by M, or on ``kernel`` ("decode" or "tile"): the GPU tests and
    chip_smoke.py force each kernel to hold both to the plain version."""
    palette = isinstance(w, PaletteBCSR)
    experts = x.shape[0] if x.dim() == 3 else 0
    if rows is not None:
        _check_rows(rows, x)
    if palette:
        if w.bits not in (4, 8):
            raise ValueError(f"palette bits must be 4 or 8, got {w.bits}")
        x = _check(x, w, w.codes, (torch.uint8,),
                   w.block[1] // 2 if w.bits == 4 else w.block[1],
                   experts=experts)
        want = (experts, 1 << w.bits) if experts else (1 << w.bits,)
        if tuple(w.palette.shape) != want \
                or w.palette.dtype != torch.float32 \
                or w.palette.device != x.device \
                or not w.palette.is_contiguous():
            raise ValueError(f"palette must be {want} f32 on {x.device}")
    else:
        x = _check(x, w, w.data, _FP_STORE, w.block[1], experts=experts)
    m = x.shape[-2]
    n_out, jmax = w.gather_idx.shape[-2:]
    br, bc = w.block
    kernel = pick_kernel(m) if kernel is None else kernel
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    y = torch.empty(x.shape[:-1] + (w.shape[0],), dtype=torch.float32,
                    device=x.device)
    if y.numel() == 0:
        return y
    store = w.codes if palette else w.data
    if experts:
        # the rows pointer (or null), and E and the slots of a slice after
        # the alignment flags
        ptrs = (rows.data_ptr() if rows is not None else None, y.data_ptr())
        grid, stack = (), (experts, store.shape[-3])
    else:
        ptrs, grid, stack = (y.data_ptr(),), (decode_warps(jmax),), ()
    shape = (m, x.shape[-1], w.shape[0], n_out, jmax, br, bc,
             int(kernel == "tile"), *grid, aligned16(x, x.shape[-1], bc))
    lib, tag = _lib(bool(experts)), "_experts" if experts else ""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if palette:
            err = getattr(lib, f"bsr_spmm_palette{tag}_fwd")(
                x.data_ptr(), int(x.dtype == torch.bfloat16),
                w.codes.data_ptr(), w.palette.data_ptr(), w.bits,
                w.gather_idx.data_ptr(), w.gather_blk.data_ptr(),
                w.gather_nnz.data_ptr(), *ptrs, *shape,
                int(w.codes.data_ptr() % 16 == 0
                    and bc * w.bits // 8 % 16 == 0), *stack, stream)
        else:
            err = getattr(lib, f"bsr_spmm{tag}_fwd")(
                x.data_ptr(), int(x.dtype == torch.bfloat16),
                w.data.data_ptr(), int(w.data.dtype == torch.bfloat16),
                w.gather_idx.data_ptr(), w.gather_blk.data_ptr(),
                w.gather_nnz.data_ptr(), *ptrs, *shape,
                aligned16(w.data, bc), *stack, stream)
    wrapper = ("spmm_palette" if palette else "spmm") + (
        "_experts" if experts else "")
    if err:
        raise RuntimeError(f"bsr_{wrapper}_fwd launch failed: CUDA error {err}")
    _count(wrapper, kernel)
    return y


def spmm_t(dy: torch.Tensor, w: BlockCSR) -> torch.Tensor:
    """dX (M, K) f32 = dY (M, N) @ W for W (N, K) BlockCSR, over the
    block-CSC tables ``gather_t_*`` (the backward of ``spmm`` in x)."""
    return kernel_call("bsr_spmm/spmm_t", _spmm_t, dy, w, False)


def spmm_t_experts(dy: torch.Tensor, w: BlockCSR) -> torch.Tensor:
    """dX (E, M, K) f32, dX[e] = dY[e] @ W[e] for dY (E, M, N) and an
    E-stacked BlockCSR W (the backward of ``spmm_experts`` in x): one
    launch for all E."""
    return kernel_call("bsr_spmm/spmm_t_experts", _spmm_t, dy, w, True)


def _spmm_t(dy: torch.Tensor, w: BlockCSR, experts: bool) -> torch.Tensor:
    if dy.dim() != (3 if experts else 2):
        raise ValueError(f"dy {tuple(dy.shape)}: spmm_t takes a 2-D dy, "
                         "spmm_t_experts a 3-D one")
    if dy.device.type == "cpu":
        return (ref.spmm_experts_bwd_ref(dy, w) if experts
                else ref.spmm_bwd_ref(dy, w))
    n_exp = dy.shape[0] if experts else 0
    tables = (w.gather_t_idx, w.gather_t_blk, w.gather_t_nnz)
    dy = _check(dy, w, w.data, _FP_STORE, w.block[1], tables, in_dim=0,
                experts=n_exp)
    m = dy.shape[-2]
    n_cols, jmax_t = w.gather_t_idx.shape[-2:]
    br, bc = w.block
    rows = spmm_t_rows(m, n_cols, bc, sm_count(dy.device.index or 0),
                       dy.dtype == torch.float32, max(n_exp, 1))
    dx = torch.empty(dy.shape[:-1] + (w.shape[1],), dtype=torch.float32,
                     device=dy.device)
    if dx.numel() == 0:
        return dx
    lib, tag = _lib(n_exp > 1), "_experts" if n_exp > 1 else ""
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"bsr_spmm_t{tag}")(
            dy.data_ptr(), int(dy.dtype == torch.bfloat16), w.data.data_ptr(),
            int(w.data.dtype == torch.bfloat16), w.gather_t_idx.data_ptr(),
            w.gather_t_blk.data_ptr(), w.gather_t_nnz.data_ptr(),
            dx.data_ptr(), m, w.shape[0], w.shape[1], n_cols, jmax_t, br, bc,
            rows // 32, aligned16(dy, w.shape[0], br), aligned16(w.data, bc),
            max(n_exp, 1), w.data.shape[-3], stream)
    wrapper = "spmm_t_experts" if experts else "spmm_t"
    if err:
        raise RuntimeError(f"bsr_{wrapper} launch failed: CUDA error {err}")
    _counts.bump(launches, wrapper)
    return dx
