"""Wrapper of the paged flash-decode kernel (``csrc/paged_attention.cu``).

``paged_flash_attention(q, k_pool, v_pool, page_table, positions, *,
window, kv_splits)`` is the engine's attention on the 'cuda' backend (port
of ``repro.kernels.paged_attention.ops.paged_flash_attention``): it groups
q per kv head as f32 ``(B, KV, C, g, hd)``, runs the kernel, which walks
each slot's running keys through its page table in kv tiles (tensor cores,
``csrc/attn_tile.cuh``) and emits per-split unnormalized partials
``(acc, m, l)``, and then the exact cross-split softmax combine
(``ref.combine_splits``; identity at one split). The gathered
``(B, P*page_size, ...)`` context is never formed.

For tensors on the CPU it runs the plain version of the kernel
(``ref.paged_flash_fwd_ref``) and the same combine; for CUDA tensors it
launches the hand-written kernel or raises. There is no fallback between
the two. ``launches`` counts kernel launches.

The kernel stages 16-byte chunks; the wrapper takes what the reference
takes all the same: a head dim that is not a multiple of 8 runs with q and
the pools padded by zero columns (the tiles' own zero-fill), and q or a
pool that starts off a 16-byte boundary is copied to an aligned tensor.
Either is a copy of the whole K and V pools on every call: in the engine,
of each layer's KV cache on every tick, which doubles the pools' memory
while it lives. No config of either package has such a head dim, and the
engine's pools start aligned; one that did would pad the pools' rows
once, where the engine allocates them (ROADMAP).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, _counts
from repro_torch.kernels._tiles import tile_hd, tile_ready
from repro_torch.kernels.paged_attention import ref
from repro_torch.obs.profile import kernel_call

launches = {"paged_flash_fwd": 0}
_P, _I = ctypes.c_void_p, ctypes.c_int
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_SMEM = 232448                  # bytes of shared memory a block can use


def reset_launches() -> None:
    _counts.reset(launches)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    # q, k_pool, v_pool, pool_dtype, table, positions, acc, m, l,
    # b, kv, c, g, hd, ps, n_logical, n_splits, window, scale, stream
    lib.paged_flash_fwd.argtypes = ([_P] * 3 + [_I] + [_P] * 5 + [_I] * 9
                                    + [ctypes.c_float, _P])
    lib.paged_flash_fwd.restype = _I
    lib.paged_flash_fwd_smem_bytes.argtypes = [_I, _I]
    lib.paged_flash_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check(q, k_pool, v_pool, page_table, positions) -> None:
    """Validate what the kernel takes."""
    b, kv, c, g, hd = q.shape
    ps = k_pool.shape[1]
    if q.dtype != torch.float32:
        raise TypeError(f"q must be f32, got {q.dtype}")
    if k_pool.dtype not in _POOL_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pools must share one of {list(_POOL_DTYPES)}, got "
                        f"{k_pool.dtype} and {v_pool.dtype}")
    if k_pool.shape != v_pool.shape or tuple(k_pool.shape[2:]) != (kv, hd):
        raise ValueError(f"pools {tuple(k_pool.shape)} / {tuple(v_pool.shape)} "
                         f"do not match q grouped as {tuple(q.shape)}")
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("page_table and positions must be int32")
    if page_table.shape[0] != b or tuple(positions.shape) != (b, c):
        raise ValueError(f"page_table {tuple(page_table.shape)} / positions "
                         f"{tuple(positions.shape)} do not match q")
    for t in (q, k_pool, v_pool, page_table, positions):
        if t.device != q.device:
            raise ValueError(f"a tensor lies on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if hd > 256:
        raise ValueError(f"head_dim {hd} exceeds the kernel's 256")
    if _lib().paged_flash_fwd_smem_bytes(ps, tile_hd(hd)) > _MAX_SMEM:
        raise ValueError(f"head_dim {hd} exceeds the kernel's shared memory")
    if b * kv > 65535:
        raise ValueError(f"grid ({b} slots x {kv} kv heads) exceeds 65535")


def paged_flash_fwd(q, k_pool, v_pool, page_table, positions, *,
                    window: Optional[int] = None, kv_splits: int = 1):
    """The kernel: per-split partials ``(acc, m, l)`` of
    ``ref.paged_flash_fwd_ref`` for q grouped as (B, KV, C, g, hd) f32.
    The tick start is ``positions[:, 0]``."""
    b, kv, c, g, hd = q.shape
    n_logical = page_table.shape[1]
    ref.pages_per_split(n_logical, kv_splits)            # validates splits
    if q.device.type == "cpu":
        return ref.paged_flash_fwd_ref(q, k_pool, v_pool, page_table,
                                       positions, positions[:, 0],
                                       window=window, kv_splits=kv_splits)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_fwd takes CUDA or CPU tensors, got "
                         f"{q.device}")
    _check(q, k_pool, v_pool, page_table, positions)
    hd_t = tile_hd(hd)
    q, k_pool, v_pool = (tile_ready(t, hd_t) for t in (q, k_pool, v_pool))
    acc = torch.empty((b, kv, kv_splits, c, g, hd_t), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((b, kv, kv_splits, c, g), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    if b == 0 or c == 0:
        return acc[..., :hd], m, l
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().paged_flash_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            _POOL_DTYPES[k_pool.dtype], page_table.data_ptr(),
            positions.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            b, kv, c, g, hd_t, k_pool.shape[1], n_logical, kv_splits,
            0 if window is None else int(window), hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"paged_flash_fwd launch failed: CUDA error {err}")
    _counts.bump(launches, "paged_flash_fwd")
    return (acc if hd_t == hd else acc[..., :hd].contiguous()), m, l


def paged_flash_attention(q, k_pool, v_pool, page_table, positions, *,
                          window: Optional[int] = None,
                          kv_splits: int = 1) -> torch.Tensor:
    """q: (B, C, H, hd); k/v_pool: (n_pages, ps, KV, hd); page_table:
    (B, P) int32; positions: (B, C) int32 ABSOLUTE positions, the engine
    contract ``positions = start_pos[:, None] + arange(C)`` (the page-skip
    predicate takes row 0 as the tick start).

    Returns (B, C, H, hd) f32; invalid query rows carry finite garbage,
    as on the ref path."""
    return kernel_call("paged_attention/paged_flash_attention",
                       _paged_flash_attention, q, k_pool, v_pool, page_table,
                       positions, window=window, kv_splits=kv_splits)


def _paged_flash_attention(q, k_pool, v_pool, page_table, positions, *,
                           window, kv_splits) -> torch.Tensor:
    b, c, h, hd = q.shape
    kv = k_pool.shape[2]
    g = h // kv
    qg = q.reshape(b, c, kv, g, hd).permute(0, 2, 1, 3, 4).float().contiguous()
    acc, m, l = paged_flash_fwd(qg, k_pool, v_pool, page_table, positions,
                                window=window, kv_splits=kv_splits)
    out = ref.combine_splits(acc, m, l)                  # (B, KV, C, g, hd)
    return out.permute(0, 2, 1, 3, 4).reshape(b, c, h, hd)
