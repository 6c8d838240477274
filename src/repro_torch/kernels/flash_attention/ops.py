"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Port of ``repro.kernels.flash_attention.ops.flash_attention`` and of the
kernel entry ``flash_attention.flash_attention_fwd``: forward only, as in
the reference (its docstring promises a custom VJP that the code does not
define). No model code of either package calls it; it is its own public
entry point.

For tensors on the CPU ``flash_attention_fwd`` runs the plain version
(``ref.flash_attention_ref``); for CUDA tensors it launches the
hand-written kernel or raises. There is no fallback between the two.
``launches`` counts kernel launches. As the paged wrapper, it takes a head
dim that is not a multiple of 8 (zero columns) and tensors off a 16-byte
boundary (an aligned copy); either copies q, k and v whole on every call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import tile_hd, tile_ready
from repro_torch.kernels.flash_attention import ref

launches = {"flash_attention_fwd": 0}
_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_SMEM = 232448                  # bytes of shared memory a block can use


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    # q, k, v, o, dtype, bh, s, hd, group, causal, window, scale, stream
    lib.flash_attention_fwd.argtypes = ([_P] * 4 + [_I] * 7
                                        + [ctypes.c_float, _P])
    lib.flash_attention_fwd.restype = _I
    lib.flash_attention_fwd_smem_bytes.argtypes = [_I]
    lib.flash_attention_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check(q, k, v) -> None:
    """Validate what the kernel takes."""
    bh, s, hd = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of {list(_DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.shape[1:] != (s, hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if bh % k.shape[0]:
        raise ValueError(f"{bh} q heads are not a multiple of {k.shape[0]} "
                         "kv heads")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"a tensor lies on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if hd > 256:
        raise ValueError(f"head_dim {hd} exceeds the kernel's 256")
    if _lib().flash_attention_fwd_smem_bytes(tile_hd(hd)) > _MAX_SMEM:
        raise ValueError(f"head_dim {hd} exceeds the kernel's shared memory")
    if bh > 65535:
        raise ValueError(f"grid of {bh} q heads exceeds 65535")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, bq: int = 128,
                        bk: int = 128) -> torch.Tensor:
    """q: (BH, S, hd); k, v: (BKV, S, hd) with BH = BKV * group.

    Returns o: (BH, S, hd) in q's dtype. ``bq`` / ``bk`` are the
    reference's tile sizes: S must be a multiple of both, as there; the
    kernel's own tiles do not change the result (see the source)."""
    bh, s, hd = q.shape
    if s % bq or s % bk:
        raise ValueError(f"sequence length {s} must be a multiple of bq={bq} "
                         f"and bk={bk}")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd takes CUDA or CPU tensors, "
                         f"got {q.device}")
    _check(q, k, v)
    hd_t = tile_hd(hd)
    q, k, v = (tile_ready(t, hd_t) for t in (q, k, v))
    o = torch.empty_like(q)
    if bh == 0 or s == 0:
        return o[..., :hd]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], bh, s, hd_t, bh // k.shape[0], int(causal),
            0 if window is None else int(window), hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    launches["flash_attention_fwd"] += 1
    return o if hd_t == hd else o[..., :hd].contiguous()


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    bq, bk = min(bq, s), min(bk, s)
    qf = q.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * kv, s, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * kv, s, hd).contiguous()
    of = flash_attention_fwd(qf, kf, vf, causal=causal, window=window,
                             bq=bq, bk=bk)
    return of.reshape(b, h, s, hd).transpose(1, 2)

