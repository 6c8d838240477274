"""What the tensor-core tile kernels need of their inputs, shared by their
wrappers: the SM count the grids are sized to, the 16-byte alignment that
cp.async staging needs, and the head dim padding of the attention tiles.
No CUDA toolkit or card is needed to import this module.
"""
from __future__ import annotations

import functools

import torch


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def aligned16(t: torch.Tensor, *dims: int) -> int:
    """1 when t starts on a 16-byte boundary and every dim (row pitch,
    column offset) is a multiple of the elements in 16 bytes: the tile
    kernels then stage its rows by 16-byte cp.async."""
    per = 16 // t.element_size()
    return int(t.data_ptr() % 16 == 0 and all(d % per == 0 for d in dims))


def tile_hd(hd: int) -> int:
    """The head dim the attention tile core runs: hd rounded up to a
    multiple of 8."""
    return -(-hd // 8) * 8


def tile_ready(t: torch.Tensor, hd: int) -> torch.Tensor:
    """t (contiguous, head dim last) as the attention tile core takes it:
    zero columns up to ``hd``, and on a 16-byte boundary (a copy where
    not). Either is a copy of the whole tensor, made on every call."""
    if t.shape[-1] != hd:
        return torch.nn.functional.pad(t, (0, hd - t.shape[-1]))
    return t.clone() if t.data_ptr() % 16 else t
