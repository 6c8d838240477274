"""Distributed-optimization extras: error-feedback gradient compression.

Port of ``repro.distributed.collectives``. int8 quantized all-reduce with
error feedback: gradients are scaled per leaf to int8 before the
data-parallel reduction and the quantization residual is carried to the
next step, so the compression error is compensated rather than
accumulated. ``all_reduce_compressed`` is the explicit reduction (the
reference's ``psum_compressed``): int8 payloads summed as int32 over a
process group, rescaled by the largest participating scale.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_map

PyTree = Any


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_grads(grads: PyTree, error: Optional[PyTree]
                      ) -> tuple[PyTree, PyTree]:
    """Error-feedback int8 compression of a gradient tree. Returns
    (decompressed grads, new error): the decompressed values are what
    enters the all-reduce; the int8 payload is what would cross the
    wire."""
    if error is None:
        error = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)
    pairs = tree_map(_ef_one, grads, error)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def _ef_one(g: torch.Tensor, e: torch.Tensor):
    target = g.float() + e
    q, s = quantize_int8(target)
    deq = dequantize_int8(q, s)
    return deq.to(g.dtype), target - deq


def all_reduce_compressed(grads: PyTree, group=None) -> PyTree:
    """Compressed sum over ``group`` divided by its size: quantize, sum
    the int8 payloads as int32, take the largest scale, rescale. Every
    rank gets the same result."""
    n = dist.get_world_size(group)

    def one(g):
        q, s = quantize_int8(g)
        acc = q.to(torch.int32)
        dist.all_reduce(acc, group=group)
        smax = s.reshape(1).clone()
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        return (acc.float() * smax[0] / n).to(g.dtype)

    return tree_map(one, grads)
