"""Proximal operators for sparse coding (paper section 2.2).

Port of ``repro.core.prox``. The l1 prox (soft thresholding) applied after
each optimizer step produces exact zeros during training; the block
group-l1 prox zeroes whole (br, bc) blocks, which is what BlockCSR stores.
Every operator is elementwise or block-local and runs on the tensor's own
device.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch

from repro_torch.core.tree import map_with_keystr

Tensor = torch.Tensor
PyTree = Any


def _as(tau, like: Tensor):
    """``tau`` in ``like``'s dtype: a host scalar stays a Python float (no
    copy to the device, no sync); a device tensor is cast."""
    if isinstance(tau, Tensor) and tau.device.type != "cpu":
        return tau.to(like.dtype)
    if like.dtype == torch.float32:
        return float(torch.as_tensor(tau, dtype=torch.float32))
    return float(torch.as_tensor(tau, dtype=like.dtype))


def soft_threshold(z: Tensor, tau) -> Tensor:
    """prox of tau*||.||_1: sgn(z) * max(|z| - tau, 0), in the min/max form
    of the paper's OpenCL kernel (Fig. 4): ``min(max(z - tau, 0), z + tau)``."""
    tau = _as(tau, z)
    return torch.minimum(torch.clamp_min(z - tau, 0), z + tau)


def prox_l1(z: Tensor, tau) -> Tensor:
    """Alias matching the paper's notation prox_{tau*||.||_1}."""
    return soft_threshold(z, tau)


def hard_threshold(z: Tensor, tau) -> Tensor:
    """Zero out |z| <= tau (the magnitude-pruning baseline's threshold)."""
    return torch.where(z.abs() > _as(tau, z), z, torch.zeros_like(z))


def prox_elastic_net(z: Tensor, tau_l1, tau_l2) -> Tensor:
    """prox of tau_l1*||.||_1 + (tau_l2/2)*||.||_2^2."""
    return soft_threshold(z, tau_l1) / (1.0 + _as(tau_l2, z))


def _block_reduce_l2(z: Tensor, block: tuple[int, int]) -> Tensor:
    """Per-block l2 norms (f32) over the last two axes, padded to block
    multiples: (..., r, c) -> (..., R, C)."""
    br, bc = block
    r, c = z.shape[-2:]
    zp = torch.nn.functional.pad(z.float(), (0, (-c) % bc, 0, (-r) % br))
    R, C = zp.shape[-2] // br, zp.shape[-1] // bc
    zb = zp.reshape(*zp.shape[:-2], R, br, C, bc)
    return torch.sqrt((zb * zb).sum(dim=(-3, -1)))


def group_l1_blocks(z: Tensor, tau, block: tuple[int, int]) -> Tensor:
    """Block soft threshold over the last two axes of ``z`` (any leading
    axes are a batch): z_g <- z_g * max(0, 1 - tau/||z_g||_2)."""
    br, bc = block
    r, c = z.shape[-2:]
    norms = _block_reduce_l2(z, block)
    tau = _as(tau, norms)
    scale = torch.clamp_min(1.0 - tau / torch.clamp_min(norms, 1e-30), 0.0)
    R, C = scale.shape[-2:]
    full = scale[..., :, None, :, None].expand(*scale.shape[:-2], R, br, C, bc)
    full = full.reshape(*scale.shape[:-2], R * br, C * bc)
    return (z.float() * full[..., :r, :c]).to(z.dtype)


def prox_group_l1_blocks(z: Tensor, tau,
                         block: tuple[int, int] = (128, 128)) -> Tensor:
    """Group-l1 over non-overlapping ``block`` tiles of a 2D weight: whole
    blocks hit exact zero. Non-2D inputs fall back to soft thresholding."""
    if z.dim() != 2:
        return soft_threshold(z, tau)
    return group_l1_blocks(z, tau, block)


def l1_penalty(w: Tensor) -> Tensor:
    return w.float().abs().sum()


def group_l1_penalty(w: Tensor, block: tuple[int, int] = (128, 128)) -> Tensor:
    if w.dim() != 2:
        return l1_penalty(w)
    return _block_reduce_l2(w, block).sum()


def get_prox(name: str, **kwargs) -> Callable[[Tensor, Any], Tensor]:
    """A prox operator by name: 'l1', 'group_l1', 'elastic_net', 'none'."""
    if name == "l1":
        return soft_threshold
    if name == "group_l1":
        return functools.partial(prox_group_l1_blocks,
                                 block=kwargs.get("block", (128, 128)))
    if name == "elastic_net":
        tau_l2 = kwargs.get("tau_l2", 0.0)
        return lambda z, tau: prox_elastic_net(z, tau, tau_l2)
    if name == "none":
        return lambda z, tau: z
    raise ValueError(f"unknown prox: {name!r}")


_NEVER_REGULARIZE = ("bias", "scale", "norm", "ln_", "_a_param", "decay",
                     "time_decay", "time_first", "pos_emb", "rglru_a")


def default_regularized_predicate(name: str, leaf) -> bool:
    """Regularize weight matrices only (the paper compresses conv and fc
    weights); biases, norm scales and vectors are left alone."""
    lname = name.lower()
    if any(k in lname for k in _NEVER_REGULARIZE):
        return False
    return leaf.dim() >= 2


def tree_prox(params: PyTree, tau, prox_fn=soft_threshold,
              predicate: Optional[Callable] = None) -> PyTree:
    """Apply ``prox_fn`` to the leaves ``predicate(keystr, leaf)`` selects
    (default: ``default_regularized_predicate``)."""
    predicate = predicate or default_regularized_predicate
    return map_with_keystr(
        lambda name, leaf: prox_fn(leaf, tau) if predicate(name, leaf)
        else leaf, params)
