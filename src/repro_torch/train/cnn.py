"""CNN training harness: the paper's experimental loop (train -> compress
-> optional retrain) on the synthetic MNIST / CIFAR stand-ins. The
counterpart of the JAX package's ``benchmarks/common.py`` (its
``data_for``, ``make_cnn_step``, ``evaluate_cnn``, ``train_cnn`` and
``spc_with_retrain``), with its data seeding: the batch of step ``s`` is
``s + seed * 100_000``, and evaluation reads the batches from 10,000 on.

A step is the forward, ``softmax_xent``, ``torch.autograd.grad``, then
``opt.update(grads, state, params, mask=mask)`` under ``torch.no_grad()``:
with ``prox_adam`` every leaf's update is one launch of
``csrc/prox_adam.cu`` on the card. The optimizer updates in place, so
``train_cnn`` trains a copy of the params it is given, and the caller's
tree stays as it was (the reference is functional). Each entry point
turns TF32 off (``models.cnn.exact_f32``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import masks as masks_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.optimizers import ProxOptimizer, get_optimizer
from repro_torch.core.tree import flatten_with_path, tree_map, unflatten_like
from repro_torch.data.synthetic import (CIFAR_LIKE, MNIST_LIKE,
                                        ImageStreamConfig, image_batch)
from repro_torch.models.cnn import CNNModel, exact_f32
from repro_torch.train.losses import accuracy, softmax_xent


def data_for(model: CNNModel, batch: int = 64,
             noise: float = 1.0) -> ImageStreamConfig:
    """noise=1.0 keeps the synthetic task non-trivial (reference accuracy
    < 1.0), so the accuracy-vs-compression frontier is informative."""
    base = MNIST_LIKE if model.input_shape[-1] == 1 else CIFAR_LIKE
    return dataclasses.replace(base, batch=batch, noise=noise)


def _param_device(params) -> torch.device:
    return flatten_with_path(params)[0][1].device


def loss_and_grads(model: CNNModel, params, batch):
    """(loss, grads tree) of ``softmax_xent`` at ``params``."""
    flat = flatten_with_path(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    with torch.enable_grad():
        loss = softmax_xent(model.apply(unflatten_like(params, leaves),
                                        batch["inputs"]), batch["labels"])
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten_like(params, list(grads))


def make_cnn_step(model: CNNModel, opt: ProxOptimizer):
    """(params, opt_state, batch, mask=None) -> (params, opt_state, loss);
    params and moments are updated in place."""
    def step(params, opt_state, batch, mask=None):
        loss, grads = loss_and_grads(model, params, batch)
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params,
                                           mask=mask)
        return params, opt_state, loss

    return step


@torch.no_grad()
def evaluate_cnn(model: CNNModel, params, data_cfg, n_batches: int = 10,
                 seed_offset: int = 10_000) -> float:
    exact_f32()
    dev = _param_device(params)
    accs = []
    for i in range(n_batches):
        b = image_batch(data_cfg, seed_offset + i, device=dev)
        accs.append(float(accuracy(model.apply(params, b["inputs"]),
                                   b["labels"])))
    return float(np.mean(accs))


def train_cnn(model: CNNModel, opt: ProxOptimizer, steps: int,
              seed: int = 0, params=None, mask=None, batch: int = 64,
              eval_every: Optional[int] = None, device=None):
    """Returns (params, history[{step, loss, acc, compression}]). Without
    ``params`` the model is initialised from ``seed`` on ``device``
    (default ``cuda``); with them, a copy of them is trained on their
    device."""
    exact_f32()
    data_cfg = data_for(model, batch)
    if params is None:
        dev = resolve_device(device)
        params = model.init(torch.Generator(dev).manual_seed(seed), dev)
    else:
        params = tree_map(lambda t: t.detach().clone(), params)
    dev = _param_device(params)
    opt_state = opt.init(params)
    step_fn = make_cnn_step(model, opt)
    history = []
    for s in range(steps):
        b = image_batch(data_cfg, s + seed * 100_000, device=dev)
        params, opt_state, loss = step_fn(params, opt_state, b, mask)
        if eval_every and (s + 1) % eval_every == 0:
            acc = evaluate_cnn(model, params, data_cfg, n_batches=5)
            comp = metrics_lib.compression_rate(params)
            history.append({"step": s + 1, "loss": float(loss),
                            "acc": acc, "compression": comp})
    return params, history


def spc_with_retrain(model: CNNModel, lam: float, steps: int,
                     retrain_steps: int, lr: float = 1e-3, seed: int = 0,
                     optimizer: str = "prox_adam", batch: int = 64,
                     device=None) -> dict:
    """The paper's pipeline on a CNN: SpC -> (mask freeze) -> debias
    retrain."""
    opt = get_optimizer(optimizer, learning_rate=lr, lam=lam)
    params, _ = train_cnn(model, opt, steps, seed=seed, batch=batch,
                          device=device)
    out = {"spc_params": params,
           "spc_compression": metrics_lib.compression_rate(params)}
    if retrain_steps:
        mask = masks_lib.zero_mask(params)
        opt_db = get_optimizer(optimizer, learning_rate=lr, lam=0.0)
        params2, _ = train_cnn(model, opt_db, retrain_steps, seed=seed,
                               params=params, mask=mask, batch=batch)
        out["retrain_params"] = params2
        out["retrain_compression"] = metrics_lib.compression_rate(params2)
    return out
