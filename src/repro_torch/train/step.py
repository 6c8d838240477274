"""train_step / grad-accumulated train_step factories (port of
``repro.train.step``).

The step runs eagerly: (state, batch) -> (state, metrics). The optimizer is
a prox optimizer, so every step ends with the paper's thresholding (or
runs debiased with a frozen mask). It updates the params and moments in
place under ``torch.no_grad()``, where the reference donates them to a
jitted step. Metrics are 0-d device tensors; the loop reads them on its
log steps only, so a step does not wait for the device.

Mixed precision as in the reference: the f32 master leaves of rank >= 2
are cast once per step to the config's compute dtype, and the gradients
w.r.t. the cast copies reach the f32 masters unchanged.

Under a rank mesh (``distributed.sharding.use_mesh``) the params are this
rank's part and the batch this data coordinate's rows. The loss is the
mean over the whole batch: each rank differentiates its share (its rows'
mean over the data-parallel degree), the leaves split over the batch axes
have their gradients summed by the backward of their gather, and every
other leaf's gradient is summed over the batch axes here. The gradient
norm counts each replicated leaf once.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.utils.checkpoint

from repro_torch.core.optimizers import ProxOptimizer
from repro_torch.core.tree import flatten_with_path, tree_map, unflatten_like
from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import current_mesh, leaf_spec
from repro_torch.train.losses import next_token_loss
from repro_torch.train.state import TrainState

PyTree = Any
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def make_loss_fn(model, aux_weight: float = 1e-2, loss_seq_chunk: int = 0,
                 param_transform: Optional[Callable] = None) -> Callable:
    """``loss_seq_chunk > 0``: the head and the loss run per sequence chunk
    under ``torch.utils.checkpoint``, so the (B, S, vocab) logits are never
    held for the backward: each chunk's logits are recomputed there.

    ``param_transform`` maps the trainable tree to what the model consumes
    (SpC-Retrain's debias phase rebuilds the ``CompressedParams`` from
    ``split_trainable``'s {dense residue, block stores} tree)."""

    def loss_fn(params, batch):
        if param_transform is not None:
            params = param_transform(params)
        labels = batch["labels"]
        if not loss_seq_chunk or labels.shape[1] <= loss_seq_chunk:
            logits, aux = model.apply_train(params, batch)
            loss = next_token_loss(logits, labels)
        else:
            hidden, aux = model.apply_hidden(params, batch)
            s = labels.shape[1]
            if s % loss_seq_chunk:
                raise ValueError(f"seq {s} is not a multiple of "
                                 f"loss_seq_chunk {loss_seq_chunk}")
            n = s // loss_seq_chunk

            def chunk_loss(h, lab):
                return next_token_loss(model.head(params, h), lab)

            loss = 0.0
            for i in range(n):
                sl = slice(i * loss_seq_chunk, (i + 1) * loss_seq_chunk)
                loss = loss + torch.utils.checkpoint.checkpoint(
                    chunk_loss, hidden[:, sl], labels[:, sl],
                    use_reentrant=False)
            loss = loss / n
        loss = loss + aux_weight * aux["load_balance"] + aux["z_loss"]
        return loss, {"loss": loss.detach(),
                      "load_balance": aux["load_balance"].detach()}

    return loss_fn


def _compute_dtype(model):
    cfg = getattr(model, "cfg", None)
    return _DTYPES[cfg.compute_dtype] if cfg is not None else torch.float32


def make_train_step(model, opt: ProxOptimizer, microbatches: int = 1,
                    aux_weight: float = 1e-2, loss_seq_chunk: int = 0,
                    param_transform: Optional[Callable] = None) -> Callable:
    loss_fn = make_loss_fn(model, aux_weight, loss_seq_chunk=loss_seq_chunk,
                           param_transform=param_transform)
    cdt = _compute_dtype(model)

    def cast_compute(params):
        """One cast of the f32 masters of rank >= 2 to the compute dtype."""
        return tree_map(lambda p: p.to(cdt)
                        if (p.dtype == torch.float32 and p.dim() >= 2)
                        else p, params)

    def grads_of(params, batch):
        """(grads tree, metrics) of one (micro)batch; a leaf the loss does
        not reach gets zeros, as ``jax.grad`` gives."""
        flat = flatten_with_path(params)
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        work = unflatten_like(params, leaves)
        mesh = current_mesh()
        dp = mesh.axis_size(mesh.batch_axes) if mesh is not None else 1
        with torch.enable_grad(), parallel.data_parallel():
            loss, metrics = loss_fn(cast_compute(work), batch)
            gs = torch.autograd.grad(loss / dp if dp > 1 else loss, leaves,
                                     allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, gs)]
        if dp > 1:
            metrics = {k: _batch_mean(v, mesh) for k, v in metrics.items()}
        return unflatten_like(params, gs), metrics

    def compute_grads(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        split = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                              + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        acc = None
        for i in range(microbatches):
            g, metrics = grads_of(params, {k: v[i] for k, v in split.items()})
            g = tree_map(lambda t: t.float(), g)
            acc = g if acc is None else tree_map(torch.add, acc, g)
        return tree_map(lambda t: t / microbatches, acc), metrics

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        grads, metrics = compute_grads(state.params, batch)
        with torch.no_grad():
            mesh = current_mesh()
            if mesh is None:
                gl = [g for _, g in flatten_with_path(grads)]
                grad_norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                           for g in gl))
            else:
                grad_norm = _reduce_grads(grads, mesh)
            params, opt_state = opt.update(grads, state.opt_state,
                                           state.params, mask=state.mask)
        metrics = dict(metrics, grad_norm=grad_norm)
        return TrainState(params=params, opt_state=opt_state,
                          mask=state.mask, step=state.step + 1), metrics

    return train_step


def _batch_mean(v: torch.Tensor, mesh) -> torch.Tensor:
    v = v.detach().clone()
    torch.distributed.all_reduce(v, group=mesh.groups["batch"])
    return v / mesh.axis_size(mesh.batch_axes)


def _split_size(spec, mesh) -> int:
    n = 1
    for axes in spec:
        if axes is not None:
            n *= mesh.axis_size(axes)
    return n


def _reduce_grads(grads, mesh) -> torch.Tensor:
    """Sum over the batch axes the gradient of every leaf that is not
    split over them (in place), and return the global gradient norm: each
    rank's share of a leaf's squared norm over the number of ranks that
    hold the same part."""
    batch = set(mesh.batch_axes)
    world = mesh.size
    total = None
    for keys, g in flatten_with_path(grads):
        spec = leaf_spec(mesh, "/".join(keys), g)
        split = {a for axes in spec if axes is not None
                 for a in ((axes,) if isinstance(axes, str) else axes)}
        if mesh.axis_size(mesh.batch_axes) > 1 and not split & batch:
            torch.distributed.all_reduce(g, group=mesh.groups["batch"])
        sq = torch.sum(torch.square(g.float())) * (
            _split_size(spec, mesh) / world)
        total = sq if total is None else total + sq
    torch.distributed.all_reduce(total)
    return torch.sqrt(total)


def make_eval_step(model) -> Callable:
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step

