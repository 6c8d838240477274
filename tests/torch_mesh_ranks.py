"""The rank side of ``test_torch_mesh.py``: what each of 4 gloo ranks on
the CPU runs, spawned once for the whole file. It imports only torch and
the port (the spawned processes import this module, not the test file);
its inputs come from files the test wrote, and rank 0 writes what the
ranks computed for the test to hold against one process and the JAX
package."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.optimizers import prox_adam
from repro_torch.data.pipeline import ShardedBatcher
from repro_torch.data.synthetic import TokenStreamConfig, token_batch
from repro_torch.distributed import collectives, elastic, parallel, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve, train
from repro_torch.models import moe as moe_lib
from repro_torch.models.model_zoo import build
from repro_torch.serve.api import Request
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.step import generate, prefill_logits
from repro_torch.sparse.compress import iter_bcsr
from repro_torch.train.state import TrainState
from repro_torch.train.step import _reduce_grads, make_train_step

SERVE_ARCH, TRAIN_ARCH, MOE_ARCH = "smollm-360m", "qwen3-0.6b", "olmoe-1b-7b"
GEN = 6
ENGINE_PROMPTS = (5, 9, 3)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 32
TRAIN_LR, TRAIN_LAM = 1e-3, 0.5


def engine_requests(vocab: int) -> list:
    rng = np.random.default_rng(3)
    return [Request(prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=GEN) for n in ENGINE_PROMPTS]


def engine_tokens(model, params) -> list:
    reqs = engine_requests(model.cfg.vocab)
    config = EngineConfig(max_batch=4, prefill_chunk=4, page_size=4,
                          max_seq_len=max(len(r.prompt) for r in reqs) + GEN)
    res = ServeEngine(model, params, config).run(reqs)["results"]
    return [[int(t) for t in res[i]] for i in range(len(reqs))]


def serve_outputs(model, params, prompt) -> dict:
    """Prefill logits, greedy tokens and engine tokens of one model."""
    return {"logits": prefill_logits(model, params, prompt,
                                     prompt.shape[1] + GEN),
            "tokens": generate(model, params, prompt, GEN),
            "engine": engine_tokens(model, params)}


def train_run(model, params, steps: int = TRAIN_STEPS, mesh=None) -> tuple:
    """Losses, grad norms and the final params of prox-Adam steps on the
    synthetic stream (this data coordinate's rows under a mesh)."""
    opt = prox_adam(TRAIN_LR, lam=TRAIN_LAM)
    data = TokenStreamConfig(vocab=model.cfg.vocab, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH)
    state = TrainState.create(params, opt)
    step = make_train_step(model, opt)
    losses, norms = [], []
    for s in range(steps):
        b = token_batch(data, s)
        if mesh is not None:
            b = {k: parallel.batch_rows(v, mesh) for k, v in b.items()}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, state.params


# capacity factors: E (no token dropped), and one low enough that every
# data shard drops tokens
DROP = 0.5


def moe_config(no_drop: bool):
    cfg = get_config(MOE_ARCH).reduced()
    cf = float(cfg.moe.n_experts) if no_drop else DROP
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def moe_inputs(cfg):
    p = moe_lib.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(4, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    return p, x


def moe_loss_grads(p: dict, x, cfg, mesh=None, impl: str = "auto"):
    """y, aux and the gradients of sum(y^2) + load_balance in the params,
    on one process or (``mesh``) this rank's part, reduced over the data
    axis and gathered whole."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    with torch.enable_grad(), parallel.data_parallel():
        view = parallel.layer_view(leaves, "moe") if mesh else leaves
        xin = parallel.batch_rows(x, mesh) if mesh else x
        y, aux = moe_lib.apply_moe(view, xin, cfg, impl=impl)
        dp = mesh.axis_size(mesh.batch_axes) if mesh else 1
        loss = (y ** 2).sum() + aux["load_balance"] / dp
        gs = torch.autograd.grad(loss, list(leaves.values()))
    g = dict(zip(leaves, gs))
    if mesh is not None:
        _reduce_grads({"moe": g}, mesh)
        g = sharding.gather_params({"moe": g}, mesh)["moe"]
        y = parallel.all_gather_cat(y.detach(), 0, mesh.groups["batch"])
    return y.detach(), {k: float(v.detach()) for k, v in aux.items()}, g


def run(spec: dict) -> None:
    """Every mesh case of the test file, on this rank."""
    rank = dist.get_rank()
    out: dict = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    torch.set_num_threads(1)
    mesh = mesh_lib.make_host_mesh(2, 2)

    # data: the ranks of one model group read the same rows
    with sharding.use_mesh(mesh):
        b = ShardedBatcher(TokenStreamConfig(vocab=128, seq_len=8,
                                             global_batch=4)).batch(0)
    rows = [None] * 4
    dist.all_gather_object(rows, b["inputs"].tolist())
    out["batch_rows"] = rows

    # serving: the compressed models the test carried over from the JAX
    # package, each rank on its part
    model = build(SERVE_ARCH, reduced=True, device="cpu")
    prompt = torch.load(spec["prompt"])
    for fmt in ("bcsr", "pal4"):
        cp = torch.load(spec[f"serve_{fmt}"], weights_only=False)
        with sharding.use_mesh(mesh):
            local = sharding.shard_params(cp, mesh)
            out[f"serve_{fmt}"] = serve_outputs(model, local, prompt)
            out[f"layout_{fmt}"] = dict(mesh.layout)

    # the CLIs, joined by this group
    serve.main(spec["serve_cli"])
    for tag, argv in spec["train_cli"].items():
        cp, hs, hd, _ = train.main(argv)
        out[f"train_cli_{tag}"] = {
            "losses": [h["loss"] for h in hs + hd],
            "stores": {p: m.data.clone() for p, m in iter_bcsr(cp)},
            "resident": {p: int(m.gather_nnz.sum()) for p, m in iter_bcsr(cp)}}

    # dense training
    tmodel = build(TRAIN_ARCH, reduced=True, device="cpu")
    params = torch.load(spec["train_params"])
    with sharding.use_mesh(mesh):
        losses, norms, local = train_run(
            tmodel, sharding.shard_params(params, mesh), mesh=mesh)
        out["train"] = {"losses": losses, "norms": norms,
                        "params": sharding.gather_params(local, mesh)}

    # the expert-parallel MoE, without and with dropped tokens
    for tag, no_drop in (("moe_nodrop", True), ("moe_drop", False)):
        cfg = moe_config(no_drop)
        p, x = moe_inputs(cfg)
        with sharding.use_mesh(mesh):
            local = sharding.shard_params({"moe": p}, mesh)["moe"]
            hits = []
            saved = moe_lib._apply_moe_ep
            moe_lib._apply_moe_ep = lambda *a, **k: (hits.append(1),
                                                     saved(*a, **k))[1]
            try:
                y, aux, g = moe_loss_grads(local, x, cfg, mesh)
            finally:
                moe_lib._apply_moe_ep = saved
        out[tag] = {"y": y, "aux": aux, "grads": g, "ep": len(hits),
                    "experts_here": local["ewi"].shape[0]}

    # the compressed all-reduce
    g = {"a": torch.from_numpy(np.random.default_rng(rank).normal(
        size=(7, 5)).astype(np.float32))}
    out["all_reduce_compressed"] = collectives.all_reduce_compressed(g)["a"]

    # save on (2, 2), restore on (4, 1)
    cp = torch.load(spec["serve_bcsr"], weights_only=False)
    with sharding.use_mesh(mesh):
        local = sharding.shard_params(cp, mesh)
        whole = sharding.gather_params(local, mesh)
    if rank == 0:
        Checkpointer(spec["ckpt"]).save(3, whole, extra={
            "plan": dataclasses.asdict(whole.plan), "arch": SERVE_ARCH,
            "reduced": True})
    dist.barrier()
    mesh41 = mesh_lib.make_host_mesh(4, 1)
    with sharding.use_mesh(mesh41):
        local = elastic.restore_onto_mesh(Checkpointer(spec["ckpt"]), 3, None,
                                          mesh41)
        out["restored_41"] = sharding.gather_params(local, mesh41)
        out["restored_41_layout"] = dict(mesh41.layout)
        tp = sharding.shard_params(params, mesh41)
        out["dense_41"] = sharding.gather_params(tp, mesh41)

    if rank == 0:
        torch.save(out, os.path.join(spec["dir"], "ranks.pt"))
