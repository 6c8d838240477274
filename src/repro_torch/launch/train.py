"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --steps 200 --compress l1:2.0 --debias-steps 50 \\
        --ckpt-dir /tmp/ckpt --device cpu

Runs compressed training (the paper's SpC pipeline) on a zoo
architecture with attention layers, on ``--device`` (``cuda`` unless told
otherwise). The frontend architectures (paligemma-3b, musicgen-medium)
train on synthetic (B, S, d) patch / frame embeddings in place of token
ids, as in the reference. The MoE architectures (olmoe-1b-7b,
llama4-scout-17b-a16e) train with the router's aux losses (load balance,
z-loss) in the loss; under ``--sparse`` the plan prox shrinks blocks of
each expert's (out, in) view, and debias trains the compressed experts,
each projection's backward one launch of the expert ``spmm_t`` and one of
the expert SDDMM. The recurrent architectures (recurrentgemma-9b's RG-LRU
and local attention, rwkv6-3b's time and channel mixing) train through
autograd of their sequence forms, the RG-LRU's doubling scan and RWKV's
chunked WKV; under ``--sparse`` the plan prox shrinks blocks of their
``rec`` / ``tm`` / ``cm`` projections too, and debias runs each compressed
projection through the same single-matrix kernels as attention's.

``--sparse`` switches to SpC-Retrain, training *into* BlockCSR: the prox is
the plan-aligned block group-l1 (exact zero blocks on the serving (out, in)
grid), compression needs no prune step, the debias phase retrains the
compressed model itself (masks frozen, only the block stores and the dense
residue update; every compressed projection runs the spmm kernel forward
and the spmm_t and SDDMM kernels backward, and the optimizer the fused
prox-Adam kernel), and the final artifact is a compressed checkpoint under
``<ckpt-dir>/compressed`` that ``launch/serve --sparse --ckpt-dir`` of
either package serves:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --sparse --steps 60 --debias-steps 20 \\
        --compress group_l1:0.05 --block 8 64 --ckpt-dir /tmp/spc --device cpu

``--quantize-bits 8|4`` palette-quantizes the block stores after debias;
the checkpoint then stores, and serving loads, the ``PaletteBCSR`` form.

``--mesh D,M`` trains on D * M ranks of a ("data", "model") mesh
(``launch/mesh.py``; spawned here, or joined under ``torchrun``): each
rank holds its part of the master params and moments
(``distributed.sharding``), each data coordinate trains on its rows of
the global batch, and the gradients are summed over the data axis, so the
run computes what one process computes. Under ``--sparse`` the
compressed pytree is placed again after compression and debias trains
each rank's block-row shards. Only rank 0 prints and writes checkpoints
and telemetry.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.optimizers import prox_adam, prox_rmsprop, prox_sgd
from repro_torch.data.synthetic import TokenStreamConfig, token_batch
from repro_torch.distributed import parallel, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import frontends
from repro_torch.models.model_zoo import build
from repro_torch.sparse.compress import (CompressionPlan, compressed_size_bytes,
                                         compression_summary, format_size_report,
                                         make_plan_prox, quantize_compressed)
from repro_torch.train.loop import run_spc_pipeline, run_spc_retrain_pipeline
from repro_torch.train.step import make_train_step


def parse_compress(spec: str):
    """'l1:2.0' | 'group_l1:0.5' | 'none'."""
    if spec == "none":
        return "none", 0.0
    kind, lam = spec.split(":")
    return kind, float(lam)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--debias-steps", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress", default="l1:1.0")
    ap.add_argument("--optimizer", default="prox_adam",
                    choices=["prox_adam", "prox_rmsprop", "prox_sgd"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--mesh", default="none",
                    help="none | single | multi | DATA,MODEL: train on the "
                         "ranks of a device mesh (launch/mesh.py); 'D,M' "
                         "spawns D*M ranks (or joins torchrun's): master "
                         "params split by the placement rules, the batch "
                         "split over data, gradients summed over it; with "
                         "--sparse the compressed pytree is placed again "
                         "and debias trains the block-row shards")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--telemetry-out", default="",
                    help="stream per-log-step training telemetry to this "
                         "JSONL file: loss and grad-norm, live block "
                         "sparsity and the group-l1 penalty on the serving "
                         "grid, one phase-tagged record per line")
    ap.add_argument("--sparse", action="store_true",
                    help="SpC-Retrain into BlockCSR: prox-SpC training with "
                         "plan-aligned block group-l1, compression with no "
                         "prune step, mask-frozen debias retraining ON the "
                         "compressed params (dw via SDDMM at the resident "
                         "slots), then a compressed checkpoint under "
                         "<ckpt-dir>/compressed")
    ap.add_argument("--quantize-bits", type=int, default=0, choices=[0, 4, 8],
                    help="with --sparse: palette-quantize the block stores "
                         "to PaletteBCSR at this width after debias")
    ap.add_argument("--block", type=int, nargs=2, default=(8, 64),
                    metavar=("BR", "BC"),
                    help="BCSR block on the (out, in) view (--sparse)")
    ap.add_argument("--min-block-sparsity", type=float, default=0.3,
                    help="dense fallback below this zero-block fraction")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.quantize_bits and not args.sparse:
        raise SystemExit("--quantize-bits requires --sparse (the palette "
                         "quantizes the compressed BlockCSR block store)")
    shape = mesh_lib.parse_mesh_flag(args.mesh)
    if shape is None:
        return _train(args)
    mesh_lib.require_ranks(args.mesh)
    n_data = int(np.prod(shape[:-1]))
    if args.batch % n_data:
        raise SystemExit(f"--batch {args.batch} does not split over the "
                         f"{n_data} data shards of --mesh {args.mesh}")
    return mesh_lib.launch(args.mesh, _train, args.device, (args,))


class _NoTelemetry:
    """The telemetry of a rank other than 0: takes records, writes none."""
    n_records = 0

    def emit(self, rec) -> None:
        pass

    def close(self) -> None:
        pass


def _train(args, mesh=None):
    """The run of one process, or of one rank of ``mesh`` (a spawned
    rank's result is dropped)."""
    logging.basicConfig(level=logging.INFO)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    main_rank = mesh is None or mesh.rank == 0
    model = build(args.arch, reduced=args.reduced, device=device)
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen)
    n_params = sum(p.numel() for p in metrics_lib.tree_leaves(params))
    print(f"arch={cfg.name} params={n_params:,}")
    if mesh is not None:
        # place the master params once; the steps keep the placement
        params = sharding.shard_params(params, mesh)

    kind, lam = parse_compress(args.compress)
    opt_cls = {"prox_adam": prox_adam, "prox_rmsprop": prox_rmsprop,
               "prox_sgd": prox_sgd}[args.optimizer]
    plan = CompressionPlan(block=tuple(args.block),
                           min_sparsity=args.min_block_sparsity)
    if args.sparse:
        if kind != "group_l1" or lam <= 0:
            raise SystemExit(
                f"--sparse trains into BlockCSR via block group-l1; pass "
                f"--compress group_l1:<lam> with lam > 0 (got {args.compress!r})")
        opt = opt_cls(args.lr, lam=lam, prox_fn=make_plan_prox(plan))
    else:
        opt = opt_cls(args.lr, lam=lam,
                      prox_name=kind if kind != "none" else "none")
    opt_debias = opt_cls(args.lr, lam=0.0)

    data_cfg = TokenStreamConfig(vocab=cfg.vocab, seq_len=args.seq,
                                 global_batch=args.batch)

    def batch_fn(step):
        b = token_batch(data_cfg, step, device=device)
        if cfg.frontend != "none":
            # precomputed patch / frame embeddings in place of token ids
            emb = frontends.synthetic_embeddings(
                torch.Generator(device=device).manual_seed(step), cfg,
                args.batch, args.seq)
            b = {"inputs": emb, "labels": b["labels"]}
        if mesh is not None:
            # this data coordinate's rows of the global batch
            b = {k: parallel.batch_rows(v, mesh) for k, v in b.items()}
        return b

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None and ckpt.latest_step() is not None:
        # the loop resumes from the newest checkpoint: the compression and
        # prox flags are not re-applied to steps already trained
        logging.getLogger("repro_torch.launch.train").warning(
            "resuming from existing checkpoint (step %d) in %s; "
            "hyperparameter flags must match the original run; use a fresh "
            "--ckpt-dir to restart training", ckpt.latest_step(),
            args.ckpt_dir)

    def make_step(o, param_transform=None):
        return make_train_step(model, o, param_transform=param_transform)

    telemetry = None
    if args.telemetry_out:
        from repro_torch.obs.profile import TrainTelemetry
        telemetry = (TrainTelemetry(args.telemetry_out) if main_rank
                     else _NoTelemetry())

    if args.sparse:
        cp, hist_spc, hist_db, report = run_spc_retrain_pipeline(
            params, make_step, opt, opt_debias, batch_fn,
            spc_steps=args.steps, debias_steps=args.debias_steps, plan=plan,
            checkpointer=ckpt, log_every=args.log_every, telemetry=telemetry)
        if mesh is not None:
            cp = sharding.gather_params(cp, mesh)
        if args.quantize_bits:
            cp = quantize_compressed(cp, bits=args.quantize_bits)
            report["palette_bytes"] = compressed_size_bytes(cp)
        print("compression:", json.dumps(report, indent=1))
        if hist_spc:
            print(f"loss: {hist_spc[0]['loss']:.4f} -> "
                  f"{hist_spc[-1]['loss']:.4f}")
        print(compression_summary(cp))
        print(format_size_report(report["dense_bytes"], report["bcsr_bytes"],
                                 report.get("palette_bytes")))
        if args.ckpt_dir and main_rank:
            cdir = os.path.join(args.ckpt_dir, "compressed")
            path = Checkpointer(cdir, keep_n=2).save(
                args.steps + args.debias_steps, cp,
                extra={"plan": dataclasses.asdict(cp.plan),
                       "arch": args.arch, "reduced": args.reduced})
            print(f"compressed checkpoint: {path}")
        if telemetry is not None:
            telemetry.close()
            print(f"telemetry: {telemetry.n_records} records -> "
                  f"{args.telemetry_out}")
        return cp, hist_spc, hist_db, report

    state, hist_spc, hist_db, report = run_spc_pipeline(
        params, make_step, opt, opt_debias, batch_fn, spc_steps=args.steps,
        debias_steps=args.debias_steps, checkpointer=ckpt,
        log_every=args.log_every, telemetry=telemetry,
        sparsity_block=tuple(args.block))
    print("compression:", json.dumps(report, indent=1))
    if hist_spc:
        print(f"loss: {hist_spc[0]['loss']:.4f} -> {hist_spc[-1]['loss']:.4f}")
    if mesh is not None:
        state = sharding.gather_state(state, mesh)
    table = metrics_lib.layer_compression(state.params)
    print(metrics_lib.format_table(table, "layer-wise compression:"))
    if telemetry is not None:
        telemetry.close()
        print(f"telemetry: {telemetry.n_records} records -> "
              f"{args.telemetry_out}")
    return state, hist_spc, hist_db, report


if __name__ == "__main__":
    main()
