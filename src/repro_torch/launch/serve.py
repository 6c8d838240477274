"""Serving launcher: batched generation, optionally from compressed weights.

Port of the non-engine path of ``repro.launch.serve``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --batch 4 --prompt-len 16 --gen 32 --sparse [--quantize-bits 8|4]

``--sparse`` block-magnitude-prunes the random init on the serving BCSR
grid, compresses it (attention q/k/v/o, MLP and an untied head as BlockCSR;
dense where a matrix does not compress) and serves from it: every
compressed projection runs the CUDA spmm kernels in prefill and decode.
``--quantize-bits 8|4`` serves PaletteBCSR instead. ``--ckpt-dir`` serves a
compressed checkpoint written by the JAX package's ``launch/train
--sparse``. Either way the per-matrix size table and the dense / bcsr /
palette byte line are printed. The model runs on ``--device`` (``cuda``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.metrics import model_size_bytes
from repro_torch.models.model_zoo import build
from repro_torch.serve.api import SamplingParams
from repro_torch.serve.step import generate
from repro_torch.sparse.compress import (CompressionPlan, bcsr_equiv_size_bytes,
                                         compress_params, compressed_size_bytes,
                                         compression_summary, format_size_report,
                                         iter_bcsr, prune_blocks_for_plan)
from repro_torch.sparse.formats import PaletteBCSR

_ENGINE = "the continuous-batching engine slice (ROADMAP Queue 1 item 7)"
_NOT_PORTED = {
    **{f: _ENGINE for f in (
        "--engine", "--max-batch", "--prefill-chunk", "--page-size",
        "--first-chunk", "--attn-backend", "--kv-splits", "--prefix-cache",
        "--priority", "--requests", "--parity-check", "--metrics-out",
        "--trace-out", "--profile")},
    "--replicas": "the router slice (ROADMAP Queue 1 item 11)",
    "--route": "the router slice (ROADMAP Queue 1 item 11)",
    "--mesh": "the multi-device slice (ROADMAP Queue 1 item 12)",
    "--logits-out": "the multi-device slice (ROADMAP Queue 1 item 12)",
}


def _reject_not_ported(argv) -> None:
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in _NOT_PORTED:
            raise SystemExit(f"{flag} is not ported to repro_torch yet; it "
                             f"comes with {_NOT_PORTED[flag]}")


def _report_sizes(cp, dense_b: int) -> None:
    """Per-matrix breakdown + one-line byte report: ``bcsr`` is the fp32
    BlockCSR total; with palette leaves the actual total is ``palette``."""
    quantized = any(isinstance(m, PaletteBCSR) for _, m in iter_bcsr(cp))
    print(compression_summary(cp))
    print(format_size_report(dense_b, bcsr_equiv_size_bytes(cp),
                             compressed_size_bytes(cp) if quantized else None))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--sparse", action="store_true",
                    help="serve from the compressed form: with --ckpt-dir, "
                         "a compressed checkpoint; without, block-prune the "
                         "random init on the serving BCSR grid and compress")
    ap.add_argument("--quantize-bits", type=int, default=0, choices=[0, 4, 8],
                    help="palette-quantize the compressed block data "
                         "(PaletteBCSR) before serving; prune path only")
    ap.add_argument("--sparsity", type=float, default=0.9,
                    help="fraction of weight blocks pruned before compression")
    ap.add_argument("--block", type=int, nargs=2, default=(8, 128),
                    metavar=("BR", "BC"), help="BCSR block (out, in) view")
    ap.add_argument("--min-block-sparsity", type=float, default=0.5,
                    help="dense fallback below this zero-block fraction")
    ap.add_argument("--ckpt-dir", default="",
                    help="serve a compressed checkpoint (looks in "
                         "<dir>/compressed, then <dir>)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation when sampling (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus (top-p) filtering when sampling (1 = off)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the plain "
                         "PyTorch versions of the kernels)")
    return ap


def main(argv=None):
    _reject_not_ported(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.quantize_bits and (not args.sparse or args.ckpt_dir):
        raise SystemExit(
            "--quantize-bits applies to the --sparse prune path only "
            "(checkpoints carry their own quantization; without --sparse "
            "nothing is compressed to quantize)")

    model = build(args.arch, reduced=args.reduced, device=args.device)
    cfg, dev = model.cfg, model.device
    gen = torch.Generator(device=dev).manual_seed(0)

    if args.ckpt_dir:
        cdir = os.path.join(args.ckpt_dir, "compressed")
        if not os.path.isdir(cdir):
            cdir = args.ckpt_dir
        ckpt = Checkpointer(cdir)
        latest = ckpt.latest_step() if os.path.isdir(cdir) else None
        if latest is None:
            raise SystemExit(f"no checkpoints found in {cdir}")
        extra = ckpt.manifest(latest).get("extra") or {}
        if extra.get("arch") not in (None, args.arch) or \
                extra.get("reduced") not in (None, args.reduced):
            raise SystemExit(
                f"checkpoint was trained with arch={extra.get('arch')!r} "
                f"reduced={extra.get('reduced')} but serve got "
                f"arch={args.arch!r} reduced={args.reduced}")
        params = ckpt.restore_compressed(latest, device=dev)
        # dense bytes from shapes only: no dense model is allocated
        _report_sizes(params, model_size_bytes(model.init(device="meta")))
    elif args.sparse:
        params = model.init(gen)
        plan = CompressionPlan(block=tuple(args.block),
                               min_sparsity=args.min_block_sparsity,
                               quantize_bits=args.quantize_bits or None)
        params = prune_blocks_for_plan(params, plan, args.sparsity)
        dense_b = model_size_bytes(params)
        params = compress_params(params, plan)
        _report_sizes(params, dense_b)
    else:
        params = model.init(gen)

    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = generate(model, params, prompt, args.gen, sampling=sampling,
                   generator=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
