"""Serving launcher: batched generation or the continuous-batching
engine, optionally from compressed weights.

Port of ``repro.launch.serve``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --batch 4 --prompt-len 16 --gen 32 --sparse [--quantize-bits 8|4]

``--arch`` takes the attention-only configs and the recurrent families
``recurrentgemma-9b`` (RG-LRU + local attention) and ``rwkv6-3b``.
``--sparse`` block-magnitude-prunes the random init on the serving BCSR
grid, compresses it (attention q/k/v/o, MLP, the RG-LRU and RWKV
projections and an untied head as BlockCSR; dense where a matrix does not
compress) and serves from it: every compressed projection runs the CUDA
spmm kernels in prefill and decode.
``--quantize-bits 8|4`` serves PaletteBCSR instead. ``--ckpt-dir`` serves a
compressed checkpoint written by the JAX package's ``launch/train
--sparse``. Either way the per-matrix size table and the dense / bcsr /
palette byte line are printed. The model runs on ``--device`` (``cuda``).

``--arch`` also takes the MoE architectures (olmoe-1b-7b: 64 experts,
top-8; llama4-scout-17b-a16e: 16 experts, top-1, a shared expert): with
``--sparse`` their expert stacks compress to E-stacked BlockCSR and each
expert projection runs one spmm launch over all experts.
``--profile [DIR]`` times every kernel entry (CUDA events on the stream)
and the engine tick (host clock) and prints the summary; with DIR it also
writes a ``torch.profiler`` Chrome trace there.

``--engine`` serves a ``--requests`` mix through the continuous-batching
engine (``serve/engine.py``): slot resource pools (paged KV for attention
layers, slot-indexed state for recurrent ones), chunked prefill
interleaved with decode, priority classes with preemption, an optional
radix prefix cache, and the paged flash-decode CUDA kernel for attention
(``--attn-backend``). ``--parity-check`` holds every request's greedy
tokens against ``generate``; ``--metrics-out`` and ``--trace-out`` write
the metrics registry and a Chrome trace of the run.

``--engine --replicas N`` serves the mix through N engine replicas behind
the asyncio router (``serve/router.py``): one worker thread per replica,
each on its own CUDA stream, all reading one copy of the weights.
``--route`` picks the dispatch: ``prefix`` (rendezvous hash of the
prompt's leading pages, so a shared system prompt stays on the replica
whose prefix cache holds it), ``least-loaded`` or ``round-robin``. It
prints the fleet's line and one line per replica; ``--metrics-out`` writes
the router's registry with every replica's (JSON, or Prometheus with a
``replica`` label), and one tracer and one profiler cover the fleet.
Requests cross the router as the typed values of ``serve/api.py``, whose
``to_json`` / ``from_json`` are the wire format.

``--mesh D,M`` serves on D * M ranks of a ("data", "model") mesh
(``launch/mesh.py``): spawned here (a ``FileStore`` rendezvous), or
joined under ``torchrun``. Each rank holds its part of the params
(``distributed.sharding``): the compressed stores split by block rows,
"model"-split ones computed split, FSDP ones gathered before use. The
batch splits over "data", and ``generate`` and ``--engine`` compute what
one process computes. ``--logits-out F`` saves the prefill logits
(B, vocab) to F, with or without a mesh. Only rank 0 prints and writes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.metrics import model_size_bytes
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model_zoo import build
from repro_torch.obs.profile import Profiler
from repro_torch.obs.trace import Tracer
from repro_torch.serve import api
from repro_torch.serve.api import SamplingParams
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.router import ROUTE_POLICIES, Router
from repro_torch.serve.step import generate, prefill_logits
from repro_torch.sparse.compress import (CompressionPlan, bcsr_equiv_size_bytes,
                                         compressed_size_bytes,
                                         compression_summary, format_size_report,
                                         init_compressed, iter_bcsr)
from repro_torch.sparse.formats import PaletteBCSR

def _report_sizes(cp, dense_b: int) -> None:
    """Per-matrix breakdown + one-line byte report: ``bcsr`` is the fp32
    BlockCSR total; with palette leaves the actual total is ``palette``."""
    quantized = any(isinstance(m, PaletteBCSR) for _, m in iter_bcsr(cp))
    print(compression_summary(cp))
    print(format_size_report(dense_b, bcsr_equiv_size_bytes(cp),
                             compressed_size_bytes(cp) if quantized else None))


def _store_bytes(params) -> int:
    """Bytes of the compressed stores (block values or codes, palettes,
    indices) this process holds."""
    return sum(m.nbytes for _, m in iter_bcsr(params)) \
        if hasattr(params, "sparse") else 0


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
    ap.add_argument("--mesh", default="none",
                    help="none | single | multi | DATA,MODEL: serve on the "
                         "ranks of a device mesh (launch/mesh.py); 'D,M' "
                         "spawns D*M ranks (or joins torchrun's), each "
                         "holding its part of the params: compressed "
                         "stores split by block rows, the batch split over "
                         "data; tokens and logits match one process")
    ap.add_argument("--logits-out", default="",
                    help="save the prefill logits (B, vocab) to this .npy "
                         "path (the sharded-vs-single parity check)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation when sampling (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus (top-p) filtering when sampling (1 = off)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--engine", action="store_true",
                    help="serve through the continuous-batching engine "
                         "(serve/engine.py): paged KV pools, chunked "
                         "prefill, priority classes with preemption over a "
                         "fixed-capacity slot batch")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="engine slot capacity (concurrent requests)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens consumed per slot per engine tick; "
                         "longer prompts prefill across ticks, interleaved "
                         "with running decodes")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page length (tokens) of the paged cache")
    ap.add_argument("--first-chunk", type=int, default=0,
                    help="jumbo width for the FIRST prefill chunk of a long "
                         "prompt (> --prefill-chunk; 0 = off)")
    ap.add_argument("--attn-backend", default="auto",
                    choices=["auto", "cuda", "ref"],
                    help="paged attention of the engine step: 'cuda' = the "
                         "paged flash-decode kernel (its plain version on "
                         "the CPU), 'ref' = gather then softmax, 'auto' = "
                         "cuda on a card, ref on the CPU")
    ap.add_argument("--kv-splits", type=int, default=1,
                    help="flash-decode KV-split lanes per slot on the cuda "
                         "backend")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="with --engine: radix-tree prefix caching; requests "
                         "sharing a prompt prefix share physical KV pages "
                         "(refcounted, copy-on-write on the first diverging "
                         "page)")
    ap.add_argument("--priority", default="standard",
                    help="default scheduling class of --engine requests: "
                         "interactive | standard | batch, or an int >= 0 "
                         "(0 = most important)")
    ap.add_argument("--requests", default="",
                    help="JSON request mix for --engine: a list of "
                         '{"prompt_len": N, "gen": M} (seeded random '
                         'prompt) or {"prompt": [ids], "gen": M} entries, '
                         'each with an optional "priority"; default: '
                         "--batch copies of --prompt-len/--gen")
    ap.add_argument("--parity-check", action="store_true",
                    help="with --engine (greedy): also run every request "
                         "through generate() and fail on any token mismatch")
    ap.add_argument("--metrics-out", default="",
                    help="with --engine: write the metrics registry after "
                         "the run (Prometheus text, or JSON for a .json "
                         "path)")
    ap.add_argument("--trace-out", default="",
                    help="with --engine: write a Chrome trace-event / "
                         "Perfetto JSON of the run")
    ap.add_argument("--profile", nargs="?", const="", default=None,
                    metavar="TRACE_DIR",
                    help="time the engine tick and every kernel entry "
                         "point (CUDA events on the stream for tensors on "
                         "the card) and print the summary; pass a "
                         "directory to also write a torch.profiler Chrome "
                         "trace there")
    ap.add_argument("--replicas", type=int, default=1,
                    help="with --engine: serve through N engine replicas "
                         "behind the asyncio router (serve/router.py), one "
                         "worker thread and CUDA stream each; the replicas "
                         "share one copy of the (compressed) weights")
    ap.add_argument("--route", default="prefix", choices=ROUTE_POLICIES,
                    help="router dispatch: 'prefix' = rendezvous-hash the "
                         "leading page-aligned prompt tokens, so a shared "
                         "system prompt stays on the replica whose prefix "
                         "cache holds it (least-loaded for prompts shorter "
                         "than a page), 'least-loaded' = queue depth + "
                         "reserved pages, 'round-robin' = modulo counter")
    return ap


def _profiler(args):
    """--profile as a ``Profiler`` (None when the flag is off: the kernel
    hooks then take their free path)."""
    if args.profile is None:
        return None
    return Profiler(trace_dir=args.profile or None)


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.quantize_bits and (not args.sparse or args.ckpt_dir):
        raise SystemExit(
            "--quantize-bits applies to the --sparse prune path only "
            "(checkpoints carry their own quantization; without --sparse "
            "nothing is compressed to quantize)")
    shape = mesh_lib.parse_mesh_flag(args.mesh)
    if shape is None:
        return _serve(args)
    if args.replicas > 1:
        raise SystemExit(
            "--replicas with --mesh is not supported: the router's "
            "least-loaded dispatch depends on timing, so the ranks of a "
            "mesh could route a request to different replicas")
    return mesh_lib.launch(args.mesh, _serve, args.device, (args,))


def _serve(args, mesh=None):
    """The run of one process, or of one rank of ``mesh`` (a spawned
    rank's result is dropped)."""
    device = mesh.device if mesh is not None else args.device
    model = build(args.arch, reduced=args.reduced, device=device)
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
        # under a mesh the whole model is read on the host, reported, and
        # split there (what restore_compressed(mesh=) does)
        params = ckpt.restore_compressed(
            latest, device="cpu" if mesh is not None else dev)
        # dense bytes from shapes only: no dense model is allocated
        _report_sizes(params, model_size_bytes(model.init(device="meta")))
    elif args.sparse:
        plan = CompressionPlan(block=tuple(args.block),
                               min_sparsity=args.min_block_sparsity,
                               quantize_bits=args.quantize_bits or None)
        # pruned and compressed part by part on the device: the dense
        # model never exists whole
        params = init_compressed(model, plan, args.sparsity, gen)
        _report_sizes(params, model_size_bytes(model.init(device="meta")))
    else:
        params = model.init(gen)
    if mesh is not None:
        params = sharding.shard_params(params, mesh)
        print(f"rank 0 holds {_store_bytes(params) / 2**20:.2f} MiB of "
              f"compressed stores")

    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    if args.logits_out:
        logits = prefill_logits(model, params, prompt,
                                args.prompt_len + args.gen)
        if mesh_lib.is_main_rank():
            np.save(args.logits_out, logits.float().cpu().numpy())
        print(f"prefill logits -> {args.logits_out}")
    if args.engine:
        return _run_engine(model, params, args)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p)
    profiler = _profiler(args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with profiler or contextlib.nullcontext():
        out = generate(model, params, prompt, args.gen, sampling=sampling,
                       generator=gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    if profiler is not None:
        print(profiler.format_summary())
    print("sample:", out[0, :16].tolist())
    return out


def _sampling(args) -> SamplingParams:
    return SamplingParams(temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p)


def _load_requests(args, vocab: int) -> list:
    """``api.Request`` list from --requests JSON (or the --batch /
    --prompt-len / --gen defaults), validated against the typed schema.
    Random prompts are seeded by request index, so a mix is reproducible
    (the reference seeds them through ``jax.random``: the ids differ)."""
    if args.requests:
        with open(args.requests) as f:
            try:
                spec = json.load(f)
            except json.JSONDecodeError as e:
                raise SystemExit(f"--requests {args.requests}: not valid "
                                 f"JSON ({e})")
    else:
        spec = [{"prompt_len": args.prompt_len, "gen": args.gen}
                for _ in range(args.batch)]
    try:
        entries = api.parse_request_file(spec, default_gen=args.gen,
                                         default_priority=args.priority)
    except api.ApiValidationError as e:
        raise SystemExit(f"--requests {args.requests or '(defaults)'}: {e}")
    out = []
    for i, e in enumerate(entries):
        ids = e["prompt"]
        if ids is None:
            ids = np.random.default_rng([1234, i]).integers(
                0, vocab, e["prompt_len"]).astype(np.int32)
        out.append(api.Request(prompt=ids,
                               max_new_tokens=e["max_new_tokens"],
                               eos_id=e["eos_id"], priority=e["priority"],
                               sampling=e["sampling"]))
    return out


def _engine_config(args, max_seq: int) -> EngineConfig:
    return EngineConfig(max_batch=args.max_batch,
                        prefill_chunk=args.prefill_chunk,
                        page_size=args.page_size, max_seq_len=max_seq,
                        first_chunk=args.first_chunk or None,
                        attn_backend=args.attn_backend,
                        kv_splits=args.kv_splits,
                        prefix_cache=args.prefix_cache,
                        sampling=_sampling(args))


def _ms(x) -> str:
    """Milliseconds for printing; percentiles over no records are None."""
    return "-" if x is None else f"{x * 1e3:.0f}"


def _check_parity(model, params, args, requests, results) -> None:
    if args.temperature > 0:
        raise SystemExit("--parity-check needs greedy decoding "
                         "(--temperature 0)")
    for rid, r in enumerate(requests):
        prompt = torch.as_tensor(r.prompt_ids, device=model.device)[None]
        ref = generate(model, params, prompt, r.max_new_tokens)[0]
        ref = ref.cpu().numpy()
        got = np.asarray(results[rid])
        if r.eos_id is not None and r.eos_id in ref.tolist():
            ref = ref[:ref.tolist().index(r.eos_id) + 1]
        if not np.array_equal(ref, got):
            raise SystemExit(
                f"engine-vs-generate token mismatch for request {rid} "
                f"(prompt_len={len(r.prompt)}): {got.tolist()} != "
                f"{ref.tolist()}")
    print(f"engine-vs-generate parity OK ({len(requests)} requests)")


def _print_slo_classes(s: dict) -> None:
    for c, cs in s["by_class"].items():
        print(f"  class {c}: {cs['n_requests']} requests "
              f"({cs['n_preempted']} preempted) | ttft p50/p95 "
              f"{_ms(cs['ttft_p50_s'])}/{_ms(cs['ttft_p95_s'])}ms")


def _save_telemetry(args, save_prom, save_json, tracer, profiler) -> None:
    """Write --metrics-out / --trace-out and print the profile summary.
    ``save_prom(path)`` / ``save_json(path)`` export the engine's registry
    or the router's fleet."""
    if args.metrics_out:
        if args.metrics_out.endswith(".json"):
            save_json(args.metrics_out)
        else:
            save_prom(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"trace -> {args.trace_out} ({len(tracer.events)} events)")
    if profiler is not None:
        print(profiler.format_summary())


def _run_engine(model, params, args) -> dict:
    """The --engine path: continuous batching over paged KV pools; with
    --replicas N > 1, N such engines behind the router."""
    requests = _load_requests(args, model.cfg.vocab)
    max_seq = max(len(r.prompt) + r.max_new_tokens for r in requests)
    config = _engine_config(args, max_seq)
    if args.replicas > 1:
        return _run_router(model, params, args, config, requests)
    tracer = Tracer() if args.trace_out else None
    gen = (torch.Generator(device=model.device).manual_seed(1)
           if args.temperature > 0 else None)
    profiler = _profiler(args)
    engine = ServeEngine(model, params, config,
                         generator=gen, tracer=tracer, profiler=profiler)
    pb = engine.pool_bytes
    print(f"engine pools: kv_pages={pb['kv_page_bytes'] / 2**20:.2f} MiB "
          f"recurrent_state={pb['state_slot_bytes'] / 2**20:.2f} MiB "
          f"({engine.config.max_batch} slots)")
    try:
        with profiler or contextlib.nullcontext():
            out = engine.run(requests)
    except api.ApiValidationError as e:
        raise SystemExit(f"--engine: {e}")
    s = out["stats"]
    print(f"engine: {s['n_requests']} requests "
          f"({s['n_prompt']} prompt + {s['n_generated']} new tokens) in "
          f"{s['wall_s']:.2f}s = {s['tok_s']:.1f} tok/s | "
          f"ttft p50/p95 {_ms(s['ttft_p50_s'])}/{_ms(s['ttft_p95_s'])}ms"
          f" | latency p50/p95 {_ms(s['latency_p50_s'])}/"
          f"{_ms(s['latency_p95_s'])}ms | {s['n_ticks']} ticks, "
          f"{s['n_prefill_chunks']} prefill chunks | pools "
          f"kv={s['kv_page_bytes']} state={s['state_slot_bytes']} bytes")
    if len(s["by_class"]) > 1 or s["n_preemptions"]:
        _print_slo_classes(s)
        print(f"  {s['n_preemptions']} preemptions")
    if args.prefix_cache:
        print(f"  prefix cache: hit rate {s['prefix_hit_rate']:.1%} "
              f"({s['n_cached_tokens']} prompt tokens served from cache)")
    _save_telemetry(args, engine.metrics.save_prometheus,
                    engine.metrics.save_json, tracer, profiler)
    print("sample:", [int(t) for t in out["results"][0][:16]])
    if args.parity_check:
        _check_parity(model, params, args, requests, out["results"])
    return out


def _run_router(model, params, args, config, requests) -> dict:
    """--replicas N: N identical engines (one EngineConfig, one copy of the
    weights) behind the prefix / least-loaded / round-robin router. One
    tracer (router request ids are unique across the fleet, so each
    request keeps one track) and one profiler cover every replica; each
    replica samples from its own generator."""
    tracer = Tracer() if args.trace_out else None
    profiler = _profiler(args)
    router = Router.build(model, params, config, args.replicas,
                          generator_seed=1 if args.temperature > 0 else None,
                          tracer=tracer, profiler=profiler,
                          policy=args.route)
    pb = router.replicas[0].engine.pool_bytes
    print(f"router: {args.replicas} replicas, pools each kv_pages="
          f"{pb['kv_page_bytes'] / 2**20:.2f} MiB recurrent_state="
          f"{pb['state_slot_bytes'] / 2**20:.2f} MiB "
          f"({config.max_batch} slots)")
    try:
        with profiler or contextlib.nullcontext():
            out = router.serve(requests)
    except api.ApiValidationError as e:
        raise SystemExit(f"--engine: {e}")
    s = out["stats"]
    print(f"router[{args.replicas}x {args.route}]: {s['n_requests']} "
          f"requests ({s['n_prompt']} prompt + {s['n_generated']} new "
          f"tokens) in {s['wall_s']:.2f}s = {s['tok_s']:.1f} tok/s | "
          f"ttft p50/p95 {_ms(s['ttft_p50_s'])}/{_ms(s['ttft_p95_s'])}ms"
          f" | latency p50/p95 {_ms(s['latency_p50_s'])}/"
          f"{_ms(s['latency_p95_s'])}ms | "
          f"{s['n_redispatched']} re-dispatched, "
          f"{s['n_failed_replicas']} failed replicas")
    if len(s["by_class"]) > 1:
        _print_slo_classes(s)
    for r in s["per_replica"]:
        line = (f"  replica {r['replica']}: {r['n_requests']} requests, "
                f"{r['n_generated']} tokens, {r['n_ticks']} ticks")
        if args.prefix_cache:
            line += f", prefix hit rate {r['prefix_hit_rate']:.1%}"
        if r["failed"]:
            line += " [FAILED]"
        print(line)

    def save_json(path):
        with open(path, "w") as f:
            json.dump({"router": router.metrics.snapshot(),
                       "replicas": [r.engine.metrics.snapshot()
                                    for r in router.replicas]}, f, indent=1)
            f.write("\n")

    def save_prom(path):
        with open(path, "w") as f:
            f.write(router.to_prometheus())

    _save_telemetry(args, save_prom, save_json, tracer, profiler)
    print("sample:", [int(t) for t in out["results"][0][:16]])
    if args.parity_check:
        _check_parity(model, params, args, requests, out["results"])
    return out


if __name__ == "__main__":
    main()
