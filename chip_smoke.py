#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, in order; any failure ends the run with a non-zero exit:
  1. device: the card's name and power limit, torch and CUDA versions;
     TF32 off for matmuls and convolutions;
  2. build: nvcc builds every CUDA source of ``src/repro_torch/csrc``;
  3. kernels: each spmm kernel at smollm-360m's projection shapes against
     its plain PyTorch version on the card, timed beside the plain version,
     a library yardstick (``torch.matmul`` on the densified weight, which
     the port never calls) and the least time the card could take;
  4. model: the port's serving CLI drives full-width smollm-360m (32
     layers, random weights from seed 0, pruned at 0.9 on (8, 128) blocks)
     from BlockCSR, palette-8 and palette-4 weights, with every kernel's
     launch counter read around each run; then prefill logits (bf16) and
     greedy generate tokens (f32) of the kernel path are held against the
     plain path (``sparse_backend="ref"``) on the same card;
  5. the kernel table (one JSON line) and the contract line.

It imports nothing of JAX or of the JAX package, and exits with an error
when no CUDA device is visible.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bsr_spmm import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.serve.step import generate  # noqa: E402
from repro_torch.sparse.compress import (CompressionPlan, _prune_blocks_2d,  # noqa: E402
                                         compress_params, iter_bcsr,
                                         prune_blocks_for_plan,
                                         quantize_bcsr, quantize_compressed)
from repro_torch.sparse.formats import bcsr_to_dense, dense_to_bcsr  # noqa: E402

ARCH = "smollm-360m"
BLOCK = (8, 128)
SPARSITY = 0.9
BATCH, PROMPT, GEN = 4, 16, 32
# H100 SXM peaks (NVIDIA data sheet): HBM rate, and f32 FMA outside the
# tensor cores, which is what these kernels use
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
L2_BYTES = 50 * 2**20
TIMED_CALLS = 100
SLEEP_CYCLES_PER_S = 2.0e9            # above the H100's 1.98 GHz boost clock
# Kernel vs plain: the same f32 products summed in another order (the JAX
# kernel tests' tolerance).
KERNEL_ATOL, KERNEL_RTOL = 2e-4, 1e-4
# Prefill logits in bf16, kernel vs plain path: the projections agree to f32
# rounding, but where an output sits on a bf16 rounding boundary the two
# paths round it one bf16 step (2**-8 relative) apart, and 32 layers carry
# those steps on. Bound: 2% of the largest |logit|.
BF16_LOGITS_RTOL = 2e-2
# f32 compute: only the summation order differs; 1e-4 absolute on logits of
# magnitude ~0.1-1 is ~100x the f32 rounding seen through 32 layers. It is
# also the near-tie margin below which a greedy token may differ.
F32_LOGITS_ATOL = 1e-4
EXPECTED_LAUNCHES = 7 * 32 * GEN      # 7 projections x 32 layers x 32 passes

# (name in the kernel table, wrapper, palette bits, x dtype)
VARIANTS = [("bsr_spmm", "spmm", None, torch.float32),
            ("bsr_spmm", "spmm", None, torch.bfloat16),
            ("bsr_spmm_palette8", "spmm_palette", 8, torch.bfloat16),
            ("bsr_spmm_palette4", "spmm_palette", 4, torch.bfloat16)]
REPLACES = {"bsr_spmm": "src/repro/kernels/bsr_spmm/bsr_spmm.py:163",
            "bsr_spmm_palette8": "src/repro/kernels/bsr_spmm/bsr_spmm.py:103",
            "bsr_spmm_palette4": "src/repro/kernels/bsr_spmm/bsr_spmm.py:103"}
# (projection, (out, in)) at smollm-360m's width
MATRICES = [("attn.wq", (960, 960)), ("attn.wk", (320, 960)),
            ("mlp.wi", (2560, 960)), ("mlp.wo", (960, 2560))]
M_VALUES = (4, 512)                   # decode rows (batch 4), a prefill
TABLE_SHAPE = ("mlp.wi", 4, torch.bfloat16)   # the row of the kernel table


def log(*a):
    print(*a, flush=True)


def phase(name):
    log(f"== {name}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, arg_sets) -> float:
    """Mean device time in ms of one ``fn(*args)`` call.

    A warm-up pass over all input sets (their total exceeds the L2, and it
    is timed on the host) leaves the first sets least recently used, so
    the timed calls find their inputs in device memory, as the model's
    layer loop does. The device is then held busy (``torch.cuda._sleep``)
    for longer than the host needs to queue the timed calls, so they run
    back to back and the CUDA events around them measure the device, not
    the rate at which Python enqueues."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / len(arg_sets)
    timed = [arg_sets[i % len(arg_sets)] for i in range(TIMED_CALLS)]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(3 * host_s * TIMED_CALLS * SLEEP_CYCLES_PER_S))
    start.record()
    for args in timed:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMED_CALLS


def copies(make, nbytes: int) -> list:
    """Enough fresh input sets from ``make()`` to exceed twice the L2."""
    n = min(max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1))), 4096)
    return [make() for _ in range(n)]


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def device_phase(dev) -> str:
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(dev)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def build_phase():
    phase("build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {[p.name for p in libs]} with nvcc "
        f"{' '.join(_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        log_file = _build.log_path(name)
        if log_file.exists():
            for line in log_file.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")


def _weight(rng, n, k, dev):
    w = (rng.standard_normal((n, k)) / math.sqrt(k)).astype(np.float32)
    return dense_to_bcsr(_prune_blocks_2d(w, BLOCK, SPARSITY), BLOCK).to(dev)


def _bound(m_rows, w, x_dtype, bits):
    """Least time for one call: each input read once (x, the resident
    blocks and their gather entries, the palette), the output written once,
    against the f32 FMAs the resident blocks need."""
    br, bc = w.block
    n_res = int(w.gather_nnz.sum())
    k_in, n_out = w.shape[1], w.shape[0]
    x_b = m_rows * k_in * torch.finfo(x_dtype).bits // 8
    blk_b = n_res * br * bc * (4 if bits is None else bits / 8)
    pal_b = 0 if bits is None else (1 << bits) * 4
    tab_b = n_res * 8 + w.gather_nnz.numel() * 4
    nbytes = x_b + blk_b + pal_b + tab_b + m_rows * n_out * 4
    flops = 2 * m_rows * n_res * br * bc
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else
            "operations", int(nbytes), int(flops))


def kernel_phase(dev) -> dict:
    phase("kernels")
    rng = np.random.default_rng(0)
    rows = {}
    for mat_name, (n, k) in MATRICES:
        w = _weight(rng, n, k, dev)
        packed = {None: w, 8: quantize_bcsr(w, 8), 4: quantize_bcsr(w, 4)}
        for m_rows in M_VALUES:
            for name, wrapper, bits, x_dtype in VARIANTS:
                wq = packed[bits]
                kernel = getattr(ops, wrapper)
                plain = ref.spmm_fwd_ref if bits is None else ref.spmm_palette_fwd_ref
                x = torch.randn(m_rows, k, device=dev).to(x_dtype)
                got, want = kernel(x, wq), plain(x, wq)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not torch.allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
                    raise SystemExit(f"{name} {mat_name} M={m_rows} {x_dtype}: "
                                     f"kernel disagrees with plain, max err {err}")
                call_b = tensor_bytes(x, *(t for t in (getattr(wq, "data", None),
                                                       getattr(wq, "codes", None))
                                           if t is not None))
                sets = copies(lambda: (x.clone(), wq.map(torch.clone)), call_b)
                ms = time_ms(kernel, sets)
                plain_ms = time_ms(plain, sets)
                wd = (bcsr_to_dense(w if bits is None else wq.dequantize())
                      [:n, :k].T.contiguous())
                lib_sets = copies(lambda: (x.float(), wd.clone()),
                                  tensor_bytes(x, wd) * 2)
                library_ms = time_ms(torch.matmul, lib_sets)
                bound_ms, bound_by, nbytes, flops = _bound(m_rows, wq, x_dtype, bits)
                row = {"kernel": name, "matrix": mat_name, "shape": [n, k],
                       "M": m_rows, "x": str(x_dtype).split(".")[-1],
                       "resident_blocks": int(wq.gather_nnz.sum()),
                       "max_abs_err": err, "atol": KERNEL_ATOL,
                       "rtol": KERNEL_RTOL, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "bytes": nbytes, "flops": flops}
                log(json.dumps(row))
                rows[(name, mat_name, m_rows, x_dtype)] = row
    return rows


def _serve_run(extra: list) -> dict:
    """One run of the serving CLI on the card; the launch counters are set
    to 0 just before it and read just after."""
    argv = ["--arch", ARCH, "--sparse", "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN), "--block", *map(str, BLOCK),
            "--sparsity", str(SPARSITY), *extra]
    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = serve.main(argv)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    text = buf.getvalue().splitlines()
    log(f"serve {' '.join(argv)}")
    for line in text[-3:]:
        log(f"  {line}")
    log(f"  launches {counts}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, run "
        f"{time.perf_counter() - t0:.1f} s")
    if tuple(out.shape) != (BATCH, GEN):
        raise SystemExit(f"serve returned {tuple(out.shape)} tokens")
    return counts


def _top2_margin(logits: torch.Tensor) -> float:
    top = torch.topk(logits.float(), 2, dim=-1).values
    return float(top[..., 0] - top[..., 1])


def _profile_generate(model, params, prompt) -> None:
    """Where a bf16 generate's time goes: the device time of every kernel
    (torch.profiler) against the wall time of the same call unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(model, params, prompt, GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        generate(model, params, prompt, GEN)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    attr = ("self_device_time_total" if rows and hasattr(rows[0], "self_device_time_total")
            else "self_cuda_time_total")
    dev_s = sum(getattr(e, attr) for e in rows) / 1e6
    log(f"bf16 generate {GEN} tokens x {BATCH}: wall {wall:.3f} s "
        f"({BATCH * GEN / wall:.1f} tok/s), device kernel time {dev_s:.4f} s, "
        f"device busy share {dev_s / wall:.3f}")
    for e in sorted(rows, key=lambda e: -getattr(e, attr))[:6]:
        log(f"  {getattr(e, attr) / 1e3:9.3f} ms {e.count:6d} calls  {e.key[:70]}")


def model_phase(dev) -> dict:
    phase("model: serving CLI (the main path)")
    main_counts = {}
    for fmt, extra, wrapper in (("bcsr", [], "spmm"),
                                ("pal8", ["--quantize-bits", "8"], "spmm_palette"),
                                ("pal4", ["--quantize-bits", "4"], "spmm_palette")):
        counts = _serve_run(extra)
        other = "spmm" if wrapper == "spmm_palette" else "spmm_palette"
        if counts[wrapper] != EXPECTED_LAUNCHES or counts[other]:
            raise SystemExit(f"{fmt}: launches {counts}, expected "
                             f"{EXPECTED_LAUNCHES} of {wrapper} only")
        main_counts[fmt] = counts[wrapper]

    phase("model: kernel path vs plain path")
    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    kernel_bf16 = build(cfg, device=dev)
    params = kernel_bf16.init(gen)
    plan = CompressionPlan(block=BLOCK)
    cp = compress_params(prune_blocks_for_plan(params, plan, SPARSITY), plan)
    del params
    leaves = list(iter_bcsr(cp))
    if len(leaves) != 7:
        raise SystemExit(f"expected 7 compressed projections, got "
                         f"{[n for n, _ in leaves]}")
    t1 = time.perf_counter()
    formats = {"bcsr": cp, "pal8": quantize_compressed(cp, 8),
               "pal4": quantize_compressed(cp, 4)}
    log(f"init + prune + compress {t1 - t0:.1f} s, quantize 8 and 4 bits "
        f"{time.perf_counter() - t1:.1f} s")
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                           device=dev)
    _profile_generate(kernel_bf16, cp, prompt)
    plain_bf16 = build(cfg, device=dev, sparse_backend="ref")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    kernel_f32 = build(f32, device=dev)
    plain_f32 = build(f32, device=dev, sparse_backend="ref")

    wrappers = {"bcsr": "spmm", "pal8": "spmm_palette", "pal4": "spmm_palette"}
    for fmt, params in formats.items():
        with torch.inference_mode():
            lk = kernel_bf16.prefill(params, prompt, kernel_bf16.init_cache(BATCH, PROMPT))[0]
            lr = plain_bf16.prefill(params, prompt, plain_bf16.init_cache(BATCH, PROMPT))[0]
        if not (torch.isfinite(lk).all() and lk.shape == (BATCH, cfg.vocab)):
            raise SystemExit(f"{fmt}: prefill logits not finite or misshapen")
        err = float((lk - lr).abs().max())
        bound = BF16_LOGITS_RTOL * float(lr.abs().max())
        log(f"{fmt}: bf16 prefill logits max |kernel - plain| = {err:.3e} "
            f"(bound {bound:.3e}; max |logit| {float(lr.abs().max()):.3e})")
        if err > bound:
            raise SystemExit(f"{fmt}: bf16 prefill logits disagree")

        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k = generate(kernel_f32, params, prompt, GEN)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        if counts[wrappers[fmt]] != EXPECTED_LAUNCHES:
            raise SystemExit(f"{fmt}: f32 generate launches {counts}")
        out_r = generate(plain_f32, params, prompt, GEN)
        matched = 0
        for row in range(BATCH):
            diff = (out_k[row] != out_r[row]).nonzero()
            if not len(diff):
                matched += GEN
                continue
            t = int(diff[0])
            matched += t
            seq = torch.cat([prompt[row], out_r[row, :t].to(prompt.dtype)])[None]
            with torch.inference_mode():
                logits = plain_f32.prefill(params, seq, plain_f32.init_cache(
                    1, seq.shape[1]))[0]
            margin = _top2_margin(logits)
            log(f"{fmt}: row {row} first differs at step {t}, plain top-2 "
                f"margin {margin:.3e}")
            if margin >= F32_LOGITS_ATOL:
                raise SystemExit(f"{fmt}: greedy tokens differ away from a near-tie")
        log(f"{fmt}: f32 generate {matched}/{BATCH * GEN} tokens match the "
            f"plain path; {BATCH * GEN / dt:.1f} tok/s (host clock, "
            f"synchronized), peak memory {peak / 2**30:.2f} GiB, "
            f"launches {counts}")
    return main_counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = device_phase(dev)
    build_phase()
    rows = kernel_phase(dev)
    launches = model_phase(dev)

    phase("kernel table")
    mat, m_rows, x_dtype = TABLE_SHAPE
    table = []
    for name, fmt in (("bsr_spmm", "bcsr"), ("bsr_spmm_palette8", "pal8"),
                      ("bsr_spmm_palette4", "pal4")):
        r = rows[(name, mat, m_rows, x_dtype)]
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/bsr_spmm.cu",
            "replaces": REPLACES[name], "launches": launches[fmt],
            "max_abs_err": max(v["max_abs_err"] for k, v in rows.items()
                               if k[0] == name),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": f"{mat} {r['shape']} M={m_rows} x={r['x']}",
            "card": card})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
