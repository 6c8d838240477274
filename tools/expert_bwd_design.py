#!/usr/bin/env python3
"""Where the time of the expert backward (``csrc/bsr_experts_bwd.cu``:
``bsr_experts_dx`` for ``ops.spmm_t_experts``, ``bsr_experts_dw`` for
``bsr_weight_grad_experts``) goes, at olmoe-1b-7b's ewi: the shipped
kernels against patched copies of the source.

    python3 tools/expert_bwd_design.py [--variants=a,b]

Each variant changes one thing (``VARIANTS``); every copy is built into
``build/expert_bwd_design/`` (one nvcc per copy, all at once) and loaded
with ctypes in place of the shipped library, each call held to the plain
version (``chip_smoke._check``) and timed with ``chip_smoke.time_ms``
(CUDA events, inputs cold in L2). Weights: 64 experts of (1024, 2048),
(8, 128) blocks pruned at 0.9 from seed-0 random views, a bf16 store; dY
and x at M = 80 and 8, bf16 (and f32 at M = 80), every row and the rows a
random top-8 router fills at that capacity. Prints the card, then one
JSON line per (M, dtype, rows) with each variant's ms; the ptxas reports
go to ``build/expert_bwd_design/ptxas.log``. About 3 minutes on an H100.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import cuda_variants  # noqa: E402
from repro_torch.kernels.bsr_sddmm import ops as sddmm_ops  # noqa: E402
from repro_torch.kernels.bsr_spmm import ops, ref  # noqa: E402
from repro_torch.sparse.compress import (CompressionPlan,  # noqa: E402
                                         _pad_stack, _prune_to_bcsr)

OUT = ROOT / "build" / "expert_bwd_design"
E, TOP_K, D, FF = 64, 8, 2048, 1024
TOKENS = {80: 512, 8: 48}          # tokens whose capacity is each M

DX_BOUNDS = "__launch_bounds__(256, 2)\nbsr_experts_dx("
DW_BOUNDS = ("__launch_bounds__(kWarps * 32, sizeof(TY) == 2 && sizeof(TX) == 2 "
             "? 4 : 1)\nbsr_experts_dw(")
JOB = "constexpr int kJob = 32;"
VARIANTS = {
    # dX at up to 255 registers a thread (one thread block an SM)
    "dx_lb1": [(DX_BOUNDS, DX_BOUNDS.replace(", 2)", ", 1)"))],
    # dX jobs of 64 / 128 summed entries (stages 2x / 4x as large)
    "dx_job64": [(JOB, JOB.replace("32", "64"))],
    "dx_job128": [(JOB, JOB.replace("32", "128"))],
    # the SDDMM with 16-bit operands at up to 255 / 168 registers a thread
    # (1 / 3 thread blocks an SM; the shipped 128 give 4)
    "dw_lb1": [(DW_BOUNDS, DW_BOUNDS.replace("? 4 : 1", "? 1 : 1"))],
    "dw_lb3": [(DW_BOUNDS, DW_BOUNDS.replace("? 4 : 1", "? 3 : 1"))],
}


def build_variants(names) -> dict:
    """The expert backward library of each variant in ``names`` and the
    shipped one: name -> (library, ptxas report)."""
    return cuda_variants.build_variants(
        "bsr_experts_bwd", OUT, VARIANTS, names, ops.experts_bwd_lib,
        ("bsr_spmm_t_experts", "bsr_sddmm_experts"))


def main() -> int:
    if not torch.cuda.is_available():
        print("expert_bwd_design: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = list(VARIANTS)
    for arg in sys.argv[1:]:
        if arg.startswith("--variants="):     # only these ("": none)
            names = [n for n in arg.split("=", 1)[1].split(",") if n]
    libs = build_variants(names)
    reports = []
    for name, (_, report) in libs.items():
        cs.log = lambda *a, name=name: print(f"[{name}]", *a, flush=True)
        cs._log_ptxas(f"bsr_experts_bwd_{name}", report)
        reports.append(f"== {name}\n{report}")
    (OUT / "ptxas.log").write_text("\n".join(reports))
    gen = torch.Generator(device=dev).manual_seed(0)
    views = torch.randn(E, FF, D, generator=gen, device=dev) / math.sqrt(D)
    w32 = _pad_stack(_prune_to_bcsr(views, cs.BLOCK, cs.SPARSITY),
                     CompressionPlan(block=cs.BLOCK), (E,), 1 << 40)
    del views
    w = dataclasses.replace(w32, data=w32.data.to(torch.bfloat16))
    for m in (80, 8):
        logits = torch.randn(TOKENS[m], D, generator=gen, device=dev) @ \
            torch.randn(D, E, generator=gen, device=dev)
        idx = torch.topk(logits, TOP_K, dim=-1).indices.reshape(-1)
        counts = torch.bincount(idx, minlength=E).clamp(max=m).to(torch.int32)
        for dt in ((torch.bfloat16, torch.float32) if m == 80
                   else (torch.bfloat16,)):
            dy = torch.randn(E, m, FF, generator=gen, device=dev).to(dt)
            x = torch.randn(E, m, D, generator=gen, device=dev).to(dt)
            measure(libs, w, dy, x, counts)
    return 0


def measure(libs, w, dy, x, counts) -> None:
    """One JSON line per row set: each variant's dX and dW ms on (dy, x),
    every row and the routed ``counts``."""
    dsets = cs.copies(lambda: (dy.clone(), w.map(torch.clone)),
                      cs.tensor_bytes(dy, w.data))
    wsets = cs.copies(lambda: (x.clone(), dy.clone(), w),
                      cs.tensor_bytes(x, dy))
    for label, rows in (("full", None), ("routed", counts)):
        row = {"M": dy.shape[1], "dy": str(dy.dtype).split(".")[-1],
               "rows": label}
        if rows is not None:
            row["empty_experts"] = int((rows == 0).sum())
        want_dx = ref.spmm_experts_bwd_ref(dy, w, rows)
        want_dw = sddmm_ops.bsr_weight_grad_experts_ref(x, dy, w, rows)
        for name, (lib, _) in libs.items():
            ops.experts_bwd_lib = lambda lib=lib: lib
            what = f"{name} M={dy.shape[1]} {dy.dtype} {label}"
            cs._check(f"dx {what}", ops.spmm_t_experts(dy, w, rows), want_dx,
                      cs.KERNEL_ATOL, cs.KERNEL_RTOL)
            cs._check(f"dw {what}", sddmm_ops.bsr_weight_grad_experts(
                x, dy, w, rows), want_dw, cs.SDDMM_ATOL, cs.SDDMM_RTOL)
            row[f"dx_ms_{name}"] = cs.time_ms(
                lambda d, ww: ops.spmm_t_experts(d, ww, rows), dsets,
                cs.MOE_TIMED_CALLS)
            row[f"dw_ms_{name}"] = cs.time_ms(
                lambda xs, d, ww: sddmm_ops.bsr_weight_grad_experts(
                    xs, d, ww, rows), wsets, cs.MOE_TIMED_CALLS)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
