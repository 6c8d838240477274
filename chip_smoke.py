#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, in order; any failure ends the run with a non-zero exit:
  1. device: the card's name and power limit, torch and CUDA versions;
     TF32 off for matmuls and convolutions;
  2. build: nvcc builds every CUDA source of ``src/repro_torch/csrc``, one
     process per source, all at once; each kernel's registers and spills
     are printed from ptxas's report, with the kernels that spill;
  3. kernels: both forward spmm kernels (the decode kernel, which the
     wrappers pick up to 16 rows of x, and the tensor-core tile kernel
     above) at smollm-360m's projection shapes against their plain PyTorch
     version on the card, timed beside the plain version, a library
     yardstick (``torch.matmul`` on the densified weight, which the port
     never calls) and the least time the card could take (at the rate of
     the operands' types and at the bf16 tensor-core rate);
  4. decode kernel: the decode kernel at the seven smollm-360m projections
     and M = 1, 4, 8, 16 (bf16 x; the f32 store, palette-8, palette-4),
     each call held to its plain version and timed beside its bytes bound
     and the floor of one launch (an empty kernel timed the same way);
  5. model: the port's serving CLI drives full-width smollm-360m (32
     layers, random weights from seed 0, pruned at 0.9 on (8, 128) blocks)
     from BlockCSR, palette-8 and palette-4 weights, with every kernel's
     launch counter read around each run; then prefill logits (bf16, each
     kernel call also held to its plain version on its inputs) and greedy
     generate tokens (f32) of the kernel path are held against the plain
     path (``sparse_backend="ref"``) on the same card;
  6. paged kernel: the paged flash-decode kernel at smollm-360m's width
     (5 kv heads of 64, g = 3, page 16) on a decode tick, a prefill tick
     and a 4096-token decode, kv_splits 1 and 4, bf16 and f32 pools,
     against its plain versions (the split partials and the gathered
     softmax), timed beside the plain version, a library yardstick
     (gather plus ``scaled_dot_product_attention``, which the port never
     calls) and the least time the card could take; and a check that a
     kernel-path ``attention.paged_attention`` never allocates the
     gathered context;
  7. engine: the serving CLI's ``--engine`` path serves 16 requests of
     16-200 prompt tokens and 32 new tokens each through full-width
     smollm-360m from BlockCSR, palette-8 and palette-4 weights, with the
     launch counters read around each run (32 paged launches and 7 x 32
     spmm launches per tick); then, in f32, the engine's greedy tokens
     against ``generate``, the 'cuda' against the 'ref' attention backend,
     and a prefix-cache run (shared prefix, copy-on-write boundary page)
     against the same requests without the cache; and where a bf16 engine
     run's time goes over a window of its ticks (torch.profiler);
  8. train kernels: the training kernels at smollm-360m's seven
     projection shapes (M = 512 rows, (8, 128) blocks at 0.9 block
     sparsity, a bf16 block store, f32 and bf16 activations): ``spmm_t``
     (dx) and the SDDMM (dw) against their plain versions, timed beside
     them, a library yardstick (dense ``dY @ W`` and ``dY' X``) and the
     least time the card could take; ``prox_adam`` at every leaf size of
     the debias tree, against its plain version and its bytes bound;
  9. train (the training main path): ``launch/train --sparse`` trains
     full-width smollm-360m in bf16 on the card: SpC steps from a planted
     step-1 checkpoint whose (8, 128) blocks have a spread of norms,
     compression, and debias steps on the compressed params, with the
     launch counters of spmm, spmm_t, SDDMM and prox_adam read around the
     run; then ``launch/serve --sparse --ckpt-dir`` serves the trained
     checkpoint;
 10. train, kernel path vs plain path: in f32, the trained compressed
     params go through debias steps with ``sparse_backend`` 'auto' (the
     spmm, spmm_t and SDDMM kernels) and 'ref' (their plain versions):
     losses, the first step's dx and dw per layer and the final block
     stores agree; a profile of one bf16 debias step gives the device busy
     share and the top kernels;
 11. recurrentgemma-9b at full width and depth (38 layers: 12 x (RG-LRU,
     RG-LRU, local attention) + 2 RG-LRU; d 4096, 16 heads of 256 on one kv
     head, window 2048, vocab 256,000): seed-0 weights pruned at 0.9 on
     (8, 128) blocks, built into BlockCSR on the card part by part
     (``sparse.compress.init_compressed``, as ``launch/serve --sparse``
     builds it), then palette-8; both forward spmm kernels at the engine's
     prefill tick (M = 256, bf16 x) on the first super-block's 19
     projections, against the plain version, the f32 ``torch.matmul`` on
     the densified weight, the bf16 one (for information) and the bound
     (kernel-table row 1c); the bf16 prefill at full depth with each
     kernel call held to its plain version, and its logits to the plain
     path's where bf16 is accurate (within 2% of f32); ``generate`` and the
     engine (the 16-request mix with its longest prompt replaced by 3,072
     tokens, past the window) in bf16 with the launch counters read around
     each run (spmm on every projection, the decode and tile kernels
     counted apart; the paged kernel at hd 256, g 16 in the engine); the
     paged kernel at that shape against its plain versions; in f32 at a
     cut depth (one super-block and the two remainder layers), the kernel
     path against the plain path and the engine against ``generate``;
 12. rwkv6-3b at full width and depth (32 layers, d 2560, 40 WKV heads of
     64, d_ff 8960, vocab 65,536), the same runs and checks, on a mix whose
     prompts RWKV's 64-token WKV chunks take;
 13. flash attention: the kernel against its plain version at
     recurrentgemma-9b's local attention (S 4096, window 2048) and
     smollm-360m's prefill, causal, not causal and windowed, bf16 and
     f32, timed beside the plain version, ``scaled_dot_product_attention``
     (which the port never calls) and its bound; then its entry point
     ``ops.flash_attention`` (no model code calls it: the serving and
     training phases launch it 0 times);
 14. the kernel table (one JSON line: the decode spmm kernels at
     smollm-360m's decode, the tile kernels at recurrentgemma-9b's prefill
     tick (palette-4 at smollm-360m's M = 512), the paged kernel at a
     decode and a prefill tick of the smollm-360m mix and at
     recurrentgemma-9b's prefill tick, flash at recurrentgemma-9b's local
     attention and smollm-360m's prefill, with the spmm and paged bounds
     also at the bf16 tensor-core rate) and the contract line.

It imports nothing of JAX or of the JAX package, and exits with an error
when no CUDA device is visible.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
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

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import masks  # noqa: E402
from repro_torch.core import optimizers  # noqa: E402
from repro_torch.core import prox as prox_lib  # noqa: E402
from repro_torch.data.synthetic import TokenStreamConfig, token_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bsr_sddmm import ops as sddmm_ops  # noqa: E402
from repro_torch.kernels.bsr_spmm import ops, ref  # noqa: E402
from repro_torch.kernels.prox_adam import ops as adam_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as paged_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.step import generate  # noqa: E402
from repro_torch.sparse import ops as sparse_ops  # noqa: E402
from repro_torch.core.metrics import model_size_bytes  # noqa: E402
from repro_torch.sparse.compress import (CompressionPlan,  # noqa: E402
                                         _prune_blocks_2d,
                                         bcsr_equiv_size_bytes,
                                         compressed_size_bytes,
                                         init_compressed, iter_bcsr,
                                         quantize_bcsr, quantize_compressed,
                                         split_trainable)
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import make_loss_fn, make_train_step  # noqa: E402
from repro_torch.sparse.formats import (PaletteBCSR, bcsr_to_dense,  # noqa: E402
                                        dense_to_bcsr)

ARCH = "smollm-360m"
BLOCK = (8, 128)
SPARSITY = 0.9
BATCH, PROMPT, GEN = 4, 16, 32
# H100 SXM peaks (NVIDIA data sheet): HBM rate, f32 FMA outside the tensor
# cores, and the dense bf16 tensor-core rate (f32 accumulation). A product
# of two bf16 operands is held to the bf16 rate, whatever unit the kernel
# uses; one with an f32 operand to the f32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
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
# The f32 agreement checks of the smollm-360m serving and engine phases run
# the first 8 of the 32 layers (the same weights), to keep the whole script
# within its time limit; the bf16 main-path runs keep all 32.
SMOLLM_F32_LAYERS = 8

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
DECODE_M = (1, 4, 8, 16)              # the decode kernel's rows, per projection
TABLE_SHAPE = ("mlp.wi", 4, torch.bfloat16)   # the row of the kernel table

# Paged attention at smollm-360m's width. Kernel vs plain: the same f32
# products summed in another order; atol 1e-4 on valid rows is the JAX
# kernel tests' tolerance (outputs are O(1) averages of V).
PAGED_ATOL = 1e-4
PAGE = 16
# (case, tick width C, absolute start of each of the 8 slots, valid tokens
# per slot, page-table width P). Decode: contexts mixed up to 232 (the
# engine mix's 200 + 32); prefill: chunks of 32 at mixed offsets, one
# partial; long: a 4096-token decode.
PAGED_CASES = [
    ("decode", 1, (231, 17, 100, 64, 0, 199, 150, 31), (1,) * 8, 15),
    ("prefill", 32, (0, 32, 96, 160, 0, 64, 192, 128), (32,) * 7 + (9,), 15),
    ("long", 1, (4095,) * 8, (1,) * 8, 256),
]
# the rows of the kernel table: a decode tick and a prefill tick of the mix
PAGED_TABLE_ROW = ("decode", torch.bfloat16, 1)
PAGED_PREFILL_ROW = ("prefill", torch.bfloat16, 1)
PAGED_REPLACES = "src/repro/kernels/paged_attention/paged_attention.py:108"
# The engine mix: 16 requests, prompts of 16-200 tokens, 32 new tokens.
MAX_BATCH, CHUNK = 8, 32
ENGINE_FLAGS = ["--max-batch", str(MAX_BATCH), "--prefill-chunk", str(CHUNK),
                "--page-size", str(PAGE)]
ENGINE_PROMPTS = [int(n) for n in np.random.default_rng(5).permutation(
    np.linspace(16, 200, 16).astype(int))]
ENGINE_GEN = 32
PREFIX_LEN = 64           # shared by the prefix-cache run's 8 requests
# The engine profile's window: ticks 30-41 of the mix's 94, 7 prefill
# ticks (width 32) and 5 decode ticks (width 1), near the run's 50 to 44.
PROFILE_TICKS = (30, 42)
# Training at smollm-360m's width: M = 512 rows (batch 8 x seq 64).
TRAIN_BATCH, TRAIN_SEQ = 8, 64
TRAIN_M = TRAIN_BATCH * TRAIN_SEQ
TRAIN_MATRICES = [("attn.wq", (960, 960)), ("attn.wk", (320, 960)),
                  ("attn.wv", (320, 960)), ("attn.wo", (960, 960)),
                  ("mlp.wi", (2560, 960)), ("mlp.wg", (2560, 960)),
                  ("mlp.wo", (960, 2560))]
TRAIN_TABLE_SHAPE = ("mlp.wi", torch.bfloat16)   # rows 1b and 4 of the table
# SDDMM kernel vs plain: 512-term f32 sums of unit-normal products (|dw|
# about 20), summed in another order.
SDDMM_ATOL, SDDMM_RTOL = 1e-3, 1e-4
# prox_adam kernel vs plain: the same f32 operations in the same order, each
# rounded to nearest (no FMA contraction in the kernel), so the results are
# expected bit-equal; 1e-6 is the stated bound.
ADAM_ATOL = 1e-6
# the soft threshold lr * lam at which the prox is checked: about |w|
PROX_TAU = 0.5
# The SpC-Retrain run. A random init gives every (8, 128) block of a
# matrix the same norm to within 2% (1,024 i.i.d. entries), so group-l1
# zeroes all of a matrix's blocks or none. The run therefore resumes from a
# planted step-1 checkpoint whose block norms are spread log-uniformly over
# [SPREAD_LO, SPREAD_HI], as trained weights' are; LAM is chosen for 0.8-0.95
# block sparsity after the SpC steps (calibrated at a reduced width on the
# CPU, where the same per-block dynamics hold). At lr 1e-3 the debias
# phase diverged at full width (loss 6.0 -> 12.8 in one step: a fresh Adam
# moves every surviving weight, and all 47M of the tied embedding, by lr);
# at 1e-4 it descends. The telemetry's host-side block-norm probe takes
# about 10 s per logged SpC step at this width, so steps are logged every
# LOG_EVERY and the others give the step time.
SPC_STEPS, DEBIAS_STEPS, TRAIN_LR, LAM = 9, 5, 1e-4, 800.0
LOG_EVERY = 4
SPREAD_LO, SPREAD_HI = 0.01, 1.0
SPARSITY_BAND = (0.8, 0.95)
TRAIN_GEN = 8
# kernel path vs plain path in f32 over COMPARE_STEPS debias steps
COMPARE_STEPS, COMPARE_LR = 3, 1e-4
# f32 gradients through 32 layers of backward, summed in another order:
# dx and dw per layer agree to 1e-3 of their largest |value|
GRAD_RTOL = 1e-3
LOSS_RTOL = 1e-5
# The block stores after COMPARE_STEPS Adam steps: m / sqrt(v) is about +-1
# whatever |g|, so where g is near 0 a gradient difference of 1e-6 can flip
# an element's step (up to lr). The two updates (final - initial) are held
# to 1% of the update's norm instead.
UPDATE_RTOL = 1e-2
# where the engine runs write their request file, metrics and traces
OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"

# Flash attention (its own entry point, ops.flash_attention; no model code
# calls it). (case, B, S, H, KV, hd, causal, window, dtype): recurrentgemma-
# 9b's local attention (the kernel-table row; tiles whose top rows start on
# a fully masked kv tile once the window bites), smollm-360m's prefill in
# bf16 and f32, and both shapes without the causal mask.
FLASH_CASES = [
    ("recurrentgemma local", 1, 4096, 16, 1, 256, True, 2048, torch.bfloat16),
    ("recurrentgemma local", 1, 4096, 16, 1, 256, True, 2048, torch.float32),
    ("recurrentgemma windowed, not causal", 1, 4096, 16, 1, 256, False, 2048,
     torch.bfloat16),
    ("smollm prefill", 4, 2048, 15, 5, 64, True, None, torch.bfloat16),
    ("smollm prefill", 4, 2048, 15, 5, 64, True, None, torch.float32),
    ("smollm, not causal", 4, 2048, 15, 5, 64, False, None, torch.bfloat16),
]
FLASH_TABLE_ROW, FLASH_PREFILL_ROW = 0, 3   # kernel-table rows
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:80"
# Kernel vs plain: f32, the same products summed in another order (the JAX
# kernel tests' tolerance); bf16 outputs are rounded from f32 sums in
# another order, so they sit at most one bf16 step (2**-8 relative) apart.
FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2 ** -7, 2 ** -7)}

# The recurrent families at full width. recurrentgemma-9b: 38 layers (12 x
# (rglru, rglru, attn) + 2 rglru), d 4096, lru 4096, 16 heads of 256 on one
# kv head, window 2048, vocab 256,000; rwkv6-3b: 32 layers, d 2560, 40 WKV
# heads of 64, d_ff 8960, vocab 65,536. Seed-0 weights pruned at 0.9 on
# (8, 128) blocks and built into BlockCSR on the card, part by part.
HYBRID, RWKV = "recurrentgemma-9b", "rwkv6-3b"
# The engine mix of the smollm phase with its longest prompt (200) replaced
# by one longer than the 2,048-token window. 3,072 is a multiple of
# prefill's 1,024-token query chunk, so generate takes it too.
HYBRID_LONG = 3072
HYBRID_PROMPTS = [HYBRID_LONG if n == max(ENGINE_PROMPTS) else n
                  for n in ENGINE_PROMPTS]
# RWKV's chunked WKV takes prompts shorter than its 64-token chunk or a
# multiple of it (as the reference does): the mix rounds down to that.
RWKV_PROMPTS = [n if n < 64 else n // 64 * 64 for n in ENGINE_PROMPTS]
# The f32 agreement checks of the hybrid run at a cut depth: one
# super-block and the two remainder layers (5 of 38 layers).
HYBRID_F32_LAYERS = 5
# kv splits of the hybrid engine's paged kernel: the long request's
# window spans about 130 pages, walked by 4 thread blocks instead of 1
HYBRID_KV_SPLITS = 4
# kernel-table row 1c: the forward spmm at the engine's prefill tick (8
# slots x chunks of 32 = 256 rows of bf16 x) on the projections of the
# hybrid's first super-block
HYBRID_SPMM_M = MAX_BATCH * CHUNK
# the plain version and the library calls of row 1c take 0.3-2 ms a call
# at these widths: 20 timed calls each keep the phase short
HYBRID_YARDSTICK_CALLS = 20
SUM_KEYS = ("ms", "ms_decode", "ms_tile", "plain_ms", "library_ms",
            "bf16_matmul_ms", "bound_ms", "bound_bf16_ms", "bytes", "flops")
# the paged kernel at recurrentgemma-9b's shape: a prefill tick of 8 slots
# at late positions (the long request's window bites) and a decode tick
HYBRID_PAGED_CASES = [
    ("hd256 prefill", 32, (3040, 2976, 32, 96, 0, 64, 2912, 128),
     (32,) * 7 + (9,), 194),
    ("hd256 decode", 1, (3103, 17, 100, 64, 0, 199, 150, 31), (1,) * 8, 194),
]
# engine profile windows of the recurrent runs (a few prefill and decode
# ticks each), and the tokens of their profiled generate
RECURRENT_PROFILE_TICKS = (20, 30)
PROFILE_GEN = 8
# rwkv6-3b's f32 checks run its first 8 of 32 layers (the same weights),
# to keep the whole script within its time limit
RWKV_F32_LAYERS = 8


def log(*a):
    print(*a, flush=True)


T0 = time.perf_counter()


def phase(name):
    log(f"== {name} (at {time.perf_counter() - T0:.1f} s)")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, arg_sets, calls: int = TIMED_CALLS) -> float:
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
    timed = [arg_sets[i % len(arg_sets)] for i in range(calls)]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(3 * host_s * calls * SLEEP_CYCLES_PER_S))
    start.record()
    for args in timed:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


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
            _log_ptxas(name, log_file.read_text())


def _log_ptxas(name: str, report: str) -> None:
    """Registers and spills of each kernel of a source, one line per kernel
    named by its mangled symbol, then the kernels that spill."""
    kernel, spill, spilling = "", "", []
    for line in report.splitlines():
        if "Compiling entry function" in line:
            kernel, spill = line.split("'")[1], ""
        elif "spill stores" in line:
            spill = line.split(",", 1)[1].strip()
        elif "registers" in line:
            log(f"  ptxas {name} {kernel}: "
                f"{line.split(':', 1)[1].strip()}; {spill}")
            if spill and not spill.startswith("0 bytes spill stores"):
                spilling.append(kernel)
    log(f"  ptxas {name}: kernels that spill: {spilling or 'none'}")


def _weight(rng, n, k, dev):
    w = (rng.standard_normal((n, k)) / math.sqrt(k)).astype(np.float32)
    return dense_to_bcsr(_prune_blocks_2d(w, BLOCK, SPARSITY), BLOCK).to(dev)


def _bound(m_rows, w, x_dtype, bits):
    """Least time for one forward call: each input read once (x, the
    resident blocks at the store's element size, their gather entries, the
    palette), the output written once, against the products the resident
    blocks need. (bound ms, what bounds it, bytes, flops, bound ms at the
    bf16 tensor-core rate): the first at the rate of the operands' types
    (f32 when x, the store or the palette is f32), the last as if every
    product ran at the bf16 rate, which the tile kernel's products do."""
    br, bc = w.block
    n_res = int(w.gather_nnz.sum())
    k_in, n_out = w.shape[1], w.shape[0]
    x_b = m_rows * k_in * torch.finfo(x_dtype).bits // 8
    blk_b = n_res * br * bc * (w.data.element_size() if bits is None
                               else bits / 8)
    pal_b = 0 if bits is None else (1 << bits) * 4
    tab_b = n_res * 8 + w.gather_nnz.numel() * 4
    nbytes = x_b + blk_b + pal_b + tab_b + m_rows * n_out * 4
    flops = 2 * m_rows * n_res * br * bc
    store = w.data.dtype if bits is None else torch.float32
    bound = _ops_bound(nbytes, flops, x_dtype, store)
    return bound + (_ops_bound(nbytes, flops, torch.bfloat16)[0],)


def _spmm_case(wq, x, wrapper: str, bits, bf16_matmul: bool = False,
               yardstick_calls: int = TIMED_CALLS) -> dict:
    """Both forward kernels (decode and tile) on (x, wq), each held to the
    plain version at KERNEL_ATOL / KERNEL_RTOL and timed beside it, the
    library call (``torch.matmul`` of x in f32 and the densified f32
    weight: the same function) and the bound; with ``bf16_matmul`` also,
    for information, the bf16 matmul on the bf16-rounded weight (another
    function), each over ``yardstick_calls`` calls. ``ms`` is the kernel
    the wrapper picks for this M (``picked``)."""
    n, k = wq.shape
    m_rows = x.shape[0]
    plain = ref.spmm_fwd_ref if bits is None else ref.spmm_palette_fwd_ref
    want = plain(x, wq)
    store = wq.data if bits is None else wq.codes
    sets = copies(lambda: (x.clone(), wq.map(torch.clone)),
                  tensor_bytes(x, store))
    row = {"matrix_shape": [n, k], "M": m_rows,
           "x": str(x.dtype).split(".")[-1],
           "store": str(store.dtype).split(".")[-1] if bits is None
           else f"palette{bits}",
           "resident_blocks": int(wq.gather_nnz.sum()),
           "atol": KERNEL_ATOL, "rtol": KERNEL_RTOL}
    for kern in ops.KERNELS:
        fn = functools.partial(ops._fwd, kernel=kern)
        got = fn(x, wq)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
            raise SystemExit(f"{wrapper} ({kern}) {[n, k]} M={m_rows} "
                             f"{x.dtype}: kernel disagrees with plain, max "
                             f"err {err}")
        row[f"max_abs_err_{kern}"] = err
        row[f"ms_{kern}"] = time_ms(fn, sets)
    row["picked"] = ops.pick_kernel(m_rows)
    row["ms"] = row[f"ms_{row['picked']}"]
    row["max_abs_err"] = max(row[f"max_abs_err_{k_}"] for k_ in ops.KERNELS)
    row["plain_ms"] = time_ms(plain, sets, yardstick_calls)
    wd = (bcsr_to_dense(wq if bits is None else wq.dequantize())
          [:n, :k].float().T.contiguous())
    row["library_ms"] = time_ms(torch.matmul, copies(
        lambda: (x.float(), wd.clone()), tensor_bytes(x, wd) * 2),
        yardstick_calls)
    if bf16_matmul:
        wb = wd.bfloat16()
        row["bf16_matmul_ms"] = time_ms(torch.matmul, copies(
            lambda: (x.bfloat16(), wb.clone()), tensor_bytes(x, wb) * 2),
            yardstick_calls)
    row.update(zip(("bound_ms", "bound_by", "bytes", "flops",
                    "bound_bf16_ms"), _bound(m_rows, wq, x.dtype, bits)))
    return row


def kernel_phase(dev) -> dict:
    phase("kernels")
    rng = np.random.default_rng(0)
    rows = {}
    for mat_name, (n, k) in MATRICES:
        w = _weight(rng, n, k, dev)
        packed = {None: w, 8: quantize_bcsr(w, 8), 4: quantize_bcsr(w, 4)}
        for m_rows in M_VALUES:
            for name, wrapper, bits, x_dtype in VARIANTS:
                x = torch.randn(m_rows, k, device=dev).to(x_dtype)
                row = {"kernel": name, "matrix": mat_name,
                       **_spmm_case(packed[bits], x, wrapper, bits)}
                log(json.dumps(row))
                rows[(name, mat_name, m_rows, x_dtype)] = row
    return rows


def launch_floor_ms() -> float:
    """The floor of one launch: an empty kernel (``torch.cuda._sleep(0)``)
    timed by ``time_ms`` as the kernels are."""
    return time_ms(lambda: torch.cuda._sleep(0), [()] * 4)


def decode_phase(dev) -> None:
    """The decode kernel (kernel-table rows 1 and 2) at the seven
    smollm-360m projections and M = 1, 4, 8, 16 (bf16 x, as the serving
    path gives it; the f32 store, palette-8 and palette-4), each call held
    to the plain version at KERNEL_ATOL / KERNEL_RTOL and timed beside the
    bound (bytes over HBM_BYTES_PER_S) and the floor of one launch."""
    phase("decode kernel at the seven projections")
    rng = np.random.default_rng(2)
    floor = launch_floor_ms()
    log(f"launch floor (an empty kernel, timed the same way): {floor:.6f} ms")
    for mat_name, (n, k) in TRAIN_MATRICES:
        w = _weight(rng, n, k, dev)
        for name, bits, wq in (("bsr_spmm", None, w),
                               ("bsr_spmm_palette8", 8, quantize_bcsr(w, 8)),
                               ("bsr_spmm_palette4", 4, quantize_bcsr(w, 4))):
            plain = ref.spmm_fwd_ref if bits is None else ref.spmm_palette_fwd_ref
            store = wq.data if bits is None else wq.codes
            for m_rows in DECODE_M:
                x = torch.randn(m_rows, k, device=dev).to(torch.bfloat16)
                fn = functools.partial(ops._fwd, kernel="decode")
                err = _check(f"{name} decode {mat_name} M={m_rows}", fn(x, wq),
                             plain(x, wq), KERNEL_ATOL, KERNEL_RTOL)
                sets = copies(lambda: (x.clone(), wq.map(torch.clone)),
                              tensor_bytes(x, store))
                row = {"kernel": name, "matrix": mat_name, "shape": [n, k],
                       "M": m_rows, "store": "float32" if bits is None
                       else f"palette{bits}", "max_abs_err": err,
                       "ms": time_ms(fn, sets), "launch_floor_ms": floor}
                row.update(zip(("bound_ms", "bound_by", "bytes", "flops"),
                               _bound(m_rows, wq, x.dtype, bits)[:4]))
                log(json.dumps(row))


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
    counts = {**ops.launches, **ops.variant_launches}
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


def _device_rows(prof) -> tuple:
    """(device kernel seconds, [(device ms, calls, kernel name)] largest
    first) of a finished ``torch.profiler`` run."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]   # step annotations
    attr = ("self_device_time_total" if rows and hasattr(rows[0], "self_device_time_total")
            else "self_cuda_time_total")
    rows = sorted(((getattr(e, attr) / 1e3, e.count, e.key) for e in rows),
                  reverse=True)
    return sum(r[0] for r in rows) / 1e3, rows


# the spmm kernels of csrc/bsr_spmm.cu by the names the profiler shows
SPMM_KERNELS = (("decode spmm", "decode_fwd"), ("tile spmm", "bsr_tile_fwd"),
                ("spmm_t", "bsr_tile_bwd"))


def _log_profile(what: str, wall: float, dev_s: float, rows, top: int,
                 n_tokens: int = 0) -> None:
    rate = f" ({n_tokens / wall:.1f} tok/s)" if n_tokens else ""
    log(f"bf16 {what}: wall {wall:.3f} s{rate}, device kernel time "
        f"{dev_s:.4f} s, device busy share {dev_s / wall:.3f}")
    for ms, calls, key in rows[:top]:
        log(f"  {ms:9.3f} ms {calls:6d} calls  {key[:70]}")
    sums = []
    for label, name in SPMM_KERNELS:
        hits = [(ms, calls) for ms, calls, key in rows if name in key]
        sums.append(f"{label} {sum(h[0] for h in hits):.3f} ms over "
                    f"{sum(h[1] for h in hits)} calls")
    log(f"  spmm kernels: {', '.join(sums)}")


def _profile(what: str, n_tokens: int, run, top: int) -> None:
    """Where ``run()``'s time goes: the device time of every kernel
    (torch.profiler) against the wall time of the same call unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev_s, rows = _device_rows(prof)
    _log_profile(what, wall, dev_s, rows, top, n_tokens)


@contextlib.contextmanager
def _held_calls(what: str):
    """Within the block, every kernel call of ``sparse_matmul``'s forward is
    also run through its plain version on the same inputs and held to it
    at KERNEL_ATOL / KERNEL_RTOL (the kernels phase's tolerance), both in
    f32; yields the list of each call's max |kernel - plain|."""
    forward = sparse_ops._forward
    errs = []

    def held(x, w, backend):
        y = forward(x, w, backend)
        if backend == "cuda":
            plain = (ref.spmm_palette_fwd_ref if isinstance(w, PaletteBCSR)
                     else ref.spmm_fwd_ref)
            want = plain(x, w)
            errs.append(float((y - want).abs().max()))
            if not torch.allclose(y, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
                raise SystemExit(f"{what}: kernel call {len(errs)} (x "
                                 f"{tuple(x.shape)} {x.dtype}, W {w.shape}) "
                                 f"disagrees with plain, max err {errs[-1]}")
        return y

    sparse_ops._forward = held
    try:
        yield errs
    finally:
        sparse_ops._forward = forward


def _prefill_logits(model, params, prompt) -> torch.Tensor:
    with torch.inference_mode():
        return model.prefill(params, prompt,
                             model.init_cache(*prompt.shape))[0].float()


def _bf16_logits_check(what, kernel_model, plain_model, params, prompt,
                       plain_f32=None) -> None:
    """The bf16 prefill of the kernel path, each kernel call held to its
    plain version on the same inputs (``_held_calls``); then its logits,
    within BF16_LOGITS_RTOL of the largest logit of the plain path
    (``sparse_backend="ref"``). With ``plain_f32`` (the recurrent
    families) the logits are held so only where bf16 itself is that
    accurate: where the bf16 plain path lies within BF16_LOGITS_RTOL of
    the f32 plain path. Past that, rounding in the bf16 model (rwkv6-3b's
    data-dependent decays at 32 layers) moves two correct bf16 paths apart
    as far as each lies from f32, the log shows it, and the kernel is held
    call by call alone."""
    b = prompt.shape[0]
    with _held_calls(what) as errs:
        lk = _prefill_logits(kernel_model, params, prompt)
    if not errs:
        raise SystemExit(f"{what}: the bf16 prefill launched no kernel")
    lr = _prefill_logits(plain_model, params, prompt)
    if not (torch.isfinite(lk).all()
            and lk.shape == (b, kernel_model.cfg.vocab)):
        raise SystemExit(f"{what}: prefill logits not finite or misshapen")
    err = float((lk - lr).abs().max())
    bound = BF16_LOGITS_RTOL * float(lr.abs().max())
    log(f"{what}: {len(errs)} kernel calls of the bf16 prefill held to their "
        f"plain versions, max |diff| {max(errs):.3e}; bf16 prefill logits "
        f"max |kernel - plain| = {err:.3e} (bound {bound:.3e}; max |logit| "
        f"{float(lr.abs().max()):.3e})")
    if plain_f32 is not None:
        l32 = _prefill_logits(plain_f32, params, prompt)
        plain_err = float((lr - l32).abs().max())
        kernel_err = float((lk - l32).abs().max())
        accurate = plain_err <= BF16_LOGITS_RTOL * float(l32.abs().max())
        log(f"{what}: max |logit - f32 plain logit|: bf16 plain "
            f"{plain_err:.3e}, bf16 kernel {kernel_err:.3e} (max |f32 logit| "
            f"{float(l32.abs().max()):.3e}); " + (
                "bf16 is accurate here: the logits are held" if accurate else
                "bf16 rounding dominates the logits here: the kernel is held "
                "call by call only"))
        if not accurate:
            return
    if err > bound:
        raise SystemExit(f"{what}: bf16 prefill logits disagree")


def model_phase(dev) -> dict:
    phase("model: serving CLI (the main path)")
    main_counts = {}
    for fmt, extra, wrapper in (("bcsr", [], "spmm"),
                                ("pal8", ["--quantize-bits", "8"], "spmm_palette"),
                                ("pal4", ["--quantize-bits", "4"], "spmm_palette")):
        counts = _serve_run(extra)
        other = "spmm" if wrapper == "spmm_palette" else "spmm_palette"
        split = {k: counts[f"{wrapper}_{k}"] for k in ops.KERNELS}
        # prefill (M = 64) runs the tile kernel, decode (M = 4) the other
        if counts[wrapper] != EXPECTED_LAUNCHES or counts[other] or \
                sum(split.values()) != EXPECTED_LAUNCHES or \
                not all(split.values()):
            raise SystemExit(f"{fmt}: launches {counts}, expected "
                             f"{EXPECTED_LAUNCHES} of {wrapper} only, through "
                             "both of its kernels")
        main_counts[fmt] = split

    phase("model: kernel path vs plain path")
    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    kernel_bf16 = build(cfg, device=dev)
    cp = init_compressed(kernel_bf16, CompressionPlan(block=BLOCK), SPARSITY,
                         gen)
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
    _profile(f"generate {GEN} tokens x {BATCH}", BATCH * GEN,
             lambda: generate(kernel_bf16, cp, prompt, GEN), top=6)
    plain_bf16 = build(cfg, device=dev, sparse_backend="ref")
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              n_layers=SMOLLM_F32_LAYERS)
    kernel_f32 = build(f32, device=dev)
    plain_f32 = build(f32, device=dev, sparse_backend="ref")
    log(f"the f32 generate checks run the first {SMOLLM_F32_LAYERS} of "
        f"{cfg.n_layers} layers; the bf16 checks run all")

    wrappers = {"bcsr": "spmm", "pal8": "spmm_palette", "pal4": "spmm_palette"}
    for fmt, params in formats.items():
        _bf16_logits_check(fmt, kernel_bf16, plain_bf16, params, prompt)
        params = _cut_depth(params, f32.n_super_blocks)
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k = generate(kernel_f32, params, prompt, GEN)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        if counts[wrappers[fmt]] != 7 * f32.n_layers * GEN:
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
    return main_counts, formats


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def _paged_inputs(dev, case, dtype, cfg=None):
    _, c, starts, n_tok, p_log = case
    cfg = cfg or get_config(ARCH)
    kv, hd, h = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    b = len(starts)
    gen = torch.Generator(device=dev).manual_seed(3)
    n_pages = 1 + b * p_log
    q = torch.randn(b, c, h, hd, device=dev, generator=gen)
    kp = torch.randn(n_pages, PAGE, kv, hd, device=dev, generator=gen).to(dtype)
    vp = torch.randn(n_pages, PAGE, kv, hd, device=dev, generator=gen).to(dtype)
    table = (1 + torch.randperm(b * p_log, generator=gen, device=dev)
             ).reshape(b, p_log).to(torch.int32)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    positions = (start[:, None] + torch.arange(c, device=dev)).to(torch.int32)
    valid = (torch.arange(c, device=dev)[None]
             < torch.tensor(n_tok, device=dev)[:, None])
    return q, kp, vp, table, positions, valid


def _grouped(q, kv):
    b, c, h, hd = q.shape
    return q.reshape(b, c, kv, h // kv, hd).permute(0, 2, 1, 3, 4).contiguous()


def _paged_bound(case, kv, g, hd, elt, splits, window=None):
    """Least time for one kernel call: the K and V bytes of the pages that
    run (all kv heads of each running (slot, page)), q, the partials and
    the index tables, each moved once, against the products (scores and
    probability times V) of those pages at the f32 rate (q is f32). For
    bf16 pools also the bound at the bf16 tensor-core rate, which the
    kernel's products run at (None for other pools)."""
    _, c, starts, _, p_log = case
    b = len(starts)
    runs = sum(page * PAGE <= s0 + c - 1
               and (window is None or page * PAGE + PAGE - 1 >= s0 - window + 1)
               for s0 in starts for page in range(p_log))
    nbytes = (runs * PAGE * kv * hd * elt * 2 + b * kv * c * g * hd * 4
              + b * kv * splits * c * g * (hd + 2) * 4
              + b * p_log * 4 + b * c * 4)
    flops = runs * kv * 4 * c * g * PAGE * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    bf16_ms = (max(t_bytes, flops / BF16_FLOPS_PER_S) * 1e3 if elt == 2
               else None)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else
            "operations", int(nbytes), int(flops), int(runs), bf16_ms)


def _gather_sdpa(q, kp, vp, table, positions, window=None):
    """Library yardstick: gather the page table into the dense context,
    repeat it over the GQA groups, then ``scaled_dot_product_attention``
    with the causal-by-absolute-position mask (and the window). The port
    never calls it."""
    b, c, h, hd = q.shape
    p_log, kv = table.shape[1], kp.shape[2]
    ctx = p_log * PAGE

    def dense(pool):
        x = pool[table.long()].reshape(b, ctx, kv, hd).transpose(1, 2)
        return x.repeat_interleave(h // kv, dim=1)

    k_pos = torch.arange(ctx, device=q.device)
    mask = k_pos[None, None, :] <= positions[:, :, None]
    if window is not None:
        mask &= positions[:, :, None] - k_pos[None, None, :] < window
    mask = mask[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2).to(kp.dtype), dense(kp), dense(vp), attn_mask=mask)


def paged_kernel_phase(dev) -> dict:
    phase("paged kernel")
    cfg = get_config(ARCH)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kv
    rows = {}
    for case in PAGED_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, table, positions, valid = _paged_inputs(dev, case, dtype)
            qg = _grouped(q, kv)
            plain_out = paged_ref.paged_attention_ref(q, kp, vp, table,
                                                      positions)
            for splits in (1, 4):
                got = paged_ops.paged_flash_fwd(qg, kp, vp, table, positions,
                                                kv_splits=splits)
                want = paged_ref.paged_flash_fwd_ref(
                    qg, kp, vp, table, positions, positions[:, 0],
                    kv_splits=splits)
                out = paged_ops.paged_flash_attention(
                    q, kp, vp, table, positions, kv_splits=splits)
                torch.cuda.synchronize()
                rows_ok = valid[:, None, None, :, None]
                part_err = 0.0
                for x, y in zip(got, want):
                    mask = (rows_ok[..., None] if x.dim() == 6
                            else rows_ok).expand_as(x)
                    if not torch.allclose(x[mask], y[mask], atol=PAGED_ATOL,
                                          rtol=PAGED_ATOL):
                        raise SystemExit(f"paged {case[0]} {dtype} S={splits}:"
                                         " kernel partials disagree with plain")
                    part_err = max(part_err, float(
                        ((x[mask] - y[mask]).abs()
                         / (1 + y[mask].abs())).max()))
                err = float((out[valid] - plain_out[valid]).abs().max())
                if not (torch.isfinite(out).all() and err <= PAGED_ATOL):
                    raise SystemExit(f"paged {case[0]} {dtype} S={splits}: "
                                     f"kernel disagrees with plain, {err}")
                lib = _gather_sdpa(q, kp, vp, table, positions)
                lib_err = float((lib.transpose(1, 2).float()[valid]
                                 - plain_out[valid]).abs().max())
                call_b = tensor_bytes(qg, kp, vp)
                sets = copies(lambda: (qg.clone(), kp.clone(), vp.clone(),
                                       table, positions), call_b)
                kern = functools.partial(paged_ops.paged_flash_fwd,
                                         kv_splits=splits)
                ms = time_ms(kern, sets)
                wrapper_ms = time_ms(functools.partial(
                    paged_ops.paged_flash_attention, kv_splits=splits),
                    [(q, kp_, vp_, tb, ps_) for _, kp_, vp_, tb, ps_ in sets])
                plain_ms = time_ms(lambda *a: paged_ref.paged_flash_fwd_ref(
                    *a, a[-1][:, 0], kv_splits=splits), sets[:3], calls=3)
                library_ms = time_ms(_gather_sdpa, [
                    (q, kp_, vp_, tb, ps_) for _, kp_, vp_, tb, ps_ in sets],
                    calls=20)
                bound_ms, bound_by, nbytes, flops, runs, bf16_ms = \
                    _paged_bound(case, kv, g, hd, kp.element_size(), splits)
                row = {"kernel": "paged_flash_attention", "case": case[0],
                       "B": len(case[2]), "C": case[1], "P": case[4],
                       "g": g, "hd": hd,
                       "pages_run": runs, "pool": str(dtype).split(".")[-1],
                       "kv_splits": splits, "max_abs_err": err,
                       "partials_max_rel_err": part_err, "atol": PAGED_ATOL,
                       "ms": ms, "wrapper_ms": wrapper_ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "library": "gather + repeat_interleave + "
                                  "scaled_dot_product_attention",
                       "library_max_abs_err": lib_err,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_bf16_ms": bf16_ms, "bytes": nbytes,
                       "flops": flops}
                log(json.dumps(row))
                rows[(case[0], dtype, splits)] = row

    # the kernel path never forms the gathered (B, P*ps, KV, hd) context
    _, c, starts, n_tok, p_log = PAGED_CASES[2]
    b = len(starts)
    pools = attention.init_paged_kv(cfg, 1 + b * p_log, PAGE, torch.bfloat16,
                                    dev)
    p = attention.init_attention(cfg, device=dev)
    table = (1 + torch.arange(b * p_log, device=dev)
             ).reshape(b, p_log).to(torch.int32)
    positions = torch.tensor(starts, dtype=torch.int32, device=dev)[:, None]
    x = torch.randn(b, 1, cfg.d_model, device=dev).to(torch.bfloat16)
    n_tokens = torch.tensor(n_tok, dtype=torch.int32, device=dev)
    gathered = b * p_log * PAGE * kv * hd * 2
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        attention.paged_attention(p, x, pools, table, positions, n_tokens, cfg,
                                  backend="cuda", kv_splits=4)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
    log(f"kernel-path paged_attention at B={b}, P={p_log}: peak rise {rise} "
        f"bytes vs {gathered} bytes of gathered context")
    if rise >= gathered:
        raise SystemExit("the kernel path allocated a gathered context")
    return rows


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _engine_requests(vocab: int) -> list:
    rng = np.random.default_rng(7)
    return [api.Request(prompt=rng.integers(0, vocab, n),
                        max_new_tokens=ENGINE_GEN) for n in ENGINE_PROMPTS]


def _prefix_requests(vocab: int) -> list:
    """8 requests sharing a 64-token prefix, then half a page more of
    common tokens (so that a warm request's match ends mid-page and the
    boundary page is copied on write), then a private tail."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, vocab, PREFIX_LEN + PAGE // 2)
    return [api.Request(prompt=np.concatenate(
                [shared, rng.integers(0, vocab, 8 + i)]),
            max_new_tokens=ENGINE_GEN) for i in range(8)]


def _engine_cli_run(tag: str, extra: list, req_file: Path) -> tuple:
    """One run of ``launch/serve --engine`` on the card; the launch counters
    are set to 0 just before it and read just after."""
    argv = ["--arch", ARCH, "--sparse", "--engine", "--requests",
            str(req_file), *ENGINE_FLAGS, "--block", *map(str, BLOCK),
            "--sparsity", str(SPARSITY), "--metrics-out",
            str(OUT_DIR / f"engine_{tag}.prom"), "--trace-out",
            str(OUT_DIR / f"engine_{tag}.trace.json"), *extra]
    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    paged_ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = serve.main(argv)
    torch.cuda.synchronize()
    counts = {**ops.launches, **paged_ops.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"serve {' '.join(argv)}")
    for line in buf.getvalue().splitlines()[-6:]:
        log(f"  {line}")
    s = out["stats"]
    log(f"  launches {counts}, peak memory {peak / 2**30:.2f} GiB, run "
        f"{time.perf_counter() - t0:.1f} s")
    if s["n_requests"] != len(ENGINE_PROMPTS) or \
            s["n_generated"] != len(ENGINE_PROMPTS) * ENGINE_GEN:
        raise SystemExit(f"engine {tag}: served {s['n_requests']} requests, "
                         f"{s['n_generated']} tokens")
    return counts, s, peak


def _cut_depth(params, n_super: int):
    """The same weights with only the first ``n_super`` super-blocks of the
    stacked layers (the remainder layers kept): the params of the config
    with ``n_layers`` cut to match."""
    def cut(node):
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            return node[:n_super]
        return node.map(lambda t: t[:n_super])          # BlockCSR / palette

    return dataclasses.replace(
        params, dense={**params.dense, "layers": cut(params.dense["layers"])},
        sparse={**params.sparse, "layers": cut(params.sparse["layers"])})


def _logits_after(model, params, prompt, tokens) -> torch.Tensor:
    """The logits that pick the token after ``prompt`` and ``tokens``: one
    prefill of the prompt, then a decode step per token, as ``generate``
    runs them (so any prompt that ``generate`` takes will do)."""
    p = torch.as_tensor(list(prompt), device=model.device)[None]
    with torch.inference_mode():
        cache = model.init_cache(1, p.shape[1] + len(tokens) + 1)
        logits, cache = model.prefill(params, p, cache)
        for i, t in enumerate(tokens):
            tok = torch.tensor([[t]], device=model.device)
            logits, cache = model.decode_step(params, tok, cache,
                                              p.shape[1] + i)
            logits = logits[:, 0]
    return logits[0]


def _divergence_ok(model, params, prompt, ref_tokens, got_tokens,
                   what: str) -> int:
    """Tokens matched before the first difference; raises unless the
    reference's top-2 logit margin at that step is a near tie."""
    ref_tokens = [int(t) for t in ref_tokens]
    got_tokens = [int(t) for t in got_tokens]
    if ref_tokens == got_tokens:
        return len(ref_tokens)
    t = next(i for i, (a, b) in enumerate(zip(ref_tokens, got_tokens))
             if a != b)
    margin = _top2_margin(_logits_after(model, params,
                                        [int(x) for x in prompt],
                                        ref_tokens[:t]))
    log(f"{what}: first differs at step {t}, top-2 margin {margin:.3e}")
    if margin >= F32_LOGITS_ATOL:
        raise SystemExit(f"{what}: greedy tokens differ away from a near-tie")
    return t


def _engine(model, params, requests, **kw) -> ServeEngine:
    max_seq = max(len(r.prompt) + r.max_new_tokens for r in requests)
    return ServeEngine(model, params, EngineConfig(
        max_batch=MAX_BATCH, prefill_chunk=CHUNK, page_size=PAGE,
        max_seq_len=max_seq,
        **kw))


def _profile_engine_window(make_engine, requests, ticks=PROFILE_TICKS) -> None:
    """Where a bf16 engine run's time goes, over the ticks
    ``PROFILE_TICKS``: the device time of every kernel (torch.profiler)
    against the host-clock time of the same ticks in an unprofiled run of
    the same requests (each tick ends in its device sync). A window keeps
    the profiler's own parse of the trace short."""
    from torch.profiler import ProfilerActivity, profile, schedule
    first, last = ticks

    def drive(engine, after_tick):
        for r in requests:
            engine.submit(r)
        tick = 0
        while engine.scheduler.has_work() and tick < last:
            engine.step()
            after_tick(tick)
            tick += 1

    ends = {}
    drive(make_engine(), lambda i: ends.__setitem__(i, time.perf_counter()))
    wall = ends[last - 1] - ends[first - 1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=first - 1, warmup=1,
                                   active=last - first, repeat=1)) as prof:
        drive(make_engine(), lambda i: prof.step())
    dev_s, rows = _device_rows(prof)
    _log_profile(f"engine, {len(requests)} requests, ticks {first}-{last - 1}",
                 wall, dev_s, rows, top=8)


def engine_phase(dev, formats) -> dict:
    phase("engine: serving CLI --engine (the main path)")
    cfg = get_config(ARCH)
    requests = _engine_requests(cfg.vocab)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    req_file = OUT_DIR / "engine_requests.json"
    req_file.write_text(json.dumps(
        [{"prompt": list(r.prompt), "gen": r.max_new_tokens}
         for r in requests]))
    main_counts = {}
    for fmt, extra, wrapper in (("bcsr", [], "spmm"),
                                ("pal8", ["--quantize-bits", "8"], "spmm_palette"),
                                ("pal4", ["--quantize-bits", "4"], "spmm_palette")):
        counts, s, peak = _engine_cli_run(fmt, extra, req_file)
        ticks, layers = s["n_ticks"], cfg.n_layers
        other = "spmm" if wrapper == "spmm_palette" else "spmm_palette"
        if counts["paged_flash_fwd"] != layers * ticks or \
                counts[wrapper] != 7 * layers * ticks or counts[other]:
            raise SystemExit(f"engine {fmt}: launches {counts} over {ticks} "
                             f"ticks, expected {layers * ticks} paged and "
                             f"{7 * layers * ticks} {wrapper} only")
        log(f"engine {fmt} bf16: {s['tok_s']:.1f} tok/s, ttft p50/p95 "
            f"{s['ttft_p50_s'] * 1e3:.1f}/{s['ttft_p95_s'] * 1e3:.1f} ms, "
            f"{ticks} ticks, {s['n_prefill_chunks']} prefill chunks, kv "
            f"pool {s['kv_page_bytes']} bytes, peak memory "
            f"{peak / 2**30:.2f} GiB")
        main_counts[fmt] = counts["paged_flash_fwd"]

    phase("engine: bf16 profile")
    model = build(cfg, device=dev)
    _profile_engine_window(lambda: _engine(model, formats["bcsr"], requests),
                           requests)

    phase("engine: f32 tokens against generate, backends, prefix cache")
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              n_layers=SMOLLM_F32_LAYERS)
    kernel_f32 = build(f32, device=dev)
    log(f"the f32 engine checks run the first {SMOLLM_F32_LAYERS} of "
        f"{cfg.n_layers} layers")
    formats = {fmt: _cut_depth(params, f32.n_super_blocks)
               for fmt, params in formats.items()}
    for fmt, params in formats.items():
        engine = _engine(kernel_f32, params, requests, attn_backend="cuda")
        ops.reset_launches()
        paged_ops.reset_launches()
        out = engine.run(requests)
        ticks = out["stats"]["n_ticks"]
        if paged_ops.launches["paged_flash_fwd"] != f32.n_layers * ticks:
            raise SystemExit(f"{fmt}: f32 engine paged launches "
                             f"{paged_ops.launches} over {ticks} ticks")
        matched = 0
        for rid, r in enumerate(requests):
            ref_toks = generate(kernel_f32, params, torch.tensor(
                r.prompt_ids, device=dev)[None], ENGINE_GEN)[0]
            matched += _divergence_ok(kernel_f32, params, r.prompt, ref_toks,
                                      out["results"][rid],
                                      f"{fmt} engine vs generate rid {rid}")
        log(f"{fmt}: f32 engine {matched}/{len(requests) * ENGINE_GEN} tokens "
            f"match generate on the kernel path ({ticks} ticks, "
            f"{out['stats']['tok_s']:.1f} tok/s)")
        if fmt == "bcsr":
            cuda_out = out

    params = formats["bcsr"]
    out = _engine(kernel_f32, params, requests, attn_backend="ref").run(requests)
    matched = sum(_divergence_ok(kernel_f32, params, r.prompt,
                                 cuda_out["results"][rid], out["results"][rid],
                                 f"bcsr engine cuda vs ref rid {rid}")
                  for rid, r in enumerate(requests))
    log(f"bcsr: f32 engine, attn backend ref vs cuda: {matched}/"
        f"{len(requests) * ENGINE_GEN} tokens match")

    prefix_reqs = _prefix_requests(cfg.vocab)
    runs = {}
    for cached in (False, True):
        engine = _engine(kernel_f32, params, prefix_reqs, attn_backend="cuda",
                         prefix_cache=cached)
        results = {}
        for wave in (prefix_reqs[:1], prefix_reqs[1:]):
            results.update(engine.run(wave)["results"])
        runs[cached] = (engine, results)
    engine, with_cache = runs[True]
    cow = int(engine.scheduler._m_cow.value())
    hit = engine.prefix_cache.tokens_hit
    if cow < 1 or hit < 7 * (PREFIX_LEN + PAGE // 2):
        raise SystemExit(f"prefix cache: {cow} copy-on-write pages, {hit} "
                         "tokens hit")
    matched = sum(_divergence_ok(kernel_f32, params, r.prompt,
                                 runs[False][1][rid], with_cache[rid],
                                 f"prefix cache rid {rid}")
                  for rid, r in enumerate(prefix_reqs))
    log(f"bcsr: f32 engine with prefix cache ({hit} prompt tokens hit, {cow} "
        f"copy-on-write pages): {matched}/{len(prefix_reqs) * ENGINE_GEN} "
        "tokens match the run without it")
    return main_counts


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _ops_bound(nbytes, flops, *dtypes):
    """(bound ms, what bounds it, bytes, flops): ``flops`` at the bf16
    rate when every operand dtype is bf16, else at the f32 rate."""
    rate = (BF16_FLOPS_PER_S if dtypes and all(d == torch.bfloat16
                                               for d in dtypes)
            else F32_FLOPS_PER_S)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else
            "operations", int(nbytes), int(flops))


def _used_width(occupied, block: int, width: int) -> int:
    """Columns of a (., width) operand in the block-rows (or -cols) that
    ``occupied`` marks: the only ones the product needs."""
    idx = torch.nonzero(occupied.cpu()).flatten().tolist()
    return sum(min(block, width - i * block) for i in idx)


def _spmm_t_bound(w, dy):
    """The dY columns of block-rows that hold a resident block read once,
    the resident blocks and their transposed gather entries once, dX
    written once; 2 flops per resident block entry and row."""
    br, bc = w.block
    n_res = int(w.gather_t_nnz.sum())
    dy_cols = _used_width(w.gather_nnz > 0, br, w.shape[0])
    nbytes = (dy.shape[0] * dy_cols * dy.element_size()
              + n_res * br * bc * w.data.element_size()
              + n_res * 8 + w.gather_t_nnz.numel() * 4
              + dy.shape[0] * w.shape[1] * 4)
    return _ops_bound(nbytes, 2 * dy.shape[0] * n_res * br * bc,
                      dy.dtype, w.data.dtype)


def _sddmm_bound(w, x, dy):
    """The columns of x and dY that some valid slot needs read once, the
    slot coordinates once, the (n_slots, br, bc) f32 output written once;
    2 flops per output entry and row, at the valid slots of this weight."""
    br, bc = w.block
    r_grid, c_grid = w.block_grid
    rows, cols, valid = sddmm_ops.slot_coordinates(w)
    n_valid = int(valid.sum())
    used = lambda idx, n: torch.zeros(n, dtype=torch.bool).index_fill_(  # noqa: E731
        0, idx[valid].long().cpu(), True)
    x_cols = _used_width(used(cols, c_grid), bc, w.shape[1])
    dy_cols = _used_width(used(rows, r_grid), br, w.shape[0])
    n_slots = w.data.shape[0]
    nbytes = (x.shape[0] * (x_cols * x.element_size()
                            + dy_cols * dy.element_size())
              + 3 * n_slots * 4 + n_slots * br * bc * 4)
    return _ops_bound(nbytes, 2 * x.shape[0] * n_valid * br * bc,
                      x.dtype, dy.dtype)


def _check(name, got, want, atol, rtol):
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise SystemExit(f"{name}: kernel disagrees with plain, max err {err}")
    return err


def train_kernel_phase(dev) -> dict:
    phase("train kernels")
    rng = np.random.default_rng(1)
    rows = {}
    leaf_sizes = {}
    for mat_name, (n, k) in TRAIN_MATRICES:
        w32 = _weight(rng, n, k, dev)
        w = dataclasses.replace(w32, data=w32.data.to(torch.bfloat16))
        leaf_sizes[f"bcsr_data {mat_name}"] = 32 * w.data.numel()
        for dt in (torch.float32, torch.bfloat16):
            dy = torch.randn(TRAIN_M, n, device=dev).to(dt)
            x = torch.randn(TRAIN_M, k, device=dev).to(dt)
            wd = bcsr_to_dense(w)[:n, :k].to(dt).contiguous()
            lib = str(dt).split(".")[-1]
            # spmm_t: dX = dY @ W
            err = _check(f"spmm_t {mat_name} {dt}", ops.spmm_t(dy, w),
                         ref.spmm_bwd_ref(dy, w), KERNEL_ATOL, KERNEL_RTOL)
            sets = copies(lambda: (dy.clone(), w.map(torch.clone)),
                          tensor_bytes(dy, w.data))
            row = {"kernel": "bsr_spmm_t", "matrix": mat_name, "shape": [n, k],
                   "M": TRAIN_M, "dy": str(dt).split(".")[-1],
                   "store": "bfloat16",
                   "resident_blocks": int(w.gather_t_nnz.sum()),
                   "max_abs_err": err, "atol": KERNEL_ATOL,
                   "rtol": KERNEL_RTOL, "ms": time_ms(ops.spmm_t, sets),
                   "plain_ms": time_ms(ref.spmm_bwd_ref, sets),
                   "library_ms": time_ms(torch.matmul, copies(
                       lambda: (dy.clone(), wd.clone()),
                       tensor_bytes(dy, wd))),
                   "library": f"torch.matmul(dY, densified W) {lib}"}
            row.update(zip(("bound_ms", "bound_by", "bytes", "flops"),
                           _spmm_t_bound(w, dy)))
            log(json.dumps(row))
            rows[("bsr_spmm_t", mat_name, dt)] = row
            # SDDMM: dW at the resident slots
            err = _check(f"bsr_sddmm {mat_name} {dt}",
                         sddmm_ops.bsr_weight_grad(x, dy, w),
                         sddmm_ops.bsr_weight_grad_ref(x, dy, w),
                         SDDMM_ATOL, SDDMM_RTOL)
            sets = copies(lambda: (x.clone(), dy.clone(), w),
                          tensor_bytes(x, dy))
            row = {"kernel": "bsr_sddmm", "matrix": mat_name, "shape": [n, k],
                   "M": TRAIN_M, "x": str(dt).split(".")[-1],
                   "slots": int(w.data.shape[0]), "max_abs_err": err,
                   "atol": SDDMM_ATOL, "rtol": SDDMM_RTOL,
                   "ms": time_ms(sddmm_ops.bsr_weight_grad, sets),
                   "plain_ms": time_ms(sddmm_ops.bsr_weight_grad_ref, sets),
                   "library_ms": time_ms(lambda a, b: torch.matmul(a.T, b),
                                         copies(lambda: (dy.clone(), x.clone()),
                                                tensor_bytes(x, dy))),
                   "library": f"torch.matmul(dY', X) {lib} (dense dW)"}
            row.update(zip(("bound_ms", "bound_by", "bytes", "flops"),
                           _sddmm_bound(w, x, dy)))
            log(json.dumps(row))
            rows[("bsr_sddmm", mat_name, dt)] = row
    # prox_adam at every leaf size of the debias tree: the seven block
    # stores (32 layers each), the embedding, the stacked norms, the final
    # norm and the stacked placeholders of the compressed projections
    cfg = get_config(ARCH)
    leaf_sizes.update({"embedding": cfg.vocab * cfg.d_model,
                       "stacked norm": 32 * cfg.d_model,
                       "final norm": cfg.d_model, "placeholder": 32})
    # The SpC phase runs the kernel without the prox (the plan's group-l1
    # prox follows it), debias with it. The prox is checked at a threshold
    # tau = lr * lam of 0.5, comparable to |w|, so it zeroes and shrinks.
    sc = adam_ops.make_scalars(TRAIN_LR, PROX_TAU / TRAIN_LR, 0.9, 0.999,
                               1e-8, 3)
    for leaf, numel in leaf_sizes.items():
        def make():
            return (torch.randn(numel, device=dev),
                    torch.randn(numel, device=dev),
                    torch.randn(numel, device=dev) * 0.1,
                    torch.rand(numel, device=dev) * 0.01)
        for apply_prox in (False, True):
            def kernel(w, g, m, v, sc, apply_prox=apply_prox):
                return adam_ops.fused_update_leaf(w, g, m, v, sc,
                                                  apply_prox=apply_prox)

            def plain(w, g, m, v, sc, apply_prox=apply_prox):
                return adam_ops.fused_prox_update_ref(w, g, m, v, sc,
                                                      apply_prox=apply_prox)
            w, g, m, v = make()
            want = plain(w, g, m, v, sc)
            got = kernel(w.clone(), g, m.clone(), v.clone(), sc)
            err = max(_check(f"prox_adam {leaf} prox={apply_prox}", a, b,
                             ADAM_ATOL, ADAM_ATOL)
                      for a, b in zip(got, want))
            zeroed = float((got[0] == 0).float().mean())
            sets = copies(lambda: make() + (sc,), 16 * numel)
            nbytes = 28 * numel             # w, g, m, v read; w, m, v written
            row = {"kernel": "prox_adam", "leaf": leaf, "numel": numel,
                   "apply_prox": apply_prox, "tau": PROX_TAU,
                   "zeroed_share": zeroed, "max_abs_err": err,
                   "atol": ADAM_ATOL, "ms": time_ms(kernel, sets),
                   "plain_ms": time_ms(plain, sets), "library_ms": None,
                   "library": "none: no single PyTorch call is Adam with a "
                              "soft threshold"}
            row.update(zip(("bound_ms", "bound_by", "bytes", "flops"),
                           _ops_bound(nbytes, 10 * numel)))
            log(json.dumps(row))
            rows[("prox_adam", leaf, apply_prox)] = row
    return rows


def _projections(params):
    """(stored tensor, (in, out) view) of every compressible projection."""
    for sub, names in (("attn", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("wi", "wg", "wo"))):
        for name in names:
            t = params["layers"]["b0_attn"][sub][name]
            s = t.shape
            if name in ("wq", "wk", "wv"):
                yield t.view(s[0], s[1], s[2] * s[3])
            elif name == "wo" and sub == "attn":
                yield t.view(s[0], s[1] * s[2], s[3])
            else:
                yield t


def _plant_checkpoint(dev, ckpt_dir: Path) -> None:
    """A step-1 TrainState whose (8, 128) blocks (on the (out, in) serving
    grid) have norms spread log-uniformly over [SPREAD_LO, SPREAD_HI]."""
    model = build(get_config(ARCH), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    br, bc = BLOCK
    with torch.no_grad():
        for flat in _projections(params):
            norms = prox_lib._block_reduce_l2(flat, (bc, br))
            target = torch.exp(math.log(SPREAD_LO) + torch.rand(
                norms.shape, generator=gen, device=dev)
                * math.log(SPREAD_HI / SPREAD_LO))
            scale = target / norms.clamp_min(1e-30)
            full = scale.repeat_interleave(bc, -2).repeat_interleave(br, -1)
            flat.mul_(full[..., :flat.shape[-2], :flat.shape[-1]])
    opt = optimizers.prox_adam(TRAIN_LR, lam=LAM)
    Checkpointer(str(ckpt_dir)).save(1, TrainState(
        params=params, opt_state=opt.init(params), mask=None, step=1))


class _TimedWatchdog(train_loop.StragglerWatchdog):
    """Records every step's wall time, per phase (first instance: SpC)."""
    phases: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _TimedWatchdog.phases.append(self.times)


def _block_sparsity(cp) -> tuple:
    resident = total = 0
    for _, m in iter_bcsr(cp):
        resident += int(m.gather_nnz.sum())
        total += int(np.prod(m.block_grid)) * m.gather_nnz.shape[0]
    return 1.0 - resident / max(total, 1), resident, total


def _all_launches() -> dict:
    return {**ops.launches, **sddmm_ops.launches, **adam_ops.launches,
            **paged_ops.launches}


def _reset_all() -> None:
    for mod in (ops, sddmm_ops, adam_ops, paged_ops):
        mod.reset_launches()


def train_phase(dev) -> tuple:
    phase("train: launch/train --sparse (the main path)")
    ckpt_dir = OUT_DIR / "train_ckpt"
    if ckpt_dir.exists():
        import shutil
        shutil.rmtree(ckpt_dir)
    t0 = time.perf_counter()
    _plant_checkpoint(dev, ckpt_dir)
    torch.cuda.empty_cache()
    log(f"planted step-1 checkpoint in {time.perf_counter() - t0:.1f} s")
    tele = OUT_DIR / "train_telemetry.jsonl"
    argv = ["--arch", ARCH, "--sparse", "--steps", str(SPC_STEPS),
            "--debias-steps", str(DEBIAS_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--compress",
            f"group_l1:{LAM}", "--block", *map(str, BLOCK), "--log-every",
            str(LOG_EVERY), "--ckpt-dir", str(ckpt_dir), "--telemetry-out",
            str(tele)]
    buf = io.StringIO()
    _TimedWatchdog.phases = []
    saved = train_loop.StragglerWatchdog
    train_loop.StragglerWatchdog = _TimedWatchdog
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cp, hist_spc, hist_db, report = train.main(argv)
        torch.cuda.synchronize()
    finally:
        train_loop.StragglerWatchdog = saved
    counts = _all_launches()
    wall = time.perf_counter() - t0
    log(f"train {' '.join(argv)}")
    for line in buf.getvalue().splitlines():
        if line.startswith(("arch=", "loss:", "model size", "compressed ")):
            log(f"  {line}")
    log(f"  run {wall:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for rec in map(json.loads, tele.read_text().splitlines()):
        if rec["phase"] in ("spc", "debias"):
            extra = (f" live block sparsity {rec['block_sparsity']:.4f}"
                     if "block_sparsity" in rec else "")
            log(f"  {rec['phase']} step {rec['step']}: loss {rec['loss']:.4f}"
                f" grad_norm {rec['grad_norm']:.4f}{extra}")
    for name, times in zip(("spc", "debias"), _TimedWatchdog.phases):
        log(f"  {name} step times (s, host clock; a logged step includes its "
            f"telemetry and the loss read): {[round(t, 4) for t in times]}")
    sparsity, resident, total = _block_sparsity(cp)
    log(f"  block sparsity after SpC: {sparsity:.4f} ({resident} of {total} "
        f"(8, 128) blocks resident, {len(list(iter_bcsr(cp)))} projections "
        f"compressed), band {SPARSITY_BAND}")
    if not SPARSITY_BAND[0] <= sparsity <= SPARSITY_BAND[1]:
        raise SystemExit(f"block sparsity {sparsity:.4f} outside the band")
    if len(list(iter_bcsr(cp))) != 7:
        raise SystemExit("expected all 7 projections compressed")
    per_step = {k: v / DEBIAS_STEPS for k, v in counts.items()}
    log(f"  launches {counts}; per debias step spmm {per_step['spmm']:.1f}, "
        f"spmm_t {per_step['spmm_t']:.1f}, bsr_sddmm "
        f"{per_step['bsr_sddmm']:.1f}")
    expect = 7 * 32 * DEBIAS_STEPS
    if counts["spmm"] != expect or counts["spmm_t"] != expect \
            or counts["bsr_sddmm"] != expect or counts["prox_adam"] <= 0:
        raise SystemExit(f"train launches {counts}: expected {expect} spmm, "
                         "spmm_t and bsr_sddmm and some prox_adam")
    losses = [h["loss"] for h in hist_spc + hist_db]
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"non-finite training loss: {losses}")

    phase("train: launch/serve --sparse --ckpt-dir (the trained checkpoint)")
    buf = io.StringIO()
    _reset_all()
    argv = ["--arch", ARCH, "--sparse", "--ckpt-dir", str(ckpt_dir), "--batch",
            str(BATCH), "--prompt-len", str(PROMPT), "--gen", str(TRAIN_GEN)]
    with contextlib.redirect_stdout(buf):
        out = serve.main(argv)
    torch.cuda.synchronize()
    log(f"serve {' '.join(argv)}")
    for line in buf.getvalue().splitlines()[-3:]:
        log(f"  {line}")
    if tuple(out.shape) != (BATCH, TRAIN_GEN) or \
            ops.launches["spmm"] != 7 * 32 * TRAIN_GEN:
        raise SystemExit(f"serving the trained checkpoint: tokens "
                         f"{tuple(out.shape)}, launches {ops.launches}")
    return counts, ckpt_dir / "compressed"


class _Tap(torch.autograd.Function):
    """Identity whose backward records the gradient that reaches it."""

    @staticmethod
    def forward(ctx, x, sink):
        ctx.sink = sink
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.sink.append(g.detach().clone())
        return g, None


@contextlib.contextmanager
def _dx_taps(sink: list):
    """Record dx of every ``sparse_matmul``, in the order of the backward."""
    orig = sparse_ops.sparse_matmul

    def tapped(x, w, backend="auto"):
        return orig(_Tap.apply(x, sink), w, backend)

    sparse_ops.sparse_matmul = tapped
    try:
        yield
    finally:
        sparse_ops.sparse_matmul = orig


def _first_grads(model, trainable, rebuild, batch):
    """(loss, dx list, dw tree) of one debias forward and backward."""
    leaves = {p: d.detach().requires_grad_(True)
              for p, d in trainable["bcsr_data"].items()}

    def grad_leaf(t):
        if isinstance(t, dict):
            return {k: grad_leaf(v) for k, v in t.items()}
        return t.detach().requires_grad_(True)

    dense = grad_leaf(trainable["dense"])
    tr = {"dense": dense, "bcsr_data": leaves}
    sink: list = []
    with _dx_taps(sink), torch.enable_grad():
        loss, _ = make_loss_fn(model, param_transform=rebuild)(tr, batch)
        # the residue too, so that the first layer's dx is needed and runs
        grads = torch.autograd.grad(
            loss, list(leaves.values()) + [dense["embed"]["embedding"]])
    return float(loss.detach()), sink, dict(zip(leaves, grads))


def train_compare_phase(dev, cdir: Path) -> None:
    phase("train: kernel path vs plain path (f32 debias)")
    f32 = dataclasses.replace(get_config(ARCH), compute_dtype="float32")
    data = TokenStreamConfig(vocab=f32.vocab, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH)
    runs = {}
    for backend in ("auto", "ref"):
        model = build(f32, device=dev, sparse_backend=backend)
        cp = Checkpointer(str(cdir)).restore_compressed(device=dev)
        trainable, rebuild = split_trainable(cp)
        init = {k: v.clone() for k, v in trainable["bcsr_data"].items()}
        loss0, dxs, dws = _first_grads(model, trainable, rebuild,
                                       token_batch(data, 0, device=dev))
        opt = optimizers.prox_adam(COMPARE_LR, lam=0.0)
        state = TrainState(params=trainable, opt_state=opt.init(trainable),
                           mask=masks.zero_mask(trainable), step=0)
        step = make_train_step(model, opt, param_transform=rebuild)
        _reset_all()
        losses = []
        for i in range(COMPARE_STEPS):
            state, met = step(state, token_batch(data, i, device=dev))
            losses.append(float(met["loss"]))
        log(f"{backend}: losses {losses}, launches {_all_launches()}")
        runs[backend] = (loss0, dxs, dws, losses,
                         {k: v - init[k] for k, v in
                          state.params["bcsr_data"].items()})
    k, p = runs["auto"], runs["ref"]
    for a, b in zip(k[3], p[3]):
        if abs(a - b) > LOSS_RTOL * abs(b):
            raise SystemExit(f"debias losses differ: {k[3]} vs {p[3]}")
    if len(k[1]) != 7 * 32 or len(p[1]) != 7 * 32:
        raise SystemExit(f"dx taps: {len(k[1])} and {len(p[1])}")
    dx_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(k[1], p[1]))
    dw_err = 0.0
    for path, gk in k[2].items():
        gp = p[2][path]
        for layer in range(gk.shape[0]):
            scale = gp[layer].abs().max().clamp_min(1e-30)
            dw_err = max(dw_err, float((gk[layer] - gp[layer]).abs().max()
                                       / scale))
    data_err = max(float((k[4][path] - p[4][path]).abs().max())
                   for path in k[4])
    upd_err = max(float((k[4][path] - p[4][path]).norm()
                        / p[4][path].norm().clamp_min(1e-30)) for path in k[4])
    log(f"f32 debias, kernels vs plain: step-1 loss {k[0]:.6f} vs {p[0]:.6f}; "
        f"dx max err / max|dx| per layer {dx_err:.3e}, dw {dw_err:.3e} "
        f"(bound {GRAD_RTOL}); block-store updates after {COMPARE_STEPS} "
        f"steps at lr {COMPARE_LR}: |diff| / |update| {upd_err:.3e} (bound "
        f"{UPDATE_RTOL}), max |diff| {data_err:.3e}")
    if dx_err > GRAD_RTOL or dw_err > GRAD_RTOL or upd_err > UPDATE_RTOL:
        raise SystemExit("kernel path and plain path disagree")

    phase("train: bf16 debias step profile")
    model = build(get_config(ARCH), device=dev)
    cp = Checkpointer(str(cdir)).restore_compressed(device=dev)
    trainable, rebuild = split_trainable(cp)
    opt = optimizers.prox_adam(TRAIN_LR, lam=0.0)
    holder = [TrainState(params=trainable, opt_state=opt.init(trainable),
                         mask=masks.zero_mask(trainable), step=0)]
    step = make_train_step(model, opt, param_transform=rebuild)
    batch = token_batch(data, 0, device=dev)

    def one():
        holder[0], met = step(holder[0], batch)
        float(met["loss"])

    one()                                            # warm-up
    _profile("debias step (batch 8 x 64)", 0, one, top=10)
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            holder[0], _ = step(holder[0], batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}"
                                for w in caught)
    log(f"host syncs in one debias step (loss not read): {len(caught)}, "
        f"by caller {where.most_common(8)}")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _flash_pairs(s: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head: the products the work needs
    (a kernel skips the masked ones where it can)."""
    i = np.arange(s)
    hi = i if causal else np.full(s, s - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(s, np.int64)
    return int((hi - lo + 1).sum())


def _flash_bound(b, s, h, kv, hd, causal, window, dtype):
    """q, k and v read once and o written once, against 4 * hd flops per
    unmasked (query, key) pair and head (scores and probability times V),
    at the bf16 tensor-core rate for bf16 operands, else the f32 rate."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * h + 2 * b * kv) * s * hd * elt
    flops = 4 * hd * b * h * _flash_pairs(s, causal, window)
    return _ops_bound(nbytes, flops, dtype)


def _flash_mask(s, causal, window, dev):
    """SDPA's boolean mask, or None where ``is_causal`` (or nothing) says it."""
    if window is None:
        return None
    qp = torch.arange(s, device=dev)[:, None]
    kp = torch.arange(s, device=dev)[None, :]
    mask = (qp - kp) < window
    return mask & (qp >= kp) if causal else mask


def flash_phase(dev) -> tuple:
    """The flash-attention kernel against its plain version at the shapes
    of FLASH_CASES, timed beside it, SDPA and its bound; then its entry
    point ``ops.flash_attention`` driven once in the model layout with the
    launch counter set to 0 just before. The counter's value on arrival is
    what the serving and training phases launched: no model code calls
    the kernel."""
    phase("flash attention")
    model_launches = flash_ops.launches["flash_attention_fwd"]
    rows = []
    for ci, (case, b, s, h, kv, hd, causal, window, dtype) in enumerate(FLASH_CASES):
        gen = torch.Generator(device=dev).manual_seed(ci)

        def mk(n):
            return torch.randn(n, s, hd, device=dev, generator=gen).to(dtype)

        q, k, v = mk(b * h), mk(b * kv), mk(b * kv)
        got = flash_ops.flash_attention_fwd(q, k, v, causal=causal,
                                            window=window)
        want = flash_ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window)
        torch.cuda.synchronize()
        atol, rtol = FLASH_TOL[dtype]
        err = float((got.float() - want.float()).abs().max())
        if not (torch.isfinite(got.float()).all() and torch.allclose(
                got.float(), want.float(), atol=atol, rtol=rtol)):
            raise SystemExit(f"flash {case} {dtype}: kernel disagrees with "
                             f"plain, max err {err}")
        sets = copies(lambda: (mk(b * h), mk(b * kv), mk(b * kv)),
                      tensor_bytes(q, k, v) * 2)
        kern = functools.partial(flash_ops.flash_attention_fwd,
                                 causal=causal, window=window)
        plain = functools.partial(flash_ref.flash_attention_ref,
                                  causal=causal, window=window)
        mask = _flash_mask(s, causal, window, dev)

        def sdpa(q, k, v):
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)

        lib_sets = [(q_.view(b, h, s, hd), k_.view(b, kv, s, hd),
                     v_.view(b, kv, s, hd)) for q_, k_, v_ in sets]
        lib_err = float((sdpa(*lib_sets[0]).reshape(b * h, s, hd).float()
                         - plain(*sets[0]).float()).abs().max())
        row = {"kernel": "flash_attention", "case": case, "B": b, "S": s,
               "H": h, "KV": kv, "hd": hd, "causal": causal,
               "window": window, "dtype": str(dtype).split(".")[-1],
               "max_abs_err": err, "atol": atol, "rtol": rtol,
               "ms": time_ms(kern, sets, calls=20),
               "plain_ms": time_ms(plain, sets[:2], calls=3),
               "library_ms": time_ms(sdpa, lib_sets, calls=20),
               "library": "scaled_dot_product_attention(enable_gqa=True"
                          + (", boolean mask)" if mask is not None else
                             ", is_causal)" if causal else ")"),
               "library_max_abs_err": lib_err}
        row.update(zip(("bound_ms", "bound_by", "bytes", "flops"),
                       _flash_bound(b, s, h, kv, hd, causal, window, dtype)))
        log(json.dumps(row))
        rows.append(row)

    # the entry point, in the (B, S, H, hd) model layout, at the table row's
    # shape and at smollm-360m's prefill shape
    flash_ops.reset_launches()
    for case, b, s, h, kv, hd, causal, window, dtype in (
            FLASH_CASES[FLASH_TABLE_ROW], FLASH_CASES[3]):
        gen = torch.Generator(device=dev).manual_seed(99)
        q = torch.randn(b, s, h, hd, device=dev, generator=gen).to(dtype)
        k = torch.randn(b, s, kv, hd, device=dev, generator=gen).to(dtype)
        v = torch.randn(b, s, kv, hd, device=dev, generator=gen).to(dtype)
        out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
        want = flash_ref.flash_attention_ref(
            q.transpose(1, 2).reshape(b * h, s, hd),
            k.transpose(1, 2).reshape(b * kv, s, hd),
            v.transpose(1, 2).reshape(b * kv, s, hd), causal=causal,
            window=window).reshape(b, h, s, hd).transpose(1, 2)
        torch.cuda.synchronize()
        atol, rtol = FLASH_TOL[dtype]
        if tuple(out.shape) != (b, s, h, hd) or not torch.allclose(
                out.float(), want.float(), atol=atol, rtol=rtol):
            raise SystemExit(f"flash_attention entry point, {case}: "
                             "disagrees with the plain version")
    launches = flash_ops.launches["flash_attention_fwd"]
    log(f"flash_attention entry point: {launches} launches; the serving and "
        f"training phases launched it {model_launches} times")
    if launches < 2 or model_launches:
        raise SystemExit("flash_attention launch counts are off")
    return rows, launches, model_launches


# ---------------------------------------------------------------------------
# the recurrent families: recurrentgemma-9b (RG-LRU + local attention) and
# rwkv6-3b, at full width
# ---------------------------------------------------------------------------

def _spmm_per_pass(cp) -> int:
    """spmm launches of one forward pass: one per compressed matrix of
    every layer (a stacked store counts once per layer)."""
    return sum(m.data.shape[0] if m.data.dim() == 4 else 1
               for _, m in iter_bcsr(cp))


def _recurrent_requests(vocab: int, prompts) -> list:
    rng = np.random.default_rng(7)
    return [api.Request(prompt=rng.integers(0, vocab, n),
                        max_new_tokens=ENGINE_GEN) for n in prompts]


def _paged_hd256_rows(dev, cfg) -> list:
    """The paged flash-decode kernel at recurrentgemma-9b's attention
    (16 q heads of 256 on one kv head, window 2048): against its plain
    version, timed beside it, the gather + SDPA yardstick and its bound."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kv
    window = cfg.attn_window
    rows = []
    for case in HYBRID_PAGED_CASES:
        q, kp, vp, table, positions, valid = _paged_inputs(
            dev, case, torch.bfloat16, cfg)
        qg = _grouped(q, kv)
        plain_out = paged_ref.paged_attention_ref(q, kp, vp, table, positions,
                                                  window=window)
        for splits in (1, HYBRID_KV_SPLITS):
            out = paged_ops.paged_flash_attention(q, kp, vp, table, positions,
                                                  window=window,
                                                  kv_splits=splits)
            torch.cuda.synchronize()
            err = float((out[valid] - plain_out[valid]).abs().max())
            if not (torch.isfinite(out).all() and err <= PAGED_ATOL):
                raise SystemExit(f"paged {case[0]} S={splits}: kernel "
                                 f"disagrees with plain, {err}")
            sets = copies(lambda: (qg.clone(), kp.clone(), vp.clone(), table,
                                   positions), tensor_bytes(qg, kp, vp))
            kern = functools.partial(paged_ops.paged_flash_fwd, window=window,
                                     kv_splits=splits)
            row = {"kernel": "paged_flash_attention", "case": case[0],
                   "B": len(case[2]), "C": case[1], "P": case[4], "g": g,
                   "hd": hd, "window": window, "pool": "bfloat16",
                   "kv_splits": splits, "max_abs_err": err,
                   "atol": PAGED_ATOL, "ms": time_ms(kern, sets, calls=10),
                   "plain_ms": time_ms(lambda *a: paged_ref.paged_flash_fwd_ref(
                       *a, a[-1][:, 0], window=window, kv_splits=splits),
                       sets[:1], calls=2),
                   "library_ms": time_ms(
                       functools.partial(_gather_sdpa, window=window),
                       [(q, kp_, vp_, tb, ps_) for _, kp_, vp_, tb, ps_ in sets],
                       calls=20),
                   "library": "gather + repeat_interleave + "
                              "scaled_dot_product_attention (window mask)"}
            row.update(zip(("bound_ms", "bound_by", "bytes", "flops",
                            "pages_run", "bound_bf16_ms"),
                           _paged_bound(case, kv, g, hd, kp.element_size(),
                                        splits, window)))
            log(json.dumps(row))
            rows.append(row)
    return rows


def _hybrid_spmm_rows(dev, formats) -> dict:
    """Kernel-table row 1c: both forward kernels at the engine's prefill
    tick (M = 256, bf16 x) on recurrentgemma-9b's own compressed
    projections of its first super-block (two RG-LRU layers and a local
    attention layer, each with its MLP: 19 matrices), BlockCSR (its f32
    store) and palette-8, each against the plain version, the library call
    (f32 matmul on the densified f32 weight), for information the bf16
    matmul on the bf16-rounded weight, and the bound; then their sums over
    the super-block."""
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for fmt, bits in (("bcsr", None), ("pal8", 8)):
        rows = []
        for path, m in iter_bcsr(formats[fmt]):
            if not path.startswith("layers/"):
                continue
            w = m[0] if (m.data if bits is None else m.codes).dim() == 4 else m
            x = torch.randn(HYBRID_SPMM_M, w.shape[1], generator=gen,
                            device=dev).to(torch.bfloat16)
            row = {"kernel": "bsr_spmm" if bits is None else "bsr_spmm_palette8",
                   "matrix": path,
                   **_spmm_case(w, x, "spmm" if bits is None else "spmm_palette",
                                bits, bf16_matmul=True,
                                yardstick_calls=HYBRID_YARDSTICK_CALLS)}
            log(json.dumps(row))
            rows.append(row)
        total = {k: sum(r[k] for r in rows) for k in SUM_KEYS}
        total.update(calls=len(rows), picked=rows[0]["picked"],
                     max_abs_err=max(r["max_abs_err"] for r in rows))
        log(json.dumps({"row": "1c", "format": fmt, "super_block": total}))
        out[fmt] = {"rows": rows, "sum": total}
    return out


def _check_counts(what, counts, want: dict) -> None:
    for name, n in want.items():
        if counts.get(name, 0) != n:
            raise SystemExit(f"{what}: launches {counts}, expected {want}")


def recurrent_phase(dev, arch: str, prompts, f32_layers=None,
                    kv_splits: int = 1) -> dict:
    """One recurrent family at full width: the compressed model built on
    the card (BlockCSR, then palette-8); ``generate`` (batch 4, prompt 16,
    32 new tokens) and the engine on the request mix ``prompts`` in bf16,
    each with the launch counters set to 0 just before and read just
    after; where the time goes (torch.profiler); then in f32 the kernel
    path against the plain path and the engine against ``generate``, at
    the depth ``f32_layers`` (all layers when None)."""
    cfg = get_config(arch)
    phase(f"{arch}: the compressed model, built on the card")
    t0 = time.perf_counter()
    model = build(cfg, device=dev)
    cp = init_compressed(model, CompressionPlan(block=BLOCK), SPARSITY,
                         torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    formats = {"bcsr": cp, "pal8": quantize_compressed(cp, 8)}
    torch.cuda.synchronize()
    dense_b = model_size_bytes(model.init(device="meta"))
    per_pass = _spmm_per_pass(cp)
    n_attn = (cfg.n_super_blocks * cfg.block_pattern.count("attn")
              + cfg.remainder_pattern.count("attn"))
    sizes = {"dense": dense_b, "bcsr": bcsr_equiv_size_bytes(cp),
             "pal8": compressed_size_bytes(formats["pal8"])}
    log(f"{arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_params():,} params; {len(list(iter_bcsr(cp)))} compressed "
        f"weights, {per_pass} spmm per pass, {n_attn} attention layers; "
        f"build {t1 - t0:.1f} s, palette-8 {time.perf_counter() - t1:.1f} s; "
        f"bytes dense {dense_b / 1e6:.2f} MB, bcsr {sizes['bcsr'] / 1e6:.2f} "
        f"MB, palette-8 {sizes['pal8'] / 1e6:.2f} MB")
    result = {"arch": arch, "sizes": sizes, "per_pass": per_pass}
    if arch == HYBRID:
        phase(f"{arch}: the forward spmm at the engine's prefill tick "
              f"(M = {HYBRID_SPMM_M}), first super-block")
        result["spmm_1c"] = _hybrid_spmm_rows(dev, formats)

    phase(f"{arch}: kernel path vs plain path, bf16, all {cfg.n_layers} "
          "layers")
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                           device=dev)
    plain = build(cfg, device=dev, sparse_backend="ref")
    plain_f32 = build(dataclasses.replace(cfg, compute_dtype="float32"),
                      device=dev, sparse_backend="ref")
    for fmt, params in formats.items():
        _bf16_logits_check(f"{arch} {fmt}", model, plain, params, prompt,
                           plain_f32)
    torch.cuda.empty_cache()

    phase(f"{arch}: generate (the main path)")
    for fmt, params in formats.items():
        wrapper = "spmm" if fmt == "bcsr" else "spmm_palette"
        ops.reset_launches()
        paged_ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(model, params, prompt, GEN)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {**ops.launches, **paged_ops.launches}
        _check_counts(f"{arch} {fmt} generate", counts,
                      {wrapper: per_pass * GEN, "paged_flash_fwd": 0})
        if tuple(out.shape) != (BATCH, GEN) or int(out.min()) < 0 or \
                int(out.max()) >= cfg.vocab:
            raise SystemExit(f"{arch} {fmt}: generate returned {out.shape}")
        log(f"{arch} {fmt} bf16 generate {BATCH} x {GEN}: "
            f"{BATCH * GEN / dt:.1f} tok/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"{counts}")
        result[f"generate_{fmt}"] = {"tok_s": BATCH * GEN / dt,
                                     "launches": counts[wrapper]}
    _profile(f"{arch} generate {PROFILE_GEN} tokens x {BATCH}",
             BATCH * PROFILE_GEN,
             lambda: generate(model, cp, prompt, PROFILE_GEN), top=8)

    if arch == HYBRID:
        phase(f"{arch}: paged kernel at hd {cfg.resolved_head_dim}, "
              f"g {cfg.n_heads // cfg.n_kv_heads}")
        result["paged_rows"] = _paged_hd256_rows(dev, cfg)

    phase(f"{arch}: engine (the main path)")
    requests = _recurrent_requests(cfg.vocab, prompts)
    for fmt, params in formats.items():
        wrapper = "spmm" if fmt == "bcsr" else "spmm_palette"
        engine = _engine(model, params, requests, kv_splits=kv_splits)
        ops.reset_launches()
        paged_ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = engine.run(requests)
        torch.cuda.synchronize()
        counts = {**ops.launches, **ops.variant_launches, **paged_ops.launches}
        s = out["stats"]
        ticks = s["n_ticks"]
        _check_counts(f"{arch} {fmt} engine", counts,
                      {wrapper: per_pass * ticks,
                       "paged_flash_fwd": n_attn * ticks})
        if s["n_requests"] != len(requests) or \
                s["n_generated"] != len(requests) * ENGINE_GEN:
            raise SystemExit(f"{arch} engine {fmt}: served {s['n_requests']} "
                             f"requests, {s['n_generated']} tokens")
        peak = torch.cuda.max_memory_allocated()
        log(f"{arch} engine {fmt} bf16: {s['tok_s']:.1f} tok/s, ttft p50/p95 "
            f"{s['ttft_p50_s'] * 1e3:.1f}/{s['ttft_p95_s'] * 1e3:.1f} ms, "
            f"{ticks} ticks, {s['n_prefill_chunks']} prefill chunks, pools "
            f"kv {s['kv_page_bytes']} + state {s['state_slot_bytes']} bytes, "
            f"peak memory {peak / 2**30:.2f} GiB, run "
            f"{time.perf_counter() - t0:.1f} s, launches {counts}")
        result[f"engine_{fmt}"] = {
            "tok_s": s["tok_s"], "ttft_p50_s": s["ttft_p50_s"],
            "ttft_p95_s": s["ttft_p95_s"], "ticks": ticks,
            "paged": counts["paged_flash_fwd"], "spmm": counts[wrapper],
            **{k: counts[f"{wrapper}_{k}"] for k in ops.KERNELS}}
    _profile_engine_window(
        lambda: _engine(model, cp, requests, kv_splits=kv_splits), requests,
        RECURRENT_PROFILE_TICKS)
    del formats
    torch.cuda.empty_cache()

    phase(f"{arch}: f32, kernel path vs plain path and engine vs generate")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    if f32_layers:
        f32 = dataclasses.replace(f32, n_layers=f32_layers)
        log(f"{arch}: the f32 checks run at a cut depth of {f32_layers} "
            f"layers ({f32.n_super_blocks} super-block(s) and remainder "
            f"{f32.remainder_pattern}); the bf16 runs above are at full "
            f"depth, {cfg.n_layers} layers")
    kernel_f32 = build(f32, device=dev)
    plain_f32 = build(f32, device=dev, sparse_backend="ref")
    p32 = _cut_depth(cp, f32.n_super_blocks)
    out_k = generate(kernel_f32, p32, prompt, GEN)
    out_r = generate(plain_f32, p32, prompt, GEN)
    matched = sum(_divergence_ok(plain_f32, p32, prompt[row].tolist(),
                                 out_r[row], out_k[row],
                                 f"{arch} f32 generate kernel vs plain row {row}")
                  for row in range(BATCH))
    log(f"{arch}: f32 generate {matched}/{BATCH * GEN} tokens of the kernel "
        "path match the plain path")
    ops.reset_launches()
    paged_ops.reset_launches()
    cuda_out = _engine(kernel_f32, p32, requests, attn_backend="cuda",
                       kv_splits=kv_splits).run(requests)
    counts = {**ops.launches, **paged_ops.launches}
    matched = sum(_divergence_ok(
        kernel_f32, p32, r.prompt,
        generate(kernel_f32, p32, torch.tensor(r.prompt_ids, device=dev)[None],
                 ENGINE_GEN)[0],
        cuda_out["results"][rid], f"{arch} f32 engine vs generate rid {rid}")
        for rid, r in enumerate(requests))
    log(f"{arch}: f32 engine {matched}/{len(requests) * ENGINE_GEN} tokens "
        f"match generate ({cuda_out['stats']['n_ticks']} ticks, launches "
        f"{counts})")
    plain_out = _engine(plain_f32, p32, requests, attn_backend="ref"
                        ).run(requests)
    matched = sum(_divergence_ok(plain_f32, p32, r.prompt,
                                 plain_out["results"][rid],
                                 cuda_out["results"][rid],
                                 f"{arch} f32 engine kernel vs plain rid {rid}")
                  for rid, r in enumerate(requests))
    log(f"{arch}: f32 engine {matched}/{len(requests) * ENGINE_GEN} tokens of "
        "the kernel path (spmm and paged kernels) match the plain path")
    del cp, p32
    torch.cuda.empty_cache()
    return result


def _spmm_rows(table, rows, launches, hybrid, card) -> None:
    """The forward spmm's rows: the decode kernel at smollm-360m's decode
    (rows 1-2, M = 4), launched by ``launch/serve --sparse``'s decode
    steps; the tile kernel at recurrentgemma-9b's prefill tick (row 1c,
    per call over the first super-block's 19 projections), launched by the
    hybrid engine's prefill ticks, and, for palette-4, at smollm-360m's
    mlp.wi with M = 512, launched by the serve run's prefill."""
    mat, m_rows, x_dtype = TABLE_SHAPE
    for name, fmt in (("bsr_spmm", "bcsr"), ("bsr_spmm_palette8", "pal8"),
                      ("bsr_spmm_palette4", "pal4")):
        r = rows[(name, mat, m_rows, x_dtype)]
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/bsr_spmm.cu",
            "replaces": REPLACES[name], "launches": launches[fmt]["decode"],
            "max_abs_err": max(v["max_abs_err"] for k, v in rows.items()
                               if k[0] == name),
            "ms": r["ms_decode"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bound_bf16_ms": r["bound_bf16_ms"], "library_ms": r["library_ms"],
            "shape": f"decode kernel, {mat} {r['matrix_shape']} M={m_rows} "
                     f"x={r['x']}",
            "card": card})
    for name, fmt in (("bsr_spmm_tile", "bcsr"),
                      ("bsr_spmm_palette8_tile", "pal8")):
        tot = hybrid["spmm_1c"][fmt]["sum"]
        n = tot["calls"]
        store = "f32" if fmt == "bcsr" else "palette8"
        rate = F32_FLOPS_PER_S
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/bsr_spmm.cu",
            "replaces": REPLACES[name.replace("_tile", "")],
            "launches": hybrid[f"engine_{fmt}"]["tile"],
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms_tile"] / n,
            "plain_ms": tot["plain_ms"] / n, "bound_ms": tot["bound_ms"] / n,
            "bound_by": "bytes" if tot["bytes"] / HBM_BYTES_PER_S
            >= tot["flops"] / rate else "operations",
            "bound_bf16_ms": tot["bound_bf16_ms"] / n,
            "library_ms": tot["library_ms"] / n,
            "bf16_matmul_ms": tot["bf16_matmul_ms"] / n,
            "shape": f"tile kernel, {HYBRID} first super-block's {n} "
                     f"projections, per call, M={HYBRID_SPMM_M} x=bfloat16 "
                     f"store={store}",
            "card": card})
    r = rows[("bsr_spmm_palette4", mat, max(M_VALUES), x_dtype)]
    table.append({
        "name": "bsr_spmm_palette4_tile", "route": "cuda",
        "source": "src/repro_torch/csrc/bsr_spmm.cu",
        "replaces": REPLACES["bsr_spmm_palette4"],
        "launches": launches["pal4"]["tile"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms_tile"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "bound_bf16_ms": r["bound_bf16_ms"],
        "library_ms": r["library_ms"],
        "shape": f"tile kernel, {mat} {r['matrix_shape']} M={max(M_VALUES)} "
                 f"x={r['x']}",
        "card": card})


def _paged_row(table, name, r, launches, max_err, card) -> None:
    """A row of the paged kernel: ``r`` one of its timed rows, ``launches``
    the paged launches of the engine run that drives that shape."""
    table.append({
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": PAGED_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "bound_bf16_ms": r["bound_bf16_ms"], "library_ms": r["library_ms"],
        "shape": f"{r['case']} B={r['B']} C={r['C']} P={r['P']} "
                 f"g={r['g']} hd={r['hd']} "
                 f"pool={r['pool']} kv_splits={r['kv_splits']}",
        "card": card})


def _flash_row(table, name, r, launches, model_launches, max_err,
               card) -> None:
    table.append({
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": FLASH_REPLACES, "launches": launches,
        "model_path_launches": model_launches, "max_abs_err": max_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "shape": f"B={r['B']} S={r['S']} H={r['H']} KV={r['KV']} "
                 f"hd={r['hd']} causal window={r['window']} {r['dtype']}",
        "card": card})


def _train_rows(table, train_rows, train_counts, card) -> None:
    mat, dt = TRAIN_TABLE_SHAPE
    for name, replaces in (
            ("bsr_spmm_t", "src/repro/kernels/bsr_spmm/bsr_spmm.py:163"),
            ("bsr_sddmm", "src/repro/kernels/bsr_sddmm/bsr_sddmm.py:44")):
        r = train_rows[(name, mat, dt)]
        table.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/csrc/bsr_spmm.cu"
                       if name == "bsr_spmm_t"
                       else "src/repro_torch/csrc/bsr_sddmm.cu"),
            "replaces": replaces,
            "launches": train_counts["spmm_t" if name == "bsr_spmm_t"
                                     else "bsr_sddmm"],
            "max_abs_err": max(v["max_abs_err"] for key, v in
                               train_rows.items() if key[0] == name),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": f"{mat} {r['shape']} M={TRAIN_M} "
                     f"{'dy' if name == 'bsr_spmm_t' else 'x'}=bfloat16 "
                     "store=bfloat16",
            "card": card})
    r = train_rows[("prox_adam", "bcsr_data mlp.wi", True)]
    table.append({
        "name": "prox_adam", "route": "cuda",
        "source": "src/repro_torch/csrc/prox_adam.cu",
        "replaces": "src/repro/kernels/prox_adam/prox_adam.py:69",
        "launches": train_counts["prox_adam"],
        "max_abs_err": max(v["max_abs_err"] for key, v in train_rows.items()
                           if key[0] == "prox_adam"),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "shape": f"bcsr_data mlp.wi leaf, {r['numel']} f32 elements, "
                 "with the prox",
        "card": card})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = device_phase(dev)
    build_phase()
    flash_ops.reset_launches()
    table = []
    rows = kernel_phase(dev)
    decode_phase(dev)
    launches, formats = model_phase(dev)
    paged_rows = paged_kernel_phase(dev)
    paged_launches = engine_phase(dev, formats)
    paged_err = max(v["max_abs_err"] for v in paged_rows.values())
    _paged_row(table, "paged_flash_attention", paged_rows[PAGED_TABLE_ROW],
               paged_launches["bcsr"], paged_err, card)
    _paged_row(table, "paged_flash_attention_prefill",
               paged_rows[PAGED_PREFILL_ROW], paged_launches["bcsr"],
               paged_err, card)
    del formats
    torch.cuda.empty_cache()
    train_rows = train_kernel_phase(dev)
    train_counts, cdir = train_phase(dev)
    train_compare_phase(dev, cdir)
    _train_rows(table, train_rows, train_counts, card)
    hybrid = recurrent_phase(dev, HYBRID, HYBRID_PROMPTS,
                             f32_layers=HYBRID_F32_LAYERS,
                             kv_splits=HYBRID_KV_SPLITS)
    log(f"{HYBRID}: {json.dumps({k: v for k, v in hybrid.items() if k != 'spmm_1c'}, default=str)}")
    r = next(x for x in hybrid["paged_rows"] if x["case"] == "hd256 prefill"
             and x["kv_splits"] == HYBRID_KV_SPLITS)
    _paged_row(table, "paged_flash_attention_hd256_prefill", r,
               hybrid["engine_bcsr"]["paged"],
               max(x["max_abs_err"] for x in hybrid["paged_rows"]), card)
    _spmm_rows(table, rows, launches, hybrid, card)
    rwkv = recurrent_phase(dev, RWKV, RWKV_PROMPTS, f32_layers=RWKV_F32_LAYERS)
    log(f"{RWKV}: {json.dumps(rwkv, default=str)}")
    flash_rows, flash_launches, model_launches = flash_phase(dev)
    flash_err = max(v["max_abs_err"] for v in flash_rows)
    _flash_row(table, "flash_attention", flash_rows[FLASH_TABLE_ROW],
               flash_launches, model_launches, flash_err, card)
    _flash_row(table, "flash_attention_smollm_prefill",
               flash_rows[FLASH_PREFILL_ROW], flash_launches, model_launches,
               flash_err, card)

    phase("kernel table")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
