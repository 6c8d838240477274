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
 7b. router: the same mix through ``launch/serve --engine --replicas N
     --route least-loaded`` (N engine replicas, each a worker thread on
     its own CUDA stream, one copy of the weights) for N = 4 in bf16 at
     full depth, beside the single engine, with the launch counters
     held to the replicas' ticks; the mix's first 4 requests through
     ``Router.build`` for N = 1, 2 and 4 unprofiled (at N = 1 in turn with
     one engine, for the router's own cost; allocated device memory while
     serving held to N ticks' activations), the live allocations at the
     N = 2 peak by stream and by allocating line (the allocator's trace), and a run with two
     windows: the device busy share (the union of the device events'
     intervals, torch.profiler alone) and the launch counters held to the
     kernel-call profiler's counts (``--profile``'s); ``Router.build``
     growing device memory by the replicas' pools only; in f32 at 4
     layers, a 2-replica
     fleet whose replica 0 fails after 4 tokens streams ``generate``'s
     tokens with contiguous indices, and the prefix route puts requests
     sharing a 4-page prefix on one replica, which hits its cache;
 7c. mesh: ``--mesh 2,2``, 4 ranks (one process each, spawned once)
     sharing the card, their collectives through gloo, each rank holding
     its part of the params (the compressed stores split by block rows)
     and running the kernels on it, against the same runs with ``--mesh
     none`` in this process: (a) ``launch/serve --sparse --ckpt-dir
     --logits-out`` on a checkpoint of phase 5's model (each rank restores
     its shard), bf16 at full depth (logits within 2% of the largest
     |logit|, greedy tokens equal but at near ties) and f32 at 2 layers
     (1e-4, tokens equal); (b) the same with ``--engine`` (tokens equal);
     (c) per rank the spmm launches per pass (equal to one process's),
     the compressed store bytes and the peak memory; (d) ``launch/train
     --sparse`` at full width cut to 2 layers, f32, 3 SpC and 2 debias
     steps from a planted checkpoint (losses within 1e-5 relative, stores
     within 1% of their norm; each rank's spmm_t, SDDMM and prox_adam
     launches); (e) olmoe-1b-7b's MoE layer at full width, f32, dense
     experts, on mesh (1, 2) of the first two ranks: the expert-parallel
     path against the single-program path;
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
 11b. recurrentgemma-9b training: ``spmm_t`` and the SDDMM at its layer-0
     mlp.wi ((12288, 4096), (8, 128) blocks at 0.9, M = 512, bf16 and f32)
     against their plain versions, timed beside them, the dense library
     yardsticks and their bounds (kernel-table rows 1br / 4r); SpC-Retrain
     (``train/loop.run_spc_retrain_pipeline``) at full width on its first
     super-block in bf16 from weights whose blocks have spread norms (the
     RG-LRU projections among them): step times, peak memory, the
     recurrent projections' block sparsity (0.8-0.95), the seconds of
     ``compress_params``, one launch of spmm, spmm_t and the SDDMM per
     compressed matrix a debias step; in f32 at that depth, the kernel
     path against the plain path over 3 debias steps (every kernel call
     held to its plain version; losses, step 1's dx and dw, the stores'
     updates); debias at full width and depth on phase 11's model, with
     the launch counters per step and one step profiled; and
     ``launch/train --reduced --sparse`` from a planted checkpoint (its
     RG-LRU projections compress) and ``launch/serve --sparse --ckpt-dir``
     on its checkpoint;
 12. rwkv6-3b at full width and depth (32 layers, d 2560, 40 WKV heads of
     64, d_ff 8960, vocab 65,536), the same runs and checks, on a mix whose
     prompts RWKV's 64-token WKV chunks take;
 12b. rwkv6-3b training: the runs of 11b but the kernel rows, SpC-Retrain
     on 2 of 32 layers, the block sparsity held over the time- and
     channel-mix projections;
 13. olmoe-1b-7b at full width and depth (16 layers, d 2048, 16 heads of
     128 with QK-norm, 64 experts of d_ff 1024, top-8, vocab 50,304): seed-0
     weights pruned at 0.9 on (8, 128) blocks, built on the card by
     ``init_compressed``, then palette-8 and palette-4; the expert launch
     (``ops.spmm_experts`` / ``spmm_palette_experts``: the expert forward
     of ``csrc/bsr_spmm_experts.cu``, the expert on the grid's z axis) on
     layer 0's three projections at M = 1, 8, 16 (decode form) and 40
     (tile form), bf16 and f32 x, every row computed, each held to its
     plain version and, at ewi, timed beside it, ``torch.bmm`` on the
     densified weight, 64 single-expert launches (M = 8) and its bound; at
     M = 8 and 40, bf16 x, the launch on the rows layer 0's router fills
     with M random tokens (the MoE layer's counts), held to the plain
     version with the same counts (at ewi beside its routed bound);
     ``generate`` and the engine through the serving CLI from BlockCSR,
     palette-8 and palette-4 in bf16 at full width on the first 8 of 16
     layers, with 57 spmm launches a forward (4 attention projections and
     3 expert launches per layer, and the head) and none per expert; where the engine's time goes; the bf16 prefill
     at full depth held call by call, and in its logits unless a router
     flipped at a near tie (flips counted and printed); in f32 at 2 of 16
     layers, the kernel path against the plain path (each store) and the
     engine (capacity factor E / top_k, so nothing is dropped; BlockCSR)
     against ``generate``; and a ``launch/serve --profile`` run whose
     counts equal the launch counters;
 13b. olmoe-1b-7b training through compressed experts: the expert
     backward (``ops.spmm_t_experts``, dx, and
     ``bsr_weight_grad_experts``, dw: one launch each of
     ``csrc/bsr_experts_bwd.cu`` for all 64 experts, on each expert's
     occupied rows) on layer 0's three projections of phase 13's model
     (bf16 store) at M = 80 (a debias step's capacity) and 8, bf16 and
     f32, every row and the rows layer 0's router fills, each held to its
     plain version with the same counts (dx zero past each count, every
     padded slot and every expert without a token zero in dw); at ewi
     timed beside the plain version, ``torch.bmm`` on the densified
     experts or a dense dW, and its bound (on the occupied rows where
     routed), and at M = 80, bf16, every row, 64 single-expert launches;
     SpC-Retrain (``train/loop.run_spc_retrain_pipeline`` with the plan's
     group-l1 prox) at full width on 2 of 16 layers in bf16, from weights
     whose blocks have spread norms: step times, peak memory, the expert
     block sparsity (0.8-0.95), the seconds of ``compress_params``, the
     launch counters per debias step (3 launches of each expert kernel
     and 9 of each single-matrix kernel a step), then ``generate``; debias
     at full width and depth on phase 13's model (48 launches of each
     expert kernel and 65 of each single-matrix one a step), one step
     profiled; in f32 at 2 layers, the kernel path against the plain path
     over 3 debias steps (every kernel call held to its plain version;
     router flips counted; losses, step 1's dx and dw per expert slice,
     and the stores' updates); and ``launch/train --reduced --sparse`` on
     reduced olmoe from a planted checkpoint (its experts compress) and
     ``launch/serve --sparse --ckpt-dir`` on its checkpoint;
 14. flash attention: the kernel against its plain version at
     recurrentgemma-9b's local attention (S 4096, window 2048) and
     smollm-360m's prefill, causal, not causal and windowed, bf16 and
     f32, timed beside the plain version, ``scaled_dot_product_attention``
     (which the port never calls) and its bound; then its entry point
     ``ops.flash_attention`` (no model code calls it: the serving and
     training phases launch it 0 times);
 14b. cnn, the paper's pipeline: ``launch/paper_cnn`` at its full
     constants (LeNet-5: reference, SpC, SpC(Retrain), Pru, Pru(Retrain)
     and MM; 250 and 100 steps) on the card, its table printed, with
     6 x 700 prox_adam launches and no other kernel; a cut
     ``spc_with_retrain`` on LeNet-5 (20 + 10 steps, f32, cuDNN
     deterministic) with every prox_adam call on the kernel and held
     bit-equal to its plain version, against the same run on the plain
     version: losses per step, compression rates and params equal; one
     SpC step at batch 128 of each net at full width (LeNet-5, AlexNet,
     VGG16, ResNet-32): step time, peak memory, one launch a leaf; and
     prox_adam at LeNet-5's fc1 and VGG16's largest filter against its
     plain version and its bytes bound (kernel-table row 5c);
 15. the kernel table (one JSON line: the decode spmm kernels at
     smollm-360m's decode, the tile kernels at recurrentgemma-9b's prefill
     tick (palette-4 at smollm-360m's M = 512), the paged kernel at a
     decode and a prefill tick of the smollm-360m mix and at
     recurrentgemma-9b's prefill tick, flash at recurrentgemma-9b's local
     attention and smollm-360m's prefill, the expert launch at
     olmoe-1b-7b's ewi (rows 1e / 2e) and the expert backward there (rows
     1be / 4e), the single-matrix backward at recurrentgemma-9b's mlp.wi
     (rows 1br / 4r), prox_adam at the CNN leaves (row 5c), with the spmm
     and paged bounds also at the bf16 tensor-core rate) and the contract
     line.

It imports nothing of JAX or of the JAX package, and exits with an error
when no CUDA device is visible.
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import faulthandler
import functools
import gc
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
from repro_torch.data.synthetic import image_batch  # noqa: E402
from repro_torch.launch import paper_cnn, serve, train  # noqa: E402
from repro_torch.models.cnn import CNN_ZOO  # noqa: E402
from repro_torch.models.cnn import weight_count as cnn_weight_count  # noqa: E402
from repro_torch.train import cnn as cnn_train  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.obs.profile import Profiler  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve.engine import HOST_LOCK, EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.router import Router  # noqa: E402
from repro_torch.serve.step import generate  # noqa: E402
from repro_torch.sparse import ops as sparse_ops  # noqa: E402
from repro_torch.core.metrics import model_size_bytes, tree_leaves  # noqa: E402
from repro_torch.sparse.compress import (CompressionPlan,  # noqa: E402
                                         _prune_blocks_2d,
                                         bcsr_equiv_size_bytes,
                                         compressed_size_bytes,
                                         init_compressed, iter_bcsr,
                                         make_plan_prox, quantize_bcsr,
                                         quantize_compressed, split_trainable)
from repro_torch.core.tree import flatten_with_path, keystr, tree_map  # noqa: E402
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
QUEUED_LAUNCHES = 600         # launches queued at most by one time_ms
PLAIN_ADAM_OPS = 18           # kernels of the plain prox_adam on one leaf
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
# the first 4 of the 32 layers (the same weights), to keep the whole script
# within its time limit; the bf16 main-path runs keep all 32.
SMOLLM_F32_LAYERS = 4

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
# The router phase: the engine mix through N replicas (one worker thread
# and CUDA stream each) at full depth in bf16; the CLI runs serve the
# whole mix, the Router.build runs its first ROUTER_REQUESTS requests (cut
# from 16 to keep the script within its time limit). The fleet's streamed
# tokens (of 128) mark two windows: ROUTER_BUSY_WINDOW, where
# torch.profiler alone records the device (the busy share), and
# ROUTER_COUNT_WINDOW, where the kernel-call profiler's counts are held to
# the launch counters.
# Router.build may grow device memory by the replicas' pools and at most
# ROUTER_MEM_SLACK more (the allocator rounds each of a replica's 64 pool
# tensors up to 512 bytes; 4 MiB is far above that); serving N replicas
# may add at most N times what one replica's serving adds, and
# ROUTER_MEM_SLACK. Failover fails replica 0 once it has streamed
# ROUTER_FAIL_AFTER tokens.
ROUTER_REPLICAS = (2, 4)
# the replicas the CLI runs serve the mix with (Router.build runs N = 1 and
# ROUTER_REPLICAS)
ROUTER_CLI_REPLICAS = (4,)
ROUTER_REQUESTS = 4
ROUTER_BUSY_WINDOW = (32, 48)
ROUTER_COUNT_WINDOW = (64, 80)
ROUTER_MEM_SLACK = 4 * 2**20
ROUTER_TRACE_ENTRIES = 3_000_000     # the allocator trace of the N = 2 run
ROUTER_TRACE_REPLICAS = 2
ROUTER_FAIL_AFTER = 4
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
# The mesh phase: --mesh 2,2 (4 ranks, one process each, sharing the card;
# their collectives go through gloo) against --mesh none. Serving: the
# model phase's BlockCSR model from a checkpoint, MESH_GEN new tokens at
# batch 4, bf16 at full depth and f32 at MESH_F32_LAYERS layers; the engine
# on MESH_ENGINE_PROMPTS. Training: launch/train --sparse at full width cut
# to MESH_TRAIN_LAYERS layers in f32, MESH_SPC SpC and MESH_DEBIAS debias
# steps from a planted step-1 checkpoint. The expert-parallel MoE at
# olmoe-1b-7b's width, one layer, f32, on mesh MESH_EP_SHAPE (the first 2
# ranks), MESH_EP_BATCH tokens.
MESH, MESH_SHAPE, MESH_RANKS = "2,2", (2, 2), 4
MESH_GEN = 2
MESH_F32_LAYERS = 2
MESH_ENGINE_PROMPTS = (16, 48)
MESH_TRAIN_LAYERS, MESH_SPC, MESH_DEBIAS = 2, 3, 2
MESH_EP_SHAPE, MESH_EP_BATCH = (1, 2), 64
# the expert-parallel y against the single-program y: 1e-4 of the largest
# |y| (the reference's 1e-4 at its reduced width, where |y| is about 1; the
# seed-0 init at full width gives |y| in the hundreds, and the two paths
# sum each token's k expert outputs in another order)
MESH_EP_RTOL = 1e-4
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
# rwkv6-3b's f32 checks run its first 4 of 32 layers (the same weights),
# to keep the whole script within its time limit
RWKV_F32_LAYERS = 4

# The MoE family at full width and depth: olmoe-1b-7b (16 layers, d 2048,
# 16 heads of 128 with QK-norm, 64 experts of d_ff 1024, top-8, vocab
# 50,304). The expert launch's rows: a generate decode step's capacity (8
# rows an expert at batch 4), an engine decode tick's (8), a prefill's of
# 64 tokens (16), and an engine prefill tick's of 256 tokens (40: the tile
# kernel); M = 1 for a single sequence.
MOE = "olmoe-1b-7b"
MOE_M = (1, 8, 16, 40)
MOE_TIMED_CALLS = 30
MOE_YARDSTICK_CALLS = 5
# the 64 single-expert launches, timed beside the expert launch at this M
# only (their times at the other M stand in PERF.md)
MOE_SINGLES_M = 8
# the expert launch on the rows a router fills: at these M, bf16 x, each
# expert's count of M random tokens routed by layer 0's router (the
# capacity factor E / top_k makes the buffer M rows an expert)
MOE_ROUTED_M = (8, 40)
MOE_ROUTED_SEED = 24
# its f32 checks run the first 2 of 16 layers (the same weights)
MOE_F32_LAYERS = 2
# generate and the engine through the serving CLI: the first 8 of 16
# layers at full width (the CLI builds and compresses its model each run)
MOE_SERVE_LAYERS = 8
# a router near tie: the k-th minus the (k+1)-th prob of some token below
# this, in some layer; past it a greedy token may differ in f32
MOE_ROUTER_TIE = 1e-5
MOE_PROFILE_TICKS = (20, 26)
# MoE training (olmoe-1b-7b). The expert backward's rows: a debias step's
# capacity at batch 8 x 64 (int(1.25 * 512 * 8 / 64) = 80 rows an expert)
# and the floor of moe._capacity (8); rows 1be / 4e of the kernel table at
# ewi, M = 80, bf16.
MOE_TRAIN_M = (80, 8)
MOE_TRAIN_TABLE = ("ewi", 80, torch.bfloat16)
# the routed rows of the expert backward: the tokens whose capacity is
# each M (a debias step's 512, and 48, whose capacity is the floor 8),
# routed by layer 0's router from random token ids
MOE_TRAIN_TOKENS = {80: 512, 8: 48}
# SpC-Retrain at full width runs the first 2 of 16 layers: an f32 master,
# Adam's two moments, the grads and the bf16 casts of all 16 (6.92 B
# parameters) would pass the card's 80 GB; of 2 layers (1.05 B) they take
# about 19 GB. Debias starts from the compressed model, which fits at full
# depth (3.17 GB of BCSR and residue).
MOE_TRAIN_LAYERS = 2
# launch/train --sparse on a reduced model (olmoe's experts of 64 x 64, the
# recurrent families) from a planted checkpoint: (8, 16) blocks at lr 3e-3;
# the group-l1 threshold lr * lam (0.06) must pass lr sqrt(8 * 16) (0.034),
# the norm one Adam step gives a zeroed block, or pruned blocks grow back
# and nothing compresses.
CLI_BLOCK, CLI_LR, CLI_LAM = (8, 16), 3e-3, 20.0
CLI_STEPS, CLI_DEBIAS, CLI_GEN = 6, 3, 8
# Recurrent-family training. SpC-Retrain at full width runs a cut depth:
# recurrentgemma-9b's first super-block (3 layers: RG-LRU, RG-LRU, local
# attention; with the tied 256,000 x 4096 embedding 1.64 B parameters,
# whose f32 master, Adam's moments and grads take about 26 GB), rwkv6-3b's
# first 2 of 32 layers; the f32 kernel-against-plain check runs the same
# cut. Debias runs the serving phase's 0.9-pruned model at full depth. The
# block sparsity is held over the recurrent projections (``where``). Rows
# 1br / 4r of the kernel table: spmm_t and the SDDMM at recurrentgemma-9b's
# layer-0 mlp.wi, (12288, 4096), M = 512, bf16; launches per full-depth
# debias run.
RECURRENT_TRAIN_LAYERS = {HYBRID: 3, RWKV: 2}
RECURRENT_WHERE = {HYBRID: ("/rec/",), RWKV: ("/tm/", "/cm/")}
# launch/train --reduced --sparse compresses every recurrent projection:
# recurrentgemma-9b's 3 in each of its 2 stacked and 2 remainder RG-LRU
# layers, rwkv6-3b's 5 time-mix and 3 channel-mix stacks
RECURRENT_CLI_COMPRESSED = {HYBRID: 12, RWKV: 8}
RECURRENT_TRAIN_TABLE = ("layers/b0_rglru/mlp/wi", torch.bfloat16)
# The paper's CNN pipeline (launch/paper_cnn at its constants: LeNet-5;
# reference, SpC and Pru(Retrain)'s steps and SpC(Retrain)'s take one
# prox_adam launch a step over all 6 leaves; MM launches none). The kernel
# path against the plain path runs a cut spc_with_retrain (20 + 10 steps,
# every one of LeNet-5's 6 leaves held a step); one SpC step is timed per
# net at batch 128 (leaves: weights and biases; at most 35, ResNet-32's,
# so one launch a step).
CNN_RUN_LAUNCHES = 2 * paper_cnn.STEPS + 2 * paper_cnn.RETRAIN_STEPS
CNN_CUT = (20, 10)
CNN_LENET_LEAVES = 6
CNN_BATCH, CNN_TIMED_STEPS = 128, 5
# row 5c: prox_adam at LeNet-5's fc1 and VGG16's largest filter (HWIO)
CNN_ADAM_LEAVES = (("lenet5 fc1/w", (800, 500)),
                   ("vgg16-cifar conv4-2/w", (3, 3, 512, 512)))
# row 5s: one step's update over every leaf of these nets, as one launch
CNN_STEP_NETS = ("lenet5", "resnet32-cifar")

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


def queued_calls(launches: int) -> int:
    """Timed calls for ``time_ms`` of a function that makes ``launches``
    launches a call: at most QUEUED_LAUNCHES in all. The driver queues
    about a thousand launches before the host blocks; past that the host
    enqueues while the device runs, and the events time the host."""
    return max(1, min(TIMED_CALLS, QUEUED_LAUNCHES // max(launches, 1)))


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


def _serve_run(extra: list, arch: str = ARCH, lines=None) -> dict:
    """One run of the serving CLI on the card; the launch counters are set
    to 0 just before it and read just after. ``lines``, where given, takes
    the run's printed lines."""
    argv = ["--arch", arch, "--sparse", "--batch", str(BATCH), "--prompt-len",
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
    if lines is not None:
        lines.extend(text)
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
    first) of a finished ``torch.profiler`` run. The runs record device
    activity only: no row here reads the host's operator events, and they
    would add several events a kernel to the trace the profiler parses."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]   # step annotations
    if not rows:
        raise SystemExit("the profiler recorded no device kernel")
    attr = ("self_device_time_total" if rows and hasattr(rows[0], "self_device_time_total")
            else "self_cuda_time_total")
    rows = sorted(((getattr(e, attr) / 1e3, e.count, e.key) for e in rows),
                  reverse=True)
    return sum(r[0] for r in rows) / 1e3, rows


# the block-sparse kernels (csrc/bsr_spmm.cu, bsr_spmm_experts.cu,
# bsr_sddmm.cu, bsr_experts_bwd.cu) by the names the profiler shows
SPMM_KERNELS = (("decode spmm", "decode_fwd"), ("tile spmm", "bsr_tile_fwd"),
                ("expert spmm", "bsr_experts_fwd"), ("spmm_t", "bsr_tile_bwd"),
                ("sddmm", "sddmm_tile_kernel"), ("expert spmm_t",
                                                 "bsr_experts_dx"),
                ("expert sddmm", "bsr_experts_dw"))


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
    log(f"  block-sparse kernels: {', '.join(sums)}")


def _profile(what: str, n_tokens: int, run, top: int) -> None:
    """Where ``run()``'s time goes: the device time of every kernel
    (torch.profiler) against the wall time of the same call unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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

    def held(x, w, backend, rows=None):
        y = forward(x, w, backend, rows)
        if backend == "cuda":
            palette = isinstance(w, PaletteBCSR)
            if x.dim() == 3:                 # an MoE layer's experts
                want = (ref.spmm_palette_experts_fwd_ref if palette
                        else ref.spmm_experts_fwd_ref)(x, w, rows)
            else:
                want = (ref.spmm_palette_fwd_ref if palette
                        else ref.spmm_fwd_ref)(x, w)
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


def _engine_cli_run(tag: str, extra: list, req_file: Path,
                    arch: str = ARCH) -> tuple:
    """One run of ``launch/serve --engine`` on the card; the launch counters
    are set to 0 just before it and read just after."""
    argv = ["--arch", arch, "--sparse", "--engine", "--requests",
            str(req_file), *ENGINE_FLAGS, "--block", *map(str, BLOCK),
            "--sparsity", str(SPARSITY), "--metrics-out",
            str(OUT_DIR / f"engine_{tag}.prom"), "--trace-out",
            str(OUT_DIR / f"engine_{tag}.trace.json"), *extra]
    buf = io.StringIO()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    paged_ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = serve.main(argv)
    torch.cuda.synchronize()
    counts = {**ops.launches, **ops.variant_launches, **paged_ops.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"serve {' '.join(argv)}")
    for line in buf.getvalue().splitlines()[-6:]:
        log(f"  {line}")
    s = out["stats"]
    log(f"  launches {counts}, peak memory {peak / 2**30:.2f} GiB ("
        f"{before} bytes allocated before the run), run "
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


def _engine_config(requests, **kw) -> EngineConfig:
    return EngineConfig(max_batch=MAX_BATCH, prefill_chunk=CHUNK,
                        page_size=PAGE, max_seq_len=max(
                            len(r.prompt) + r.max_new_tokens
                            for r in requests), **kw)


def _engine(model, params, requests, **kw) -> ServeEngine:
    return ServeEngine(model, params, _engine_config(requests, **kw))


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
    with profile(activities=[ProfilerActivity.CUDA],
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
        if fmt == "bcsr":
            single = {"stats": s, "peak": peak}

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
            if fmt == "bcsr":
                single.setdefault("generate", {})[rid] = ref_toks.tolist()
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
    return main_counts, single


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def _router_cli_run(n: int) -> dict:
    """The engine mix through ``launch/serve --engine --replicas n --route
    least-loaded`` (bf16 BCSR, full depth): the fleet's stats, launch
    counters held to the replicas' ticks, peak memory."""
    counts, s, peak = _engine_cli_run(
        f"router{n}", ["--replicas", str(n), "--route", "least-loaded"],
        OUT_DIR / "engine_requests.json")
    ticks = [r["n_ticks"] for r in s["per_replica"]]
    layers = get_config(ARCH).n_layers
    if s["n_replicas"] != n or s["n_failed_replicas"] or \
            counts["paged_flash_fwd"] != layers * sum(ticks) or \
            counts["spmm"] != 7 * layers * sum(ticks) or \
            counts["spmm_palette"]:
        raise SystemExit(f"router {n}: launches {counts} over ticks {ticks}, "
                         f"expected {layers * sum(ticks)} paged and "
                         f"{7 * layers * sum(ticks)} spmm; stats {s}")
    return {"stats": s, "ticks": ticks, "peak": peak, "counts": counts}


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_busy(prof, path: Path) -> tuple:
    """(summed device seconds, seconds the device ran any kernel, copy or
    memset, {kernel name: count}) of a finished ``torch.profiler`` run,
    read from its Chrome trace (written to ``path``: kineto writes it
    natively, faster than Python builds an event for each). Replicas' work
    overlaps on their streams, so the busy time is the union of the
    events' intervals, not their sum."""
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not events:
        raise SystemExit("the profiler recorded no device kernel")
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events)
    total = sum(b - a for a, b in spans)
    union, (lo, hi) = 0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            union, lo = union + hi - lo, a
        hi = max(hi, b)
    kernels = collections.Counter(e["name"] for e in events
                                  if e["cat"] == "kernel")
    return total / 1e6, (union + hi - lo) / 1e6, kernels


class _Marks:
    """Marks on a fleet's streamed tokens: ``stream``, the router's stream
    callback (it runs in the event loop thread), counts every token of
    the fleet; ``await reached(k)`` returns once the k-th has streamed, and
    ``at[k]`` is the host clock then."""

    def __init__(self, *ks):
        self.n = 0
        self.at = {}
        self._reached = {k: asyncio.Event() for k in ks}

    def stream(self, event) -> None:
        self.n += 1
        if self.n in self._reached:
            self.at[self.n] = time.perf_counter()
            self._reached[self.n].set()

    async def reached(self, k: int) -> None:
        await self._reached[k].wait()


def _router_flow(fleet, waves, stream=None, fail=None, during=None) -> tuple:
    """Serve ``waves`` (lists of requests, each awaited before the next)
    through ``fleet``: (completions, the wall time from the first submit
    to the last completion). ``stream`` gets every ``StreamEvent``;
    ``fail`` = (replica, tokens) arms a failure; ``during`` (a coroutine
    function) runs beside the first wave."""
    async def flow():
        await fleet.start()
        if fail is not None:
            fleet.fail_replica_after(*fail)
        t0 = time.perf_counter()
        comps = []
        for i, wave in enumerate(waves):
            futs = [await fleet.submit(r, stream=stream) for r in wave]
            if i == 0 and during is not None:
                await during()
            comps += await asyncio.gather(*futs)
        wall = time.perf_counter() - t0
        await fleet.stop()
        return comps, wall

    return asyncio.run(flow())


def _router_run(model, params, requests, n: int) -> dict:
    """The engine mix through ``Router.build(..., n)`` (least-loaded),
    unprofiled: the fleet's stats, the host clock at the busy window's
    marks, and how far allocated device memory rose while serving above
    what it was after the build (weights, head memo, pools)."""
    fleet = Router.build(model, params, _engine_config(requests), n,
                         policy="least-loaded")
    marks = _Marks(*ROUTER_BUSY_WINDOW)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    comps, wall = _router_flow(fleet, [requests], marks.stream)
    s = fleet.fleet_stats(wall, comps)
    first, last = ROUTER_BUSY_WINDOW
    return {"stats": s, "ticks": [r["n_ticks"] for r in s["per_replica"]],
            "base": base, "rise": torch.cuda.max_memory_allocated() - base,
            "busy_wall": marks.at[last] - marks.at[first]}


def _live_at_peak(trace) -> tuple:
    """(peak bytes, live allocations at the peak) of a caching-allocator
    trace (``torch.cuda.memory._snapshot()["device_traces"][0]``), counting
    only the blocks allocated while it recorded. A block stops counting
    as allocated when its free is requested."""
    cur = peak = 0
    at = -1
    live = {}
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            cur += e["size"]
            if cur > peak:
                peak, at = cur, i
        elif e["action"] in ("free_requested", "free_completed"):
            cur -= live.pop(e["addr"], 0)
    live = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] in ("free_requested", "free_completed"):
            live.pop(e["addr"], None)
    return peak, list(live.values())


def _alloc_site(e) -> str:
    """The innermost line of the port that asked for allocation ``e``."""
    for f in e.get("frames", ()):
        if "repro_torch" in f["filename"]:
            return (f"{f['filename'].split('repro_torch/')[-1]}:{f['line']} "
                    f"{f['name']}")
    return "outside the port"


def _router_memory(model, params, requests, n: int) -> dict:
    """The engine mix through ``Router.build(..., n)`` with the caching
    allocator's trace on from after the build: the live allocations at
    the serving peak, by stream (a replica's, or the default) and by the
    line of the port that allocated them."""
    fleet = Router.build(model, params, _engine_config(requests), n,
                         policy="least-loaded")
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python",
        max_entries=ROUTER_TRACE_ENTRIES)
    try:
        _router_flow(fleet, [requests])
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    if len(trace) >= ROUTER_TRACE_ENTRIES:
        raise SystemExit(f"router {n}x memory: the allocator's trace "
                         f"filled its {ROUTER_TRACE_ENTRIES} entries")
    peak, live = _live_at_peak(trace)
    names = {0: "default"}
    names.update({rep.stream.cuda_stream: f"replica {rep.idx}"
                  for rep in fleet.replicas})
    by_stream = collections.Counter()
    by_site = collections.Counter()
    n_site = collections.Counter()
    for e in live:
        by_stream[names.get(e["stream"], str(e["stream"]))] += e["size"]
        by_site[_alloc_site(e)] += e["size"]
        n_site[_alloc_site(e)] += 1
    log(f"router {n}x memory: {len(trace)} allocator events; at the "
        f"serving peak {peak} bytes live above the build, in {len(live)} "
        f"blocks; by stream {dict(by_stream.most_common())}; by line:")
    for site, nbytes in by_site.most_common(8):
        log(f"  {nbytes} bytes in {n_site[site]} blocks: {site}")
    return {"peak": peak, "by_stream": dict(by_stream),
            "by_site": dict(by_site)}


def _router_window(model, params, requests, n: int) -> dict:
    """The engine mix through ``Router.build(..., n)`` (least-loaded) with
    two windows, each opened and closed while this thread holds
    ``HOST_LOCK`` and the device is synchronized, so no replica launches
    meanwhile (switching torch.profiler while two replicas launched ended
    the process). Over ROUTER_BUSY_WINDOW torch.profiler alone records
    the device: the busy share is the union of the window's device
    intervals over its wall time. Over ROUTER_COUNT_WINDOW the port's
    kernel-call profiler (``obs.profile.Profiler``, what ``--profile``
    prints) counts the kernel calls of every replica's thread, and the
    launch counters, set to 0 as the window opens and read as it closes,
    must equal its counts; the kernels in the busy window's trace are
    printed beside them."""
    from torch.profiler import ProfilerActivity, profile
    fleet = Router.build(model, params, _engine_config(requests), n,
                         policy="least-loaded")
    marks = _Marks(*ROUTER_BUSY_WINDOW, *ROUTER_COUNT_WINDOW)
    window = {}

    async def windows():
        first, last = ROUTER_BUSY_WINDOW
        await marks.reached(first)
        with HOST_LOCK:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            w0, k0 = time.perf_counter(), marks.n
        await marks.reached(last)
        with HOST_LOCK:
            torch.cuda.synchronize()
            w1, k1 = time.perf_counter(), marks.n
            prof.__exit__(None, None, None)
        await marks.reached(ROUTER_COUNT_WINDOW[0])
        with HOST_LOCK:
            torch.cuda.synchronize()
            ops.reset_launches()
            paged_ops.reset_launches()
            calls = Profiler().start()
        await marks.reached(ROUTER_COUNT_WINDOW[1])
        with HOST_LOCK:
            torch.cuda.synchronize()
            window["counts"] = {**ops.launches, **paged_ops.launches}
            calls.stop()
        window.update(prof=prof, calls=calls, wall=w1 - w0, tokens=k1 - k0)

    _router_flow(fleet, [requests], marks.stream, during=windows)
    dev_sum, busy, kernels = _device_busy(
        window["prof"], OUT_DIR / f"router{n}_window.trace.json")
    counts = window["counts"]
    summary = window["calls"].summary()
    profiled = {key: summary.get(name, {}).get("n_calls")
                for name, key in (("bsr_spmm/spmm", "spmm"),
                                  ("paged_attention/paged_flash_attention",
                                   "paged_flash_fwd"))}
    traced = {"spmm": sum(v for k, v in kernels.items()
                          if "decode_fwd" in k or "bsr_tile_fwd" in k),
              "paged_flash_fwd": sum(v for k, v in kernels.items()
                                     if "paged_flash_fwd" in k)}
    log(f"router {n}x busy window (streamed tokens {ROUTER_BUSY_WINDOW}): "
        f"{window['tokens']} tokens in {window['wall']:.3f} s, device time "
        f"{dev_sum:.4f} s summed, busy {busy:.4f} s, busy share "
        f"{busy / window['wall']:.3f}, the trace holds {traced}; count "
        f"window (streamed tokens {ROUTER_COUNT_WINDOW}): launch counters "
        f"{counts['spmm']} spmm, {counts['paged_flash_fwd']} paged; the "
        f"kernel-call profiler counted {profiled}")
    if any(profiled[k] != counts[k] or not counts[k] for k in profiled):
        raise SystemExit(f"router {n}x window: the profiler counted "
                         f"{profiled}, the launch counters {counts}")
    return {"busy": busy, "wall": window["wall"]}


def router_phase(dev, formats, single) -> None:
    """The router (``serve/router.py``): the engine mix through ``launch/
    serve --engine --replicas N --route least-loaded`` for N = 4 in bf16 at
    full depth, beside the engine phase's single engine; through
    ``Router.build`` for N = 1, 2 and 4 unprofiled (at N = 1 in turn with
    one engine, for the router's own cost; serving memory), with the allocator's trace at N = 2,
    and with the busy and count windows; the weights once
    (``Router.build`` grows device memory by the replicas' pools only);
    then in f32 at SMOLLM_F32_LAYERS layers, failover (replica 0 failed
    after 4 tokens) and the prefix route, against ``generate``."""
    phase("router: launch/serve --engine --replicas N (bf16, full depth)")
    cfg = get_config(ARCH)
    requests = _engine_requests(cfg.vocab)
    cli = {1: {"stats": single["stats"], "ticks": [single["stats"]["n_ticks"]],
               "peak": single["peak"]}}
    for n in ROUTER_CLI_REPLICAS:
        r = cli[n] = _router_cli_run(n)
        s = r["stats"]
        log(f"router N={n}: {s['tok_s']:.1f} tok/s, ttft p50/p95 "
            f"{s['ttft_p50_s'] * 1e3:.1f}/{s['ttft_p95_s'] * 1e3:.1f} ms, "
            f"ticks per replica {r['ticks']}, peak memory "
            f"{r['peak'] / 2**30:.2f} GiB, launches spmm {r['counts']['spmm']}"
            f" paged {r['counts']['paged_flash_fwd']}")

    phase("router: Router.build, unprofiled, N = 1, 2, 4, and one engine")
    requests = requests[:ROUTER_REQUESTS]
    log(f"the Router.build runs serve the mix's first {ROUTER_REQUESTS} "
        f"requests ({ROUTER_REQUESTS * ENGINE_GEN} new tokens)")
    model = build(cfg, device=dev)
    params = formats["bcsr"]
    bare, routed = [], []
    for bare_first in (True, False):      # engine, router, router, engine
        if bare_first:
            bare.append(_engine(model, params, requests).run(requests))
        routed.append(_router_run(model, params, requests, 1))
        if not bare_first:
            bare.append(_engine(model, params, requests).run(requests))
    bare_tok_s = [b["stats"]["tok_s"] for b in bare]
    routed_tok_s = [r["stats"]["tok_s"] for r in routed]
    log(f"one ServeEngine in this thread, then Router N=1, twice in turn: "
        f"{bare_tok_s[0]:.1f}, {routed_tok_s[0]:.1f}, {routed_tok_s[1]:.1f}"
        f", {bare_tok_s[1]:.1f} tok/s")
    runs = {1: routed[0]}
    runs.update((n, _router_run(model, params, requests, n))
                for n in ROUTER_REPLICAS)
    for n, r in runs.items():
        s = r["stats"]
        log(f"Router N={n}: {s['tok_s']:.1f} tok/s, ttft p50/p95 "
            f"{s['ttft_p50_s'] * 1e3:.1f}/{s['ttft_p95_s'] * 1e3:.1f} ms, "
            f"ticks per replica {r['ticks']}; allocated after the build "
            f"{r['base']} bytes, rose by {r['rise']} while serving")
    for n in ROUTER_REPLICAS:
        if runs[n]["rise"] > n * runs[1]["rise"] + ROUTER_MEM_SLACK:
            _router_memory(model, params, requests, n)
            raise SystemExit(
                f"router N={n}: serving raised allocated memory by "
                f"{runs[n]['rise']} bytes, more than {n} x one replica's "
                f"{runs[1]['rise']} and {ROUTER_MEM_SLACK} slack")
    mem = _router_memory(model, params, requests, ROUTER_TRACE_REPLICAS)

    phase("router: busy and count windows, N = 1, 2, 4")
    for n in (1, *ROUTER_REPLICAS):
        w = _router_window(model, params, requests, n)
        runs[n]["busy_share"] = w["busy"] / w["wall"]
        runs[n]["busy_share_unprofiled"] = w["busy"] / runs[n]["busy_wall"]
        log(f"router {n}x busy window: {w['wall']:.3f} s profiled, "
            f"{runs[n]['busy_wall']:.3f} s in the unprofiled run")
    log("router summary, bf16 BCSR at full depth, the engine mix: the CLI "
        "(N = 1 the engine phase's bare engine), then Router.build "
        "unprofiled, then the busy window's device busy time over its "
        "profiled wall and over the same tokens' unprofiled wall:")
    for n in (1, *ROUTER_REPLICAS):
        c, r = cli.get(n), runs[n]
        log(f"  N={n}: " + (f"CLI {c['stats']['tok_s']:.1f} tok/s, ttft p95 "
                            f"{c['stats']['ttft_p95_s'] * 1e3:.1f} ms, ticks "
                            f"{c['ticks']}, peak memory "
                            f"{c['peak'] / 2**30:.2f} GiB; " if c else
                            "no CLI run; ") + "Router "
            f"{r['stats']['tok_s']:.1f} tok/s, ttft p95 "
            f"{r['stats']['ttft_p95_s'] * 1e3:.1f} ms, ticks {r['ticks']}, "
            f"serving rise {r['rise'] / 2**20:.1f} MiB; busy share "
            f"{r['busy_share']:.3f} profiled, "
            f"{r['busy_share_unprofiled']:.3f} unprofiled")
    log(f"router: one engine's tok/s over Router N=1's, in turn in this "
        f"phase: {sum(bare_tok_s) / sum(routed_tok_s):.3f}; N = "
        f"{ROUTER_TRACE_REPLICAS}'s serving peak above the build: "
        f"{mem['peak']} bytes, {mem['by_stream']}")

    phase("router: the weights once")
    config = _engine_config(requests)
    for n in ROUTER_REPLICAS:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        fleet = Router.build(model, params, config, n)
        grown = torch.cuda.memory_allocated() - before
        pools = sum(fleet.replicas[0].engine.pool_bytes.values())
        weights = compressed_size_bytes(params)
        log(f"router N={n}: Router.build grew device memory by {grown} "
            f"bytes; {n} x pools {pools} = {n * pools}, slack "
            f"{ROUTER_MEM_SLACK}; the weights are {weights} bytes")
        if grown > n * pools + ROUTER_MEM_SLACK:
            raise SystemExit(f"router N={n}: Router.build grew memory by "
                             f"{grown} bytes, more than {n} pools of {pools} "
                             f"and {ROUTER_MEM_SLACK} slack")
        del fleet
    torch.cuda.empty_cache()

    phase("router: f32 failover and prefix route against generate")
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              n_layers=SMOLLM_F32_LAYERS)
    kernel_f32 = build(f32, device=dev)
    params = _cut_depth(params, f32.n_super_blocks)
    config = _engine_config(requests, attn_backend="cuda")
    fleet = Router.build(kernel_f32, params, config, 2,
                         policy="least-loaded")
    events = []
    comps, _ = _router_flow(fleet, [requests], events.append,
                            fail=(0, ROUTER_FAIL_AFTER))
    stats = fleet.fleet_stats(completions=comps)
    matched = 0
    for c in comps:
        rid = c.request_id
        idx = [e.index for e in events if e.request_id == rid]
        if idx != list(range(ENGINE_GEN)) or \
                [e.token for e in events if e.request_id == rid] != \
                list(c.tokens):
            raise SystemExit(f"router failover rid {rid}: stream indices "
                             f"{idx} for {len(c.tokens)} tokens")
        matched += _divergence_ok(kernel_f32, params, requests[rid].prompt,
                                  single["generate"][rid], c.tokens,
                                  f"router failover rid {rid}")
    log(f"router failover: {stats['n_failed_replicas']} failed replica, "
        f"{stats['n_redispatched']} re-dispatched, {matched}/"
        f"{len(requests) * ENGINE_GEN} tokens match generate, per replica "
        f"{[(r['n_requests'], r['n_ticks']) for r in stats['per_replica']]}")
    if stats["n_failed_replicas"] != 1 or stats["n_redispatched"] < 1 or \
            len(comps) != len(requests):
        raise SystemExit(f"router failover: {stats}")

    prefix_reqs = _prefix_requests(cfg.vocab)
    config = dataclasses.replace(config, prefix_cache=True, max_seq_len=max(
        len(r.prompt) + r.max_new_tokens for r in prefix_reqs))
    fleet = Router.build(kernel_f32, params, config, 2, policy="prefix")
    comps, _ = _router_flow(fleet, [prefix_reqs[:1], prefix_reqs[1:]])
    stats = fleet.fleet_stats(completions=comps)
    per = stats["per_replica"]
    matched = 0
    for c in comps:
        r = prefix_reqs[c.request_id]
        ref_toks = generate(kernel_f32, params, torch.tensor(
            r.prompt_ids, device=dev)[None], ENGINE_GEN)[0]
        matched += _divergence_ok(kernel_f32, params, r.prompt, ref_toks,
                                  c.tokens, f"router prefix rid {c.request_id}")
    log(f"router prefix route: per replica "
        f"{[(r['n_requests'], round(r['prefix_hit_rate'], 4)) for r in per]}"
        f", {stats['n_cached_tokens']} prompt tokens from cache, {matched}/"
        f"{len(prefix_reqs) * ENGINE_GEN} tokens match generate")
    if sorted(r["n_requests"] for r in per) != [0, len(prefix_reqs)] or \
            max(r["prefix_hit_rate"] for r in per) <= 0:
        raise SystemExit(f"router prefix route: {per}")
    del fleet, kernel_f32, params, model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the device mesh
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _cut_build(module, n_layers: int, f32: bool):
    """``module.build`` (a launcher's) giving the architecture cut to
    ``n_layers`` layers, and in f32 where ``f32``: the CLI then runs the
    first layers of whatever params it is given."""
    saved = module.build

    def cut(arch, reduced=False, device=None):
        m = saved(arch, reduced=reduced, device=device)
        cfg = dataclasses.replace(m.cfg, n_layers=n_layers, **(
            {"compute_dtype": "float32"} if f32 else {}))
        return build(cfg, device=m.device)

    module.build = cut
    try:
        yield
    finally:
        module.build = saved


def _mesh_record(fn) -> tuple:
    """``fn()`` with every launch counter set to 0 just before it and read
    just after; (its result, {seconds, launches, peak GiB})."""
    torch.cuda.synchronize()
    _reset_all()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"s": time.perf_counter() - t0,
                 "launches": {**_all_launches(), **ops.variant_launches},
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "before_gib": before / 2**30}


def _mesh_ranks(spec: dict) -> None:
    """The mesh phase's runs on each rank of one spawned 4-rank group: the
    launchers' ``--mesh`` runs join it. Every record is gathered to rank
    0, which writes them to ``spec["out"]``."""
    import torch.distributed as dist
    from repro_torch.distributed import parallel, sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe as moe_lib
    recs: dict = {}

    def run(tag, fn):
        out, rec = _mesh_record(fn)
        per = [None] * dist.get_world_size()
        dist.all_gather_object(per, rec)
        recs[tag] = per
        return out

    def tokens(out):
        return [[int(t) for t in row] for row in out.tolist()]

    res = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    res["a_bf16"] = tokens(run("a_bf16", lambda: serve.main(spec["a_bf16"])))
    with _cut_build(serve, MESH_F32_LAYERS, f32=True):
        res["a_f32"] = tokens(run("a_f32", lambda: serve.main(spec["a_f32"])))
    out = run("b_engine", lambda: serve.main(spec["b_engine"]))
    res["b_engine"] = _engine_tokens(out)
    mesh = mesh_lib.make_host_mesh(*MESH_SHAPE)
    with sharding.use_mesh(mesh):
        local = Checkpointer(spec["ckpt"]).restore_compressed(mesh=mesh)
    mine = {path: m.nbytes for path, m in iter_bcsr(local)}
    per = [None] * dist.get_world_size()
    dist.all_gather_object(per, mine)
    res["c_store_bytes"] = per
    res["c_axes"] = {path: mesh.layout[("bcsr", path)] for path in mine}
    del local
    with _cut_build(train, MESH_TRAIN_LAYERS, f32=True):
        cp, hist_spc, hist_db, _ = run("d_train",
                                       lambda: train.main(spec["d_train"]))
    res["d_losses"] = [h["loss"] for h in hist_spc + hist_db]
    if dist.get_rank() == 0:
        torch.save({path: m.data.cpu() for path, m in iter_bcsr(cp)},
                   spec["d_stores"])
    del cp
    torch.cuda.empty_cache()

    # (e) the expert-parallel MoE at olmoe-1b-7b's width, one layer, on the
    # first two ranks, against the single-program path on rank 0
    ep = mesh_lib.make_host_mesh(*MESH_EP_SHAPE)
    if ep is not None:
        cfg = dataclasses.replace(get_config(MOE), n_layers=1,
                                  compute_dtype="float32")
        dev = ep.device
        p = moe_lib.init_moe(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        x = torch.randn(MESH_EP_BATCH, cfg.d_model, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        x = x.reshape(4, -1, cfg.d_model)
        with sharding.use_mesh(ep), torch.inference_mode():
            local = sharding.shard_params({"moe": p}, ep)["moe"]
            hits = []
            saved = moe_lib._apply_moe_ep

            def counted(*a, **kw):
                hits.append(1)
                return saved(*a, **kw)
            moe_lib._apply_moe_ep = counted
            try:
                y_ep, aux_ep = moe_lib.apply_moe(
                    parallel.layer_view(local, "moe"), x, cfg)
            finally:
                moe_lib._apply_moe_ep = saved
        if ep.rank == 0:
            with torch.inference_mode():
                y, aux = moe_lib.apply_moe(p, x, cfg, impl="gspmd")
            res["e"] = {
                "ep_path": len(hits),
                "experts_per_rank": local["ewi"].shape[0],
                "y_err": float((y_ep - y).abs().max()),
                "y_max": float(y.abs().max()),
                "lb_err": abs(float(aux_ep["load_balance"])
                              - float(aux["load_balance"]))}
        del p, local, x
    torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        res["records"] = recs
        Path(spec["out"]).write_text(json.dumps(res))


def _engine_tokens(out: dict) -> list:
    """An engine run's tokens, request by request."""
    res = out["results"]
    return [[int(t) for t in res[i]] for i in range(len(res))]


def _mesh_counts(rec: dict) -> dict:
    keys = ("spmm", "spmm_palette", "spmm_t", "bsr_sddmm", "prox_adam",
            "paged_flash_fwd")
    return {k: rec["launches"].get(k, 0) for k in keys}


def mesh_phase(dev, cp) -> dict:
    """``--mesh 2,2``: 4 ranks on the card (one process each, spawned once;
    the collectives through gloo, as ranks that share a card take) serve
    a compressed checkpoint of the serving phase's model and train, each
    rank on its own shard, against the same runs in this process with
    ``--mesh none``."""
    phase(f"mesh: launch/serve and launch/train --mesh {MESH} on one card")
    t_phase = time.perf_counter()
    mdir = OUT_DIR / "mesh"
    if mdir.exists():
        import shutil
        shutil.rmtree(mdir)
    cdir = mdir / "serve_ckpt" / "compressed"
    Checkpointer(str(cdir)).save(1, cp, extra={
        "plan": dataclasses.asdict(cp.plan), "arch": ARCH, "reduced": False})
    tdirs = {tag: mdir / f"train_{tag}" for tag in ("none", "mesh")}
    for d in tdirs.values():
        _plant_checkpoint(dev, d, n_layers=MESH_TRAIN_LAYERS)
    req_file = mdir / "requests.json"
    req_file.write_text(json.dumps(
        [{"prompt_len": n, "gen": MESH_GEN} for n in MESH_ENGINE_PROMPTS]))
    log(f"saved the compressed checkpoint and planted two {MESH_TRAIN_LAYERS}"
        f"-layer train checkpoints in {time.perf_counter() - t_phase:.1f} s")

    def argv(tag: str, mesh: str, **kw) -> dict:
        serve_base = ["--arch", ARCH, "--sparse", "--ckpt-dir", str(cdir),
                      "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                      "--gen", str(MESH_GEN), "--mesh", mesh]
        return {
            "a_bf16": serve_base + ["--logits-out",
                                    str(mdir / f"a_bf16_{tag}.npy")],
            "a_f32": serve_base + ["--logits-out",
                                   str(mdir / f"a_f32_{tag}.npy")],
            "b_engine": serve_base + ["--engine", "--requests", str(req_file),
                                      *ENGINE_FLAGS],
            "d_train": ["--arch", ARCH, "--sparse", "--steps",
                        str(1 + MESH_SPC), "--debias-steps", str(MESH_DEBIAS),
                        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                        "--lr", str(TRAIN_LR), "--compress",
                        f"group_l1:{LAM}", "--block", *map(str, BLOCK),
                        "--log-every", "1", "--ckpt-dir", str(tdirs[tag]),
                        "--mesh", mesh]}

    # the same runs in this process, --mesh none
    single, srec = {}, {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        a = argv("none", "none")
        out, srec["a_bf16"] = _mesh_record(lambda: serve.main(a["a_bf16"]))
        single["a_bf16"] = out.tolist()
        with _cut_build(serve, MESH_F32_LAYERS, f32=True):
            out, srec["a_f32"] = _mesh_record(lambda: serve.main(a["a_f32"]))
        single["a_f32"] = out.tolist()
        out, srec["b_engine"] = _mesh_record(
            lambda: serve.main(a["b_engine"]))
        single["b_engine"] = _engine_tokens(out)
        with _cut_build(train, MESH_TRAIN_LAYERS, f32=True):
            (cp1, hs, hd, _), srec["d_train"] = _mesh_record(
                lambda: train.main(a["d_train"]))
        single["d_losses"] = [h["loss"] for h in hs + hd]
    for line in buf.getvalue().splitlines():
        if line.startswith(("generated", "engine:", "loss:")):
            log(f"  --mesh none: {line}")
    single_stores = {path: m.data for path, m in iter_bcsr(cp1)}
    single_sparsity = _block_sparsity(cp1)
    single_bytes = {path: m.nbytes for path, m in iter_bcsr(cp)}
    del cp1
    torch.cuda.empty_cache()
    t_single = time.perf_counter() - t_phase

    # the --mesh runs: one spawn of 4 ranks, each joined by the launchers
    from repro_torch.launch import mesh as mesh_lib
    spec = {**argv("mesh", MESH), "ckpt": str(cdir),
            "out": str(mdir / "ranks.json"),
            "d_stores": str(mdir / "d_stores.pt")}
    t0 = time.perf_counter()
    mesh_lib.run_ranks(_mesh_ranks, MESH_RANKS, "cuda", (spec,))
    t_mesh = time.perf_counter() - t0
    res = json.loads(Path(spec["out"]).read_text())
    recs = res["records"]
    log(f"{res['world']} ranks, backend {res['backend']} (ranks share the "
        f"card); the --mesh none runs {t_single:.1f} s, the spawned ranks' "
        f"runs {t_mesh:.1f} s")
    for tag in ("a_bf16", "a_f32", "b_engine", "d_train"):
        log(f"{tag}: one process {srec[tag]['s']:.1f} s, peak "
            f"{srec[tag]['peak_gib']:.2f} GiB ({srec[tag]['before_gib']:.2f} "
            f"allocated before the run), launches {_mesh_counts(srec[tag])}")
        for r, rec in enumerate(recs[tag]):
            log(f"  rank {r}: {rec['s']:.1f} s, peak {rec['peak_gib']:.2f} "
                f"GiB, launches {_mesh_counts(rec)}")

    # (a) prefill logits and greedy tokens, bf16 at full depth, f32 at
    # MESH_F32_LAYERS
    model = build(get_config(ARCH), device=dev)
    for tag, rtol, atol in (("a_bf16", BF16_LOGITS_RTOL, None),
                            ("a_f32", None, F32_LOGITS_ATOL)):
        one = np.load(mdir / f"{tag}_none.npy")
        got = np.load(mdir / f"{tag}_mesh.npy")
        err = float(np.abs(got - one).max())
        bound = rtol * float(np.abs(one).max()) if rtol else atol
        same = res[tag] == single[tag]
        log(f"(a) {tag}: prefill logits {got.shape}, max |mesh - one| "
            f"{err:.3e} (bound {bound:.3e}; bit-equal "
            f"{bool(np.array_equal(got, one))}), greedy tokens equal {same}")
        if not np.isfinite(got).all() or err > bound:
            raise SystemExit(f"(a) {tag}: logits off by {err}")
        if not same:
            if tag == "a_f32":
                raise SystemExit("(a) f32: greedy tokens differ")
            # bf16: held to a near tie of the one-process run, whose
            # prompt is the CLI's first draw from seed 0
            ckpt = Checkpointer(str(cdir)).restore_compressed(device=dev)
            prompts = torch.randint(0, model.cfg.vocab, (BATCH, PROMPT),
                                    generator=torch.Generator(
                                        device=dev).manual_seed(0),
                                    device=dev)
            for row in range(BATCH):
                _divergence_ok(model, ckpt, prompts[row], single[tag][row],
                               res[tag][row], f"(a) {tag} row {row}")
    # (b) the engine
    log(f"(b) engine: {len(res['b_engine'])} requests, tokens equal to one "
        f"process {res['b_engine'] == single['b_engine']}")
    if res["b_engine"] != single["b_engine"]:
        raise SystemExit("(b) engine tokens under the mesh differ")
    # (c) per rank: spmm launches per pass (generate's MESH_GEN passes and
    # the prefill of --logits-out), store bytes, peak memory
    passes = MESH_GEN + 1
    one_pp = srec["a_bf16"]["launches"]["spmm"] / passes
    log(f"(c) spmm launches per pass: one process {one_pp}, ranks "
        f"{[r['launches']['spmm'] / passes for r in recs['a_bf16']]}; "
        f"compressed store bytes one process {sum(single_bytes.values())}, "
        f"ranks {[sum(b.values()) for b in res['c_store_bytes']]}")
    by_axis: dict = {}
    for path, axis in res["c_axes"].items():
        by_axis.setdefault(str(axis), []).append(path)
    for axis, paths in sorted(by_axis.items()):
        names = sorted(".".join(p.split("/")[-2:]) for p in paths)
        ranks = [sum(b[p] for p in paths) for b in res["c_store_bytes"]]
        log(f"  leaves split over {axis}: {names}; bytes one process "
            f"{sum(single_bytes[p] for p in paths)}, ranks {ranks}")
    model_split = by_axis.get("model", [])
    half = [sum(b[p] for p in model_split) / max(sum(
        single_bytes[p] for p in model_split), 1)
        for b in res["c_store_bytes"]]
    if any(r["launches"]["spmm"] != srec["a_bf16"]["launches"]["spmm"]
           for r in recs["a_bf16"]) or not model_split or max(half) > 0.75:
        raise SystemExit("(c) the ranks' spmm launches differ from one "
                         "process's, or the model-split stores are not cut "
                         f"in about half ({half})")
    # (d) training: losses and stores, launches per rank
    l1, lm = single["d_losses"], res["d_losses"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(l1, lm))
    stores = torch.load(spec["d_stores"])
    srel = max(float((stores[p].to(dev) - single_stores[p]).norm()
                     / single_stores[p].norm()) for p in single_stores)
    log(f"(d) train: losses one process {[round(v, 6) for v in l1]}, mesh "
        f"{[round(v, 6) for v in lm]}; max relative {rel:.3e} (bound "
        f"{LOSS_RTOL}); stores after debias within {srel:.3e} of their norm "
        f"(bound {UPDATE_RTOL}); block sparsity one process "
        f"{single_sparsity[0]:.4f}")
    for r, rec in enumerate(recs["d_train"]):
        c = rec["launches"]
        # one prox_adam launch per optimizer step on each rank's shard
        if not (c["spmm_t"] and c["bsr_sddmm"]) or \
                c["prox_adam"] != MESH_SPC + MESH_DEBIAS:
            raise SystemExit(f"(d) rank {r} launched {c}, expected "
                             f"{MESH_SPC + MESH_DEBIAS} prox_adam")
    if rel > LOSS_RTOL or srel > UPDATE_RTOL:
        raise SystemExit("(d) mesh training left the one-process run")
    # (e) the expert-parallel MoE
    e = res["e"]
    bound = MESH_EP_RTOL * e["y_max"]
    log(f"(e) {MOE}, one layer, f32, dense experts on mesh {MESH_EP_SHAPE}: "
        f"expert-parallel path taken {e['ep_path']} time(s), "
        f"{e['experts_per_rank']} experts a rank; max |y_ep - y| "
        f"{e['y_err']:.3e} (|y| up to {e['y_max']:.3e}, bound {bound:.3e}); "
        f"load balance off by {e['lb_err']:.3e}")
    if e["ep_path"] != 1 or e["y_err"] > bound:
        raise SystemExit("(e) the expert-parallel MoE left the "
                         "single-program path")
    wall = time.perf_counter() - t_phase
    log(f"mesh phase {wall:.1f} s")
    return {"records": recs, "single": srec, "wall": wall}


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


def _bwd_kernel_rows(mat_name: str, w, dy, x,
                     plain_calls: int = TIMED_CALLS) -> dict:
    """The backward kernels on one weight ``w`` (bf16 store): ``spmm_t``
    (dX = dY W) and the SDDMM (dW at the resident slots), each against its
    plain version on the card, timed beside it (over ``plain_calls``
    calls: a plain version that densifies a large weight costs
    milliseconds a call, and ``time_ms`` holds the device for three times
    the host's time of the calls), a library yardstick (dense ``dY @ W``
    and ``dY' X`` in the operands' type, which the port never calls) and
    the least time the card could take; rows keyed (kernel, ``mat_name``,
    dtype)."""
    rows = {}
    n, k = w.shape
    dt = dy.dtype
    wd = bcsr_to_dense(w)[:n, :k].to(dt).contiguous()
    lib = str(dt).split(".")[-1]
    # spmm_t: dX = dY @ W
    err = _check(f"spmm_t {mat_name} {dt}", ops.spmm_t(dy, w),
                 ref.spmm_bwd_ref(dy, w), KERNEL_ATOL, KERNEL_RTOL)
    sets = copies(lambda: (dy.clone(), w.map(torch.clone)),
                  tensor_bytes(dy, w.data))
    row = {"kernel": "bsr_spmm_t", "matrix": mat_name, "shape": [n, k],
           "M": dy.shape[0], "dy": lib, "store": "bfloat16",
           "resident_blocks": int(w.gather_t_nnz.sum()),
           "max_abs_err": err, "atol": KERNEL_ATOL,
           "rtol": KERNEL_RTOL, "ms": time_ms(ops.spmm_t, sets),
           "plain_ms": time_ms(ref.spmm_bwd_ref, sets, plain_calls),
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
    sets = copies(lambda: (x.clone(), dy.clone(), w), tensor_bytes(x, dy))
    row = {"kernel": "bsr_sddmm", "matrix": mat_name, "shape": [n, k],
           "M": x.shape[0], "x": lib, "slots": int(w.data.shape[0]),
           "max_abs_err": err, "atol": SDDMM_ATOL, "rtol": SDDMM_RTOL,
           "ms": time_ms(sddmm_ops.bsr_weight_grad, sets),
           "plain_ms": time_ms(sddmm_ops.bsr_weight_grad_ref, sets,
                               plain_calls),
           "library_ms": time_ms(lambda a, b: torch.matmul(a.T, b),
                                 copies(lambda: (dy.clone(), x.clone()),
                                        tensor_bytes(x, dy))),
           "library": f"torch.matmul(dY', X) {lib} (dense dW)"}
    row.update(zip(("bound_ms", "bound_by", "bytes", "flops"),
                   _sddmm_bound(w, x, dy)))
    log(json.dumps(row))
    rows[("bsr_sddmm", mat_name, dt)] = row
    return rows


def _host_ms(fn, args, calls: int = 20) -> float:
    """Mean host-clock ms to enqueue one ``fn(*args)`` (no sync inside)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    dt = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return dt


def _tree_row(what: str, shapes, prox, sc, dev) -> dict:
    """One optimizer step's update over f32 leaves of ``shapes`` (the soft
    threshold where ``prox``): one tree call, held to one launch per K
    leaves and every leaf bit-equal to the plain version on its inputs;
    timed (CUDA events, cold in L2) as that call, as the same kernel
    launched one leaf at a time, and as the plain version, beside its
    bytes bound; the host ms to enqueue each form; and, for scale only,
    ``torch._fused_adam_`` over the same leaves (Adam without the prox: not
    the same function, so not the library column)."""
    numel = sum(math.prod(sh) for sh in shapes)

    def make():
        return ([torch.randn(sh, device=dev) for sh in shapes],
                [torch.randn(sh, device=dev) for sh in shapes],
                [torch.randn(sh, device=dev) * 0.1 for sh in shapes],
                [torch.rand(sh, device=dev) * 0.01 for sh in shapes])

    def tree(ws, gs, ms, vs):
        adam_ops.fused_tree_update(ws, gs, ms, vs, sc, prox=prox)

    def per_leaf(ws, gs, ms, vs):
        for w, g, m, v, p in zip(ws, gs, ms, vs, prox):
            adam_ops.fused_update_leaf(w, g, m, v, sc, apply_prox=p)

    def plain(ws, gs, ms, vs):
        adam_ops.fused_tree_update_ref(ws, gs, ms, vs, sc, prox=prox)

    steps = [torch.full((), 3.0, device=dev) for _ in shapes]

    def fused_adam(ws, gs, ms, vs):
        torch._fused_adam_(ws, gs, ms, vs, [], steps, lr=float(sc[0]),
                           beta1=0.9, beta2=0.999, weight_decay=0.0,
                           eps=1e-8, amsgrad=False, maximize=False)

    ws, gs, ms, vs = make()
    want = adam_ops.fused_tree_update_ref(ws, gs, ms, vs, sc, prox=prox)
    before = adam_ops.launches["prox_adam"]
    tree(ws, gs, ms, vs)
    launched = adam_ops.launches["prox_adam"] - before
    torch.cuda.synchronize()
    pairs = [(a, b) for leaf, out in zip(zip(ws, ms, vs), want)
             for a, b in zip(leaf, out)]
    err = max(float((a - b).abs().max()) for a, b in pairs)
    if launched != math.ceil(len(shapes) / adam_ops.K) or \
            not all(torch.equal(a, b) for a, b in pairs):
        raise SystemExit(f"prox_adam tree {what}: {launched} launches for "
                         f"{len(shapes)} leaves, max err {err} (bit-equal "
                         "expected)")
    args = (ws, gs, ms, vs)
    host = {"tree": _host_ms(tree, args), "per_leaf": _host_ms(per_leaf, args)}
    sets = copies(make, 16 * numel)
    leaves = len(shapes)
    row = {"kernel": "prox_adam", "tree": what, "leaves": leaves,
           "numel": numel, "launches_a_call": launched, "bit_equal": True,
           "max_abs_err": err, "ms": time_ms(tree, sets),
           "per_leaf_ms": time_ms(per_leaf, sets, queued_calls(leaves)),
           "plain_ms": time_ms(plain, sets,
                               queued_calls(PLAIN_ADAM_OPS * leaves)),
           "library_ms": None,
           "host_ms": host,
           "notes": {"torch._fused_adam_ ms (Adam, no prox; for scale)":
                     time_ms(fused_adam, sets)}}
    row.update(zip(("bound_ms", "bound_by", "bytes", "flops"),
                   _ops_bound(28 * numel, 10 * numel)))
    log(json.dumps(row))
    return row


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
            rows.update(_bwd_kernel_rows(mat_name, w, dy, x))
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
                   "plain_ms": time_ms(plain, sets,
                                       queued_calls(PLAIN_ADAM_OPS)),
                   "library_ms": None,
                   "library": "none: no single PyTorch call is Adam with a "
                              "soft threshold"}
            row.update(zip(("bound_ms", "bound_by", "bytes", "flops"),
                           _ops_bound(nbytes, 10 * numel)))
            log(json.dumps(row))
            rows[("prox_adam", leaf, apply_prox)] = row
    # the same leaves as one tree: one launch a step, beside row 5
    rows[("prox_adam_tree", "debias tree")] = _tree_row(
        "smollm-360m debias tree", [(n,) for n in leaf_sizes.values()],
        [True] * len(leaf_sizes), sc, dev)
    return rows


_PROJECTIONS = (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wi", "wg", "wo")),
                ("moe", ("ewi", "ewg", "ewo")),
                ("rec", ("lru_in", "lru_gate", "lru_out")),
                ("tm", ("rwkv_r", "rwkv_k", "rwkv_v", "rwkv_g", "rwkv_o")),
                ("cm", ("cm_k", "cm_v", "cm_r")))


def _projections(params):
    """The (in, out) view of every compressible projection: attention, MLP,
    the RG-LRU's and RWKV's time- and channel-mix projections of every
    stacked layer (the layer axis leads) and of every remainder layer,
    each expert of an MoE layer (the (L, E) axes lead), and an untied
    head."""
    for group, n_lead in (("layers", 1), ("rem", 0)):
        for layer in params.get(group, {}).values():
            for sub, names in _PROJECTIONS:
                for name in names:
                    t = layer.get(sub, {}).get(name)
                    if t is None:
                        continue
                    lead, s = t.shape[:n_lead], t.shape[n_lead:]
                    if sub == "attn" and name in ("wq", "wk", "wv"):
                        yield t.view(*lead, s[0], s[1] * s[2])
                    elif sub == "attn":
                        yield t.view(*lead, s[0] * s[1], s[2])
                    else:
                        yield t
    if "head" in params:
        yield params["head"]


def _spread_norms(params, block, gen) -> None:
    """Scale every block (``block`` on the (out, in) serving grid) of every
    compressible projection, in place, so that the block norms are spread
    log-uniformly over [SPREAD_LO, SPREAD_HI], as trained weights' are."""
    br, bc = block
    with torch.no_grad():
        for flat in _projections(params):
            norms = prox_lib._block_reduce_l2(flat, (bc, br))
            target = torch.exp(math.log(SPREAD_LO) + torch.rand(
                norms.shape, generator=gen, device=flat.device)
                * math.log(SPREAD_HI / SPREAD_LO))
            scale = target / norms.clamp_min(1e-30)
            full = scale.repeat_interleave(bc, -2).repeat_interleave(br, -1)
            flat.mul_(full[..., :flat.shape[-2], :flat.shape[-1]])


def _plant_checkpoint(dev, ckpt_dir: Path, arch: str = ARCH, block=BLOCK,
                      lr: float = TRAIN_LR, lam: float = LAM,
                      reduced: bool = False, n_layers=None) -> None:
    """A step-1 TrainState of ``arch`` (cut to ``n_layers`` where given)
    whose blocks have spread norms (``_spread_norms``), with the optimizer
    state ``launch/train --sparse`` builds, for the CLI to resume from."""
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build(arch, reduced=reduced, device=dev)
    if n_layers is not None:
        model = build(dataclasses.replace(model.cfg, n_layers=n_layers),
                      device=dev)
    params = model.init(gen)
    _spread_norms(params, block, gen)
    opt = optimizers.prox_adam(lr, lam=lam)
    Checkpointer(str(ckpt_dir)).save(1, TrainState(
        params=params, opt_state=opt.init(params), mask=None, step=1))


class _TimedWatchdog(train_loop.StragglerWatchdog):
    """Records every step's wall time, per phase (first instance: SpC)."""
    phases: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _TimedWatchdog.phases.append(self.times)


def _block_sparsity(cp, where=("",)) -> tuple:
    """(block sparsity, resident, total) over the compressed weights whose
    path holds one of the substrings ``where``, every stacked slice (layer,
    expert) counted."""
    resident = total = 0
    for path, m in iter_bcsr(cp):
        if any(w in path for w in where):
            resident += int(m.gather_nnz.sum())
            total += m.gather_nnz.numel() * m.block_grid[1]
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
    # one prox_adam launch per optimizer step: resumed from the planted
    # step 1, SPC_STEPS - 1 SpC steps, then the debias steps
    opt_steps = SPC_STEPS - 1 + DEBIAS_STEPS
    if counts["spmm"] != expect or counts["spmm_t"] != expect \
            or counts["bsr_sddmm"] != expect \
            or counts["prox_adam"] != opt_steps:
        raise SystemExit(f"train launches {counts}: expected {expect} spmm, "
                         f"spmm_t and bsr_sddmm and {opt_steps} prox_adam")
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

    def tapped(x, w, backend="auto", out_dtype=None, rows=None):
        return orig(_Tap.apply(x, sink), w, backend, out_dtype, rows)

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
                    kv_splits: int = 1) -> tuple:
    """One recurrent family at full width: the compressed model built on
    the card (BlockCSR, then palette-8); ``generate`` (batch 4, prompt 16,
    32 new tokens) and the engine on the request mix ``prompts`` in bf16,
    each with the launch counters set to 0 just before and read just
    after; where the time goes (torch.profiler); then in f32 the kernel
    path against the plain path and the engine against ``generate``, at
    the depth ``f32_layers`` (all layers when None). Returns (the results,
    the BlockCSR params, for the training phase; the palette-8 copy is
    freed)."""
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
    del p32
    torch.cuda.empty_cache()
    return result, cp


# ---------------------------------------------------------------------------
# the MoE family: olmoe-1b-7b at full width and depth
# ---------------------------------------------------------------------------

def _moe_bound(m_rows, w, x_dtype, bits):
    """``_bound`` for one expert launch: E problems of m_rows rows each,
    every expert's X and Y and palette, the resident blocks of all E
    slices, each multiplied by its own expert's rows only."""
    e = w.gather_nnz.shape[0]
    br, bc = w.block
    n_res = int(w.gather_nnz.sum())
    k_in, n_out = w.shape[1], w.shape[0]
    x_b = e * m_rows * k_in * torch.finfo(x_dtype).bits // 8
    blk_b = n_res * br * bc * (w.data.element_size() if bits is None
                               else bits / 8)
    pal_b = 0 if bits is None else e * (1 << bits) * 4
    tab_b = n_res * 8 + w.gather_nnz.numel() * 4
    nbytes = x_b + blk_b + pal_b + tab_b + e * m_rows * n_out * 4
    flops = 2 * m_rows * n_res * br * bc
    store = w.data.dtype if bits is None else torch.float32
    bound = _ops_bound(nbytes, flops, x_dtype, store)
    return bound + (_ops_bound(nbytes, flops, torch.bfloat16)[0],)


def _moe_routed_bound(counts, m_rows, w, x_dtype, bits):
    """``_moe_bound`` for the launch with each expert's occupied rows
    ``counts`` ((E,), on the host): the resident blocks, table entries and
    palette of the experts that hold a token, their occupied X rows, their
    Y rows (all m_rows of each: the rows past a count are written as
    zeros) and the products on occupied rows only."""
    br, bc = w.block
    held = counts > 0
    n_res = w.gather_nnz.sum(1).cpu().numpy()
    k_in, n_out = w.shape[1], w.shape[0]
    elt = w.data.element_size() if bits is None else bits / 8
    blk_b = int(n_res[held].sum()) * br * bc * elt
    pal_b = 0 if bits is None else int(held.sum()) * (1 << bits) * 4
    tab_b = int(n_res[held].sum()) * 8 + int(held.sum()) * w.gather_nnz.shape[1] * 4
    x_b = int(counts.sum()) * k_in * torch.finfo(x_dtype).bits // 8
    y_b = int(held.sum()) * m_rows * n_out * 4
    flops = 2 * int((counts * n_res).sum()) * br * bc
    store = w.data.dtype if bits is None else torch.float32
    nbytes = x_b + blk_b + pal_b + tab_b + y_b
    bound = _ops_bound(nbytes, flops, x_dtype, store)
    return bound + (_ops_bound(nbytes, flops, torch.bfloat16)[0],)


def _moe_routed_counts(dev, cp, cfg, tokens: dict) -> dict:
    """{M: (E,) int32 counts on the card}: for each M, the embeddings of
    ``tokens[M]`` random token ids (seed MOE_ROUTED_SEED) through layer 0's
    router and the MoE dispatch (``moe._dispatch``) at capacity M."""
    from repro_torch.models import moe as moe_lib
    gen = torch.Generator(device=dev).manual_seed(MOE_ROUTED_SEED)
    router = cp.dense["layers"]["b0_attn"]["moe"]["router"][0]
    emb = cp.dense["embed"]["embedding"]
    out = {}
    for m_rows, n_tok in tokens.items():
        ids = torch.randint(0, cfg.vocab, (n_tok,), generator=gen, device=dev)
        _, expert_idx, _ = moe_lib._router_and_aux(router, emb[ids], cfg.moe)
        _, counts = moe_lib._dispatch(expert_idx, cfg.moe.n_experts, m_rows)
        out[m_rows] = counts
        host = counts.cpu()
        log(f"{MOE}: layer 0's router over {n_tok} random tokens: "
            f"{int((host == 0).sum())} of {cfg.moe.n_experts} experts hold "
            f"0 rows, the largest count {int(host.max())} (capacity "
            f"{m_rows}); counts {host.tolist()}")
    return out


def _moe_expert_rows(dev, formats) -> dict:
    """Kernel-table rows 1e / 2e: the expert launch (``spmm_experts`` /
    ``spmm_palette_experts``, the kernel M picks) on layer 0's ewi, ewg and
    ewo, all 64 experts, at M = 1, 8, 16 (decode form) and 40 (the
    engine's prefill tick's capacity; tile form), bf16 and f32 x, the f32
    store, palette-8 and palette-4, every row of each expert's buffer
    computed (no counts: the kernel table's rows 1e / 2e). Each call held to the
    plain version (a loop of the single-matrix plain version over the
    experts) at KERNEL_ATOL / KERNEL_RTOL, and timed beside the plain
    version, ``torch.bmm`` of x in f32 on the densified f32 (E, K, N)
    weight (the library yardstick, which the port never calls), for
    information the bf16 ``torch.bmm`` on the bf16-rounded weight, at
    MOE_SINGLES_M the same work as 64 single-expert launches, and the
    bound. The two ``torch.bmm`` take x in f32 and in bf16 whatever its
    dtype, so they are timed once for each M and serve both x dtypes'
    rows. Then the routed rows (key (fmt, proj, M, "routed")): at
    MOE_ROUTED_M, bf16 x, the launch with the counts of
    ``_moe_routed_counts``, held to the plain version with the same counts
    and to exact zeros past each count, timed beside that plain version,
    with the routed bound and the full one."""
    gen = torch.Generator(device=dev).manual_seed(4)
    routed = _moe_routed_counts(dev, formats["bcsr"], get_config(MOE),
                                {m: m for m in MOE_ROUTED_M})
    rows = {}
    for fmt, bits in (("bcsr", None), ("pal8", 8), ("pal4", 4)):
        name = {"bcsr": "bsr_spmm_experts", "pal8": "bsr_spmm_palette8_experts",
                "pal4": "bsr_spmm_palette4_experts"}[fmt]
        plain = (ref.spmm_experts_fwd_ref if bits is None
                 else ref.spmm_palette_experts_fwd_ref)
        for proj in ("ewi", "ewg", "ewo"):
            w = formats[fmt].sparse["layers"]["b0_attn"]["moe"][proj][0]
            store = w.data if bits is None else w.codes
            e, (n, k) = w.gather_nnz.shape[0], w.shape
            timed = proj == "ewi"          # ewg and ewo: held to plain only
            wd = wb = None
            if timed:
                wd = torch.stack([bcsr_to_dense(w[i] if bits is None
                                                else w[i].dequantize())[:n, :k]
                                  for i in range(e)]).float() \
                    .transpose(1, 2).contiguous()          # (E, K, N)
                wb = wd.bfloat16()
            for m_rows in MOE_M:
                bmm_ms = {}
                for x_dtype in (torch.bfloat16, torch.float32):
                    x = torch.randn(e, m_rows, k, generator=gen,
                                    device=dev).to(x_dtype)
                    kern = ops.pick_kernel(m_rows)
                    fn = functools.partial(ops._fwd, kernel=kern)
                    err = _check(f"{name} {proj} M={m_rows} {x_dtype}",
                                 fn(x, w), plain(x, w), KERNEL_ATOL,
                                 KERNEL_RTOL)
                    row = {"kernel": name, "matrix": f"layer 0 moe.{proj}",
                           "experts": e, "matrix_shape": [n, k], "M": m_rows,
                           "x": str(x_dtype).split(".")[-1], "picked": kern,
                           "resident_blocks": int(w.gather_nnz.sum()),
                           "max_abs_err": err, "atol": KERNEL_ATOL,
                           "rtol": KERNEL_RTOL}
                    row.update(zip(("bound_ms", "bound_by", "bytes", "flops",
                                    "bound_bf16_ms"),
                                   _moe_bound(m_rows, w, x_dtype, bits)))
                    sets = None
                    if timed:
                        sets = copies(lambda: (x.clone(), w.map(torch.clone)),
                                      tensor_bytes(x, store))

                    def singles(xs, ws, kern=kern):
                        for i in range(xs.shape[0]):
                            ops._fwd(xs[i], ws[i], kern)

                    if timed and not bmm_ms:
                        bmm_ms = {
                            "library_ms": time_ms(torch.bmm, copies(
                                lambda: (x.float(), wd.clone()),
                                tensor_bytes(x, wd) * 2), MOE_YARDSTICK_CALLS),
                            "bf16_matmul_ms": time_ms(torch.bmm, copies(
                                lambda: (x.bfloat16(), wb.clone()),
                                tensor_bytes(x, wb) * 2), MOE_YARDSTICK_CALLS)}

                    if timed:
                        row.update(ms=time_ms(fn, sets, MOE_TIMED_CALLS),
                                   plain_ms=time_ms(plain, sets[:1], 1),
                                   **bmm_ms)
                        if m_rows == MOE_SINGLES_M:
                            row["singles_ms"] = time_ms(singles, sets,
                                                        MOE_YARDSTICK_CALLS)
                    log(json.dumps(row))
                    rows[(fmt, proj, m_rows, x_dtype)] = row
                    if m_rows in routed and x_dtype == torch.bfloat16:
                        rows[(fmt, proj, m_rows, "routed")] = _routed_row(
                            row, fn, plain, x, sets, w, routed[m_rows], bits)
                    del sets
            del wd, wb
            torch.cuda.empty_cache()
    return rows


def _routed_row(full: dict, fn, plain, x, sets, w, counts, bits) -> dict:
    """The routed row beside the full row ``full`` (input ``x``): the
    launch with each expert's occupied rows ``counts``, held to the plain
    version with the same counts at KERNEL_ATOL / KERNEL_RTOL and to exact
    zeros past each count; where ``sets`` (the full row's timed input
    sets) is given, timed beside that plain version, with the full row's
    time for comparison; its routed bound and the full row's."""
    what = f"{full['kernel']} {full['matrix']} M={full['M']} routed"
    got = fn(x, w, rows=counts)
    err = _check(what, got, plain(x, w, counts), KERNEL_ATOL, KERNEL_RTOL)
    host = counts.cpu()
    for i, r in enumerate(host.tolist()):
        if got[i, r:].any():
            raise SystemExit(f"{what}: expert {i} has nonzero rows past its "
                             f"count {r}")
    row = {**{k: full[k] for k in ("kernel", "matrix", "experts",
                                   "matrix_shape", "M", "x", "picked",
                                   "resident_blocks", "atol", "rtol")},
           "rows": "routed", "empty_experts": int((host == 0).sum()),
           "largest_count": int(host.max()), "occupied_rows": int(host.sum()),
           "max_abs_err": err, "full_bound_ms": full["bound_ms"]}
    if sets is not None:
        row.update(ms=time_ms(lambda xs, ws: fn(xs, ws, rows=counts), sets,
                              MOE_TIMED_CALLS),
                   plain_ms=time_ms(lambda xs, ws: plain(xs, ws, counts),
                                    sets[:1], 1),
                   full_ms=full["ms"], library_ms=full["library_ms"])
    row.update(zip(("bound_ms", "bound_by", "bytes", "flops", "bound_bf16_ms"),
                   _moe_routed_bound(host.numpy(), full["M"], w,
                                     torch.bfloat16, bits)))
    log(json.dumps(row))
    return row


def _per_pass(cp) -> tuple:
    """(spmm, expert spmm) launches of one forward pass of any family: a
    compressed matrix of the stacked layers once per layer, one of ``rem``
    or the head once, an expert stack once per layer for all its experts
    (0 for a family without experts)."""
    single = experts = 0
    for path, m in iter_bcsr(cp):
        n_layers = m.gather_nnz.shape[0] if path.startswith("layers/") else 1
        if "/moe/" in path:
            experts += n_layers
        else:
            single += n_layers
    return single, experts


@contextlib.contextmanager
def _router_probs(inputs=None):
    """Within the block, the f32 router probs of every MoE layer call, in
    order (appended to the yielded list); ``inputs``, where given, takes
    each call's router input (the normed hidden state) in f32."""
    from repro_torch.models import moe as moe_lib
    inner = moe_lib._router_and_aux
    seen = []

    def record(router_w, xt, e):
        with torch.no_grad():
            seen.append(torch.softmax(xt.float() @ router_w.float(), dim=-1))
        if inputs is not None:
            inputs.append(xt.detach().float())
        return inner(router_w, xt, e)

    moe_lib._router_and_aux = record
    try:
        yield seen
    finally:
        moe_lib._router_and_aux = inner


def _router_margin(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Per token: the k-th largest prob minus the (k+1)-th."""
    top = torch.topk(probs, k + 1, dim=-1).values
    return top[:, k - 1] - top[:, k]


def _router_flips(what: str, k: int, runs_a: tuple, runs_b: tuple) -> tuple:
    """(flips, first) between two runs' routers, each run given as (router
    probs, router inputs) layer by layer: flips counts the (token, layer)
    pairs whose top-k expert set differs; first describes the first layer
    with one: its index, its flips, the two runs' largest prob difference
    there and the smallest top-k margin (k-th minus (k+1)-th prob, run b)
    among its flipped tokens.

    Raises where the runs part otherwise than a near tie explains. Up to
    and including the first layer with a flip, no token has taken another
    expert yet, so the two runs' router inputs must agree within
    BF16_LOGITS_RTOL of run b's largest |input| in that layer. And in that
    layer a token's set can differ only where its margin is at most twice
    its own largest prob difference (an expert in one set and not the
    other lies at or below the k-th prob of one run and at or above the
    (k+1)-th of the other), up to f32 rounding. Past the first flip the
    runs' inputs differ by a whole expert's output."""
    flips, first = 0, None
    for layer, (pa, xa, pb, xb) in enumerate(zip(*runs_a, *runs_b)):
        if first is None:
            x_err = float((xa - xb).abs().max())
            x_bound = BF16_LOGITS_RTOL * float(xb.abs().max())
            if x_err > x_bound:
                raise SystemExit(
                    f"{what}: layer {layer}'s router inputs differ by "
                    f"{x_err:.3e} (bound {x_bound:.3e}) before any router "
                    "flip")
        sa = torch.topk(pa, k, dim=-1).indices.sort(-1).values
        sb = torch.topk(pb, k, dim=-1).indices.sort(-1).values
        differ = (sa != sb).any(-1)
        n = int(differ.sum())
        if n and first is None:
            diff = (pa - pb).abs().amax(-1)[differ]
            margin = _router_margin(pb, k)[differ]
            slack = 4 * torch.finfo(torch.float32).eps
            if bool((margin > 2 * diff + slack).any()):
                raise SystemExit(
                    f"{what}: layer {layer} routes a token elsewhere at a "
                    f"top-{k} margin above twice its prob difference "
                    f"(margins {margin.tolist()}, differences {diff.tolist()})")
            first = {"layer": layer, "flips": n,
                     "router_input_err": x_err, "router_input_bound": x_bound,
                     "max_prob_diff": float((pa - pb).abs().max()),
                     "min_margin": float(margin.min())}
        flips += n
    return flips, first


def _moe_bf16_check(what, kernel_model, plain_model, params, prompt) -> int:
    """The bf16 prefill at full depth: each kernel call held to its plain
    version on its inputs (``_held_calls``), then the logits within
    BF16_LOGITS_RTOL of the plain path's largest |logit| unless some
    router sent a token elsewhere on the two paths (two correct bf16 paths
    round one output a bf16 step apart, and where a router's k-th and
    (k+1)-th probs lie closer than that, the token takes another expert
    and its hidden state moves by a whole expert's output). Such a flip is
    accepted only as ``_router_flips`` holds it: the router inputs agree
    up to the first flip and the flipped tokens' margins are within what
    the prob difference explains. Flips are counted and printed, with the
    first layer where one happens. Returns the flips."""
    k = kernel_model.cfg.moe.top_k
    xk, xp = [], []
    with _held_calls(what) as errs, _router_probs(xk) as pk:
        lk = _prefill_logits(kernel_model, params, prompt)
    with _router_probs(xp) as pp:
        lr = _prefill_logits(plain_model, params, prompt)
    if not errs or not (torch.isfinite(lk).all()
                        and lk.shape == (prompt.shape[0],
                                         kernel_model.cfg.vocab)):
        raise SystemExit(f"{what}: no kernel call, or logits not finite or "
                         "misshapen")
    flips, first = _router_flips(what, k, (pk, xk), (pp, xp))
    err = float((lk - lr).abs().max())
    bound = BF16_LOGITS_RTOL * float(lr.abs().max())
    log(f"{what}: {len(errs)} kernel calls of the bf16 prefill held to their "
        f"plain versions, max |diff| {max(errs):.3e}; router top-{k} flips "
        f"between kernel and plain path: {flips} of {len(pk) * pk[0].shape[0]}"
        f" (token, layer) pairs, first {first}; bf16 prefill logits max "
        f"|kernel - plain| = {err:.3e} (bound {bound:.3e}; max |logit| "
        f"{float(lr.abs().max()):.3e})" + (
            "; the logits are held" if not flips else
            "; the logits are not held: a flipped token took other experts"))
    if not flips and err > bound:
        raise SystemExit(f"{what}: bf16 prefill logits disagree")
    return flips


def _moe_divergence_ok(model, params, prompt, ref_tokens, got_tokens,
                       what: str) -> int:
    """``_divergence_ok`` for an MoE model: a first difference is also
    accepted after a router near tie (some token's k-th minus (k+1)-th
    prob in some layer below MOE_ROUTER_TIE on the reference's sequence)."""
    ref_tokens = [int(t) for t in ref_tokens]
    got_tokens = [int(t) for t in got_tokens]
    if ref_tokens == got_tokens:
        return len(ref_tokens)
    t = next(i for i, (a, b) in enumerate(zip(ref_tokens, got_tokens))
             if a != b)
    with _router_probs() as probs:
        margin = _top2_margin(_logits_after(model, params,
                                            [int(x) for x in prompt],
                                            ref_tokens[:t]))
    router = min(float(_router_margin(p, model.cfg.moe.top_k).min())
                 for p in probs)
    log(f"{what}: first differs at step {t}, top-2 logit margin "
        f"{margin:.3e}, smallest router top-k margin {router:.3e}")
    if margin >= F32_LOGITS_ATOL and router >= MOE_ROUTER_TIE:
        raise SystemExit(f"{what}: greedy tokens differ away from a near-tie")
    return t


def _profile_counts(lines) -> dict:
    """{name: calls} from the ``--profile`` summary lines."""
    out = {}
    for line in lines:
        parts = line.split()
        if line.startswith("  ") and len(parts) > 2 and parts[2] == "calls":
            out[parts[0]] = int(parts[1])
    return out


def moe_phase(dev) -> dict:
    """olmoe-1b-7b at full width and depth (16 layers, d 2048, 16 heads of
    128 with QK-norm, 64 experts of d_ff 1024, top-8, vocab 50,304): seed-0
    weights pruned at 0.9 on (8, 128) blocks of every (out, in) view and
    built on the card by ``init_compressed``, then palette-8 and -4; the
    expert launch at its shapes (rows 1e / 2e); ``generate`` and the
    engine through the serving CLI from BlockCSR, palette-8 and palette-4
    in bf16, 113 spmm launches per forward (4 attention projections and 3
    expert launches per layer, and the head) and none per expert; where
    the engine's time goes; the bf16 prefill held call by call and, where
    no router flips, in its logits; in f32 at a cut depth, the kernel
    path against the plain path and the engine against ``generate``; and
    one ``--profile`` run whose counts equal the launch counters."""
    cfg = get_config(MOE)
    phase(f"{MOE}: the compressed model, built on the card")
    t0 = time.perf_counter()
    model = build(cfg, device=dev)
    cp = init_compressed(model, CompressionPlan(block=BLOCK), SPARSITY,
                         torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    formats = {"bcsr": cp, "pal8": quantize_compressed(cp, 8),
               "pal4": quantize_compressed(cp, 4)}
    torch.cuda.synchronize()
    single, experts = _per_pass(cp)
    dense_b = model_size_bytes(model.init(device="meta"))
    sizes = {"dense": dense_b, "bcsr": bcsr_equiv_size_bytes(cp),
             "pal8": compressed_size_bytes(formats["pal8"]),
             "pal4": compressed_size_bytes(formats["pal4"])}
    log(f"{MOE}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.moe.n_experts} "
        f"experts top-{cfg.moe.top_k}, {cfg.n_params():,} params; "
        f"{len(list(iter_bcsr(cp)))} compressed weights, {single} spmm and "
        f"{experts} expert spmm launches per pass; build {t1 - t0:.1f} s, "
        f"palette-8 and -4 {time.perf_counter() - t1:.1f} s; bytes "
        + ", ".join(f"{k} {v / 1e6:.2f} MB" for k, v in sizes.items()))
    if (single, experts) != (4 * cfg.n_layers + 1, 3 * cfg.n_layers):
        raise SystemExit(f"{MOE}: expected {4 * cfg.n_layers + 1} spmm and "
                         f"{3 * cfg.n_layers} expert launches a pass")
    result = {"arch": MOE, "sizes": sizes, "per_pass": single + experts}

    phase(f"{MOE}: the expert launch against its plain version "
          f"(rows 1e / 2e)")
    result["expert_rows"] = _moe_expert_rows(dev, formats)

    phase(f"{MOE}: generate and the engine through the serving CLI "
          "(the main path)")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    requests = _engine_requests(cfg.vocab)
    req_file = OUT_DIR / "moe_requests.json"
    req_file.write_text(json.dumps(
        [{"prompt": list(map(int, r.prompt)), "gen": r.max_new_tokens}
         for r in requests]))
    n_cut = MOE_SERVE_LAYERS
    cut_single, cut_experts = 4 * n_cut + 1, 3 * n_cut
    log(f"{MOE}: the serving CLI runs the first {n_cut} of {cfg.n_layers} "
        f"layers at full width: {cut_single} spmm and {cut_experts} expert "
        "launches a pass")
    for fmt, extra, wrapper in (("bcsr", [], "spmm"),
                                ("pal8", ["--quantize-bits", "8"], "spmm_palette"),
                                ("pal4", ["--quantize-bits", "4"], "spmm_palette")):
        with _cut_build(serve, n_cut, f32=False):
            counts = _serve_run(extra, arch=MOE)
        ew = f"{wrapper}_experts"
        want = {wrapper: cut_single * GEN, ew: cut_experts * GEN}
        _check_counts(f"{MOE} {fmt} generate", counts, want)
        if sum(counts[k] for k in ops.FORWARD) != \
                (cut_single + cut_experts) * GEN:
            raise SystemExit(f"{MOE} {fmt} generate: launches {counts}")
        result[f"generate_{fmt}"] = {
            "launches": {k: counts[k] for k in (wrapper, ew)},
            **{k: counts[f"{ew}_{k}"] for k in ops.KERNELS}}
        with _cut_build(serve, n_cut, f32=False):
            counts, s, peak = _engine_cli_run(f"moe_{fmt}", extra, req_file,
                                              arch=MOE)
        ticks = s["n_ticks"]
        _check_counts(f"{MOE} {fmt} engine", counts,
                      {wrapper: cut_single * ticks, ew: cut_experts * ticks,
                       "paged_flash_fwd": n_cut * ticks})
        if sum(counts[k] for k in ops.FORWARD) != \
                (cut_single + cut_experts) * ticks:
            raise SystemExit(f"{MOE} {fmt} engine: launches {counts}")
        log(f"{MOE} engine {fmt} bf16: {s['tok_s']:.1f} tok/s, ttft p50/p95 "
            f"{s['ttft_p50_s'] * 1e3:.1f}/{s['ttft_p95_s'] * 1e3:.1f} ms, "
            f"{ticks} ticks, {s['n_prefill_chunks']} prefill chunks, kv pool "
            f"{s['kv_page_bytes']} bytes, peak memory {peak / 2**30:.2f} GiB; "
            f"{cut_single + cut_experts} spmm launches a tick")
        result[f"engine_{fmt}"] = {
            "tok_s": s["tok_s"], "ttft_p50_s": s["ttft_p50_s"],
            "ttft_p95_s": s["ttft_p95_s"], "ticks": ticks,
            "spmm": counts[wrapper], "experts": counts[ew],
            **{k: counts[f"{ew}_{k}"] for k in ops.KERNELS}}

    phase(f"{MOE}: where the engine's time goes (bf16)")
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    _profile_engine_window(lambda: _engine(model, cp, requests), requests,
                           MOE_PROFILE_TICKS)

    phase(f"{MOE}: kernel path vs plain path, bf16, all {cfg.n_layers} "
          "layers")
    plain = build(cfg, device=dev, sparse_backend="ref")
    result["bf16_router_flips"] = {
        fmt: _moe_bf16_check(f"{MOE} {fmt}", model, plain, params, prompt)
        for fmt, params in formats.items()}
    del plain
    torch.cuda.empty_cache()

    phase(f"{MOE}: f32 at a cut depth, kernel path vs plain path and "
          "engine vs generate")
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              n_layers=MOE_F32_LAYERS)
    log(f"{MOE}: the f32 checks run the first {MOE_F32_LAYERS} of "
        f"{cfg.n_layers} layers; the bf16 runs above run all of them")
    kernel_f32 = build(f32, device=dev)
    plain_f32 = build(f32, device=dev, sparse_backend="ref")
    # The engine against generate runs with capacity_factor E / top_k, so
    # that every expert has a slot for every token: which tokens overflow
    # depends on which tokens share a forward (an engine tick is not a
    # generate batch), so the two agree only where none is dropped, as in
    # the reference's own engine test (tests/test_serve_engine.py:132).
    # The drop path is held against the JAX package on the CPU
    # (tests/test_torch_moe.py).
    no_drop = build(dataclasses.replace(f32, moe=dataclasses.replace(
        f32.moe, capacity_factor=f32.moe.n_experts / f32.moe.top_k)),
        device=dev)
    for fmt, params in formats.items():
        p32 = _cut_depth(params, f32.n_super_blocks)
        out_k = generate(kernel_f32, p32, prompt, GEN)
        out_r = generate(plain_f32, p32, prompt, GEN)
        matched = sum(_moe_divergence_ok(
            plain_f32, p32, prompt[row].tolist(), out_r[row], out_k[row],
            f"{MOE} {fmt} f32 generate kernel vs plain row {row}")
            for row in range(BATCH))
        log(f"{MOE} {fmt}: f32 generate {matched}/{BATCH * GEN} tokens of the "
            "kernel path match the plain path")
        if fmt != "bcsr":               # the dispatch does not see the store
            continue
        ops.reset_launches()
        paged_ops.reset_launches()
        out = _engine(no_drop, p32, requests, attn_backend="cuda").run(requests)
        counts = {**ops.launches, **paged_ops.launches}
        engine_matched = sum(_moe_divergence_ok(
            no_drop, p32, r.prompt,
            generate(no_drop, p32, torch.tensor(r.prompt_ids, device=dev)[None],
                     ENGINE_GEN)[0],
            out["results"][rid], f"{MOE} {fmt} f32 engine vs generate rid {rid}")
            for rid, r in enumerate(requests))
        log(f"{MOE} {fmt}: f32 engine (capacity factor "
            f"{no_drop.cfg.moe.capacity_factor}) {engine_matched}/"
            f"{len(requests) * ENGINE_GEN} tokens match generate "
            f"({out['stats']['n_ticks']} ticks, launches {counts})")
    del no_drop, kernel_f32, plain_f32
    torch.cuda.empty_cache()

    phase(f"{MOE}: launch/serve --profile")
    lines = []
    counts = _serve_run(["--profile"], arch=MOE, lines=lines)
    prof = _profile_counts(lines)
    for name, key in (("bsr_spmm/spmm", "spmm"),
                      ("bsr_spmm/spmm_experts", "spmm_experts")):
        log(f"  --profile {name}: {prof.get(name)} calls, launch counter "
            f"{counts[key]}")
        if prof.get(name) != counts[key] or not counts[key]:
            raise SystemExit(f"--profile: {name} counted {prof.get(name)}, "
                             f"the launch counter {counts[key]}")
    for line in lines:
        if line.startswith("  ") and "calls" in line:
            log(f"  {line.strip()}")
    result["profile_counts"] = prof
    del formats, model
    torch.cuda.empty_cache()
    return result, cp


# ---------------------------------------------------------------------------
# MoE training (olmoe-1b-7b)
# ---------------------------------------------------------------------------

def _expert_bwd_bound(kind, w, dy, counts=None):
    """(bound ms, what bounds it, bytes, flops) of one expert backward call
    (``kind`` "spmm_t": dX = dY W; "sddmm": dW, x of dY's dtype): each
    expert's single-matrix bound (``_spmm_t_bound``, ``_sddmm_bound``) on
    its rows. With ``counts`` ((E,), on the host), the experts that hold a
    token only, on their occupied rows (dY, x and the products), with every
    dX row of such an expert written (the rows past its count are zeros)
    and its valid slots."""
    e = w.gather_nnz.shape[0]
    nbytes = flops = 0
    for i in range(e):
        m = dy.shape[1] if counts is None else int(counts[i])
        if m == 0:
            continue
        d = dy[i, :m]
        if kind == "spmm_t":
            b = _spmm_t_bound(w[i], d)
            # dX: every row of the buffer, not only the occupied ones
            extra = (dy.shape[1] - m) * w.shape[1] * 4
        else:
            b = _sddmm_bound(w[i], d.new_empty((m, w.shape[1])), d)
            extra = 0
        nbytes, flops = nbytes + b[2] + extra, flops + b[3]
    return _ops_bound(nbytes, flops, dy.dtype, w.data.dtype)


def _moe_train_kernel_rows(dev, cp) -> dict:
    """Rows 1be / 4e: the expert backward (``spmm_t_experts``, dx, and
    ``bsr_weight_grad_experts``, dw; ``csrc/bsr_experts_bwd.cu``) on layer
    0's ewi, ewg and ewo of the phase-13 model (64 experts, (8, 128) blocks
    at 0.9, the store in bf16), at M = 80 (a debias step's capacity) and 8
    (the capacity's floor), dY and x in bf16 (the cotangent bf16 training
    hands them) and f32, every row and the rows layer 0's router fills
    (``_moe_routed_counts`` on MOE_TRAIN_TOKENS). Each call held to its
    plain version with the same counts (a loop of the single-matrix plain
    version over the experts), dx exact zeros past each count, every
    padded slot and every expert without a token zero in dw. At ewi each call is timed beside
    the plain version, the library yardsticks ``torch.bmm(dY, densified
    W)`` and ``torch.bmm(dY', X)`` (a dense dW; the port calls neither) and
    its bound (the routed bound on the occupied rows); at M = 80, bf16,
    every row, also 64 single-expert launches of ``spmm_t`` /
    ``bsr_weight_grad``. Rows keyed (kernel, proj, M, dtype, "full" |
    "routed")."""
    gen = torch.Generator(device=dev).manual_seed(5)
    routed = _moe_routed_counts(dev, cp, get_config(MOE), MOE_TRAIN_TOKENS)
    table_proj, table_m, table_dt = MOE_TRAIN_TABLE
    rows = {}
    for proj in ("ewi", "ewg", "ewo"):
        w32 = cp.sparse["layers"]["b0_attn"]["moe"][proj][0]
        w = dataclasses.replace(w32, data=w32.data.to(torch.bfloat16))
        e, (n, k) = w.gather_nnz.shape[0], w.shape
        valid = sddmm_ops.slot_coordinates(w)[2]
        timed = proj == table_proj
        wd = (torch.stack([bcsr_to_dense(w[i])[:n, :k] for i in range(e)])
              if timed else None)
        for m_rows in MOE_TRAIN_M:
            for dt in (torch.bfloat16, torch.float32):
                lib = str(dt).split(".")[-1]
                dy = torch.randn(e, m_rows, n, generator=gen, device=dev).to(dt)
                x = torch.randn(e, m_rows, k, generator=gen, device=dev).to(dt)
                base = {"matrix": f"layer 0 moe.{proj}", "experts": e,
                        "matrix_shape": [n, k], "M": m_rows, "dtype": lib,
                        "store": "bfloat16",
                        "resident_blocks": int(w.gather_nnz.sum())}
                yard = {}
                if timed:
                    wdt = wd.to(dt)
                    yard = {
                        "spmm_t_experts": time_ms(torch.bmm, copies(
                            lambda: (dy.clone(), wdt.clone()),
                            tensor_bytes(dy, wdt)), MOE_YARDSTICK_CALLS),
                        "bsr_sddmm_experts": time_ms(
                            lambda a, b: torch.bmm(a.transpose(1, 2), b),
                            copies(lambda: (dy.clone(), x.clone()),
                                   tensor_bytes(x, dy)), MOE_YARDSTICK_CALLS)}
                    del wdt
                for label in ("full", "routed"):
                    counts = None if label == "full" else routed[m_rows]
                    host = None if counts is None else counts.cpu()
                    what = f"{proj} M={m_rows} {lib} {label}"
                    got = ops.spmm_t_experts(dy, w, counts)
                    err = _check(f"spmm_t_experts {what}", got,
                                 ref.spmm_experts_bwd_ref(dy, w, counts),
                                 KERNEL_ATOL, KERNEL_RTOL)
                    if host is not None and any(
                            bool(got[i, r:].any())
                            for i, r in enumerate(host.tolist())):
                        raise SystemExit(f"spmm_t_experts {what}: nonzero dx "
                                         "past a count")
                    row = {"kernel": "bsr_spmm_t_experts", **base,
                           "rows": label, "max_abs_err": err,
                           "atol": KERNEL_ATOL, "rtol": KERNEL_RTOL}
                    if host is not None:
                        row.update(empty_experts=int((host == 0).sum()),
                                   occupied_rows=int(host.sum()))
                    if timed:
                        sets = copies(lambda: (dy.clone(), w.map(torch.clone)),
                                      tensor_bytes(dy, w.data))
                        row.update(
                            ms=time_ms(lambda d, ww: ops.spmm_t_experts(
                                d, ww, counts), sets, MOE_TIMED_CALLS),
                            plain_ms=time_ms(
                                lambda d, ww: ref.spmm_experts_bwd_ref(
                                    d, ww, counts), sets[:1], 1),
                            library_ms=yard["spmm_t_experts"],
                            library=f"torch.bmm(dY, densified W) {lib}")
                        row.update(zip(("bound_ms", "bound_by", "bytes",
                                        "flops"), _expert_bwd_bound(
                                            "spmm_t", w, dy, host)))
                        if (m_rows, dt, label) == (table_m, table_dt, "full"):
                            def t_singles(d, ww):
                                for i in range(d.shape[0]):
                                    ops.spmm_t(d[i], ww[i])
                            row["singles_ms"] = time_ms(t_singles, sets,
                                                        MOE_YARDSTICK_CALLS)
                        del sets
                    log(json.dumps(row))
                    rows[("spmm_t_experts", proj, m_rows, dt, label)] = row

                    got = sddmm_ops.bsr_weight_grad_experts(x, dy, w, counts)
                    err = _check(f"bsr_sddmm_experts {what}", got,
                                 sddmm_ops.bsr_weight_grad_experts_ref(
                                     x, dy, w, counts),
                                 SDDMM_ATOL, SDDMM_RTOL)
                    empty = (torch.zeros(e, dtype=torch.bool) if host is None
                             else host == 0).to(dev)
                    if bool(got[~valid].any()) or bool(got[empty].any()):
                        raise SystemExit(f"bsr_sddmm_experts {what}: a padded "
                                         "slot or an expert without tokens "
                                         "is not zero")
                    row = {"kernel": "bsr_sddmm_experts", **base,
                           "rows": label, "slots": int(w.data.shape[1]),
                           "valid_slots": int(valid.sum()),
                           "max_abs_err": err, "atol": SDDMM_ATOL,
                           "rtol": SDDMM_RTOL}
                    if host is not None:
                        row.update(empty_experts=int((host == 0).sum()),
                                   occupied_rows=int(host.sum()))
                    if timed:
                        sets = copies(lambda: (x.clone(), dy.clone(), w),
                                      tensor_bytes(x, dy))
                        row.update(
                            ms=time_ms(lambda xs, d, ww:
                                       sddmm_ops.bsr_weight_grad_experts(
                                           xs, d, ww, counts),
                                       sets, MOE_TIMED_CALLS),
                            plain_ms=time_ms(
                                lambda xs, d, ww:
                                sddmm_ops.bsr_weight_grad_experts_ref(
                                    xs, d, ww, counts), sets[:1], 1),
                            library_ms=yard["bsr_sddmm_experts"],
                            library=f"torch.bmm(dY', X) {lib} (dense dW)")
                        row.update(zip(("bound_ms", "bound_by", "bytes",
                                        "flops"), _expert_bwd_bound(
                                            "sddmm", w, dy, host)))
                        if (m_rows, dt, label) == (table_m, table_dt, "full"):
                            def s_singles(xs, d, ww):
                                for i in range(xs.shape[0]):
                                    sddmm_ops.bsr_weight_grad(xs[i], d[i],
                                                              ww[i])
                            row["singles_ms"] = time_ms(s_singles, sets,
                                                        MOE_YARDSTICK_CALLS)
                        del sets
                    log(json.dumps(row))
                    rows[("bsr_sddmm_experts", proj, m_rows, dt, label)] = row
                    del got
        del wd
        torch.cuda.empty_cache()
    return rows


def _per_step(counts: dict, steps: int) -> dict:
    return {k: counts[k] / steps for k in (
        "spmm", "spmm_t", "bsr_sddmm", "spmm_experts", "spmm_t_experts",
        "bsr_sddmm_experts", "spmm_palette", "spmm_palette_experts")}


def _check_train_counts(what, counts, steps, single, experts,
                        opt_steps) -> None:
    """Each debias step: ``single`` launches of each single-matrix training
    kernel (attention and the head), ``experts`` of each expert one (3 a
    layer), no palette launch and so no launch that is not one of these;
    and one prox_adam launch per optimizer step of the run (``opt_steps``,
    SpC and debias: every tree here has at most K leaves)."""
    want = {"spmm": single, "spmm_t": single, "bsr_sddmm": single,
            "spmm_experts": experts, "spmm_t_experts": experts,
            "bsr_sddmm_experts": experts, "spmm_palette": 0,
            "spmm_palette_experts": 0}
    got = _per_step(counts, steps)
    log(f"  {what}: launches per debias step {got}")
    if got != {k: float(v) for k, v in want.items()} or \
            counts["prox_adam"] != opt_steps:
        raise SystemExit(f"{what}: launches {counts}, expected per step {want} "
                         f"and {opt_steps} prox_adam (one an optimizer step)")



def _timed_spc_retrain(dev, model, params, debias_steps: int) -> dict:
    """``train/loop.run_spc_retrain_pipeline`` (the function ``launch/train
    --sparse`` calls) on ``model`` from ``params`` (consumed) in the
    config's dtype, batch TRAIN_BATCH x TRAIN_SEQ: SPC_STEPS SpC steps with
    the plan's group-l1 prox at LAM, compression (``compress_params``
    timed), ``debias_steps`` debias steps; the launch counters set to 0
    just before and read just after, each step's wall time per phase, the
    peak memory."""
    cfg = model.cfg
    plan = CompressionPlan(block=BLOCK)
    data = TokenStreamConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH)
    compress_s = []
    inner = train_loop.compress_params

    def timed_compress(p, pl):
        t0 = time.perf_counter()
        out = inner(p, pl)
        torch.cuda.synchronize()
        compress_s.append(time.perf_counter() - t0)
        return out

    _TimedWatchdog.phases = []
    saved = train_loop.StragglerWatchdog
    train_loop.StragglerWatchdog = _TimedWatchdog
    train_loop.compress_params = timed_compress
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    t0 = time.perf_counter()
    try:
        cp, hist_spc, hist_db, report = train_loop.run_spc_retrain_pipeline(
            params, lambda o, param_transform=None: make_train_step(
                model, o, param_transform=param_transform),
            optimizers.prox_adam(TRAIN_LR, lam=LAM,
                                 prox_fn=make_plan_prox(plan)),
            optimizers.prox_adam(TRAIN_LR, lam=0.0),
            lambda step: token_batch(data, step, device=dev),
            spc_steps=SPC_STEPS, debias_steps=debias_steps, plan=plan,
            log_every=1)
        torch.cuda.synchronize()
    finally:
        train_loop.StragglerWatchdog = saved
        train_loop.compress_params = inner
    counts = _all_launches()
    del params
    log(f"  run {time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"compress_params {compress_s[0]:.1f} s; bytes dense "
        f"{report['dense_bytes'] / 1e6:.1f} MB, bcsr "
        f"{report['bcsr_bytes'] / 1e6:.1f} MB")
    for name, hist in (("spc", hist_spc), ("debias", hist_db)):
        log(f"  {name} losses {[round(h['loss'], 4) for h in hist]}"
            + (f", load balance {[round(h['load_balance'], 4) for h in hist]}"
               if cfg.moe is not None else ""))
    for name, times in zip(("spc", "debias"), _TimedWatchdog.phases):
        log(f"  {name} step times (s, host clock, the loss read every step): "
            f"{[round(t, 4) for t in times]}")
    losses = [h["loss"] for h in hist_spc + hist_db]
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"non-finite training loss: {losses}")
    return {"cp": cp, "launches": counts, "compress_s": compress_s[0],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "step_times": _TimedWatchdog.phases,
            "opt_steps": SPC_STEPS + debias_steps}


def _moe_spc_retrain(dev) -> tuple:
    """SpC-Retrain of olmoe-1b-7b at full width on MOE_TRAIN_LAYERS layers
    in bf16 (``_timed_spc_retrain``), from seed-0 weights whose blocks have
    spread norms (``_spread_norms``: every projection, each expert's (out,
    in) view and the head), DEBIAS_STEPS debias steps on the
    compressed experts; then ``generate`` from the result."""
    cfg = dataclasses.replace(get_config(MOE), n_layers=MOE_TRAIN_LAYERS)
    phase(f"{MOE} training: SpC-Retrain at full width, {MOE_TRAIN_LAYERS} of "
          f"16 layers (the main path)")
    model = build(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    _spread_norms(params, BLOCK, gen)
    run = _timed_spc_retrain(dev, model, params, DEBIAS_STEPS)
    del params
    cp = run.pop("cp")
    sparsity, resident, total = _block_sparsity(cp, ("/moe/",))
    log(f"  expert block sparsity after SpC: {sparsity:.4f} ({resident} of "
        f"{total} (8, 128) blocks resident), all compressed weights "
        f"{_block_sparsity(cp)[0]:.4f}, band {SPARSITY_BAND}")
    if not SPARSITY_BAND[0] <= sparsity <= SPARSITY_BAND[1]:
        raise SystemExit(f"expert block sparsity {sparsity:.4f} outside the "
                         "band")
    single = 4 * cfg.n_layers + 1
    if _per_pass(cp) != (single, 3 * cfg.n_layers):
        raise SystemExit(f"expected every projection compressed, got "
                         f"{[p for p, _ in iter_bcsr(cp)]}")
    _check_train_counts("SpC-Retrain", run["launches"], DEBIAS_STEPS,
                        single, 3 * cfg.n_layers, run["opt_steps"])
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                           device=dev)
    ops.reset_launches()
    out = generate(model, cp, prompt, TRAIN_GEN)
    torch.cuda.synchronize()
    log(f"  generate from the trained compressed params: tokens "
        f"{tuple(out.shape)}, launches spmm {ops.launches['spmm']} "
        f"spmm_experts {ops.launches['spmm_experts']}")
    if tuple(out.shape) != (BATCH, TRAIN_GEN) or \
            ops.launches["spmm_experts"] != 3 * cfg.n_layers * TRAIN_GEN or \
            ops.launches["spmm"] != single * TRAIN_GEN:
        raise SystemExit("generate from the trained params: tokens or "
                         "launches")
    return cp, dict(run, sparsity=sparsity)


def _debias_full(dev, cfg, cp, what: str) -> dict:
    """Debias of ``cp`` (a model of ``cfg``) at full width and depth in the
    config's dtype: ``split_trainable`` / ``rebuild`` and
    ``make_train_step`` with prox-Adam at lam 0, DEBIAS_STEPS steps of
    batch TRAIN_BATCH x TRAIN_SEQ; the launch counters per step, held to
    one launch of each training kernel per compressed matrix (or expert
    stack) and layer; one step profiled. Trains ``cp``'s stores in
    place."""
    model = build(cfg, device=dev)
    trainable, rebuild = split_trainable(cp)
    opt = optimizers.prox_adam(TRAIN_LR, lam=0.0)
    holder = [TrainState(params=trainable, opt_state=opt.init(trainable),
                         mask=masks.zero_mask(trainable), step=0)]
    step = make_train_step(model, opt, param_transform=rebuild)
    data = TokenStreamConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH)
    batches = [token_batch(data, i, device=dev) for i in range(DEBIAS_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    times, losses = [], []
    for b in batches:
        t0 = time.perf_counter()
        holder[0], met = step(holder[0], b)
        losses.append(float(met["loss"]))
        times.append(time.perf_counter() - t0)
    counts = _all_launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"  losses {[round(v, 4) for v in losses]}; step times (s, host "
        f"clock, the loss read) {[round(t, 4) for t in times]}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    _check_train_counts(f"{what} full-depth debias", counts, DEBIAS_STEPS,
                        *_per_pass(cp), DEBIAS_STEPS)
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"non-finite debias loss: {losses}")

    def one():
        holder[0], met = step(holder[0], batches[0])
        float(met["loss"])

    _profile(f"{what} debias step (batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
             f"{cfg.n_layers} layers)", 0, one, top=10)
    del holder, trainable, step
    torch.cuda.empty_cache()
    return {"launches": counts, "step_times": times, "peak_bytes": peak}


@contextlib.contextmanager
def _held_backward(what: str):
    """Within the block, every kernel call of ``sparse_matmul``'s backward
    (``spmm_t`` / ``spmm_t_experts`` for dx, the SDDMM for dw) is also run
    through its plain version on the same inputs and held to it (the
    kernels phase's tolerances); yields the list of each call's max
    |kernel - plain|."""
    dx_product, dw_product = sparse_ops._dx_product, sparse_ops._dw_product
    errs = []

    def hold(got, want, atol, rtol, desc):
        errs.append(float((got - want).abs().max()) if got.numel() else 0.0)
        if not torch.allclose(got, want, atol=atol, rtol=rtol):
            raise SystemExit(f"{what}: {desc} disagrees with plain, max err "
                             f"{errs[-1]}")

    def dx(dy, w, backend, rows=None):
        got = dx_product(dy, w, backend, rows)
        if backend == "cuda":
            want = (ref.spmm_experts_bwd_ref(dy, w, rows) if dy.dim() == 3
                    else ref.spmm_bwd_ref(dy, w))
            hold(got, want, KERNEL_ATOL, KERNEL_RTOL,
                 f"dx call (dy {tuple(dy.shape)} {dy.dtype}, W {w.shape})")
        return got

    def dw(x, dy, w, backend, rows=None):
        got = dw_product(x, dy, w, backend, rows)
        if backend == "cuda":
            want = (sddmm_ops.bsr_weight_grad_experts_ref(x, dy, w, rows)
                    if x.dim() == 3 else sddmm_ops.bsr_weight_grad_ref(x, dy, w))
            hold(got, want, SDDMM_ATOL, SDDMM_RTOL,
                 f"dw call (x {tuple(x.shape)}, dy {dy.dtype}, W {w.shape})")
        return got

    sparse_ops._dx_product, sparse_ops._dw_product = dx, dw
    try:
        yield errs
    finally:
        sparse_ops._dx_product, sparse_ops._dw_product = dx_product, dw_product


def _moe_train_compare(dev, cp) -> dict:
    """The kernel path against the plain path in f32 (``sparse_backend``
    'auto' against 'ref') on the SpC-Retrain result (MOE_TRAIN_LAYERS
    layers), over COMPARE_STEPS debias steps from the same stores: the
    kernel path's every kernel call (forward and backward) held to its
    plain version on its inputs; the routers' top-k choices compared per
    layer and step (flips counted; a flip is accepted only at a near tie,
    as ``_router_flips`` holds it). Up to the first step with a flip: the
    losses within LOSS_RTOL, step 1's dx per projection call and dw per
    layer and expert slice within GRAD_RTOL of their largest |value|, and
    after COMPARE_STEPS steps the stores' updates within UPDATE_RTOL of
    their norm."""
    phase(f"{MOE} training: kernel path vs plain path (f32 debias, "
          f"{MOE_TRAIN_LAYERS} layers)")
    f32 = dataclasses.replace(get_config(MOE), compute_dtype="float32",
                              n_layers=MOE_TRAIN_LAYERS)
    k_top = f32.moe.top_k
    data = TokenStreamConfig(vocab=f32.vocab, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH)
    trainable, rebuild = split_trainable(cp)
    base = {"dense": tree_map(torch.clone, trainable["dense"]),
            "bcsr_data": {p: d.clone() for p, d in
                          trainable["bcsr_data"].items()}}
    del trainable
    runs = {}
    for backend in ("auto", "ref"):
        model = build(f32, device=dev, sparse_backend=backend)
        tr = {"dense": tree_map(torch.clone, base["dense"]),
              "bcsr_data": {p: d.clone() for p, d in base["bcsr_data"].items()}}
        loss0, dxs, dws = _first_grads(model, tr, rebuild,
                                       token_batch(data, 0, device=dev))
        opt = optimizers.prox_adam(COMPARE_LR, lam=0.0)
        state = TrainState(params=tr, opt_state=opt.init(tr),
                           mask=masks.zero_mask(tr), step=0)
        step = make_train_step(model, opt, param_transform=rebuild)
        losses, inputs = [], []
        held = contextlib.ExitStack()
        fwd_errs = bwd_errs = []
        if backend == "auto":
            fwd_errs = held.enter_context(_held_calls(f"{MOE} f32 debias"))
            bwd_errs = held.enter_context(_held_backward(f"{MOE} f32 debias"))
        with held, _router_probs(inputs) as probs:
            _reset_all()
            for i in range(COMPARE_STEPS):
                state, met = step(state, token_batch(data, i, device=dev))
                losses.append(float(met["loss"]))
        log(f"  {backend}: losses {losses}, launches {_all_launches()}"
            + (f"; {len(fwd_errs)} forward and {len(bwd_errs)} backward "
               f"kernel calls held to their plain versions, max |diff| "
               f"{max(fwd_errs):.3e} / {max(bwd_errs):.3e}"
               if backend == "auto" else ""))
        runs[backend] = (loss0, dxs, dws, losses,
                         {p: v - base["bcsr_data"][p] for p, v in
                          state.params["bcsr_data"].items()}, probs, inputs)
        del state, step, model, tr
        torch.cuda.empty_cache()
    k, p = runs["auto"], runs["ref"]
    flips, first = _router_flips(f"{MOE} f32 debias", k_top, (k[5], k[6]),
                                 (p[5], p[6]))
    per_step = len(k[5]) // COMPARE_STEPS
    first_step = COMPARE_STEPS if first is None else first["layer"] // per_step
    log(f"  router top-{k_top} flips between kernel and plain path: {flips} "
        f"of {len(k[5]) * k[5][0].shape[0]} (token, layer, step) triples, "
        f"first {first}" + ("" if first is None else
                            f" (step {first_step + 1}: from there the steps "
                            "are held call by call only)"))
    for i, (a, b) in enumerate(zip(k[3], p[3])):
        if i < first_step and abs(a - b) > LOSS_RTOL * abs(b):
            raise SystemExit(f"debias losses differ: {k[3]} vs {p[3]}")
    result = {"flips": flips, "first_flip_step": first_step + 1
              if first is not None else None, "losses": (k[3], p[3])}
    if first_step == 0:
        return result
    if len(k[1]) != len(p[1]) or len(k[1]) != 7 * MOE_TRAIN_LAYERS + 1:
        raise SystemExit(f"dx taps: {len(k[1])} and {len(p[1])}")
    dx_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(k[1], p[1]))
    dw_err = 0.0
    for path, gk in k[2].items():
        gp = p[2][path]
        lead = gk.shape[:-3]
        for idx in np.ndindex(*lead):
            scale = gp[idx].abs().max().clamp_min(1e-30)
            dw_err = max(dw_err, float((gk[idx] - gp[idx]).abs().max()
                                       / scale))
    upd_err = max(float((k[4][q] - p[4][q]).norm()
                        / p[4][q].norm().clamp_min(1e-30)) for q in k[4])
    log(f"  f32 debias, kernels vs plain: step-1 loss {k[0]:.6f} vs "
        f"{p[0]:.6f}; dx max err / max|dx| per call {dx_err:.3e}, dw per "
        f"layer and expert slice {dw_err:.3e} (bound {GRAD_RTOL}); "
        f"block-store updates after {COMPARE_STEPS} steps: |diff| / |update| "
        f"{upd_err:.3e} (bound {UPDATE_RTOL}"
        + (")" if first is None else ", not held: a router flipped)"))
    if dx_err > GRAD_RTOL or dw_err > GRAD_RTOL or \
            (first is None and upd_err > UPDATE_RTOL):
        raise SystemExit("kernel path and plain path disagree")
    result.update(dx_err=dx_err, dw_err=dw_err, upd_err=upd_err)
    return result


def _reduced_train_cli(dev, arch: str, where: tuple, n_where: int) -> dict:
    """``launch/train --arch <arch> --reduced --sparse`` on the card,
    resumed from a planted checkpoint so that the projections compress,
    with the launch counters read around it: ``n_where`` compressed
    weights whose path holds one of ``where``, one launch of each training
    kernel per compressed matrix (or expert stack) and layer a debias
    step; then ``launch/serve --sparse --ckpt-dir`` on its checkpoint."""
    phase(f"{arch} training: launch/train --reduced --sparse and launch/serve "
          "--ckpt-dir")
    cfg = get_config(arch).reduced()
    ckpt_dir = OUT_DIR / f"{arch}_train_ckpt"
    if ckpt_dir.exists():
        import shutil
        shutil.rmtree(ckpt_dir)
    _plant_checkpoint(dev, ckpt_dir, arch, CLI_BLOCK, CLI_LR, CLI_LAM,
                      reduced=True)
    argv = ["--arch", arch, "--reduced", "--sparse", "--steps",
            str(CLI_STEPS), "--debias-steps", str(CLI_DEBIAS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr",
            str(CLI_LR), "--compress", f"group_l1:{CLI_LAM}",
            "--block", *map(str, CLI_BLOCK), "--log-every", "1",
            "--ckpt-dir", str(ckpt_dir)]
    buf = io.StringIO()
    _reset_all()
    with contextlib.redirect_stdout(buf):
        cp, hist_spc, hist_db, report = train.main(argv)
    torch.cuda.synchronize()
    counts = _all_launches()
    log(f"train {' '.join(argv)}")
    for line in buf.getvalue().splitlines():
        if line.startswith(("arch=", "loss:", "model size", "compressed ")):
            log(f"  {line}")
    hits = sorted(q for q, _ in iter_bcsr(cp) if any(w in q for w in where))
    log(f"  compressed {hits}, their block sparsity "
        f"{_block_sparsity(cp, where)[0]:.4f}")
    if len(hits) != n_where:
        raise SystemExit(f"launch/train --reduced --sparse compressed {hits}, "
                         f"expected {n_where} weights under {where}")
    single, experts = _per_pass(cp)
    # resumed from the planted step 1: CLI_STEPS - 1 SpC steps
    _check_train_counts(f"{arch} launch/train --reduced --sparse", counts,
                        CLI_DEBIAS, single, experts,
                        CLI_STEPS - 1 + CLI_DEBIAS)
    argv = ["--arch", arch, "--reduced", "--sparse", "--ckpt-dir",
            str(ckpt_dir), "--batch", str(BATCH), "--prompt-len", str(PROMPT),
            "--gen", str(CLI_GEN)]
    buf = io.StringIO()
    _reset_all()
    with contextlib.redirect_stdout(buf):
        out = serve.main(argv)
    torch.cuda.synchronize()
    log(f"serve {' '.join(argv)}")
    for line in buf.getvalue().splitlines()[-3:]:
        log(f"  {line}")
    log(f"  launches spmm {ops.launches['spmm']} spmm_experts "
        f"{ops.launches['spmm_experts']}")
    if tuple(out.shape) != (BATCH, CLI_GEN) or \
            ops.launches["spmm_experts"] != experts * CLI_GEN or \
            ops.launches["spmm"] != single * CLI_GEN:
        raise SystemExit(f"serving the trained {arch} checkpoint: tokens "
                         f"{tuple(out.shape)}, launches {ops.launches}")
    return {"launches": counts}


def moe_train_phase(dev, cp) -> dict:
    """MoE training through compressed experts (olmoe-1b-7b): the expert
    backward kernels at its shapes (rows 1be / 4e, on ``cp``, phase 13's
    BlockCSR); SpC-Retrain at full width on 2 layers; debias at full width
    and depth on ``cp`` (trained in place); the kernel path against the
    plain path in f32; and the training and serving CLIs on reduced
    olmoe."""
    phase(f"{MOE} training: the expert backward kernels against their plain "
          "versions (rows 1be / 4e)")
    result = {"kernel_rows": _moe_train_kernel_rows(dev, cp)}
    cp2, result["spc_retrain"] = _moe_spc_retrain(dev)
    torch.cuda.empty_cache()
    result["compare"] = _moe_train_compare(dev, cp2)
    del cp2
    torch.cuda.empty_cache()
    phase(f"{MOE} training: debias at full width and depth (bf16)")
    result["debias_full"] = _debias_full(dev, get_config(MOE), cp, MOE)
    result["cli"] = _reduced_train_cli(dev, MOE, ("/moe/",), 3)
    return result


def _recurrent_train_rows(dev, cp) -> dict:
    """Rows 1br / 4r: ``spmm_t`` and the SDDMM at recurrentgemma-9b's
    layer-0 mlp.wi of the serving phase's model ((12288, 4096), (8, 128)
    blocks at 0.9, the store in bf16), M = 512, dY and x in bf16 and f32
    (``_bwd_kernel_rows``)."""
    path, _ = RECURRENT_TRAIN_TABLE
    w32 = dict(iter_bcsr(cp))[path][0]
    w = dataclasses.replace(w32, data=w32.data.to(torch.bfloat16))
    n, k = w.shape
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        dy = torch.randn(TRAIN_M, n, generator=gen, device=dev).to(dt)
        x = torch.randn(TRAIN_M, k, generator=gen, device=dev).to(dt)
        rows.update(_bwd_kernel_rows(path, w, dy, x, plain_calls=3))
    del w
    torch.cuda.empty_cache()
    return rows


def _recurrent_spc_retrain(dev, arch: str) -> tuple:
    """SpC-Retrain of ``arch`` at full width on RECURRENT_TRAIN_LAYERS[arch]
    layers in bf16 (``_timed_spc_retrain``), from seed-0 weights whose
    blocks have spread norms (``_spread_norms``: every projection, the
    recurrent ones and an untied head included): the block sparsity of the
    recurrent projections in SPARSITY_BAND, every projection of the plan's
    min_size or more compressed, one launch of each training kernel per compressed matrix and layer a
    debias step."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=RECURRENT_TRAIN_LAYERS[arch])
    phase(f"{arch} training: SpC-Retrain at full width, {cfg.n_layers} of "
          f"{full.n_layers} layers (the main path)")
    model = build(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    _spread_norms(params, BLOCK, gen)
    min_size = CompressionPlan(block=BLOCK).min_size
    n_proj = sum(t.shape[0] if t.dim() == 3 else 1
                 for t in _projections(params)
                 if t.shape[-2] * t.shape[-1] >= min_size)
    log(f"  {sum(t.numel() for t in tree_leaves(params)):,} parameters, "
        f"{n_proj} projections a pass")
    run = _timed_spc_retrain(dev, model, params, DEBIAS_STEPS)
    del params
    cp = run.pop("cp")
    where = RECURRENT_WHERE[arch]
    sparsity, resident, total = _block_sparsity(cp, where)
    log(f"  block sparsity of the recurrent projections {where} after SpC: "
        f"{sparsity:.4f} ({resident} of {total} (8, 128) blocks resident), "
        f"all compressed weights {_block_sparsity(cp)[0]:.4f}, band "
        f"{SPARSITY_BAND}")
    if not SPARSITY_BAND[0] <= sparsity <= SPARSITY_BAND[1]:
        raise SystemExit(f"{arch}: recurrent block sparsity {sparsity:.4f} "
                         "outside the band")
    if _per_pass(cp) != (n_proj, 0):
        raise SystemExit(f"{arch}: expected all {n_proj} projections "
                         f"compressed, got {[p for p, _ in iter_bcsr(cp)]}")
    _check_train_counts(f"{arch} SpC-Retrain", run["launches"], DEBIAS_STEPS,
                        n_proj, 0, run["opt_steps"])
    return cp, dict(run, sparsity=sparsity)


def _recurrent_train_compare(dev, arch: str, cp) -> dict:
    """The kernel path against the plain path in f32 (``sparse_backend``
    'auto' against 'ref') on the SpC-Retrain result (its cut depth), over
    COMPARE_STEPS debias steps from the same stores, every kernel call of
    the kernel path (forward and backward) held to its plain version on
    its inputs: the losses within LOSS_RTOL, step 1's dx per projection
    call and dw per layer within GRAD_RTOL of their largest |value|, and
    the stores' updates after COMPARE_STEPS steps within UPDATE_RTOL of
    their norm."""
    f32 = dataclasses.replace(get_config(arch), compute_dtype="float32",
                              n_layers=RECURRENT_TRAIN_LAYERS[arch])
    phase(f"{arch} training: kernel path vs plain path (f32 debias, "
          f"{f32.n_layers} layers)")
    data = TokenStreamConfig(vocab=f32.vocab, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH)
    trainable, rebuild = split_trainable(cp)
    base = {"dense": tree_map(torch.clone, trainable["dense"]),
            "bcsr_data": {p: d.clone() for p, d in
                          trainable["bcsr_data"].items()}}
    del trainable
    runs = {}
    for backend in ("auto", "ref"):
        model = build(f32, device=dev, sparse_backend=backend)
        tr = {"dense": tree_map(torch.clone, base["dense"]),
              "bcsr_data": {p: d.clone() for p, d in base["bcsr_data"].items()}}
        loss0, dxs, dws = _first_grads(model, tr, rebuild,
                                       token_batch(data, 0, device=dev))
        opt = optimizers.prox_adam(COMPARE_LR, lam=0.0)
        state = TrainState(params=tr, opt_state=opt.init(tr),
                           mask=masks.zero_mask(tr), step=0)
        step = make_train_step(model, opt, param_transform=rebuild)
        losses = []
        held = contextlib.ExitStack()
        fwd_errs = bwd_errs = []
        if backend == "auto":
            fwd_errs = held.enter_context(_held_calls(f"{arch} f32 debias"))
            bwd_errs = held.enter_context(_held_backward(f"{arch} f32 debias"))
        with held:
            _reset_all()
            for i in range(COMPARE_STEPS):
                state, met = step(state, token_batch(data, i, device=dev))
                losses.append(float(met["loss"]))
        log(f"  {backend}: losses {losses}, launches {_all_launches()}"
            + (f"; {len(fwd_errs)} forward and {len(bwd_errs)} backward "
               f"kernel calls held to their plain versions, max |diff| "
               f"{max(fwd_errs, default=0.0):.3e} / "
               f"{max(bwd_errs, default=0.0):.3e}"
               if backend == "auto" else ""))
        if backend == "auto" and dev.type == "cuda" and not (
                fwd_errs and bwd_errs):
            raise SystemExit(f"{arch} f32 debias: no kernel call was held")
        runs[backend] = (loss0, dxs, dws, losses,
                         {p: v - base["bcsr_data"][p] for p, v in
                          state.params["bcsr_data"].items()})
        del state, step, model, tr
        torch.cuda.empty_cache()
    k, p = runs["auto"], runs["ref"]
    for a, b in zip(k[3], p[3]):
        if abs(a - b) > LOSS_RTOL * abs(b):
            raise SystemExit(f"{arch} debias losses differ: {k[3]} vs {p[3]}")
    n_calls = sum(_per_pass(cp))
    if len(k[1]) != len(p[1]) or len(k[1]) != n_calls:
        raise SystemExit(f"dx taps: {len(k[1])} and {len(p[1])}, expected "
                         f"{n_calls}")
    dx_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(k[1], p[1]))
    dw_err = 0.0
    for path, gk in k[2].items():
        gp = p[2][path]
        for idx in np.ndindex(*gk.shape[:-3]):
            scale = gp[idx].abs().max().clamp_min(1e-30)
            dw_err = max(dw_err, float((gk[idx] - gp[idx]).abs().max()
                                       / scale))
    upd_err = max(float((k[4][q] - p[4][q]).norm()
                        / p[4][q].norm().clamp_min(1e-30)) for q in k[4])
    log(f"  f32 debias, kernels vs plain: step-1 loss {k[0]:.6f} vs "
        f"{p[0]:.6f}; dx max err / max|dx| per call {dx_err:.3e}, dw per "
        f"layer {dw_err:.3e} (bound {GRAD_RTOL}); block-store updates after "
        f"{COMPARE_STEPS} steps: |diff| / |update| {upd_err:.3e} (bound "
        f"{UPDATE_RTOL})")
    if dx_err > GRAD_RTOL or dw_err > GRAD_RTOL or upd_err > UPDATE_RTOL:
        raise SystemExit(f"{arch}: kernel path and plain path disagree")
    return {"losses": (k[3], p[3]), "dx_err": dx_err, "dw_err": dw_err,
            "upd_err": upd_err}


def recurrent_train_phase(dev, arch: str, cp) -> dict:
    """Recurrent-family training (``arch``): for recurrentgemma-9b the
    backward kernels at its mlp.wi (rows 1br / 4r, on ``cp``, the serving
    phase's BlockCSR); SpC-Retrain at full width on a cut depth; the
    kernel path against the plain path in f32 there; debias at full width
    and depth on ``cp`` (trained in place); and the training and serving
    CLIs on the reduced family."""
    result = {}
    if arch == HYBRID:
        phase(f"{arch} training: the backward kernels at mlp.wi (rows "
              "1br / 4r)")
        result["kernel_rows"] = _recurrent_train_rows(dev, cp)
    cp2, result["spc_retrain"] = _recurrent_spc_retrain(dev, arch)
    torch.cuda.empty_cache()
    result["compare"] = _recurrent_train_compare(dev, arch, cp2)
    del cp2
    torch.cuda.empty_cache()
    phase(f"{arch} training: debias at full width and depth (bf16)")
    result["debias_full"] = _debias_full(dev, get_config(arch), cp, arch)
    result["cli"] = _reduced_train_cli(dev, arch, RECURRENT_WHERE[arch],
                                       RECURRENT_CLI_COMPRESSED[arch])
    return result


def _recurrent_train_table_rows(table, rt, card) -> None:
    """Rows 1br / 4r: ``spmm_t`` and the SDDMM at recurrentgemma-9b's
    layer-0 mlp.wi ((12288, 4096), bf16 dY, x and store, M = 512); launches
    are the full-depth debias run's, and the cut-depth SpC-Retrain run's
    beside them."""
    path, dt = RECURRENT_TRAIN_TABLE
    for name, key, source, replaces in (
            ("bsr_spmm_t_recurrent", "bsr_spmm_t",
             "src/repro_torch/csrc/bsr_spmm.cu",
             "src/repro/kernels/bsr_spmm/bsr_spmm.py:163"),
            ("bsr_sddmm_recurrent", "bsr_sddmm",
             "src/repro_torch/csrc/bsr_sddmm.cu",
             "src/repro/kernels/bsr_sddmm/bsr_sddmm.py:44")):
        rows = rt["kernel_rows"]
        r = rows[(key, path, dt)]
        launch = "spmm_t" if key == "bsr_spmm_t" else "bsr_sddmm"
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": rt["debias_full"]["launches"][launch],
            "spc_retrain_launches": rt["spc_retrain"]["launches"][launch],
            "max_abs_err": max(v["max_abs_err"] for q, v in rows.items()
                               if q[0] == key),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": f"{HYBRID} layer 0 mlp.wi {r['shape']} M={TRAIN_M} "
                     f"{'dy' if key == 'bsr_spmm_t' else 'x'}=bfloat16 "
                     "store=bfloat16",
            "card": card})


def _moe_train_rows(table, mt, card) -> None:
    """Rows 1be / 4e: the expert backward at olmoe-1b-7b's layer-0 ewi (64
    experts of (1024, 2048), bf16 dY, x and store, M = 80, every row;
    beside it the routed rows, f32 dY and x, and M = 8); launches are the
    SpC-Retrain run's (its debias steps), and the full-depth debias run's
    beside them."""
    proj, m_rows, dt = MOE_TRAIN_TABLE
    f32 = torch.float32
    for name, key in (("bsr_spmm_t_experts", "spmm_t_experts"),
                      ("bsr_sddmm_experts", "bsr_sddmm_experts")):
        rows = mt["kernel_rows"]
        r = rows[(key, proj, m_rows, dt, "full")]
        rr = rows[(key, proj, m_rows, dt, "routed")]
        rf = rows[(key, proj, m_rows, f32, "full")]
        r8 = rows[(key, proj, 8, dt, "routed")]
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/bsr_experts_bwd.cu",
            "replaces": ("src/repro/kernels/bsr_spmm/bsr_spmm.py:163"
                         if key == "spmm_t_experts" else
                         "src/repro/kernels/bsr_sddmm/bsr_sddmm.py:44"),
            "launches": mt["spc_retrain"]["launches"][key],
            "full_depth_debias_launches": mt["debias_full"]["launches"][key],
            "max_abs_err": max(v["max_abs_err"] for q, v in rows.items()
                               if q[0] == key),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "singles_ms": r["singles_ms"],
            "routed_ms": rr["ms"], "routed_bound_ms": rr["bound_ms"],
            "routed_bound_by": rr["bound_by"],
            "routed_empty_experts": rr["empty_experts"],
            "f32_ms": rf["ms"], "f32_bound_ms": rf["bound_ms"],
            "f32_library_ms": rf["library_ms"],
            "m8_routed_ms": r8["ms"], "m8_routed_bound_ms": r8["bound_ms"],
            "shape": f"{MOE} layer 0 {proj}, {r['experts']} experts of "
                     f"{r['matrix_shape']}, M={m_rows} dy=x=bfloat16 "
                     "store=bfloat16",
            "card": card})


def _moe_table_rows(table, moe, card) -> None:
    """Rows 1e / 2e: the expert launch at olmoe-1b-7b's ewi (64 experts,
    bf16 x): the decode kernel at M = 8 (a generate decode step's capacity,
    and an engine decode tick's) for the f32 store, palette-8 and
    palette-4, and the tile kernel at M = 40 (an engine prefill tick's) for
    the f32 store; launches are the engine run's of that kernel (and
    ``generate``'s beside them)."""
    rows = moe["expert_rows"]
    for name, fmt, m_rows, kern in (
            ("bsr_spmm_experts", "bcsr", 8, "decode"),
            ("bsr_spmm_experts_tile", "bcsr", 40, "tile"),
            ("bsr_spmm_palette8_experts", "pal8", 8, "decode"),
            ("bsr_spmm_palette4_experts", "pal4", 8, "decode")):
        r = rows[(fmt, "ewi", m_rows, torch.bfloat16)]
        rr = rows[(fmt, "ewi", m_rows, "routed")]
        wrapper = "spmm_experts" if fmt == "bcsr" else "spmm_palette_experts"
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/bsr_spmm_experts.cu",
            "replaces": REPLACES["bsr_spmm" if fmt == "bcsr"
                                 else "bsr_spmm_palette8"],
            "launches": moe[f"engine_{fmt}"][kern],
            "generate_launches": moe[f"generate_{fmt}"][kern],
            "max_abs_err": max(v["max_abs_err"] for k, v in rows.items()
                               if k[0] == fmt),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bound_bf16_ms": r["bound_bf16_ms"], "library_ms": r["library_ms"],
            "bf16_matmul_ms": r["bf16_matmul_ms"],
            "singles_ms": r.get("singles_ms"),
            "routed_ms": rr["ms"], "routed_bound_ms": rr["bound_ms"],
            "routed_bound_by": rr["bound_by"],
            "routed_plain_ms": rr["plain_ms"],
            "routed_max_abs_err": rr["max_abs_err"],
            "routed_empty_experts": rr["empty_experts"],
            "routed_largest_count": rr["largest_count"],
            "shape": f"{kern} form, {wrapper}, {MOE} layer 0 ewi, "
                     f"{r['experts']} experts of {r['matrix_shape']}, "
                     f"M={m_rows} x=bfloat16; ms / bound_ms: every row, "
                     "routed_*: the rows layer 0's router fills",
            "card": card})


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
    r = train_rows[("prox_adam_tree", "debias tree")]
    table.append({
        "name": "prox_adam_debias_tree", "route": "cuda",
        "source": "src/repro_torch/csrc/prox_adam.cu",
        "replaces": "src/repro/kernels/prox_adam/prox_adam.py:69",
        "launches": train_counts["prox_adam"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "shape": f"smollm-360m's debias tree, {r['leaves']} leaves "
                 f"({r['numel']} f32 elements), one launch, with the prox; "
                 f"one launch a leaf {r['per_leaf_ms']:.6f} ms",
        "card": card})


# ---------------------------------------------------------------------------
# the paper's CNN pipeline
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _adam_calls(plain: bool):
    """Within the block, every ``prox_adam`` tree call of the optimizers
    (one an optimizer step) either runs the kernel, with every leaf held
    bit-equal to the plain version computed on its inputs before the
    in-place launch and the launches held to one per K leaves (``plain``
    False), or runs the plain version on the card (``plain`` True).
    Yields [calls held, leaves held]."""
    kernel = adam_ops.fused_tree_update
    held = [0, 0]

    def call(ws, gs, ms, vs, scalars, *, rule="adam", prox=None,
             predicate=None):
        want = adam_ops.fused_tree_update_ref(ws, gs, ms, vs, scalars,
                                              rule=rule, prox=prox)
        if plain:
            for leaf, out in zip(zip(ws, ms, vs), want):
                for t, x in zip(leaf, out):
                    t.copy_(x)
            return ws, ms, vs
        before = adam_ops.launches["prox_adam"]
        kernel(ws, gs, ms, vs, scalars, rule=rule, prox=prox)
        launched = adam_ops.launches["prox_adam"] - before
        held[0] += 1
        if launched != math.ceil(len(ws) / adam_ops.K):
            raise SystemExit(f"cnn: prox_adam call {held[0]} over {len(ws)} "
                             f"leaves made {launched} launches")
        for leaf, out in zip(zip(ws, ms, vs), want):
            for name, a, b in zip("wmv", leaf, out):
                if not torch.equal(a, b):
                    raise SystemExit(
                        f"cnn: prox_adam call {held[0]} ({name}, "
                        f"{tuple(a.shape)}) differs from plain, max err "
                        f"{float((a.float() - b.float()).abs().max())}")
            held[1] += 1
        return ws, ms, vs

    adam_ops.fused_tree_update = call
    try:
        yield held
    finally:
        adam_ops.fused_tree_update = kernel


def _cnn_pipeline_run() -> dict:
    """``python -m repro_torch.launch.paper_cnn`` at its full constants,
    in process, with the launch counters read around it."""
    _reset_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = paper_cnn.main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _all_launches()
    log(f"cnn: launch/paper_cnn in {wall:.2f} s, launches {counts}")
    if counts["prox_adam"] != CNN_RUN_LAUNCHES or \
            any(v for k, v in counts.items() if k != "prox_adam"):
        raise SystemExit(f"cnn: expected {CNN_RUN_LAUNCHES} prox_adam "
                         f"launches and no other, got {counts}")
    names = [r[0] for r in rows]
    if names != ["reference", "SpC", "SpC(Retrain)", "Pru", "Pru(Retrain)",
                 "MM"] or not all(0.0 <= a <= 1.0 and 0.0 <= c <= 1.0
                                  for _, a, c in rows) or rows[1][2] <= 0:
        raise SystemExit(f"cnn: unexpected table {rows}")
    return {"rows": rows, "wall_s": wall, "launches": counts["prox_adam"]}


def _cnn_compare(dev) -> dict:
    """A cut ``spc_with_retrain`` on LeNet-5 (f32, cuDNN deterministic)
    twice from the same seed: with every prox_adam call on the kernel, held
    bit-equal to its plain version, and with the plain version; losses per
    step, compression rates and final params equal."""
    model = CNN_ZOO["lenet5"]
    steps, retrain = CNN_CUT
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    make = cnn_train.make_cnn_step
    runs = {}
    try:
        for plain in (False, True):
            losses = []

            def recorded(m, opt, losses=losses):
                step = make(m, opt)

                def run(*a, **kw):
                    out = step(*a, **kw)
                    losses.append(out[2])
                    return out
                return run

            cnn_train.make_cnn_step = recorded
            with _adam_calls(plain) as held:
                out = cnn_train.spc_with_retrain(model, lam=paper_cnn.LAM,
                                                 steps=steps,
                                                 retrain_steps=retrain,
                                                 device=dev)
            runs[plain] = (out, [float(x) for x in losses], list(held))
    finally:
        cnn_train.make_cnn_step = make
        torch.backends.cudnn.deterministic = det
    (k_out, k_loss, held), (p_out, p_loss, _) = runs[False], runs[True]
    if held != [steps + retrain, CNN_LENET_LEAVES * (steps + retrain)]:
        raise SystemExit(f"cnn: {held} prox_adam calls and leaves held, "
                         f"expected {steps + retrain} calls (one a step) "
                         f"and {CNN_LENET_LEAVES * (steps + retrain)} leaves")
    if k_loss != p_loss:
        raise SystemExit(f"cnn: losses differ, kernel {k_loss}, plain {p_loss}")
    diff = 0.0
    for key in ("spc", "retrain"):
        if k_out[f"{key}_compression"] != p_out[f"{key}_compression"]:
            raise SystemExit(f"cnn: {key} compression differs")
        for (path, a), (_, b) in zip(
                flatten_with_path(k_out[f"{key}_params"]),
                flatten_with_path(p_out[f"{key}_params"])):
            diff = max(diff, float((a - b).abs().max()))
            if not torch.equal(a, b):
                raise SystemExit(f"cnn: {key} params {path} differ")
    res = {"held_calls": held[0], "held_leaves": held[1], "losses": k_loss,
           "spc_compression": k_out["spc_compression"],
           "retrain_compression": k_out["retrain_compression"],
           "max_param_diff": diff}
    log(f"cnn: kernel path vs plain path: {json.dumps(res)}")
    return res


def _cnn_steps(dev) -> dict:
    """One SpC step (prox_adam, lr 1e-3, lam 1) at batch 128 for each net at
    full width: host-clock step time (synchronized), the net's peak memory
    (params, Adam's moments, a batch and the step's activations: the peak
    over what was allocated before its init) and prox_adam launches per
    step, held to one (every net has at most K leaves)."""
    out = {}
    for name, model in CNN_ZOO.items():
        # garbage of earlier phases (and nets) freed now, not during the
        # step, where it would hide the net's own peak
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        opt = optimizers.prox_adam(1e-3, lam=paper_cnn.LAM)
        state = opt.init(params)
        step = cnn_train.make_cnn_step(model, opt)
        data = cnn_train.data_for(model, CNN_BATCH)
        batches = [image_batch(data, s, device=dev)
                   for s in range(CNN_TIMED_STEPS + 1)]
        params, state, _ = step(params, state, batches[0])   # warm-up
        torch.cuda.synchronize()
        _reset_all()
        times = []
        for b in batches[1:]:
            t0 = time.perf_counter()
            params, state, loss = step(params, state, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        per_step = adam_ops.launches["prox_adam"] / CNN_TIMED_STEPS
        leaves = len(flatten_with_path(params))
        # (the reference's He init takes a filter's height as its fan-in,
        # so the deeper nets' random logits are huge: the loss is logged,
        # not held)
        if leaves > adam_ops.K or per_step != 1:
            raise SystemExit(f"cnn: {name} step: {per_step} prox_adam "
                             f"launches a step over {leaves} leaves")
        out[name] = {"step_ms": sorted(times), "launches_per_step": per_step,
                     "launches": adam_ops.launches["prox_adam"],
                     "steps": CNN_TIMED_STEPS, "leaves": leaves,
                     "peak_gib": (torch.cuda.max_memory_allocated() - base)
                     / 2**30,
                     "weights": cnn_weight_count(params), "loss": float(loss)}
        log(f"cnn: {name} SpC step at batch {CNN_BATCH}: "
            f"{json.dumps(out[name])}")
        del params, state, batches
    torch.cuda.empty_cache()
    return out


def _cnn_adam_rows(dev) -> dict:
    """Row 5c: prox_adam (with the prox) at LeNet-5's fc1 and at VGG16's
    largest filter, against its plain version and its bytes bound."""
    sc = adam_ops.make_scalars(1e-3, PROX_TAU / 1e-3, 0.9, 0.999, 1e-8, 3)
    rows = {}
    for leaf, shape in CNN_ADAM_LEAVES:
        numel = math.prod(shape)

        def make():
            return (torch.randn(shape, device=dev),
                    torch.randn(shape, device=dev),
                    torch.randn(shape, device=dev) * 0.1,
                    torch.rand(shape, device=dev) * 0.01)

        def kernel(w, g, m, v, sc):
            return adam_ops.fused_update_leaf(w, g, m, v, sc)

        def plain(w, g, m, v, sc):
            return adam_ops.fused_prox_update_ref(w, g, m, v, sc)
        w, g, m, v = make()
        want = plain(w, g, m, v, sc)
        got = kernel(w.clone(), g, m.clone(), v.clone(), sc)
        err = max(_check(f"prox_adam {leaf}", a, b, ADAM_ATOL, ADAM_ATOL)
                  for a, b in zip(got, want))
        sets = copies(lambda: make() + (sc,), 16 * numel)
        row = {"kernel": "prox_adam", "leaf": leaf, "shape": list(shape),
               "numel": numel, "max_abs_err": err,
               "bit_equal": all(torch.equal(a, b) for a, b in zip(got, want)),
               "ms": time_ms(kernel, sets),
               "plain_ms": time_ms(plain, sets, queued_calls(PLAIN_ADAM_OPS)),
               "library_ms": None}
        row.update(zip(("bound_ms", "bound_by", "bytes", "flops"),
                       _ops_bound(28 * numel, 10 * numel)))
        log(json.dumps(row))
        rows[leaf] = row
    return rows


def _cnn_step_rows(dev) -> dict:
    """Row 5s: one SpC step's update over every leaf of LeNet-5 and
    ResNet-32 at their real shapes (the soft threshold where the default
    predicate holds, as ``core.optimizers`` flags it), as one launch."""
    sc = adam_ops.make_scalars(1e-3, PROX_TAU / 1e-3, 0.9, 0.999, 1e-8, 3)
    rows = {}
    for name in CNN_STEP_NETS:
        params = CNN_ZOO[name].init(torch.Generator(dev).manual_seed(0), dev)
        flat = flatten_with_path(params)
        prox = [prox_lib.default_regularized_predicate(keystr(k), p)
                for k, p in flat]
        rows[name] = _tree_row(f"{name} step", [p.shape for _, p in flat],
                               prox, sc, dev)
        del params, flat
    return rows


def cnn_phase(dev) -> dict:
    phase("cnn: launch/paper_cnn (the paper's pipeline)")
    t0 = time.perf_counter()
    res = {"run": _cnn_pipeline_run()}
    phase("cnn: kernel path vs plain path (f32, LeNet-5, cuDNN deterministic)")
    res["compare"] = _cnn_compare(dev)
    phase(f"cnn: one SpC step at batch {CNN_BATCH} per net, full width")
    res["steps"] = _cnn_steps(dev)
    phase("cnn: prox_adam at the CNN leaves (row 5c)")
    res["adam_rows"] = _cnn_adam_rows(dev)
    phase("cnn: one step's update over every leaf, one launch (row 5s)")
    res["step_rows"] = _cnn_step_rows(dev)
    res["phase_s"] = time.perf_counter() - t0
    log(f"cnn: phase took {res['phase_s']:.1f} s")
    return res


def _cnn_rows(table, cnn, card) -> None:
    """Rows 5c and 5s: prox_adam at the CNN leaves and over a step's
    leaves; launches per launch/paper_cnn run."""
    for leaf, r in cnn["adam_rows"].items():
        table.append({
            "name": "prox_adam_cnn", "route": "cuda",
            "source": "src/repro_torch/csrc/prox_adam.cu",
            "replaces": "src/repro/kernels/prox_adam/prox_adam.py:69",
            "launches": cnn["run"]["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": f"{leaf} {tuple(r['shape'])} f32, with the prox",
            "card": card})
    for name, r in cnn["step_rows"].items():
        # LeNet-5's launches are launch/paper_cnn's run; another net's, its
        # timed SpC steps in _cnn_steps
        steps = cnn["steps"][name]
        launches, run = (cnn["run"]["launches"], "launch/paper_cnn") \
            if name == "lenet5" else \
            (steps["launches"], f"{steps['steps']} SpC steps")
        table.append({
            "name": "prox_adam_cnn_step", "route": "cuda",
            "source": "src/repro_torch/csrc/prox_adam.cu",
            "replaces": "src/repro/kernels/prox_adam/prox_adam.py:69",
            "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": f"{name}: one step's update over its {r['leaves']} "
                     f"leaves ({r['numel']} f32 elements), one launch; "
                     f"one launch a leaf {r['per_leaf_ms']:.6f} ms; "
                     f"launches of its {run}",
            "card": card})


def main() -> int:
    faulthandler.enable()       # a hard crash prints every thread's stack
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
    paged_launches, single = engine_phase(dev, formats)
    router_phase(dev, formats, single)
    mesh_phase(dev, formats["bcsr"])
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
    hybrid, cp = recurrent_phase(dev, HYBRID, HYBRID_PROMPTS,
                                 f32_layers=HYBRID_F32_LAYERS,
                                 kv_splits=HYBRID_KV_SPLITS)
    log(f"{HYBRID}: {json.dumps({k: v for k, v in hybrid.items() if k != 'spmm_1c'}, default=str)}")
    hybrid_train = recurrent_train_phase(dev, HYBRID, cp)
    del cp
    torch.cuda.empty_cache()
    log(f"{HYBRID} training: {json.dumps({k: v for k, v in hybrid_train.items() if k != 'kernel_rows'}, default=str)}")
    _recurrent_train_table_rows(table, hybrid_train, card)
    r = next(x for x in hybrid["paged_rows"] if x["case"] == "hd256 prefill"
             and x["kv_splits"] == HYBRID_KV_SPLITS)
    _paged_row(table, "paged_flash_attention_hd256_prefill", r,
               hybrid["engine_bcsr"]["paged"],
               max(x["max_abs_err"] for x in hybrid["paged_rows"]), card)
    _spmm_rows(table, rows, launches, hybrid, card)
    rwkv, cp = recurrent_phase(dev, RWKV, RWKV_PROMPTS,
                               f32_layers=RWKV_F32_LAYERS)
    log(f"{RWKV}: {json.dumps(rwkv, default=str)}")
    rwkv_train = recurrent_train_phase(dev, RWKV, cp)
    del cp
    torch.cuda.empty_cache()
    log(f"{RWKV} training: {json.dumps(rwkv_train, default=str)}")
    moe, cp = moe_phase(dev)
    log(f"{MOE}: {json.dumps({k: v for k, v in moe.items() if k != 'expert_rows'}, default=str)}")
    _moe_table_rows(table, moe, card)
    moe_train = moe_train_phase(dev, cp)
    del cp
    torch.cuda.empty_cache()
    log(f"{MOE} training: {json.dumps({k: v for k, v in moe_train.items() if k != 'kernel_rows'}, default=str)}")
    _moe_train_rows(table, moe_train, card)
    flash_rows, flash_launches, model_launches = flash_phase(dev)
    flash_err = max(v["max_abs_err"] for v in flash_rows)
    _flash_row(table, "flash_attention", flash_rows[FLASH_TABLE_ROW],
               flash_launches, model_launches, flash_err, card)
    _flash_row(table, "flash_attention_smollm_prefill",
               flash_rows[FLASH_PREFILL_ROW], flash_launches, model_launches,
               flash_err, card)
    cnn = cnn_phase(dev)
    _cnn_rows(table, cnn, card)

    phase("kernel table")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
