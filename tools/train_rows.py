#!/usr/bin/env python3
"""Time the training kernels of a checkout, to hold a change of
``csrc/bsr_sddmm.cu``, ``spmm_t`` or the expert backward against its
parent on one card.

    python3 tools/train_rows.py ROOT >> rows.log

Builds the kernels of the checkout at ROOT (on first use) and prints one
JSON line: three timings each (``chip_smoke.time_ms``, cold in L2) of

* the SDDMM and ``spmm_t`` at smollm-360m's mlp.wi ((2560, 960), (8, 128)
  blocks at 0.9, a bf16 store), M = 512, bf16 (kernel-table rows 4, 1b);
* the same at recurrentgemma-9b's mlp.wi ((12288, 4096)), M = 512, bf16
  (rows 4r, 1br);
* ``bsr_weight_grad_experts`` and ``spmm_t_experts`` at olmoe-1b-7b's ewi
  (64 experts of (1024, 2048), the same blocks and sparsity, seed-0
  random weights), M = 80, bf16 dY, x and store, every row (rows 4e, 1be),
  and with f32 dY and x (the cotangent training handed them before it
  came in bf16).

Run it for the parent (unpacked with ``git archive`` into a directory
``.gitignore`` lists, such as ``build/parent``) and the change in turns in
one call on the card: parent, change, change, parent.
"""
import json
import sys

tree = sys.argv[1]
sys.path[:0] = [tree, tree + "/src"]

import dataclasses  # noqa: E402
import math  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.sparse.compress import (CompressionPlan,  # noqa: E402
                                         _pad_stack, _prune_to_bcsr)

E, D, FF, M_EXPERTS = 64, 2048, 1024, 80

cs._build.build_all()                 # one nvcc per source, all at once
dev = torch.device("cuda", 0)
rng = np.random.default_rng(1)
out = {"tree": tree}
for tag, (n, k) in (("", (2560, 960)), ("_rg", (12288, 4096))):
    w32 = cs._weight(rng, n, k, dev)
    w = dataclasses.replace(w32, data=w32.data.to(torch.bfloat16))
    dy = torch.randn(512, n, device=dev).bfloat16()
    x = torch.randn(512, k, device=dev).bfloat16()
    sets = cs.copies(lambda: (x.clone(), dy.clone(), w), cs.tensor_bytes(x, dy))
    tsets = cs.copies(lambda: (dy.clone(), w.map(torch.clone)),
                      cs.tensor_bytes(dy, w.data))
    out[f"sddmm{tag}_ms"] = [cs.time_ms(cs.sddmm_ops.bsr_weight_grad, sets)
                             for _ in range(3)]
    out[f"spmm_t{tag}_ms"] = [cs.time_ms(cs.ops.spmm_t, tsets)
                              for _ in range(3)]
    del w32, w, sets, tsets

gen = torch.Generator(device=dev).manual_seed(0)
views = torch.randn(E, FF, D, generator=gen, device=dev) / math.sqrt(D)
w32 = _pad_stack(_prune_to_bcsr(views, cs.BLOCK, cs.SPARSITY),
                 CompressionPlan(block=cs.BLOCK), (E,), 1 << 40)
del views
w = dataclasses.replace(w32, data=w32.data.to(torch.bfloat16))
for dt in (torch.bfloat16, torch.float32):
    tag = "" if dt == torch.bfloat16 else "_f32"
    dy = torch.randn(E, M_EXPERTS, FF, generator=gen, device=dev).to(dt)
    x = torch.randn(E, M_EXPERTS, D, generator=gen, device=dev).to(dt)
    sets = cs.copies(lambda: (x.clone(), dy.clone(), w), cs.tensor_bytes(x, dy))
    tsets = cs.copies(lambda: (dy.clone(), w.map(torch.clone)),
                      cs.tensor_bytes(dy, w.data))
    out[f"sddmm_experts{tag}_ms"] = [
        cs.time_ms(cs.sddmm_ops.bsr_weight_grad_experts, sets,
                   cs.MOE_TIMED_CALLS) for _ in range(3)]
    out[f"spmm_t_experts{tag}_ms"] = [
        cs.time_ms(cs.ops.spmm_t_experts, tsets, cs.MOE_TIMED_CALLS)
        for _ in range(3)]
    del sets, tsets
print(json.dumps(out))
