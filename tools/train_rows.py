#!/usr/bin/env python3
"""Time the single-matrix training kernels of a checkout, to hold a change
of ``csrc/bsr_sddmm.cu`` or of ``spmm_t`` against its parent on one card.

    python3 tools/train_rows.py ROOT >> rows.log

Builds the kernels of the checkout at ROOT (on first use) and prints one
JSON line: three timings each (``chip_smoke.time_ms``, cold in L2) of the
SDDMM and of ``spmm_t`` at smollm-360m's mlp.wi ((2560, 960), (8, 128)
blocks at 0.9, a bf16 store), M = 512, bf16 (kernel-table rows 4 and 1b).
Run it for the parent (unpacked with ``git archive`` into a directory
``.gitignore`` lists, such as ``build/parent``) and the change in turns in
one call on the card: parent, change, change, parent.
"""
import json
import sys

tree = sys.argv[1]
sys.path[:0] = [tree, tree + "/src"]

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

dev = torch.device("cuda", 0)
rng = np.random.default_rng(1)
w32 = cs._weight(rng, 2560, 960, dev)
w = dataclasses.replace(w32, data=w32.data.to(torch.bfloat16))
dy = torch.randn(512, 2560, device=dev).bfloat16()
x = torch.randn(512, 960, device=dev).bfloat16()
sets = cs.copies(lambda: (x.clone(), dy.clone(), w), cs.tensor_bytes(x, dy))
tsets = cs.copies(lambda: (dy.clone(), w.map(torch.clone)),
                  cs.tensor_bytes(dy, w.data))
out = {"tree": tree,
       "sddmm_ms": [cs.time_ms(cs.sddmm_ops.bsr_weight_grad, sets)
                    for _ in range(3)],
       "spmm_t_ms": [cs.time_ms(cs.ops.spmm_t, tsets) for _ in range(3)]}
print(json.dumps(out))
