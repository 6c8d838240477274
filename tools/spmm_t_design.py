#!/usr/bin/env python3
"""Where the time of ``spmm_t`` (``csrc/bsr_spmm.cu``, ``bsr_tile_bwd``) goes,
on one NVIDIA GPU:

    python3 tools/spmm_t_design.py        # from the root of a checkout

* tile widths: copies of the source with thread blocks of 32 and 128
  columns of dX (``kTCols``; the kernel takes 64), built by nvcc under
  ``build/spmm_t_design/``, against the shipped one at smollm-360m's seven
  projections (M = 512, bf16 dY and store), each at 32 and 64 rows of dX a
  thread block (the ``mt`` argument of the C interface); the shipped one
  also with f32 dY, at 32 and 64 rows;
* M: the shipped kernel at mlp.wi (2560 x 960, (8, 128) blocks at 0.9
  block sparsity) and M = 64 .. 4096 rows;
* jobs: the same at M = 512 and block sparsity 0.5 .. 0.98, which sets the
  resident blocks of the fullest block-column (16 of them make one job).

Every kernel call is first held to the plain version (2e-4 + 1e-4
relative); times are ``chip_smoke.time_ms`` (CUDA events, inputs cold in
L2). Prints one JSON line per measurement and the card's name and power
limit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._tiles import aligned16  # noqa: E402
from repro_torch.kernels.bsr_spmm import ops, ref  # noqa: E402
from repro_torch.sparse.compress import _prune_blocks_2d  # noqa: E402
from repro_torch.sparse.formats import dense_to_bcsr  # noqa: E402

OUT = ROOT / "build" / "spmm_t_design"
WIDTHS = (32, 128)                     # variants beside the shipped 64
SHIPPED = "constexpr int kTCols = 64;"


def build_variants() -> dict:
    """The C library of each tile width: the shipped one and copies of the
    source with ``kTCols`` changed, one nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "bsr_spmm.cu").read_text()
    assert src.count(SHIPPED) == 1
    procs = {}
    for width in WIDTHS:
        cu = OUT / f"bsr_spmm_{width}.cu"
        cu.write_text(src.replace(SHIPPED, f"constexpr int kTCols = {width};"))
        for header in _build.CSRC.glob("*.cuh"):
            (OUT / header.name).write_text(header.read_text())
        so = cu.with_suffix(".so")
        procs[width] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {64: ops._lib()}
    for width, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {width}-column copy:\n{out}")
        libs[width] = ctypes.CDLL(str(so))
        libs[width].bsr_spmm_t.argtypes = ops._lib().bsr_spmm_t.argtypes
        libs[width].bsr_spmm_t.restype = ctypes.c_int
    return libs


def spmm_t(lib, rows: int):
    """``ops.spmm_t`` on ``lib`` with ``rows`` rows of dX a thread block."""
    def call(dy, w):
        dx = torch.empty((dy.shape[0], w.shape[1]), device=dy.device)
        br, bc = w.block
        n_cols, jmax_t = w.gather_t_idx.shape
        err = lib.bsr_spmm_t(
            dy.data_ptr(), int(dy.dtype == torch.bfloat16), w.data.data_ptr(),
            int(w.data.dtype == torch.bfloat16), w.gather_t_idx.data_ptr(),
            w.gather_t_blk.data_ptr(), w.gather_t_nnz.data_ptr(), dx.data_ptr(),
            dy.shape[0], w.shape[0], w.shape[1], n_cols, jmax_t, br, bc,
            rows // 32, aligned16(dy, w.shape[0], br), aligned16(w.data, bc),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"bsr_spmm_t failed: CUDA error {err}")
        return dx
    return call


def weight(rng, n, k, sparsity, dev):
    w = (rng.standard_normal((n, k)) / math.sqrt(k)).astype(np.float32)
    w = dense_to_bcsr(_prune_blocks_2d(w, cs.BLOCK, sparsity), cs.BLOCK).to(dev)
    return dataclasses.replace(w, data=w.data.to(torch.bfloat16))


def timed(fn, dy, w) -> float:
    cs._check("spmm_t", fn(dy, w), ref.spmm_bwd_ref(dy, w), cs.KERNEL_ATOL,
              cs.KERNEL_RTOL)
    return cs.time_ms(fn, cs.copies(lambda: (dy.clone(), w.map(torch.clone)),
                                    cs.tensor_bytes(dy, w.data)))


def main() -> int:
    if not torch.cuda.is_available():
        print("spmm_t_design: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants()
    rng = np.random.default_rng(0)
    for name, (n, k) in cs.TRAIN_MATRICES:
        w = weight(rng, n, k, cs.SPARSITY, dev)
        dy = torch.randn(cs.TRAIN_M, n, device=dev).to(torch.bfloat16)
        row = {"measure": "tile width", "matrix": name, "M": cs.TRAIN_M,
               "wrapper_rows": ops.spmm_t_rows(cs.TRAIN_M, w.gather_t_idx.shape[0],
                                               cs.BLOCK[1], 132, False)}
        for width, lib in sorted(libs.items()):
            for rows in (32, 64):
                row[f"ms_cols{width}_rows{rows}"] = timed(spmm_t(lib, rows), dy, w)
        for rows in (32, 64):
            row[f"ms_f32_dy_rows{rows}"] = timed(spmm_t(libs[64], rows), dy.float(), w)
        print(json.dumps(row), flush=True)
    w = weight(rng, 2560, 960, cs.SPARSITY, dev)
    for m in (64, 128, 256, 512, 1024, 2048, 4096):
        dy = torch.randn(m, 2560, device=dev).to(torch.bfloat16)
        print(json.dumps({"measure": "M", "matrix": "mlp.wi", "M": m,
                          "ms": timed(ops.spmm_t, dy, w)}), flush=True)
    for sparsity in (0.5, 0.75, 0.9, 0.95, 0.98):
        w = weight(rng, 2560, 960, sparsity, dev)
        dy = torch.randn(cs.TRAIN_M, 2560, device=dev).to(torch.bfloat16)
        most = int(w.gather_t_nnz.max())
        print(json.dumps({"measure": "jobs", "matrix": "mlp.wi", "sparsity": sparsity,
                          "most_blocks_in_a_column": most, "jobs": -(-most // 16),
                          "ms": timed(ops.spmm_t, dy, w)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
