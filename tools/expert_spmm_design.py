#!/usr/bin/env python3
"""Where the time of the expert forward (``csrc/bsr_spmm_experts.cu``,
``bsr_experts_fwd``) goes, on one NVIDIA GPU:

    python3 tools/expert_spmm_design.py [--variants=a,b] [--block=BR,BC]

(from a checkout's root). Builds copies of the source under
``build/expert_design/``, each with one change, and times them beside the
shipped one at olmoe-1b-7b's layer-0 ewi (64 experts of (1024, 2048),
(8, 128) blocks at 0.9, or ``--block``'s; an f32 store and palette-8), bf16 x, M = 1 and 8 (decode form; f32 x too), 40 and 80 (tile
form: an engine prefill tick's capacity and a training step's), with every
row computed and with the counts a random top-8 router gives M random
tokens:

* ``no_single_row``: a chunk with one occupied row on the 16-row m-tile
  like any other (the shipped kernel runs it on exact f32 FMAs);
* ``no_upper_skip`` / ``upper_skip_bf16``: an m-tile's rows 8 .. 15
  loaded (as zeros) and split also where all of them lie past the count,
  or skipped then with bf16 x too (the shipped kernel skips them with f32
  x only, a warp-uniform test);
* ``split2``: f32 operands split by ``tc::split2`` (two roundings a pair
  and a part; the shipped kernel rounds each pair with one packed
  conversion, the same bits);
* ``f32x_regs168`` / ``f32x_regs255``: f32 x at caps of 168 / 255
  registers (bf16 x at the shipped 128);
* ``early_tables``: the block-row's table entries loaded in the trip
  that reads rows[e], before the count is known (the shipped kernel loads
  them after it, beside the palette);
* ``regs168`` / ``regs255``: the register cap of 168 / 255 a thread
  (``__launch_bounds__`` with 3 / 2 thread blocks an SM; the shipped
  kernel takes 4, 128 registers); ``bounds43``: 128 in the decode form,
  168 in the tile form;
* ``prefetch`` / ``prefetch43``: the resident blocks' jobs in two stages
  of registers, job q + 1's table entries, block rows and (decode form) X
  rows loaded before job q's products run; at 168 registers, or 128 in
  the decode form;
* ``regs102`` / ``regs85``: caps of 102 / 85 registers (5 / 6 thread
  blocks an SM);
* ``tile_mt4`` / ``tile_mt1``: the tile form on chunks of 64 / 16 rows
  (the shipped one takes 32; 64: fewer warps, each block read once for
  more rows);
* ``warps8``: thread blocks of 8 warps (2 an SM);
* ``xsmem``: the decode form with X staged once per thread block in shared
  memory (its 16 rows of the expert's X, all K columns, 16 bytes a
  thread; the warps then read their 16-byte pieces from there), in place
  of each lane's 16-byte loads from device memory; decode
  form only (64 rows of K = 2048 would not fit).

``--variants=`` (empty) times the shipped kernel alone.

Every call is first held to the plain version (2e-4 + 1e-4 relative);
times are ``chip_smoke.time_ms`` (CUDA events, inputs cold in L2). Prints
each copy's registers and spills (ptxas), one JSON line per measurement,
and the card's name and power limit; writes the full ptxas reports to
``build/expert_design/ptxas.log``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import cuda_variants  # noqa: E402
from repro_torch.kernels.bsr_spmm import ops, ref  # noqa: E402
from repro_torch.sparse.compress import (CompressionPlan, _pad_stack,  # noqa: E402
                                         _prune_to_bcsr, quantize_bcsr)

OUT = ROOT / "build" / "expert_design"
E, TOP_K, D, FF = 64, 8, 2048, 1024
BOUNDS = "__launch_bounds__(kWarps * 32, 4)"
WARPS = "constexpr int kWarps = 4;"

# X staged in shared memory: rows [m0, m0 + 16 MT) of the expert's X (zero
# at and past its count), all K columns at a pitch of K + 8, before the
# warps start; the lanes then read their pieces from there.
XSMEM_LOADS = '''
template <typename T>
__device__ __forceinline__ void load_shared(Row32<T>& v, const T* p, int n);
template <>
__device__ __forceinline__ void load_shared(Row32<__nv_bfloat16>& v, const __nv_bfloat16* p, int n) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = n - 32 * q;
    if (m >= 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(p + 32 * q);
      v.w[4 * q] = a.x; v.w[4 * q + 1] = a.y; v.w[4 * q + 2] = a.z; v.w[4 * q + 3] = a.w;
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(p + 32 * q);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v.w[4 * q + e] = (2 * e < m ? (uint32_t)s[2 * e] : 0u) |
                         ((2 * e + 1 < m ? (uint32_t)s[2 * e + 1] : 0u) << 16);
    }
  }
}
template <>
__device__ __forceinline__ void load_shared(Row32<float>& v, const float* p, int n) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) v.v[8 * q + e] = 32 * q + e < n ? p[32 * q + e] : 0.f;
}

// acc (MT m-tiles'''
XSMEM_STAGE_AT = '''  const int mt_run = min(MT, (r - m0 + 15) / 16);  // m-tiles issued'''
XSMEM_STAGE = '''  extern __shared__ __align__(16) unsigned char xs_raw[];
  TX* const xs = reinterpret_cast<TX*>(xs_raw);
  const int pitch = K + 8;
  {
    constexpr int per = 16 / sizeof(TX);
    const int chunks = K / per;
    for (int i = threadIdx.x; i < 16 * MT * chunks; i += blockDim.x) {
      const int rr = i / chunks, c = (i - rr * chunks) * per;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + rr < r) v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + rr) * K + c));
      *reinterpret_cast<uint4*>(xs + rr * pitch + c) = v;
    }
    __syncthreads();
  }
''' + XSMEM_STAGE_AT
XSMEM_X_OLD = '''          if (ra < r) xa.load(x + (size_t)ra * K + xcol, xend - xcol, x_vec != 0);
          else xa.zero();
          if (upper) {
            if (rb < r) xb.load(x + (size_t)rb * K + xcol, xend - xcol, x_vec != 0);
            else xb.zero();
          }'''
XSMEM_X_NEW = '''          load_shared(xa, xs + (ra - m0) * pitch + xcol, xend - xcol);
          if (upper) load_shared(xb, xs + (rb - m0) * pitch + xcol, xend - xcol);'''
XSMEM_LAUNCH_OLD = '''  bsr_experts_fwd<MT, NT, TX, Blocks><<<grid, kWarps * 32, 0, st>>>('''
XSMEM_LAUNCH_NEW = '''  const size_t smem = (size_t)16 * MT * (K + 8) * sizeof(TX);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(bsr_experts_fwd<MT, NT, TX, Blocks>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  bsr_experts_fwd<MT, NT, TX, Blocks><<<grid, kWarps * 32, smem, st>>>('''

# The resident blocks' jobs (block j, 128-column chunk kc) in two stages of
# registers: job q + 1's table entries, block rows and (decode form) X rows
# are loaded before job q's products run.
LOOP_START = "\n  for (int j = 0; j < n_res; ++j) {\n    int c, s;"
LOOP_END = "\n  write_task<MT, NT>(y, acc, o, br, N, m0, m_end, r, lane);\n}"
PREFETCH_LOOP = '''    const int n_kc = (bc + bsr::kK - 1) / bsr::kK;
    const int jobs = n_res * n_kc;
    struct Stage {
      WRow w[NT];
      XRow xa, xb;                     // m-tile 0's X rows (decode form)
      int c, kc;
    };
    auto issue = [&](int q, Stage& st) {
      const int j = q / n_kc, kc = (q - j * n_kc) * bsr::kK;
      if (kc == 0 && j > 0 && (j & 31) == 0) {
        cl = sl = 0;
        if (j + lane < jmax) {
          cl = idx[(size_t)o * jmax + j + lane];
          sl = blk[(size_t)o * jmax + j + lane];
        }
      }
      const int c = __shfl_sync(kFull, cl, j & 31), s = __shfl_sync(kFull, sl, j & 31);
      st.c = c;
      st.kc = kc;
#pragma unroll
      for (int n = 0; n < NT; ++n) w.load(st.w[n], s, 8 * n + g, kc, t, pal);
      if constexpr (MT == 1) {
        const int xcol = c * bc + kc + 8 * t, xend = min(K, c * bc + bc);
        if (m0 + g < r) st.xa.load(x + (size_t)(m0 + g) * K + xcol, xend - xcol, x_vec != 0);
        else st.xa.zero();
        if (m0 + g + 8 < r) st.xb.load(x + (size_t)(m0 + g + 8) * K + xcol, xend - xcol, x_vec != 0);
        else st.xb.zero();
      }
    };
    float tb[MT][NT][4];
    auto products = [&](const WRow& wr, const XRow& xa, const XRow& xb, float (&tt)[4]) {
#pragma unroll
      for (int kk = 0; kk < bsr::kK / 16; ++kk) {
        uint32_t b0[WS], b1[WS], a0[XS], a1[XS], a2[XS], a3[XS];
        wr.frag(kk, 0, b0);
        wr.frag(kk, 1, b1);
        xa.frag(kk, 0, a0);
        xb.frag(kk, 0, a1);
        xa.frag(kk, 1, a2);
        xb.frag(kk, 1, a3);
#pragma unroll
        for (int jw = 0; jw < WS; ++jw)
#pragma unroll
          for (int i = 0; i + jw < bsr::order(XS, WS) && i < XS; ++i) {
            const uint32_t a[4] = {a0[i], a1[i], a2[i], a3[i]};
            F::mma(tt, a, b0[jw], b1[jw]);
          }
      }
    };
    auto compute = [&](const Stage& st) {
      if (st.kc == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) tb[m][n][q] = 0.f;
      }
      const int xcol = st.c * bc + st.kc + 8 * t, xend = min(K, st.c * bc + bc);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m >= mt_run) continue;
          if constexpr (MT == 1) {
            products(st.w[n], st.xa, st.xb, tb[0][n]);
          } else {
            XRow xa, xb;
            const int ra = m0 + 16 * m + g, rb = ra + 8;
            if (ra < r) xa.load(x + (size_t)ra * K + xcol, xend - xcol, x_vec != 0);
            else xa.zero();
            if (rb < r) xb.load(x + (size_t)rb * K + xcol, xend - xcol, x_vec != 0);
            else xb.zero();
            products(st.w[n], xa, xb, tb[m][n]);
          }
        }
      if (st.kc + bsr::kK >= bc) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[m][n][q] += tb[m][n][q];
      }
    };
    Stage sa, sb;
    if (jobs > 0) issue(0, sa);
    for (int q = 0; q < jobs; q += 2) {
      if (q + 1 < jobs) issue(q + 1, sb);
      compute(sa);
      if (q + 1 < jobs) {
        if (q + 2 < jobs) issue(q + 2, sa);
        compute(sb);
      }
    }
'''


def _prefetch(text: str) -> str:
    assert text.count(LOOP_START) == 1
    assert text.count(LOOP_END) == 1
    start, end = text.index(LOOP_START) + 1, text.index(LOOP_END) + 1
    return text[:start] + PREFETCH_LOOP + text[end:]


def _tile_mt(mt: int):
    """The tile form on chunks of 16 mt rows (the shipped one takes 32)."""
    def patch(text: str) -> str:
        old = "if (tile) BSR_EXP_LAUNCH(2, 1,"
        assert text.count(old) == 2
        return text.replace(old, f"if (tile) BSR_EXP_LAUNCH({mt}, 1,")
    return patch


# The block-row's table entries loaded beside rows[e], before the count
# says whether the chunk holds a row (an expert with none then reads them
# for nothing).
TABLES_AT = """      sl = blk[(size_t)o * jmax + lane];
    }
  }
"""
EARLY_AT = """  if (m0 >= r) {"""


def _early_tables(text: str) -> str:
    assert text.count(TABLES_AT) == 1
    start = text.index("  // the block-row's count and first 32 table entries")
    end = text.index(TABLES_AT) + len(TABLES_AT)
    block = text[start:end]
    text = text[:start] + text[end:]
    assert text.count(EARLY_AT) == 1
    return text.replace(EARLY_AT, block + EARLY_AT)


SPLIT_NEW = """    float a = v[4 * kk + 2 * p], b = v[4 * kk + 2 * p + 1];
#pragma unroll
    for (int q = 0; q < PARTS; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a in the low half
      out[q] = *reinterpret_cast<const uint32_t*>(&h);
      a -= __low2float(h);
      b -= __high2float(h);
    }"""
SPLIT_OLD = """    tc::split2<H, PARTS>(v[4 * kk + 2 * p], v[4 * kk + 2 * p + 1], out);"""

UPPER_LOAD = """          if (upper) {
            if (rb < r) xb.load(x + (size_t)rb * K + xcol, xend - xcol, x_vec != 0);
            else xb.zero();
          }"""
UPPER_FRAG = """            if (upper) {
              xb.frag(kk, 0, a1);
              xb.frag(kk, 1, a3);
            }"""

VARIANTS = {
    "no_single_row": [("  if (r - m0 == 1) {", "  if (false) {")],
    "upper_skip_bf16": [("const bool upper = XS == 1 || m0 + 16 * m + 8 < r;",
                         "const bool upper = m0 + 16 * m + 8 < r;")],
    "no_upper_skip": [
        (UPPER_LOAD, """          if (rb < r) xb.load(x + (size_t)rb * K + xcol, xend - xcol, x_vec != 0);
          else xb.zero();"""),
        (UPPER_FRAG, """            xb.frag(kk, 0, a1);
            xb.frag(kk, 1, a3);""")],
    "split2": [(SPLIT_NEW, SPLIT_OLD)],
    "f32x_regs168": [(BOUNDS, "__launch_bounds__(kWarps * 32, sizeof(TX) == 4 ? 3 : 4)")],
    "f32x_regs255": [(BOUNDS, "__launch_bounds__(kWarps * 32, sizeof(TX) == 4 ? 2 : 4)")],
    "early_tables": [_early_tables],
    "bounds43": [(BOUNDS, "__launch_bounds__(kWarps * 32, MT == 1 ? 4 : 3)")],
    "regs102": [(BOUNDS, "__launch_bounds__(kWarps * 32, 5)")],
    "regs85": [(BOUNDS, "__launch_bounds__(kWarps * 32, 6)")],
    "tile_mt4": [_tile_mt(4)],
    "tile_mt1": [_tile_mt(1)],
    "prefetch": [_prefetch, (BOUNDS, "__launch_bounds__(kWarps * 32, 3)")],
    "prefetch43": [_prefetch,
                   (BOUNDS, "__launch_bounds__(kWarps * 32, MT == 1 ? 4 : 3)")],
    "regs168": [(BOUNDS, "__launch_bounds__(kWarps * 32, 3)")],
    "regs255": [(BOUNDS, "__launch_bounds__(kWarps * 32, 2)")],
    "warps8": [(WARPS, "constexpr int kWarps = 8;"),
               (BOUNDS, "__launch_bounds__(kWarps * 32, 2)")],
    "xsmem": [("\n// acc (MT m-tiles", XSMEM_LOADS),
              (XSMEM_STAGE_AT, XSMEM_STAGE), (XSMEM_X_OLD, XSMEM_X_NEW),
              (XSMEM_LAUNCH_OLD, XSMEM_LAUNCH_NEW)],
}


def build_variants(names) -> dict:
    """The expert library of each variant in ``names`` and the shipped
    one: name -> (library, ptxas report)."""
    return cuda_variants.build_variants(
        "bsr_spmm_experts", OUT, VARIANTS, names, lambda: ops._lib(True),
        ("bsr_spmm_experts_fwd", "bsr_spmm_palette_experts_fwd"),
        includes=("bsr_spmm",))


def main() -> int:
    if not torch.cuda.is_available():
        print("expert_spmm_design: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names, block = list(VARIANTS), cs.BLOCK
    for arg in sys.argv[1:]:
        if arg.startswith("--variants="):     # only these ("": none)
            names = [n for n in arg.split("=", 1)[1].split(",") if n]
        elif arg.startswith("--block="):
            block = tuple(int(v) for v in arg.split("=", 1)[1].split(","))
    libs = build_variants(names)
    reports = []
    for name, (_, report) in libs.items():
        cs.log = lambda *a, name=name: print(f"[{name}]", *a, flush=True)
        cs._log_ptxas(f"bsr_spmm_experts_{name}", report)
        reports.append(f"== {name}\n{report}")
    (OUT / "ptxas.log").write_text("\n".join(reports))
    gen = torch.Generator(device=dev).manual_seed(0)
    views = torch.randn(E, FF, D, generator=gen, device=dev) / math.sqrt(D)
    w32 = _pad_stack(_prune_to_bcsr(views, block, cs.SPARSITY),
                     CompressionPlan(block=block), (E,), 1 << 40)
    del views
    for fmt, w in (("bcsr", w32), ("pal8", quantize_bcsr(w32, 8))):
        plain = (ref.spmm_experts_fwd_ref if fmt == "bcsr"
                 else ref.spmm_palette_experts_fwd_ref)
        store = w.data if fmt == "bcsr" else w.codes
        for m in (1, 8, 40, 80):
            logits = torch.randn(m, D, generator=gen, device=dev) @ \
                torch.randn(D, E, generator=gen, device=dev)
            idx = torch.topk(logits, TOP_K, dim=-1).indices.reshape(-1)
            counts = torch.bincount(idx, minlength=E).clamp(max=m) \
                .to(torch.int32)
            for x_dtype in ((torch.bfloat16, torch.float32) if m <= 8
                            else (torch.bfloat16,)):
                x = torch.randn(E, m, D, generator=gen, device=dev).to(x_dtype)
                measure(libs, w, plain, store, x, m, counts, fmt)
    return 0


def measure(libs, w, plain, store, x, m, counts, fmt) -> None:
    """One JSON line: each variant on x (E, m, D), routed (bf16 x) and with
    every row."""
    sets = cs.copies(lambda: (x.clone(), w.map(torch.clone)),
                     cs.tensor_bytes(x, store))
    kern = ops.pick_kernel(m)
    bf16 = x.dtype == torch.bfloat16
    row = {"matrix": f"{fmt} ewi", "block": list(w.block), "M": m, "x": str(x.dtype).split(".")[-1],
           "form": kern, "empty_experts": int((counts == 0).sum()),
           "largest": int(counts.max())}
    for name, (lib, _) in libs.items():
        if name == "xsmem" and (kern == "tile" or not bf16):
            continue
        ops._lib = lambda experts=False, lib=lib: lib
        for label, rows in ((("routed", counts),) if bf16 else ()) + \
                (("full", None),):
            fn = lambda xs, ws, rows=rows: ops._fwd(  # noqa: E731
                xs, ws, kern, rows)
            cs._check(f"{name} {fmt} M={m} {label}", fn(x, w),
                      plain(x, w, rows), cs.KERNEL_ATOL, cs.KERNEL_RTOL)
            row[f"ms_{name}_{label}"] = cs.time_ms(fn, sets,
                                                   cs.MOE_TIMED_CALLS)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
