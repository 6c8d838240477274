// The expert axis of the forward spmm kernels: E stacked BlockCSR /
// PaletteBCSR matrices (an MoE layer's experts, (E, out, in)) in one launch
// each. Its backward is bsr_experts_bwd.cu.
//
// Replaces, for a stack of experts, the Pallas TPU kernels
//   repro/kernels/bsr_spmm/bsr_spmm.py::gather_block_matmul          (forward)
//   repro/kernels/bsr_spmm/bsr_spmm.py::gather_block_matmul_palette  (forward)
// that the reference's MoE FFN reaches once per expert under lax.map
// (repro/models/moe.py:249-259).
//
// * bsr_experts_fwd (ops.spmm_experts, ops.spmm_palette_experts): Y[e] (M, N)
//   f32 = X[e] (M, K) @ W_e' on the rows that expert e holds. rows[e] (an
//   (E,) int32 tensor on the card, read by the kernel: no host sync; null:
//   every row) is the count of tokens the MoE dispatch gave expert e. The
//   rows of its (E, cap) buffer past that count are zero in the reference
//   and never read by the combine, so rows past the count are written as
//   exact zeros and never computed: the outputs equal the reference's.
//
// What bounds the forward on an H100 (3.35 TB/s, 989 TFLOP/s bf16 on the
// tensor cores): bytes. At olmoe-1b-7b's ewi (64 experts of (1024, 2048),
// (8, 128) blocks at 0.9) the f32 store is 53.7 MB, 16 us of reads; X and Y
// add 1-5 us; the products are 0.2-1 GFLOP. What a design has to avoid at
// these shapes: thousands of short thread blocks that are each one chain
// of dependent trips to memory (tables, then blocks and X, then a sum,
// then the write), rows of an expert's buffer that no token fills, and
// tiles of a few rows that each read the block again.
//
// The design. A warp takes one block-row o of one expert and every occupied row
// of its m-chunk; thread block (kWarps warps, blockIdx.x) takes kWarps
// block-rows, blockIdx.y the m-chunk of 16 MT rows and blockIdx.z the expert.
// No shared memory is staged and warps never wait for each other (a palette
// call stages its palette behind one barrier): the block-row's table entries
// and its count arrive in one trip (lane j loads entry j; beside the
// palette's), then for each resident block j, in order, every lane loads its
// part of the block and of X straight into registers, and the products run on
// the tensor cores (mma.sync m16n8k16, f32 sums) from those registers. The
// mapping that makes that possible: lane (g = lane / 4, t = lane % 4) holds
// columns 32 q + 8 t + i (q, i < 4, 8) of a 128-column chunk, of X rows g and g
// + 8 of an m-tile and of block row g of an n-tile (16-byte loads of bf16, 2 x
// 16 of f32, 8 bytes of 8-bit codes, 4 of 4-bit), and k-step kk takes its
// values 4 kk .. 4 kk + 3 as the fragment's k = 2 t, 2 t + 1, 2 t + 8, 2 t + 9.
// A and B permute k alike, so the mma sums each column once
// (tests/test_torch_expert_rows.py rehearses the mapping). f32 operands go as
// three bf16 parts with bsr_tile.cuh's product rule; each block's products are
// summed from zero and then added in f32, blocks in the order of the tables,
// and each output is written once by one thread, with no atomics: bit-equal run
// to run.
//
// * The decode form (M <= 16 in the wrappers; MT = 1): a warp takes all of
//   the expert's occupied rows, at most 16, so each resident block is read
//   once a call; an expert with rows[e] == 0 writes its zeros and reads none of
//   its tables or blocks.
// * A chunk with one occupied row (an expert that holds one token; M = 1)
//   takes exact f32 FMAs in place of the 16-row m-tile: the same loads, no
//   three-part split, and the products of 15 empty rows not run.
// * The tile form (M > 16; MT = 2, or 1 at br 32): m-chunks of 16 MT rows;
//   a chunk at or past rows[e] writes zeros and reads nothing, and a chunk
//   issues no m-tile past rows[e] rounded up to 16. The block is held in
//   registers across the chunk's m-tiles; X rows are re-read for each
//   resident block (from L2 or L1, not from device memory), and each chunk
//   of an expert reads its blocks again (chunks of 64 rows, which read them
//   once for more rows, were slower: fewer warps in flight;
//   tools/expert_spmm_design.py).
//
// What still holds it back (PERF.md, rows 1e / 2e;
// tools/expert_spmm_design.py): a warp's chain of dependent trips (rows[e],
// the tables, then the blocks and X) at 16 warps an SM (128 registers).
// At olmoe's ewi on routed counts the decode form takes 2.1x the bound of
// its bytes and the tile form at M = 40 1.8x; the palettes, at 1/4-1/8 of
// the f32 store's bytes, take its time, 8-13x their bounds. Deeper
// pipelines in registers, other register caps, 8-warp blocks, other tile
// chunks and X staged in shared memory were each slower. At 128 registers
// ptxas spills (the build's report, which chip_smoke.py logs; PERF.md):
// with bf16 x, nothing in the decode form at br <= 8 (olmoe's (8, 128)
// blocks), 8-16 bytes in its tile form (the f32 store, palette-4), up to
// 56 in the decode form and 40-196 in the tile form at br 16 (NT 2), and
// 20-324 at br 32 (NT 4); with f32 x, every instantiation (16-728 bytes).
// tools/expert_spmm_design.py --block=BR,BC times the shipped kernel at
// other block shapes (PERF.md: br 16 and 32).
//
// Built with nvcc into a shared library with a plain C interface; each entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#define BSR_SPMM_EXPERTS 1
#include "bsr_spmm.cu"

namespace {

constexpr int kWarps = 4;            // warps a thread block
constexpr unsigned kFull = 0xffffffffu;

using bsr::H;
using F = tc::Half<H>;

// 32 values of a lane: columns 32 q + 8 t + i of a 128-column chunk of one
// row (value 8 q + i), f32 as it is, bf16 as packed pairs; frag(kk, p, out)
// gives the PARTS bf16 parts of values 4 kk + 2 p and 4 kk + 2 p + 1 as one
// packed register each (the lower column in the low half), value(i) value i
// as f32.
template <typename T> struct Row32;

template <> struct Row32<float> {
  static constexpr int PARTS = 3;
  float v[32];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = 0.f;
  }
  // p: the row at the lane's first column; n: the valid columns from p
  __device__ __forceinline__ float value(int i) const { return v[i]; }
  __device__ __forceinline__ void load(const float* p, int n, bool vec) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = n - 32 * q;
      float* d = v + 8 * q;
      if (vec && m >= 8) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p + 32 * q));
        const float4 b = __ldg(reinterpret_cast<const float4*>(p + 32 * q) + 1);
        d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
        d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = e < m ? __ldg(p + 32 * q + e) : 0.f;
      }
    }
  }
  // tc::split2's parts, each pair rounded by one cvt.rn.bf16x2.f32
  __device__ __forceinline__ void frag(int kk, int p, uint32_t (&out)[PARTS]) const {
    float a = v[4 * kk + 2 * p], b = v[4 * kk + 2 * p + 1];
#pragma unroll
    for (int q = 0; q < PARTS; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a in the low half
      out[q] = *reinterpret_cast<const uint32_t*>(&h);
      a -= __low2float(h);
      b -= __high2float(h);
    }
  }
};

template <> struct Row32<__nv_bfloat16> {
  static constexpr int PARTS = 1;
  uint32_t w[16];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ float value(int i) const {
    return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int n, bool vec) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = n - 32 * q;
      uint32_t* d = w + 4 * q;
      if (vec && m >= 8) {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(p + 32 * q));
        d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
      } else {
        const unsigned short* s = reinterpret_cast<const unsigned short*>(p + 32 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t lo = 2 * e < m ? __ldg(s + 2 * e) : 0u;
          const uint32_t hi = 2 * e + 1 < m ? __ldg(s + 2 * e + 1) : 0u;
          d[e] = lo | (hi << 16);
        }
      }
    }
  }
  __device__ __forceinline__ void frag(int kk, int p, uint32_t (&out)[PARTS]) const {
    out[0] = w[2 * kk + p];
  }
};

// The block operands. load(v, s, r, kc, t, pal): row r of slot s's block,
// columns kc + 32 q + 8 t + i (zero past bc, and at r >= br); vec: rows
// aligned for the vector loads.

// fp block store: data (n_slots, br, bc), S = float or __nv_bfloat16
template <typename S>
struct RegFloatBlocks {
  using Row = Row32<S>;
  static constexpr int kPalette = 1;   // no palette (1: a legal array size)
  const S* data;
  int br, bc;
  bool vec;
  __device__ __forceinline__ void stage(float*) const {}
  __device__ __forceinline__ void to_expert(long long e, long long es) { data += e * es; }
  __device__ __forceinline__ void load(Row& v, int s, int r, int kc, int t,
                                       const float*) const {
    if (r >= br) {
      v.zero();
      return;
    }
    const int col = kc + 8 * t;
    v.load(data + ((size_t)s * br + r) * bc + col, bc - col, vec);
  }
};

// palette store: codes (n_slots, br, bc) at 8 bits, (n_slots, br, bc / 2) at
// 4 bits, low nibble first; palette (2**BITS,) f32, code 0 exact zero
template <int BITS>
struct RegPaletteBlocks {
  using Row = Row32<float>;
  static constexpr int kPalette = 1 << BITS;
  const uint8_t* codes;
  const float* palette;
  int br, bc;
  bool vec;
  __device__ __forceinline__ void stage(float* pal) const {
    for (int i = threadIdx.x; i < kPalette; i += blockDim.x) pal[i] = i > 0 ? palette[i] : 0.f;
  }
  __device__ __forceinline__ void to_expert(long long e, long long es) {
    codes += e * es;
    palette += e * kPalette;
  }
  __device__ __forceinline__ void load(Row& v, int s, int r, int kc, int t,
                                       const float* pal) const {
    if (r >= br) {
      v.zero();
      return;
    }
    const int row_bytes = bc * BITS / 8;
    const uint8_t* p = codes + ((size_t)s * br + r) * row_bytes;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = kc + 32 * q + 8 * t;     // a multiple of 8
      int code[8];
      if (BITS == 8) {
        if (vec && col + 8 <= bc) {
          const uint2 b = __ldg(reinterpret_cast<const uint2*>(p + col));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            code[e] = (b.x >> (8 * e)) & 0xFF;
            code[4 + e] = (b.y >> (8 * e)) & 0xFF;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) code[e] = col + e < bc ? __ldg(p + col + e) : 0;
        }
      } else {
        if (vec && col + 8 <= bc) {
          const uint32_t b = __ldg(reinterpret_cast<const unsigned int*>(p + col / 2));
#pragma unroll
          for (int e = 0; e < 8; ++e) code[e] = (b >> (4 * e)) & 0xF;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            code[e] = col + e < bc ? (__ldg(p + (col + e) / 2) >> (4 * (e & 1))) & 0xF : 0;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v.v[8 * q + e] = pal[code[e]];
    }
  }
};

// acc (MT m-tiles x NT n-tiles of 16 x 8) for one task, or zero rows: write
// rows [m0, m_end) of output columns o br .. o br + br - 1 (row >= r: 0).
template <int MT, int NT>
__device__ __forceinline__ void write_task(float* y, const float (&acc)[MT][NT][4], int o, int br,
                                           int N, int m0, int m_end, int r, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * m + g + 8 * h;
      if (row >= m_end) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * t + e, out = o * br + col;
          if (col < br && out < N) y[(size_t)row * N + out] = row < r ? acc[m][n][2 * h + e] : 0.f;
        }
    }
}

template <int MT, int NT, typename TX, typename Blocks>
__global__ void __launch_bounds__(kWarps * 32, 4)
bsr_experts_fwd(const TX* __restrict__ x, Blocks w, const int* __restrict__ idx,
                const int* __restrict__ blk, const int* __restrict__ nnz,
                const int* __restrict__ rows, float* __restrict__ y, int M, int K, int N, int O,
                int jmax, int x_vec, Experts ex) {
  using XRow = Row32<TX>;
  using WRow = typename Blocks::Row;
  constexpr int XS = XRow::PARTS, WS = WRow::PARTS;
  const long long e = blockIdx.z;                  // expert e's problem
  x += e * ex.x;
  y += e * ex.y;
  idx += e * ex.tab;
  blk += e * ex.tab;
  nnz += e * ex.nnz;
  w.to_expert(e, ex.w);
  const int r = rows ? min(max(rows[e], 0), M) : M;  // block-uniform
  const int m0 = blockIdx.y * 16 * MT;
  const int m_end = min(M, m0 + 16 * MT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int o = blockIdx.x * kWarps + warp;        // the warp's block-row
  const int br = w.br, bc = w.bc;
  float acc[MT][NT][4];
  if (m0 >= r) {                      // no occupied row here: zeros, nothing read
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
    if (o < O) write_task<MT, NT>(y, acc, o, br, N, m0, m_end, r, lane);
    return;
  }
  // the block-row's count and first 32 table entries (lane j loads entry
  // j), in one trip, issued before the palette's barrier so that the two
  // trips overlap
  int n_res = 0, cl = 0, sl = 0;
  if (o < O) {
    n_res = nnz[o];
    if (lane < jmax) {
      cl = idx[(size_t)o * jmax + lane];
      sl = blk[(size_t)o * jmax + lane];
    }
  }
  __shared__ float pal[Blocks::kPalette];
  if constexpr (Blocks::kPalette > 1) {
    w.stage(pal);
    __syncthreads();
  }
  // table entry j: its block-column c and slot s (the next 32 entries
  // loaded when j reaches them)
  auto entry = [&](int j, int& c, int& s) {
    if (j > 0 && (j & 31) == 0) {
      cl = sl = 0;
      if (j + lane < jmax) {
        cl = idx[(size_t)o * jmax + j + lane];
        sl = blk[(size_t)o * jmax + j + lane];
      }
    }
    c = __shfl_sync(kFull, cl, j & 31);
    s = __shfl_sync(kFull, sl, j & 31);
  };
  const int mt_run = min(MT, (r - m0 + 15) / 16);  // m-tiles issued
  if (o >= O) return;
  if (r - m0 == 1) {
    // One occupied row, m0 (an expert that holds one token): exact f32
    // FMAs in place of a 16-row m-tile, neither operand split. Lane (g, t)
    // sums the products of its columns of row m0 and of block row 8 n + g;
    // the four lanes of a group are added (xor 1, then 2), and lane (g, t =
    // n) writes output column 8 n + g.
    float p1[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) p1[n] = 0.f;
    for (int j = 0; j < n_res; ++j) {
      int c, s;
      entry(j, c, s);
      for (int kc = 0; kc < bc; kc += bsr::kK) {
        const int xcol = c * bc + kc + 8 * t, xend = min(K, c * bc + bc);
        XRow xr;
        xr.load(x + (size_t)m0 * K + xcol, xend - xcol, x_vec != 0);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          WRow wr;
          w.load(wr, s, 8 * n + g, kc, t, pal);
#pragma unroll
          for (int i = 0; i < 32; ++i) p1[n] = fmaf(xr.value(i), wr.value(i), p1[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      p1[n] += __shfl_xor_sync(kFull, p1[n], 1);
      p1[n] += __shfl_xor_sync(kFull, p1[n], 2);
      const int col = 8 * n + g, out = o * br + col;
      if (t == n && col < br && out < N) y[(size_t)m0 * N + out] = p1[n];
    }
    for (int i = lane; i < (m_end - m0 - 1) * br; i += 32) {   // rows past it
      const int out = o * br + i % br;
      if (out < N) y[(size_t)(m0 + 1 + i / br) * N + out] = 0.f;
    }
    return;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
  for (int j = 0; j < n_res; ++j) {
    int c, s;
    entry(j, c, s);
    float tb[MT][NT][4];               // the block's products, summed from zero
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) tb[m][n][q] = 0.f;
    for (int kc = 0; kc < bc; kc += bsr::kK) {
      const int xcol = c * bc + kc + 8 * t;      // the lane's first column of X
      const int xend = min(K, c * bc + bc);      // X columns past it are zero
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        WRow wr;
        w.load(wr, s, 8 * n + g, kc, t, pal);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m >= mt_run) continue;
          XRow xa, xb;                           // rows g and g + 8 of m-tile m
          const int ra = m0 + 16 * m + g, rb = ra + 8;
          // f32 x: where the tile's rows 8 .. 15 all lie past the count
          // (warp-uniform), their fragments are zero, neither loaded nor
          // split (with bf16 x, which needs no split, the test cost more
          // than it saved)
          const bool upper = XS == 1 || m0 + 16 * m + 8 < r;
          if (ra < r) xa.load(x + (size_t)ra * K + xcol, xend - xcol, x_vec != 0);
          else xa.zero();
          if (upper) {
            if (rb < r) xb.load(x + (size_t)rb * K + xcol, xend - xcol, x_vec != 0);
            else xb.zero();
          }
#pragma unroll
          for (int kk = 0; kk < bsr::kK / 16; ++kk) {
            uint32_t b0[WS], b1[WS], a0[XS], a1[XS] = {}, a2[XS], a3[XS] = {};
            wr.frag(kk, 0, b0);
            wr.frag(kk, 1, b1);
            xa.frag(kk, 0, a0);
            xa.frag(kk, 1, a2);
            if (upper) {
              xb.frag(kk, 0, a1);
              xb.frag(kk, 1, a3);
            }
#pragma unroll
            for (int jw = 0; jw < WS; ++jw)
#pragma unroll
              for (int i = 0; i + jw < bsr::order(XS, WS) && i < XS; ++i) {
                const uint32_t a[4] = {a0[i], a1[i], a2[i], a3[i]};
                F::mma(tb[m][n], a, b0[jw], b1[jw]);
              }
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)       // the block's sum, added in f32
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] += tb[m][n][q];
  }
  write_task<MT, NT>(y, acc, o, br, N, m0, m_end, r, lane);
}

template <int MT, int NT, typename TX, typename Blocks>
int launch_experts_t(const void* x, Blocks w, const int* idx, const int* blk, const int* nnz,
                     const int* rows, float* y, int M, int K, int N, int O, int jmax,
                     int x_vec, int E, const Experts& ex, cudaStream_t st) {
  const dim3 grid((O + kWarps - 1) / kWarps, (M + 16 * MT - 1) / (16 * MT), E);
  if (grid.x == 0 || grid.y == 0) return 0;
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  bsr_experts_fwd<MT, NT, TX, Blocks><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const TX*>(x), w, idx, blk, nnz, rows, y, M, K, N, O, jmax, x_vec,
      ex);
  return static_cast<int>(cudaGetLastError());
}

// The decode form (MT 1) or the tile form (chunks of 32 rows, 16 at br 32,
// where the n-tiles' sums take the registers) over E experts
// of n_slots slots each (store_row: one stored block row in the store's
// units, elements of an fp store or bytes of codes).
template <typename Blocks>
int launch_experts(const void* x, int x_is_bf16, Blocks w, const int* idx, const int* blk,
                   const int* nnz, const int* rows, float* y, int M, int K, int N, int O,
                   int jmax, int tile, int x_vec, int E, int n_slots,
                   long long store_row, void* stream) {
  if (w.br != 1 && w.br != 2 && w.br != 4 && w.br != 8 && w.br != 16 && w.br != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E < 1 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Experts ex{(long long)M * K, (long long)M * N, (long long)O * jmax, (long long)O,
                   (long long)n_slots * w.br * store_row};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BSR_EXP_ARGS x, w, idx, blk, nnz, rows, y, M, K, N, O, jmax, x_vec, E, ex, st
#define BSR_EXP_LAUNCH(MT, NT, TX) return launch_experts_t<MT, NT, TX>(BSR_EXP_ARGS)
  const int nt = bsr::n_tiles(w.br);
  if (x_is_bf16) {
    if (nt == 1) {
      if (tile) BSR_EXP_LAUNCH(2, 1, __nv_bfloat16);
      BSR_EXP_LAUNCH(1, 1, __nv_bfloat16);
    }
    if (nt == 2) {
      if (tile) BSR_EXP_LAUNCH(2, 2, __nv_bfloat16);
      BSR_EXP_LAUNCH(1, 2, __nv_bfloat16);
    }
    BSR_EXP_LAUNCH(1, 4, __nv_bfloat16);
  }
  if (nt == 1) {
    if (tile) BSR_EXP_LAUNCH(2, 1, float);
    BSR_EXP_LAUNCH(1, 1, float);
  }
  if (nt == 2) {
    if (tile) BSR_EXP_LAUNCH(2, 2, float);
    BSR_EXP_LAUNCH(1, 2, float);
  }
  BSR_EXP_LAUNCH(1, 4, float);
#undef BSR_EXP_LAUNCH
#undef BSR_EXP_ARGS
}

}  // namespace

extern "C" {

// Y (E, M, N) f32, Y[e] = X[e] (M, K) @ W_e' on rows [0, rows[e]) and zero
// below, for E stacked BlockCSR W_e (N, K): data (E, n_slots, br, bc) f32,
// or bf16 when data_is_bf16, idx/blk (E, O, jmax) int32, nnz (E, O) int32,
// rows (E,) int32 on the card or null (every row); br one of 1, 2, 4, 8,
// 16, 32. tile: the tile form, else the decode form; x_vec / w_vec: the rows of X / of the store are 16-byte
// aligned and bc a multiple of 16 bytes' worth.
int bsr_spmm_experts_fwd(const void* x, int x_is_bf16, const void* data, int data_is_bf16,
                         const int* idx, const int* blk, const int* nnz, const int* rows,
                         float* y, int M, int K, int N, int O, int jmax, int br, int bc,
                         int tile, int x_vec, int w_vec, int E, int n_slots,
                         void* stream) {
  if (data_is_bf16)
    return launch_experts(x, x_is_bf16,
                          RegFloatBlocks<__nv_bfloat16>{
                              static_cast<const __nv_bfloat16*>(data), br, bc, w_vec != 0},
                          idx, blk, nnz, rows, y, M, K, N, O, jmax, tile, x_vec, E,
                          n_slots, bc, stream);
  return launch_experts(x, x_is_bf16,
                        RegFloatBlocks<float>{static_cast<const float*>(data), br, bc,
                                              w_vec != 0},
                        idx, blk, nnz, rows, y, M, K, N, O, jmax, tile, x_vec, E,
                        n_slots, bc, stream);
}

// As bsr_spmm_experts_fwd for E stacked PaletteBCSR W_e: codes uint8 (E,
// n_slots, br, bc) at 8 bits or (E, n_slots, br, bc/2) at 4 bits, palette
// (E, 2**bits) f32, one per expert; w_vec: the codes start on a 16-byte
// boundary and a row of codes is a multiple of 16 bytes.
int bsr_spmm_palette_experts_fwd(const void* x, int x_is_bf16, const uint8_t* codes,
                                 const float* palette, int bits, const int* idx, const int* blk,
                                 const int* nnz, const int* rows, float* y, int M, int K, int N,
                                 int O, int jmax, int br, int bc, int tile,
                                 int x_vec, int w_vec, int E, int n_slots, void* stream) {
  if (bits == 8)
    return launch_experts(x, x_is_bf16, RegPaletteBlocks<8>{codes, palette, br, bc, w_vec != 0},
                          idx, blk, nnz, rows, y, M, K, N, O, jmax, tile, x_vec, E,
                          n_slots, bc, stream);
  if (bits == 4)
    return launch_experts(x, x_is_bf16, RegPaletteBlocks<4>{codes, palette, br, bc, w_vec != 0},
                          idx, blk, nnz, rows, y, M, K, N, O, jmax, tile, x_vec, E,
                          n_slots, bc / 2, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
