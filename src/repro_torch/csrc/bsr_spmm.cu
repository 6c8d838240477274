// Gather-block-matmul for BlockCSR and PaletteBCSR weights on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   repro/kernels/bsr_spmm/bsr_spmm.py::gather_block_matmul          (forward,
//       transpose_block=True, as called by ops.spmm; and the backward,
//       transpose_block=False over the transposed tables, as called by
//       ops.spmm_t)
//   repro/kernels/bsr_spmm/bsr_spmm.py::gather_block_matmul_palette  (forward,
//       as called by ops.spmm_palette)
//
// The forward computes Y (M, N) = X (M, K) @ W' for a block-sparse W (N, K)
// with (br, bc) blocks: output block-row o accumulates
//   X[:, idx[o,j]*bc : +bc] @ B(blk[o,j])'   for j < nnz[o],
// in f32, where B(s) is the block of slot s (BlockCSR, an f32 or bf16 store)
// or palette[code] over the uint8 codes of slot s (PaletteBCSR; at 4 bits
// two codes share a byte, low nibble first, and code 0 is exact zero).
// The backward (bsr_spmm_t) computes dX (M, K) = dY (M, N) @ W over the
// block-CSC tables: output block-column c accumulates
//   dY[:, t_idx[c,j]*br : +br] @ B(t_blk[c,j])   for j < t_nnz[c].
//
// Bound on an H100 SXM (3.35 TB/s HBM; 989 TFLOP/s for bf16 x bf16 on the
// tensor cores, 67 TFLOP/s f32): at decode (M <= 16) each stored block is
// used for a few rows only, so the forward is bound by bytes: the resident
// blocks (4 B an entry f32, 2 B bf16, 1 or 0.5 B palette codes) plus X plus
// Y, 0.06-0.33 us at smollm-360m's widths, far below the cost of one launch.
// At prefill (M = 256) and in training (M = 512) the products are priced at
// the f32 rate when an operand is f32 and at the bf16 rate when both are
// bf16; at these sparse widths the bytes stay the larger term at the bf16
// rate (spmm_t at smollm-360m's mlp.wi, M = 512, bf16: 1.2 us of bytes).
//
// Three kernels; the forward's two are chosen by M in the wrapper (ops.spmm,
// ops.spmm_palette; a stated threshold, never a fallback):
//
// * M <= 16, decode_fwd: an f32 FMA kernel (a 16-row mma tile would be
//   mostly padding). What bounds it is latency, not bytes: a block-row holds
//   1-3 resident blocks at smollm-360m's widths, and each call is a chain of
//   dependent loads. So every warp takes one resident block of its own: a
//   thread block of 8 warps takes 8 / J block-rows (a task: a block-row and
//   a tile of 32 / br rows of X), J warps each, J the power of two at or
//   above the tables' width jmax (at most 8; a warp takes j, j + J, ...), so
//   short rows are packed and no warp waits for another's block. A warp
//   loads nnz[o] and its idx / blk entries together, then its X slab and
//   every row of its block at once: each lane takes 4 adjacent columns of
//   every block row (16 bytes of an f32 store row, 8 of bf16, 4 or 2 of
//   codes) and keeps its task's 32 partial sums (32 / br rows x br columns)
//   in registers. A transposing butterfly (31 shuffles) leaves lane l with
//   output l's sum over the warp, and the J warps of a task are added
//   through shared memory in the order j = 0, 1, ..., so every output is
//   written once by one thread. The palette (at most 256 floats) is staged
//   in shared memory behind the one barrier of a palette call; a BlockCSR
//   call with J = 1 has none. What still holds it back (PERF.md; chip_smoke.py):
//   a call takes 0.0042-0.0060 ms at M <= 8 against 0.0017 ms for an empty
//   kernel timed the same way: the launch, two dependent trips to memory
//   (the tables, then the block rows and X) and the butterfly. At M = 16
//   each 4-row tile re-reads its blocks (0.0085-0.0099 ms at the MLP
//   projections).
// * M > 16, bsr_tile_fwd: the block-tile core (bsr_tile.cuh) on the tensor
//   cores. One thread block per output block-row o and 32 * n_warps rows
//   of X (n_warps 4, or 2 for f32 x, whose three parts would not fit two
//   stages of 128 rows). Each resident block j, 128 columns at a
//   time, is one job: the X slab (rows x 128, gathered at column
//   idx[o,j]*bc; X stays in L2) and the block (br x 128, as stored) are
//   copied by cp.async into a ring of two stages, the next job's copies in
//   flight while this job's block is converted into bf16 parts and its
//   products run (mma.sync m16n8k16: n = br, one n-tile at br 8, 2 or 4 at
//   br 16 / 32, zero-filled n at br < 8). What holds it back: every
//   resident block re-reads its X slab from L2, so its time grows with M
//   well above the bound (PERF.md).
// * bsr_tile_bwd (spmm_t): the block-tile core with the block as stored:
//   dX[:, c bc : +bc] is a sum of gathered dY slabs (rows x br) times blocks
//   (br x bc), m = rows of dX, n = its columns, k = br. A job is the next
//   128 / br resident blocks of the column (128 summed entries): their dY
//   slabs side by side (rows x 128, column b br + e of the slab is column e
//   of block-row t_idx[c, j0 + b]) and their blocks stacked (128 x 64
//   columns, row b br + e is row e of block t_blk[c, j0 + b]). So at br 8
//   two blocks make one k-step of m16n8k16 (m16n8k8 would halve the work
//   of each mma and double their count), below br 8 16 / br blocks do
//   (never a zero-filled k), and br 32 takes two k-steps a block. A
//   fragments come from the dY slab by ldmatrix, B fragments from the
//   row-major block by the transposing ldmatrix. A job's table entries are
//   staged in shared memory first (read per copy, they cost one trip to
//   memory each), then both slabs arrive by cp.async (bf16 dY at br >= 8,
//   the bf16 store) or by plain loads split into three bf16 parts (f32) in
//   the ring of two stages, the next job's copies in flight behind this
//   job's products; each job's products are summed from zero and added in
//   f32. A thread block (4 warps, 2 x 2) takes 64 columns of one
//   block-column and 64 rows of dX, or 32 rows for f32 dY and where 64
//   would leave SMs idle (smollm-360m's K = 960 has only 8 block-columns;
//   the wrapper decides from shapes alone). Every output is written once
//   by one thread, in a fixed order: no atomics, bit-equal run to run. What
//   still holds it back (PERF.md; tools/spmm_t_design.py): 0.0128 ms at
//   mlp.wi (M = 512, bf16), 1.5x the dense bf16 matmul. The time is flat in
//   M up to 256 rows and grows about 3 us per job of the fullest column,
//   and tiles of 128 columns (half the dY gathers) are slower while tiles
//   of 32 are no faster there: the serial chain of a thread block's jobs
//   (its tables, then its copies, then its products), not the bytes, sets
//   the time.
//
// The expert axis (an MoE layer's E stacked matrices in one launch) is
// built apart, by bsr_spmm_experts.cu, which includes this file with
// BSR_SPMM_EXPERTS set: nvcc builds the two at once. Its forward has kernels
// of its own there (bsr_experts_fwd, driven by each expert's occupied
// rows); its backward (ops.spmm_t_experts) is bsr_tile_bwd below with EXP
// true, blockIdx.z the expert: expert e's dY, dX, transposed tables and
// block store lie at e times a per-expert stride (Experts below) from the
// first's; the stacked stores share one slot count and table width (the
// compression pads them), so every expert runs the grid of the widest. A
// single matrix runs the instantiation without the offsets (EXP false):
// with them, 64-bit products in every thread block cost the single-matrix
// calls about 2% (PERF.md).
//
// f32 operands on the tensor cores go as three bf16 parts that hold them
// exactly; of two split operands only the products whose part orders sum to
// at most 2 are kept (bsr_tile.cuh). Every output element of every kernel is
// written exactly once, so an empty matrix (all nnz = 0) writes zeros. br
// must be a power of two up to 32.
//
// Built with nvcc into a shared library with a plain C interface; each entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bsr_tile.cuh"

#ifndef BSR_SPMM_EXPERTS
#define BSR_SPMM_EXPERTS 0
#endif

namespace {

constexpr bool kExperts = BSR_SPMM_EXPERTS;   // this build's backward: the expert axis

constexpr int kDecWarps = 8;         // decode: warps per thread block
constexpr int kDecOut = 32;          // decode: outputs of a task, 32 / br rows x br

using bsr::to_f32;

// Per-expert strides of the operands, in elements of each (x, y, the
// gather tables idx / blk, nnz, the block store; for a palette store w is
// in bytes of codes, and the palette's stride is its 2**BITS entries). The
// backward reads x as dY's, y as dX's, tab and nnz as the transposed
// tables'. Unused for a single matrix; the expert forward
// (bsr_spmm_experts.cu) takes the same.
struct Experts {
  long long x, y, tab, nnz, w;
};

// v = p[0 .. 3] as f32, the ones at e >= n zero; vec: p is aligned for one
// 16-byte (f32) or 8-byte (bf16) load.
template <typename T>
__device__ __forceinline__ void load_quad(float (&v)[4], const T* p, int n, bool vec) {
  if (vec && n >= 4) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = __uint_as_float(q.x << 16); v[1] = __uint_as_float(q.x & 0xffff0000u);
      v[2] = __uint_as_float(q.y << 16); v[3] = __uint_as_float(q.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? to_f32(p[e]) : 0.f;
  }
}

// Decode block operands: load4 gives columns col .. col + 3 of row r of
// slot s as f32, zero past bc; vec: rows aligned for the vector load.

// fp block store: data (n_slots, br, bc), S = float or __nv_bfloat16
template <typename S>
struct FloatBlocks {
  const S* data;
  int br, bc;
  bool vec;
  static constexpr int kPalette = 1;   // no palette (1: a legal array size)
  __device__ __forceinline__ void stage(float*) const {}
  __device__ __forceinline__ void load4(float (&v)[4], int s, int r, int col,
                                        const float*) const {
    load_quad(v, data + ((size_t)s * br + r) * bc + col, bc - col, vec);
  }
};

// palette store: codes (n_slots, br, bc) at 8 bits, (n_slots, br, bc/2) at 4
template <int BITS>
struct PaletteBlocks {
  const uint8_t* codes;
  const float* palette;
  int br, bc;
  bool vec;
  static constexpr int kPalette = 1 << BITS;
  __device__ __forceinline__ void stage(float* pal) const {
    for (int i = threadIdx.x; i < kPalette; i += blockDim.x) pal[i] = palette[i];
  }
  __device__ __forceinline__ void load4(float (&v)[4], int s, int r, int col,
                                        const float* pal) const {
    int code[4];
    if (BITS == 8) {
      const uint8_t* p = codes + ((size_t)s * br + r) * bc + col;
      if (vec && col + 4 <= bc) {
        const uint32_t b = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
        for (int e = 0; e < 4; ++e) code[e] = (b >> (8 * e)) & 0xFF;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) code[e] = col + e < bc ? p[e] : 0;
      }
    } else {                         // col is even: a byte holds columns col, col + 1
      const uint8_t* p = codes + ((size_t)s * br + r) * (bc / 2) + col / 2;
      if (vec && col + 4 <= bc) {
        const uint32_t b = __ldg(reinterpret_cast<const unsigned short*>(p));
#pragma unroll
        for (int e = 0; e < 4; ++e) code[e] = (b >> (4 * e)) & 0xF;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          code[e] = col + e < bc ? (p[e / 2] >> (4 * (e & 1))) & 0xF : 0;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = code[e] ? pal[code[e]] : 0.f;
  }
};

// One step of the transposing butterfly: lanes h apart exchange halves of
// the 2 h values each still holds; a lane keeps the half whose outputs
// share its bit h and adds the other lane's values of the same outputs.
template <int H>
__device__ __forceinline__ void butterfly_step(float (&v)[kDecOut], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Lane l ends with the sum over the warp's lanes of v[l]: five steps, 31
// shuffles in all.
__device__ __forceinline__ float butterfly32(float (&v)[kDecOut], int lane) {
  butterfly_step<16>(v, lane);
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
  return v[0];
}

// The decode forward (M <= 16 in the wrappers). A task is a block-row o and
// a tile of BM = 32 / BR rows of X (tasks o-major); thread block b takes
// tasks b * (8 / J) .., J warps each. Warp w takes resident blocks j = w %
// J, w % J + J, ... < nnz[o] of its task; lane l takes the block's columns
// 4 l .. 4 l + 3 (then + 128, ...), and keeps acc[m * BR + r] for row m of
// the tile and block row r.
template <int BR, typename TX, typename Blocks>
__global__ void __launch_bounds__(kDecWarps * 32, 1)
decode_fwd(const TX* __restrict__ x, Blocks w, const int* __restrict__ idx,
           const int* __restrict__ blk, const int* __restrict__ nnz,
           float* __restrict__ y, int M, int K, int N, int O, int jmax, int J, int x_vec) {
  constexpr int BM = kDecOut / BR;
  __shared__ float pal[Blocks::kPalette];
  __shared__ float part[kDecWarps][kDecOut];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (M + BM - 1) / BM;
  const long long task = (long long)blockIdx.x * (kDecWarps / J) + warp / J;
  const int jw = warp & (J - 1);
  const bool live = task < (long long)O * tiles;
  const int o = live ? (int)(task / tiles) : 0;
  const int m0 = live ? (int)(task - (long long)o * tiles) * BM : 0;
  int n_res = 0, c = 0, s = 0;                 // the task's table entries, together
  if (live) {
    n_res = nnz[o];
    if (jw < jmax) {
      c = idx[(size_t)o * jmax + jw];
      s = blk[(size_t)o * jmax + jw];
    }
  }
  if constexpr (Blocks::kPalette > 1) {
    w.stage(pal);
    __syncthreads();
  }
  float acc[kDecOut];
#pragma unroll
  for (int i = 0; i < kDecOut; ++i) acc[i] = 0.f;
  const int bc = w.bc;
  for (int j = jw; j < n_res; j += J) {
    if (j != jw) {
      c = idx[(size_t)o * jmax + j];
      s = blk[(size_t)o * jmax + j];
    }
    for (int col = lane * 4; col < bc; col += 128) {
      const int kx = c * bc + col;             // reads past K or M give 0
      float xv[BM][4];
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        if (m0 + m < M)
          load_quad(xv[m], x + (size_t)(m0 + m) * K + kx, min(bc - col, K - kx),
                    x_vec != 0);
        else
          xv[m][0] = xv[m][1] = xv[m][2] = xv[m][3] = 0.f;
      }
      float wv[BR][4];                         // every row in flight at once
#pragma unroll
      for (int r = 0; r < BR; ++r) w.load4(wv[r], s, r, col, pal);
#pragma unroll
      for (int r = 0; r < BR; ++r)
#pragma unroll
        for (int m = 0; m < BM; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m * BR + r] = fmaf(xv[m][e], wv[r][e], acc[m * BR + r]);
    }
  }
  float v = butterfly32(acc, lane);
  if (J > 1) {                        // the task's warps, added in the order of j
    part[warp][lane] = v;
    __syncthreads();
    if (jw == 0)
      for (int q = 1; q < J; ++q) v += part[warp + q][lane];
  }
  if (live && jw == 0) {
    const int row = m0 + lane / BR, col = o * BR + lane % BR;
    if (row < M && col < N) y[(size_t)row * N + col] = v;
  }
}

// The tile forward (M > 16). One thread block per output block-row o
// (blockIdx.x) and 32 * n_warps rows of X (blockIdx.y, then + gridDim.y;
// n_warps = blockDim.x / 32); warp w owns rows 32w .. 32w + 31 of them (two
// m-tiles, so each B fragment serves two mma) and all br output columns.
// Jobs q = (resident block j, 128-column chunk kc) run in order. Job q's X
// slab and raw block arrive by cp.async into stage q & 1 of the ring; at
// job q, once every warp is past job q - 1, job q + 1's copies are issued
// into the other stage, then job q's raw block is converted into its bf16
// parts, and its products run while job q + 1's copies are in flight.
constexpr int kTileWarpRows = 32;          // rows of X per warp (2 m-tiles)

template <int XS, typename TX, typename Blocks>
__device__ __forceinline__ void issue_job(int q, const TX* x, const Blocks& w,
                                          const int* idx, const int* blk, int o,
                                          int jmax, int n_kc, int m0, int rows, int M,
                                          int K, bool x_vec, bsr::H* xs, int xpart,
                                          uint8_t* wraw, int wraw_stage) {
  const int j = q / n_kc, kc = (q - j * n_kc) * bsr::kK;
  const int c = idx[(size_t)o * jmax + j], s = blk[(size_t)o * jmax + j];
  const int bc = w.bc;
  bsr::stage<XS>(xs + (q & 1) * XS * xpart, bsr::kStr, xpart, x, K, m0, rows, M,
                 c * bc + kc, min(K, c * bc + bc), bsr::kK / 8, x_vec);
  w.raw(wraw + (q & 1) * wraw_stage, s, kc);
}

template <int NT, typename TX, typename Blocks>
__global__ void __launch_bounds__(128, 1)
bsr_tile_fwd(const TX* __restrict__ x, Blocks w, const int* __restrict__ idx,
             const int* __restrict__ blk, const int* __restrict__ nnz,
             float* __restrict__ y, int M, int K, int N, int jmax, int x_vec) {
  using bsr::H;
  using bsr::kStr;
  constexpr int MT = kTileWarpRows / 16;           // m-tiles per warp
  constexpr int XS = bsr::parts<TX>();             // parts of X
  constexpr int WS = Blocks::PARTS;                // parts of the block
  constexpr int NR = bsr::n_rows(NT);              // staged block rows
  constexpr int wpart = NR * kStr;
  constexpr int wraw_stage = NR * Blocks::kRawRow;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = (blockDim.x >> 5) * kTileWarpRows;
  const int xpart = rows * kStr;
  H* const xs = reinterpret_cast<H*>(smem_raw);    // [2][XS][rows][kStr]
  H* const ws = xs + 2 * XS * xpart;               // [WS][NR][kStr]
  H* const pal = ws + WS * wpart;                  // palette parts
  uint8_t* const wraw = reinterpret_cast<uint8_t*>(pal + (Blocks::kHasPalette ? WS * bsr::kPalette : 0));

  const int o = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bc = w.bc, br = w.br;
  const int n_kc = (bc + bsr::kK - 1) / bsr::kK;
  const int jobs = nnz[o] * n_kc;
  w.stage_palette(pal);
  for (int m0 = blockIdx.y * rows; m0 < M; m0 += gridDim.y * rows) {
    float acc[MT][NT][4], t[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = t[m][n][e] = 0.f;
    if (jobs > 0)
      issue_job<XS>(0, x, w, idx, blk, o, jmax, n_kc, m0, rows, M, K, x_vec != 0, xs, xpart,
                    wraw, wraw_stage);
    tc::cp_async_commit();
    for (int q = 0; q < jobs; ++q) {
      tc::cp_async_wait<0>();
      __syncthreads();                // job q landed; every warp is past job q - 1
      if (q + 1 < jobs)
        issue_job<XS>(q + 1, x, w, idx, blk, o, jmax, n_kc, m0, rows, M, K, x_vec != 0, xs,
                      xpart, wraw, wraw_stage);
      tc::cp_async_commit();
      w.convert(ws, wpart, wraw + (q & 1) * wraw_stage, pal);
      __syncthreads();                // the block's parts are ready
      const int kcq = q % n_kc;
      if (kcq == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) t[m][n][e] = 0.f;
      }
      bsr::fwd_slab<MT, NT, XS, WS>(t, xs + (q & 1) * XS * xpart + warp * kTileWarpRows * kStr,
                                    xpart, ws, wpart);
      if (kcq == n_kc - 1) {          // the block's sum, added in f32
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] += t[m][n][e];
      }
    }
    __syncthreads();                  // the ring is free for the next rows

    // thread: rows lane / 4 and lane / 4 + 8 of each m-tile, columns
    // 8n + 2 (lane % 4) + {0, 1}
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + warp * kTileWarpRows + m * 16 + (lane >> 2) + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n * 8 + (lane & 3) * 2 + e, out = o * br + col;
            if (col < br && out < N) y[(size_t)row * N + out] = acc[m][n][2 * h + e];
          }
      }
  }
}

// spmm_t on the block-tile core. A thread block (4 warps, 2 x 2) takes
// columns cc .. cc + 63 of block-column c (blockIdx.x runs over c, then
// the 64-column chunks of bc) and R = 32 MT rows of dX at a time
// (blockIdx.y, then + gridDim.y); warp (wm, wn) owns rows 16 MT wm .. and
// columns 32 wn .. of them (MT m-tiles x 4 n-tiles). Job q is resident
// blocks j0 = q * 128 / br .. of the column: its dY slab (R x 128) and its
// block slab (128 x 64) arrive in stage q & 1 of the ring; at job q, once
// every warp is past job q - 1, job q + 1's copies are issued into the
// other stage, then job q's products run, summed from zero, and are added
// to the accumulator in f32.
constexpr int kTCols = 64;                 // dX columns of a thread block
constexpr int kTStr = kTCols + 8;          // row stride of the staged block slab

template <int MT, typename TY, typename S, bool EXP>
__global__ void __launch_bounds__(128, 1)
bsr_tile_bwd(const TY* __restrict__ dy, const S* __restrict__ data,
             const int* __restrict__ t_idx, const int* __restrict__ t_blk,
             const int* __restrict__ t_nnz, float* __restrict__ dx, int M, int N, int K,
             int jmax_t, int br, int bc, int dy_vec, int w_vec, Experts ex) {
  if constexpr (EXP) {                // expert blockIdx.z's problem
    const long long e = blockIdx.z;
    dy += e * ex.x;
    dx += e * ex.y;
    t_idx += e * ex.tab;
    t_blk += e * ex.tab;
    t_nnz += e * ex.nnz;
    data += e * ex.w;
  }
  using bsr::H;
  using bsr::kK;
  using bsr::kStr;
  constexpr int XS = bsr::parts<TY>(), WS = bsr::parts<S>();
  constexpr int NT = kTCols / 2 / 8;               // n-tiles of a warp
  constexpr int R = 2 * 16 * MT;                   // rows of dX a pass
  constexpr int apart = R * kStr, bpart = kK * kTStr;
  constexpr int stage = XS * apart + WS * bpart;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  H* const ring = reinterpret_cast<H*>(smem_raw);  // [2][XS][R][kStr], [WS][kK][kTStr]

  const int n_cc = (bc + kTCols - 1) / kTCols;
  const int c = blockIdx.x / n_cc, cc = (blockIdx.x - c * n_cc) * kTCols;
  if (c * bc + cc >= K) return;                    // block-uniform
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int lg = 31 - __clz(br);
  const int per_job = kK >> lg;                    // resident blocks a job
  const int n_j = t_nnz[c];
  const int jobs = (n_j + per_job - 1) / per_job;
  const int* const ti = t_idx + (size_t)c * jmax_t;
  const int* const tb = t_blk + (size_t)c * jmax_t;

  __shared__ int tab[2][2][kK];                    // a job's block-rows and slots
  for (int m0 = blockIdx.y * R; m0 < M; m0 += gridDim.y * R) {
    // job q into stage q & 1. Its table entries first, into tab[q & 1]
    // (up to the tables' width, whatever t_nnz says, so that the first
    // job's reads need not wait for it); then column b br + e of the dY
    // slab is column e of block-row tab[.][0][b], row b br + e of the block
    // slab row e of block tab[.][1][b], both zero past the column's count,
    // M, N and bc, all copies issued back to back
    auto issue = [&](int q) {
      H* const st = ring + (q & 1) * stage;
      int* const rows = tab[q & 1][0];
      int* const slots = tab[q & 1][1];
      const int j0 = q * per_job;
      for (int b = threadIdx.x; b < min(per_job, jmax_t - j0); b += blockDim.x) {
        rows[b] = ti[j0 + b];
        slots[b] = tb[j0 + b];
      }
      __syncthreads();
      const int nb = min(per_job, n_j - j0);
      bsr::stage_at<XS>(st, kStr, apart, R, kK / 8, dy_vec != 0, dy,
                        [=](int r, int k) -> const TY* {
                          const int b = k >> lg;
                          if (b >= nb || m0 + r >= M) return nullptr;
                          const int col = rows[b] * br + (k & (br - 1));
                          return col < N ? dy + (size_t)(m0 + r) * N + col : nullptr;
                        });
      bsr::stage_at<WS>(st + XS * apart, kTStr, bpart, kK, kTCols / 8, w_vec != 0, data,
                        [=](int k, int col) -> const S* {
                          const int b = k >> lg;
                          if (b >= nb || cc + col >= bc) return nullptr;
                          return data + ((size_t)slots[b] * br + (k & (br - 1))) * bc + cc + col;
                        });
    };
    float acc[MT][NT][4], t[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    if (jmax_t > 0) issue(0);         // at t_nnz 0 it stages zeros, never used
    tc::cp_async_commit();
    for (int q = 0; q < jobs; ++q) {
      tc::cp_async_wait<0>();
      __syncthreads();                // job q landed; every warp is past job q - 1
      if (q + 1 < jobs) issue(q + 1);
      tc::cp_async_commit();
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[m][n][e] = 0.f;
      const H* const st = ring + (q & 1) * stage;
      const int ksteps = (min(per_job, n_j - q * per_job) * br + 15) / 16;
      bsr::bwd_slab<MT, NT, XS, WS>(t, st + wm * 16 * MT * kStr, apart,
                                    st + XS * apart + wn * NT * 8, bpart, kTStr, ksteps);
#pragma unroll
      for (int m = 0; m < MT; ++m)    // the job's sum, added in f32
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] += t[m][n][e];
    }
    __syncthreads();                  // the ring is free for the next rows

    // thread: rows lane / 4 and lane / 4 + 8 of each m-tile, columns
    // 8n + 2 (lane % 4) + {0, 1}
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 16 * MT + m * 16 + (lane >> 2) + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cb = cc + wn * NT * 8 + n * 8 + (lane & 3) * 2 + e, col = c * bc + cb;
            if (cb < bc && col < K) dx[(size_t)row * K + col] = acc[m][n][2 * h + e];
          }
      }
  }
}

template <int BR, typename Blocks>
void launch_br(const void* x, int x_is_bf16, Blocks w, const int* idx, const int* blk,
               const int* nnz, float* y, int M, int K, int N, int O, int jmax, int J,
               int x_vec, cudaStream_t st) {
  constexpr int BM = kDecOut / BR;
  const long long tasks = (long long)O * ((M + BM - 1) / BM);
  const int per_block = kDecWarps / J;
  const dim3 grid((unsigned)((tasks + per_block - 1) / per_block));
  if (grid.x == 0) return;
#define BSR_DECODE_LAUNCH(TX)                                                               \
  decode_fwd<BR, TX, Blocks><<<grid, kDecWarps * 32, 0, st>>>(                             \
      static_cast<const TX*>(x), w, idx, blk, nnz, y, M, K, N, O, jmax, J, x_vec)
  if (x_is_bf16)
    BSR_DECODE_LAUNCH(__nv_bfloat16);
  else
    BSR_DECODE_LAUNCH(float);
#undef BSR_DECODE_LAUNCH
}

template <typename Blocks>
int launch_decode(const void* x, int x_is_bf16, Blocks w, const int* idx, const int* blk,
                  const int* nnz, float* y, int M, int K, int N, int O, int jmax, int J,
                  int x_vec, cudaStream_t st) {
  if (J != 1 && J != 2 && J != 4 && J != 8) return static_cast<int>(cudaErrorInvalidValue);
#define BSR_DECODE_ARGS x, x_is_bf16, w, idx, blk, nnz, y, M, K, N, O, jmax, J, x_vec, st
  switch (w.br) {
    case 1: launch_br<1>(BSR_DECODE_ARGS); break;
    case 2: launch_br<2>(BSR_DECODE_ARGS); break;
    case 4: launch_br<4>(BSR_DECODE_ARGS); break;
    case 8: launch_br<8>(BSR_DECODE_ARGS); break;
    case 16: launch_br<16>(BSR_DECODE_ARGS); break;
    case 32: launch_br<32>(BSR_DECODE_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BSR_DECODE_ARGS
  return static_cast<int>(cudaGetLastError());
}

template <int NT, typename TX, typename Blocks>
int launch_tile_t(const void* x, Blocks w, const int* idx, const int* blk, const int* nnz,
                  float* y, int M, int K, int N, int O, int jmax, int x_vec, cudaStream_t st) {
  constexpr int XS = bsr::parts<TX>(), NR = bsr::n_rows(NT);
  // f32 x takes three parts: two stages of 128 rows would not fit
  constexpr int n_warps = XS > 1 ? 2 : 4;
  constexpr int rows = kTileWarpRows * n_warps;
  const size_t smem =
      sizeof(bsr::H) * ((size_t)2 * XS * rows * bsr::kStr + (size_t)Blocks::PARTS * NR * bsr::kStr +
                        (Blocks::kHasPalette ? Blocks::PARTS * bsr::kPalette : 0)) +
      (size_t)2 * NR * Blocks::kRawRow;
  auto kern = bsr_tile_fwd<NT, TX, Blocks>;
  static size_t opted = 48 * 1024;             // the limit raised so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const dim3 grid(O, std::min((M + rows - 1) / rows, 65535));
  if (grid.x == 0 || grid.y == 0) return 0;
  kern<<<grid, 32 * n_warps, smem, st>>>(static_cast<const TX*>(x), w, idx, blk, nnz, y, M,
                                         K, N, jmax, x_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename Blocks>
int launch_tile(const void* x, int x_is_bf16, Blocks w, const int* idx, const int* blk,
                const int* nnz, float* y, int M, int K, int N, int O, int jmax, int x_vec,
                cudaStream_t st) {
#define BSR_TILE_ARGS x, w, idx, blk, nnz, y, M, K, N, O, jmax, x_vec, st
#define BSR_TILE_LAUNCH(NT, TX) return launch_tile_t<NT, TX>(BSR_TILE_ARGS)
  const int nt = bsr::n_tiles(w.br);
  if (x_is_bf16) {
    if (nt == 1) BSR_TILE_LAUNCH(1, __nv_bfloat16);
    if (nt == 2) BSR_TILE_LAUNCH(2, __nv_bfloat16);
    if (nt == 4) BSR_TILE_LAUNCH(4, __nv_bfloat16);
  } else {
    if (nt == 1) BSR_TILE_LAUNCH(1, float);
    if (nt == 2) BSR_TILE_LAUNCH(2, float);
    if (nt == 4) BSR_TILE_LAUNCH(4, float);
  }
#undef BSR_TILE_LAUNCH
#undef BSR_TILE_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward of either variant: tile (M > 16 in the wrappers) or decode.
template <typename DecodeBlocks, typename TileBlocks>
int launch_fwd(const void* x, int x_is_bf16, DecodeBlocks wd, TileBlocks wt, const int* idx,
               const int* blk, const int* nnz, float* y, int M, int K, int N, int O,
               int jmax, int tile, int J, int x_vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wd.br != 1 && wd.br != 2 && wd.br != 4 && wd.br != 8 && wd.br != 16 && wd.br != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile)
    return launch_tile(x, x_is_bf16, wt, idx, blk, nnz, y, M, K, N, O, jmax, x_vec, st);
  return launch_decode(x, x_is_bf16, wd, idx, blk, nnz, y, M, K, N, O, jmax, J, x_vec, st);
}

template <int MT, typename TY, typename S>
int launch_bwd(const void* dy, const void* data, const int* t_idx, const int* t_blk,
               const int* t_nnz, float* dx, int M, int N, int K, int C, int jmax_t, int br,
               int bc, int dy_vec, int w_vec, int E, const Experts& ex, cudaStream_t st) {
  constexpr int R = 32 * MT;
  constexpr size_t smem = sizeof(bsr::H) * 2 *
      ((size_t)bsr::parts<TY>() * R * bsr::kStr + (size_t)bsr::parts<S>() * bsr::kK * kTStr);
  auto kern = bsr_tile_bwd<MT, TY, S, kExperts>;
  static size_t opted = 48 * 1024;             // the limit raised so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const int n_cc = (bc + kTCols - 1) / kTCols;
  const dim3 grid(C * n_cc, std::min((M + R - 1) / R, 65535), E);
  if (grid.x == 0 || M == 0 || E == 0) return 0;
  kern<<<grid, 128, smem, st>>>(static_cast<const TY*>(dy), static_cast<const S*>(data), t_idx,
                                t_blk, t_nnz, dx, M, N, K, jmax_t, br, bc, dy_vec, w_vec, ex);
  return static_cast<int>(cudaGetLastError());
}

template <typename TY, typename S>
int launch_bwd_mt(int mt, const void* dy, const void* data, const int* t_idx, const int* t_blk,
                  const int* t_nnz, float* dx, int M, int N, int K, int C, int jmax_t, int br,
                  int bc, int dy_vec, int w_vec, int E, const Experts& ex, cudaStream_t st) {
#define BSR_BWD_ARGS dy, data, t_idx, t_blk, t_nnz, dx, M, N, K, C, jmax_t, br, bc, dy_vec, \
                     w_vec, E, ex, st
  if (mt == 1) return launch_bwd<1, TY, S>(BSR_BWD_ARGS);
  if (mt == 2) return launch_bwd<2, TY, S>(BSR_BWD_ARGS);
#undef BSR_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The entries of this build: bsr_spmm_fwd, bsr_spmm_palette_fwd and
// bsr_spmm_t for one matrix, or bsr_spmm_t_experts for E stacked ones
// (bsr_spmm_experts.cu, which adds the expert forward's entries).
#if BSR_SPMM_EXPERTS
#define BSR_BWD(name) name##_experts
#else
#define BSR_BWD(name) name
#endif

extern "C" {

#if !BSR_SPMM_EXPERTS
// Y (M, N) f32 = X (M, K) @ W' for one BlockCSR W (N, K): data (n_slots, br,
// bc) f32, or bf16 when data_is_bf16, idx/blk (O, jmax) int32, nnz (O,)
// int32; br one of 1, 2, 4, 8, 16, 32. tile: the tile kernel, else the
// decode kernel with J warps a block-row (1, 2, 4 or 8); x_vec / w_vec: the
// rows of X / of the store are 16-byte aligned (vector loads and staging).
int bsr_spmm_fwd(const void* x, int x_is_bf16, const void* data, int data_is_bf16,
                 const int* idx, const int* blk, const int* nnz, float* y, int M, int K,
                 int N, int O, int jmax, int br, int bc, int tile, int J, int x_vec, int w_vec,
                 void* stream) {
  if (data_is_bf16) {
    const auto* d = static_cast<const __nv_bfloat16*>(data);
    return launch_fwd(x, x_is_bf16, FloatBlocks<__nv_bfloat16>{d, br, bc, w_vec != 0},
                      bsr::FloatBlocks<__nv_bfloat16>{d, br, bc, w_vec != 0}, idx, blk, nnz,
                      y, M, K, N, O, jmax, tile, J, x_vec, stream);
  }
  const auto* d = static_cast<const float*>(data);
  return launch_fwd(x, x_is_bf16, FloatBlocks<float>{d, br, bc, w_vec != 0},
                    bsr::FloatBlocks<float>{d, br, bc, w_vec != 0}, idx, blk, nnz, y, M, K,
                    N, O, jmax, tile, J, x_vec, stream);
}

// As bsr_spmm_fwd for one PaletteBCSR W: codes uint8 (n_slots, br, bc) at 8
// bits or (n_slots, br, bc/2) at 4 bits, palette (2**bits,) f32; w_vec: the
// codes start on a 16-byte boundary and bc is a multiple of 8.
int bsr_spmm_palette_fwd(const void* x, int x_is_bf16, const uint8_t* codes,
                         const float* palette, int bits, const int* idx, const int* blk,
                         const int* nnz, float* y, int M, int K, int N, int O, int jmax,
                         int br, int bc, int tile, int J, int x_vec, int w_vec, void* stream) {
  if (bits == 8)
    return launch_fwd(x, x_is_bf16, PaletteBlocks<8>{codes, palette, br, bc, w_vec != 0},
                      bsr::PaletteBlocks<8>{codes, palette, br, bc, w_vec != 0}, idx, blk,
                      nnz, y, M, K, N, O, jmax, tile, J, x_vec, stream);
  if (bits == 4)
    return launch_fwd(x, x_is_bf16, PaletteBlocks<4>{codes, palette, br, bc, w_vec != 0},
                      bsr::PaletteBlocks<4>{codes, palette, br, bc, w_vec != 0}, idx, blk,
                      nnz, y, M, K, N, O, jmax, tile, J, x_vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif

// dX (E, M, K) f32 = dY (E, M, N) @ W_e for E stacked BlockCSR W_e (N, K)
// (E = 1: one matrix), over the transposed tables t_idx/t_blk (E, C,
// jmax_t) int32 and t_nnz (E, C) int32: dY f32 or bf16, data f32 or bf16
// (E, n_slots, br, bc); br one of 1, 2, 4, 8, 16, 32; mt 1 or 2: 32 mt rows
// of dX a thread block; dy_vec / w_vec: the rows of dY / of the store are
// 16-byte aligned and br / bc are multiples of 16 bytes' worth.
int BSR_BWD(bsr_spmm_t)(const void* dy, int dy_is_bf16, const void* data, int data_is_bf16,
                        const int* t_idx, const int* t_blk, const int* t_nnz, float* dx,
                        int M, int N, int K, int C, int jmax_t, int br, int bc, int mt,
                        int dy_vec, int w_vec, int E, int n_slots, void* stream) {
  if (br != 1 && br != 2 && br != 4 && br != 8 && br != 16 && br != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E < 1 || E > 65535 || (!kExperts && E != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Experts ex{(long long)M * N, (long long)M * K, (long long)C * jmax_t, (long long)C,
                   (long long)n_slots * br * bc};
#define BSR_BWD_ARGS mt, dy, data, t_idx, t_blk, t_nnz, dx, M, N, K, C, jmax_t, br, bc, \
                     dy_vec, w_vec, E, ex, st
  if (dy_is_bf16)
    return data_is_bf16 ? launch_bwd_mt<__nv_bfloat16, __nv_bfloat16>(BSR_BWD_ARGS)
                        : launch_bwd_mt<__nv_bfloat16, float>(BSR_BWD_ARGS);
  return data_is_bf16 ? launch_bwd_mt<float, __nv_bfloat16>(BSR_BWD_ARGS)
                      : launch_bwd_mt<float, float>(BSR_BWD_ARGS);
#undef BSR_BWD_ARGS
}

}  // extern "C"

#undef BSR_BWD
