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
// blocks (the store's element size per entry: 4 B f32, 2 B bf16, 1 or 0.5 B
// for the palette codes) plus X plus Y. At prefill (M = 256 in the engine)
// and in training (M = 512) the products are priced at the f32 rate when
// an operand is f32 and at the bf16 rate when both are bf16; at these
// sparse widths the bytes stay the larger term at the bf16 rate.
//
// The forward has two kernels, chosen by M in the wrapper (ops.spmm,
// ops.spmm_palette; a stated threshold, never a fallback):
//
// * M > 16, bsr_tile_fwd: the block-tile core (bsr_tile.cuh) on the tensor
//   cores. One thread block per output block-row o and 32 * n_warps rows
//   of X (n_warps 4, or 2 for f32 x, whose three parts would not fit two
//   stages of 128 rows; 1 and 2 warps were not faster even where 4 leave
//   SMs idle, PERF.md). Each resident block j, 128 columns at a
//   time, is one job: the X slab (rows x 128, gathered at column
//   idx[o,j]*bc; X stays in L2) and the block (br x 128, as stored) are
//   copied by cp.async into a ring of two stages, the next job's copies in
//   flight while this job's block is converted into bf16 parts and its
//   products run. The block is staged once per thread block and shared by
//   its warps; each warp runs its 32 rows (two m-tiles) against it
//   (mma.sync m16n8k16: n = br, one n-tile at br 8, 2 or 4 at br 16 / 32,
//   zero-filled n at br < 8). f32 operands (the f32 store, the palette,
//   f32 X) go as three bf16 parts that hold them exactly, and each block's
//   products are summed from zero and added to the accumulator in f32 (see
//   bsr_tile.cuh). Reads past K or M, and columns past the block's bc, are
//   staged as zero; X is not padded. What holds it back: every resident
//   block re-reads its X slab from L2, so its time grows with M well
//   above the bound (PERF.md); sharing slabs between the block-rows of a
//   column is the next step.
// * M <= 16, gather_block_matmul_fwd: the decode kernel, an f32 FMA loop
//   (a 16-row mma tile would be mostly padding, and this kernel beats its
//   library call at M = 4). One thread block (8 warps) per output
//   block-row o and a tile of rows of X. Each block reads its own nnz[o],
//   idx and blk entries (the TPU's sequential grid axis becomes a loop over
//   j < nnz[o]; a padded gather entry is never read). Its warps split the
//   row's resident blocks, so they are fetched in parallel; a warp reads
//   each block row as one coalesced segment, with no barrier inside the
//   loop, and keeps a (32 / br) x br tile of partial sums in registers.
//   The palette (at most 256 floats) is staged in shared memory and indexed
//   directly: the one-hot matvec of the TPU kernel was a Mosaic workaround
//   for its missing vector gather.
//
// Every output element of both is written exactly once, so an empty matrix
// (all nnz = 0) writes zeros. br must be a power of two up to 32.
//
// Backward design: the forward's warp tile is (32 / br) x br outputs, shaped
// for br <= 32 output columns; a backward output block-column is bc = 128
// wide with an inner dimension of only br = 8, so it has its own kernel. One
// thread block per (output block-column c, tile of kBwdRows rows, chunk of
// 128 columns). Per resident block j it stages the (rows x br) slab of dY in
// shared memory, and each thread reads its column of the (br, bc) block
// straight from global memory (a warp reads 32 consecutive floats) and keeps
// kBwdRows / 2 partial sums in registers. Reads of dY past N or M and writes
// of dX past K are masked. Every output is written once, in a fixed order:
// no atomics, deterministic. No tensor cores yet.
//
// Built with nvcc into a shared library with a plain C interface; each entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bsr_tile.cuh"

namespace {

constexpr int kWarps = 8;            // warps per thread block
constexpr int kTile = 32;            // outputs per warp: BM rows x BR cols

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// fp block store: data (n_slots, br, bc), S = float or __nv_bfloat16
template <typename S>
struct FloatBlocks {
  const S* data;
  int br, bc;
  static constexpr int kPalette = 1;   // no palette (1: a legal array size)
  static constexpr int kUnroll = 4;    // columns a lane has in flight
  __device__ __forceinline__ void stage(float*, int, int) const {}
  __device__ __forceinline__ float load(int s, int r, int k, const float*) const {
    return to_f32(data[((size_t)s * br + r) * bc + k]);
  }
};

// palette store: codes (n_slots, br, bc) at 8 bits, (n_slots, br, bc/2) at 4
template <int BITS>
struct PaletteBlocks {
  const uint8_t* codes;
  const float* palette;
  int br, bc;
  static constexpr int kPalette = 1 << BITS;
  // at 4 bits the nibble selects of 4 columns in flight spilled at BR 8-16
  static constexpr int kUnroll = BITS == 4 ? 2 : 4;
  __device__ __forceinline__ void stage(float* pal, int tid, int nt) const {
    for (int i = tid; i < kPalette; i += nt) pal[i] = palette[i];
  }
  __device__ __forceinline__ float load(int s, int r, int k, const float* pal) const {
    int code;
    if (BITS == 8) {
      code = codes[((size_t)s * br + r) * bc + k];
    } else {
      const uint8_t b = codes[((size_t)s * br + r) * (bc / 2) + k / 2];
      code = (k & 1) ? (b >> 4) : (b & 0xF);
    }
    return code ? pal[code] : 0.0f;
  }
};

// One thread block per output block-row o and n_rw * BM rows of X, BM =
// 32 / BR. Its 8 warps form n_rw row groups of BM rows times 8 / n_rw
// resident-block groups: warp w takes rows group w % n_rw and the resident
// blocks j = w / n_rw, w / n_rw + 8 / n_rw, ... < nnz[o]. At decode
// (n_rw = 1) a row's blocks are fetched by 8 warps in parallel; at large M
// (n_rw = 8) each block is read once per 8 * BM rows. Lane l takes block
// columns l, l + 32, ..., so a warp reads each block row as one coalesced
// segment, with no barrier inside the loop; each lane keeps its BM x BR
// tile of partial sums in registers. Lanes combine by shuffles, the warps
// of a row group through shared memory.
template <int BR, typename T, typename Blocks>
__global__ void __launch_bounds__(kWarps * 32)
gather_block_matmul_fwd(const T* __restrict__ x, Blocks w,
                        const int* __restrict__ idx,
                        const int* __restrict__ blk,
                        const int* __restrict__ nnz,
                        float* __restrict__ y, int M, int K, int N, int jmax,
                        int n_rw) {
  constexpr int BM = kTile / BR;
  __shared__ float pal[Blocks::kPalette];
  __shared__ float part[kWarps][kTile];

  const int bc = w.bc;
  const int o = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_jw = kWarps / n_rw;
  const int m0 = (blockIdx.y * n_rw + warp % n_rw) * BM;
  w.stage(pal, threadIdx.x, blockDim.x);       // palette, if any
  __syncthreads();

  float acc[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) acc[i] = 0.0f;

  const int n_j = nnz[o];
  for (int j = warp / n_rw; j < n_j; j += n_jw) {
    const int c = idx[(size_t)o * jmax + j];
    const int s = blk[(size_t)o * jmax + j];
#pragma unroll Blocks::kUnroll
    for (int k = lane; k < bc; k += 32) {
      const int col = c * bc + k;             // reads past K or M give 0
      float xv[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const int row = m0 + m;
        xv[m] = (row < M && col < K) ? to_f32(x[(size_t)row * K + col]) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float wv = w.load(s, r, k, pal);
#pragma unroll
        for (int m = 0; m < BM; ++m) acc[m * BR + r] += xv[m] * wv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTile; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kTile; ++i) part[warp][i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x < n_rw * kTile) {
    const int g = threadIdx.x / kTile, i = threadIdx.x % kTile;
    float v = 0.0f;
    for (int q = 0; q < n_jw; ++q) v += part[q * n_rw + g][i];
    const int row = (blockIdx.y * n_rw + g) * BM + i / BR, col = o * BR + i % BR;
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

constexpr int kBwdRows = 32;        // dX rows per thread block (backward)
constexpr int kBwdCols = 128;        // dX columns per thread block (backward)
constexpr int kBwdMaxBr = 32;

// dX (M, K) = dY (M, N) @ W. blockDim = (kBwdCols, 2): thread (tx, ty) owns
// column c * bc + col0 + tx and rows m0 + ty * kBwdRows / 2 + i.
template <typename T, typename S>
__global__ void __launch_bounds__(kBwdCols * 2)
gather_block_matmul_bwd(const T* __restrict__ dy, const S* __restrict__ data,
                        const int* __restrict__ t_idx,
                        const int* __restrict__ t_blk,
                        const int* __restrict__ t_nnz,
                        float* __restrict__ dx, int M, int N, int K, int jmax_t,
                        int br, int bc) {
  constexpr int RPT = kBwdRows / 2;
  __shared__ float slab[kBwdRows][kBwdMaxBr];
  const int c = blockIdx.x;
  const int m0 = blockIdx.y * kBwdRows;
  const int k = blockIdx.z * kBwdCols + threadIdx.x;        // column in the block
  const int tid = threadIdx.y * kBwdCols + threadIdx.x;
  const bool col_ok = k < bc;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.0f;

  const int n_j = t_nnz[c];
  for (int j = 0; j < n_j; ++j) {
    const int r = t_idx[(size_t)c * jmax_t + j];
    const int s = t_blk[(size_t)c * jmax_t + j];
    __syncthreads();                       // the previous slab is consumed
    for (int e = tid; e < kBwdRows * br; e += kBwdCols * 2) {
      const int row = m0 + e / br, n = r * br + e % br;
      slab[e / br][e % br] =
          (row < M && n < N) ? to_f32(dy[(size_t)row * N + n]) : 0.0f;
    }
    __syncthreads();
    if (col_ok) {
      const S* blkp = data + (size_t)s * br * bc + k;
      for (int rr = 0; rr < br; ++rr) {
        const float wv = to_f32(blkp[(size_t)rr * bc]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] += slab[threadIdx.y * RPT + i][rr] * wv;
      }
    }
  }
  const int col = c * bc + k;
  if (col_ok && col < K) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = m0 + threadIdx.y * RPT + i;
      if (row < M) dx[(size_t)row * K + col] = acc[i];
    }
  }
}

template <typename T, typename S>
void launch_bwd(const void* dy, const void* data, const int* t_idx, const int* t_blk,
                const int* t_nnz, float* dx, int M, int N, int K, int C, int jmax_t,
                int br, int bc, cudaStream_t st) {
  const dim3 grid(C, (M + kBwdRows - 1) / kBwdRows, (bc + kBwdCols - 1) / kBwdCols);
  const dim3 block(kBwdCols, 2);
  gather_block_matmul_bwd<T, S><<<grid, block, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const S*>(data), t_idx, t_blk, t_nnz,
      dx, M, N, K, jmax_t, br, bc);
}

template <int BR, typename Blocks>
void launch_br(const void* x, int x_is_bf16, Blocks w, const int* idx, const int* blk,
               const int* nnz, float* y, int M, int K, int N, int O, int jmax,
               cudaStream_t st) {
  constexpr int BM = kTile / BR;
  int n_rw = 1;                                // row groups: enough for M, <= 8
  while (n_rw < kWarps && n_rw * BM < M) n_rw *= 2;
  const dim3 grid(O, (M + n_rw * BM - 1) / (n_rw * BM));
  if (x_is_bf16) {
    gather_block_matmul_fwd<BR, __nv_bfloat16, Blocks><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w, idx, blk, nnz, y, M, K, N, jmax, n_rw);
  } else {
    gather_block_matmul_fwd<BR, float, Blocks><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), w, idx, blk, nnz, y, M, K, N, jmax, n_rw);
  }
}

template <typename Blocks>
int launch_decode(const void* x, int x_is_bf16, Blocks w, const int* idx, const int* blk,
                  const int* nnz, float* y, int M, int K, int N, int O, int jmax,
                  cudaStream_t st) {
  switch (w.br) {
    case 1: launch_br<1>(x, x_is_bf16, w, idx, blk, nnz, y, M, K, N, O, jmax, st); break;
    case 2: launch_br<2>(x, x_is_bf16, w, idx, blk, nnz, y, M, K, N, O, jmax, st); break;
    case 4: launch_br<4>(x, x_is_bf16, w, idx, blk, nnz, y, M, K, N, O, jmax, st); break;
    case 8: launch_br<8>(x, x_is_bf16, w, idx, blk, nnz, y, M, K, N, O, jmax, st); break;
    case 16: launch_br<16>(x, x_is_bf16, w, idx, blk, nnz, y, M, K, N, O, jmax, st); break;
    case 32: launch_br<32>(x, x_is_bf16, w, idx, blk, nnz, y, M, K, N, O, jmax, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  kern<<<grid, 32 * n_warps, smem, st>>>(static_cast<const TX*>(x), w, idx, blk, nnz, y, M,
                                         K, N, jmax, x_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename Blocks>
int launch_tile(const void* x, int x_is_bf16, Blocks w, const int* idx, const int* blk,
                const int* nnz, float* y, int M, int K, int N, int O, int jmax, int x_vec,
                cudaStream_t st) {
#define BSR_TILE_ARGS x, w, idx, blk, nnz, y, M, K, N, O, jmax, x_vec, st
  const int nt = bsr::n_tiles(w.br);
  if (x_is_bf16) {
    if (nt == 1) return launch_tile_t<1, __nv_bfloat16>(BSR_TILE_ARGS);
    if (nt == 2) return launch_tile_t<2, __nv_bfloat16>(BSR_TILE_ARGS);
    if (nt == 4) return launch_tile_t<4, __nv_bfloat16>(BSR_TILE_ARGS);
  } else {
    if (nt == 1) return launch_tile_t<1, float>(BSR_TILE_ARGS);
    if (nt == 2) return launch_tile_t<2, float>(BSR_TILE_ARGS);
    if (nt == 4) return launch_tile_t<4, float>(BSR_TILE_ARGS);
  }
#undef BSR_TILE_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward of either variant: tile (M > 16 in the wrappers) or decode.
template <typename DecodeBlocks, typename TileBlocks>
int launch_fwd(const void* x, int x_is_bf16, DecodeBlocks wd, TileBlocks wt, const int* idx,
               const int* blk, const int* nnz, float* y, int M, int K, int N, int O,
               int jmax, int tile, int x_vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wd.br != 1 && wd.br != 2 && wd.br != 4 && wd.br != 8 && wd.br != 16 && wd.br != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile)
    return launch_tile(x, x_is_bf16, wt, idx, blk, nnz, y, M, K, N, O, jmax, x_vec, st);
  return launch_decode(x, x_is_bf16, wd, idx, blk, nnz, y, M, K, N, O, jmax, st);
}

}  // namespace

extern "C" {

// Y (M, N) f32 = X (M, K) @ W' for BlockCSR W: data (n_slots, br, bc) f32, or
// bf16 when data_is_bf16, idx/blk (O, jmax) int32, nnz (O,) int32; br one of
// 1, 2, 4, 8, 16, 32. tile: the tile kernel, else the decode kernel; x_vec /
// w_vec: the rows of X / of the store are 16-byte aligned (the tile
// kernel's vector staging).
int bsr_spmm_fwd(const void* x, int x_is_bf16, const void* data, int data_is_bf16,
                 const int* idx, const int* blk, const int* nnz, float* y, int M, int K,
                 int N, int O, int jmax, int br, int bc, int tile, int x_vec, int w_vec,
                 void* stream) {
  if (data_is_bf16) {
    const auto* d = static_cast<const __nv_bfloat16*>(data);
    return launch_fwd(x, x_is_bf16, FloatBlocks<__nv_bfloat16>{d, br, bc},
                      bsr::FloatBlocks<__nv_bfloat16>{d, br, bc, w_vec != 0}, idx, blk, nnz,
                      y, M, K, N, O, jmax, tile, x_vec, stream);
  }
  const auto* d = static_cast<const float*>(data);
  return launch_fwd(x, x_is_bf16, FloatBlocks<float>{d, br, bc},
                    bsr::FloatBlocks<float>{d, br, bc, w_vec != 0}, idx, blk, nnz, y, M, K,
                    N, O, jmax, tile, x_vec, stream);
}

// dX (M, K) f32 = dY (M, N) @ W for BlockCSR W (N, K), over the transposed
// tables t_idx/t_blk (C, jmax_t) int32 and t_nnz (C,) int32: dY f32 or bf16,
// data f32 or bf16 (n_slots, br, bc); br at most 32.
int bsr_spmm_t(const void* dy, int dy_is_bf16, const void* data, int data_is_bf16,
               const int* t_idx, const int* t_blk, const int* t_nnz, float* dx, int M,
               int N, int K, int C, int jmax_t, int br, int bc, void* stream) {
  if (br < 1 || br > kBwdMaxBr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dy_is_bf16) {
    if (data_is_bf16)
      launch_bwd<__nv_bfloat16, __nv_bfloat16>(dy, data, t_idx, t_blk, t_nnz, dx, M, N, K, C, jmax_t, br, bc, st);
    else
      launch_bwd<__nv_bfloat16, float>(dy, data, t_idx, t_blk, t_nnz, dx, M, N, K, C, jmax_t, br, bc, st);
  } else {
    if (data_is_bf16)
      launch_bwd<float, __nv_bfloat16>(dy, data, t_idx, t_blk, t_nnz, dx, M, N, K, C, jmax_t, br, bc, st);
    else
      launch_bwd<float, float>(dy, data, t_idx, t_blk, t_nnz, dx, M, N, K, C, jmax_t, br, bc, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// As bsr_spmm_fwd for PaletteBCSR W: codes uint8 (n_slots, br, bc) at 8 bits or
// (n_slots, br, bc/2) at 4 bits, palette (2**bits,) f32; w_vec: the codes
// start on a 16-byte boundary and bc is a multiple of 8.
int bsr_spmm_palette_fwd(const void* x, int x_is_bf16, const uint8_t* codes,
                         const float* palette, int bits, const int* idx, const int* blk,
                         const int* nnz, float* y, int M, int K, int N, int O, int jmax,
                         int br, int bc, int tile, int x_vec, int w_vec, void* stream) {
  if (bits == 8)
    return launch_fwd(x, x_is_bf16, PaletteBlocks<8>{codes, palette, br, bc},
                      bsr::PaletteBlocks<8>{codes, palette, br, bc, w_vec != 0}, idx, blk,
                      nnz, y, M, K, N, O, jmax, tile, x_vec, stream);
  if (bits == 4)
    return launch_fwd(x, x_is_bf16, PaletteBlocks<4>{codes, palette, br, bc},
                      bsr::PaletteBlocks<4>{codes, palette, br, bc, w_vec != 0}, idx, blk,
                      nnz, y, M, K, N, O, jmax, tile, x_vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
