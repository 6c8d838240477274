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
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 without tensor cores):
// at decode M = 4 each stored block is used for 4 rows only, so the kernel
// is bound by bytes: the resident blocks (4 B per entry for BlockCSR, 1 or
// 0.5 B for the palette codes) plus X plus Y, over 3.35 TB/s. At prefill
// and in training (M = 512) the f32 FMAs are the larger term. br must be a
// power of two up to 32.
//
// Forward design against that bound: one thread block (8 warps) per output block-row
// o and a tile of rows of X. Each block reads its own nnz[o], idx and blk
// entries (the TPU's sequential grid axis becomes a loop over j < nnz[o]; a
// padded gather entry is never read). At decode its warps split the row's
// resident blocks, so they are fetched in parallel rather than one after
// another; at large M they split the rows, so each block is read once per
// 8 * 32 / br rows. A warp reads each block row as one coalesced segment,
// with no barrier inside the loop, and keeps a (32 / br) x br tile of
// partial sums in registers. The palette (at most 256 floats) is staged in
// shared memory and indexed directly: the one-hot matvec of the TPU kernel
// was a Mosaic workaround for its missing vector gather. Codes are expanded
// in registers, so the bytes read per block are 4x / 8x fewer than for
// BlockCSR. Reads of X past K (960 is not a multiple of 128) or past M are
// masked to zero in the kernel; X is not padded. Every output element is
// written exactly once, so an empty matrix (all nnz = 0) writes zeros. No
// tensor cores, TMA or multi-stage pipelining yet.
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
// no atomics, deterministic.
//
// Built with nvcc into a shared library with a plain C interface; each entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
#pragma unroll 4
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
int launch(const void* x, int x_is_bf16, Blocks w, const int* idx, const int* blk,
           const int* nnz, float* y, int M, int K, int N, int O, int jmax,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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

}  // namespace

extern "C" {

// Y (M, N) f32 = X (M, K) @ W' for BlockCSR W: data (n_slots, br, bc) f32, or
// bf16 when data_is_bf16, idx/blk (O, jmax) int32, nnz (O,) int32; br one of
// 1, 2, 4, 8, 16, 32.
int bsr_spmm_fwd(const void* x, int x_is_bf16, const void* data, int data_is_bf16,
                 const int* idx, const int* blk, const int* nnz, float* y, int M, int K,
                 int N, int O, int jmax, int br, int bc, void* stream) {
  if (data_is_bf16) {
    FloatBlocks<__nv_bfloat16> w{static_cast<const __nv_bfloat16*>(data), br, bc};
    return launch(x, x_is_bf16, w, idx, blk, nnz, y, M, K, N, O, jmax, stream);
  }
  FloatBlocks<float> w{static_cast<const float*>(data), br, bc};
  return launch(x, x_is_bf16, w, idx, blk, nnz, y, M, K, N, O, jmax, stream);
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
// (n_slots, br, bc/2) at 4 bits, palette (2**bits,) f32.
int bsr_spmm_palette_fwd(const void* x, int x_is_bf16, const uint8_t* codes,
                         const float* palette, int bits, const int* idx, const int* blk,
                         const int* nnz, float* y, int M, int K, int N, int O, int jmax,
                         int br, int bc, void* stream) {
  if (bits == 8) {
    PaletteBlocks<8> w{codes, palette, br, bc};
    return launch(x, x_is_bf16, w, idx, blk, nnz, y, M, K, N, O, jmax, stream);
  }
  if (bits == 4) {
    PaletteBlocks<4> w{codes, palette, br, bc};
    return launch(x, x_is_bf16, w, idx, blk, nnz, y, M, K, N, O, jmax, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
