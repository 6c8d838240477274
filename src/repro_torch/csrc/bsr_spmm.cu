// Gather-block-matmul for BlockCSR and PaletteBCSR weights on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   repro/kernels/bsr_spmm/bsr_spmm.py::gather_block_matmul          (forward,
//       transpose_block=True, as called by ops.spmm)
//   repro/kernels/bsr_spmm/bsr_spmm.py::gather_block_matmul_palette  (forward,
//       as called by ops.spmm_palette)
//
// Both compute Y (M, N) = X (M, K) @ W' for a block-sparse W (N, K) with
// (br, bc) blocks: output block-row o accumulates
//   X[:, idx[o,j]*bc : +bc] @ B(blk[o,j])'   for j < nnz[o],
// in f32, where B(s) is the fp32 block of slot s (BlockCSR) or palette[code]
// over the uint8 codes of slot s (PaletteBCSR; at 4 bits two codes share a
// byte, low nibble first, and code 0 is exact zero).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 without tensor cores):
// at decode M = 4 each stored block is used for 4 rows only, so the kernel
// is bound by bytes: the resident blocks (4 B per entry for BlockCSR, 1 or
// 0.5 B for the palette codes) plus X plus Y, over 3.35 TB/s. At prefill
// (M = 512) the f32 FMAs are the larger term. br must be a power of two up
// to 32.
//
// Design against that bound: one thread block (8 warps) per output block-row
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

// fp32 block store: data (n_slots, br, bc)
struct FloatBlocks {
  const float* data;
  int br, bc;
  static constexpr int kPalette = 1;   // no palette (1: a legal array size)
  __device__ __forceinline__ void stage(float*, int, int) const {}
  __device__ __forceinline__ float load(int s, int r, int k, const float*) const {
    return data[((size_t)s * br + r) * bc + k];
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

// Y (M, N) f32 = X (M, K) @ W' for BlockCSR W: data (n_slots, br, bc) f32,
// idx/blk (O, jmax) int32, nnz (O,) int32; br one of 1, 2, 4, 8, 16, 32.
int bsr_spmm_fwd(const void* x, int x_is_bf16, const float* data, const int* idx,
                 const int* blk, const int* nnz, float* y, int M, int K, int N, int O,
                 int jmax, int br, int bc, void* stream) {
  FloatBlocks w{data, br, bc};
  return launch(x, x_is_bf16, w, idx, blk, nnz, y, M, K, N, O, jmax, stream);
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
