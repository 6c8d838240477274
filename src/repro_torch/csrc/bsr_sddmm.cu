// Sampled dense-dense matmul (SDDMM) for BlockCSR weight gradients on
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/bsr_sddmm/bsr_sddmm.py::sddmm_block_grad
// (as called by repro/kernels/bsr_sddmm/ops.py::bsr_weight_grad).
//
// dW[s] (br, bc) = dY[:, r_s*br : +br]' @ X[:, c_s*bc : +bc], summed over
// the M rows, for every slot s of the block store, where (r_s, c_s) are
// the slot's block coordinates; invalid slots (slot 0, the pad, and the
// trailing slots pad_bcsr appends) are written as zero. Only the resident
// blocks are computed: no dense (N, K) gradient exists anywhere.
//
// Bound on an H100 SXM: each valid slot does 2 M br bc flops and needs the
// X and dY columns of its block; the bound is the larger of those bytes
// (each X / dY column that some slot needs read once, the f32 output
// written once) over 3.35 TB/s and the flops over 989 TFLOP/s (bf16 x
// bf16) or 67 TFLOP/s (an f32 operand). At smollm-360m's widths and M =
// 512 the bytes are the larger term.
//
// Design: the block-tile core (bsr_tile.cuh) on the tensor cores, with
// dW(s)' (bc x br) = X[:, c bc : +bc]' dY[:, r br : +br] as the product:
// m = bc (16-column m-tiles of X), n = br (one n-tile of 8 at br 8, 2 or 4
// at br 16 / 32, zero-filled n at br < 8), and the depth taken along M.
// * Slots that share a block-column share their X slab: a thread block
//   takes a group of 4 / NT slots of one block-column c in the order of the
//   block-CSC tables (gather_t_*; blockIdx.y is the group), 128 columns of
//   the block and 32 of its rows (blockIdx.x runs over c, then the
//   128-column chunks, then the 32-row groups; one of each at (8, 128)).
//   It stages X[rows, c bc + kc : +128] once per chunk of 64 rows for all
//   its slots, and each slot's dY slab beside it, by cp.async (16-bit,
//   aligned) or plain loads (f32 split into three bf16 parts that hold it
//   exactly, see bsr_tile.cuh) into a ring of two stages.
// * Warp w owns slot w / NT of the group and m-tiles (w % NT) * 8 / NT ..,
//   all NT n-tiles: 8 mma tiles, 32 f32 sums a thread. Each chunk's
//   products start from zero and are added to the sums in f32.
// * At smollm-360m's widths there are only 8 block-columns, so the wrapper
//   also splits M into n_split ranges of whole chunks (blockIdx.z) until
//   the grid fills the card; each range writes its partial sums to a
//   scratch (n_split, n_slots, br, bc), and a second kernel adds them in
//   the order z = 0, 1, ... Every output is summed by one thread in a fixed
//   order: no atomics, so two runs give bit-equal gradients.
// * The zeros of the invalid slots: written by the thread blocks past the
//   columns' (the last blockIdx.x, at y = 0) when M is not split, else by
//   the combine.
//
// Built with nvcc into a shared library with a plain C interface; the
// entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bsr_tile.cuh"

namespace {

using bsr::H;
using bsr::kChunk;
using bsr::kK;
using bsr::kStr;

constexpr int kWarps = 4;
constexpr int kZeroSlots = 8;         // invalid-slot zeroing: slots per block

__host__ __device__ constexpr int dy_cols(int nt) { return nt == 4 ? 32 : 16; }
__host__ __device__ constexpr int dy_stride(int nt) { return dy_cols(nt) + 8; }

// Stage chunk q (rows r0 + 64 q ..) into stage q & 1: the X slab at
// columns c bc + kc .. + 128, and beside it the dY slab of each of the
// thread block's SPB slots j0 .. (columns nc .. + 32 of the slot's
// block-row; zero for a slot past the column's count).
template <int SPB, int NT, int XS, int YS, typename TY, typename TX>
__device__ __forceinline__ void stage_chunk(int q, const TY* dy, const TX* x,
                                            const int* t_idx, int c, int jmax_t, int j0,
                                            int n_j, int r0, int r1, int N, int K, int br,
                                            int bc, int kc, int nc, bool x_vec, bool y_vec,
                                            bsr::H* xs, bsr::H* ys) {
  using bsr::kChunk;
  using bsr::kStr;
  constexpr int YSTR = dy_stride(NT);
  constexpr int xpart = kChunk * kStr, ypart = SPB * kChunk * YSTR;
  const int m = r0 + q * kChunk;
  bsr::stage<XS>(xs + (q & 1) * XS * xpart, kStr, xpart, x, K, m, kChunk, r1,
                 c * bc + kc, min(K, c * bc + bc), bsr::kK / 8, x_vec);
#pragma unroll
  for (int i = 0; i < SPB; ++i) {
    const bool live = j0 + i < n_j;
    const int row = live ? t_idx[(size_t)c * jmax_t + j0 + i] : 0;
    bsr::stage<YS>(ys + (q & 1) * YS * ypart + i * kChunk * YSTR, YSTR, ypart, dy, N, m,
                   kChunk, r1, row * br + nc, live ? min(N, row * br + br) : 0,
                   dy_cols(NT) / 8, y_vec);
  }
}

template <int NT, typename TY, typename TX>
__global__ void __launch_bounds__(kWarps * 32, 1)
sddmm_tile_kernel(const TY* __restrict__ dy, const TX* __restrict__ x,
                  const int* __restrict__ t_idx, const int* __restrict__ t_blk,
                  const int* __restrict__ t_nnz, const int* __restrict__ valid,
                  float* __restrict__ out, int M, int N, int K, int C, int jmax_t, int br,
                  int bc, int n_slots, int rows_per_split, int x_vec, int y_vec) {
  constexpr int XS = bsr::parts<TX>(), YS = bsr::parts<TY>();
  constexpr int SPB = kWarps / NT;                 // slots per thread block
  constexpr int MT = kK / 16 / NT;                 // m-tiles per warp
  constexpr int YSTR = dy_stride(NT);
  constexpr int xpart = kChunk * kStr, xstage = XS * xpart;
  constexpr int ypart = SPB * kChunk * YSTR, ystage = YS * ypart;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  H* const xs = reinterpret_cast<H*>(smem_raw);    // [2][XS][kChunk][kStr]
  H* const ys = xs + 2 * xstage;                   // [2][YS][SPB][kChunk][YSTR]
  const int n_kc = (bc + kK - 1) / kK, n_nc = (br + 31) / 32;
  const size_t n_out = (size_t)br * bc;

  if ((int)blockIdx.x >= C * n_kc * n_nc) {        // zeros of invalid slots
    if (blockIdx.y || blockIdx.z) return;
    const int s0 = (blockIdx.x - C * n_kc * n_nc) * kZeroSlots;
    for (int s = s0; s < min(s0 + kZeroSlots, n_slots); ++s)
      if (!valid[s])
        for (size_t e = threadIdx.x; e < n_out; e += blockDim.x) out[s * n_out + e] = 0.f;
    return;
  }
  const int c = blockIdx.x / (n_kc * n_nc);
  const int kc = (blockIdx.x / n_nc % n_kc) * kK, nc = (blockIdx.x % n_nc) * 32;
  const int j0 = blockIdx.y * SPB;
  const int n_j = t_nnz[c];
  if (j0 >= n_j) return;                           // block-uniform
  const int z = blockIdx.z;
  const int r0 = z * rows_per_split, r1 = min(M, r0 + rows_per_split);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my_j = j0 + warp / NT, mg = warp % NT;
  float acc[MT][NT][4], t[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
  const int chunks = (r1 - r0 + kChunk - 1) / kChunk;
  if (chunks > 0)
    stage_chunk<SPB, NT, XS, YS>(0, dy, x, t_idx, c, jmax_t, j0, n_j, r0, r1, N, K, br, bc,
                                 kc, nc, x_vec != 0, y_vec != 0, xs, ys);
  tc::cp_async_commit();
  for (int q = 0; q < chunks; ++q) {
    if (q + 1 < chunks)
      stage_chunk<SPB, NT, XS, YS>(q + 1, dy, x, t_idx, c, jmax_t, j0, n_j, r0, r1, N, K,
                                   br, bc, kc, nc, x_vec != 0, y_vec != 0, xs, ys);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[a][n][e] = 0.f;
    bsr::sddmm_chunk<MT, NT, XS, YS>(t, xs + (q & 1) * xstage, xpart, mg * MT * 16,
                                     ys + (q & 1) * ystage + (warp / NT) * kChunk * YSTR,
                                     ypart, YSTR);
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] += t[a][n][e];
    __syncthreads();
  }
  if (my_j >= n_j) return;
  const int s = t_blk[(size_t)c * jmax_t + my_j];
  float* const o = out + ((size_t)z * n_slots + s) * n_out;
  // thread: X columns (m) lane / 4 and lane / 4 + 8 of each m-tile, dY
  // columns (n) 8n + 2 (lane % 4) + {0, 1}; dW[s] is (br, bc), so dW[n][m]
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = kc + (mg * MT + a) * 16 + (lane >> 2) + 8 * h;
      if (m >= bc) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nc + n * 8 + (lane & 3) * 2 + e;
          if (col < br) o[(size_t)col * bc + m] = acc[a][n][2 * h + e];
        }
    }
}

// out[s] = sum over z of part[z][s], z = 0, 1, ... in order, at valid
// slots; zero at the others.
__global__ void sddmm_combine_kernel(const float* __restrict__ part,
                                     const int* __restrict__ valid, float* __restrict__ out,
                                     int n_slots, int n_out, int n_split) {
  const size_t total = (size_t)n_slots * n_out;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    if (valid[e / n_out])
      for (int z = 0; z < n_split; ++z) v += part[(size_t)z * total + e];
    out[e] = v;
  }
}

template <int NT, typename TY, typename TX>
int launch_t(const void* dy, const void* x, const int* t_idx, const int* t_blk,
             const int* t_nnz, const int* valid, float* out, float* scratch, int M, int N,
             int K, int C, int jmax_t, int n_slots, int br, int bc, int n_split, int x_vec,
             int y_vec, cudaStream_t st) {
  constexpr int XS = bsr::parts<TX>(), YS = bsr::parts<TY>();
  constexpr int SPB = kWarps / NT;
  const size_t smem = sizeof(H) * 2 *
      ((size_t)XS * kChunk * kStr + (size_t)YS * SPB * kChunk * dy_stride(NT));
  auto kern = sddmm_tile_kernel<NT, TY, TX>;
  static size_t opted = 48 * 1024;             // the limit raised so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const int n_kc = (bc + kK - 1) / kK, n_nc = (br + 31) / 32;
  const int groups = std::max(1, (jmax_t + SPB - 1) / SPB);
  // the zeros of the invalid slots: these blocks without a split of M,
  // the combine with one
  const int zero_blocks = n_split > 1 ? 0 : (n_slots + kZeroSlots - 1) / kZeroSlots;
  const int rows = ((M + n_split - 1) / n_split + kChunk - 1) / kChunk * kChunk;
  const dim3 grid(C * n_kc * n_nc + zero_blocks, groups, n_split);
  kern<<<grid, kWarps * 32, smem, st>>>(
      static_cast<const TY*>(dy), static_cast<const TX*>(x), t_idx, t_blk, t_nnz, valid,
      n_split > 1 ? scratch : out, M, N, K, C, jmax_t, br, bc, n_slots, rows, x_vec, y_vec);
  if (n_split > 1) {
    const size_t total = (size_t)n_slots * br * bc;
    const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256, 4096));
    sddmm_combine_kernel<<<blocks, 256, 0, st>>>(scratch, valid, out, n_slots, br * bc,
                                                 n_split);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TY, typename TX>
int launch(const void* dy, const void* x, const int* t_idx, const int* t_blk,
           const int* t_nnz, const int* valid, float* out, float* scratch, int M, int N,
           int K, int C, int jmax_t, int n_slots, int br, int bc, int n_split, int x_vec,
           int y_vec, cudaStream_t st) {
#define SDDMM_ARGS dy, x, t_idx, t_blk, t_nnz, valid, out, scratch, M, N, K, C, jmax_t, \
                   n_slots, br, bc, n_split, x_vec, y_vec, st
  switch (bsr::n_tiles(min(br, 32))) {
    case 1: return launch_t<1, TY, TX>(SDDMM_ARGS);
    case 2: return launch_t<2, TY, TX>(SDDMM_ARGS);
    case 4: return launch_t<4, TY, TX>(SDDMM_ARGS);
  }
#undef SDDMM_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out (n_slots, br, bc) f32 = per-slot dY' X; dy (M, N) and x (M, K) f32 or
// bf16; t_idx / t_blk (C, jmax_t) and t_nnz (C,) the block-CSC tables,
// valid (n_slots,) int32; any block (br past 32 in groups of 32 columns of
// dY, bc in chunks of 128 columns of X). With n_split > 1,
// scratch holds n_split * n_slots * br * bc floats of partial sums.
// x_vec / y_vec: the rows of x / dy are 16-byte aligned (see bsr_tile.cuh).
int bsr_sddmm(const void* dy, int dy_is_bf16, const void* x, int x_is_bf16,
              const int* t_idx, const int* t_blk, const int* t_nnz, const int* valid,
              float* out, float* scratch, int M, int N, int K, int C, int jmax_t,
              int n_slots, int br, int bc, int n_split, int x_vec, int y_vec,
              void* stream) {
  if (br < 1 || bc < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_split < 1 || (n_split > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SDDMM_ARGS dy, x, t_idx, t_blk, t_nnz, valid, out, scratch, M, N, K, C, jmax_t, \
                   n_slots, br, bc, n_split, x_vec, y_vec, st
  if (dy_is_bf16)
    return x_is_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(SDDMM_ARGS)
                     : launch<__nv_bfloat16, float>(SDDMM_ARGS);
  return x_is_bf16 ? launch<float, __nv_bfloat16>(SDDMM_ARGS)
                   : launch<float, float>(SDDMM_ARGS);
#undef SDDMM_ARGS
}

}  // extern "C"
