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
// Bound on an H100 SXM: at M = 512 each slot reads M * (br + bc) inputs and
// does M * br * bc FMAs (2 flops each); over a layer's resident blocks the
// f32 FMAs (67 TFLOP/s without tensor cores) and the bytes of the slabs
// (each dY and X slab read once per slot that uses it) are of the same
// order, so the bound is whichever this run's shapes make larger.
//
// Design against that bound: one thread block (256 threads) per slot; the
// TPU's sequential M grid axis becomes a loop over M in chunks of 32 rows.
// Each chunk stages the dY (32 x br) and X (32 x bc) slabs in shared memory
// (reads past M, N or K give zero: X is not padded to the block grid), and
// each thread owns br * bc / 256 outputs in registers. Each output is
// summed by one thread in a fixed order: no atomics, so two runs give
// bit-equal gradients. No tensor cores yet.
//
// Built with nvcc into a shared library with a plain C interface; the
// entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPer = 16;          // outputs per thread: br * bc <= 4096
constexpr int kChunk = 32;           // rows of M per staged slab

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TY, typename TX>
__global__ void __launch_bounds__(kThreads)
sddmm_block_grad_kernel(const TY* __restrict__ dy, const TX* __restrict__ x,
                        const int* __restrict__ rows, const int* __restrict__ cols,
                        const int* __restrict__ valid, float* __restrict__ out,
                        int M, int N, int K, int br, int bc) {
  extern __shared__ float smem[];
  float* sdy = smem;                   // [kChunk][br]
  float* sx = smem + kChunk * br;      // [kChunk][bc]
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_out = br * bc;
  float* o = out + (size_t)s * n_out;
  if (!valid[s]) {                     // block-uniform: no barrier skipped
    for (int e = tid; e < n_out; e += kThreads) o[e] = 0.0f;
    return;
  }
  const int r0 = rows[s] * br, c0 = cols[s] * bc;
  int rr[kMaxPer], kk[kMaxPer];
  float acc[kMaxPer];
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int e = tid + i * kThreads;
    rr[i] = e < n_out ? e / bc : 0;
    kk[i] = e < n_out ? e % bc : 0;
    acc[i] = 0.0f;
  }
  for (int m0 = 0; m0 < M; m0 += kChunk) {
    __syncthreads();                   // the previous slabs are consumed
    for (int e = tid; e < kChunk * br; e += kThreads) {
      const int m = m0 + e / br, n = r0 + e % br;
      sdy[e] = (m < M && n < N) ? to_f32(dy[(size_t)m * N + n]) : 0.0f;
    }
    for (int e = tid; e < kChunk * bc; e += kThreads) {
      const int m = m0 + e / bc, k = c0 + e % bc;
      sx[e] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      if (tid + i * kThreads < n_out) {
        float a = acc[i];
        for (int mm = 0; mm < kChunk; ++mm)
          a += sdy[mm * br + rr[i]] * sx[mm * bc + kk[i]];
        acc[i] = a;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int e = tid + i * kThreads;
    if (e < n_out) o[e] = acc[i];
  }
}

template <typename TY, typename TX>
int launch(const void* dy, const void* x, const int* rows, const int* cols,
           const int* valid, float* out, int M, int N, int K, int n_slots, int br,
           int bc, cudaStream_t st) {
  const size_t smem = (size_t)kChunk * (br + bc) * sizeof(float);
  sddmm_block_grad_kernel<TY, TX><<<n_slots, kThreads, smem, st>>>(
      static_cast<const TY*>(dy), static_cast<const TX*>(x), rows, cols, valid, out,
      M, N, K, br, bc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (n_slots, br, bc) f32 = per-slot dY' X; dy (M, N) and x (M, K) f32 or
// bf16, rows/cols/valid (n_slots,) int32. br * bc <= 4096 and
// 32 * (br + bc) * 4 bytes of shared memory <= 48 KB.
int bsr_sddmm(const void* dy, int dy_is_bf16, const void* x, int x_is_bf16,
              const int* rows, const int* cols, const int* valid, float* out, int M,
              int N, int K, int n_slots, int br, int bc, void* stream) {
  if (br * bc > kMaxPer * kThreads || (size_t)kChunk * (br + bc) * 4 > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dy_is_bf16) {
    return x_is_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(dy, x, rows, cols, valid, out, M, N, K, n_slots, br, bc, st)
        : launch<__nv_bfloat16, float>(dy, x, rows, cols, valid, out, M, N, K, n_slots, br, bc, st);
  }
  return x_is_bf16
      ? launch<float, __nv_bfloat16>(dy, x, rows, cols, valid, out, M, N, K, n_slots, br, bc, st)
      : launch<float, float>(dy, x, rows, cols, valid, out, M, N, K, n_slots, br, bc, st);
}

}  // extern "C"
