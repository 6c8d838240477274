// Causal and windowed GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention/flash_attention.py::flash_attention_fwd
// (called through repro/kernels/flash_attention/ops.py::flash_attention).
// For q (BH, S, hd) and k, v (BKV, S, hd), with q head h reading kv head
// h / g (g = BH / BKV, the GQA group), it computes
//   o[h, i] = softmax_j(q[h, i] . k[h / g, j] * hd^-0.5  masked) @ v[h / g]
// where key j is masked unless j <= i (causal) and i - j < window (a
// window); the output has q's dtype.
//
// Semantics, to the letter of the reference:
//   * the sentinel is -1e30, not -inf, in the mask and in the initial m.
//     A row whose first running kv tile is fully masked (the top rows of a
//     tile once the window bites) adds exp(0) = 1 terms; the first real
//     score wipes them through corr = exp(m_prev - m_new) = exp(-1e30 - m)
//     = 0. Every row has at least its own key, so the output is the masked
//     softmax whatever the tiling. l is clamped at 1e-30 before the divide;
//   * q, k and v (f32, bf16 or f16) are widened to f32, the scale
//     multiplies the f32 dot product, and every sum is f32;
//   * kv tiles wholly above the diagonal (causal) or wholly below the
//     window are skipped: their keys are masked for every row of the tile,
//     so skipping them leaves the output as it is.
//
// Bound on an H100 SXM (3.35 TB/s HBM; 989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s f32 without them): q, k, v and o are moved once, and
// the products are 4 * hd flops per unmasked (query, key) pair. At
// S = 2048-4096 the flops are the larger term by 5-50x.
//
// Design against that bound, simple first: the TPU grid (head, q tile,
// kv tile) with the kv axis sequential becomes one thread block per (q
// tile of kBQ = 64 rows, q head) that loops over kv tiles of kBK = 32 keys
// and carries m, l and acc in registers (nothing carries between blocks).
// The q tile is staged once in shared memory as f32; each kv tile's K (row
// stride hd + 1, so that one lane per key reads without bank conflicts) and
// V are staged as f32 in coalesced rows. Each of the 8 warps owns 8 query
// rows and takes them 4 at a time: a lane computes the scores of one key
// for the 4 rows (q broadcast from shared memory), the warp reduces max and
// sum by shuffles, and each lane owns hd / 32 columns of each row's
// accumulator. The products run on the f32 FMA pipes; no tensor cores,
// TMA or pipelining of the kv tiles yet. At hd = 256 the staged tiles take
// 132 KB of shared memory, above the 48 KB default, so the launch raises
// the kernel's dynamic shared memory limit first.
//
// Built with nvcc into a shared library with a plain C interface; the entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                            // query rows per block
constexpr int kBK = 32;                            // keys per kv tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;         // 8
constexpr int kGroup = 4;                          // rows scored together
constexpr float kNegInf = -1e30f;                  // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)kBQ * hd + (size_t)kBK * (hd + 1) +
                          (size_t)kBK * hd + (size_t)kWarps * kGroup * kBK);
}

// HPL: head-dim columns per lane (hd <= 32 * HPL).
template <typename T, int HPL>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q,              // (BH, S, hd)
    const T* __restrict__ k,              // (BKV, S, hd)
    const T* __restrict__ v,
    T* __restrict__ o,                    // (BH, S, hd)
    int s_len, int hd, int group, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int kstride = hd + 1;
  float* q_s = smem;                      // kBQ x hd
  float* k_s = q_s + kBQ * hd;            // kBK x (hd + 1)
  float* v_s = k_s + kBK * kstride;       // kBK x hd
  float* p_s = v_s + kBK * hd;            // kWarps x kGroup x kBK

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qoff = (size_t)head * s_len * hd;
  const size_t kvoff = (size_t)(head / group) * s_len * hd;
  const int q_rows = min(kBQ, s_len - q0);

  for (int i = threadIdx.x; i < kBQ * hd; i += kThreads) {
    q_s[i] = i / hd < q_rows ? to_f32(q[qoff + (size_t)q0 * hd + i]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][HPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < HPL; ++j) acc[r][j] = 0.f;
  }
  const int row0 = warp * kRowsPerWarp;   // this warp's first row in the tile
  float* pw = p_s + warp * kGroup * kBK;

  // kv tiles that hold a key some row of the tile may see
  const int q_last = q0 + q_rows - 1;
  const int key_hi = causal ? q_last : s_len - 1;
  const int key_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t0 = (key_lo / kBK) * kBK; t0 <= key_hi; t0 += kBK) {
    __syncthreads();                      // the last tile is consumed
    for (int i = threadIdx.x; i < kBK * hd; i += kThreads) {
      const int t = i / hd, d = i - t * hd;
      const bool in = t0 + t < s_len;
      const size_t src = kvoff + (size_t)t0 * hd + i;
      k_s[t * kstride + d] = in ? to_f32(k[src]) : 0.f;
      v_s[i] = in ? to_f32(v[src]) : 0.f;
    }
    __syncthreads();

    const int kpos = t0 + lane;
    const float* kr = k_s + lane * kstride;
#pragma unroll
    for (int g0 = 0; g0 < kRowsPerWarp; g0 += kGroup) {
      float s[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) s[i] = 0.f;
      const float* qr = q_s + (row0 + g0) * hd;
      for (int d = 0; d < hd; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) s[i] = fmaf(qr[i * hd + d], kd, s[i]);
      }
      float corr[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int qpos = q0 + row0 + g0 + i;
        bool ok = kpos < s_len;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        const float si = ok ? s[i] * scale : kNegInf;
        const float m_new = fmaxf(m[g0 + i], warp_max(si));
        const float p = expf(si - m_new);
        pw[i * kBK + lane] = p;
        corr[i] = expf(m[g0 + i] - m_new);
        l[g0 + i] = corr[i] * l[g0 + i] + warp_sum(p);
        m[g0 + i] = m_new;
      }
      __syncwarp();                       // pw complete for every lane
#pragma unroll
      for (int j = 0; j < HPL; ++j) {
        const int d = lane + 32 * j;
        float a[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) a[i] = 0.f;
        if (d < hd) {
          for (int t = 0; t < kBK; ++t) {
            const float vd = v_s[t * hd + d];
#pragma unroll
            for (int i = 0; i < kGroup; ++i) a[i] = fmaf(pw[i * kBK + t], vd, a[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          acc[g0 + i][j] = corr[i] * acc[g0 + i][j] + a[i];
      }
      __syncwarp();                       // before the next group rewrites pw
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= q_rows) continue;
    const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = o + qoff + (size_t)(q0 + row) * hd;
#pragma unroll
    for (int j = 0; j < HPL; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) orow[d] = from_f32<T>(acc[r][j] * inv_l);
    }
  }
}

template <typename T, int HPL>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s_len, int hd, int group, int causal, int window, float scale,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HPL>;
  const size_t smem = smem_bytes(hd);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((s_len + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len, hd, group, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int bh,
                int s_len, int hd, int group, int causal, int window,
                float scale, cudaStream_t stream) {
#define FLASH_ARGS q, k, v, o, bh, s_len, hd, group, causal, window, scale, stream
  if (hd <= 32) return launch<T, 1>(FLASH_ARGS);
  if (hd <= 64) return launch<T, 2>(FLASH_ARGS);
  if (hd <= 128) return launch<T, 4>(FLASH_ARGS);
  if (hd <= 256) return launch<T, 8>(FLASH_ARGS);
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel takes at head_dim ``hd``.
size_t flash_attention_fwd_smem_bytes(int hd) { return smem_bytes(hd); }

// dtype: 0 = f32, 1 = bf16, 2 = f16 (q, k, v and o share it). causal: 0/1.
// window <= 0 means no window.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int bh, int s_len, int hd, int group,
                        int causal, int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_hd<float>(q, k, v, o, bh, s_len, hd, group, causal,
                                window, scale, s);
    case 1:
      return dispatch_hd<__nv_bfloat16>(q, k, v, o, bh, s_len, hd, group,
                                        causal, window, scale, s);
    case 2:
      return dispatch_hd<__half>(q, k, v, o, bh, s_len, hd, group, causal,
                                 window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
