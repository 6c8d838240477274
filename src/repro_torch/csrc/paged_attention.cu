// Paged flash-decode attention over a block-paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/paged_attention/paged_attention.py::paged_flash_fwd
// (the continuous-batching engine's mixed prefill/decode attention). For
// every (slot b, kv head, split s) it walks the split's logical pages
// through the page table and runs the online softmax of the C*g query rows
// that share the kv head (GQA group g, tick width C) against each page's
// keys, emitting UNNORMALIZED partials
//   acc (B, KV, S, C, g, hd), m and l (B, KV, S, C, g), all f32;
// the wrapper (kernels/paged_attention/ops.py) runs the exact cross-split
// combine. The gathered (B, P*ps, KV, hd) context is never formed.
//
// Semantics, to the letter of the reference:
//   * the sentinel is -1e30, not -inf, in the mask and in the initial m; a
//     row whose first running page is fully masked adds exp(0) = 1 terms
//     that the first real score wipes out through corr = exp(m_prev - m_new)
//     = 0, and an empty split emits m = -1e30, l = 0, acc = 0;
//   * a page runs when page*ps <= start + C - 1 and, with a window,
//     page*ps + ps - 1 >= start - window + 1, where start is the tick's
//     first position (row 0); the per-row mask q_pos >= k_pos (and
//     q_pos - k_pos < window) does the rest. Pages per split: ceil(P / S);
//   * q arrives as f32, K and V (f32, bf16 or f16) are widened to f32, the
//     scale hd^-0.5 multiplies the f32 dot product, and every sum is f32.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 without tensor
// cores): at decode (C = 1) each K/V page is used by g = 3 rows only, so the
// kernel is bound by the bytes of the pages that run; at a prefill chunk
// (C = 32) the f32 FMAs (4 * C*g * ps * hd per page) are the larger term.
//
// Design against that bound, simple first: the TPU's sequential page axis
// becomes a loop inside one thread block per (slot, kv head, split), which
// carries m, l and acc in registers across pages (nothing carries between
// blocks). The block reads its own page-table row. For each page that runs
// it stages the page's K (row stride hd + 1, so that one lane per key reads
// without bank conflicts) and V in shared memory as f32, in coalesced rows
// of hd values. The C*g rows are dealt over 4 warps, 4 rows per warp at a
// time; a lane computes the score of one key (q broadcast from shared
// memory), the warp reduces max and sum by shuffles, and each lane owns
// hd / 32 columns of the row's accumulator. Decode leaves most of the card
// idle (B * KV * S blocks); kv_splits adds blocks. No tensor cores, TMA or
// multi-stage pipelining yet.
//
// Built with nvcc into a shared library with a plain C interface; the entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;   // query rows per pass
constexpr float kNegInf = -1e30f;                  // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

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

size_t smem_bytes(int ps, int hd) {
  return sizeof(float) * ((size_t)ps * (hd + 1) + (size_t)ps * hd +
                          (size_t)kTileRows * hd + (size_t)kWarps * ps);
}

// HPL: head-dim columns per lane (hd <= 32 * HPL).
template <typename T, int HPL>
__global__ void __launch_bounds__(kThreads) paged_flash_fwd_kernel(
    const float* __restrict__ q,            // (B, KV, C*g, hd)
    const T* __restrict__ k_pool,           // (n_pages, ps, KV, hd)
    const T* __restrict__ v_pool,
    const int* __restrict__ table,          // (B, P)
    const int* __restrict__ positions,      // (B, C)
    float* __restrict__ acc_out,            // (B, KV, S, C*g, hd)
    float* __restrict__ m_out,              // (B, KV, S, C*g)
    float* __restrict__ l_out,
    int kv, int c, int g, int hd, int ps, int n_logical, int n_splits,
    int pages_per_split, int window, float scale) {
  extern __shared__ float smem[];
  const int kstride = hd + 1;
  float* k_s = smem;                        // ps x (hd + 1)
  float* v_s = k_s + ps * kstride;          // ps x hd
  float* q_s = v_s + ps * hd;               // kTileRows x hd
  float* p_s = q_s + kTileRows * hd;        // kWarps x ps

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = c * g;
  const int start = positions[(size_t)b * c];
  const int* trow = table + (size_t)b * n_logical;
  const size_t bk = (size_t)b * kv + kvh;
  const float* qb = q + bk * rows * hd;
  const size_t out_row0 = (bk * n_splits + split) * rows;
  float* pw = p_s + warp * ps;
  const int page_lo = split * pages_per_split;
  const int page_hi = min(page_lo + pages_per_split, n_logical);

  for (int tile = 0; tile < rows; tile += kTileRows) {
    float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][HPL];
    int qpos[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = tile + i * kWarps + warp;
      m[i] = kNegInf;
      l[i] = 0.f;
      qpos[i] = r < rows ? positions[(size_t)b * c + r / g] : 0;
#pragma unroll
      for (int j = 0; j < HPL; ++j) acc[i][j] = 0.f;
    }
    __syncthreads();                        // the last tile is done with q_s
    for (int i = threadIdx.x; i < kTileRows * hd; i += kThreads) {
      q_s[i] = tile + i / hd < rows ? qb[(size_t)tile * hd + i] : 0.f;
    }

    for (int page = page_lo; page < page_hi; ++page) {
      const int base = page * ps;
      bool run = base <= start + c - 1;                      // causal frontier
      if (window > 0) run = run && base + ps - 1 >= start - window + 1;
      if (!run) continue;                   // the same for the whole block
      const size_t phys = (size_t)trow[page];
      __syncthreads();                      // the last page is consumed
      for (int i = threadIdx.x; i < ps * hd; i += kThreads) {
        const int t = i / hd, d = i - t * hd;
        const size_t src = ((phys * ps + t) * kv + kvh) * hd + d;
        k_s[t * kstride + d] = to_f32(k_pool[src]);
        v_s[i] = to_f32(v_pool[src]);
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = tile + i * kWarps + warp;
        if (r >= rows) continue;            // the same for the whole warp
        const float* qr = q_s + (i * kWarps + warp) * hd;
        float mx = kNegInf;
        for (int t = lane; t < ps; t += 32) {
          const float* kr = k_s + t * kstride;
          float s = 0.f;
          for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
          s *= scale;
          const int kpos = base + t;
          bool ok = qpos[i] >= kpos;
          if (window > 0) ok = ok && qpos[i] - kpos < window;
          s = ok ? s : kNegInf;
          pw[t] = s;
          mx = fmaxf(mx, s);
        }
        const float m_new = fmaxf(m[i], warp_max(mx));
        float psum = 0.f;
        for (int t = lane; t < ps; t += 32) {
          const float p = expf(pw[t] - m_new);
          pw[t] = p;
          psum += p;
        }
        const float corr = expf(m[i] - m_new);
        l[i] = corr * l[i] + warp_sum(psum);
        __syncwarp();                       // pw complete for every lane
#pragma unroll
        for (int j = 0; j < HPL; ++j) {
          const int d = lane + 32 * j;
          float a = 0.f;
          if (d < hd) {
            for (int t = 0; t < ps; ++t) a = fmaf(pw[t], v_s[t * hd + d], a);
          }
          acc[i][j] = corr * acc[i][j] + a;
        }
        m[i] = m_new;
        __syncwarp();                       // before the next row rewrites pw
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = tile + i * kWarps + warp;
      if (r >= rows) continue;
      const size_t o = out_row0 + r;
      if (lane == 0) {
        m_out[o] = m[i];
        l_out[o] = l[i];
      }
#pragma unroll
      for (int j = 0; j < HPL; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) acc_out[o * hd + d] = acc[i][j];
      }
    }
  }
}

template <typename T, int HPL>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* positions, void* acc, void* m,
           void* l, int b, int kv, int c, int g, int hd, int ps,
           int n_logical, int n_splits, int window, float scale,
           cudaStream_t stream) {
  auto kernel = paged_flash_fwd_kernel<T, HPL>;
  const size_t smem = smem_bytes(ps, hd);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int pages_per_split = (n_logical + n_splits - 1) / n_splits;
  dim3 grid(n_splits, kv, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(positions), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), kv, c, g, hd, ps,
      n_logical, n_splits, pages_per_split, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k_pool, const void* v_pool,
                const void* table, const void* positions, void* acc, void* m,
                void* l, int b, int kv, int c, int g, int hd, int ps,
                int n_logical, int n_splits, int window, float scale,
                cudaStream_t stream) {
#define PAGED_ARGS q, k_pool, v_pool, table, positions, acc, m, l, b, kv, c, g, \
                   hd, ps, n_logical, n_splits, window, scale, stream
  if (hd <= 32) return launch<T, 1>(PAGED_ARGS);
  if (hd <= 64) return launch<T, 2>(PAGED_ARGS);
  if (hd <= 128) return launch<T, 4>(PAGED_ARGS);
  if (hd <= 256) return launch<T, 8>(PAGED_ARGS);
#undef PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Smallest dynamic shared memory the kernel takes for (page_size, head_dim).
size_t paged_flash_fwd_smem_bytes(int ps, int hd) { return smem_bytes(ps, hd); }

// pool_dtype: 0 = f32, 1 = bf16, 2 = f16. window <= 0 means no window.
int paged_flash_fwd(const void* q, const void* k_pool, const void* v_pool,
                    int pool_dtype, const void* table, const void* positions,
                    void* acc, void* m, void* l, int b, int kv, int c, int g,
                    int hd, int ps, int n_logical, int n_splits, int window,
                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pool_dtype) {
    case 0:
      return dispatch_hd<float>(q, k_pool, v_pool, table, positions, acc, m, l,
                                b, kv, c, g, hd, ps, n_logical, n_splits,
                                window, scale, s);
    case 1:
      return dispatch_hd<__nv_bfloat16>(q, k_pool, v_pool, table, positions,
                                        acc, m, l, b, kv, c, g, hd, ps,
                                        n_logical, n_splits, window, scale, s);
    case 2:
      return dispatch_hd<__half>(q, k_pool, v_pool, table, positions, acc, m,
                                 l, b, kv, c, g, hd, ps, n_logical, n_splits,
                                 window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
