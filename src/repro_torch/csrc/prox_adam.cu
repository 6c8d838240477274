// Fused Prox-ADAM / Prox-RMSProp update on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/prox_adam/prox_adam.py::fused_prox_update
// (as called by repro/kernels/prox_adam/ops.py::fused_update_leaf).
//
// Per element, in f32:
//   adam:    m' = b1 m + (1-b1) g;  v' = b2 v + ((1-b2) g) g;
//            d = (m' * (1/bc1)) / (sqrt(v' * (1/bc2)) + eps)
//   rmsprop: m' = m;  v' = b2 v + ((1-b2) g) g;  d = g / (sqrt(v') + eps)
//   z = w - lr d;  with the prox, z = min(max(z - tau, 0), z + tau),
//   tau = lr * lam (the paper's Fig. 4 min/max soft threshold).
// w (f32 or bf16), m and v are updated in place; g is f32.
//
// Every operation is an explicit round-to-nearest intrinsic, in the order
// of the plain version (kernels/prox_adam/ref.py), so nvcc contracts no
// multiply-add into an FMA and the two round alike: the results are
// bit-equal, also after a bf16 w's final rounding.
//
// Bound on an H100 SXM: bytes. Each element reads w, g, m, v and writes w,
// m, v: 28 bytes for an f32 w (24 for bf16), against about 10 flops, so
// the kernel can at best stream at the 3.35 TB/s of HBM.
//
// Design against that bound: one elementwise pass over the flat leaf (the
// TPU's (rows, 128) tiling is not needed), 16-byte vector loads and stores
// of 4 elements per thread where the pointers allow it, a grid-stride
// loop, and the scalars passed by value so no step copies them to the
// device. The rule and the prox are template parameters. Deterministic: no
// atomics, no reductions.
//
// Built with nvcc into a shared library with a plain C interface; the
// entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Scalars {
  float lr, lam, b1, b2, eps, bc1, bc2;
};

template <int RULE, bool PROX>
__device__ __forceinline__ float step(float w, float g, float& m, float& v,
                                      const Scalars& s) {
  const float c2 = __fsub_rn(1.0f, s.b2);
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(c2, g), g));
  float d;
  if (RULE == 0) {
    const float c1 = __fsub_rn(1.0f, s.b1);
    m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(c1, g));
    const float r1 = __fdiv_rn(1.0f, s.bc1), r2 = __fdiv_rn(1.0f, s.bc2);
    d = __fdiv_rn(__fmul_rn(m, r1),
                  __fadd_rn(__fsqrt_rn(__fmul_rn(v, r2)), s.eps));
  } else {
    d = __fdiv_rn(g, __fadd_rn(__fsqrt_rn(v), s.eps));
  }
  float z = __fsub_rn(w, __fmul_rn(s.lr, d));
  if (PROX) {
    const float tau = __fmul_rn(s.lr, s.lam);
    z = fminf(fmaxf(__fsub_rn(z, tau), 0.0f), __fadd_rn(z, tau));
  }
  return z;
}

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float x) { p[i] = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16(x);
}

// 4 consecutive w values as one vector load / store.
__device__ __forceinline__ void ld4(const float* p, int64_t i, float* o) {
  const float4 q = *reinterpret_cast<const float4*>(p + i);
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, int64_t i, float* o) {
  const uint2 q = *reinterpret_cast<const uint2*>(p + i);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  o[0] = __low2float(a); o[1] = __high2float(a);
  o[2] = __low2float(b); o[3] = __high2float(b);
}
__device__ __forceinline__ void st4(float* p, int64_t i, const float* o) {
  *reinterpret_cast<float4*>(p + i) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, int64_t i, const float* o) {
  __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&a);
  q.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p + i) = q;
}

// VEC: every pointer is 16-byte aligned (8 for a bf16 w) and n4 = n / 4
// vectors go through the vector path; the tail (and the whole leaf when
// !VEC) goes element by element.
template <typename T, int RULE, bool PROX, bool VEC>
__global__ void __launch_bounds__(256)
prox_adam_kernel(T* __restrict__ w, const float* __restrict__ g,
                 float* __restrict__ m, float* __restrict__ v, int64_t n,
                 Scalars s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t tail = 0;
  if (VEC) {
    const int64_t n4 = n / 4;
    for (int64_t q = i0; q < n4; q += stride) {
      const int64_t i = q * 4;
      float wv[4], gv[4], mv[4], vv[4];
      ld4(w, i, wv);
      ld4(g, i, gv);
      ld4(m, i, mv);
      ld4(v, i, vv);
#pragma unroll
      for (int k = 0; k < 4; ++k) wv[k] = step<RULE, PROX>(wv[k], gv[k], mv[k], vv[k], s);
      st4(w, i, wv);
      if (RULE == 0) st4(m, i, mv);
      st4(v, i, vv);
    }
    tail = n4 * 4;
  }
  for (int64_t i = tail + i0; i < n; i += stride) {
    float mv = m[i], vv = v[i];
    const float z = step<RULE, PROX>(ld(w, i), g[i], mv, vv, s);
    st(w, i, z);
    if (RULE == 0) m[i] = mv;
    v[i] = vv;
  }
}

template <typename T, int RULE, bool PROX>
void launch(T* w, const float* g, float* m, float* v, int64_t n, Scalars s,
            cudaStream_t st) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(w) % (4 * sizeof(T)) |
                      reinterpret_cast<uintptr_t>(g) % 16 |
                      reinterpret_cast<uintptr_t>(m) % 16 |
                      reinterpret_cast<uintptr_t>(v) % 16;
  const int threads = 256;
  int64_t blocks = (n / 4 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond 16 waves
  if (a == 0) {
    prox_adam_kernel<T, RULE, PROX, true><<<(int)blocks, threads, 0, st>>>(w, g, m, v, n, s);
  } else {
    prox_adam_kernel<T, RULE, PROX, false><<<(int)blocks, threads, 0, st>>>(w, g, m, v, n, s);
  }
}

template <typename T>
void dispatch(T* w, const float* g, float* m, float* v, int64_t n, int rule,
              int prox, Scalars s, cudaStream_t st) {
  if (rule == 0) {
    if (prox) launch<T, 0, true>(w, g, m, v, n, s, st);
    else launch<T, 0, false>(w, g, m, v, n, s, st);
  } else {
    if (prox) launch<T, 1, true>(w, g, m, v, n, s, st);
    else launch<T, 1, false>(w, g, m, v, n, s, st);
  }
}

}  // namespace

extern "C" {

// In-place update of n elements: w (f32, or bf16 when w_is_bf16), g f32,
// m f32, v f32. rule 0 = adam, 1 = rmsprop; prox 1 applies the soft
// threshold. Scalars as in fused_prox_update: lr, lam, b1, b2, eps,
// bc1 = 1 - b1^t, bc2 = 1 - b2^t.
int prox_adam_update(void* w, int w_is_bf16, const float* g, float* m, float* v,
                     long long n, int rule, int prox, float lr, float lam,
                     float b1, float b2, float eps, float bc1, float bc2,
                     void* stream) {
  if (rule != 0 && rule != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Scalars s{lr, lam, b1, b2, eps, bc1, bc2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    dispatch(static_cast<__nv_bfloat16*>(w), g, m, v, n, rule, prox, s, st);
  } else {
    dispatch(static_cast<float*>(w), g, m, v, n, rule, prox, s, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
