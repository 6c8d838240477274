// Fused Prox-ADAM / Prox-RMSProp update on Hopper (sm_90a): one launch per
// optimizer step over all of a tree's leaves.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/prox_adam/prox_adam.py::fused_prox_update
// which repro/kernels/prox_adam/ops.py::fused_tree_update calls once a
// leaf, inside one jitted step. The port runs eagerly, so one launch a leaf
// would pay a launch and a host wrapper call for each of them; here one
// launch takes up to MAX_LEAVES leaves.
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
// m, v: 28 bytes for an f32 w (24 for bf16), against about 10 flops, so a
// step's update can at best stream the sum of its leaves' bytes at the
// 3.35 TB/s of HBM. A CNN's leaves are small (LeNet-5's six hold 431k
// elements, 12 MB: 3.6 us at that rate), so a launch a leaf, each with its
// fixed cost (about 3 us for a small launch, timed back to back), cannot
// approach it; one launch a step pays that cost once.
//
// Design against that bound:
// - The table of leaves travels by value in the kernel's parameters (a
//   __grid_constant__ struct, read in place): each leaf's four pointers,
//   length, and first thread block with its flags (bf16 w, prox, vector
//   path) in the top bits, for up to MAX_LEAVES = 100 leaves in 4,032
//   bytes, under the 4 KB of classic parameter space (the largest tree the
//   port trains, recurrentgemma-9b's debias tree at full depth, has 98).
//   No device allocation, copy or sync a step.
// - Each thread block takes one contiguous chunk of CHUNK elements of one
//   leaf, found by a binary search over the table's block prefix (uniform
//   in the block: no divergence).
// - Each thread loads VECS float4 of each of w, g, m and v before any
//   arithmetic. VECS = 1: on an H100 more vectors a thread (2 or 4; 256 B
//   in flight) lost at every size measured, by up to 1.3x at LeNet-5's
//   fc1 (fewer, longer blocks: 196 at 4 vectors) and 2x at a one-block
//   leaf (the serial divides and square roots of a thread), and did not
//   win at 8.4 M elements (tools/prox_adam_rows.py).
// - A leaf whose pointers are not all 16-byte aligned (8 for a bf16 w)
//   goes element by element, with the same loads-first order; the last
//   partial chunk of a leaf checks bounds, the others do not.
// The rule is a template parameter; prox and dtype are flags of the leaf.
// Deterministic: no atomics, no reductions, every output written once.
//
// Built with nvcc into a shared library with a plain C interface; the
// entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 100;              // rows of a launch's table
constexpr int THREADS = 128;
constexpr int VECS = 1;                      // float4 of each array a thread
constexpr int CHUNK = THREADS * VECS * 4;    // elements a thread block
constexpr int ELEMS = CHUNK / THREADS;       // elements a thread

// a leaf's flags, kept in the top bits of its first block
constexpr int BF16_W = 1, PROX = 2, VEC = 4;
constexpr int FLAG_SHIFT = 28;
constexpr int FIRST_MASK = (1 << FLAG_SHIFT) - 1;

struct Scalars {
  float lr, lam, b1, b2, eps, bc1, bc2;
};

// A launch's table, by value in the kernel's parameters: n_leaves rows
// are used.
struct Table {
  void* w[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  int n[MAX_LEAVES];      // elements of leaf i (< 2^31)
  int first[MAX_LEAVES];  // leaf i's first thread block | flags << FLAG_SHIFT
  int n_leaves;
  Scalars s;
};
static_assert(sizeof(Table) <= 4096,
              "the table must fit 4 KB of parameters");

struct Leaf {
  void* w;
  const float* g;
  float* m;
  float* v;
  int64_t n;
};

template <int RULE, bool PROX_ON>
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
  if (PROX_ON) {
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

// 4 consecutive values as one vector load / store.
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

// One chunk [base, base + CHUNK) of an aligned leaf: vector j of a thread
// starts at element base + 4 (j THREADS + tid), so each of the VECS loads
// of an array is one coalesced 2 KB (f32) row of the block. GUARD: the
// leaf's last chunk, where vectors past n are skipped and the one that n
// cuts goes element by element.
template <typename T, int RULE, bool PROX_ON, bool GUARD>
__device__ __forceinline__ void vec_chunk(T* __restrict__ w,
                                          const float* __restrict__ g,
                                          float* __restrict__ m,
                                          float* __restrict__ v, int64_t n,
                                          int64_t base, const Scalars& s) {
  float wv[VECS][4], gv[VECS][4], mv[VECS][4], vv[VECS][4];
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const int64_t i = base + 4 * ((int64_t)j * THREADS + threadIdx.x);
    if (!GUARD || i + 4 <= n) {
      ld4(w, i, wv[j]);
      ld4(g, i, gv[j]);
      ld4(m, i, mv[j]);
      ld4(v, i, vv[j]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = i + k < n;
        wv[j][k] = in ? ld(w, i + k) : 0.0f;
        gv[j][k] = in ? g[i + k] : 0.0f;
        mv[j][k] = in ? m[i + k] : 0.0f;
        vv[j][k] = in ? v[i + k] : 0.0f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wv[j][k] = step<RULE, PROX_ON>(wv[j][k], gv[j][k], mv[j][k], vv[j][k], s);
  }
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const int64_t i = base + 4 * ((int64_t)j * THREADS + threadIdx.x);
    if (!GUARD || i + 4 <= n) {
      st4(w, i, wv[j]);
      if (RULE == 0) st4(m, i, mv[j]);
      st4(v, i, vv[j]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i + k < n) {
          st(w, i + k, wv[j][k]);
          if (RULE == 0) m[i + k] = mv[j][k];
          v[i + k] = vv[j][k];
        }
      }
    }
  }
}

// One chunk of a leaf that the vector path cannot take: element base + j
// THREADS + tid for j < ELEMS, all loads first.
template <typename T, int RULE, bool PROX_ON>
__device__ __forceinline__ void scalar_chunk(T* __restrict__ w,
                                             const float* __restrict__ g,
                                             float* __restrict__ m,
                                             float* __restrict__ v, int64_t n,
                                             int64_t base, const Scalars& s) {
  float wv[ELEMS], gv[ELEMS], mv[ELEMS], vv[ELEMS];
#pragma unroll
  for (int j = 0; j < ELEMS; ++j) {
    const int64_t i = base + (int64_t)j * THREADS + threadIdx.x;
    const bool in = i < n;
    wv[j] = in ? ld(w, i) : 0.0f;
    gv[j] = in ? g[i] : 0.0f;
    mv[j] = in ? m[i] : 0.0f;
    vv[j] = in ? v[i] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < ELEMS; ++j)
    wv[j] = step<RULE, PROX_ON>(wv[j], gv[j], mv[j], vv[j], s);
#pragma unroll
  for (int j = 0; j < ELEMS; ++j) {
    const int64_t i = base + (int64_t)j * THREADS + threadIdx.x;
    if (i < n) {
      st(w, i, wv[j]);
      if (RULE == 0) m[i] = mv[j];
      v[i] = vv[j];
    }
  }
}

template <typename T, int RULE, bool PROX_ON>
__device__ __forceinline__ void chunk(const Leaf& leaf, int flags,
                                      int64_t base, const Scalars& s) {
  T* w = static_cast<T*>(leaf.w);
  const int64_t n = leaf.n;
  if (!(flags & VEC)) {
    scalar_chunk<T, RULE, PROX_ON>(w, leaf.g, leaf.m, leaf.v, n, base, s);
  } else if (base + CHUNK <= n) {
    vec_chunk<T, RULE, PROX_ON, false>(w, leaf.g, leaf.m, leaf.v, n, base, s);
  } else {
    vec_chunk<T, RULE, PROX_ON, true>(w, leaf.g, leaf.m, leaf.v, n, base, s);
  }
}

template <int RULE>
__global__ void __launch_bounds__(THREADS)
prox_adam_tree_kernel(const __grid_constant__ Table t) {
  // the leaf that owns this block: the last i with first[i] <= blockIdx.x
  const int b = blockIdx.x;
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if ((t.first[mid] & FIRST_MASK) <= b) lo = mid;
    else hi = mid - 1;
  }
  const Leaf leaf{t.w[lo], t.g[lo], t.m[lo], t.v[lo], t.n[lo]};
  const int flags = t.first[lo] >> FLAG_SHIFT;
  const int64_t base = (int64_t)(b - (t.first[lo] & FIRST_MASK)) * CHUNK;
  if (flags & BF16_W) {
    if (flags & PROX) chunk<__nv_bfloat16, RULE, true>(leaf, flags, base, t.s);
    else chunk<__nv_bfloat16, RULE, false>(leaf, flags, base, t.s);
  } else {
    if (flags & PROX) chunk<float, RULE, true>(leaf, flags, base, t.s);
    else chunk<float, RULE, false>(leaf, flags, base, t.s);
  }
}

}  // namespace

extern "C" {

// The kernel's constants, which the wrapper's launch plan must match.
int prox_adam_chunk() { return CHUNK; }
int prox_adam_max_leaves() { return MAX_LEAVES; }

// One launch over n_leaves leaves (1..MAX_LEAVES), updated in place. rows
// holds 7 int64 a leaf: the pointers w (f32, or bf16 with the BF16_W
// flag), g, m, v (f32), the length n (0 < n < 2^31), the flags (BF16_W 1,
// PROX 2, VEC 4) and the leaf's first thread block; blocks is the total
// (< 2^28). Each leaf's first block is the sum of ceil(n / CHUNK) over the
// leaves before it, and VEC needs every pointer 16-byte aligned (w 8 when
// bf16): a table that breaks any of these is refused
// (cudaErrorInvalidValue) before a launch. rule 0 = adam, 1 = rmsprop.
// Scalars as in fused_prox_update: lr, lam, b1, b2, eps, bc1 = 1 - b1^t,
// bc2 = 1 - b2^t.
int prox_adam_tree(const long long* rows, int n_leaves, int blocks, int rule,
                   float lr, float lam, float b1, float b2, float eps,
                   float bc1, float bc2, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || (rule != 0 && rule != 1))
    return bad;
  Table t;
  long long next = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const long long* r = rows + 7 * i;
    const long long n = r[4], flags = r[5];
    const unsigned long long wal = (flags & BF16_W) ? 8 : 16;
    const unsigned long long* u = reinterpret_cast<const unsigned long long*>(r);
    const bool aligned = u[0] % wal == 0 && u[1] % 16 == 0 &&
                         u[2] % 16 == 0 && u[3] % 16 == 0;
    if (n < 1 || n > 0x7fffffffLL || flags < 0 || flags > 7 ||
        r[6] != next || ((flags & VEC) && !aligned))
      return bad;
    t.w[i] = reinterpret_cast<void*>(r[0]);
    t.g[i] = reinterpret_cast<const float*>(r[1]);
    t.m[i] = reinterpret_cast<float*>(r[2]);
    t.v[i] = reinterpret_cast<float*>(r[3]);
    t.n[i] = static_cast<int>(n);
    t.first[i] = static_cast<int>(next | (flags << FLAG_SHIFT));
    next += (n + CHUNK - 1) / CHUNK;
  }
  if (next != blocks || next > FIRST_MASK) return bad;
  t.n_leaves = n_leaves;
  t.s = Scalars{lr, lam, b1, b2, eps, bc1, bc2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rule == 0) {
    prox_adam_tree_kernel<0><<<blocks, THREADS, 0, st>>>(t);
  } else {
    prox_adam_tree_kernel<1><<<blocks, THREADS, 0, st>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
