// Tensor-core primitives shared by the two tile cores (attn_tile.cuh for
// the attention kernels, bsr_tile.cuh for the block-sparse products):
// mma.sync m16n8k16 with f32 sums on bf16 or f16 operands, the split of
// an f32 operand into 16-bit hi and lo parts, ldmatrix fragment loads and
// cp.async staging into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// The 16-bit mma operand type for a storage type: f32 goes through bf16
// hi / lo parts.
template <typename T> struct Operand { using H = T; };
template <> struct Operand<float> { using H = __nv_bfloat16; };

template <typename H> struct Half;

template <> struct Half<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ float to(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Half<__half> {
  static __device__ __forceinline__ __half from(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ float to(__half x) { return __half2float(x); }
  static __device__ __forceinline__ uint32_t bits(__half x) { return __half_as_ushort(x); }
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Two floats as packed 16-bit parts (a in the low half): part 0 is the
// rounding of the value, part p the rounding of what parts 0 .. p-1 leave
// (hi, lo at PARTS 2; hi, mid, lo at 3: three bf16 parts hold an f32
// exactly). Each remainder is exact in f32.
template <typename H, int PARTS>
__device__ __forceinline__ void split2(float a, float b, uint32_t (&out)[PARTS]) {
  using F = Half<H>;
#pragma unroll
  for (int p = 0; p < PARTS; ++p) {
    const H ha = F::from(a), hb = F::from(b);
    out[p] = F::bits(ha) | (F::bits(hb) << 16);
    a -= F::to(ha);
    b -= F::to(hb);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// 16 bytes global -> shared; with ok false, 16 zero bytes (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace tc
