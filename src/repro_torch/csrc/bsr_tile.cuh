// The block-tile core shared by the forward BCSR / palette spmm
// (bsr_spmm.cu, bsr_tile_fwd), the backward dX = dY W (bsr_spmm.cu,
// bsr_tile_bwd) and the SDDMM (bsr_sddmm.cu): sums of products of
// gathered slabs of a dense operand and (br, bc) blocks, on the tensor
// cores (mma.sync m16n8k16, bf16 operands, f32 sums; the primitives of
// tc_ops.cuh).
//
// * Slabs are staged into shared memory 128 columns (kK) at a time, rows
//   padded by 16 bytes (kStr): the 8 rows an ldmatrix reads fall into 8
//   distinct bank groups. Every value outside the operand (rows past M,
//   columns past K, N or the block's bc) is staged as zero, so that no
//   product meets uninitialized memory along the summed axis. Rows of a
//   fragment that no output keeps (a block's rows past br, br < 8
//   zero-filling n) may hold anything: the mma keeps rows and columns
//   apart.
// * A 16-bit operand (bf16 activations, a bf16 block store) is copied by
//   cp.async (16 bytes a thread, zero-fill for the edges) where its rows
//   are 16-byte aligned, else by plain loads.
// * The plain versions compute in f32 and the kernels are held to them at
//   2e-4 + 1e-4 relative (the spmm; the SDDMM at 2e-4 max(1, M / 32)),
//   on sums of hundreds to thousands of O(1) products. One bf16 rounding
//   of an f32 operand is 2^-9 relative, and a hi + lo pair 2^-18 with lo x
//   lo dropped: both miss that (tests/test_torch_bsr_tiles.py; the first
//   chip run of hi + lo missed at M = 33, K = 960). So an f32 operand
//   (activations, the f32 block store, the palette, dY) is split into three
//   bf16 parts, hi, mid and lo, which hold it exactly: 3 products beside a
//   bf16 partner (exact products), 6 for f32 x f32 (the parts whose orders
//   sum to at most 2; what is dropped is 2^-27). bf16 x bf16 is 1 product.
// * Palette codes are decoded through the 256-entry palette held in
//   shared memory already split into its three parts; code 0 stays exactly
//   zero.
// * The tensor cores' own accumulation does not round to nearest, and
//   drifts over long walks (the paged kernel's 4,096-key partials, PERF.md).
//   So each block (forward), each job of 128 summed entries (backward) or
//   each chunk of 64 rows of M (SDDMM) is summed from zero and then added
//   to the accumulator in f32.

#pragma once

#include "tc_ops.cuh"

namespace bsr {

using H = __nv_bfloat16;
using F = tc::Half<H>;

constexpr int kK = 128;              // columns of a staged slab (8 k-steps)
constexpr int kStr = kK + 8;         // its row stride in 16-bit elements
constexpr int kChunk = 64;           // SDDMM: rows of M per staged chunk
constexpr int kPalette = 256;

// n-tiles of 8 for br <= 32 block rows (br < 8 zero-fills n, as do the
// rows past br) and the rows staged for them (ldmatrix x4 reads 16 rows at
// a time)
__host__ __device__ constexpr int n_tiles(int br) { return br <= 8 ? 1 : br <= 16 ? 2 : 4; }
__host__ __device__ constexpr int n_rows(int nt) { return nt <= 2 ? 16 : 8 * nt; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Parts of an operand stored as T, and the products of an X-part i and a
// W-part j that are kept: i + j < order(XS, WS).
template <typename T> __host__ __device__ constexpr int parts() { return sizeof(T) == 4 ? 3 : 1; }
__host__ __device__ constexpr int order(int a, int b) { return a > b ? a : b; }

// Eight floats as PARTS 16-byte chunks of bf16 parts, part p at d + p * part.
template <int PARTS>
__device__ __forceinline__ void split8(const float (&v)[8], H* d, int part) {
  uint32_t p[4][PARTS];
#pragma unroll
  for (int e = 0; e < 4; ++e) tc::split2<H, PARTS>(v[2 * e], v[2 * e + 1], p[e]);
#pragma unroll
  for (int q = 0; q < PARTS; ++q)
    *reinterpret_cast<uint4*>(d + q * part) = make_uint4(p[0][q], p[1][q], p[2][q], p[3][q]);
}

// Stage rows [0, rows) x chunks [0, cpr) of 8 elements of a gathered
// operand (spmm_t's dY and block slabs; a contiguous operand takes stage
// below: the tile forward ran slower staging through this function, PERF.md)
// into dst (row stride str): at(r, k) is the address of element k of row
// r, or nullptr where the operand has none (staged as zero). A 16-bit T is
// staged as it is (PARTS 1), by cp.async where vec says that each chunk is
// 16-byte aligned and that at(r, k) of its first element speaks for all
// eight (the caller commits and waits; src is any valid address, never
// read); an f32 T as its PARTS bf16 parts, part p at dst + p * part, by
// 16-byte loads where vec says the same of each half of four.
template <int PARTS, typename T, typename At>
__device__ __forceinline__ void stage_at(H* dst, int str, int part, int rows, int cpr,
                                         bool vec, const T* src, At at) {
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int r = i / cpr, k = (i - r * cpr) * 8;
    H* d = dst + r * str + k;
    if constexpr (sizeof(T) == 2) {
      static_assert(PARTS == 1, "a 16-bit operand is staged as it is");
      if (vec) {
        const T* s = at(r, k);
        tc::cp_async16(d, s ? s : src, s != nullptr);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T* a = at(r, k + 2 * e);
          const T* b = at(r, k + 2 * e + 1);
          w[e] = (a ? __bfloat16_as_ushort(*a) : 0u) |
                 ((b ? (uint32_t)__bfloat16_as_ushort(*b) : 0u) << 16);
        }
        *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    } else {
      float v[8];
      if (vec) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const T* s = at(r, k + 4 * h);
          float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
          if (s) q = __ldg(reinterpret_cast<const float4*>(s));
          v[4 * h] = q.x; v[4 * h + 1] = q.y; v[4 * h + 2] = q.z; v[4 * h + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const T* s = at(r, k + e);
          v[e] = s ? to_f32(*s) : 0.f;
        }
      }
      split8<PARTS>(v, d, part);
    }
  }
}

// Stage rows [0, rows) x chunks [0, cpr) of 8 columns of the row-major
// matrix src (pitch ld elements) into dst (row stride str): element (i, k)
// is src[(row0 + i) * ld + col0 + k] where row0 + i < row_end and col0 + k
// < col_end, else zero. A 16-bit T is staged as it is (PARTS 1), by
// cp.async where vec says that every chunk is 16-byte aligned and lies
// wholly inside or outside [col0, col_end) (the caller commits and
// waits); an f32 T as its PARTS bf16 parts, part p at dst + p * part.
template <int PARTS, typename T>
__device__ __forceinline__ void stage(H* dst, int str, int part, const T* src, long long ld,
                                      int row0, int rows, int row_end, int col0, int col_end,
                                      int cpr, bool vec) {
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int r = i / cpr, k = col0 + (i - r * cpr) * 8;
    const int row = row0 + r;
    H* d = dst + r * str + (i - r * cpr) * 8;
    const T* s = src + (long long)row * ld + k;
    const bool row_ok = row < row_end;
    if constexpr (sizeof(T) == 2) {
      static_assert(PARTS == 1, "a 16-bit operand is staged as it is");
      if (vec) {
        const bool ok = row_ok && k < col_end;
        tc::cp_async16(d, ok ? s : src, ok);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t a = row_ok && k + 2 * e < col_end ? __bfloat16_as_ushort(s[2 * e]) : 0u;
          const uint32_t b = row_ok && k + 2 * e + 1 < col_end ? __bfloat16_as_ushort(s[2 * e + 1]) : 0u;
          w[e] = a | (b << 16);
        }
        *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    } else {
      float v[8];
      if (vec) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row_ok && k + 4 * h < col_end) q = __ldg(reinterpret_cast<const float4*>(s + 4 * h));
          v[4 * h] = q.x; v[4 * h + 1] = q.y; v[4 * h + 2] = q.z; v[4 * h + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = row_ok && k + e < col_end ? to_f32(s[e]) : 0.f;
      }
      split8<PARTS>(v, d, part);
    }
  }
}

// Copy rows [0, rows) of a raw chunk: bytes [b0, b0 + RB) of row r of
// src (row r at src + r * pitch), bytes from end on as zero, into dst at a
// row stride of RB. vec (16-byte aligned rows, end a multiple of 16):
// cp.async, which the caller commits and waits for; else byte loads.
template <int RB>
__device__ __forceinline__ void raw_rows(uint8_t* dst, const uint8_t* src, long long pitch,
                                         int rows, int b0, int end, bool vec) {
  if (vec) {
    constexpr int P = RB / 16;
    for (int i = threadIdx.x; i < rows * P; i += blockDim.x) {
      const int r = i / P, b = b0 + (i - r * P) * 16;
      const bool ok = b < end;
      tc::cp_async16(dst + r * RB + (i - r * P) * 16, ok ? src + r * pitch + b : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * RB; i += blockDim.x) {
      const int r = i / RB, b = b0 + (i - r * RB);
      dst[i] = b < end ? src[r * pitch + b] : 0;
    }
  }
}

// The forward's block operand. A policy copies rows [0, br) x columns
// [kc, kc + kK) of slot s's block, as stored (zero past bc), into a raw
// buffer of kRawRow bytes a row (raw: by cp.async, so the copy of the next
// job overlaps this job's products), and converts a raw buffer into PARTS
// bf16 parts at kStr, part p at dst + p * part.

// fp block store: data (n_slots, br, bc), S = float (3 parts) or bf16 (1)
template <typename S>
struct FloatBlocks {
  static constexpr int PARTS = parts<S>();
  static constexpr bool kHasPalette = false;
  static constexpr int kRawRow = kK * sizeof(S);
  const S* data;
  int br, bc;
  bool vec;           // rows 16-byte aligned (bc a multiple of 16 / sizeof(S))
  __device__ __forceinline__ void stage_palette(H*) const {}
  __device__ __forceinline__ void raw(uint8_t* dst, int s, int kc) const {
    raw_rows<kRawRow>(dst, reinterpret_cast<const uint8_t*>(data + (long long)s * br * bc),
                      (long long)bc * sizeof(S), br, kc * (int)sizeof(S),
                      bc * (int)sizeof(S), vec);
  }
  __device__ __forceinline__ void convert(H* dst, int part, const uint8_t* raw,
                                          const H*) const {
    for (int i = threadIdx.x; i < br * (kK / 8); i += blockDim.x) {
      const int r = i / (kK / 8), c8 = i - r * (kK / 8);
      const S* src = reinterpret_cast<const S*>(raw + r * kRawRow) + c8 * 8;
      H* d = dst + r * kStr + c8 * 8;
      if constexpr (sizeof(S) == 2) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
      } else {
        const float4 a = reinterpret_cast<const float4*>(src)[0];
        const float4 b = reinterpret_cast<const float4*>(src)[1];
        const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        split8<PARTS>(v, d, part);
      }
    }
  }
};

// palette store: codes (n_slots, br, bc) at 8 bits, (n_slots, br, bc / 2)
// at 4 bits, low nibble first; palette (2**BITS,) f32
template <int BITS>
struct PaletteBlocks {
  static constexpr int PARTS = 3;
  static constexpr bool kHasPalette = true;
  static constexpr int kRawRow = kK * BITS / 8;
  const uint8_t* codes;
  const float* palette;
  int br, bc;
  bool vec;           // code rows 16-byte aligned
  // pal: the kPalette values' part 0, then part 1, then part 2; code 0
  // is exact zero
  __device__ __forceinline__ void stage_palette(H* pal) const {
    for (int i = threadIdx.x; i < kPalette; i += blockDim.x) {
      float v = i > 0 && i < (1 << BITS) ? palette[i] : 0.f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        const H h = F::from(v);
        pal[p * kPalette + i] = h;
        v -= F::to(h);
      }
    }
  }
  __device__ __forceinline__ void raw(uint8_t* dst, int s, int kc) const {
    const int row_bytes = bc * BITS / 8;
    raw_rows<kRawRow>(dst, codes + (long long)s * br * row_bytes, row_bytes, br,
                      kc * BITS / 8, row_bytes, vec);
  }
  __device__ __forceinline__ void convert(H* dst, int part, const uint8_t* raw,
                                          const H* pal) const {
    for (int i = threadIdx.x; i < br * (kK / 8); i += blockDim.x) {
      const int r = i / (kK / 8), c8 = i - r * (kK / 8);
      int code[8];
      if (BITS == 8) {
        const uint2 b = *reinterpret_cast<const uint2*>(raw + r * kRawRow + c8 * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          code[e] = (b.x >> (8 * e)) & 0xFF;
          code[4 + e] = (b.y >> (8 * e)) & 0xFF;
        }
      } else {
        const uint32_t b = *reinterpret_cast<const uint32_t*>(raw + r * kRawRow + c8 * 4);
#pragma unroll
        for (int e = 0; e < 8; ++e) code[e] = (b >> (4 * e)) & 0xF;
      }
      H* d = dst + r * kStr + c8 * 8;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        const H* pp = pal + p * kPalette;
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = F::bits(pp[code[2 * e]]) | (F::bits(pp[code[2 * e + 1]]) << 16);
        *reinterpret_cast<uint4*>(d + p * part) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
};

// Forward: t (MT m-tiles of 16 rows x NT n-tiles of 8 columns) += the
// warp's 16 MT rows of a staged X slab (XS parts, part p at x + p * xpart)
// times a staged block (WS parts at w + p * wpart) transposed, over kK
// columns. A fragments come from X rows, B fragments from block rows (both
// non-transposed ldmatrix); each B fragment serves the MT m-tiles.
template <int MT, int NT, int XS, int WS>
__device__ __forceinline__ void fwd_slab(float (&t)[MT][NT][4], const H* x, int xpart,
                                         const H* w, int wpart) {
  const int lane = threadIdx.x & 31;
  const H* xa = x + (lane & 15) * kStr + (lane >> 4) * 8;
  const H* wb = w + ((lane & 7) + (lane >> 4) * 8) * kStr + ((lane >> 3) & 1) * 8;
#pragma unroll 2
  for (int kk = 0; kk < kK / 16; ++kk) {
    uint32_t a[MT][XS][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < XS; ++i) tc::ldsm_x4(a[m][i], xa + i * xpart + m * 16 * kStr + kk * 16);
#pragma unroll
    for (int np = 0; np < (NT + 1) / 2; ++np)
#pragma unroll
      for (int j = 0; j < WS; ++j) {
        uint32_t b[4];
        tc::ldsm_x4(b, wb + j * wpart + np * 16 * kStr + kk * 16);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i + j < order(XS, WS) && i < XS; ++i) {
            F::mma(t[m][2 * np], a[m][i], b[0], b[1]);
            if (2 * np + 1 < NT) F::mma(t[m][2 * np + 1], a[m][i], b[2], b[3]);
          }
      }
  }
}

// spmm_t: t (MT m-tiles of 16 rows x NT n-tiles of 8 columns, NT even) +=
// the warp's 16 MT rows of a staged dY slab (XS parts, part p at a + p *
// apart, row stride kStr; its columns are the summed axis) times a staged
// block slab (WS parts at b + p * bpart, row stride bs; its rows are the
// summed axis, its columns the output's) as stored, over ksteps k-steps of
// 16. A fragments come from dY rows (ldmatrix), B fragments from block
// rows by the transposing ldmatrix; each B fragment serves the MT m-tiles.
template <int MT, int NT, int XS, int WS>
__device__ __forceinline__ void bwd_slab(float (&t)[MT][NT][4], const H* a, int apart,
                                         const H* b, int bpart, int bs, int ksteps) {
  const int lane = threadIdx.x & 31;
  const H* ya = a + (lane & 15) * kStr + (lane >> 4) * 8;
  const H* wb = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * bs + (lane >> 4) * 8;
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t af[MT][XS][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < XS; ++i) tc::ldsm_x4(af[m][i], ya + i * apart + m * 16 * kStr + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np)
#pragma unroll
      for (int j = 0; j < WS; ++j) {
        uint32_t bf[4];
        tc::ldsm_x4_t(bf, wb + j * bpart + kk * 16 * bs + np * 16);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i + j < order(XS, WS) && i < XS; ++i) {
            F::mma(t[m][2 * np], af[m][i], bf[0], bf[1]);
            F::mma(t[m][2 * np + 1], af[m][i], bf[2], bf[3]);
          }
      }
  }
}

// SDDMM: t (MT m-tiles of 16 columns of X, from column m0, x NT n-tiles
// of 8 columns of dY) += X' dY over a staged chunk of kChunk rows: A
// fragments from the X chunk (rows are the summed axis) and B fragments
// from the dY chunk (row stride ys), both by the transposing ldmatrix.
template <int MT, int NT, int XS, int YS>
__device__ __forceinline__ void sddmm_chunk(float (&t)[MT][NT][4], const H* x, int xpart,
                                            int m0, const H* y, int ypart, int ys) {
  const int lane = threadIdx.x & 31;
  const H* xa = x + ((lane & 7) + (lane >> 4) * 8) * kStr + m0 + ((lane >> 3) & 1) * 8;
  const H* yb = y + ((lane & 7) + ((lane >> 3) & 1) * 8) * ys + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    uint32_t b[YS][(NT + 1) / 2][4];
#pragma unroll
    for (int j = 0; j < YS; ++j)
#pragma unroll
      for (int np = 0; np < (NT + 1) / 2; ++np)
        tc::ldsm_x4_t(b[j][np], yb + j * ypart + kk * 16 * ys + np * 16);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[XS][4];
#pragma unroll
      for (int i = 0; i < XS; ++i) tc::ldsm_x4_t(a[i], xa + i * xpart + kk * 16 * kStr + mt * 16);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < YS; ++j)
#pragma unroll
          for (int i = 0; i + j < order(XS, YS) && i < XS; ++i)
            F::mma(t[mt][n], a[i], b[j][n / 2][2 * (n & 1)], b[j][n / 2][2 * (n & 1) + 1]);
    }
  }
}

}  // namespace bsr
