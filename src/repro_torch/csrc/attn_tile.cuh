// The attention tile core shared by paged_attention.cu and
// flash_attention.cu: an online softmax over kv tiles whose QK^T and PV
// products run on the tensor cores (mma.sync m16n8k16, bf16 or f16
// operands, f32 sums), FlashAttention-2 style.
//
// * A warp owns 16 query rows (a warp pair where d_split says so) and
//   carries their m, l and accumulator fragment in registers. The block's
//   query tile stays in shared memory; each k-step loads its A fragments
//   by ldmatrix (at hd 256 the accumulator alone takes 128 registers).
// * A kv tile of kv_tile<HD>() keys of K and V is staged into shared
//   memory, by cp.async (16-bit storage) into a ring of two stages, so that
//   one tile's copy overlaps the previous tile's products, or (f32
//   storage) by plain loads that split each value into a hi and a lo part.
//   Rows are padded by 16 bytes: the 8 rows an ldmatrix reads fall into 8
//   distinct bank groups. A padded key or query row is zero-filled
//   (cp.async's zero-fill form): 0 * NaN left in shared memory would be NaN.
// * The plain versions compute in f32, and the kernels are held to them at
//   1e-4. One bf16 rounding of an f32 operand is 2^-9 relative, so an f32
//   operand x is split into hi = bf16(x) and lo = bf16(x - hi) (2^-17
//   together; f16 parts beside f16 storage), and the products of the parts
//   are summed in f32: QS, KS and PS count the parts of Q, K/V and P, and
//   the products of two lo parts (2^-18) are dropped. bf16 x bf16 products
//   are exact in f32. Over the 8,192-key walk of an f32 pool the pair's
//   2^-18 per product added up past 1e-4 (a chip run), so the paged kernel
//   splits q, K, V and P into three parts (hi, mid, lo: exact) for f32
//   pools and keeps the products whose part orders sum to at most 2.
// * Scores are scaled, then masked with the reference's three kinds of key
//   column (Mask): a key a row may see keeps its score; a real key that
//   the causal or window mask hides gets -1e30 (the reference's sentinel:
//   while m is still -1e30 it adds exp(0) = 1 to l and V to acc, junk that
//   the first real score wipes through exp(-1e30 - m) = 0); a key slot past
//   the keys that run gets -inf and adds nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_ops.cuh"

namespace attn {

constexpr int kWarpRows = 16;                  // query rows per warp (mma M)
constexpr float kMasked = -1e30f;              // the reference's NEG_INF

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// Keys per kv tile: 32 at hd 256 keeps two 16-bit stages beside two Q
// parts in 135 KB.
template <int HD> __host__ __device__ constexpr int kv_tile() { return HD > 128 ? 32 : 64; }
// Warps per 16 query rows. At hd 256 the accumulator alone takes 128
// registers a thread, and with split operands (QS * KS > 1) the rest no
// longer fits without spilling: two warps then share 16 rows, each summing
// S over half the head dim (exchanged through shared memory) and owning
// half the accumulator's columns.
__host__ __device__ constexpr int d_split(int hd, int qs, int ks) {
  return hd > 128 && qs * ks > 1 ? 2 : 1;
}
// Row stride in 16-bit elements of a staged tile (16 bytes of padding).
template <int HD> __host__ __device__ constexpr int row_stride() { return HD + 8; }
// Smallest head-dim template that holds hd (hd % 8 == 0, hd <= 256).
__host__ __device__ constexpr int padded_hd(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

// The tensor-core primitives of tc_ops.cuh, shared with bsr_tile.cuh.
using tc::Half;
using tc::Operand;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::split2;

// The two warps of a 16-row group (64 threads) at barrier id.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(id) : "memory");
}


// Stage rows [0, NROWS <= 64) of a tile into dst, at row_stride<HD>():
// row j is row(j) of the source (row(j) < 0: a padded row, zero-filled),
// which starts at base + row(j) * pitch + col0; columns from hd on are
// zero. Lane j of each warp evaluates row for rows j and j + 32 once (a
// page-table lookup for the paged kernel); the 16-byte chunks take their
// row by a shuffle, so no chunk waits on a lookup. 16-bit T: cp.async (the
// caller commits and waits). f32 T: plain loads, split into hi parts at
// dst and lo parts at dst + part. Every lane of a warp runs the same
// number of chunks (NROWS * HD / 8 is a multiple of 32). f32 T: PARTS
// parts, part p at dst + p * part.
template <int HD, int THREADS, int NROWS, int PARTS = 2, typename T, typename H,
          typename Row>
__device__ __forceinline__ void stage(H* dst, int part, const T* base, int pitch,
                                      int col0, int hd, Row row) {
  static_assert(NROWS <= 64 && NROWS * HD % 256 == 0, "rows per warp pass");
  constexpr int STR = row_stride<HD>();
  constexpr int EL = 16 / sizeof(T);           // elements per 16-byte chunk
  constexpr int CH = HD / EL;                  // chunks per row
  // f32 at hd 256: one chunk in flight beside the accumulator
  constexpr int kUnroll = sizeof(T) == 4 && HD > 128 ? 1 : 4;
  const int lane = threadIdx.x & 31;
  const int own0 = lane < NROWS ? row(lane) : -1;
  int own1 = -1;
  if constexpr (NROWS > 32) own1 = row(lane + 32);
#pragma unroll kUnroll
  for (int i = threadIdx.x; i < NROWS * CH; i += THREADS) {
    const int j = i / CH, c = i - j * CH;
    int r = __shfl_sync(0xffffffffu, own0, j & 31);
    if constexpr (NROWS > 32) {
      const int r1 = __shfl_sync(0xffffffffu, own1, j & 31);
      if (j >= 32) r = r1;
    }
    const bool ok = r >= 0 && c * EL < hd;
    const T* src = base + (ok ? (long long)r * pitch + col0 + c * EL : 0);
    if constexpr (sizeof(T) == 2) {
      cp_async16(dst + j * STR + c * EL, src, ok);
    } else {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) x = __ldg(reinterpret_cast<const float4*>(src));
      uint32_t p01[PARTS], p23[PARTS];
      split2<H, PARTS>(x.x, x.y, p01);
      split2<H, PARTS>(x.z, x.w, p23);
#pragma unroll
      for (int p = 0; p < PARTS; ++p)
        *reinterpret_cast<uint2*>(dst + p * part + j * STR + c * EL) = make_uint2(p01[p], p23[p]);
    }
  }
}

// The three kinds of key column, for the two rows a thread holds.
struct Mask {
  int qpos[2];      // absolute positions of rows lane/4 and lane/4 + 8
  int qmin, qmax;   // over the warp's rows (set by warp_range)
  int key0;         // position of the tile's first key
  int key_end;      // keys from here on are padded slots (-inf)
  int window;       // <= 0: none
  bool causal;
  __device__ __forceinline__ void warp_range() {
    qmin = min(qpos[0], qpos[1]);
    qmax = max(qpos[0], qpos[1]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
    }
  }
  // Every row of the warp sees every key of a tile of bk keys (the same
  // for the whole warp): the tile needs no mask.
  __device__ __forceinline__ bool all_visible(int bk) const {
    return key0 + bk <= key_end && (!causal || key0 + bk - 1 <= qmin) &&
           (window <= 0 || qmax - key0 < window);
  }
  __device__ __forceinline__ float operator()(int h, int key, float s) const {
    const int kpos = key0 + key;
    if (kpos >= key_end) return neg_inf();
    bool ok = !causal || qpos[h] >= kpos;
    if (window > 0) ok = ok && qpos[h] - kpos < window;
    return ok ? s : kMasked;
  }
};

// One warp's 16 rows: m, l and the accumulator fragment of its DC columns.
// Thread t holds rows t/4 and t/4 + 8 of the warp, columns 8d + 2(t%4) +
// {0, 1}.
template <typename H, int HD, int QS, int KS, int PS>
struct Core {
  static constexpr int STR = row_stride<HD>();
  static constexpr int BK = kv_tile<HD>();
  static constexpr int SPLIT = d_split(HD, QS, KS), DC = HD / SPLIT;
  static constexpr int kExchange = 32 * BK / 2;   // floats of one S fragment
  // k-steps of S unrolled (all of them would hoist every ldmatrix of a
  // wide head ahead of its products and spill), and column blocks of P V
  // per pass (2G independent accumulator chains beside acc)
  static constexpr int kStepUnroll = HD >= 128 ? 2 : HD / 16;
  static constexpr int G = DC >= 64 ? 4 : DC / 16;
  // products of parts i (of Q or P) and j (of K or V) kept: i + j below
  // the larger part count (with two split operands, lo x lo is dropped;
  // with three, the terms of order 2^-27)
  static constexpr int kOrderS = QS > KS ? QS : KS, kOrderP = PS > KS ? PS : KS;
  float acc[DC / 8][4];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int d = 0; d < DC / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    m[0] = m[1] = kMasked;
    l[0] = l[1] = 0.f;
  }

  // q: the warp's 16 rows of Q part 0 (part p at q + p * q_part); k: a
  // staged kv tile of BK rows (part p at + p * kv_part); v: its V tile at
  // this warp's first column. With SPLIT 2, half (0 or 1) says which half
  // of the head dim this warp sums S over, xs holds the pair's two S
  // fragments (2 * kExchange floats) and bar is the pair's barrier id.
  template <class M>
  __device__ __forceinline__ void step(const H* q, int q_part, const H* k,
                                       const H* v, int kv_part, float scale,
                                       const M& mask, int half = 0,
                                       float* xs = nullptr, int bar = 0) {
    using F = Half<H>;
    const int lane = threadIdx.x & 31;
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;

    // S = Q K^T: A from Q rows (lane % 16), B from K rows (non-transposed)
    const H* qa = q + (lane & 15) * STR + (lane >> 4) * 8;
    const H* kb = k + ((lane & 7) + (lane >> 4) * 8) * STR + ((lane >> 3) & 1) * 8;
#pragma unroll kStepUnroll
    for (int kk = half * HD / 16 / SPLIT; kk < (half + 1) * HD / 16 / SPLIT; ++kk) {
      uint32_t a[QS][4];
#pragma unroll
      for (int i = 0; i < QS; ++i) ldsm_x4(a[i], qa + i * q_part + kk * 16);
#pragma unroll
      for (int nn = 0; nn < BK / 16; ++nn)
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          uint32_t b[4];
          ldsm_x4(b, kb + j * kv_part + nn * 16 * STR + kk * 16);
#pragma unroll
          for (int i = 0; i + j < kOrderS && i < QS; ++i) {
            F::mma(s[2 * nn], a[i], b[0], b[1]);
            F::mma(s[2 * nn + 1], a[i], b[2], b[3]);
          }
        }
    }

    if constexpr (SPLIT == 2) {               // S = own half + the other's
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[half * kExchange + (4 * n + e) * 32 + lane] = s[n][e];
      pair_sync(bar);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += xs[(1 - half) * kExchange + (4 * n + e) * 32 + lane];
    }

    // scale, mask, online softmax (rows shared by the 4 lanes of a quad)
    if (mask.all_visible(BK)) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    } else {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = mask(e >> 1, n * 8 + (lane & 3) * 2 + (e & 1), s[n][e] * scale);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[h] = __expf(m[h] - mx);
      m[h] = mx;
      float sum = 0.f;                          // this lane's share of the row
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[n][e] = __expf(s[n][e] - mx);
          sum += s[n][e];
        }
      l[h] = corr[h] * l[h] + sum;
    }
#pragma unroll
    for (int d = 0; d < DC / 8; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }

    // acc += P V. The S fragments of keys 16kk.. are P's A fragments; B
    // comes from V rows by the transposing ldmatrix. With split operands
    // the tile's P V starts from zero and is added to acc in f32, as the
    // reference adds p @ v per page: the tensor cores' sums (not rounded to
    // nearest) then span one tile, not a walk of thousands of keys. Single
    // 16-bit operands (flash, bf16 / f16) are held to their type's rounding
    // and accumulate into acc directly.
    uint32_t pa[BK / 16][PS][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t p[4][PS];
      split2<H, PS>(s[2 * kk][0], s[2 * kk][1], p[0]);
      split2<H, PS>(s[2 * kk][2], s[2 * kk][3], p[1]);
      split2<H, PS>(s[2 * kk + 1][0], s[2 * kk + 1][1], p[2]);
      split2<H, PS>(s[2 * kk + 1][2], s[2 * kk + 1][3], p[3]);
#pragma unroll
      for (int i = 0; i < PS; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][i][r] = p[r][i];
    }
    const H* vb = v + ((lane & 7) + ((lane >> 3) & 1) * 8) * STR + (lane >> 4) * 8;
    if constexpr (PS * KS == 1) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int dn = 0; dn < DC / 16; ++dn) {
          uint32_t b[4];
          ldsm_x4_t(b, vb + kk * 16 * STR + dn * 16);
          F::mma(acc[2 * dn], pa[kk][0], b[0], b[1]);
          F::mma(acc[2 * dn + 1], pa[kk][0], b[2], b[3]);
        }
      return;
    }
#pragma unroll
    for (int d0 = 0; d0 < DC / 16; d0 += G) {
      float t[2 * G][4];
#pragma unroll
      for (int n = 0; n < 2 * G; ++n) t[n][0] = t[n][1] = t[n][2] = t[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < KS; ++j)
#pragma unroll
          for (int dn = 0; dn < G; ++dn) {
            uint32_t b[4];
            ldsm_x4_t(b, vb + j * kv_part + kk * 16 * STR + (d0 + dn) * 16);
#pragma unroll
            for (int i = 0; i + j < kOrderP && i < PS; ++i) {
              F::mma(t[2 * dn], pa[kk][i], b[0], b[1]);
              F::mma(t[2 * dn + 1], pa[kk][i], b[2], b[3]);
            }
          }
#pragma unroll
      for (int n = 0; n < 2 * G; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[2 * d0 + n][e] += t[n][e];
    }
  }

  // Sum each row's l over its quad (m is already quad-uniform).
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }
};

// Shared memory (bytes) of a block with ROWS query rows: QS parts of the Q
// tile, STAGES stages of K and V tiles of KS parts each, and the S
// exchange of the warp pairs (at d_split 2), in that order.
template <int HD>
__host__ __device__ constexpr size_t smem_bytes(int rows, int qs, int ks, int stages) {
  return sizeof(uint16_t) * row_stride<HD>() *
             ((size_t)qs * rows + (size_t)stages * 2 * ks * kv_tile<HD>()) +
         (d_split(HD, qs, ks) == 2 ? sizeof(float) * rows * 2 * kv_tile<HD>() : 0);
}

}  // namespace attn
