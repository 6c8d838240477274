// Paged flash-decode attention over a block-paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/paged_attention/paged_attention.py::paged_flash_fwd
// (the continuous-batching engine's mixed prefill/decode attention). For
// every (slot b, kv head, split s) it walks the split's logical pages
// through the page table and runs the online softmax of the C*g query rows
// that share the kv head (GQA group g, tick width C) against their keys,
// emitting UNNORMALIZED partials
//   acc (B, KV, S, C, g, hd), m and l (B, KV, S, C, g), all f32;
// the wrapper (kernels/paged_attention/ops.py) runs the exact cross-split
// combine. The gathered (B, P*ps, KV, hd) context is never formed.
//
// Semantics, to the letter of the reference (kernels/paged_attention/ref.py):
//   * a page runs when page*ps <= start + C - 1 and, with a window,
//     page*ps + ps - 1 >= start - window + 1, where start is the tick's
//     first position (row 0); pages per split: ceil(P / S). The running
//     pages of a split are one range of logical key positions;
//   * a key of a running page that row r may see (q_pos >= k_pos, and
//     q_pos - k_pos < window) keeps its scaled score; one that the mask
//     hides gets -1e30, so a row whose split holds only masked keys carries
//     the reference's exp(0) junk in l and acc; a slot past the running
//     keys gets -inf and adds nothing. An empty split emits m = -1e30,
//     l = 0, acc = 0;
//   * q arrives as f32, K and V as f32, bf16 or f16; the scale hd^-0.5
//     multiplies the f32 dot product, and every sum is f32.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 on the tensor
// cores): at decode (C = 1) each K/V page serves g rows, so the kernel is
// bound by the bytes of the pages that run; at a wide prefill tick (C 32,
// g 16: 512 rows per kv head) by the products, 4 * C*g * keys * hd flops.
//
// Design, on the tile core of attn_tile.cuh: one thread block per (row
// tile, split, slot x kv head). A row tile is 64 of the C*g rows (16 where
// C*g <= 16, as at decode), a warp per 16 rows (a warp pair at hd 256);
// row r has position positions[b, r / g]. The block walks its split's running keys once, in kv
// tiles of consecutive logical positions gathered through its row of the
// page table (each 16-byte cp.async chunk computes its own physical
// address, so any page size works), in a ring of two stages. Where every
// row of the tile sees a key of the split, kv tiles that no row sees are
// skipped (their -1e30 terms would be wiped exactly); otherwise the whole
// split is walked, junk included. q is split into bf16 (f16 for f16
// pools) hi and lo parts, so QK^T is q_hi K + q_lo K and PV is P_hi V +
// P_lo V on the tensor cores; f32 pools also split K and V (three products
// each) and are staged by plain loads in one stage.
//
// Built with nvcc into a shared library with a plain C interface; the entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <climits>

#include "attn_tile.cuh"

namespace {

// RG: groups of 16 query rows per block (1 or 4).
template <typename T, int HD, int RG>
struct Paged {
  using H = typename attn::Operand<T>::H;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int QS = 2, KS = kF32 ? 2 : 1, STAGES = kF32 ? 1 : 2;
  using Core = attn::Core<H, HD, QS, KS, 2>;
  static constexpr int SPLIT = Core::SPLIT, DC = Core::DC;
  static constexpr int THREADS = RG * SPLIT * 32, ROWS = RG * attn::kWarpRows;
  static constexpr int STR = attn::row_stride<HD>(), BK = attn::kv_tile<HD>();
  static constexpr size_t kSmem = attn::smem_bytes<HD>(ROWS, QS, KS, STAGES);
};

template <typename T, int HD, int RG>
__global__ void __launch_bounds__(Paged<T, HD, RG>::THREADS, 1) paged_flash_fwd_kernel(
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
  using K = Paged<T, HD, RG>;
  using H = typename K::H;
  using Core = typename K::Core;
  constexpr int STR = K::STR, BK = K::BK, ROWS = K::ROWS, KS = K::KS;
  constexpr int kPart = BK * STR;           // one part of a staged K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  H* q_s = reinterpret_cast<H*>(smem_raw);  // QS x ROWS x STR
  H* kv_s = q_s + K::QS * ROWS * STR;       // STAGES x (K, V) x KS parts
  float* xs = reinterpret_cast<float*>(kv_s + K::STAGES * 2 * KS * kPart);
  __shared__ int q_range[2];

  const int rows = c * g, r0 = blockIdx.x * ROWS, split = blockIdx.y;
  const int b = blockIdx.z / kv, kvh = blockIdx.z - b * kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp % RG, half = warp / RG;   // row group, column half
  const int* pos = positions + (size_t)b * c;
  const int* trow = table + (size_t)b * n_logical;
  const int start = pos[0];
  const size_t bk = (size_t)blockIdx.z;

  // the split's running pages, as logical key positions [key_lo, key_end)
  const int page_lo = split * pages_per_split;
  const int page_hi = min(min(page_lo + pages_per_split, n_logical),
                          (start + c - 1) / ps + 1);
  int run_lo = page_lo;
  if (window > 0) {
    const int floor_key = start - window + 2 - ps;
    if (floor_key > 0) run_lo = max(run_lo, (floor_key + ps - 1) / ps);
  }
  int key_lo = run_lo * ps, key_end = page_hi * ps;

  // the tile's query rows (f32 q split into hi / lo) and their positions
  if (threadIdx.x == 0) {
    q_range[0] = INT_MAX;
    q_range[1] = INT_MIN;
  }
  const int r_last = min(r0 + ROWS, rows) - 1;
  attn::stage<HD, K::THREADS, ROWS>(q_s, ROWS * STR, q + bk * rows * hd, hd, 0,
                                    hd, [&](int j) { return r0 + j < rows ? r0 + j : -1; });
  __syncthreads();
  for (int t = r0 / g + threadIdx.x; t <= r_last / g; t += K::THREADS) {
    atomicMin(&q_range[0], pos[t]);
    atomicMax(&q_range[1], pos[t]);
  }
  __syncthreads();
  const int qmin = q_range[0], qmax = q_range[1];
  if (key_lo < key_end && key_lo <= qmin &&
      (window <= 0 || qmax - window + 2 <= key_end)) {
    // every row sees a key of the split: keys no row sees add exactly 0
    if (window > 0) key_lo = max(key_lo, qmin - window + 1);
    key_end = min(key_end, qmax + 1);
  }
  const int n_tiles = key_lo < key_end ? (key_end - key_lo + BK - 1) / BK : 0;

  attn::Mask mask;
  const int wrow = r0 + rg * attn::kWarpRows + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + 8 * h;
    mask.qpos[h] = r < rows ? pos[r / g] : qmax;
  }
  mask.warp_range();
  mask.key_end = key_end;
  mask.window = window;
  mask.causal = true;

  auto load = [&](int t, int st) {
    H* kd = kv_s + st * 2 * KS * kPart;
    const int k0 = key_lo + t * BK;
    auto row = [&](int j) {                    // pool row (page, slot)
      const int kp = k0 + j;
      if (kp >= key_end) return -1;
      const int page = kp / ps;
      return trow[page] * ps + (kp - page * ps);
    };
    attn::stage<HD, K::THREADS, BK>(kd, kPart, k_pool, kv * hd, kvh * hd, hd, row);
    attn::stage<HD, K::THREADS, BK>(kd + KS * kPart, kPart, v_pool, kv * hd,
                                    kvh * hd, hd, row);
  };

  Core core;
  core.init();
  const bool active = r0 + rg * attn::kWarpRows < rows;   // the pair alike
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % K::STAGES;
    if (K::STAGES == 1 || t == 0) load(t, st);
    attn::cp_async_commit();
    if (K::STAGES == 2 && t + 1 < n_tiles) {
      load(t + 1, (t + 1) % 2);                // overlaps this tile's products
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const H* kd = kv_s + st * 2 * KS * kPart;
      mask.key0 = key_lo + t * BK;
      core.step(q_s + rg * attn::kWarpRows * STR, ROWS * STR, kd,
                kd + KS * kPart + half * K::DC, kPart, scale, mask, half,
                xs + rg * 2 * Core::kExchange, 1 + rg);
    }
    __syncthreads();                           // the stage is consumed
  }
  core.finish();

  const size_t out_row0 = (bk * n_splits + split) * rows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + 8 * h;
    if (r >= rows) continue;
    const size_t o = out_row0 + r;
    if ((lane & 3) == 0 && half == 0) {
      m_out[o] = core.m[h];
      l_out[o] = core.l[h];
    }
#pragma unroll
    for (int d = 0; d < K::DC / 8; ++d) {
      const int col = half * K::DC + d * 8 + (lane & 3) * 2;
      if (col < hd)
        *reinterpret_cast<float2*>(acc_out + o * hd + col) =
            make_float2(core.acc[d][2 * h], core.acc[d][2 * h + 1]);
    }
  }
}

template <typename T, int HD, int RG>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* positions, void* acc, void* m,
           void* l, int b, int kv, int c, int g, int hd, int ps,
           int n_logical, int n_splits, int window, float scale,
           cudaStream_t stream) {
  using K = Paged<T, HD, RG>;
  auto kernel = paged_flash_fwd_kernel<T, HD, RG>;
  if (K::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const int pages_per_split = (n_logical + n_splits - 1) / n_splits;
  dim3 grid((c * g + K::ROWS - 1) / K::ROWS, n_splits, b * kv);
  kernel<<<grid, K::THREADS, K::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(positions), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), kv, c, g, hd, ps,
      n_logical, n_splits, pages_per_split, window, scale);
  return (int)cudaGetLastError();
}

#define PAGED_ARGS q, k_pool, v_pool, table, positions, acc, m, l, b, kv, c, g, \
                   hd, ps, n_logical, n_splits, window, scale, stream

template <typename T, int HD>
int dispatch_rows(const void* q, const void* k_pool, const void* v_pool,
                  const void* table, const void* positions, void* acc, void* m,
                  void* l, int b, int kv, int c, int g, int hd, int ps,
                  int n_logical, int n_splits, int window, float scale,
                  cudaStream_t stream) {
  if (c * g <= attn::kWarpRows) return launch<T, HD, 1>(PAGED_ARGS);
  return launch<T, HD, 4>(PAGED_ARGS);
}

template <typename T>
int dispatch_hd(const void* q, const void* k_pool, const void* v_pool,
                const void* table, const void* positions, void* acc, void* m,
                void* l, int b, int kv, int c, int g, int hd, int ps,
                int n_logical, int n_splits, int window, float scale,
                cudaStream_t stream) {
  switch (attn::padded_hd(hd)) {
    case 16: return dispatch_rows<T, 16>(PAGED_ARGS);
    case 32: return dispatch_rows<T, 32>(PAGED_ARGS);
    case 64: return dispatch_rows<T, 64>(PAGED_ARGS);
    case 128: return dispatch_rows<T, 128>(PAGED_ARGS);
    default: return dispatch_rows<T, 256>(PAGED_ARGS);
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory the kernel takes at head_dim hd (any page
// size: a kv tile holds keys, not pages).
size_t paged_flash_fwd_smem_bytes(int ps, int hd) {
  (void)ps;
  switch (attn::padded_hd(hd)) {
    case 16: return Paged<float, 16, 4>::kSmem;
    case 32: return Paged<float, 32, 4>::kSmem;
    case 64: return Paged<float, 64, 4>::kSmem;
    case 128: return Paged<float, 128, 4>::kSmem;
    default: return Paged<float, 256, 4>::kSmem;
  }
}

// pool_dtype: 0 = f32, 1 = bf16, 2 = f16. window <= 0 means no window.
// hd: a multiple of 8, at most 256.
int paged_flash_fwd(const void* q, const void* k_pool, const void* v_pool,
                    int pool_dtype, const void* table, const void* positions,
                    void* acc, void* m, void* l, int b, int kv, int c, int g,
                    int hd, int ps, int n_logical, int n_splits, int window,
                    float scale, void* stream) {
  if (hd % 8 || hd > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_CALL(T) dispatch_hd<T>(q, k_pool, v_pool, table, positions, acc, \
    m, l, b, kv, c, g, hd, ps, n_logical, n_splits, window, scale, s)
  switch (pool_dtype) {
    case 0: return PAGED_CALL(float);
    case 1: return PAGED_CALL(__nv_bfloat16);
    case 2: return PAGED_CALL(__half);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PAGED_CALL
}

}  // extern "C"
