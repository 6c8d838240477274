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
//   * the scale multiplies the f32 dot product and every sum is f32;
//   * kv tiles wholly above the diagonal (causal) or wholly below the
//     window are skipped: their keys are masked for every row of the tile,
//     so skipping them leaves the output as it is.
//
// Bound on an H100 SXM (3.35 TB/s HBM; 989 TFLOP/s bf16 on the tensor
// cores): q, k, v and o are moved once, and the products are 4 * hd flops
// per unmasked (query, key) pair. At S = 2048-4096 the flops are the larger
// term by 5-50x.
//
// Design, on the tile core of attn_tile.cuh: one thread block per (64-row
// q tile, q head), heaviest causal tiles first; a warp owns 16 rows. K and
// V tiles (64 keys, 32 at hd 256) are staged by cp.async in a ring of two
// stages; rows past S are zero-filled and their keys get -inf. bf16 and
// f16 inputs go to the tensor cores as they are (q and K are exact; P is
// rounded once to the input type, as in SDPA's flash backend, within the
// output's rounding). f32 inputs are split into bf16 hi and lo parts,
// staged by plain loads in one stage, and each product is hi*hi + hi*lo +
// lo*hi (2^-16 relative); at hd 256 a warp pair then shares 16 rows.
//
// Built with nvcc into a shared library with a plain C interface; the entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "attn_tile.cuh"

namespace {

template <typename T, int HD>
struct Flash {
  using H = typename attn::Operand<T>::H;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int PARTS = kF32 ? 2 : 1, STAGES = kF32 ? 1 : 2;
  using Core = attn::Core<H, HD, PARTS, PARTS, PARTS>;
  static constexpr int RG = 4, SPLIT = Core::SPLIT, DC = Core::DC;
  static constexpr int THREADS = RG * SPLIT * 32, ROWS = RG * attn::kWarpRows;
  static constexpr int STR = attn::row_stride<HD>(), BK = attn::kv_tile<HD>();
  static constexpr size_t kSmem = attn::smem_bytes<HD>(ROWS, PARTS, PARTS, STAGES);
};

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ void store2<__half>(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

template <typename T, int HD>
__global__ void __launch_bounds__(Flash<T, HD>::THREADS, 1) flash_fwd_kernel(
    const T* __restrict__ q,              // (BH, S, hd)
    const T* __restrict__ k,              // (BKV, S, hd)
    const T* __restrict__ v,
    T* __restrict__ o,                    // (BH, S, hd)
    int s_len, int hd, int group, int causal, int window, float scale) {
  using K = Flash<T, HD>;
  using H = typename K::H;
  constexpr int STR = K::STR, BK = K::BK, ROWS = K::ROWS, PARTS = K::PARTS;
  using Core = typename K::Core;
  constexpr int kPart = BK * STR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  H* q_s = reinterpret_cast<H*>(smem_raw);  // PARTS x ROWS x STR
  H* kv_s = q_s + PARTS * ROWS * STR;       // STAGES x (K, V) x PARTS
  float* xs = reinterpret_cast<float*>(kv_s + K::STAGES * 2 * PARTS * kPart);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;   // long rows first
  const int head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp % K::RG, half = warp / K::RG;   // row group, column half
  const size_t qoff = (size_t)head * s_len * hd;
  const size_t kvoff = (size_t)(head / group) * s_len * hd;
  const int q_rows = min(ROWS, s_len - q0);

  attn::stage<HD, K::THREADS, ROWS>(q_s, ROWS * STR, q + qoff, hd, 0, hd,
                                    [&](int j) { return j < q_rows ? q0 + j : -1; });

  // kv tiles that hold a key some row of the tile may see
  const int key_end = causal ? q0 + q_rows : s_len;
  const int key_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_tiles = (key_end - key_lo + BK - 1) / BK;

  attn::Mask mask;
  const int wrow = q0 + rg * attn::kWarpRows + (lane >> 2);
  mask.qpos[0] = wrow;
  mask.qpos[1] = wrow + 8;
  mask.warp_range();
  mask.key_end = s_len;
  mask.window = window;
  mask.causal = causal != 0;

  auto load = [&](int t, int st) {
    H* kd = kv_s + st * 2 * PARTS * kPart;
    const int k0 = key_lo + t * BK;
    auto row = [&](int j) { return k0 + j < s_len ? k0 + j : -1; };
    attn::stage<HD, K::THREADS, BK>(kd, kPart, k + kvoff, hd, 0, hd, row);
    attn::stage<HD, K::THREADS, BK>(kd + PARTS * kPart, kPart, v + kvoff, hd, 0,
                                    hd, row);
  };

  Core core;
  core.init();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % K::STAGES;
    if (K::STAGES == 1 || t == 0) load(t, st);
    attn::cp_async_commit();                   // with tile 0: the q tile
    if (K::STAGES == 2 && t + 1 < n_tiles) {
      load(t + 1, (t + 1) % 2);                // overlaps this tile's products
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    const H* kd = kv_s + st * 2 * PARTS * kPart;
    mask.key0 = key_lo + t * BK;
    core.step(q_s + rg * attn::kWarpRows * STR, ROWS * STR, kd,
              kd + PARTS * kPart + half * K::DC, kPart, scale, mask, half,
              xs + rg * 2 * Core::kExchange, 1 + rg);
    __syncthreads();                           // the stage is consumed
  }
  core.finish();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + 8 * h;
    if (row >= s_len) continue;
    const float inv_l = 1.f / fmaxf(core.l[h], 1e-30f);
    T* orow = o + qoff + (size_t)row * hd;
#pragma unroll
    for (int d = 0; d < K::DC / 8; ++d) {
      const int col = half * K::DC + d * 8 + (lane & 3) * 2;
      if (col < hd) store2<T>(orow + col, core.acc[d][2 * h] * inv_l,
                              core.acc[d][2 * h + 1] * inv_l);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s_len, int hd, int group, int causal, int window, float scale,
           cudaStream_t stream) {
  using K = Flash<T, HD>;
  auto kernel = flash_fwd_kernel<T, HD>;
  if (K::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((s_len + K::ROWS - 1) / K::ROWS, bh);
  kernel<<<grid, K::THREADS, K::kSmem, stream>>>(
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
  switch (attn::padded_hd(hd)) {
    case 16: return launch<T, 16>(FLASH_ARGS);
    case 32: return launch<T, 32>(FLASH_ARGS);
    case 64: return launch<T, 64>(FLASH_ARGS);
    case 128: return launch<T, 128>(FLASH_ARGS);
    default: return launch<T, 256>(FLASH_ARGS);
  }
#undef FLASH_ARGS
}

}  // namespace

extern "C" {

// Largest dynamic shared memory the kernel takes at head_dim ``hd`` (the
// f32 inputs' hi / lo tiles).
size_t flash_attention_fwd_smem_bytes(int hd) {
  switch (attn::padded_hd(hd)) {
    case 16: return Flash<float, 16>::kSmem;
    case 32: return Flash<float, 32>::kSmem;
    case 64: return Flash<float, 64>::kSmem;
    case 128: return Flash<float, 128>::kSmem;
    default: return Flash<float, 256>::kSmem;
  }
}

// dtype: 0 = f32, 1 = bf16, 2 = f16 (q, k, v and o share it). causal: 0/1.
// window <= 0 means no window. hd: a multiple of 8, at most 256.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int bh, int s_len, int hd, int group,
                        int causal, int window, float scale, void* stream) {
  if (hd % 8 || hd > 256) return (int)cudaErrorInvalidValue;
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
