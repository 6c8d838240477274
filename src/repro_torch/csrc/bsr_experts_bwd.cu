// The backward of the expert axis of the BlockCSR spmm on Hopper (sm_90a):
// E stacked matrices W_e (N, K) (an MoE layer's compressed experts, (E,
// out, in)), each product over the rows its expert holds, one launch each.
//
// Replaces, for a stack of experts, the Pallas TPU kernels
//   repro/kernels/bsr_spmm/bsr_spmm.py:163 gather_block_matmul
//       (transpose_block=False over the transposed tables, as called by
//       ops.spmm_t: dX)
//   repro/kernels/bsr_sddmm/bsr_sddmm.py:44 sddmm_block_grad
//       (as called by ops.bsr_weight_grad: dW at the resident slots)
// that the reference's VJP of its MoE FFN reaches once per expert under
// lax.map (repro/models/moe.py:256-259, repro/sparse/ops.py:87-93).
//
// * bsr_experts_dx (ops.spmm_t_experts): dX[e] (M, K) f32 = dY[e] (M, N) @
//   W_e over the block-CSC tables: block-column c of dX sums dY[:, t_idx[c,
//   j] br : +br] @ B(t_blk[c, j]) over j < t_nnz[c].
// * bsr_experts_dw (ops.bsr_weight_grad_experts): dW[e][s] (br, bc) f32 =
//   dY[e][:, r_s br : +br]' @ X[e][:, c_s bc : +bc] at every valid slot s;
//   the pad slot, the slots the compression pads each expert with, and an
//   expert without tokens get exact zeros.
//
// rows[e] (an (E,) int32 tensor on the card, read by the kernels: no host
// sync; null: every row) is the count of tokens the MoE dispatch gave
// expert e. Past it the rows of dY are zero in training (the combine never
// reads those rows of the expert output, so their cotangent is zero, and
// so is every dX there that feeds another expert projection) and so are
// the rows of X (the dispatch buffer, and f(0) * 0 after it): those rows
// add nothing to dW, and their dX is zero. So dX is computed on rows [0,
// rows[e]) and written as zeros below, and dW sums rows [0, rows[e]) only;
// an expert with no token writes its zeros and reads none of its tables or
// blocks. The plain versions (bsr_spmm/ref.py::spmm_experts_bwd_ref,
// bsr_sddmm/ops.py::bsr_weight_grad_experts_ref) take rows alike.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 x bf16 on the tensor
// cores, 67 TFLOP/s with an f32 operand): bytes. At olmoe-1b-7b's ewi (64
// experts of (1024, 2048), (8, 128) blocks at 0.9, about 205 resident
// blocks an expert), M = 80, bf16 dY, X and store: dX writes 41.9 MB of
// f32 and reads 26.9 MB of blocks and 10.5 MB of dY (0.023 ms); dW writes
// 53.7 MB of f32 and reads 21 MB of X and 10.5 MB of dY (0.025 ms). The
// products are 0.4 GFLOP each. What a design has to avoid at these shapes
// (the kernels of bsr_spmm.cu and bsr_sddmm.cu with the expert on the grid,
// which took 3x these bounds): thread blocks that each run one short chain
// of trips to memory (a column of ewi holds about 13 resident blocks, one
// 128-entry job), rows of an expert's buffer that hold no token, and
// operands staged again for each few rows, columns or slots.
//
// Both kernels take one thread block per block-column c of one expert (and
// 128-column chunk of bc): blockIdx.x the column (then its chunks),
// blockIdx.z the expert. So a column's blocks and X are read once for all
// its rows and slots, no thread block exists for rows or slots past the
// counts, and an expert without tokens is a grid of thread blocks that
// write zeros.
//
// bsr_experts_dx: W warps (a warp per m-tile of 16 rows, up to 8: every
// occupied row in one pass up to 128 rows), warp w the rows 16 w .. and
// all 128 columns (16 n-tiles, 64 f32 sums a thread). The column's table
// entries arrive in one trip into shared memory. A job is the next 32
// summed entries (32 / br resident blocks): their dY slab (rows x 32,
// column b br + e the column e of block-row t_idx[c, j0 + b]) and their
// block rows (32 x 128, row b br + e the row e of block t_blk[c, j0 + b])
// are copied (cp.async, or plain loads split into three bf16 parts for an
// f32 operand) into a ring of two stages, the next job's copies in flight
// behind this job's products (mma.sync m16n8k16 as bsr_tile.cuh's
// bwd_slab: A fragments from the dY slab, B fragments by the transposing
// ldmatrix from the block rows). Only the rows below rows[e] are copied
// (the last m-tile zero-filled past it), and a warp whose rows all lie past
// it runs no product and writes zeros. The sums stay in the accumulators
// along the column (at most jmax_t br entries).
//
// bsr_experts_dw: the block-tile core (bsr_tile.cuh), 4 warps: X[:rows, c
// bc + kc : +128] is staged once into shared memory for all the column's
// slots (about 13 at ewi, 26 at ewo), and the dY slabs of groups of 4 / NT
// slots stream through a ring of two stages behind it, the next group's
// copies (cp.async) in flight behind this group's products. Rows are
// staged and summed in k-steps of 16 up to rows[e] (the last one
// zero-filled past it); at most 128 rows a pass (64 with an f32 operand),
// more in passes, each 64 rows summed from zero and then added in f32. Warp
// w owns slot w / NT of a group and m-tiles (w % NT) 8 / NT .., all NT
// n-tiles of br <= 32 (dW(s)' = X' dY: m = columns of X, n = block rows).
// The zeros of the slots no column writes are folded into the column's
// thread blocks: block c zeroes the invalid slots among slots c S / C .. of
// its expert (every one of them for an expert without tokens), their flags
// read in one trip while the first copies are in flight. With 16-bit
// operands it is held to 128 registers, 4 thread blocks an SM (at 202
// registers, 2 an SM, it took 1.2x the time; PERF.md).
//
// Both: f32 operands go as three bf16 parts with bsr_tile.cuh's product
// rule; each output is written once, by one thread, in a fixed order (the
// tables' order along a column, the rows' along M), with no atomics: two
// runs are bit-equal, and expert e's slice equals an E = 1 call on it.
//
// What still holds them back (PERF.md, rows 1be / 4e;
// tools/expert_bwd_design.py): at olmoe's ewi, M = 80, bf16, dX takes 1.8x
// and dW 2.1x their bounds, and on the rows a router fills 1.8x and 2.1x.
// dX sits at 128 registers (64 sums a thread; 24 bytes spill), which hold
// it to 3 thread blocks (15 warps) an SM: at one thread block an SM it
// took 1.6x the time; jobs of 64 entries took 0.97x at M = 80 in bf16 but
// 1.2-1.3x at M = 8 and with f32 dY, jobs of 128 1.06-2.5x. dW reads X
// from shared memory again for every slot of the column, and a column's
// groups of slots run one after another behind one ring of two stages.
// With f32 dY the three parts triple the shared memory of each stage.
//
// Built with nvcc into a shared library with a plain C interface; each entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bsr_tile.cuh"

namespace {

using bsr::H;
using bsr::kK;
using bsr::kStr;
using F = tc::Half<H>;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;            // dW: warps a thread block

// ---------------------------------------------------------------------------
// dX
// ---------------------------------------------------------------------------

constexpr int kJob = 32;             // summed entries a job
constexpr int kJobStr = kJob + 8;    // row stride of a staged dY slab

// acc (16 n-tiles of 8 columns) += the warp's 16 rows of a staged dY slab
// (XS parts at a + p * apart, row stride kJobStr) times a staged block slab
// (WS parts at b + p * bpart, row stride kStr) over ksteps k-steps
// (bsr_tile.cuh::bwd_slab at one m-tile and this A stride).
template <int XS, int WS>
__device__ __forceinline__ void dx_slab(float (&acc)[16][4], const H* a, int apart, const H* b,
                                        int bpart, int ksteps) {
  const int lane = threadIdx.x & 31;
  const H* ya = a + (lane & 15) * kJobStr + (lane >> 4) * 8;
  const H* wb = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * kStr + (lane >> 4) * 8;
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t af[XS][4];
#pragma unroll
    for (int i = 0; i < XS; ++i) tc::ldsm_x4(af[i], ya + i * apart + kk * 16);
#pragma unroll
    for (int np = 0; np < 8; ++np)
#pragma unroll
      for (int j = 0; j < WS; ++j) {
        uint32_t bf[4];
        tc::ldsm_x4_t(bf, wb + j * bpart + kk * 16 * kStr + np * 16);
#pragma unroll
        for (int i = 0; i + j < bsr::order(XS, WS) && i < XS; ++i) {
          F::mma(acc[2 * np], af[i], bf[0], bf[1]);
          F::mma(acc[2 * np + 1], af[i], bf[2], bf[3]);
        }
      }
  }
}

template <typename TY, typename S>
__global__ void __launch_bounds__(256, 2)
bsr_experts_dx(const TY* __restrict__ dy, const S* __restrict__ data,
               const int* __restrict__ t_idx, const int* __restrict__ t_blk,
               const int* __restrict__ t_nnz, const int* __restrict__ rows,
               float* __restrict__ dx, int M, int N, int K, int C, int jmax_t, int br, int bc,
               long long store, int dy_vec, int w_vec, int dx_vec) {
  constexpr int XS = bsr::parts<TY>(), WS = bsr::parts<S>();
  const long long e = blockIdx.z;                  // expert e's problem
  dy += e * M * N;
  dx += e * M * K;
  t_idx += e * C * jmax_t;
  t_blk += e * C * jmax_t;
  t_nnz += e * C;
  data += e * store;
  const int n_kc = (bc + kK - 1) / kK;
  const int c = blockIdx.x / n_kc, kc = (blockIdx.x - c * n_kc) * kK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = 16 * (blockDim.x >> 5);            // rows a pass
  const int r = rows ? min(max(rows[e], 0), M) : M;
  const int passes = (r + R - 1) / R;              // 0 for an expert without tokens
  const int apart = R * kJobStr, bpart = kJob * kStr;
  const int stage = XS * apart + WS * bpart;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  H* const ring = reinterpret_cast<H*>(smem_raw);  // [2][XS][R][kJobStr], [WS][kJob][kStr]
  int* const tab = reinterpret_cast<int*>(ring + 2 * stage);  // [2][jmax_t]: block-rows, slots
  float acc[16][4];
  // the warp's 16 rows of pass p: acc as summed (zeros where nothing was),
  // lane: rows lane / 4 and + 8, columns 8 n + 2 (lane % 4) + {0, 1}
  auto write = [&](int p) {
    const int m0 = p * R + 16 * warp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + (lane >> 2) + 8 * h;
      if (row >= M) continue;
      float* const out = dx + (size_t)row * K + (size_t)c * bc;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int cb = kc + 8 * n + 2 * (lane & 3);
        if (dx_vec && cb < bc && c * bc + cb < K) {
          *reinterpret_cast<float2*>(out + cb) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
        } else {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (cb + q < bc && c * bc + cb + q < K) out[cb + q] = acc[n][2 * h + q];
        }
      }
    }
  };
  auto zero_acc = [&]() {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
  };
  zero_acc();
  int n_j = 0;
  if (passes > 0) {
    n_j = t_nnz[c];
    const int* const ti = t_idx + (size_t)c * jmax_t;
    const int* const tb = t_blk + (size_t)c * jmax_t;
    for (int j = threadIdx.x; j < n_j; j += blockDim.x) {
      tab[j] = ti[j];
      tab[jmax_t + j] = tb[j];
    }
    __syncthreads();
  }
  const int lg = 31 - __clz(br);
  const int jobs = (n_j * br + kJob - 1) / kJob;
  const int units = passes * jobs;
  // unit u = pass u / jobs, job u % jobs, into stage u & 1: dY rows past r
  // and entries past the column's count staged as zero
  auto issue = [&](int u) {
    const int p = u / jobs, q = u - p * jobs;
    const int row0 = p * R, j0 = q * (kJob >> lg);
    const int nb = min(kJob >> lg, n_j - j0);      // resident blocks of the job
    H* const st = ring + (u & 1) * stage;
    const int* const rws = tab + j0;
    const int* const sls = tab + jmax_t + j0;
    bsr::stage_at<XS>(st, kJobStr, apart, R, kJob / 8, dy_vec != 0, dy,
                      [=](int i, int k) -> const TY* {
                        const int b = k >> lg;
                        const int row = row0 + i;
                        if (b >= nb || row >= r) return nullptr;
                        const int col = rws[b] * br + (k & (br - 1));
                        return col < N ? dy + (size_t)row * N + col : nullptr;
                      });
    bsr::stage_at<WS>(st + XS * apart, kStr, bpart, kJob, kK / 8, w_vec != 0, data,
                      [=](int k, int col) -> const S* {
                        const int b = k >> lg;
                        if (b >= nb || kc + col >= bc) return nullptr;
                        return data + ((size_t)sls[b] * br + (k & (br - 1))) * bc + kc + col;
                      });
  };
  if (units > 0) issue(0);
  tc::cp_async_commit();
  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) issue(u + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();                  // unit u landed
    const int p = u / jobs, q = u - p * jobs;
    const H* const st = ring + (u & 1) * stage;
    if (p * R + 16 * warp < r)        // the warp's rows hold a token
      dx_slab<XS, WS>(acc, st + 16 * warp * kJobStr, apart, st + XS * apart, bpart,
                      (min(kJob, n_j * br - q * kJob) + 15) / 16);
    if (q == jobs - 1) {
      write(p);
      zero_acc();
    }
    __syncthreads();                  // stage u & 1 is free for unit u + 2
  }
  // the passes past the occupied rows (or a column without resident
  // blocks): zeros
  for (int p = jobs > 0 ? passes : 0; p * R < M; ++p) write(p);
}

template <typename TY, typename S>
int launch_dx(const void* dy, const void* data, const int* t_idx, const int* t_blk,
              const int* t_nnz, const int* rows, float* dx, int M, int N, int K, int C,
              int jmax_t, int br, int bc, int n_slots, int dy_vec, int w_vec, int dx_vec,
              int E, cudaStream_t st) {
  constexpr int XS = bsr::parts<TY>(), WS = bsr::parts<S>();
  // a warp per m-tile of the rows, up to 8 (128 rows a pass)
  const int warps = std::min(8, std::max(1, (M + 15) / 16));
  const int R = 16 * warps;
  const size_t smem = sizeof(H) * 2 * ((size_t)XS * R * kJobStr + (size_t)WS * kJob * kStr) +
                      sizeof(int) * 2 * (size_t)jmax_t;
  auto kern = bsr_experts_dx<TY, S>;
  static size_t opted = 48 * 1024;             // the limit raised so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const int n_kc = (bc + kK - 1) / kK;
  const dim3 grid(C * n_kc, 1, E);
  if (grid.x == 0 || M == 0) return 0;
  kern<<<grid, 32 * warps, smem, st>>>(
      static_cast<const TY*>(dy), static_cast<const S*>(data), t_idx, t_blk, t_nnz, rows, dx,
      M, N, K, C, jmax_t, br, bc, (long long)n_slots * br * bc, dy_vec, w_vec, dx_vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// dW
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int dy_cols(int nt) { return nt == 4 ? 32 : 16; }
__host__ __device__ constexpr int dy_stride(int nt) { return dy_cols(nt) + 8; }

// t += X' dY over ksteps k-steps of 16 staged rows: A fragments from the X
// rows at x (part stride xpart; the warp's MT m-tiles from column m0), B
// fragments from the dY rows at y (part stride ypart, row stride ys), both
// by the transposing ldmatrix; every 4 k-steps (64 rows) summed from zero
// and then added to acc in f32 (bsr_tile.cuh::sddmm_chunk, over a count
// of k-steps).
template <int MT, int NT, int XS, int YS>
__device__ __forceinline__ void dw_rows(float (&acc)[MT][NT][4], const H* x, int xpart, int m0,
                                        const H* y, int ypart, int ys, int ksteps) {
  const int lane = threadIdx.x & 31;
  const H* xa = x + ((lane & 7) + (lane >> 4) * 8) * kStr + m0 + ((lane >> 3) & 1) * 8;
  const H* yb = y + ((lane & 7) + ((lane >> 3) & 1) * 8) * ys + (lane >> 4) * 8;
  for (int k0 = 0; k0 < ksteps; k0 += 4) {
    float t[MT][NT][4];
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[a][n][e] = 0.f;
    const int k1 = min(ksteps, k0 + 4);
    for (int kk = k0; kk < k1; ++kk) {
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
        for (int i = 0; i < XS; ++i)
          tc::ldsm_x4_t(a[i], xa + i * xpart + kk * 16 * kStr + mt * 16);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < YS; ++j)
#pragma unroll
            for (int i = 0; i + j < bsr::order(XS, YS) && i < XS; ++i)
              F::mma(t[mt][n], a[i], b[j][n / 2][2 * (n & 1)], b[j][n / 2][2 * (n & 1) + 1]);
      }
    }
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] += t[a][n][e];
  }
}

// Thread block: block-column c (then its 128-column chunks) of expert
// blockIdx.z. A unit is (group q of SPB slots, pass p of R rows), in the
// order q, then p; unit u's dY slabs (and its X rows, when the occupied
// rows take more than one pass) arrive in stage u & 1 while unit u - 1's
// products run. x_bufs: X buffers the launch allocated (2 where M exceeds
// one pass).
template <int NT, typename TY, typename TX>
__global__ void __launch_bounds__(kWarps * 32, sizeof(TY) == 2 && sizeof(TX) == 2 ? 4 : 1)
bsr_experts_dw(const TY* __restrict__ dy, const TX* __restrict__ x,
               const int* __restrict__ t_idx, const int* __restrict__ t_blk,
               const int* __restrict__ t_nnz, const int* __restrict__ valid,
               const int* __restrict__ rows, float* __restrict__ out, int M, int N, int K, int C,
               int jmax_t, int br, int bc, int n_slots, int R, int x_bufs, int x_vec,
               int y_vec) {
  constexpr int XS = bsr::parts<TX>(), YS = bsr::parts<TY>();
  constexpr int SPB = kWarps / NT;                 // slots a group
  constexpr int MT = kK / 16 / NT;                 // m-tiles a warp
  constexpr int YSTR = dy_stride(NT);
  const long long e = blockIdx.z;                  // expert e's problem
  dy += e * M * N;
  x += e * M * K;
  t_idx += e * C * jmax_t;
  t_blk += e * C * jmax_t;
  t_nnz += e * C;
  valid += e * n_slots;
  out += e * n_slots * br * bc;
  const int n_kc = (bc + kK - 1) / kK;
  const int c = blockIdx.x / n_kc, kc = (blockIdx.x - c * n_kc) * kK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = rows ? min(max(rows[e], 0), M) : M;
  const size_t n_out = (size_t)br * bc;
  const int w_cols = min(kK, bc - kc);

  // the slots no column writes, among this block's share c S / C ..: the
  // pad slot and the padded slots (valid 0), or every slot of an expert
  // without tokens (valid not read); warp w takes slots w, w + 4, ..., its
  // lanes' flags of 32 of them loaded at once, and writes a slot's columns
  // kc .. with all its lanes
  auto zero_slots = [&]() {
    const int share = (n_slots + C - 1) / C;
    const int s0 = c * share, s_end = min(n_slots, s0 + share);
    for (int base = s0 + warp; base < s_end; base += 32 * kWarps) {
      const int mine = base + kWarps * lane;
      const int keep = r > 0 && mine < s_end ? valid[mine] : 0;
      for (int k = 0; k < 32 && base + kWarps * k < s_end; ++k) {
        if (__shfl_sync(kFull, keep, k)) continue;    // warp-uniform
        float* const o = out + (size_t)(base + kWarps * k) * n_out + kc;
        for (int i = lane; i < br * w_cols; i += 32) {
          const int row = i / w_cols;
          o[(size_t)row * bc + (i - row * w_cols)] = 0.f;
        }
      }
    }
  };
  if (r == 0) {
    zero_slots();
    return;
  }
  const int n_j = t_nnz[c];

  const int ks_all = (r + 15) / 16;               // k-steps of the occupied rows
  const int rk = R / 16;                           // k-steps a pass
  const int passes = (ks_all + rk - 1) / rk;
  const int units = (n_j + SPB - 1) / SPB * passes;
  const bool x_once = passes == 1;                 // X staged by unit 0 only
  const int xpart = R * kStr, xstage = XS * xpart;
  const int ypart = SPB * R * YSTR, ystage = YS * ypart;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  H* const xs = reinterpret_cast<H*>(smem_raw);    // [x_bufs][XS][R][kStr]
  H* const ys = xs + x_bufs * xstage;              // [2][YS][SPB][R][YSTR]
  const int* const ti = t_idx + (size_t)c * jmax_t;

  auto issue = [&](int u) {
    const int q = u / passes, p = u - q * passes;
    const int row0 = p * R, prow = min(rk, ks_all - p * rk) * 16;
    if (!x_once || u == 0)
      bsr::stage<XS>(xs + (x_once ? 0 : u & 1) * xstage, kStr, xpart, x, K, row0, prow, r,
                     c * bc + kc, min(K, c * bc + bc), kK / 8, x_vec != 0);
#pragma unroll
    for (int i = 0; i < SPB; ++i) {
      const int j = q * SPB + i;
      const bool live = j < n_j;
      const int brow = live ? ti[j] : 0;
      bsr::stage<YS>(ys + (u & 1) * ystage + i * R * YSTR, YSTR, ypart, dy, N, row0, prow, r,
                     brow * br, live ? min(N, brow * br + br) : 0, dy_cols(NT) / 8,
                     y_vec != 0);
    }
  };

  const int mg = warp % NT;
  float acc[MT][NT][4];
  if (units > 0) issue(0);
  tc::cp_async_commit();
  zero_slots();                       // while unit 0's copies are in flight
  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) issue(u + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();                  // unit u landed; every warp past unit u - 1
    const int q = u / passes, p = u - q * passes;
    const int my_j = q * SPB + warp / NT;
    const int s = my_j < n_j ? t_blk[(size_t)c * jmax_t + my_j] : 0;
    if (p == 0) {
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) acc[a][n][q4] = 0.f;
    }
    dw_rows<MT, NT, XS, YS>(acc, xs + (x_once ? 0 : u & 1) * xstage, xpart, mg * MT * 16,
                            ys + (u & 1) * ystage + (warp / NT) * R * YSTR, ypart, YSTR,
                            min(rk, ks_all - p * rk));
    if (p == passes - 1 && my_j < n_j) {
      // thread: X columns (m) lane / 4 and lane / 4 + 8 of each m-tile, dY
      // columns (n) 8n + 2 (lane % 4) + {0, 1}; dW[s] is (br, bc), so dW[n][m]
      float* const o = out + (size_t)s * n_out;
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = kc + (mg * MT + a) * 16 + (lane >> 2) + 8 * h;
          if (m >= bc) continue;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int col = n * 8 + (lane & 3) * 2 + e2;
              if (col < br) o[(size_t)col * bc + m] = acc[a][n][2 * h + e2];
            }
        }
    }
    __syncthreads();                  // stage u & 1 is free for unit u + 2
  }
}

template <int NT, typename TY, typename TX>
int launch_dw_t(const void* dy, const void* x, const int* t_idx, const int* t_blk,
                const int* t_nnz, const int* valid, const int* rows, float* out, int M, int N,
                int K, int C, int jmax_t, int n_slots, int br, int bc, int x_vec, int y_vec,
                int E, cudaStream_t st) {
  constexpr int XS = bsr::parts<TX>(), YS = bsr::parts<TY>();
  constexpr int SPB = kWarps / NT;
  // rows a pass: every row up to 128 (64 with an f32 operand, whose three
  // parts take three times the room); X double-buffered where one pass
  // cannot hold M
  const int m16 = std::max(16, (M + 15) / 16 * 16);
  const int R = std::min(m16, XS == 1 && YS == 1 ? 128 : 64);
  const int x_bufs = m16 > R ? 2 : 1;
  const size_t smem = sizeof(H) * ((size_t)x_bufs * XS * R * kStr +
                                   (size_t)2 * YS * SPB * R * dy_stride(NT));
  auto kern = bsr_experts_dw<NT, TY, TX>;
  static size_t opted = 48 * 1024;             // the limit raised so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const int n_kc = (bc + kK - 1) / kK;
  const dim3 grid(C * n_kc, 1, E);
  if (grid.x == 0) return 0;
  kern<<<grid, kWarps * 32, smem, st>>>(
      static_cast<const TY*>(dy), static_cast<const TX*>(x), t_idx, t_blk, t_nnz, valid, rows,
      out, M, N, K, C, jmax_t, br, bc, n_slots, R, x_bufs, x_vec, y_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename TY, typename TX>
int launch_dw(int br, const void* dy, const void* x, const int* t_idx, const int* t_blk,
              const int* t_nnz, const int* valid, const int* rows, float* out, int M, int N,
              int K, int C, int jmax_t, int n_slots, int bc, int x_vec, int y_vec, int E,
              cudaStream_t st) {
#define DW_ARGS dy, x, t_idx, t_blk, t_nnz, valid, rows, out, M, N, K, C, jmax_t, n_slots, \
                br, bc, x_vec, y_vec, E, st
  switch (bsr::n_tiles(br)) {
    case 1: return launch_dw_t<1, TY, TX>(DW_ARGS);
    case 2: return launch_dw_t<2, TY, TX>(DW_ARGS);
    case 4: return launch_dw_t<4, TY, TX>(DW_ARGS);
  }
#undef DW_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

bool block_rows_ok(int br) {
  return br == 1 || br == 2 || br == 4 || br == 8 || br == 16 || br == 32;
}

}  // namespace

extern "C" {

// dX (E, M, K) f32, dX[e] = dY[e] (M, N) @ W_e on rows [0, rows[e]) and zero
// below, for E stacked BlockCSR W_e (N, K) over the transposed tables
// t_idx/t_blk (E, C, jmax_t) int32 and t_nnz (E, C) int32: dY f32 or bf16,
// data f32 or bf16 (E, n_slots, br, bc); rows (E,) int32 on the card or
// null (every row); br one of 1, 2, 4, 8, 16, 32. dy_vec / w_vec: the rows
// of dY / of the store are 16-byte aligned and br / bc are multiples of 16
// bytes' worth; dx_vec: K and bc even.
int bsr_spmm_t_experts(const void* dy, int dy_is_bf16, const void* data, int data_is_bf16,
                       const int* t_idx, const int* t_blk, const int* t_nnz, const int* rows,
                       float* dx, int M, int N, int K, int C, int jmax_t, int br, int bc,
                       int dy_vec, int w_vec, int dx_vec, int E, int n_slots, void* stream) {
  if (!block_rows_ok(br) || bc < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (E < 1 || E > 65535 || (long long)n_slots * br * bc >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DX_ARGS dy, data, t_idx, t_blk, t_nnz, rows, dx, M, N, K, C, jmax_t, br, bc, n_slots, \
                dy_vec, w_vec, dx_vec, E, st
  if (dy_is_bf16)
    return data_is_bf16 ? launch_dx<__nv_bfloat16, __nv_bfloat16>(DX_ARGS)
                        : launch_dx<__nv_bfloat16, float>(DX_ARGS);
  return data_is_bf16 ? launch_dx<float, __nv_bfloat16>(DX_ARGS)
                      : launch_dx<float, float>(DX_ARGS);
#undef DX_ARGS
}

// out (E, n_slots, br, bc) f32 = per-slot dY_e' X_e over rows [0,
// rows[e]) for E stacked BlockCSR weights; dy (E, M, N) and x (E, M, K)
// f32 or bf16; t_idx / t_blk (E, C, jmax_t) and t_nnz (E, C) the
// block-CSC tables, valid (E, n_slots) int32, rows (E,) int32 on the card
// or null; br one of 1, 2, 4, 8, 16, 32, any bc (chunks of 128 columns of
// X). x_vec / y_vec: the rows of x / dy are 16-byte aligned (see
// bsr_tile.cuh).
int bsr_sddmm_experts(const void* dy, int dy_is_bf16, const void* x, int x_is_bf16,
                      const int* t_idx, const int* t_blk, const int* t_nnz, const int* valid,
                      const int* rows, float* out, int M, int N, int K, int C, int jmax_t,
                      int n_slots, int br, int bc, int x_vec, int y_vec, int E, void* stream) {
  if (!block_rows_ok(br) || bc < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (E < 1 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DW_ARGS br, dy, x, t_idx, t_blk, t_nnz, valid, rows, out, M, N, K, C, jmax_t, \
                n_slots, bc, x_vec, y_vec, E, st
  if (dy_is_bf16)
    return x_is_bf16 ? launch_dw<__nv_bfloat16, __nv_bfloat16>(DW_ARGS)
                     : launch_dw<__nv_bfloat16, float>(DW_ARGS);
  return x_is_bf16 ? launch_dw<float, __nv_bfloat16>(DW_ARGS)
                   : launch_dw<float, float>(DW_ARGS);
#undef DW_ARGS
}

}  // extern "C"
