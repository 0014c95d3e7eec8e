// Row-grouped block-sparse SpMM for Hopper (sm_90a):
//
//     y[n_pad, C] = alpha * (L @ x) + p_plus - p_minus [+ gm @ kron(I, wt)]
//
// L is stored as `blocks` [nb, 128, 128] plus the row-grouped view
// `g_idx` [nR, G] (index into blocks; nb marks a padded slot) and `g_bcol`
// [nR * G] (column block of each slot). x is [n_pad_cols, C] and may have
// more rows than y (rectangular operators). Three modes:
//
//   FP32   fp32 blocks, x, seeds and y; IEEE fp32 FMAs, no TF32.
//   BF16X3 fp32 storage; both operands rounded to a bf16 `hi` and a bf16
//          residual `lo` (round to nearest even), hi*hi + hi*lo + lo*hi
//          accumulated in fp32 (each product of two bf16 values is exact
//          in fp32).
//   BF16   bf16 blocks, x, seeds and y (compute_dtype=bfloat16). Each
//          value is widened to fp32 when it is staged, every product is
//          exact in fp32, the sum is fp32, alpha and the seeds are applied
//          in fp32 (alpha * acc + p_plus - p_minus, in that order), and
//          each output is rounded to bf16 once.
//
// Lazy seed (FP32 and BF16): given gm [n_pad, C] and wt [f, f] (f | 128,
// f | C), the seed c[r, i*f + o] = sum_e gm[r, i*f + e] * wt[e, o] (the
// backward's mix cotangent g @ W_j^T of batch item i) is computed here in
// fp32 from the stored values and added after p_minus, before the one
// rounding, so no c_j is written to or read back from HBM.
//
// Replaces the TPU kernels launched by meshvae_tpu/ops/pallas_cheb.py
// `_grouped_matmul`: `_make_multirow_kernel` / `_make_grouped_kernel`
// (:395-459) with f32 blocks (FP32) and with bf16 blocks and a bf16 output
// (BF16; `_bsr_matmul_impl` picks that output dtype at :682-688), and
// `_make_multirow_kernel_bf16x3` / `_make_grouped_kernel_bf16x3` (BF16X3);
// the lazy seed replaces `_seed_dot_fn` (:161-177), the plus_fn that
// `_make_grouped_kernel` (:406-410), `_make_spmm_kernel` and
// `_make_colmajor_kernel` run on `t_plus_dot`. On rows wider than 8
// column blocks it also replaces the per-block `_make_spmm_kernel` (:180)
// and the column-major `_make_colmajor_kernel` (:208, via
// `_colmajor_matmul`), which the pool backward runs on P^T: that kernel
// keeps the whole [n_pad, panel] output resident in VMEM while blocks
// stream in column order; here each CTA owns
// its output tile and loops over the row's G slots (any G: 25 on the 80k
// template's finest P^T), so every output is written once and no CTA needs
// another's partial sums. With bf16 blocks #5 and #7 round their output
// block after every slot; this kernel rounds once, as `_make_grouped_kernel`
// does.
//
// What bounds it: the occupied blocks plus x, the seeds and y are the
// bytes a call must move (5-40 MB at the 5k serving shapes; at the 80k
// template's level 0 in BF16, C = 512: 122 MB of blocks and 83 MB for each
// of x, a seed and y), far below the card's operation rate at C <= 1024,
// so the floor is HBM bytes. But this kernel runs every FMA of each dense
// 128x128 block on the CUDA cores (the blocks are ~1.5% nonzero), so the
// FMAs (three per pair in BF16X3) and the latency of staging each K chunk
// set its time, tens of times the byte floor. The lazy seed reads gm in
// place of a c_j of the same size and adds f / (128 G) of the block FMAs
// (an f-deep product per output).
//
// Design: one CTA per (64-row half of an output row-block, 64-column tile);
// it walks the row's G slots through g_idx, stages 16-deep K chunks of the
// block and the matching x rows in shared memory as fp32 (split into hi/lo
// there in BF16X3, widened from bf16 in BF16, so each element is converted
// once), accumulates 4x4 outputs per thread in registers, applies alpha
// and the seeds, and writes each output once (bsr_tile.cuh). Padded slots
// are skipped and the padded [nR, G, 128, 128] gather is never
// materialised. The lazy seed is computed before the block product and
// parked in shared memory until the epilogue, so the block product keeps
// a plain call's registers (and its occupancy). For f < 64 the tile holds
// 64 / f whole batch items: its gm tile (transposed) and wt are staged in
// shared memory once, and each thread sums its 4 x 4 outputs over the f
// features of their item, so the block-diagonal zeros of kron(I, wt) are
// never multiplied. For f >= 64 an item covers the tile: the CTA reads the
// item's full f columns of gm for its rows (an item that spans two tiles
// at f = 128 is read by both) and runs the f-deep product with wt's column
// slice through the same shared tiles as the block product.
// Tensor-core MMAs (mma.sync / wgmma on the bf16 operands), TMA and a
// pipelined ring of tiles are later work.

#include "bsr_tile.cuh"

namespace {

using namespace bsr;

// DOT: the lazy seed is wanted (gm and wt non-null), a separate
// instantiation so the plain calls keep their registers
template <typename T, bool SPLIT, bool DOT>
__global__ void __launch_bounds__(THREADS)
bsr_grouped_spmm_kernel(const T* __restrict__ blocks,
                        const int* __restrict__ g_idx,
                        const int* __restrict__ g_bcol,
                        const T* __restrict__ x,
                        const T* __restrict__ p_plus,
                        const T* __restrict__ p_minus,
                        const T* __restrict__ gm,
                        const T* __restrict__ wt,
                        T* __restrict__ y,
                        int nb, int g, int n_col_blocks, int c, int f,
                        float alpha) {
  __shared__ __align__(16) Tiles<SPLIT> tiles;
  const Coords q = coords(threadIdx.x);
  const int col0 = blockIdx.x * BN;
  const int row_block = blockIdx.y / (BLOCK / BM);
  const int m0 = (blockIdx.y % (BLOCK / BM)) * BM;

  // lazy seed first: seed[r][n] = sum_e gm[r, item(n) * f + e] wt[e, n % f]
  // on the tile's rows and columns, e in order (fp32 FMAs of the widened
  // values), parked in shared memory (gs, each thread's own 4 x 4) so the
  // block product below runs with the registers of a plain call
  __shared__ __align__(16) float gs[DOT ? BN : 1][APAD];
  if constexpr (DOT) {
    float seed[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) seed[i][j] = 0.f;
    if (f >= BN) {
      // an item covers the tile's 64 columns: a dense f-deep product of
      // the item's gm columns with wt's 64-column slice, through the
      // shared tiles chunk by chunk
      const int kbase = (col0 / f) * f;
      const T* grow =
          gm + (size_t)(row_block * BLOCK + m0 + q.a_row) * c + kbase;
      const T* wrow = wt + (size_t)q.b_k * f + (col0 - kbase) + q.b_col;
      for (int k0 = 0; k0 < f; k0 += BK) {
        const T* w4 = wrow + (size_t)k0 * f;
        fma_chunk<SPLIT>(tiles, q, load4(grow + k0 + q.a_k),
                         make_float4(load1(w4), load1(w4 + 1), load1(w4 + 2),
                                     load1(w4 + 3)), seed);
      }
    } else {
      // 64 / f whole items per tile: stage the tile's gm (transposed) and
      // wt once; each thread runs the f-deep sums of its 4 x 4 outputs
      __shared__ float ws[(BN / 2) * (BN / 2)];
      for (int i = threadIdx.x; i < BM * BN / 4; i += THREADS) {
        const int r = i / (BN / 4), k4 = (i % (BN / 4)) * 4;
        const float4 v = load4(gm + (size_t)(row_block * BLOCK + m0 + r) * c
                               + col0 + k4);
        gs[k4][r] = v.x; gs[k4 + 1][r] = v.y;
        gs[k4 + 2][r] = v.z; gs[k4 + 3][r] = v.w;
      }
      for (int i = threadIdx.x; i < f * f; i += THREADS) ws[i] = load1(wt + i);
      __syncthreads();
      int base[4], o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = q.tx * 4 + j;
        o[j] = n % f;
        base[j] = n - o[j];
      }
      for (int e = 0; e < f; ++e) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 a =
              *reinterpret_cast<const float4*>(&gs[base[j] + e][q.ty * 4]);
          const float w = ws[e * f + o[j]];
          seed[0][j] = fmaf(a.x, w, seed[0][j]);
          seed[1][j] = fmaf(a.y, w, seed[1][j]);
          seed[2][j] = fmaf(a.z, w, seed[2][j]);
          seed[3][j] = fmaf(a.w, w, seed[3][j]);
        }
      }
    }
    __syncthreads();  // every thread is done reading gs
#pragma unroll
    for (int i = 0; i < 4; ++i)
      store4(&gs[q.ty * 4 + i][q.tx * 4],
             make_float4(seed[i][0], seed[i][1], seed[i][2], seed[i][3]));
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  spmm_tile<T, SPLIT>(tiles, q, blocks, g_idx, g_bcol, x, nb, g,
                      n_col_blocks, c, row_block, m0, col0, acc);

  // epilogue: alpha, seeds (fp32), one write (one rounding) per output
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t off = (size_t)(row_block * BLOCK + m0 + q.ty * 4 + i) * c
                       + col0 + q.tx * 4;
    float4 out = make_float4(alpha * acc[i][0], alpha * acc[i][1],
                             alpha * acc[i][2], alpha * acc[i][3]);
    if (p_plus != nullptr) {
      const float4 p = load4(p_plus + off);
      out.x += p.x; out.y += p.y; out.z += p.z; out.w += p.w;
    }
    if (p_minus != nullptr) {
      const float4 p = load4(p_minus + off);
      out.x -= p.x; out.y -= p.y; out.z -= p.z; out.w -= p.w;
    }
    if constexpr (DOT) {  // this thread's own seed values, from gs
      const float4 p = *reinterpret_cast<const float4*>(
          &gs[q.ty * 4 + i][q.tx * 4]);
      out.x += p.x; out.y += p.y; out.z += p.z; out.w += p.w;
    }
    store4(y + off, out);
  }
}

template <typename T, bool SPLIT, bool DOT>
void launch_one(const void* blocks, const int* g_idx, const int* g_bcol,
                const void* x, const void* p_plus, const void* p_minus,
                const void* gm, const void* wt, void* y, int nb, int n_rows,
                int g, int n_col_blocks, int c, int f, float alpha,
                cudaStream_t st) {
  const dim3 grid(c / BN, n_rows * (BLOCK / BM));
  bsr_grouped_spmm_kernel<T, SPLIT, DOT><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(blocks), g_idx, g_bcol,
      static_cast<const T*>(x), static_cast<const T*>(p_plus),
      static_cast<const T*>(p_minus), static_cast<const T*>(gm),
      static_cast<const T*>(wt), static_cast<T*>(y), nb, g, n_col_blocks, c,
      f, alpha);
}

template <typename T, bool SPLIT>
void launch(const void* blocks, const int* g_idx, const int* g_bcol,
            const void* x, const void* p_plus, const void* p_minus,
            const void* gm, const void* wt, void* y, int nb, int n_rows,
            int g, int n_col_blocks, int c, int f, float alpha,
            cudaStream_t st) {
  if constexpr (SPLIT) {
    launch_one<T, true, false>(blocks, g_idx, g_bcol, x, p_plus, p_minus,
                               gm, wt, y, nb, n_rows, g, n_col_blocks, c, f,
                               alpha, st);
  } else if (gm != nullptr) {
    launch_one<T, false, true>(blocks, g_idx, g_bcol, x, p_plus, p_minus,
                               gm, wt, y, nb, n_rows, g, n_col_blocks, c, f,
                               alpha, st);
  } else {
    launch_one<T, false, false>(blocks, g_idx, g_bcol, x, p_plus, p_minus,
                                gm, wt, y, nb, n_rows, g, n_col_blocks, c, f,
                                alpha, st);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). `mode` is 0 = FP32,
// 1 = BF16X3 (fp32 storage), 2 = BF16 (bf16 blocks, x, seeds and y).
// Shapes, dtypes and alignment are checked by the Python wrapper:
// c % 64 == 0, every pointer 16-byte aligned, y, the seeds and gm
// [n_rows * 128, c], x [n_col_blocks * 128, c], wt [f, f] with 128 % f == 0
// and c % f == 0. gm and wt are null unless the lazy seed is wanted, which
// BF16X3 does not take. Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int bsr_grouped_spmm(const void* blocks, const int* g_idx,
                                const int* g_bcol, const void* x,
                                const void* p_plus, const void* p_minus,
                                const void* gm, const void* wt, void* y,
                                int nb, int n_rows, int g, int n_col_blocks,
                                int c, int f, float alpha, int mode,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((gm == nullptr) != (wt == nullptr)
      || (gm != nullptr && (mode == 1 || f <= 0 || BLOCK % f || c % f)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case 0:
      launch<float, false>(blocks, g_idx, g_bcol, x, p_plus, p_minus, gm, wt,
                           y, nb, n_rows, g, n_col_blocks, c, f, alpha, st);
      break;
    case 1:
      launch<float, true>(blocks, g_idx, g_bcol, x, p_plus, p_minus, gm, wt,
                          y, nb, n_rows, g, n_col_blocks, c, f, alpha, st);
      break;
    case 2:
      launch<__nv_bfloat16, false>(blocks, g_idx, g_bcol, x, p_plus, p_minus,
                                   gm, wt, y, nb, n_rows, g, n_col_blocks, c,
                                   f, alpha, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
