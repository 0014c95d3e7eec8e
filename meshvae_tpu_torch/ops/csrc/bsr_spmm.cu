// Row-grouped block-sparse SpMM for Hopper (sm_90a):
//
//     y[n_pad, C] = alpha * (L @ x) + p_plus - p_minus
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
// Replaces the TPU kernels launched by meshvae_tpu/ops/pallas_cheb.py
// `_grouped_matmul`: `_make_multirow_kernel` / `_make_grouped_kernel`
// (:395-459) with f32 blocks (FP32) and with bf16 blocks and a bf16 output
// (BF16; `_bsr_matmul_impl` picks that output dtype at :682-688), and
// `_make_multirow_kernel_bf16x3` / `_make_grouped_kernel_bf16x3` (BF16X3).
// On rows wider than 8 column blocks it also replaces the per-block
// `_make_spmm_kernel` (:180) and the column-major `_make_colmajor_kernel`
// (:208, via `_colmajor_matmul`), which the pool backward runs on P^T:
// that kernel keeps the whole [n_pad, panel] output resident in VMEM while
// blocks stream in column order; here each CTA owns its output tile and
// loops over the row's G slots (any G: 25 on the 80k template's finest
// P^T), so every output is written once and no CTA needs another's
// partial sums. With bf16 blocks #5 and #7 round their output block after
// every slot; this kernel rounds once, as `_make_grouped_kernel` does.
//
// What bounds it: the occupied blocks plus x, the seeds and y are the
// bytes a call must move (5-40 MB at the 5k serving shapes; at the 80k
// template's level 0 in BF16, C = 512: 122 MB of blocks and 83 MB for each
// of x, a seed and y), far below the card's operation rate at C <= 1024,
// so the floor is HBM bytes. But this kernel runs every FMA of each dense
// 128x128 block on the CUDA cores (the blocks are ~1.5% nonzero), so the
// FMAs (three per pair in BF16X3) and the latency of staging each K chunk
// set its time, tens of times the byte floor.
//
// Design: one CTA per (64-row half of an output row-block, 64-column tile);
// it walks the row's G slots through g_idx, stages 16-deep K chunks of the
// block and the matching x rows in shared memory as fp32 (split into hi/lo
// there in BF16X3, widened from bf16 in BF16, so each element is converted
// once), accumulates 4x4 outputs per thread in registers, applies alpha
// and the seeds, and writes each output once. Padded slots are skipped and
// the padded [nR, G, 128, 128] gather is never materialised. Tensor-core
// MMAs (mma.sync / wgmma on the bf16 operands), TMA and a pipelined ring of
// tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int BLOCK = 128;       // operator block edge
constexpr int BM = 64;           // output rows per CTA
constexpr int BN = 64;           // output columns per CTA
constexpr int BK = 16;           // K depth staged per shared-memory chunk
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int APAD = BM + 4;     // padded row of the transposed A tile

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// four consecutive elements as fp32 (16 bytes of fp32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, sizeof(lo));
  memcpy(&hi, &u.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// one round-to-nearest-even per value
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  memcpy(&u.x, &lo, sizeof(lo));
  memcpy(&u.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
bsr_grouped_spmm_kernel(const T* __restrict__ blocks,
                        const int* __restrict__ g_idx,
                        const int* __restrict__ g_bcol,
                        const T* __restrict__ x,
                        const T* __restrict__ p_plus,
                        const T* __restrict__ p_minus,
                        T* __restrict__ y,
                        int nb, int g, int n_col_blocks, int c, float alpha) {
  // k-major fp32 tiles: each thread reads 4 consecutive rows (A) or
  // columns (B) of one k as a float4
  __shared__ __align__(16) float a_hi[BK][APAD];
  __shared__ __align__(16) float b_hi[BK][BN];
  __shared__ __align__(16) float a_lo[SPLIT ? BK : 1][APAD];
  __shared__ __align__(16) float b_lo[SPLIT ? BK : 1][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int col0 = blockIdx.x * BN;
  const int row_block = blockIdx.y / (BLOCK / BM);
  const int m0 = (blockIdx.y % (BLOCK / BM)) * BM;

  // loader coordinates: A chunk is BM x BK, B chunk is BK x BN, four
  // consecutive elements of each per thread
  const int a_row = tid / (BK / 4);
  const int a_k = (tid % (BK / 4)) * 4;
  const int b_k = tid / (BN / 4);
  const int b_col = (tid % (BN / 4)) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < g; ++s) {
    const int bi = g_idx[row_block * g + s];
    const int bc = g_bcol[row_block * g + s];
    // padded slot (the zero block), or a column outside x: nothing to add.
    // Uniform across the CTA, so the barriers below stay matched.
    if (bi < 0 || bi >= nb || bc < 0 || bc >= n_col_blocks) continue;
    const T* blk = blocks + (size_t)bi * BLOCK * BLOCK + (size_t)m0 * BLOCK;
    const T* xs = x + (size_t)bc * BLOCK * c + col0;

    for (int k0 = 0; k0 < BLOCK; k0 += BK) {
      const float4 av = load4(blk + (size_t)a_row * BLOCK + k0 + a_k);
      const float4 bv = load4(xs + (size_t)(k0 + b_k) * c + b_col);
      __syncthreads();  // the previous chunk has been consumed
      const float a4[4] = {av.x, av.y, av.z, av.w};
      if constexpr (SPLIT) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float hi = bf16_round(a4[j]);
          a_hi[a_k + j][a_row] = hi;
          a_lo[a_k + j][a_row] = bf16_round(a4[j] - hi);
        }
        const float4 bh = make_float4(bf16_round(bv.x), bf16_round(bv.y),
                                      bf16_round(bv.z), bf16_round(bv.w));
        *reinterpret_cast<float4*>(&b_hi[b_k][b_col]) = bh;
        *reinterpret_cast<float4*>(&b_lo[b_k][b_col]) =
            make_float4(bf16_round(bv.x - bh.x), bf16_round(bv.y - bh.y),
                        bf16_round(bv.z - bh.z), bf16_round(bv.w - bh.w));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) a_hi[a_k + j][a_row] = a4[j];
        *reinterpret_cast<float4*>(&b_hi[b_k][b_col]) = bv;
      }
      __syncthreads();

#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&a_hi[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&b_hi[k][tx * 4]);
        const float ar[4] = {a.x, a.y, a.z, a.w};
        const float br[4] = {b.x, b.y, b.z, b.w};
        if constexpr (SPLIT) {
          const float4 al4 = *reinterpret_cast<const float4*>(&a_lo[k][ty * 4]);
          const float4 bl4 = *reinterpret_cast<const float4*>(&b_lo[k][tx * 4]);
          const float al[4] = {al4.x, al4.y, al4.z, al4.w};
          const float bl[4] = {bl4.x, bl4.y, bl4.z, bl4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
              acc[i][j] = fmaf(ar[i], bl[j], acc[i][j]);
              acc[i][j] = fmaf(al[i], br[j], acc[i][j]);
            }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        }
      }
    }
  }

  // epilogue: alpha, seeds (fp32), one write (one rounding) per output
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t off = (size_t)(row_block * BLOCK + m0 + ty * 4 + i) * c
                       + col0 + tx * 4;
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
    store4(y + off, out);
  }
}

template <typename T, bool SPLIT>
void launch(const void* blocks, const int* g_idx, const int* g_bcol,
            const void* x, const void* p_plus, const void* p_minus, void* y,
            int nb, int n_rows, int g, int n_col_blocks, int c, float alpha,
            cudaStream_t st) {
  const dim3 grid(c / BN, n_rows * (BLOCK / BM));
  bsr_grouped_spmm_kernel<T, SPLIT><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(blocks), g_idx, g_bcol,
      static_cast<const T*>(x), static_cast<const T*>(p_plus),
      static_cast<const T*>(p_minus), static_cast<T*>(y), nb, g,
      n_col_blocks, c, alpha);
}

}  // namespace

// Plain C entry point (loaded with ctypes). `mode` is 0 = FP32,
// 1 = BF16X3 (fp32 storage), 2 = BF16 (bf16 blocks, x, seeds and y).
// Shapes, dtypes and alignment are checked by the Python wrapper:
// c % 64 == 0, every pointer 16-byte aligned, y and the seeds
// [n_rows * 128, c], x [n_col_blocks * 128, c]. Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int bsr_grouped_spmm(const void* blocks, const int* g_idx,
                                const int* g_bcol, const void* x,
                                const void* p_plus, const void* p_minus,
                                void* y, int nb, int n_rows, int g,
                                int n_col_blocks, int c, float alpha,
                                int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      launch<float, false>(blocks, g_idx, g_bcol, x, p_plus, p_minus, y, nb,
                           n_rows, g, n_col_blocks, c, alpha, st);
      break;
    case 1:
      launch<float, true>(blocks, g_idx, g_bcol, x, p_plus, p_minus, y, nb,
                          n_rows, g, n_col_blocks, c, alpha, st);
      break;
    case 2:
      launch<__nv_bfloat16, false>(blocks, g_idx, g_bcol, x, p_plus,
                                   p_minus, y, nb, n_rows, g, n_col_blocks,
                                   c, alpha, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
