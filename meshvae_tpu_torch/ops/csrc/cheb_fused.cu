// One fused Chebyshev step for Hopper (sm_90a): block-sparse propagation
// and the channel mix of its result in the same launch,
//
//     T_k = alpha * (L @ T_{k-1}) - [T_{k-2}]            [n_pad, C]
//     acc[r, i*f_out + o] += sum_e T_k[r, i*f_pad + e] * W_k[e, o]
//
// with C = B * f_pad (batch item i owns columns i*f_pad..) and acc
// [n_pad, B * f_out] updated in place. fp32 storage; FP32 runs IEEE fp32
// FMAs, BF16X3 rounds both operands of both products to a bf16 hi and a
// bf16 residual lo and adds hi*hi + hi*lo + lo*hi in fp32.
//
// Replaces meshvae_tpu/ops/pallas_fused.py `_make_fused_kernel` (:51-81),
// launched per step by `_fused_step` (:84-144): there the grid walks the
// operator block by block (first/last flags), the TPU keeps the T_k
// row-block resident in VMEM until its last block, then multiplies it by
// kron(I_bchunk, W_k) on the MXU and adds into the aliased accumulator.
// Here the grouped view (g_idx / g_bcol) gives each CTA a whole output
// tile, so the mix follows in the same CTA: T_k's tile goes from registers
// to HBM (the next step and the backward read it) and to shared memory,
// and the CTA mixes its own batch items into acc. Each acc element belongs
// to exactly one CTA (the one holding its item's rows and columns), so
// there are no atomics and no ordering between CTAs.
//
// What bounds it: the same bytes as the plain step (blocks, T_{k-1},
// T_{k-2}, T_k) plus acc read and written once; the operations (every FMA
// of each dense 128x128 block on the CUDA cores, as bsr_spmm.cu) set its
// time far above that floor. The mix adds 2 * f_out operations per T_k
// element, read from shared memory, and saves the plain path's re-read of
// the whole basis by the mix GEMM.
//
// Design: one CTA per (64-row half of an output row block, tile of TW =
// max(64, f_pad) columns, i.e. TW / f_pad whole batch items). It computes
// T_k for its tile in TW / 64 passes of the 64 x 64 tile product
// (bsr_tile.cuh), writes each pass to t_out and to a [64, TW] fp32 tile in
// dynamic shared memory, stages W_k [f_pad, f_out], then each thread adds
// sum_e T[r, e] W[e, o] for its (row, item, o) outputs into acc.

#include "bsr_tile.cuh"

namespace {

using namespace bsr;

__device__ __forceinline__ float mul_add(float a, float b, float acc,
                                         bool split) {
  if (!split) return fmaf(a, b, acc);
  const float ah = bf16_round(a), bh = bf16_round(b);
  const float al = bf16_round(a - ah), bl = bf16_round(b - bh);
  acc = fmaf(ah, bh, acc);
  acc = fmaf(ah, bl, acc);
  return fmaf(al, bh, acc);
}

template <bool SPLIT>
__global__ void __launch_bounds__(THREADS)
cheb_fused_step_kernel(const float* __restrict__ blocks,
                       const int* __restrict__ g_idx,
                       const int* __restrict__ g_bcol,
                       const float* __restrict__ t1,
                       const float* __restrict__ t2,
                       const float* __restrict__ w,
                       float* __restrict__ t_out,
                       float* __restrict__ acc_mix,
                       int nb, int g, int n_col_blocks, int c, int f_pad,
                       int f_out, float alpha) {
  __shared__ __align__(16) Tiles<SPLIT> tiles;
  // ts [BM][tw] (the T_k tile), then ws [f_pad][f_out] (W_k)
  extern __shared__ __align__(16) float dyn[];
  const int tw = f_pad > BN ? f_pad : BN;
  float* ts = dyn;
  float* ws = dyn + BM * tw;
  const Coords q = coords(threadIdx.x);
  const int tile0 = blockIdx.x * tw;
  const int row_block = blockIdx.y / (BLOCK / BM);
  const int m0 = (blockIdx.y % (BLOCK / BM)) * BM;

  for (int i = threadIdx.x; i < f_pad * f_out; i += THREADS) ws[i] = w[i];

  for (int sub = 0; sub < tw; sub += BN) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
    spmm_tile<float, SPLIT>(tiles, q, blocks, g_idx, g_bcol, t1, nb, g,
                            n_col_blocks, c, row_block, m0, tile0 + sub, a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q.ty * 4 + i;
      const size_t off = (size_t)(row_block * BLOCK + m0 + r) * c + tile0
                         + sub + q.tx * 4;
      float4 out = make_float4(alpha * a[i][0], alpha * a[i][1],
                               alpha * a[i][2], alpha * a[i][3]);
      if (t2 != nullptr) {
        const float4 p = load4(t2 + off);
        out.x -= p.x; out.y -= p.y; out.z -= p.z; out.w -= p.w;
      }
      store4(t_out + off, out);
      store4(ts + r * tw + sub + q.tx * 4, out);
    }
  }
  __syncthreads();

  // the tile's batch items, mixed: outputs (row r, item it, feature o)
  const int items = tw / f_pad;
  const int aw = items * f_out;
  const int c_out = (c / f_pad) * f_out;
  const int item0 = tile0 / f_pad;
  for (int idx = threadIdx.x; idx < BM * aw; idx += THREADS) {
    const int r = idx / aw, cc = idx % aw;
    const int it = cc / f_out, o = cc % f_out;
    const float* trow = ts + r * tw + it * f_pad;
    float s = 0.f;
    for (int e = 0; e < f_pad; ++e)
      s = mul_add(trow[e], ws[e * f_out + o], s, SPLIT);
    float* dst = acc_mix + (size_t)(row_block * BLOCK + m0 + r) * c_out
                 + (size_t)(item0 + it) * f_out + o;
    *dst = *dst + s;
  }
}

template <bool SPLIT>
int launch(const void* blocks, const int* g_idx, const int* g_bcol,
           const float* t1, const float* t2, const float* w, float* t_out,
           float* acc, int nb, int n_rows, int g, int n_col_blocks, int c,
           int f_pad, int f_out, float alpha, cudaStream_t st) {
  const int tw = f_pad > BN ? f_pad : BN;
  const size_t smem = sizeof(float) * ((size_t)BM * tw
                                       + (size_t)f_pad * f_out);
  if (smem + sizeof(Tiles<SPLIT>) > 48 * 1024) {  // above the default cap
    const cudaError_t err = cudaFuncSetAttribute(
        cheb_fused_step_kernel<SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(c / tw, n_rows * (BLOCK / BM));
  cheb_fused_step_kernel<SPLIT><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(blocks), g_idx, g_bcol, t1, t2, w, t_out,
      acc, nb, g, n_col_blocks, c, f_pad, f_out, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). `mode` is 0 = FP32,
// 1 = BF16X3. Shapes and alignment are checked by the Python wrapper:
// f_pad a power of two, c = B * f_pad a multiple of max(64, f_pad), t1,
// t2 (null at the first step) and t_out [n_rows * 128, c] (t1 may have
// n_col_blocks * 128 rows), w [f_pad, f_out], acc [n_rows * 128,
// B * f_out], every pointer 16-byte aligned. Launches on `stream` and
// returns the CUDA error of the launch.
extern "C" int cheb_fused_step(const void* blocks, const int* g_idx,
                               const int* g_bcol, const float* t1,
                               const float* t2, const float* w, float* t_out,
                               float* acc, int nb, int n_rows, int g,
                               int n_col_blocks, int c, int f_pad, int f_out,
                               float alpha, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tw = f_pad > BN ? f_pad : BN;
  if (f_pad <= 0 || (f_pad & (f_pad - 1)) || f_out <= 0 || c % tw)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case 0:
      return launch<false>(blocks, g_idx, g_bcol, t1, t2, w, t_out, acc, nb,
                           n_rows, g, n_col_blocks, c, f_pad, f_out, alpha,
                           st);
    case 1:
      return launch<true>(blocks, g_idx, g_bcol, t1, t2, w, t_out, acc, nb,
                          n_rows, g, n_col_blocks, c, f_pad, f_out, alpha, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
