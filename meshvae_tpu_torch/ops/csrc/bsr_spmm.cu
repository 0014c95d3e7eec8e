// Row-grouped block-sparse SpMM for Hopper (sm_90a):
//
//     y[n_pad, C] = alpha * (L @ x) + p_plus - p_minus [+ gm @ kron(I, wt)]
//
// L is stored as `blocks` [nb, 128, 128] plus the row-grouped view
// `g_idx` [nR, G] (index into blocks; nb marks a padded slot) and `g_bcol`
// [nR * G] (column block of each slot), and `tile_mask` [nb, 8] (uint8:
// bit t of byte s is set when the 16 x 16 tile at rows 16s.., columns
// 16t.. of the block holds a nonzero). x is [n_pad_cols, C] and may have
// more rows than y (rectangular operators). Three modes:
//
//   FP32   fp32 blocks, x, seeds and y; IEEE fp32 FMAs on the CUDA cores,
//          no TF32.
//   BF16X3 fp32 storage; both operands rounded to a bf16 `hi` and a bf16
//          residual `lo` (round to nearest even), hi*hi + hi*lo + lo*hi
//          on the tensor cores with fp32 accumulation.
//   BF16   bf16 blocks, x, seeds and y (compute_dtype=bfloat16): bf16
//          tensor-core products (exact in fp32), fp32 accumulation, alpha
//          and the seeds applied in fp32 (alpha * acc + p_plus - p_minus,
//          in that order), and each output rounded to bf16 once.
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
// column blocks it also replaces the per-block `_make_spmm_kernel` (:180,
// :329 in bf16x3) and the column-major `_make_colmajor_kernel` (:208, :234
// in bf16x3), which the pool backward runs on P^T: the TPU kernel keeps
// the whole output panel resident in VMEM while blocks stream in column
// order; here each CTA owns its output tile and loops over the row's G
// slots (any G), so every output is written once and no CTA needs
// another's partial sums. With bf16 blocks those TPU kernels round their
// output block after every slot; this kernel rounds once, as
// `_make_grouped_kernel` does.
//
// What bounds it: the bytes a call must move. A block of a mesh operator
// is ~1% nonzero and only 15-36% of its 16 x 16 tiles hold any nonzero, so
// the occupied tiles, x, the seeds and y are the floor (at the 80k
// template's level 0 in BF16, C = 512: ~24 MB of occupied tiles of 122 MB
// stored, 82 MB for each of x, a seed and y); the operations on the
// occupied tiles are far below the tensor cores' rate and, in FP32, a few
// times below the CUDA cores'.
//
// Design: one CTA of four warps per (64-row half of an output row block,
// 64-column tile) runs the occupied-tile engine (tile_engine.cuh
// `product`): warp w owns the 16-row strip w of the half and its 64
// columns; the CTA walks the row's G slots in order (padded slots and
// slots whose four strips are empty are skipped) and, within a slot, the
// 16-deep k chunks that any of its strips needs, staged through a
// cp.async ring (the x chunk and only the A tiles whose strip bit is set);
// each warp whose own bit is set runs its tile on the tensor cores (BF16;
// BF16X3 splits hi/lo as the fragments are read, so the operator stays one
// array that its caller may re-cast) or, in FP32, as CUDA-core FMAs in the
// dense product's k order.
// alpha, the seeds and the lazy seed are applied in fp32 in the epilogue,
// one write (one rounding) per output. The lazy seed is computed before
// the block product (a serial phase: the tile's gm and wt staged in shared
// memory, fp32 FMAs in e order) and parked in shared memory until the
// epilogue, so the block product keeps a plain call's registers. wgmma
// takes 64 rows with one k schedule and would run 1.7-3x the tiles that a
// per-strip schedule runs; emitted_spmm.cu runs the same tile products
// behind a TMA pipeline, and overlapping the lazy seed with the block
// product is later work.

#include "tile_engine.cuh"

namespace {

using namespace tile;

constexpr int SEED_LD = BN + 8;     // row of the parked lazy seed (fp32)
constexpr int GT_LD = BM + 4;       // row of the transposed gm tile (fp32)

// shared memory of one instantiation: the ring, which the lazy seed's
// staging (gm tile, wt) aliases before the product starts, and the parked
// seed
template <int MODE, bool DOT>
struct Smem {
  static constexpr int STAGING = (BN * GT_LD + BN * BN) * 4;
  static constexpr int RING = Ring<MODE>::BYTES;
  static constexpr int FRONT = DOT && STAGING > RING ? STAGING : RING;
  static constexpr int BYTES = FRONT + (DOT ? BM * SEED_LD * 4 : 0);
};

// The lazy seed of the CTA's 64 x 64 tile, parked in `seed` [64][SEED_LD]
// (fp32): seed[r][n] = sum_e gm[r, item(n) * f + e] wt[e, n % f], e in
// order, fp32 FMAs of the widened values, through the staging area
// (which aliases the ring). Each thread sums the outputs of the FP32
// layout.
template <typename T>
__device__ __forceinline__ void lazy_seed(const T* __restrict__ gm,
                                          const T* __restrict__ wt,
                                          float* stage, float* seed, int f,
                                          int c, size_t row0, int col0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int r0 = warp * KT + rg * 4;
  float s[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
  float* gt = stage;               // gm tile, transposed: gt[k][row]
  float* ws = stage + BN * GT_LD;  // wt (or its 64-column slice)
  if (f > BN) {
    // an item covers the tile: the f-deep product of the item's gm columns
    // with wt's 64-column slice, 16 e at a time
    const int kbase = (col0 / f) * f;
    for (int e0 = 0; e0 < f; e0 += KT) {
      __syncthreads();  // the previous chunk has been read
      for (int p = threadIdx.x; p < BM * KT / 4; p += THREADS) {
        const int r = p / (KT / 4), e4 = (p % (KT / 4)) * 4;
        const float4 v = load4(gm + (row0 + r) * c + kbase + e0 + e4);
        gt[(e4 + 0) * GT_LD + r] = v.x; gt[(e4 + 1) * GT_LD + r] = v.y;
        gt[(e4 + 2) * GT_LD + r] = v.z; gt[(e4 + 3) * GT_LD + r] = v.w;
      }
      for (int p = threadIdx.x; p < KT * BN / 4; p += THREADS) {
        const int e = p / (BN / 4), n4 = (p % (BN / 4)) * 4;
        store4(ws + e * BN + n4,
               load4(wt + (size_t)(e0 + e) * f + (col0 - kbase) + n4));
      }
      __syncthreads();
#pragma unroll 4
      for (int e = 0; e < KT; ++e) {
        const float4 a = load4(gt + e * GT_LD + r0);
        const float ar[4] = {a.x, a.y, a.z, a.w};
        const float4 b0 = load4(ws + e * BN + cg * 4);
        const float4 b1 = load4(ws + e * BN + 32 + cg * 4);
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(ar[i], br[j], s[i][j]);
      }
    }
  } else {
    // 64 / f whole items per tile: stage the tile's gm (transposed) and wt
    // once; each output sums the f features of its own item
    for (int p = threadIdx.x; p < BM * BN / 4; p += THREADS) {
      const int r = p / (BN / 4), k4 = (p % (BN / 4)) * 4;
      const float4 v = load4(gm + (row0 + r) * c + col0 + k4);
      gt[(k4 + 0) * GT_LD + r] = v.x; gt[(k4 + 1) * GT_LD + r] = v.y;
      gt[(k4 + 2) * GT_LD + r] = v.z; gt[(k4 + 3) * GT_LD + r] = v.w;
    }
    for (int p = threadIdx.x; p < f * f; p += THREADS) ws[p] = load1(wt + p);
    __syncthreads();
    int base[8], o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = (j / 4) * 32 + cg * 4 + j % 4;
      o[j] = n % f;
      base[j] = n - o[j];
    }
    for (int e = 0; e < f; ++e) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 a = load4(gt + (base[j] + e) * GT_LD + r0);
        const float w = ws[e * f + o[j]];
        s[0][j] = fmaf(a.x, w, s[0][j]);
        s[1][j] = fmaf(a.y, w, s[1][j]);
        s[2][j] = fmaf(a.z, w, s[2][j]);
        s[3][j] = fmaf(a.w, w, s[3][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store4(seed + (r0 + i) * SEED_LD + h * 32 + cg * 4,
             make_float4(s[i][4 * h], s[i][4 * h + 1], s[i][4 * h + 2],
                         s[i][4 * h + 3]));
  __syncthreads();  // the staging area is free for the ring
}

// DOT: the lazy seed is wanted (gm and wt non-null), a separate
// instantiation so the plain calls keep their registers and shared memory
template <int MODE, bool DOT>
__global__ void __launch_bounds__(THREADS)
bsr_grouped_spmm_kernel(const typename Ring<MODE>::T* __restrict__ blocks,
                        const int* __restrict__ g_idx,
                        const int* __restrict__ g_bcol,
                        const uint32_t* __restrict__ tile_mask,
                        const typename Ring<MODE>::T* __restrict__ x,
                        const typename Ring<MODE>::T* __restrict__ p_plus,
                        const typename Ring<MODE>::T* __restrict__ p_minus,
                        const typename Ring<MODE>::T* __restrict__ gm,
                        const typename Ring<MODE>::T* __restrict__ wt,
                        typename Ring<MODE>::T* __restrict__ y, int nb, int g,
                        int n_col_blocks, int c, int f, float alpha) {
  using R = Ring<MODE>;
  using T = typename R::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* seed = DOT ? reinterpret_cast<float*>(smem + Smem<MODE, DOT>::FRONT)
                    : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * BN;
  const int row_block = blockIdx.y / (BLOCK / BM);
  const int half = blockIdx.y % (BLOCK / BM);
  const int m0 = half * BM;
  const size_t row0 = (size_t)row_block * BLOCK + m0;

  if constexpr (DOT)
    lazy_seed(gm, wt, reinterpret_cast<float*>(smem), seed, f, c, row0, col0);

  const Args a{g_idx, g_bcol, tile_mask, nb, g, n_col_blocks, c, row_block,
               half};
  Acc acc;
  zero(acc);
  // the ring (tile_engine.cuh `product`, written out here: the call keeps
  // this kernel's registers as they were): the producer cursor runs
  // STAGES - 1 chunks ahead of the consumer's; both walk the same
  // (slot, k-tile) stream
  Cursor prod{0, 0, 0, 0u, 0u};
  seek(prod, a);
  Cursor cons = prod;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    issue<MODE>(ring + s * R::STAGE, prod, a, blocks, x, m0, col0);
    advance(prod, a);
  }
  int buf = 0;
  while (cons.slot < g) {
    // chunk `buf` has landed once at most STAGES - 2 younger groups are
    // pending; the barrier publishes it to every thread and retires the
    // buffer read last time, which this issue refills
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = buf == 0 ? STAGES - 1 : buf - 1;
    issue<MODE>(ring + next * R::STAGE, prod, a, blocks, x, m0, col0);
    advance(prod, a);
    if ((cons.strips >> (8 * warp + chunk_of(cons))) & 1u)
      run_tile<MODE>(ring + buf * R::STAGE, warp, lane, acc);
    advance(cons, a);
    buf = buf == STAGES - 1 ? 0 : buf + 1;
  }
  cp_async_wait<0>();  // only empty groups remain

  // epilogue: alpha, seeds (fp32), one write (one rounding) per output
  if constexpr (MODE == FP32) {
    const int r = warp * KT + (lane / 8) * 4, n = (lane % 8) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        finish<4>(acc.v[2 * i + h], alpha, p_plus, p_minus, seed, SEED_LD, y,
                  (row0 + r + i) * c + col0 + h * 32 + n, r + i, h * 32 + n);
  } else {
    const int r = warp * KT + (lane >> 2), n = (lane & 3) * 2;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        finish<2>(acc.v[nt] + 2 * h, alpha, p_plus, p_minus, seed, SEED_LD, y,
                  (row0 + r + 8 * h) * c + col0 + nt * 8 + n, r + 8 * h,
                  nt * 8 + n);
  }
}

template <int MODE, bool DOT>
int launch(const void* blocks, const int* g_idx, const int* g_bcol,
           const void* tile_mask, const void* x, const void* p_plus,
           const void* p_minus, const void* gm, const void* wt, void* y,
           int nb, int n_rows, int g, int n_col_blocks, int c, int f,
           float alpha, cudaStream_t st) {
  using T = typename Ring<MODE>::T;
  constexpr int bytes = Smem<MODE, DOT>::BYTES;
  auto kern = bsr_grouped_spmm_kernel<MODE, DOT>;
  static int cap[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(kern, bytes, cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(c / BN, n_rows * (BLOCK / BM));
  kern<<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(blocks), g_idx, g_bcol,
      static_cast<const uint32_t*>(tile_mask), static_cast<const T*>(x),
      static_cast<const T*>(p_plus), static_cast<const T*>(p_minus),
      static_cast<const T*>(gm), static_cast<const T*>(wt),
      static_cast<T*>(y), nb, g, n_col_blocks, c, f, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). `mode` is 0 = FP32,
// 1 = BF16X3 (fp32 storage), 2 = BF16 (bf16 blocks, x, seeds and y).
// Shapes, dtypes and alignment are checked by the Python wrapper:
// c % 64 == 0, every pointer 16-byte aligned, tile_mask [nb, 8] uint8,
// y, the seeds and gm [n_rows * 128, c], x [n_col_blocks * 128, c], wt
// [f, f] with 128 % f == 0 and c % f == 0. gm and wt are null unless the
// lazy seed is wanted, which BF16X3 does not take. Launches on `stream`
// and returns cudaGetLastError() of the launch.
extern "C" int bsr_grouped_spmm(const void* blocks, const int* g_idx,
                                const int* g_bcol, const void* tile_mask,
                                const void* x, const void* p_plus,
                                const void* p_minus, const void* gm,
                                const void* wt, void* y, int nb, int n_rows,
                                int g, int n_col_blocks, int c, int f,
                                float alpha, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dot = gm != nullptr;
  if ((gm == nullptr) != (wt == nullptr) || tile_mask == nullptr
      || (dot && (mode == BF16X3 || f <= 0 || BLOCK % f || c % f)))
    return static_cast<int>(cudaErrorInvalidValue);
#define BSR_ARGS                                                            \
  blocks, g_idx, g_bcol, tile_mask, x, p_plus, p_minus, gm, wt, y, nb,      \
      n_rows, g, n_col_blocks, c, f, alpha, st
  switch (mode) {
    case FP32:
      return dot ? launch<FP32, true>(BSR_ARGS) : launch<FP32, false>(BSR_ARGS);
    case BF16X3:
      return launch<BF16X3, false>(BSR_ARGS);
    case BF16:
      return dot ? launch<BF16, true>(BSR_ARGS) : launch<BF16, false>(BSR_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BSR_ARGS
}
