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
// 64-column tile); warp w owns the 16-row strip w of the half and its 64
// columns. The CTA walks the row's G slots in order (padded slots and
// slots whose four strips are empty are skipped) and, within a slot, the
// 16-deep k chunks that any of its strips needs. Each such chunk is staged
// in shared memory through a ring of STAGES buffers filled by 16-byte
// cp.async copies, STAGES - 1 chunks ahead: the x chunk [16, 64] and the
// 16 x 16 tiles of the strips whose bit is set (a chunk no strip needs is
// never loaded, a tile no strip needs is never copied). Then each warp
// whose own bit is set runs its tile:
//   BF16    ldmatrix (A) and ldmatrix.trans (x), 8 mma.sync m16n8k16
//           (bf16 in, fp32 accumulators) per tile;
//   BF16X3  the fp32 chunk is split into hi/lo bf16 pairs in registers as
//           the fragments are read from shared memory (no second copy of
//           the blocks: the operator may be swapped or re-cast by its
//           caller, and the split costs issue slots, not bytes), and the
//           same MMAs run three times (hi*hi, hi*lo, lo*hi);
//   FP32    CUDA-core FMAs of the strip's 16 x 64 outputs (4 x 8 per lane)
//           over the tile's 16 k in k order. Only tiles that are all zero
//           are skipped, whose FMAs add an exact 0 to a sum that is never
//           -0, and the order of the rest is kept: for finite x this mode
//           gives the same bits as running every FMA of every block.
// alpha, the seeds and the lazy seed are applied in fp32 in the epilogue,
// one write (one rounding) per output. The lazy seed is computed before
// the block product (a serial phase: the tile's gm and wt staged in shared
// memory, fp32 FMAs in e order) and parked in shared memory until the
// epilogue, so the block product keeps a plain call's registers. wgmma
// takes 64 rows with one k schedule and would run 1.7-3x the tiles that a
// per-strip schedule runs; TMA, wgmma and overlapping the lazy seed with
// the block product are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bsr_tile.cuh"

namespace {

using bsr::BLOCK;
using bsr::BM;
using bsr::BN;
using bsr::load1;
using bsr::load4;
using bsr::store4;

enum Mode { FP32 = 0, BF16X3 = 1, BF16 = 2 };

constexpr int WARPS = 4;            // one 16-row strip of the half each
constexpr int THREADS = 32 * WARPS;
constexpr int KT = 16;              // k depth of a chunk (a tile's edge)
constexpr int STAGES = 3;           // chunks resident in the ring
constexpr int SEED_LD = BN + 8;     // row of the parked lazy seed (fp32)
constexpr int GT_LD = BM + 4;       // row of the transposed gm tile (fp32)
constexpr int MAX_DEVICES = 16;

// One ring buffer: the block chunk A [64 rows][16 k] (row-major, rows
// padded so ldmatrix and the fragment reads hit distinct banks) and the x
// chunk X [16 k][64 columns].
template <int MODE>
struct Ring {
  using T = typename std::conditional<MODE == BF16, __nv_bfloat16,
                                      float>::type;
  static constexpr int A_LD = 24;
  static constexpr int X_LD = MODE == BF16 ? BN + 8 : BN + 4;
  static constexpr int A = BM * A_LD;
  static constexpr int STAGE = A + KT * X_LD;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int BYTES = STAGES * STAGE * static_cast<int>(sizeof(T));
  static_assert((A * sizeof(T)) % 16 == 0 && (STAGE * sizeof(T)) % 16 == 0,
                "every stage and its x chunk start 16-byte aligned");
};

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p,
                                            bool trans) {
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// (v0, v1) -> packed bf16 pairs hi = bf16(v) and lo = bf16(v - hi), round
// to nearest even (v0 in the low half, as an MMA fragment wants it)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// Per-lane outputs. FP32 (CUDA cores): rows strip + rg * 4 + i (i < 4),
// columns h * 32 + cg * 4 + j (h < 2, j < 4) in acc[2i + h][j], with
// rg = lane / 8, cg = lane % 8 (a quarter warp shares its rows, so the A
// reads broadcast and the x reads are 128 contiguous bytes). MMA (BF16,
// BF16X3): the m16n8 accumulator layout of 8 column tiles, acc[nt][2h + j]
// at row strip + lane / 4 + 8h, column nt * 8 + (lane % 4) * 2 + j.
struct Acc {
  float v[8][4];
};

// The CTA's position in its chunk stream: slot (>= g once it has ended),
// the slot's block and column block, its four strip masks (byte w: warp
// w's k-tiles) and the k-tiles of the slot still to visit.
struct Cursor {
  int slot, bi, bc;
  uint32_t strips, need;
};

struct Args {
  const int* g_idx;
  const int* g_bcol;
  const uint32_t* mask;  // tile_mask as two words per block
  int nb, g, n_col_blocks, c, row_block, half;
};

// move to the first slot at or after cur.slot that is real and needed
__device__ __forceinline__ void seek(Cursor& cur, const Args& a) {
  for (; cur.slot < a.g; ++cur.slot) {
    const int bi = __ldg(a.g_idx + a.row_block * a.g + cur.slot);
    const int bc = __ldg(a.g_bcol + a.row_block * a.g + cur.slot);
    if (bi < 0 || bi >= a.nb || bc < 0 || bc >= a.n_col_blocks) continue;
    const uint32_t strips = __ldg(a.mask + 2 * bi + a.half);
    const uint32_t need =
        (strips | strips >> 8 | strips >> 16 | strips >> 24) & 0xffu;
    if (need) {
      cur.bi = bi;
      cur.bc = bc;
      cur.strips = strips;
      cur.need = need;
      return;
    }
  }
}

__device__ __forceinline__ void advance(Cursor& cur, const Args& a) {
  if (cur.slot >= a.g) return;
  cur.need &= cur.need - 1;
  if (cur.need == 0) {
    ++cur.slot;
    seek(cur, a);
  }
}

__device__ __forceinline__ int chunk_of(const Cursor& cur) {
  return __ffs(cur.need) - 1;
}

// Issue the cursor's chunk into ring buffer `buf` (nothing once the
// stream has ended) and commit one group, so every thread counts the same
// groups.
template <int MODE>
__device__ __forceinline__ void issue(typename Ring<MODE>::T* buf,
                                      const Cursor& cur, const Args& a,
                                      const typename Ring<MODE>::T* blocks,
                                      const typename Ring<MODE>::T* x,
                                      int m0, int col0) {
  using R = Ring<MODE>;
  using T = typename R::T;
  if (cur.slot < a.g) {
    const int kt = chunk_of(cur);
    const T* ga = blocks + (size_t)cur.bi * BLOCK * BLOCK
                  + (size_t)m0 * BLOCK + kt * KT;
    constexpr int A_ROW = KT / R::VEC;  // pieces per row of the A chunk
    constexpr int X_ROW = BN / R::VEC;
    static_assert((BM * A_ROW) % THREADS == 0 && (KT * X_ROW) % THREADS == 0,
                  "each thread copies whole 16-byte pieces");
#pragma unroll
    for (int i = 0; i < BM * A_ROW / THREADS; ++i) {
      const int p = threadIdx.x + i * THREADS;
      const int row = p / A_ROW, q = p % A_ROW;
      if ((cur.strips >> (8 * (row / KT) + kt)) & 1u)
        cp_async16(buf + row * R::A_LD + q * R::VEC,
                   ga + (size_t)row * BLOCK + q * R::VEC);
    }
    const T* gx = x + ((size_t)cur.bc * BLOCK + kt * KT) * a.c + col0;
#pragma unroll
    for (int i = 0; i < KT * X_ROW / THREADS; ++i) {
      const int p = threadIdx.x + i * THREADS;
      const int r = p / X_ROW, q = p % X_ROW;
      cp_async16(buf + R::A + r * R::X_LD + q * R::VEC,
                 gx + (size_t)r * a.c + q * R::VEC);
    }
  }
  cp_async_commit();
}

// acc += this warp's 16 x 16 A tile @ the 16 x 64 x chunk
template <int MODE>
__device__ __forceinline__ void run_tile(const typename Ring<MODE>::T* buf,
                                         int warp, int lane, Acc& acc) {
  using R = Ring<MODE>;
  const typename R::T* A = buf + warp * KT * R::A_LD;
  const typename R::T* X = buf + R::A;
  if constexpr (MODE == FP32) {
    const int rg = lane / 8, cg = lane % 8;
#pragma unroll
    for (int k0 = 0; k0 < KT; k0 += 4) {
      float ar[4][4];  // ar[kk][i] = A[rg * 4 + i][k0 + kk]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = load4(A + (rg * 4 + i) * R::A_LD + k0);
        ar[0][i] = v.x; ar[1][i] = v.y; ar[2][i] = v.z; ar[3][i] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* xr = X + (k0 + kk) * R::X_LD + cg * 4;
        const float4 b0 = load4(xr), b1 = load4(xr + 32);
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc.v[2 * i + j / 4][j % 4] =
                fmaf(ar[kk][i], br[j], acc.v[2 * i + j / 4][j % 4]);
      }
    }
  } else if constexpr (MODE == BF16) {
    uint32_t af[4];
    ldmatrix_x4(af, A + (lane & 15) * R::A_LD + (lane >> 4) * 8, false);
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      uint32_t bf[4];  // b0, b1 of column tile nt, then of nt + 1
      ldmatrix_x4(bf, X + (lane & 15) * R::X_LD + nt * 8 + (lane >> 4) * 8,
                  true);
      mma_bf16(acc.v[nt], af, bf[0], bf[1]);
      mma_bf16(acc.v[nt + 1], af, bf[2], bf[3]);
    }
  } else {  // BF16X3: fragments read from the fp32 chunk and split
    const int gid = lane >> 2, tig = lane & 3;
    uint32_t ah[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // a0..a3: rows +8 (odd r), k +8 (r >= 2)
      const float2 v =
          load2(A + (gid + 8 * (r & 1)) * R::A_LD + tig * 2 + 8 * (r >> 1));
      split2(v.x, v.y, ah[r], al[r]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* xc = X + tig * 2 * R::X_LD + nt * 8 + gid;
      uint32_t bh0, bl0, bh1, bl1;
      split2(xc[0], xc[R::X_LD], bh0, bl0);
      split2(xc[8 * R::X_LD], xc[9 * R::X_LD], bh1, bl1);
      mma_bf16(acc.v[nt], ah, bh0, bh1);
      mma_bf16(acc.v[nt], ah, bl0, bl1);
      mma_bf16(acc.v[nt], al, bh0, bh1);
    }
  }
}

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

// out = alpha * acc + p_plus - p_minus [+ seed] at n (2 or 4) consecutive
// outputs from offset `off` of y (tile row r, tile column n0), one write
template <int N, typename T>
__device__ __forceinline__ void finish(const float* acc, float alpha,
                                       const T* p_plus, const T* p_minus,
                                       const float* seed, T* y, size_t off,
                                       int r, int n0) {
  float out[N];
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = alpha * acc[j];
  float p[N];
  auto read = [&](const T* src) {
    if constexpr (N == 4) {
      const float4 v = load4(src);
      p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
    } else {
      const float2 v = load2(src);
      p[0] = v.x; p[1] = v.y;
    }
  };
  if (p_plus != nullptr) {
    read(p_plus + off);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] += p[j];
  }
  if (p_minus != nullptr) {
    read(p_minus + off);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] -= p[j];
  }
  if (seed != nullptr) {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] += seed[r * SEED_LD + n0 + j];
  }
  if constexpr (N == 4)
    store4(y + off, make_float4(out[0], out[1], out[2], out[3]));
  else
    store2(y + off, make_float2(out[0], out[1]));
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
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.v[i][j] = 0.f;

  // the ring: the producer cursor runs STAGES - 1 chunks ahead of the
  // consumer's; both walk the same (slot, k-tile) stream
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
        finish<4>(acc.v[2 * i + h], alpha, p_plus, p_minus, seed, y,
                  (row0 + r + i) * c + col0 + h * 32 + n, r + i, h * 32 + n);
  } else {
    const int r = warp * KT + (lane >> 2), n = (lane & 3) * 2;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        finish<2>(acc.v[nt] + 2 * h, alpha, p_plus, p_minus, seed, y,
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
  if constexpr (bytes > 48 * 1024) {  // above the default, once per device
    static bool ready[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (dev >= MAX_DEVICES || !ready[dev]))
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) ready[dev] = true;
  }
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
