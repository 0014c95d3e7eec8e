// The 64 x 64 output tile of a row-grouped block-sparse product, shared by
// the port's CUDA kernels (bsr_spmm.cu, cheb_fused.cu).
//
// L is stored as `blocks` [nb, 128, 128] plus the row-grouped view
// `g_idx` [nR, G] (index into blocks; nb marks a padded slot) and `g_bcol`
// [nR * G] (column block of each slot). One CTA of THREADS threads owns a
// BM x BN output tile: 16 x 16 threads, 4 x 4 outputs each, accumulated in
// fp32 registers. K is consumed in BK-deep chunks staged in shared memory
// as fp32 (k-major, so each thread reads 4 consecutive rows or columns of
// one k as a float4). With SPLIT both operands are rounded to a bf16 `hi`
// and a bf16 residual `lo` (round to nearest even) when staged, and each
// pair adds hi*hi + hi*lo + lo*hi (each product of two bf16 values is
// exact in fp32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace bsr {

constexpr int BLOCK = 128;       // operator block edge
constexpr int BM = 64;           // output rows per CTA
constexpr int BN = 64;           // output columns per CTA
constexpr int BK = 16;           // K depth staged per shared-memory chunk
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int APAD = BM + 4;     // padded row of the transposed A tile

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

template <bool SPLIT>
struct Tiles {
  float a_hi[BK][APAD];
  float b_hi[BK][BN];
  float a_lo[SPLIT ? BK : 1][APAD];
  float b_lo[SPLIT ? BK : 1][BN];
};

// Thread coordinates: the outputs (rows ty*4.., columns tx*4..) and the
// four consecutive elements it stages of an A chunk (BM x BK: row a_row,
// k a_k..) and of a B chunk (BK x BN: k b_k, columns b_col..).
struct Coords {
  int tx, ty, a_row, a_k, b_k, b_col;
};

__device__ __forceinline__ Coords coords(int tid) {
  return Coords{tid % 16, tid / 16, tid / (BK / 4), (tid % (BK / 4)) * 4,
                tid / (BN / 4), (tid % (BN / 4)) * 4};
}

// Stage one K chunk (av: this thread's A elements, bv: its B elements)
// and add its BK rank-1 updates to acc. Every thread of the CTA calls it.
template <bool SPLIT>
__device__ __forceinline__ void fma_chunk(Tiles<SPLIT>& t, const Coords& q,
                                          float4 av, float4 bv,
                                          float (&acc)[4][4]) {
  __syncthreads();  // the previous chunk has been consumed
  const float a4[4] = {av.x, av.y, av.z, av.w};
  if constexpr (SPLIT) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float hi = bf16_round(a4[j]);
      t.a_hi[q.a_k + j][q.a_row] = hi;
      t.a_lo[q.a_k + j][q.a_row] = bf16_round(a4[j] - hi);
    }
    const float4 bh = make_float4(bf16_round(bv.x), bf16_round(bv.y),
                                  bf16_round(bv.z), bf16_round(bv.w));
    *reinterpret_cast<float4*>(&t.b_hi[q.b_k][q.b_col]) = bh;
    *reinterpret_cast<float4*>(&t.b_lo[q.b_k][q.b_col]) =
        make_float4(bf16_round(bv.x - bh.x), bf16_round(bv.y - bh.y),
                    bf16_round(bv.z - bh.z), bf16_round(bv.w - bh.w));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) t.a_hi[q.a_k + j][q.a_row] = a4[j];
    *reinterpret_cast<float4*>(&t.b_hi[q.b_k][q.b_col]) = bv;
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&t.a_hi[k][q.ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&t.b_hi[k][q.tx * 4]);
    const float ar[4] = {a.x, a.y, a.z, a.w};
    const float br[4] = {b.x, b.y, b.z, b.w};
    if constexpr (SPLIT) {
      const float4 al4 =
          *reinterpret_cast<const float4*>(&t.a_lo[k][q.ty * 4]);
      const float4 bl4 =
          *reinterpret_cast<const float4*>(&t.b_lo[k][q.tx * 4]);
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

// acc += (L @ x) on rows m0..m0+63 of row block `row_block`, columns
// col0..col0+63, walking the row's g slots; x is [n_col_blocks * 128, c].
// Padded slots and columns outside x add nothing (uniform across the CTA,
// so the barriers in fma_chunk stay matched).
template <typename T, bool SPLIT>
__device__ __forceinline__ void spmm_tile(Tiles<SPLIT>& t, const Coords& q,
                                          const T* __restrict__ blocks,
                                          const int* __restrict__ g_idx,
                                          const int* __restrict__ g_bcol,
                                          const T* __restrict__ x, int nb,
                                          int g, int n_col_blocks, int c,
                                          int row_block, int m0, int col0,
                                          float (&acc)[4][4]) {
  for (int s = 0; s < g; ++s) {
    const int bi = g_idx[row_block * g + s];
    const int bc = g_bcol[row_block * g + s];
    if (bi < 0 || bi >= nb || bc < 0 || bc >= n_col_blocks) continue;
    const T* blk = blocks + (size_t)bi * BLOCK * BLOCK + (size_t)m0 * BLOCK;
    const T* xs = x + (size_t)bc * BLOCK * c + col0;
    for (int k0 = 0; k0 < BLOCK; k0 += BK) {
      const float4 av = load4(blk + (size_t)q.a_row * BLOCK + k0 + q.a_k);
      const float4 bv = load4(xs + (size_t)(k0 + q.b_k) * c + q.b_col);
      fma_chunk<SPLIT>(t, q, av, bv, acc);
    }
  }
}

}  // namespace bsr
