// The occupied-tile engine shared by the port's CUDA kernels
// (bsr_spmm.cu, emitted_spmm.cu, cheb_fused.cu): the tile products of a
// row-grouped block-sparse operator on its occupied 16 x 16 tiles.
//
// L is stored as `blocks` [nb, 128, 128] plus the row-grouped view
// `g_idx` [nR, G] (index into blocks; nb marks a padded slot) and `g_bcol`
// [nR * G] (column block of each slot), and `tile_mask` [nb, 8] (uint8:
// bit t of byte s is set when the 16 x 16 tile at rows 16s.., columns
// 16t.. of the block holds a nonzero), read as two 32-bit words per block
// (word h: the strips of rows 64h..64h+63).
//
// A warp owns a 16-row strip of the output and 64 columns. Its product
// walks the row's slots in order and, within a slot, the 16-deep k chunks
// that its strip needs (a chunk is the x rows [16, 64] and the strip's
// A tile [16, 16]); `tile_product` adds one such tile, in one of three
// modes:
//   FP32    CUDA-core FMAs of the strip's 16 x 64 outputs (4 x 8 per lane)
//           over the tile's 16 k in k order. Only tiles that are all zero
//           are skipped, whose FMAs add an exact 0 to a sum that is never
//           -0, and the order of the rest is kept: for finite x this mode
//           gives the same bits as running every FMA of every block.
//   BF16    ldmatrix (A) and ldmatrix.trans (x), 8 mma.sync m16n8k16
//           (bf16 in, fp32 accumulators) per tile;
//   BF16X3  the fp32 chunk is split into hi/lo bf16 pairs in registers as
//           the fragments are read from shared memory, and the same MMAs
//           run three times (hi*hi, hi*lo, lo*hi).
// Where the chunk lies in shared memory is the caller's: a layout policy
// maps (row, k) of the A tile and (k, column) of the x chunk to element
// offsets (padded rows for the cp.async ring below, TMA's swizzle in
// emitted_spmm.cu).
//
// `product` is the cp.async form of the walk for a CTA of four warps that
// owns a 64-row half of a row block and a 64-column tile: each chunk that
// any of its strips needs is staged through a ring of STAGES buffers
// filled by 16-byte cp.async copies, STAGES - 1 chunks ahead (the x chunk
// and only the A tiles whose strip bit is set).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace tile {

constexpr int BLOCK = 128;          // operator block edge
constexpr int BM = 64;              // output rows of a four-warp CTA
constexpr int BN = 64;              // output columns of a tile
constexpr int KT = 16;              // k depth of a chunk (a tile's edge)
constexpr int WARPS = 4;            // one 16-row strip of the half each
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 3;           // chunks resident in the ring
constexpr int MAX_DEVICES = 16;

enum Mode { FP32 = 0, BF16X3 = 1, BF16 = 2 };

template <int MODE>
using Elem = typename std::conditional<MODE == BF16, __nv_bfloat16,
                                       float>::type;

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

// Per-lane outputs. FP32 (CUDA cores): rows strip + rg * 4 + i (i < 4),
// columns h * 32 + cg * 4 + j (h < 2, j < 4) in acc[2i + h][j], with
// rg = lane / 8, cg = lane % 8 (a quarter warp shares its rows, so the A
// reads broadcast and the x reads are 128 contiguous bytes). MMA (BF16,
// BF16X3): the m16n8 accumulator layout of 8 column tiles, acc[nt][2h + j]
// at row strip + lane / 4 + 8h, column nt * 8 + (lane % 4) * 2 + j.
struct Acc {
  float v[8][4];
};

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.v[i][j] = 0.f;
}

// acc += A tile (16 x 16) @ x chunk (16 x 64) of one warp; L::a(row, k)
// and L::x(k, column) are the element offsets of the two in shared memory
template <int MODE, class L>
__device__ __forceinline__ void tile_product(const Elem<MODE>* A,
                                             const Elem<MODE>* X, int lane,
                                             Acc& acc) {
  if constexpr (MODE == FP32) {
    const int rg = lane / 8, cg = lane % 8;
#pragma unroll
    for (int k0 = 0; k0 < KT; k0 += 4) {
      float ar[4][4];  // ar[kk][i] = A[rg * 4 + i][k0 + kk]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = load4(A + L::a(rg * 4 + i, k0));
        ar[0][i] = v.x; ar[1][i] = v.y; ar[2][i] = v.z; ar[3][i] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = load4(X + L::x(k0 + kk, cg * 4));
        const float4 b1 = load4(X + L::x(k0 + kk, 32 + cg * 4));
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
    ldmatrix_x4(af, A + L::a(lane & 15, (lane >> 4) * 8), false);
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      uint32_t bf[4];  // b0, b1 of column tile nt, then of nt + 1
      ldmatrix_x4(bf, X + L::x(lane & 15, nt * 8 + (lane >> 4) * 8), true);
      mma_bf16(acc.v[nt], af, bf[0], bf[1]);
      mma_bf16(acc.v[nt + 1], af, bf[2], bf[3]);
    }
  } else {  // BF16X3: fragments read from the fp32 chunk and split
    const int gid = lane >> 2, tig = lane & 3;
    uint32_t ah[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // a0..a3: rows +8 (odd r), k +8 (r >= 2)
      const float2 v = load2(A + L::a(gid + 8 * (r & 1), tig * 2 + 8 * (r >> 1)));
      split2(v.x, v.y, ah[r], al[r]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = nt * 8 + gid;
      uint32_t bh0, bl0, bh1, bl1;
      split2(X[L::x(tig * 2, n)], X[L::x(tig * 2 + 1, n)], bh0, bl0);
      split2(X[L::x(tig * 2 + 8, n)], X[L::x(tig * 2 + 9, n)], bh1, bl1);
      mma_bf16(acc.v[nt], ah, bh0, bh1);
      mma_bf16(acc.v[nt], ah, bl0, bl1);
      mma_bf16(acc.v[nt], al, bh0, bh1);
    }
  }
}

// The bits of k chunk `kt` in two strip words (w0: strips 0-3, w1: 4-7):
// bit s is set when strip s needs that chunk's tile.
__device__ __forceinline__ uint32_t chunk_strips(uint32_t w0, uint32_t w1,
                                                 int kt) {
  uint32_t bits = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    bits |= ((w0 >> (8 * s + kt)) & 1u) << s;
    bits |= ((w1 >> (8 * s + kt)) & 1u) << (s + 4);
  }
  return bits;
}

// the k chunks any strip of a word needs (bit kt)
__device__ __forceinline__ uint32_t needed(uint32_t strips) {
  return (strips | strips >> 8 | strips >> 16 | strips >> 24) & 0xffu;
}

// ---------------------------------------------------------------------
// The cp.async ring of a four-warp CTA (64-row half, 64-column tile)

// One ring buffer: the block chunk A [64 rows][16 k] (row-major, rows
// padded so ldmatrix and the fragment reads hit distinct banks) and the x
// chunk X [16 k][64 columns].
template <int MODE>
struct Ring {
  using T = Elem<MODE>;
  static constexpr int A_LD = 24;
  static constexpr int X_LD = MODE == BF16 ? BN + 8 : BN + 4;
  static constexpr int A = BM * A_LD;
  static constexpr int STAGE = A + KT * X_LD;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int BYTES = STAGES * STAGE * static_cast<int>(sizeof(T));
  static_assert((A * sizeof(T)) % 16 == 0 && (STAGE * sizeof(T)) % 16 == 0,
                "every stage and its x chunk start 16-byte aligned");
  // the layout policy of tile_product: a warp's strip starts at row 0
  struct Layout {
    static __device__ __forceinline__ int a(int r, int k) {
      return r * A_LD + k;
    }
    static __device__ __forceinline__ int x(int k, int n) {
      return k * X_LD + n;
    }
  };
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
    const uint32_t need = needed(strips);
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

// acc += this warp's 16 x 16 A tile @ the 16 x 64 x chunk of ring buffer
// `buf`
template <int MODE>
__device__ __forceinline__ void run_tile(const typename Ring<MODE>::T* buf,
                                         int warp, int lane, Acc& acc) {
  using R = Ring<MODE>;
  tile_product<MODE, typename R::Layout>(buf + warp * KT * R::A_LD,
                                         buf + R::A, lane, acc);
}

// acc += (L @ x) on this warp's strip of rows m0.. of row block
// a.row_block, columns col0..col0+63: the CTA's whole chunk stream through
// the ring. Every thread of the CTA calls it; on return the ring holds no
// pending copy, but other warps may still read its last buffer.
template <int MODE>
__device__ __forceinline__ void product(typename Ring<MODE>::T* ring,
                                        const Args& a,
                                        const typename Ring<MODE>::T* blocks,
                                        const typename Ring<MODE>::T* x,
                                        int m0, int col0, int warp, int lane,
                                        Acc& acc) {
  using R = Ring<MODE>;
  // the producer cursor runs STAGES - 1 chunks ahead of the consumer's;
  // both walk the same (slot, k-tile) stream
  Cursor prod{0, 0, 0, 0u, 0u};
  seek(prod, a);
  Cursor cons = prod;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    issue<MODE>(ring + s * R::STAGE, prod, a, blocks, x, m0, col0);
    advance(prod, a);
  }
  int buf = 0;
  while (cons.slot < a.g) {
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
}

// out = alpha * acc + p_plus - p_minus [+ seed] at n (2 or 4) consecutive
// outputs from offset `off` (tile row r, tile column n0), in that order,
// in fp32; the seed is parked in shared memory with rows of seed_ld floats
template <int N, typename T>
__device__ __forceinline__ void combine(const float* acc, float alpha,
                                        const T* p_plus, const T* p_minus,
                                        const float* seed, int seed_ld,
                                        size_t off, int r, int n0,
                                        float (&out)[N]) {
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
    for (int j = 0; j < N; ++j)
      out[j] += seed[r * seed_ld + n0 + j];
  }
}

template <int N, typename T>
__device__ __forceinline__ void store_n(T* p, const float (&out)[N]) {
  if constexpr (N == 4)
    store4(p, make_float4(out[0], out[1], out[2], out[3]));
  else
    store2(p, make_float2(out[0], out[1]));
}

// combine, then one write (one rounding) to y + off
template <int N, typename T>
__device__ __forceinline__ void finish(const float* acc, float alpha,
                                       const T* p_plus, const T* p_minus,
                                       const float* seed, int seed_ld, T* y,
                                       size_t off, int r, int n0) {
  float out[N];
  combine<N>(acc, alpha, p_plus, p_minus, seed, seed_ld, off, r, n0, out);
  store_n<N>(y + off, out);
}

// Calls f(acc fragment, n, tile row, tile column) for every group of
// outputs a lane holds after tile_product: n = 4 consecutive columns in
// FP32, 2 in the MMA modes; rows are those of a 16-row strip at `strip0`.
template <int MODE, class F>
__device__ __forceinline__ void for_outputs(const Acc& acc, int strip0,
                                            int lane, F&& f) {
  if constexpr (MODE == FP32) {
    const int r = strip0 + (lane / 8) * 4, n = (lane % 8) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(std::integral_constant<int, 4>(), acc.v[2 * i + h], r + i,
          h * 32 + n);
  } else {
    const int r = strip0 + (lane >> 2), n = (lane & 3) * 2;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(std::integral_constant<int, 2>(), acc.v[nt] + 2 * h, r + 8 * h,
          nt * 8 + n);
  }
}

// raise a kernel's dynamic shared memory cap to at least `bytes` (above
// the default 48 KB), once per device and size; cap[] keeps what was set
template <class K>
cudaError_t allow_smem(K kern, int bytes, int (&cap)[MAX_DEVICES]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= MAX_DEVICES || cap[dev] < bytes))
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) cap[dev] = bytes;
  return cudaSuccess;
}

}  // namespace tile
