// Persistent block-sparse SpMM with a cp.async ring, for Hopper (sm_90a):
//
//     y[n_pad, C] = L @ x
//
// L is stored as `blocks` [nb, 128, 128] plus the row-grouped view
// `g_idx` [nR, G] (index into blocks; nb marks a padded slot, which adds
// nothing) and `g_bcol` [nR * G] (column block of each slot). x is
// [n_col_blocks * 128, C] with C % 128 == 0, in the blocks' dtype: fp32
// (IEEE fp32 FMAs, no TF32) or bf16 (each product of two bf16 values is
// exact in fp32). The sum is fp32 and y, in x's dtype, is rounded once.
//
// Replaces TPU kernel #10, `emitted_spmm` (benchmarks/emitted_probe.py:45,
// pallas_call at :154), the "emitted pipeline" probe: one grid step per
// column panel walks every row with manual double-buffered DMAs of the
// whole row (g blocks and g x slabs) so that the per-grid-step cost of the
// classic pipeline is paid once per panel. On the H100 both halves of that
// layout are wrong: C = 512 gives a handful of panels for 132 SMs, and a
// double-buffered row of G blocks (G x 32 KB in bf16) does not fit in 227
// KB of shared memory once G >= 4. The Hopper form of "few, long-lived
// grid steps with an explicit copy pipeline" is:
//
//   * a persistent grid of as many CTAs as the occupancy API lets stay
//     resident (or fewer per SM when the caller asks), each walking the
//     work items (64-row half of a row block, 64-column tile) in a strided
//     loop: item = blockIdx.x, blockIdx.x + gridDim.x, ...;
//   * each item consumed as a stream of (block chunk [64 x 32], x-slab
//     chunk [32 x 64]) pairs through a STAGES-deep ring in shared memory,
//     filled by 16-byte cp.async copies (one commit group per chunk, the
//     wait at STAGES - 2 pending groups), so chunk i + STAGES - 1 is in
//     flight while chunk i's FMAs run; bf16 chunks land raw and are widened
//     to fp32 once, into one more shared chunk, before their FMAs;
//   * the ring's stream runs across item boundaries: the producer walks the
//     same (item, slot, chunk) sequence as the consumer, STAGES - 1 chunks
//     ahead, so the next item's first chunks are issued before the current
//     item's epilogue stores.
//
// The inner product is bsr_grouped_spmm's (bsr_tile.cuh): 16 x 16 threads,
// a 4 x 4 fp32 micro-tile each, rank-1 updates in k order, slots in order,
// so an A/B against bsr_grouped_spmm measures the pipeline and the grid,
// not another inner product (in fp32 the two agree bit for bit).
//
// What bounds it: the bytes a call must move (blocks, indices, x once, y)
// at C <= 1024, far below the operation rate. Like bsr_grouped_spmm it runs
// every FMA of each dense 128 x 128 block (~1.5% nonzero) on the CUDA
// cores, so FMAs and their operand traffic set its time, many times the
// byte floor. Tensor cores (mma / wgmma), TMA and mbarriers are later work.

#include <cuda_pipeline_primitives.h>

#include <algorithm>

#include "bsr_tile.cuh"

namespace {

using namespace bsr;

constexpr int KR = 32;              // K depth of one ring chunk
constexpr int STAGES = 3;           // chunks resident in the ring
constexpr int CHUNKS = BLOCK / KR;  // chunks per 128 x 128 block
constexpr int MAX_DEVICES = 16;

// Shared memory: the ring of STAGES raw chunks; with bf16 operands also
// one fp32 chunk that each landed chunk is widened into once (every element
// is converted once, as bsr_grouped_spmm converts once when it stages).
template <typename T>
struct Ring {
  static constexpr bool WIDEN = sizeof(T) == 2;
  static constexpr int A = BM * KR;        // block chunk [BM][KR], row-major
  static constexpr int B = KR * BN;        // x-slab chunk [KR][BN]
  static constexpr int STAGE = A + B;      // elements of one stage
  static constexpr int RAW_BYTES = STAGES * STAGE * static_cast<int>(sizeof(T));
  static constexpr int BYTES =
      RAW_BYTES + (WIDEN ? STAGE * static_cast<int>(sizeof(float)) : 0);
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per copy
  static constexpr int A_COPIES = A / VEC / THREADS;  // per thread
  static constexpr int B_COPIES = B / VEC / THREADS;
  static_assert(A % (VEC * THREADS) == 0 && B % (VEC * THREADS) == 0,
                "each thread copies whole 16-byte pieces");
};

struct Shape {
  int nb, g, n_col_blocks, c, n_ct, n_items;
};

// work item -> (row block, first row of its 64-row half, first column)
struct Item {
  int row, m0, col0;
};

__device__ __forceinline__ Item decode(int item, const Shape& s) {
  const int rh = item / s.n_ct;
  return Item{rh / (BLOCK / BM), (rh % (BLOCK / BM)) * BM,
              (item % s.n_ct) * BN};
}

// the block of slot `slot` of row `row` and its column block, or -1 for a
// padded slot (or one outside x): uniform across the CTA
__device__ __forceinline__ int slot_block(const int* __restrict__ g_idx,
                                          const int* __restrict__ g_bcol,
                                          const Shape& s, int row, int slot,
                                          int* bc) {
  const int bi = g_idx[row * s.g + slot];
  *bc = g_bcol[row * s.g + slot];
  return (bi < 0 || bi >= s.nb || *bc < 0 || *bc >= s.n_col_blocks) ? -1
                                                                     : bi;
}

// The producer's position in the CTA's chunk stream: (item, slot, chunk);
// item >= n_items once the stream has ended.
struct Cursor {
  int item, slot, kc;
};

// move to the first real slot at or after cur.slot, in this item or a
// later one of this CTA
__device__ __forceinline__ void seek(Cursor& cur, const int* g_idx,
                                     const int* g_bcol, const Shape& s) {
  while (cur.item < s.n_items) {
    const int row = decode(cur.item, s).row;
    for (; cur.slot < s.g; ++cur.slot) {
      int bc;
      if (slot_block(g_idx, g_bcol, s, row, cur.slot, &bc) >= 0) return;
    }
    cur.item += gridDim.x;
    cur.slot = 0;
  }
}

__device__ __forceinline__ void advance(Cursor& cur, const int* g_idx,
                                        const int* g_bcol, const Shape& s) {
  if (cur.item >= s.n_items) return;
  if (++cur.kc == CHUNKS) {
    cur.kc = 0;
    ++cur.slot;
    seek(cur, g_idx, g_bcol, s);
  }
}

// Issue the cursor's chunk into `stage` (nothing once the stream has
// ended) and commit one group, so every thread counts the same groups.
template <typename T>
__device__ __forceinline__ void issue(T* ring, int stage, const Cursor& cur,
                                      const T* __restrict__ blocks,
                                      const int* g_idx, const int* g_bcol,
                                      const T* __restrict__ x,
                                      const Shape& s) {
  using R = Ring<T>;
  if (cur.item < s.n_items) {
    const Item it = decode(cur.item, s);
    int bc;
    const int bi = slot_block(g_idx, g_bcol, s, it.row, cur.slot, &bc);
    T* a = ring + stage * R::STAGE;
    T* b = a + R::A;
    const T* ga = blocks + (size_t)bi * BLOCK * BLOCK + (size_t)it.m0 * BLOCK
                  + cur.kc * KR;
#pragma unroll
    for (int i = 0; i < R::A_COPIES; ++i) {
      const int e = (threadIdx.x + i * THREADS) * R::VEC;
      __pipeline_memcpy_async(a + e, ga + (size_t)(e / KR) * BLOCK + e % KR,
                              16);
    }
    const T* gb = x + ((size_t)bc * BLOCK + cur.kc * KR) * s.c + it.col0;
#pragma unroll
    for (int i = 0; i < R::B_COPIES; ++i) {
      const int e = (threadIdx.x + i * THREADS) * R::VEC;
      __pipeline_memcpy_async(b + e, gb + (size_t)(e / BN) * s.c + e % BN,
                              16);
    }
  }
  __pipeline_commit();
}

// bf16 stage -> fp32 chunk, four elements per thread and step (an 8-byte
// read, a 16-byte write: consecutive threads, consecutive addresses)
__device__ __forceinline__ void widen(const __nv_bfloat16* raw, float* wide) {
  constexpr int STAGE = Ring<__nv_bfloat16>::STAGE;
#pragma unroll
  for (int i = 0; i < STAGE / 4 / THREADS; ++i) {
    const int e = (threadIdx.x + i * THREADS) * 4;
    store4(wide + e, load4(raw + e));
  }
}

// acc += A chunk [BM x KR] @ B chunk [KR x BN] on this thread's 4 x 4
// outputs, k in order (fp32 chunks: the fp32 ring, or the widened chunk)
__device__ __forceinline__ void consume(const float* a, const float* b,
                                        const Coords& q,
                                        float (&acc)[4][4]) {
#pragma unroll
  for (int k0 = 0; k0 < KR; k0 += 4) {
    float ar[4][4];  // ar[kk][i] = A[ty * 4 + i][k0 + kk]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = load4(a + (q.ty * 4 + i) * KR + k0);
      ar[0][i] = v.x; ar[1][i] = v.y; ar[2][i] = v.z; ar[3][i] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 v = load4(b + (k0 + kk) * BN + q.tx * 4);
      const float br[4] = {v.x, v.y, v.z, v.w};
      fma_4x4(ar[kk], br, acc);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
emitted_spmm_kernel(const T* __restrict__ blocks,
                    const int* __restrict__ g_idx,
                    const int* __restrict__ g_bcol,
                    const T* __restrict__ x, T* __restrict__ y, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const Coords q = coords(threadIdx.x);

  // prologue: the first STAGES - 1 chunks of this CTA's stream
  Cursor cur{static_cast<int>(blockIdx.x), 0, 0};
  seek(cur, g_idx, g_bcol, s);
  int issued = 0, consumed = 0;
  for (; issued < STAGES - 1; ++issued) {
    issue(ring, issued % STAGES, cur, blocks, g_idx, g_bcol, x, s);
    advance(cur, g_idx, g_bcol, s);
  }

  for (int item = blockIdx.x; item < s.n_items; item += gridDim.x) {
    const Item it = decode(item, s);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int slot = 0; slot < s.g; ++slot) {
      int bc;
      if (slot_block(g_idx, g_bcol, s, it.row, slot, &bc) < 0) continue;
      for (int kc = 0; kc < CHUNKS; ++kc) {
        // chunk `consumed` has landed once at most STAGES - 2 younger
        // groups are pending; the barrier publishes it to every thread and
        // retires the stage read last time, which the next issue refills
        __pipeline_wait_prior(STAGES - 2);
        __syncthreads();
        issue(ring, issued % STAGES, cur, blocks, g_idx, g_bcol, x, s);
        advance(cur, g_idx, g_bcol, s);
        ++issued;
        const T* a = ring + (consumed % STAGES) * Ring<T>::STAGE;
        ++consumed;
        if constexpr (Ring<T>::WIDEN) {
          // the fp32 chunk was last read before the barrier above
          float* wide = reinterpret_cast<float*>(smem + Ring<T>::RAW_BYTES);
          widen(a, wide);
          __syncthreads();
          consume(wide, wide + Ring<T>::A, q, acc);
        } else {
          consume(a, a + Ring<T>::A, q, acc);
        }
      }
    }
    // epilogue: one write (one rounding) per output; the ring keeps
    // filling with the next item's chunks meanwhile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t off = (size_t)(it.row * BLOCK + it.m0 + q.ty * 4 + i) * s.c
                         + it.col0 + q.tx * 4;
      store4(y + off, make_float4(acc[i][0], acc[i][1], acc[i][2],
                                  acc[i][3]));
    }
  }
  __pipeline_wait_prior(0);  // only empty groups remain
}

// per device: SMs and the occupancy API's resident CTAs per SM, by dtype
struct Occupancy {
  int sms = 0, per_sm = 0;
};

template <typename T>
cudaError_t occupancy(Occupancy* out) {
  static Occupancy cache[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cache[dev].sms > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  Occupancy o;
  auto kern = emitted_spmm_kernel<T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Ring<T>::BYTES);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, kern,
                                                        THREADS,
                                                        Ring<T>::BYTES);
  if (err != cudaSuccess) return err;
  if (o.per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < MAX_DEVICES) cache[dev] = o;
  *out = o;
  return cudaSuccess;
}

template <typename T>
int launch(const void* blocks, const int* g_idx, const int* g_bcol,
           const void* x, void* y, const Shape& s, int ctas_per_sm,
           cudaStream_t st) {
  Occupancy o;
  cudaError_t err = occupancy<T>(&o);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_sm = ctas_per_sm > 0 ? std::min(ctas_per_sm, o.per_sm)
                                     : o.per_sm;
  const int grid = std::max(1, std::min(s.n_items, o.sms * per_sm));
  emitted_spmm_kernel<T><<<grid, THREADS, Ring<T>::BYTES, st>>>(
      static_cast<const T*>(blocks), g_idx, g_bcol,
      static_cast<const T*>(x), static_cast<T*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). `dtype` is 0 = fp32 (blocks, x
// and y fp32), 1 = bf16. Shapes, dtypes and alignment are checked by the
// Python wrapper: c % 128 == 0, every pointer 16-byte aligned, y
// [n_rows * 128, c], x [n_col_blocks * 128, c]. ctas_per_sm <= 0 takes the
// occupancy API's resident count; a positive value is capped by it.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int emitted_spmm(const void* blocks, const int* g_idx,
                            const int* g_bcol, const void* x, void* y, int nb,
                            int n_rows, int g, int n_col_blocks, int c,
                            int dtype, int ctas_per_sm, void* stream) {
  if (c <= 0 || c % 128 || n_rows <= 0 || g <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_ct = c / BN;
  const Shape s{nb, g, n_col_blocks, c, n_ct, n_rows * (BLOCK / BM) * n_ct};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(blocks, g_idx, g_bcol, x, y, s, ctas_per_sm, st);
    case 1:
      return launch<__nv_bfloat16>(blocks, g_idx, g_bcol, x, y, s,
                                   ctas_per_sm, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What the compiler and the occupancy API gave the kernel of `dtype` on the
// current device: registers per thread, static and dynamic shared memory
// per CTA (bytes), local memory per thread (spills), resident CTAs per SM
// and the SM count. Returns a CUDA error code.
extern "C" int emitted_spmm_info(int dtype, int* regs, int* static_smem,
                                 int* dynamic_smem, int* local_bytes,
                                 int* ctas_per_sm, int* sms) {
  cudaFuncAttributes attr;
  Occupancy o;
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncGetAttributes(&attr, emitted_spmm_kernel<float>);
    if (err == cudaSuccess) err = occupancy<float>(&o);
    *dynamic_smem = Ring<float>::BYTES;
  } else if (dtype == 1) {
    err = cudaFuncGetAttributes(&attr, emitted_spmm_kernel<__nv_bfloat16>);
    if (err == cudaSuccess) err = occupancy<__nv_bfloat16>(&o);
    *dynamic_smem = Ring<__nv_bfloat16>::BYTES;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *static_smem = static_cast<int>(attr.sharedSizeBytes);
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *ctas_per_sm = o.per_sm;
  *sms = o.sms;
  return 0;
}
