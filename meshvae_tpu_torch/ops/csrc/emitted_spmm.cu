// Persistent block-sparse SpMM behind a TMA pipeline, for Hopper (sm_90a):
//
//     y[n_pad, C] = L @ x
//
// L is stored as `blocks` [nb, 128, 128] plus the row-grouped view
// `g_idx` [nR, G] (index into blocks; nb marks a padded slot, which adds
// nothing), `g_bcol` [nR * G] (column block of each slot) and `tile_mask`
// [nb, 8] (uint8, bit t of byte s: the 16 x 16 tile (s, t) holds a
// nonzero). x is [n_col_blocks * 128, C] with C % 128 == 0, in the blocks'
// dtype: fp32 (IEEE fp32 FMAs, no TF32) or bf16 (each product of two bf16
// values is exact in fp32). The sum is fp32 and y, in x's dtype, is
// rounded once.
//
// Replaces TPU kernel #10, `emitted_spmm` (benchmarks/emitted_probe.py:45,
// pallas_call at :154), the "emitted pipeline" probe: one grid step per
// column panel walks every row with manual double-buffered DMAs
// (`pltpu.make_async_copy` completing on DMA semaphores) of the whole row,
// so that the per-grid-step cost of the classic pipeline is paid once per
// panel. It asks whether an explicitly emitted copy pipeline beats the
// auto-pipelined grouped kernel. The Hopper counterpart of that pipeline
// is TMA copies completing on mbarriers, so this kernel is the same
// question asked of bsr_grouped_spmm (whose cp.async ring is the
// auto-pipelined side), at equal inner product.
//
// What bounds it: the bytes a call must move, the occupied tiles of L, x
// once and y (at the 80k template's level 0 in bf16, C = 512: ~24 MB of
// tiles, 82 MB each of x and y, ~0.057 ms at 3.35 TB/s); the operations on
// the occupied tiles are far below the tensor cores' rate and, in fp32, a
// few times below the CUDA cores'.
//
// Design:
//   * a persistent grid of as many CTAs as the occupancy API lets stay
//     resident (or fewer per SM when the caller asks), each taking work
//     items (128-row block row, 64 columns) in a strided walk of a work
//     list that the host builds from tile_mask when the operator is made:
//     row blocks by their occupied k chunks, most first (stable), each
//     row's column tiles in order. The longest items start first and the
//     short ones fill the end of the walk (where there are more items than
//     resident CTAs);
//   * eight consumer warps, one per 16-row strip of the row block, run the
//     occupied-tile engine's products (tile_engine.cuh `tile_product`):
//     the same tiles in the same order as bsr_grouped_spmm, so in fp32 the
//     two agree bit for bit, and in bf16 the same MMAs run;
//   * one producer warp keeps a ring of STAGES chunks full: a chunk is the
//     x rows [16, 64] of one k chunk of one slot and the A tiles [16, 16]
//     of the strips whose bit is set, each one TMA copy
//     (cp.async.bulk.tensor.2d) completing on the stage's full mbarrier;
//     the consumer warps release a stage on its empty mbarrier. The x
//     chunk lands once per row block (not once per 64-row half), and the
//     stream runs across item boundaries, so the next item's first chunks
//     land while the current item's epilogue stores;
//   * TMA cannot pad shared-memory rows, so the bf16 boxes use its swizzle
//     (32 bytes for the A tiles, 128 bytes for the x chunk) and the
//     fragment addresses apply the same XOR, which keeps ldmatrix free of
//     bank conflicts. The fp32 boxes need none: a quarter warp reads one A
//     row (a broadcast) and 128 contiguous bytes of x.
//   * ptxas fits the bf16 instantiation in 56 registers for four resident
//     CTAs per SM, with an 8-byte spill; a register budget for three CTAs
//     per SM removes the spill but ran slower at the 80k level 0.

#include <cuda.h>

#include <algorithm>

#include "tile_engine.cuh"

namespace {

using namespace tile;

constexpr int CWARPS = BLOCK / KT;             // consumer warps, one a strip
constexpr int THREADS10 = 32 * (CWARPS + 1);   // and the producer warp
constexpr int ALIGN = 1024;                    // 128-byte swizzle period

template <int MODE>
struct Stage {
  using T = Elem<MODE>;
  static constexpr int ES = static_cast<int>(sizeof(T));
  static constexpr int X_BYTES = KT * BN * ES;     // x chunk [16][64]
  static constexpr int A_BYTES = KT * KT * ES;     // one strip's A tile
  static constexpr int BYTES = X_BYTES + CWARPS * A_BYTES;
  static constexpr int STAGES = MODE == BF16 ? 6 : 4;
  static constexpr int RING = STAGES * BYTES;
  static constexpr int SMEM = ALIGN + RING + 2 * STAGES * 8;  // + barriers
  static_assert(BYTES % ALIGN == 0 && X_BYTES % ALIGN == 0,
                "every x chunk starts on the swizzle period");
  // tile_product's layout policy: element offsets as TMA wrote the boxes
  // (bf16: 16-byte piece index XOR the 128-byte row bits; A rows are 32
  // bytes, x rows 128)
  struct Layout {
    static __device__ __forceinline__ int a(int r, int k) {
      const int b = (r * KT + k) * ES;
      return (MODE == BF16 ? b ^ ((b >> 3) & 0x10) : b) / ES;
    }
    static __device__ __forceinline__ int x(int k, int n) {
      const int b = (k * BN + n) * ES;
      return (MODE == BF16 ? b ^ ((b >> 3) & 0x70) : b) / ES;
    }
  };
};

struct Shape {
  int nb, g, n_col_blocks, c, n_ct, n_items;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// the box of `map` at (column c0, row c1) into dst, completing on bar
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// slot `slot` of `row`: its block and column block and its two strip words,
// false for a padded slot (or one outside x)
__device__ __forceinline__ bool slot_of(const int* __restrict__ g_idx,
                                        const int* __restrict__ g_bcol,
                                        const uint32_t* __restrict__ mask,
                                        const Shape& s, int row, int slot,
                                        int& bi, int& bc, uint32_t& w0,
                                        uint32_t& w1) {
  bi = __ldg(g_idx + row * s.g + slot);
  bc = __ldg(g_bcol + row * s.g + slot);
  if (bi < 0 || bi >= s.nb || bc < 0 || bc >= s.n_col_blocks) return false;
  w0 = __ldg(mask + 2 * bi);
  w1 = __ldg(mask + 2 * bi + 1);
  return true;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS10)
emitted_spmm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_x,
                    const int* __restrict__ g_idx,
                    const int* __restrict__ g_bcol,
                    const uint32_t* __restrict__ mask,
                    const int* __restrict__ order, Elem<MODE>* __restrict__ y,
                    Shape s) {
  using S = Stage<MODE>;
  using T = Elem<MODE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((ALIGN - (smem_addr(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::RING);
  uint64_t* empty = full + S::STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  if (warp == CWARPS) {  // the producer: one lane issues every copy
    if (lane != 0) return;
    for (int item = blockIdx.x; item < s.n_items; item += gridDim.x) {
      const int row = __ldg(order + item / s.n_ct);
      const int col0 = (item % s.n_ct) * BN;
      for (int slot = 0; slot < s.g; ++slot) {
        int bi, bc;
        uint32_t w0, w1;
        if (!slot_of(g_idx, g_bcol, mask, s, row, slot, bi, bc, w0, w1))
          continue;
        for (uint32_t need = needed(w0 | w1); need; need &= need - 1) {
          const int kt = __ffs(need) - 1;
          uint32_t strips = chunk_strips(w0, w1, kt);
          unsigned char* buf = ring + stage * S::BYTES;
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect(full + stage,
                      S::X_BYTES + __popc(strips) * S::A_BYTES);
          tma_2d(buf, &map_x, col0, bc * BLOCK + kt * KT, full + stage);
          for (; strips; strips &= strips - 1) {
            const int st = __ffs(strips) - 1;
            tma_2d(buf + S::X_BYTES + st * S::A_BYTES, &map_a, kt * KT,
                   bi * BLOCK + st * KT, full + stage);
          }
          if (++stage == S::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warp w owns rows 16w..16w+15 of the item's row block
  for (int item = blockIdx.x; item < s.n_items; item += gridDim.x) {
    const int row = __ldg(order + item / s.n_ct);
    const int col0 = (item % s.n_ct) * BN;
    Acc acc;
    zero(acc);
    for (int slot = 0; slot < s.g; ++slot) {
      int bi, bc;
      uint32_t w0, w1;
      if (!slot_of(g_idx, g_bcol, mask, s, row, slot, bi, bc, w0, w1))
        continue;
      const uint32_t mine = (warp < 4 ? w0 : w1) >> (8 * (warp & 3));
      for (uint32_t need = needed(w0 | w1); need; need &= need - 1) {
        const int kt = __ffs(need) - 1;
        const unsigned char* buf = ring + stage * S::BYTES;
        mbar_wait(full + stage, phase);
        if ((mine >> kt) & 1u)
          tile_product<MODE, typename S::Layout>(
              reinterpret_cast<const T*>(buf + S::X_BYTES
                                         + warp * S::A_BYTES),
              reinterpret_cast<const T*>(buf), lane, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == S::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // epilogue: one write (one rounding) per output, while the producer
    // fills the ring with the next item's chunks
    const size_t row0 = (size_t)row * BLOCK;
    for_outputs<MODE>(acc, warp * KT, lane, [&](auto n, const float* v,
                                                int r, int n0) {
      finish<decltype(n)::value>(v, 1.f, static_cast<const T*>(nullptr),
                                 static_cast<const T*>(nullptr),
                                 static_cast<const float*>(nullptr), 0, y,
                                 (row0 + r) * s.c + col0 + n0, r, n0);
    });
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links against nothing but the CUDA runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// a row-major [rows, cols] array as boxes of [box_rows, box_cols]
template <int MODE>
cudaError_t tensor_map(CUtensorMap* map, const void* base, uint64_t rows,
                       uint64_t cols, uint32_t box_rows, uint32_t box_cols,
                       CUtensorMapSwizzle swizzle) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(Elem<MODE>)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map,
      MODE == BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// per device: SMs and the occupancy API's resident CTAs per SM, by mode
struct Occupancy {
  int sms = 0, per_sm = 0;
};

template <int MODE>
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
  auto kern = emitted_spmm_kernel<MODE>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Stage<MODE>::SMEM);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &o.per_sm, kern, THREADS10, Stage<MODE>::SMEM);
  if (err != cudaSuccess) return err;
  if (o.per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < MAX_DEVICES) cache[dev] = o;
  *out = o;
  return cudaSuccess;
}

template <int MODE>
int launch(const void* blocks, const int* g_idx, const int* g_bcol,
           const void* tile_mask, const int* order, const void* x, void* y,
           const Shape& s, int ctas_per_sm, cudaStream_t st) {
  Occupancy o;
  cudaError_t err = occupancy<MODE>(&o);
  CUtensorMap map_a, map_x;
  const auto sw_a = MODE == BF16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                 : CU_TENSOR_MAP_SWIZZLE_NONE;
  const auto sw_x = MODE == BF16 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (err == cudaSuccess)
    err = tensor_map<MODE>(&map_a, blocks, (uint64_t)s.nb * BLOCK, BLOCK, KT,
                           KT, sw_a);
  if (err == cudaSuccess)
    err = tensor_map<MODE>(&map_x, x, (uint64_t)s.n_col_blocks * BLOCK, s.c,
                           KT, BN, sw_x);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_sm = ctas_per_sm > 0 ? std::min(ctas_per_sm, o.per_sm)
                                     : o.per_sm;
  const int grid = std::max(1, std::min(s.n_items, o.sms * per_sm));
  emitted_spmm_kernel<MODE><<<grid, THREADS10, Stage<MODE>::SMEM, st>>>(
      map_a, map_x, g_idx, g_bcol, static_cast<const uint32_t*>(tile_mask),
      order, static_cast<Elem<MODE>*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). `dtype` is 0 = fp32 (blocks, x
// and y fp32), 1 = bf16. Shapes, dtypes and alignment are checked by the
// Python wrapper: c % 128 == 0, every pointer 16-byte aligned, tile_mask
// [nb, 8] uint8, order [n_rows] int32 (a permutation of the row blocks,
// the work list), y [n_rows * 128, c], x [n_col_blocks * 128, c].
// ctas_per_sm <= 0 takes the occupancy API's resident count; a positive
// value is capped by it. Launches on `stream` and returns the CUDA error
// of the launch (or of encoding its tensor maps).
extern "C" int emitted_spmm(const void* blocks, const int* g_idx,
                            const int* g_bcol, const void* tile_mask,
                            const int* order, const void* x, void* y, int nb,
                            int n_rows, int g, int n_col_blocks, int c,
                            int dtype, int ctas_per_sm, void* stream) {
  if (c <= 0 || c % 128 || n_rows <= 0 || g <= 0 || nb <= 0
      || tile_mask == nullptr || order == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_ct = c / BN;
  const Shape s{nb, g, n_col_blocks, c, n_ct, n_rows * n_ct};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<FP32>(blocks, g_idx, g_bcol, tile_mask, order, x, y, s,
                          ctas_per_sm, st);
    case 1:
      return launch<BF16>(blocks, g_idx, g_bcol, tile_mask, order, x, y, s,
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
    err = cudaFuncGetAttributes(&attr, emitted_spmm_kernel<FP32>);
    if (err == cudaSuccess) err = occupancy<FP32>(&o);
    *dynamic_smem = Stage<FP32>::SMEM;
  } else if (dtype == 1) {
    err = cudaFuncGetAttributes(&attr, emitted_spmm_kernel<BF16>);
    if (err == cudaSuccess) err = occupancy<BF16>(&o);
    *dynamic_smem = Stage<BF16>::SMEM;
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
