// The Chebyshev conv's channel mix and its weight gradient for Hopper
// (sm_90a), reading the K orders T_k of the basis where bsr_grouped_spmm
// leaves them:
//
//     mix  out[m, :] = sum_k T_k[m, :] @ W_k        out [M, F_out]
//     dW   dW[k]     = T_k^T @ g                    dW  [K, F_pad, F_out]
//
// Each T_k is its own contiguous [M, F_pad] array (M = n_pad * B rows of
// the padded [n_pad, B, F_pad] layout): T_0 the padded input, T_1.. the
// kernel's outputs. The K base pointers come by value in one struct, so
// nothing is gathered or concatenated first. W is [K, F_pad, F_out], g
// [M, F_out], all in the operator's dtype. Two modes:
//
//   FP32  IEEE fp32 FMAs on the CUDA cores (no TF32): one chain per output
//         in the order (k, f) for the mix, rows in a fixed order for dW.
//   BF16  bf16 operands on the tensor cores (mma.sync m16n8k16, products
//         exact in fp32), fp32 accumulation, one rounding to bf16 per
//         output.
//
// dW sums over M in two launches: each CTA writes fp32 partial sums of
// its rows to a workspace the caller allocates, and a reduce launch adds
// them in a fixed order and rounds once, so a replay gives the same bits.
//
// Replaces no TPU kernel: meshvae_tpu/ops/pallas_cheb.py `_basis_mix`
// (:826) concatenates the orders (:869) and leaves the mix and dW to one
// XLA dot_general each (:870, :895), and the port did the same with
// torch.cat and cuBLAS. That concatenation wrote and re-read the whole
// basis once more per conv: on the 80k template in bf16 (K = 10, B = 32)
// about 5.5 ms of copies a train step, 23% of the device's time.
//
// What bounds it: the bytes. The mix reads every T_k once and writes out;
// dW reads every T_k and g once. Both do 2 * K * F_pad * F_out operations
// per row, a few to 32 per byte read: below the tensor cores' rate in
// bf16 and near the CUDA cores' 67 TFLOP/s in fp32 only at F_out = 32.
//
// Design:
//
//   Packing (BF16). A row of F_pad = 4 or 8 bf16 values is 8 or 16 bytes,
//   too narrow for ldmatrix. G = 16 / F_pad consecutive rows are read as
//   one packed row of 16 values (the arrays are contiguous, so the packed
//   view [M / G, G * F_pad] is the same memory), and W_k becomes the
//   block-diagonal kron(I_G, W_k) [G * F_pad, G * F_out], whose diagonal
//   blocks keep the rows apart; the output's packed view [M / G, G * F_out]
//   is again out itself. F_pad a multiple of 16 packs nothing (G = 1).
//   Any other F_pad takes G = 1 and rows padded to 16 with zeros.
//
//   Staging. A panel of packed rows of each order is contiguous in global
//   memory, so one thread moves it with one bulk async copy
//   (cp.async.bulk) into a ring of stages in shared memory, completing on
//   the stage's mbarrier. The mix's ring keeps 5 panels in flight where
//   its CTAs walk many (3 stages in a small call, which its CTAs' number
//   rather than their depth serves); dW's holds 3 stages of all K orders
//   (2 in fp32). Rows past M are not copied. Rows so staged lie at the
//   array's own pitch, which costs ldmatrix at most 2-way bank conflicts
//   at 32-byte rows; g's packed rows of 128 bytes and more (F_pad 4 at
//   F_out 16) would meet 8-way ones, so they go by 16-byte cp.async into rows
//   padded to an odd number of 16-byte chunks, and every thread's
//   copies arrive on the same mbarrier (cp.async.mbarrier.arrive). A row
//   that is not a whole number of 16-byte chunks, or an unaligned
//   pointer, takes the block's element copies into padded rows instead.
//   A CTA issues its first panels before it stages W, so their latency
//   and W's overlap.
//
//   mix, BF16: 4 warps; a CTA stages the B fragments of every kron(I_G,
//   W_k) it needs once, in fragment order (one 8-byte load per lane per
//   mma), and then walks its panels (a persistent grid of the occupancy's
//   CTAs per SM) and, per panel, the K orders as ring items. Warp w owns
//   mt 16-row m tiles of the panel and all NT 8-column n tiles of its slab
//   (grid.y cuts wide outputs into slabs), so each A fragment (ldmatrix)
//   serves NT mma and each B fragment mt.
//   mix, FP32: 4 warps; thread t owns rows t, t + 128, .. of the panel and
//   NS columns; W_k's slab sits in shared memory and is read as broadcast
//   float4s, T rows as float4s.
//   dW, BF16: 8 warps; a ring item is one panel of 64 packed rows with all
//   K orders (or a group of orders per grid.y) and its g rows. The output
//   tiles (order, 16 rows of T^T, 8 columns of g) are cut among the warps
//   in order; each 16-row chunk of the panel gives one mma per tile, with
//   A = T_k^T and B = g by ldmatrix.trans. At the end the warps' tiles go
//   through shared memory, the packed view's diagonal blocks are added
//   (in order) and the CTA's partial dW is written.
//   dW, FP32: 8 warps; thread u owns (order k, feature f) and NS columns
//   of one of RG groups of rows (the panel's rows in turns; RG takes the
//   threads the tasks leave over) and walks them: one T load and NS / 4
//   broadcast float4 loads of g per row; the groups are added in order at
//   the end.
//
// No call allocates, synchronises or uses atomics: each launch can be
// captured in a CUDA graph, and its results do not depend on timing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>  // memcpy
#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

enum Mode { FP32 = 0, BF16 = 1 };

constexpr int MAX_ORDERS = 32;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_STAGES = 6;
constexpr int BAR_BYTES = 16 * MAX_STAGES;  // the ring's mbarriers, first
constexpr int MIX_THREADS = 128;
constexpr int DW_THREADS = 256;
constexpr int DW_ROWS = 64;            // packed rows per dW panel
constexpr int DW_FP32_TASKS = 2;       // (order, feature) pairs per thread
constexpr int REDUCE_ROWS = 32;        // partial sums per output, in turn
constexpr int SOFT_SMEM = 113 * 1024;  // two CTAs per SM

struct Orders {
  const void* p[MAX_ORDERS];
};

// where and how a panel of rows of the packed view [m, r] is staged
struct Rows {
  long long m;  // rows of the packed view
  int r;        // elements of a packed row in global memory
  int seg;      // a packed row is r / seg segments of seg elements ...
  int segp;     // ... each placed at a pitch of segp in shared memory
  int pitch;    // shared-memory row pitch, elements
  int how;      // How: BULK, ASYNC (both need seg == segp, r * size % 16
                // == 0 and the base 16-byte aligned) or ELEM
};

// how a panel is staged: BULK, one bulk copy by one thread into rows
// packed at pitch r (for rows of at most 32 bytes, where ldmatrix meets
// at most 2-way bank conflicts, or where no lane reads two rows); ASYNC,
// 16-byte cp.async copies by the block into rows at an odd number of
// 16-byte chunks (no bank conflict); ELEM, the block's element copies
enum How { ELEM = 0, BULK = 1, ASYNC = 2 };

struct MixPlan {
  Rows a;        // T_k, packed
  int g, f, rk;  // rows per packed row, F_pad, packed width in smem
  int fshift;    // log2(f) where g > 1
  int k, f_out, npd;  // orders, F_out, F_out padded (a block's pitch)
  int mt;        // BF16: m tiles per warp; FP32: rows per thread
  int stages;
  long long panels;
  int pair;      // outputs may be stored two (BF16) or four (FP32) at once
};

struct DwPlan {
  Rows a, b;     // T_k and g, packed
  int g, f, rk;
  int k, kg, f_out, npd, gcols;  // gcols: packed columns of g in smem
  int tpw;       // BF16: tiles per warp
  int rg;        // FP32: row groups
  int stages;
  int astride;   // elements between the orders' panels in a stage
  long long panels;
};

// ---- small device helpers ---------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
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
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) from src to dst, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// 16 bytes from src to dst
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(dst)),
               "l"(src)
               : "memory");
}

// an arrival on bar once this thread's cp.async copies so far are done
// (counted in the barrier's arrivals: each thread arrives once a phase)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   saddr(bar))
               : "memory");
}

// the block's shared-memory writes before it, ordered before bulk copies
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16_rn(0.f);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// rows of the panel [row0, row0 + rows) that lie below m
__device__ __forceinline__ int valid_rows(long long row0, int rows,
                                          long long m) {
  return m - row0 < rows ? static_cast<int>(m - row0) : rows;
}

// bytes the bulk copy of a panel moves (0 for other copies)
template <typename T>
__device__ __forceinline__ uint32_t bulk_bytes(const Rows& s, int valid) {
  return s.how == BULK ? static_cast<uint32_t>(valid) * s.r * sizeof(T)
                       : 0u;
}

// rows [row0, row0 + rows) of the packed view into dst, the rows below m:
// thread 0's bulk copy (the caller has set the stage's expected bytes),
// the block's cp.async copies (each thread arrives on the barrier after
// all its copies of the stage), or the block's element copies, which
// write zeros past m
template <typename T, int THREADS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long row0, int rows,
                                           const Rows& s, uint64_t* bar) {
  const int valid = valid_rows(row0, rows, s.m);
  if (s.how == BULK) {
    if (threadIdx.x == 0)
      bulk_copy(dst, src + row0 * s.r, bulk_bytes<T>(s, valid), bar);
    return;
  }
  if (s.how == ASYNC) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = s.r / V, per = THREADS / cpr;  // chunks, rows a sweep
    const int j = threadIdx.x % cpr, first = threadIdx.x / cpr;
    if (first < per)
      for (int row = first; row < valid; row += per)
        cp_async16(dst + row * s.pitch + j * V, src + (row0 + row) * s.r
                                                     + j * V);
    return;
  }
  const int total = rows * s.r;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int row = e / s.r, col = e - row * s.r;
    const int seg = col / s.seg;
    dst[row * s.pitch + seg * s.segp + (col - seg * s.seg)] =
        row < valid ? src[(row0 + row) * s.r + col] : zero<T>();
  }
}

// the rows of a copied panel past m, as zeros (a dW sum reads them)
template <typename T, int THREADS>
__device__ __forceinline__ void zero_tail(T* dst, int valid, int rows,
                                          const Rows& s) {
  if (s.how == ELEM || valid == rows) return;
  for (int e = valid * s.pitch + threadIdx.x; e < rows * s.pitch;
       e += THREADS)
    dst[e] = zero<T>();
}

template <typename T, int THREADS>
__device__ __forceinline__ void zero_smem(T* p, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) p[i] = zero<T>();
}

// the ring's mbarriers, one per stage, each completing on thread 0's
// arrival with the bulk bytes and, with cp.async copies, every thread's
// (thread 0 initialises them; a __syncthreads must follow before their
// first use)
__device__ __forceinline__ uint64_t* ring_init(unsigned char* smem,
                                               int stages, int count) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, count);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return full;
}

// a ring item's place, stepped item by item without a division: its
// stage and the stage's use parity, and its order and panel (items walk
// the orders of a panel, then the CTA's next panel)
struct Cursor {
  int s, k;
  uint32_t phase;
  long long panel;

  __device__ __forceinline__ void next(int orders, int stages) {
    if (++k == orders) {
      k = 0;
      panel += gridDim.x;
    }
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(saddr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element [kk, blk * npd + n] of kron(I_g, W_k) with each block's
// columns padded to npd: W_k[kk - blk * f, n] on the diagonal blocks, else
// 0 (g > 1 only for f a power of two, f = 1 << fshift)
__device__ __forceinline__ float w_packed(const bf16* w, int k, int kk,
                                          int blk, int n, const MixPlan& p) {
  const int kb = p.g > 1 ? kk >> p.fshift : (kk < p.f ? 0 : -1);
  if (kb != blk || blk >= p.g || n >= p.f_out) return 0.f;
  return __bfloat162float(w[((size_t)k * p.f + kk - blk * p.f) * p.f_out
                            + n]);
}

constexpr int FILL = 4;  // W values each thread loads at once

// ---- mix, BF16 ----------------------------------------------------------

template <int NT, int MT>
__global__ void __launch_bounds__(MIX_THREADS)
cheb_mix_bf16_kernel(const __grid_constant__ Orders orders,
                     const bf16* __restrict__ w, bf16* __restrict__ out,
                     const __grid_constant__ MixPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool tracked = p.a.how != ELEM, async = p.a.how == ASYNC;
  uint64_t* full = ring_init(smem, p.stages, 1 + (async ? MIX_THREADS : 0));
  const int kcs = p.rk / 16;
  // [K][kcs][NT][32 lanes] B fragments, then the ring
  uint2* wf = reinterpret_cast<uint2*>(smem + BAR_BYTES);
  const int nfrag = p.k * kcs * NT * 32;
  bf16* abuf = reinterpret_cast<bf16*>(wf + nfrag);
  const int rows = 4 * 16 * p.mt;  // packed rows per panel
  const int stage = rows * p.a.pitch;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = blockIdx.y * NT * 8;

  const long long items =
      (p.panels - blockIdx.x + gridDim.x - 1) / gridDim.x * p.k;
  Cursor put{0, 0, 0u, blockIdx.x}, got = put;  // issue and compute sides
  long long issued = 0;
  auto issue = [&]() {
    const long long row0 = put.panel * rows;
    if (tracked && threadIdx.x == 0) {
      fence_async();
      mbar_expect(full + put.s,
                  bulk_bytes<bf16>(p.a, valid_rows(row0, rows, p.a.m)));
    }
    stage_rows<bf16, MIX_THREADS>(
        abuf + put.s * stage, static_cast<const bf16*>(orders.p[put.k]),
        row0, rows, p.a, full + put.s);
    if (async) cp_async_arrive(full + put.s);
    put.next(p.k, p.stages);
    ++issued;
  };

  // bulk copies need no zeroed stage: the first panels are in flight
  // while W is staged
  if (p.a.how == BULK)
    while (issued < items && issued < p.stages - 1) issue();

  // B fragments: lane (g, t) holds rows 2t, 2t+1 (b.x) and 2t+8, 2t+9
  // (b.y) of column g of the 16 x 8 tile, the lower row in the low half;
  // FILL fragments a thread, their loads in flight together
  for (int base = threadIdx.x; base < nfrag; base += FILL * MIX_THREADS) {
    float v[FILL][4];
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int i = base + u * MIX_THREADS;
      if (i >= nfrag) continue;
      const int ln = i % 32, nt = i / 32 % NT, kc = i / (32 * NT) % kcs;
      const int k = i / (32 * NT * kcs);
      const int nn = col0 + nt * 8 + ln / 4, kk = kc * 16 + 2 * (ln % 4);
      const int blk = nn / p.npd, n = nn - blk * p.npd;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[u][e] = w_packed(w, k, kk + e % 2 + e / 2 * 8, blk, n, p);
    }
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int i = base + u * MIX_THREADS;
      if (i < nfrag)
        wf[i] = make_uint2(pack2(v[u][0], v[u][1]), pack2(v[u][2], v[u][3]));
    }
  }
  if (p.a.how != BULK)  // padded rows: the pad columns stay zero
    zero_smem<bf16, MIX_THREADS>(abuf, p.stages * stage);
  __syncthreads();

  if (p.a.how != BULK)
    while (issued < items && issued < p.stages - 1) issue();

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int wrow = warp * 16 * p.mt;
  const int lrow = lane % 8 + (lane / 8) % 2 * 8, lcol = lane / 16 * 8;
  // this lane's output columns: block and column of each n tile's 2t
  int oblk[NT], ocol[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int nn = col0 + nt * 8 + 2 * (lane % 4);
    oblk[nt] = nn / p.npd;
    ocol[nt] = nn - oblk[nt] * p.npd;
  }
  for (long long i = 0; i < items; ++i) {
    __syncthreads();  // every warp is done with the last item's stage
    if (issued < items) issue();
    if (tracked) mbar_wait(full + got.s, got.phase);
    const int k = got.k;
    const bf16* a = abuf + got.s * stage;
    for (int kc = 0; kc < kcs; ++kc) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (mt < p.mt)
          ldsm_x4(af[mt],
                  a + (wrow + mt * 16 + lrow) * p.a.pitch + kc * 16 + lcol);
      const uint2* b = wf + (k * kcs + kc) * NT * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 bb = b[nt * 32];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (mt < p.mt) mma(acc[mt][nt], af[mt], bb.x, bb.y);
      }
    }
    const long long panel = got.panel;
    got.next(p.k, p.stages);
    if (k != p.k - 1) continue;
    // the panel is done: C fragment rows g, g+8, columns 2t, 2t+1
    const long long q0 = panel * rows + wrow;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long q = q0 + mt * 16 + lane / 4 + 8 * h;
          const int blk = oblk[nt], n = ocol[nt];
          const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
          if (mt >= p.mt || q >= p.a.m || blk >= p.g || n >= p.f_out)
            continue;
          bf16* o = out + (q * p.g + blk) * p.f_out + n;
          if (n + 1 < p.f_out && p.pair) {
            *reinterpret_cast<uint32_t*>(o) = pack2(v0, v1);
          } else {
            o[0] = __float2bfloat16_rn(v0);
            if (n + 1 < p.f_out) o[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// ---- mix, FP32 ----------------------------------------------------------

template <int NS, int TM>
__global__ void __launch_bounds__(MIX_THREADS)
cheb_mix_fp32_kernel(const __grid_constant__ Orders orders,
                     const float* __restrict__ w, float* __restrict__ out,
                     const __grid_constant__ MixPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool tracked = p.a.how != ELEM, async = p.a.how == ASYNC;
  uint64_t* full = ring_init(smem, p.stages, 1 + (async ? MIX_THREADS : 0));
  float* ws = reinterpret_cast<float*>(smem + BAR_BYTES);  // [K][rk][NS]
  const int nw = p.k * p.rk * NS;
  float* abuf = ws + nw;
  const int rows = MIX_THREADS * p.mt;
  const int stage = rows * p.a.pitch;
  const int col0 = blockIdx.y * NS;

  const long long items =
      (p.panels - blockIdx.x + gridDim.x - 1) / gridDim.x * p.k;
  Cursor put{0, 0, 0u, blockIdx.x}, got = put;
  long long issued = 0;
  auto issue = [&]() {
    const long long row0 = put.panel * rows;
    if (tracked && threadIdx.x == 0) {
      fence_async();
      mbar_expect(full + put.s,
                  bulk_bytes<float>(p.a, valid_rows(row0, rows, p.a.m)));
    }
    stage_rows<float, MIX_THREADS>(
        abuf + put.s * stage, static_cast<const float*>(orders.p[put.k]),
        row0, rows, p.a, full + put.s);
    if (async) cp_async_arrive(full + put.s);
    put.next(p.k, p.stages);
    ++issued;
  };

  if (p.a.how == BULK)
    while (issued < items && issued < p.stages - 1) issue();

  // FILL values a thread, their loads in flight together
  for (int base = threadIdx.x; base < nw; base += FILL * MIX_THREADS) {
    float v[FILL];
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int i = base + u * MIX_THREADS;
      const int c = i % NS, kf = i / NS, k = kf / p.rk, ff = kf - k * p.rk;
      v[u] = i < nw && ff < p.f && col0 + c < p.f_out
                 ? w[((size_t)k * p.f + ff) * p.f_out + col0 + c]
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < FILL; ++u)
      if (base + u * MIX_THREADS < nw) ws[base + u * MIX_THREADS] = v[u];
  }
  if (p.a.how != BULK) zero_smem<float, MIX_THREADS>(abuf, p.stages * stage);
  __syncthreads();

  if (p.a.how != BULK)
    while (issued < items && issued < p.stages - 1) issue();

  float acc[TM][NS];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < NS; ++c) acc[r][c] = 0.f;

  for (long long i = 0; i < items; ++i) {
    __syncthreads();
    if (issued < items) issue();
    if (tracked) mbar_wait(full + got.s, got.phase);
    const int k = got.k;
    const float* a = abuf + got.s * stage + threadIdx.x * p.a.pitch;
    const float* wk = ws + k * p.rk * NS;
    for (int f4 = 0; f4 < p.rk; f4 += 4) {
      float4 av[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        if (r < p.mt)
          av[r] = *reinterpret_cast<const float4*>(
              a + r * MIX_THREADS * p.a.pitch + f4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* wr = wk + (f4 + e) * NS;
#pragma unroll
        for (int c4 = 0; c4 < NS; c4 += 4) {
          const float4 b = *reinterpret_cast<const float4*>(wr + c4);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            if (r >= p.mt) continue;
            const float x = e == 0 ? av[r].x : e == 1 ? av[r].y
                          : e == 2 ? av[r].z : av[r].w;
            acc[r][c4] = fmaf(x, b.x, acc[r][c4]);
            acc[r][c4 + 1] = fmaf(x, b.y, acc[r][c4 + 1]);
            acc[r][c4 + 2] = fmaf(x, b.z, acc[r][c4 + 2]);
            acc[r][c4 + 3] = fmaf(x, b.w, acc[r][c4 + 3]);
          }
        }
      }
    }
    const long long panel = got.panel;
    got.next(p.k, p.stages);
    if (k != p.k - 1) continue;
    const long long q0 = panel * rows;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const long long q = q0 + r * MIX_THREADS + threadIdx.x;
      if (r < p.mt && q < p.a.m) {
        float* o = out + q * p.f_out + col0;
#pragma unroll
        for (int c4 = 0; c4 < NS; c4 += 4) {
          if (p.pair && col0 + c4 + 3 < p.f_out) {
            *reinterpret_cast<float4*>(o + c4) = make_float4(
                acc[r][c4], acc[r][c4 + 1], acc[r][c4 + 2], acc[r][c4 + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (col0 + c4 + j < p.f_out) o[c4 + j] = acc[r][c4 + j];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < NS; ++c) acc[r][c] = 0.f;
    }
  }
}

// ---- dW: the ring of panels, every order's rows and g's -----------------

// one ring item of dW: the panel's rows of kn orders of T, astride
// apart, then of g at bstart
template <typename T, int THREADS>
struct DwRing {
  const Orders& orders;
  const T* g;
  const DwPlan& p;
  uint64_t* full;
  T* buf;
  int k0, kn, bstart, stage;

  // the panel at `at` into its stage
  __device__ __forceinline__ void issue(const Cursor& at) const {
    const long long r0 = at.panel * DW_ROWS;
    T* dst = buf + at.s * stage;
    uint64_t* bar = full + at.s;
    if (tracked() && threadIdx.x == 0) {
      const int valid = valid_rows(r0, DW_ROWS, p.a.m);
      fence_async();
      mbar_expect(bar, kn * bulk_bytes<T>(p.a, valid)
                           + bulk_bytes<T>(p.b, valid));
    }
    for (int kl = 0; kl < kn; ++kl)
      stage_rows<T, THREADS>(dst + kl * p.astride,
                             static_cast<const T*>(orders.p[k0 + kl]), r0,
                             DW_ROWS, p.a, bar);
    stage_rows<T, THREADS>(dst + bstart, g, r0, DW_ROWS, p.b, bar);
    if (async()) cp_async_arrive(bar);
  }

  // some part arrives by bulk or cp.async copies (the barrier tracks it);
  // some part by cp.async (every thread arrives)
  __device__ __forceinline__ bool tracked() const {
    return p.a.how != ELEM || p.b.how != ELEM;
  }
  __device__ __forceinline__ bool async() const {
    return p.a.how == ASYNC || p.b.how == ASYNC;
  }

  // the stage of the panel at `at`, arrived, with the rows past m zero
  __device__ __forceinline__ const T* wait(const Cursor& at) const {
    T* dst = buf + at.s * stage;
    if (tracked()) mbar_wait(full + at.s, at.phase);
    const int valid = valid_rows(at.panel * DW_ROWS, DW_ROWS, p.a.m);
    if (valid < DW_ROWS) {  // the last panel: a uniform branch
      for (int kl = 0; kl < kn; ++kl)
        zero_tail<T, THREADS>(dst + kl * p.astride, valid, DW_ROWS, p.a);
      zero_tail<T, THREADS>(dst + bstart, valid, DW_ROWS, p.b);
      __syncthreads();
    }
    return dst;
  }
};

// ---- dW, BF16 -----------------------------------------------------------

template <int TPW>
__global__ void __launch_bounds__(DW_THREADS)
cheb_mix_dw_bf16_kernel(const __grid_constant__ Orders orders,
                        const bf16* __restrict__ g,
                        float* __restrict__ partial,
                        const __grid_constant__ DwPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool async = p.a.how == ASYNC || p.b.how == ASYNC;
  uint64_t* full = ring_init(smem, p.stages, 1 + (async ? DW_THREADS : 0));
  bf16* buf = reinterpret_cast<bf16*>(smem + BAR_BYTES);
  const int k0 = blockIdx.y * p.kg;
  const int kn = min(p.kg, p.k - k0);
  const int bstart = kn * p.astride;  // g's rows in a stage
  const int stage = bstart + DW_ROWS * p.b.pitch;
  const DwRing<bf16, DW_THREADS> ring{orders, g,  p,  full,  buf,
                                      k0,     kn, bstart, stage};
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mtn = p.rk / 16, ntn = p.gcols / 8;
  const int tiles = kn * mtn * ntn;

  if (p.a.how != BULK || p.b.how != BULK)  // the pad columns stay zero
    zero_smem<bf16, DW_THREADS>(buf, p.stages * stage);
  __syncthreads();

  const long long mine =
      (p.panels - blockIdx.x + gridDim.x - 1) / gridDim.x;
  Cursor put{0, 0, 0u, blockIdx.x}, got = put;
  long long issued = 0;
  for (; issued < mine && issued < p.stages - 1; ++issued) {
    ring.issue(put);
    put.next(1, p.stages);
  }

  float acc[TPW][4];
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // this warp's tiles t = warp * tpw + j, (order kl, m tile mt, n tile
  // nt) in order: the ldmatrix.trans offsets of its A = T^T (matrices:
  // rows +0/+8 of T, features +0/+8) and B = g (rows +0/+8), and whether
  // its A differs from the tile before
  const int arow = lane % 8 + lane / 16 * 8, acol = (lane / 8) % 2 * 8;
  const int brow = lane % 8 + (lane / 8) % 2 * 8;
  int aoff[TPW], boff[TPW];
  unsigned fresh = 0, live = 0;
#pragma unroll
  for (int j = 0, last = -1; j < TPW; ++j) {
    const int t = warp * p.tpw + j;
    aoff[j] = boff[j] = 0;
    if (j >= p.tpw || t >= tiles) continue;
    const int nt = t % ntn, am = t / ntn;  // am = kl * mtn + mt
    const int kl = am / mtn, mt = am - kl * mtn;
    aoff[j] = kl * p.astride + arow * p.a.pitch + mt * 16 + acol;
    boff[j] = bstart + brow * p.b.pitch + nt * 8;
    live |= 1u << j;
    if (am != last) fresh |= 1u << j;
    last = am;
  }
  for (long long i = 0; i < mine; ++i) {
    __syncthreads();
    if (issued < mine) {
      ring.issue(put);
      put.next(1, p.stages);
      ++issued;
    }
    const bf16* s = ring.wait(got);
    got.next(1, p.stages);
    for (int c = 0; c < DW_ROWS; c += 16) {
      uint32_t af[4];
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        if (!(live >> j & 1)) continue;
        if (fresh >> j & 1) ldsm_x4_t(af, s + aoff[j] + c * p.a.pitch);
        uint32_t bf[2];
        ldsm_x2_t(bf, s + boff[j] + c * p.b.pitch);
        mma(acc[j], af, bf[0], bf[1]);
      }
    }
  }
  __syncthreads();

  // the warps' tiles -> shared [kn][rk][gcols] fp32 -> the diagonal blocks
  float* epi = reinterpret_cast<float*>(smem + BAR_BYTES);
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int t = warp * p.tpw + j;
    if (j >= p.tpw || t >= tiles) continue;
    const int nt = t % ntn, am = t / ntn;
    const int kl = am / mtn, mt = am - kl * mtn;
    const int row = mt * 16 + lane / 4, col = nt * 8 + 2 * (lane % 4);
    float* e = epi + ((size_t)kl * p.rk + row) * p.gcols + col;
    e[0] = acc[j][0];
    e[1] = acc[j][1];
    e[8 * p.gcols] = acc[j][2];
    e[8 * p.gcols + 1] = acc[j][3];
  }
  __syncthreads();
  const int per_k = p.f * p.f_out;
  float* dst = partial + ((size_t)blockIdx.x * p.k + k0) * per_k;
  for (int o = threadIdx.x; o < kn * per_k; o += DW_THREADS) {
    const int kl = o / per_k, ff = (o / p.f_out) % p.f, n = o % p.f_out;
    float sum = 0.f;
    for (int blk = 0; blk < p.g; ++blk)
      sum += epi[((size_t)kl * p.rk + blk * p.f + ff) * p.gcols
                 + blk * p.npd + n];
    dst[o] = sum;
  }
}

// ---- dW, FP32 -----------------------------------------------------------

template <int NS>
__global__ void __launch_bounds__(DW_THREADS)
cheb_mix_dw_fp32_kernel(const __grid_constant__ Orders orders,
                        const float* __restrict__ g,
                        float* __restrict__ partial,
                        const __grid_constant__ DwPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool async = p.a.how == ASYNC || p.b.how == ASYNC;
  uint64_t* full = ring_init(smem, p.stages, 1 + (async ? DW_THREADS : 0));
  float* buf = reinterpret_cast<float*>(smem + BAR_BYTES);
  const int k0 = blockIdx.y * p.kg;
  const int kn = min(p.kg, p.k - k0);
  const int bstart = (kn * p.astride + 3) / 4 * 4;  // 16-byte aligned
  const int stage = bstart + DW_ROWS * p.b.pitch;
  const DwRing<float, DW_THREADS> ring{orders, g,  p,  full,  buf,
                                       k0,     kn, bstart, stage};
  const int col0 = blockIdx.z * NS;

  if (p.a.how != BULK || p.b.how != BULK)
    zero_smem<float, DW_THREADS>(buf, p.stages * stage);
  __syncthreads();

  const long long mine =
      (p.panels - blockIdx.x + gridDim.x - 1) / gridDim.x;
  Cursor put{0, 0, 0u, blockIdx.x}, got = put;
  long long issued = 0;
  for (; issued < mine && issued < p.stages - 1; ++issued) {
    ring.issue(put);
    put.next(1, p.stages);
  }

  // thread (row group rg, task u): T_{k0+kl}[:, ff] (u = kl * f + ff)
  // against g[:, col0 .. col0+NS) over the panel's rows rg, rg + p.rg, ..
  const int tasks = kn * p.f;
  const int per_group = DW_THREADS / p.rg;
  const int rg = threadIdx.x / per_group, lane_task = threadIdx.x % per_group;
  int aoff[DW_FP32_TASKS];
  bool live[DW_FP32_TASKS];
#pragma unroll
  for (int j = 0; j < DW_FP32_TASKS; ++j) {
    const int u = lane_task + j * per_group;
    live[j] = u < tasks;
    aoff[j] = live[j] ? (u / p.f) * p.astride + u % p.f : 0;
  }
  float acc[DW_FP32_TASKS][NS];
#pragma unroll
  for (int j = 0; j < DW_FP32_TASKS; ++j)
#pragma unroll
    for (int c = 0; c < NS; ++c) acc[j][c] = 0.f;

  for (long long i = 0; i < mine; ++i) {
    __syncthreads();
    if (issued < mine) {
      ring.issue(put);
      put.next(1, p.stages);
      ++issued;
    }
    const float* s = ring.wait(got);
    got.next(1, p.stages);
    const float* gs = s + bstart + col0;
    for (int q = rg; q < DW_ROWS; q += p.rg) {
      float4 b[NS / 4];
#pragma unroll
      for (int c4 = 0; c4 < NS / 4; ++c4)
        b[c4] = *reinterpret_cast<const float4*>(gs + q * p.b.pitch + 4 * c4);
#pragma unroll
      for (int j = 0; j < DW_FP32_TASKS; ++j) {
        if (!live[j]) continue;
        const float x = s[aoff[j] + q * p.a.pitch];
#pragma unroll
        for (int c4 = 0; c4 < NS / 4; ++c4) {
          acc[j][4 * c4] = fmaf(x, b[c4].x, acc[j][4 * c4]);
          acc[j][4 * c4 + 1] = fmaf(x, b[c4].y, acc[j][4 * c4 + 1]);
          acc[j][4 * c4 + 2] = fmaf(x, b[c4].z, acc[j][4 * c4 + 2]);
          acc[j][4 * c4 + 3] = fmaf(x, b[c4].w, acc[j][4 * c4 + 3]);
        }
      }
    }
  }
  __syncthreads();

  // the row groups' sums -> shared [rg][task][NS] -> added in order
  float* epi = reinterpret_cast<float*>(smem + BAR_BYTES);
  const int width = DW_FP32_TASKS * per_group;  // tasks a group holds
#pragma unroll
  for (int j = 0; j < DW_FP32_TASKS; ++j) {
    if (!live[j]) continue;
    const int u = lane_task + j * per_group;
#pragma unroll
    for (int c = 0; c < NS; ++c)
      epi[((size_t)rg * width + u) * NS + c] = acc[j][c];
  }
  __syncthreads();
  const int per_k = p.f * p.f_out;
  float* dst = partial + ((size_t)blockIdx.x * p.k + k0) * per_k;
  for (int o = threadIdx.x; o < tasks * NS; o += DW_THREADS) {
    const int u = o / NS, c = o % NS;
    if (col0 + c >= p.f_out) continue;
    float sum = epi[(size_t)u * NS + c];
    for (int r = 1; r < p.rg; ++r)
      sum += epi[((size_t)r * width + u) * NS + c];
    dst[(size_t)u * p.f_out + col0 + c] = sum;  // u = kl * f + ff
  }
}

// ---- dW: the partial sums in a fixed order ------------------------------

template <typename T>
__global__ void __launch_bounds__(32 * REDUCE_ROWS)
cheb_mix_dw_reduce_kernel(const float* __restrict__ partial,
                          T* __restrict__ dw, int parts, int n) {
  __shared__ float red[REDUCE_ROWS][33];
  const int lane = threadIdx.x % 32, row = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n)
#pragma unroll 4
    for (int q = row; q < parts; q += REDUCE_ROWS)
      s += partial[(size_t)q * n + i];
  red[row][lane] = s;
  __syncthreads();
  if (row == 0 && i < n) {
    float t = red[0][lane];
    for (int r = 1; r < REDUCE_ROWS; ++r) t += red[r][lane];
    dw[i] = narrow<T>(t);
  }
}

// ---- host side: plans and launches --------------------------------------

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// a row pitch (elements of `size` bytes) >= cols whose 16-byte chunks are
// odd in number, so eight rows read at one column hit distinct banks
int odd_pitch(int cols, int size) {
  const int per = 16 / size;
  int p = round_up(cols, per);
  if ((p / per) % 2 == 0) p += per;
  return p;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool orders_aligned(const void* const* orders, int k) {
  for (int i = 0; i < k; ++i)
    if (!aligned16(orders[i])) return false;
  return true;
}

// G rows per packed row of T in mode BF16 (see the header)
int packing(int f, long long m) {
  if (f % 16 == 0) return 1;
  if (16 % f == 0 && m % (16 / f) == 0) return 16 / f;
  return 1;
}

// the staging of a panel of packed rows [m, r] read as rows of rk (the
// pad columns zero): with the pointers aligned and r == rk, BULK, or
// ASYNC from rows of `async_from` bytes (where ldmatrix would meet 8-way
// bank conflicts at a dense pitch); otherwise ELEM. ASYNC and ELEM rows
// lie at an odd-chunk pitch.
Rows rows_of(long long m, int r, int rk, int size, bool aligned,
             int async_from, int threads) {
  const bool whole = aligned && r == rk && (r * size) % 16 == 0;
  if (whole && r * size < async_from) return Rows{m, r, r, r, r, BULK};
  const int how = whole && r * size / 16 <= threads ? ASYNC : ELEM;
  return Rows{m, r, r, r, odd_pitch(rk, size), how};
}

constexpr int NEVER = 1 << 30;  // rows_of: no row is staged by ASYNC

struct Device {
  int sms = 0, cap = 0;
};

cudaError_t device_limits(Device* out) {
  static Device cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cache[dev].sms > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  Device d;
  err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &d.cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) cache[dev] = d;
  *out = d;
  return cudaSuccess;
}

// a kernel's resident CTAs per SM at a shared-memory size, remembered per
// device (the last few sizes); the first call raises the kernel's cap
struct Occupancy {
  static constexpr int WAYS = 8;
  int smem[MAX_DEVICES][WAYS] = {};
  int per_sm[MAX_DEVICES][WAYS] = {};
  int next[MAX_DEVICES] = {};
  bool capped[MAX_DEVICES] = {};
};

template <typename K>
cudaError_t persistent_grid(K kern, int threads, int smem, long long panels,
                            Occupancy& occ, int* grid) {
  Device d;
  int dev = 0, per_sm = 0;
  cudaError_t err = device_limits(&d);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < MAX_DEVICES;
  for (int w = 0; cached && w < Occupancy::WAYS; ++w)
    if (occ.smem[dev][w] == smem && occ.per_sm[dev][w] > 0)
      per_sm = occ.per_sm[dev][w];
  if (per_sm == 0) {
    if (!cached || !occ.capped[dev]) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, d.cap);
      if (err != cudaSuccess) return err;
      if (cached) occ.capped[dev] = true;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (cached) {
      const int w = occ.next[dev]++ % Occupancy::WAYS;
      occ.smem[dev][w] = smem;
      occ.per_sm[dev][w] = per_sm;
    }
  }
  const long long most = (long long)per_sm * d.sms;
  *grid = static_cast<int>(panels < most ? panels : most);
  return cudaSuccess;
}

// the widest tile (n tiles NT or columns NS, a power of two <= top) that
// covers `cols` columns
int tile_width(int cols, int unit, int top) {
  int t = 1;
  while (t * unit < cols && t < top) t *= 2;
  return t;
}

// rows per panel, in units of unit_rows: the most of top, top / 2, .., 1
// that still give `want` panels, else one. Each CTA stages W once, so a
// small call runs fastest on about as many CTAs as there are SMs
// (measured at the 80k levels)
int panel_units(long long m, int unit_rows, int top, int want) {
  int u = top;
  while (u > 1
         && (m + (long long)unit_rows * u - 1) / ((long long)unit_rows * u)
                < want)
    u /= 2;
  return u;
}

// the mix's ring stages: 6 where CTAs walk many panels, else 3 (a small
// call is bound by its CTAs' latency, and fewer stages leave room for
// more CTAs)
int ring_stages(long long panels, int sms) {
  return panels >= 8LL * sms ? 6 : 3;
}

// ---- mix ----

template <int NT, int MT>
int mix_bf16_launch(const Orders& o, const void* w, void* out,
                    const MixPlan& p, int smem, int slabs, cudaStream_t st) {
  auto kern = cheb_mix_bf16_kernel<NT, MT>;
  static Occupancy occ;
  int grid = 0;
  cudaError_t err =
      persistent_grid(kern, MIX_THREADS, smem, p.panels, occ, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(grid, slabs), MIX_THREADS, smem, st>>>(
      o, static_cast<const bf16*>(w), static_cast<bf16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <int NS, int TM>
int mix_fp32_launch(const Orders& o, const void* w, void* out,
                    const MixPlan& p, int smem, int slabs, cudaStream_t st) {
  auto kern = cheb_mix_fp32_kernel<NS, TM>;
  static Occupancy occ;
  int grid = 0;
  cudaError_t err =
      persistent_grid(kern, MIX_THREADS, smem, p.panels, occ, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(grid, slabs), MIX_THREADS, smem, st>>>(
      o, static_cast<const float*>(w), static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

int mix_bf16(const Orders& o, const void* const* orders, int k, long long m,
             int f, int f_out, const void* w, void* out, const Device& d,
             cudaStream_t st) {
  MixPlan p{};
  p.g = packing(f, m);
  p.f = f;
  while (p.g > 1 && (1 << p.fshift) < f) ++p.fshift;
  p.k = k;
  p.f_out = f_out;
  p.npd = round_up(f_out, 8);
  const int r = p.g * f;
  p.rk = round_up(r, 16);
  p.a = rows_of(m / p.g, r, p.rk, 2, orders_aligned(orders, k), NEVER,
                MIX_THREADS);
  p.pair = f_out % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const int cols = p.g * p.npd;
  // candidates: the widest slab, then the most m tiles, then the most
  // stages; within the soft budget first
  for (const int budget : {SOFT_SMEM, d.cap}) {
    for (int nt = tile_width(cols, 8, 8); nt >= 1; nt /= 2) {
      const int top = nt == 8 ? 2 : 4;
      for (int mt = panel_units(p.a.m, 64, top, d.sms); mt >= 1;
           mt /= 2) {
        const long long panels = (p.a.m + 64 * mt - 1) / (64 * mt);
        for (int stages = ring_stages(panels, d.sms); stages >= 2;
             --stages) {
          const long long wbytes = (long long)k * (p.rk / 16) * nt * 32 * 8;
          const long long smem = BAR_BYTES + wbytes
                                 + (long long)stages * 64 * mt * p.a.pitch * 2;
          if (smem > budget) continue;
          p.mt = mt;
          p.stages = stages;
          p.panels = panels;
          const int slabs = (cols + nt * 8 - 1) / (nt * 8);
          const int s = static_cast<int>(smem);
          switch (nt) {
            case 8: return mix_bf16_launch<8, 2>(o, w, out, p, s, slabs, st);
            case 4: return mix_bf16_launch<4, 4>(o, w, out, p, s, slabs, st);
            case 2: return mix_bf16_launch<2, 4>(o, w, out, p, s, slabs, st);
            default:
              return mix_bf16_launch<1, 4>(o, w, out, p, s, slabs, st);
          }
        }
      }
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int mix_fp32(const Orders& o, const void* const* orders, int k, long long m,
             int f, int f_out, const void* w, void* out, const Device& d,
             cudaStream_t st) {
  MixPlan p{};
  p.g = 1;
  p.f = f;
  p.k = k;
  p.f_out = f_out;
  p.npd = f_out;
  p.rk = round_up(f, 4);
  p.a = rows_of(m, f, p.rk, 4, orders_aligned(orders, k), NEVER,
                MIX_THREADS);
  p.pair = f_out % 4 == 0 && aligned16(out);
  for (const int budget : {SOFT_SMEM, d.cap}) {
    for (int ns = 4 * tile_width(f_out, 4, 8); ns >= 4; ns /= 2) {
      const int top = ns == 32 ? 2 : ns == 16 ? 4 : 8;
      // 256-row panels below large calls: at template5k's levels 128-row
      // ones give too many CTAs (each stages W) and 512-row ones too few
      const int first =
          (m + MIX_THREADS * top - 1) / (MIX_THREADS * top) >= 8LL * d.sms
              ? top : (top < 2 ? top : 2);
      for (int tm = first; tm >= 1; tm /= 2) {
        const long long panels =
            (m + MIX_THREADS * tm - 1) / (MIX_THREADS * tm);
        for (int stages = ring_stages(panels, d.sms); stages >= 2;
             --stages) {
          const long long smem =
              BAR_BYTES + 4LL * k * p.rk * ns
              + 4LL * stages * MIX_THREADS * tm * p.a.pitch;
          if (smem > budget) continue;
          p.mt = tm;
          p.stages = stages;
          p.panels = panels;
          const int slabs = (f_out + ns - 1) / ns;
          const int s = static_cast<int>(smem);
          switch (ns) {
            case 32: return mix_fp32_launch<32, 2>(o, w, out, p, s, slabs, st);
            case 16: return mix_fp32_launch<16, 4>(o, w, out, p, s, slabs, st);
            case 8: return mix_fp32_launch<8, 8>(o, w, out, p, s, slabs, st);
            default:
              return mix_fp32_launch<4, 8>(o, w, out, p, s, slabs, st);
          }
        }
      }
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- dW ----

constexpr int DW_TPW = 12;       // most tiles a warp holds (BF16)
constexpr int DW_TPW_SMALL = 4;  // the instantiation for a few tiles

// a dW call's plan: the kernel's parameters, its shared memory, grid and
// instantiation (BF16: tiles per warp; FP32: columns NS)
struct DwLaunch {
  DwPlan p{};
  int smem = 0, grid = 0, kgroups = 0, slabs = 1, inst = 0;
};

template <typename K>
cudaError_t dw_grid(K kern, Occupancy& occ, DwLaunch* l) {
  return persistent_grid(kern, DW_THREADS, l->smem, l->p.panels, occ,
                         &l->grid);
}

cudaError_t dw_bf16_grid(DwLaunch* l) {
  static Occupancy small, large;
  return l->inst == DW_TPW_SMALL
             ? dw_grid(cheb_mix_dw_bf16_kernel<DW_TPW_SMALL>, small, l)
             : dw_grid(cheb_mix_dw_bf16_kernel<DW_TPW>, large, l);
}

cudaError_t dw_fp32_grid(DwLaunch* l) {
  static Occupancy occ[4];
  switch (l->inst) {
    case 32: return dw_grid(cheb_mix_dw_fp32_kernel<32>, occ[3], l);
    case 16: return dw_grid(cheb_mix_dw_fp32_kernel<16>, occ[2], l);
    case 8: return dw_grid(cheb_mix_dw_fp32_kernel<8>, occ[1], l);
    default: return dw_grid(cheb_mix_dw_fp32_kernel<4>, occ[0], l);
  }
}

// mode BF16; `aligned`: every T_k and g is 16-byte aligned
cudaError_t dw_bf16_plan(int k, long long m, int f, int f_out, bool aligned,
                         const Device& d, DwLaunch* l) {
  DwPlan p{};
  p.g = packing(f, m);
  p.f = f;
  p.k = k;
  p.f_out = f_out;
  p.npd = round_up(f_out, 8);
  p.gcols = p.g * p.npd;
  const int r = p.g * f;
  p.rk = round_up(r, 16);
  p.a = rows_of(m / p.g, r, p.rk, 2, aligned, NEVER, DW_THREADS);
  if (f_out == p.npd) {  // g's packed rows need no padding
    p.b = rows_of(m / p.g, p.gcols, p.gcols, 2, aligned, 128, DW_THREADS);
  } else {
    p.b = Rows{m / p.g, p.g * f_out, f_out, p.npd, odd_pitch(p.gcols, 2),
               ELEM};
  }
  p.astride = DW_ROWS * p.a.pitch;
  p.panels = (p.a.m + DW_ROWS - 1) / DW_ROWS;
  const int tpk = (p.rk / 16) * (p.gcols / 8);  // tiles per order
  for (const int budget : {SOFT_SMEM, d.cap}) {
    for (int kg = k; kg >= 1; --kg) {
      const int tpw = (kg * tpk + DW_THREADS / 32 - 1) / (DW_THREADS / 32);
      if (tpw > DW_TPW) continue;
      for (int stages = 3; stages >= 2; --stages) {
        const long long ring =
            2LL * stages * (kg * p.astride + DW_ROWS * p.b.pitch);
        const long long epi = 4LL * kg * p.rk * p.gcols;
        const long long smem = BAR_BYTES + (ring > epi ? ring : epi);
        if (smem > budget) continue;
        p.kg = kg;
        p.tpw = tpw;
        p.stages = stages;
        l->p = p;
        l->smem = static_cast<int>(smem);
        l->kgroups = (k + kg - 1) / kg;
        l->inst = tpw <= DW_TPW_SMALL ? DW_TPW_SMALL : DW_TPW;
        return dw_bf16_grid(l);
      }
    }
  }
  return cudaErrorInvalidValue;
}

cudaError_t dw_fp32_plan(int k, long long m, int f, int f_out, bool aligned,
                         const Device& d, DwLaunch* l) {
  DwPlan p{};
  p.g = 1;
  p.f = f;
  p.k = k;
  p.f_out = f_out;
  p.npd = f_out;
  p.rk = round_up(f, 4);
  // the lanes of a row read one order's row each: dense rows
  p.a = rows_of(m, f, p.rk, 4, aligned, NEVER, DW_THREADS);
  p.a.pitch = p.rk;
  // the orders' panels one after another, each shifted by f banks from
  // the last, so the lanes (order, feature) of a row hit distinct banks
  p.astride = DW_ROWS * p.rk + round_up(f % 32, 4);
  p.panels = (m + DW_ROWS - 1) / DW_ROWS;
  for (const int budget : {SOFT_SMEM, d.cap}) {
    for (int ns = 4 * tile_width(f_out, 4, 8); ns >= 4; ns /= 2) {
      const int slabs = (f_out + ns - 1) / ns;
      p.gcols = slabs * ns;
      p.b = rows_of(m, f_out, p.gcols, 4, aligned, NEVER, DW_THREADS);
      p.b.pitch = p.gcols;
      for (int kg = k; kg >= 1; --kg) {
        const int tasks = kg * f;
        if (tasks > DW_FP32_TASKS * DW_THREADS) continue;
        // row groups: the threads the tasks leave over, a power of two
        int rg = 1;
        while (rg < DW_ROWS && 2 * rg * tasks <= DW_THREADS) rg *= 2;
        p.rg = rg;
        // two stages: the CTAs' number, not their depth, hides the latency
        // at the fp32 shapes (template5k's levels)
        p.stages = 2;
        const long long ring =
            4LL * p.stages
            * (round_up(kg * p.astride, 4) + DW_ROWS * p.b.pitch);
        const long long epi = 4LL * DW_FP32_TASKS * DW_THREADS * ns;
        const long long smem = BAR_BYTES + (ring > epi ? ring : epi);
        if (smem > budget) continue;
        p.kg = kg;
        l->p = p;
        l->smem = static_cast<int>(smem);
        l->kgroups = (k + kg - 1) / kg;
        l->slabs = slabs;
        l->inst = ns;
        return dw_fp32_grid(l);
      }
    }
  }
  return cudaErrorInvalidValue;
}

cudaError_t dw_plan(int mode, int k, long long m, int f, int f_out,
                    bool aligned, DwLaunch* l) {
  Device d;
  cudaError_t err = device_limits(&d);
  if (err != cudaSuccess) return err;
  return mode == BF16 ? dw_bf16_plan(k, m, f, f_out, aligned, d, l)
                      : dw_fp32_plan(k, m, f, f_out, aligned, d, l);
}

template <typename T>
int dw_reduce(const float* ws, void* dw, int parts, int n, cudaStream_t st) {
  cheb_mix_dw_reduce_kernel<T><<<(n + 31) / 32, 32 * REDUCE_ROWS, 0, st>>>(
      ws, static_cast<T*>(dw), parts, n);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int k, long long m, int f, int f_out, int mode) {
  return k >= 1 && k <= MAX_ORDERS && m >= 1 && f >= 1 && f_out >= 1
         && (mode == FP32 || mode == BF16);
}

Orders orders_of(const void* const* orders, int k) {
  Orders o{};
  for (int i = 0; i < k; ++i) o.p[i] = orders[i];
  return o;
}

}  // namespace

// Plain C entry points (loaded with ctypes). `orders` is a host array of
// the k device pointers T_0..T_{k-1}, each [m, f] contiguous; w is
// [k, f, f_out], out [m, f_out], g [m, f_out], dw [k, f, f_out], all of
// the mode's dtype (0 = FP32: float32; 1 = BF16: bfloat16) and contiguous.
// Shapes, dtypes and contiguity are checked by the Python wrapper; any
// alignment is taken (an unaligned pointer takes the element copies).
// Each launches on `stream` and returns cudaGetLastError() of its
// launches, or cudaErrorInvalidValue for a shape no plan fits.

// out = sum_k T_k @ W_k
extern "C" int cheb_mix(const void* const* orders, int k, long long m, int f,
                        int f_out, const void* w, void* out, int mode,
                        void* stream) {
  if (!valid(k, m, f, f_out, mode))
    return static_cast<int>(cudaErrorInvalidValue);
  Device d;
  const cudaError_t err = device_limits(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Orders o = orders_of(orders, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mode == BF16 ? mix_bf16(o, orders, k, m, f, f_out, w, out, d, st)
                      : mix_fp32(o, orders, k, m, f, f_out, w, out, d, st);
}

// floats of workspace that cheb_mix_dw needs for this shape on the current
// device (the same plan as the call's: `aligned` says whether every T_k
// and g will be 16-byte aligned), or -1 when no plan fits
extern "C" long long cheb_mix_dw_workspace(int k, long long m, int f,
                                           int f_out, int aligned, int mode) {
  if (!valid(k, m, f, f_out, mode)) return -1;
  DwLaunch l;
  if (dw_plan(mode, k, m, f, f_out, aligned != 0, &l) != cudaSuccess)
    return -1;
  return (long long)l.grid * k * f * f_out;
}

// dw[k] = T_k^T @ g: the partial sums of each CTA into ws (ws_floats of
// them, cheb_mix_dw_workspace's count), then their fixed-order sum
extern "C" int cheb_mix_dw(const void* const* orders, int k, long long m,
                           int f, int f_out, const void* g, void* dw,
                           void* ws, long long ws_floats, int mode,
                           void* stream) {
  if (!valid(k, m, f, f_out, mode))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = orders_aligned(orders, k) && aligned16(g);
  DwLaunch l;
  cudaError_t err = dw_plan(mode, k, m, f, f_out, aligned, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = k * f * f_out;
  if ((long long)l.grid * n > ws_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  const Orders o = orders_of(orders, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  const dim3 grid(l.grid, l.kgroups, l.slabs);
  const int sm = l.smem;
  if (mode == BF16) {
    const bf16* gp = static_cast<const bf16*>(g);
    if (l.inst == DW_TPW_SMALL)
      cheb_mix_dw_bf16_kernel<DW_TPW_SMALL><<<grid, DW_THREADS, sm, st>>>(
          o, gp, part, l.p);
    else
      cheb_mix_dw_bf16_kernel<DW_TPW><<<grid, DW_THREADS, sm, st>>>(
          o, gp, part, l.p);
  } else {
    const float* gp = static_cast<const float*>(g);
    switch (l.inst) {
      case 32:
        cheb_mix_dw_fp32_kernel<32><<<grid, DW_THREADS, sm, st>>>(o, gp, part,
                                                                  l.p);
        break;
      case 16:
        cheb_mix_dw_fp32_kernel<16><<<grid, DW_THREADS, sm, st>>>(o, gp, part,
                                                                  l.p);
        break;
      case 8:
        cheb_mix_dw_fp32_kernel<8><<<grid, DW_THREADS, sm, st>>>(o, gp, part,
                                                                 l.p);
        break;
      default:
        cheb_mix_dw_fp32_kernel<4><<<grid, DW_THREADS, sm, st>>>(o, gp, part,
                                                                 l.p);
    }
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mode == BF16 ? dw_reduce<bf16>(part, dw, l.grid, n, st)
                      : dw_reduce<float>(part, dw, l.grid, n, st);
}
