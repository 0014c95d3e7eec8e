// One fused Chebyshev step for Hopper (sm_90a): block-sparse propagation
// and the channel mix of its result in the same launch,
//
//     T_k = alpha * (L @ T_{k-1}) - [T_{k-2}]            [n_pad, C]
//     acc[r, i*f_out + o] += sum_e T_k[r, i*f_pad + e] * W_k[e, o]
//
// with C = B * f_pad (batch item i owns columns i*f_pad..) and acc
// [n_pad, B * f_out] updated in place. fp32 storage; FP32 runs IEEE fp32
// products, BF16X3 rounds both operands of both products to a bf16 hi and
// a bf16 residual lo and adds hi*hi + hi*lo + lo*hi in fp32.
//
// Replaces meshvae_tpu/ops/pallas_fused.py `_make_fused_kernel` (:51-81),
// launched per step by `_fused_step` (:84-144): there the grid walks the
// operator block by block (first/last flags), the TPU keeps the T_k
// row-block resident in VMEM until its last block, then multiplies it by
// kron(I_bchunk, W_k) on the MXU and adds into the aliased accumulator.
// Here the grouped view (g_idx / g_bcol) gives each CTA a whole output
// tile, so the mix follows in the same CTA. Each acc element belongs to
// exactly one CTA (the one holding its item's rows and columns), so there
// are no atomics and no ordering between CTAs.
//
// What bounds it: bytes. Per step it must read the occupied 16 x 16 tiles
// of L, T_{k-1} and T_{k-2}, write T_k, and read and write acc once; at
// the scaled20k level 0 (C = 1,024, f_out = 16) that is ~12 MB of tiles
// and ~410 MB of activations, ~0.13 ms at 3.35 TB/s. The operations (the
// propagation on the occupied tiles, 2 f_out per T_k element for the mix)
// are far below the tensor cores' rate and, in FP32, below the CUDA
// cores'.
//
// Design: one CTA of four warps per (64-row half of an output row block,
// tile of TW = max(64, f_pad) columns, i.e. TW / f_pad whole batch items).
//   1. The propagation is the occupied-tile engine (tile_engine.cuh
//      `product`), TW / 64 passes of its 64-column tile: FP32 CUDA-core
//      FMAs in the dense product's k order, BF16X3 per-strip mma.sync with
//      the hi/lo split in registers. The epilogue rounds alpha * sum, then
//      its difference with T_{k-2}, as bsr_grouped_spmm does (so in both
//      modes T_k has the bits of bsr_grouped_spmm(..., t_prev=T_{k-2})),
//      writes T_k once and parks it in shared memory (ts [64][TW], fp32).
//      A wider tile than 64 columns (f_pad > 64) is the same engine run
//      once per 64 columns.
//   2. The mix reads T_k from ts. FP32: each thread sums one row's item
//      for 4 consecutive o (1 where f_out % 4 != 0) over e in order, fp32
//      FMAs from 0, and adds the sums into acc, consecutive threads on
//      consecutive acc columns. BF16X3: W_k is split into bf16 hi/lo once
//      per CTA (transposed, zero-padded to a 16-deep k and 8-wide n), each
//      warp runs m16n8k16 MMAs (hi*hi, hi*lo, lo*hi) of its strip per
//      (item, 8 outputs) — one k-step per item at f_pad = 16, two n8 tiles
//      at f_out = 16 — into a shared mix tile, and the CTA adds that tile
//      into acc, coalesced. acc is read once and written once.

#include "tile_engine.cuh"

namespace {

using namespace tile;

// shared memory of one launch: the engine's ring, the T_k tile ts
// [64][ts_ld] (fp32), W_k (FP32: fp32 [f_pad][f_out]; BF16X3: bf16 hi then
// lo, each [n8][kp_ld], transposed and zero-padded) and, in BF16X3, the mix
// tile ms [64][aw] (fp32)
struct Layout {
  int tw, ts_ld, items, aw, kp, kp_ld, n8, ts, ws, ms, bytes;
};

__host__ __device__ inline Layout layout(int mode, int f_pad, int f_out) {
  Layout l;
  l.tw = f_pad > BN ? f_pad : BN;
  l.ts_ld = l.tw + 8;
  l.items = l.tw / f_pad;
  l.aw = l.items * f_out;
  l.kp = f_pad > KT ? f_pad : KT;
  l.kp_ld = l.kp + 8;
  l.n8 = (f_out + 7) / 8 * 8;
  l.ts = Ring<FP32>::BYTES;  // the BF16X3 ring has the same fp32 stages
  l.ws = l.ts + BM * l.ts_ld * 4;
  const int w_bytes = mode == FP32 ? f_pad * f_out * 4 : 2 * l.n8 * l.kp_ld * 2;
  l.ms = l.ws + (w_bytes + 15) / 16 * 16;
  l.bytes = l.ms + (mode == FP32 ? 0 : BM * l.aw * 4);
  return l;
}

// W_k into shared memory (every thread of the CTA; read after a barrier)
template <int MODE>
__device__ __forceinline__ void stage_w(const float* __restrict__ w,
                                        unsigned char* dst, const Layout& l,
                                        int f_pad, int f_out) {
  if constexpr (MODE == FP32) {
    float* ws = reinterpret_cast<float*>(dst);
    for (int p = threadIdx.x; p < f_pad * f_out; p += THREADS) ws[p] = w[p];
  } else {
    __nv_bfloat16* wh = reinterpret_cast<__nv_bfloat16*>(dst);
    __nv_bfloat16* wl = wh + l.n8 * l.kp_ld;
    for (int p = threadIdx.x; p < l.n8 * l.kp; p += THREADS) {
      const int n = p / l.kp, k = p % l.kp;
      const float v = n < f_out && k < f_pad ? w[k * f_out + n] : 0.f;
      const __nv_bfloat16 hi = __float2bfloat16_rn(v);
      wh[n * l.kp_ld + k] = hi;
      wl[n * l.kp_ld + k] = __float2bfloat16_rn(v - __bfloat162float(hi));
    }
  }
}

// FP32 mix: OB consecutive outputs o of one (row, item) per thread step
template <int OB>
__device__ __forceinline__ void mix_fp32(const float* ts, const float* ws,
                                         const Layout& l, int f_pad,
                                         int f_out, float* dst0,
                                         size_t c_out) {
  const int groups = l.aw / OB;  // per row
  for (int idx = threadIdx.x; idx < BM * groups; idx += THREADS) {
    const int r = idx / groups, cc = (idx % groups) * OB;
    const int it = cc / f_out, o = cc % f_out;
    const float* trow = ts + r * l.ts_ld + it * f_pad;
    float s[OB];
#pragma unroll
    for (int j = 0; j < OB; ++j) s[j] = 0.f;
    for (int e = 0; e < f_pad; ++e) {
      const float t = trow[e];
      if constexpr (OB == 4) {
        const float4 wv = load4(ws + e * f_out + o);
        s[0] = fmaf(t, wv.x, s[0]);
        s[1] = fmaf(t, wv.y, s[1]);
        s[2] = fmaf(t, wv.z, s[2]);
        s[3] = fmaf(t, wv.w, s[3]);
      } else {
        s[0] = fmaf(t, ws[e * f_out + o], s[0]);
      }
    }
    float* dst = dst0 + r * c_out + cc;
    if constexpr (OB == 4) {
      float4 v = load4(dst);
      v.x += s[0]; v.y += s[1]; v.z += s[2]; v.w += s[3];
      store4(dst, v);
    } else {
      *dst += s[0];
    }
  }
}

// BF16X3 mix of this warp's strip into ms, on the tensor cores
__device__ __forceinline__ void mix_mma(const float* ts,
                                        const unsigned char* wsrc, float* ms,
                                        const Layout& l, int f_pad, int f_out,
                                        int warp, int lane) {
  const __nv_bfloat16* wh = reinterpret_cast<const __nv_bfloat16*>(wsrc);
  const __nv_bfloat16* wl = wh + l.n8 * l.kp_ld;
  const int gid = lane >> 2, tig = lane & 3;
  const float* strip = ts + warp * KT * l.ts_ld;
  for (int it = 0; it < l.items; ++it) {
    for (int n0 = 0; n0 < l.n8; n0 += 8) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < l.kp; k0 += KT) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // rows +8 (odd r), k +8 (r >= 2)
          const int k = k0 + tig * 2 + 8 * (r >> 1);
          const float* t = strip + (gid + 8 * (r & 1)) * l.ts_ld
                           + it * f_pad + k;
          split2(k < f_pad ? t[0] : 0.f, k + 1 < f_pad ? t[1] : 0.f, ah[r],
                 al[r]);
        }
        const int b = (n0 + gid) * l.kp_ld + k0 + tig * 2;
        uint32_t bh0, bh1, bl0, bl1;
        memcpy(&bh0, wh + b, 4);
        memcpy(&bh1, wh + b + 8, 4);
        memcpy(&bl0, wl + b, 4);
        memcpy(&bl1, wl + b + 8, 4);
        mma_bf16(d, ah, bh0, bh1);
        mma_bf16(d, ah, bl0, bl1);
        mma_bf16(d, al, bh0, bh1);
      }
      // d[2h + j] at strip row gid + 8h, output n0 + tig * 2 + j
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int o = n0 + tig * 2 + j;
          if (o < f_out)
            ms[(warp * KT + gid + 8 * h) * l.aw + it * f_out + o] =
                d[2 * h + j];
        }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
cheb_fused_step_kernel(const float* __restrict__ blocks,
                       const int* __restrict__ g_idx,
                       const int* __restrict__ g_bcol,
                       const uint32_t* __restrict__ tile_mask,
                       const float* __restrict__ t1,
                       const float* __restrict__ t2,
                       const float* __restrict__ w,
                       float* __restrict__ t_out,
                       float* __restrict__ acc_mix,
                       int nb, int g, int n_col_blocks, int c, int f_pad,
                       int f_out, float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(MODE, f_pad, f_out);
  float* ring = reinterpret_cast<float*>(smem);
  float* ts = reinterpret_cast<float*>(smem + l.ts);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile0 = blockIdx.x * l.tw;
  const int row_block = blockIdx.y / (BLOCK / BM);
  const int half = blockIdx.y % (BLOCK / BM);
  const int m0 = half * BM;
  const size_t row0 = (size_t)row_block * BLOCK + m0;
  const Args a{g_idx, g_bcol, tile_mask, nb, g, n_col_blocks, c, row_block,
               half};

  stage_w<MODE>(w, smem + l.ws, l, f_pad, f_out);
  for (int sub = 0; sub < l.tw; sub += BN) {
    if (sub) __syncthreads();  // every warp is done with the ring
    Acc acc;
    zero(acc);
    product<MODE>(ring, a, blocks, t1, m0, tile0 + sub, warp, lane, acc);
    // T_k = alpha * acc - T_{k-2}, the product and the difference each
    // rounded (bsr_grouped_spmm's order): one write, and parked in ts
    for_outputs<MODE>(acc, warp * KT, lane, [&](auto n, const float* v,
                                                int r, int n0) {
      constexpr int N = decltype(n)::value;
      const size_t off = (row0 + r) * c + tile0 + sub + n0;
      float out[N];
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = __fmul_rn(alpha, v[j]);
      if (t2 != nullptr) {
        float p[N];
        if constexpr (N == 4) {
          const float4 q = load4(t2 + off);
          p[0] = q.x; p[1] = q.y; p[2] = q.z; p[3] = q.w;
        } else {
          const float2 q = load2(t2 + off);
          p[0] = q.x; p[1] = q.y;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) out[j] = __fsub_rn(out[j], p[j]);
      }
      store_n<N>(t_out + off, out);
      store_n<N>(ts + r * l.ts_ld + sub + n0, out);
    });
  }
  __syncthreads();  // ts and W_k are complete

  const size_t c_out = (size_t)(c / f_pad) * f_out;
  float* dst0 = acc_mix + row0 * c_out + (size_t)(tile0 / f_pad) * f_out;
  if constexpr (MODE == FP32) {
    const float* ws = reinterpret_cast<const float*>(smem + l.ws);
    if (f_out % 4 == 0)
      mix_fp32<4>(ts, ws, l, f_pad, f_out, dst0, c_out);
    else
      mix_fp32<1>(ts, ws, l, f_pad, f_out, dst0, c_out);
  } else {
    float* ms = reinterpret_cast<float*>(smem + l.ms);
    mix_mma(ts, smem + l.ws, ms, l, f_pad, f_out, warp, lane);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * l.aw; idx += THREADS) {
      float* dst = dst0 + (idx / l.aw) * c_out + idx % l.aw;
      *dst += ms[idx];
    }
  }
}

template <int MODE>
int launch(const void* blocks, const int* g_idx, const int* g_bcol,
           const void* tile_mask, const float* t1, const float* t2,
           const float* w, float* t_out, float* acc, int nb, int n_rows,
           int g, int n_col_blocks, int c, int f_pad, int f_out, float alpha,
           cudaStream_t st) {
  const Layout l = layout(MODE, f_pad, f_out);
  auto kern = cheb_fused_step_kernel<MODE>;
  static int cap[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(kern, l.bytes, cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(c / l.tw, n_rows * (BLOCK / BM));
  kern<<<grid, THREADS, l.bytes, st>>>(
      static_cast<const float*>(blocks), g_idx, g_bcol,
      static_cast<const uint32_t*>(tile_mask), t1, t2, w, t_out, acc, nb, g,
      n_col_blocks, c, f_pad, f_out, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). `mode` is 0 = FP32,
// 1 = BF16X3. Shapes and alignment are checked by the Python wrapper:
// f_pad a power of two, c = B * f_pad a multiple of max(64, f_pad), t1,
// t2 (null at the first step) and t_out [n_rows * 128, c] (t1 may have
// n_col_blocks * 128 rows), tile_mask [nb, 8] uint8, w [f_pad, f_out],
// acc [n_rows * 128, B * f_out], every pointer 16-byte aligned. Launches
// on `stream` and returns the CUDA error of the launch.
extern "C" int cheb_fused_step(const void* blocks, const int* g_idx,
                               const int* g_bcol, const void* tile_mask,
                               const float* t1, const float* t2,
                               const float* w, float* t_out, float* acc,
                               int nb, int n_rows, int g, int n_col_blocks,
                               int c, int f_pad, int f_out, float alpha,
                               int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tw = f_pad > BN ? f_pad : BN;
  if (f_pad <= 0 || (f_pad & (f_pad - 1)) || f_out <= 0 || c % tw
      || tile_mask == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
#define FUSED_ARGS                                                          \
  blocks, g_idx, g_bcol, tile_mask, t1, t2, w, t_out, acc, nb, n_rows, g,   \
      n_col_blocks, c, f_pad, f_out, alpha, st
  switch (mode) {
    case FP32:
      return launch<FP32>(FUSED_ARGS);
    case BF16X3:
      return launch<BF16X3>(FUSED_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FUSED_ARGS
}
