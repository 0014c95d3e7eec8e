// The pool backward's transpose product for Hopper (sm_90a):
//
//     y[b, i, :] = sum over k in row i of t_val[k] * g[b, t_col[k], :]
//
// P^T is a barycentric up-pool P [N_out, N_in] transposed, stored in CSR:
// t_ptr [N_in + 1] (int32), t_col (int32, ascending within each row) and
// t_val, in the operator dtype. g is the pool output's cotangent
// [B, N_out, F] and y the pool input's gradient [B, N_in, F], both in
// their model layout (no transpose, no feature padding), one row-major
// array each. Two modes:
//
//   FP32  fp32 values, g and y; one fmaf chain per output from +0 over the
//         row's nonzeros in ascending column order. That is the order in
//         which bsr_grouped_spmm's FP32 mode (bsr_spmm.cu) sums the same
//         row of the block-sparse P^T: its slots are sorted by column
//         block, it walks k in the dense product's order, and what it
//         adds beyond the nonzeros are exact zeros to a sum that is never
//         -0. So for finite g the two give the same bits.
//   BF16  bf16 values, g and y: widened to fp32 (exact), the same fmaf
//         chain, one round-to-nearest-even to bf16 per output.
//
// Replaces the TPU kernels that meshvae_tpu/ops/pool.py
// `_bsr_transpose_apply` reaches through `_bsr_matmul_impl`
// (meshvae_tpu/ops/pallas_cheb.py): the column-major
// `_make_colmajor_kernel` (#7, :208, launched by `_colmajor_matmul` :249
// on rows of more than 8 column blocks), the per-block `_make_spmm_kernel`
// (#5, :180) and the row-grouped `_make_grouped_kernel` (#4, :395) where
// it runs a P^T. Those multiply 128 x 128 blocks of P^T, which are almost
// all zero: a fine vertex has at most 3 coarse parents, so P^T holds about
// 3 N_out nonzeros (15k at template5k's finest up-pool, with hub rows of
// up to 51).
//
// What bounds it: the bytes a call must move, g and y once each and the
// CSR (at template5k's finest up-pool, B * F = 256 in fp32: 5.1 MB of g,
// 1.3 MB of y, 0.1 MB of CSR, about 2 us at 3.35 TB/s); its FMAs are
// 2 * nnz * B * F operations, far below the CUDA cores' rate. At the
// main path's sizes a call is short, so what the design fights is
// latency: the block-sparse kernel it replaces ran about 80 CTAs, each
// walking up to 12 slots x 8 k-chunks in series through its cp.async
// ring.
//
// Design: one warp per (output row i, 32 vector columns), the vector
// columns running over the B * F columns of y's row i in all B items (V
// consecutive features of one item each: 16 bytes of elements where F and
// the alignment allow, else one).
// Each lane owns one vector column and its V outputs.
// The warp reads the row's t_col / t_val 32 at a time, one pair per lane,
// and hands them round with __shfl_sync; per pair each lane loads V
// features of g's row t_col[k] in its item (16-byte loads: the lanes of
// one item read adjacent addresses). UNROLL loads are issued before the
// FMAs that consume them, so a hub row of 51 nonzeros waits on 7 round
// trips to memory, not 51, and the next 32 (t_col, t_val) are loaded
// before a chunk's g loads wait. Every output is written once by one lane:
// no atomics, no cross-CTA reduction, no allocation, so a call can be
// captured in a CUDA graph. Four warps per CTA; at template5k's finest
// up-pool that is 2,500 warps in 625 CTAs. The gather reads each g row
// once per parent (about 2.5 times) through L2, which the bound above
// does not count (chip_smoke.py phase 3b prints the kernel's time beside
// the bound at every main-path shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>  // memcpy

namespace {

enum Mode { FP32 = 0, BF16 = 1 };

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
// g loads in flight per lane (divides 32); more hide more latency on a
// hub row but cost registers, and so resident warps, on every row
constexpr int UNROLL = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V consecutive elements (16 bytes of them, or one) as raw 32-bit words
template <typename T, int V>
struct Raw {
  static constexpr int WORDS = (V * sizeof(T) + 3) / 4;
  uint32_t w[WORDS];
};

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  static_assert(V * sizeof(T) == 16 || V == 1, "16 bytes or one element");
  Raw<T, V> r;
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = u.x; r.w[1] = u.y; r.w[2] = u.z; r.w[3] = u.w;
  } else if constexpr (sizeof(T) == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    r.w[0] = __bfloat16_as_ushort(p[0]);
  }
  return r;
}

// element j of a raw load, widened to fp32 (exact for bf16: its bits are
// the high half of the fp32 word; element 0 is the low half in memory)
template <typename T, int V>
__device__ __forceinline__ float elem(const Raw<T, V>& r, int j) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(r.w[j]);
  } else {
    return __uint_as_float(j % 2 ? r.w[j / 2] & 0xffff0000u
                                 : r.w[j / 2] << 16);
  }
}

// two outputs rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// V outputs, one rounding each (bf16), as one store of V elements
template <typename T, int V>
__device__ __forceinline__ void store_out(T* p, const float (&acc)[V]) {
  if constexpr (V == 1 && sizeof(T) == 4) {
    p[0] = acc[0];
  } else if constexpr (V == 1) {
    p[0] = __float2bfloat16_rn(acc[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]),
                   pack2(acc[4], acc[5]), pack2(acc[6], acc[7]));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
pool_transpose_kernel(const int* __restrict__ t_ptr,
                      const int* __restrict__ t_col,
                      const T* __restrict__ t_val, const T* __restrict__ g,
                      T* __restrict__ y, int n_in, int n_out, int f,
                      int b, int chunks) {
  const int lane = threadIdx.x % 32;
  const long long item = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (item >= (long long)n_in * chunks) return;  // warp-uniform
  const int row = static_cast<int>(item / chunks);
  const int vcol = static_cast<int>(item % chunks) * 32 + lane;
  const bool active = vcol < b * f / V;
  // this lane's V columns: item bi, features fi .. fi + V - 1
  const int bi = active ? vcol * V / f : 0;
  const int fi = active ? vcol * V % f : 0;
  const T* gb = g + (size_t)bi * n_out * f + fi;

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;

  const int lo = __ldg(t_ptr + row), hi = __ldg(t_ptr + row + 1);
  // the row's (t_col, t_val) 32 at a time, one pair per lane; the next 32
  // are loaded before this chunk's g loads wait
  int my_col = 0;
  float my_val = 0.f;
  if (lo + lane < hi) {
    my_col = __ldg(t_col + lo + lane);
    my_val = widen(t_val[lo + lane]);
  }
  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);  // warp-uniform
    int next_col = 0;
    float next_val = 0.f;
    if (base + 32 + lane < hi) {
      next_col = __ldg(t_col + base + 32 + lane);
      next_val = widen(t_val[base + 32 + lane]);
    }
    for (int k0 = 0; k0 < n; k0 += UNROLL) {
      // UNROLL loads in flight before the FMAs that consume them
      Raw<T, V> raw[UNROLL];
      float w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = __shfl_sync(FULL, my_col, k0 + u);
        w[u] = __shfl_sync(FULL, my_val, k0 + u);
        if (active && k0 + u < n)
          raw[u] = load_raw<T, V>(gb + (size_t)c * f);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (active && k0 + u < n) {
#pragma unroll
          for (int j = 0; j < V; ++j)
            acc[j] = fmaf(w[u], elem<T, V>(raw[u], j), acc[j]);
        }
    }
    my_col = next_col;
    my_val = next_val;
  }
  if (active)
    store_out<T, V>(y + (size_t)bi * n_in * f + (size_t)row * f + fi, acc);
}

template <typename T, int V>
int launch(const int* t_ptr, const int* t_col, const void* t_val,
           const void* g, void* y, int n_in, int n_out, int f, int b,
           cudaStream_t st) {
  const int chunks = (b * f / V + 31) / 32;
  const long long warps = (long long)n_in * chunks;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  pool_transpose_kernel<T, V><<<static_cast<unsigned>(blocks), THREADS, 0,
                                st>>>(
      t_ptr, t_col, static_cast<const T*>(t_val), static_cast<const T*>(g),
      static_cast<T*>(y), n_in, n_out, f, b, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vec(const int* t_ptr, const int* t_col, const void* t_val,
               const void* g, void* y, int n_in, int n_out, int f, int b,
               int vec, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec == V)
    return launch<T, V>(t_ptr, t_col, t_val, g, y, n_in, n_out, f, b, st);
  if (vec == 1)
    return launch<T, 1>(t_ptr, t_col, t_val, g, y, n_in, n_out, f, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (loaded with ctypes). `mode` is 0 = FP32, 1 = BF16;
// `vec` is the elements each lane loads at once: 16 bytes of them (4 in
// FP32, 8 in BF16), which must divide f, with g and y 16-byte aligned; or
// 1.
// Shapes, dtypes and contiguity are checked by the Python wrapper: t_ptr
// [n_in + 1], t_col and t_val [t_ptr[n_in]], g [b, n_out, f], y [b, n_in,
// f]. Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int pool_transpose(const int* t_ptr, const int* t_col,
                              const void* t_val, const void* g, void* y,
                              int n_in, int n_out, int f, int b, int mode,
                              int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_in < 0 || n_out < 0 || f <= 0 || b <= 0 || vec <= 0 || f % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == FP32)
    return launch_vec<float>(t_ptr, t_col, t_val, g, y, n_in, n_out, f, b,
                             vec, st);
  if (mode == BF16)
    return launch_vec<__nv_bfloat16>(t_ptr, t_col, t_val, g, y, n_in, n_out,
                                     f, b, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
