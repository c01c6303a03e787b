// One-pass AdamW over every parameter leaf in one launch, for Hopper (sm_90a),
// CUDA C++ with a plain C entry.
//
// Replaces the TPU kernel ops/adamw_pallas.py::_kernel of the JAX package
// (Pallas, launched per leaf by adamw_update_leaf's pl.pallas_call).  Same
// function, element by element:
//   g'  = finite ? g * scale : 0        (select, so a NaN g cannot leak)
//   mu' = b1 * mu + (1 - b1) * g'
//   nu' = b2 * nu + (1 - b2) * g'^2
//   p'  = p - lr * ((mu' / bc1) / (sqrt(nu' / bc2) + eps) + wd * p)
// with [scale, lr, bc1, bc2, finite] read from a device array, so a step
// needs no host sync.  g, nu and p are f32; mu is f32 or bf16 (computed in
// f32, stored rounded).  Each operation is done in the plain version's order
// with IEEE rounding and no FMA contraction (__fmul_rn and friends), so the
// kernel agrees with the plain PyTorch version bit for bit.
//
// Bound on the H100 (SXM, 3.35 TB/s): reading g, mu, nu, p and writing mu,
// nu, p is 28 bytes per parameter with f32 mu (24 with bf16): 2.40 GB for
// ViT-base's 85.7 M parameters, 0.72 ms; about 15 operations per parameter
// (1.3 GFLOP, 0.02 ms on the f32 CUDA cores).  So it is bound by memory, and
// the design streams each element once: one thread per element per pass,
// neighbouring threads on neighbouring addresses.
//
// Multi-tensor layout: the optimizer keeps a device table with one row per
// leaf -- (p, g, mu, nu pointers, element count, first chunk) as int64 --
// built once and rebuilt only when a pointer changes.  The grid has one block
// per 2048-element chunk of every leaf; a block finds its leaf by binary
// search over the first-chunk column.  The parameters stay separate tensors
// (no flat buffer to keep the model's tensors viewing), and leaves of any
// size, such as the 71-wide head bias, take the same path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;  // elements per block
constexpr int kCols = 6;                       // table columns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Consts {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

template <typename MuT>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const long long* __restrict__ table, int n_leaves,
             const float* __restrict__ scalars, Consts c) {
  // the leaf whose chunks hold this block: the last row with first chunk <= block
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid * kCols + 5] <= static_cast<long long>(blockIdx.x)) lo = mid;
    else hi = mid - 1;
  }
  const long long* row = table + lo * kCols;
  float* p = reinterpret_cast<float*>(row[0]);
  const float* g = reinterpret_cast<const float*>(row[1]);
  MuT* mu = reinterpret_cast<MuT*>(row[2]);
  float* nu = reinterpret_cast<float*>(row[3]);
  const long long n = row[4];
  const long long start = (static_cast<long long>(blockIdx.x) - row[5]) * kChunk;

  const float scale = scalars[0], lr = scalars[1], bc1 = scalars[2], bc2 = scalars[3];
  const bool finite = scalars[4] > 0.f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long e = start + i * kThreads + threadIdx.x;
    if (e < n) {
      const float gi = finite ? __fmul_rn(g[e], scale) : 0.f;
      const float m = __fadd_rn(__fmul_rn(c.b1, to_f32(mu[e])), __fmul_rn(c.one_minus_b1, gi));
      const float v = __fadd_rn(__fmul_rn(c.b2, nu[e]), __fmul_rn(c.one_minus_b2, __fmul_rn(gi, gi)));
      float upd = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps));
      const float pe = p[e];
      if (c.wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(c.wd, pe));
      mu[e] = from_f32<MuT>(m);
      nu[e] = v;
      p[e] = __fsub_rn(pe, __fmul_rn(lr, upd));
    }
  }
}

}  // namespace

// Elements per block: a leaf of n elements takes ceil(n / this) chunks.
extern "C" int adamw_chunk_elems() { return kChunk; }

// table: (n_leaves, 6) int64 on the device, rows (p, g, mu, nu, n, first
// chunk) with first chunks ascending from 0; n_chunks: the total.  scalars:
// 5 f32 on the device [scale, lr, bc1, bc2, finite].  mu_bf16 says whether
// every mu is bf16 (1) or f32 (0).  one_minus_b1/b2 are 1 - b1 and 1 - b2 as
// the caller rounds them.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int adamw_step(const void* table, int n_leaves, int n_chunks,
                          const void* scalars, int mu_bf16, float b1, float one_minus_b1,
                          float b2, float one_minus_b2, float eps, float wd, void* stream) {
  if (n_leaves < 1 || n_chunks < n_leaves) return static_cast<int>(cudaErrorInvalidValue);
  const Consts c{b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  const auto* tab = static_cast<const long long*>(table);
  const auto* sc = static_cast<const float*>(scalars);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mu_bf16) {
    adamw_kernel<__nv_bfloat16><<<n_chunks, kThreads, 0, s>>>(tab, n_leaves, sc, c);
  } else {
    adamw_kernel<float><<<n_chunks, kThreads, 0, s>>>(tab, n_leaves, sc, c);
  }
  return static_cast<int>(cudaGetLastError());
}
