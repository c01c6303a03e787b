// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the TPU kernels ops/attention.py::_flash_kernel and
// ::_flash_kernel_lse of the JAX package (Pallas, launched through
// _flash_forward's pl.pallas_call; the second also emits the row
// log-sum-exp for the blocked backward).  Same function:
// for each (bh = b*H + h, query row) the online-softmax attention
// softmax(scale * q.k^T) . v over keys 0..T-1, with
//   * an f32 running max m, sum l and accumulator, output in the input dtype;
//   * keys at positions >= T masked to NEG_INF = -1e30;
//   * for bf16 inputs, p rounded to bf16 before the PV product (as the TPU
//     kernel's p.astype(v.dtype));
//   * optional attention-probability dropout: l sums the raw p, the keep mask
//     is the counter hash dropout_keep(seed, bh, qpos, kpos, rate) computed
//     here in uint32 arithmetic, kept entries are scaled by 1/(1-rate).
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32 without tensor cores):
// at the serving shape B=64, H=12, T=41, D=64, q, k, v and o hold 8.06 M
// elements: 32.2 MB in f32 (9.6 us of memory traffic), 16.1 MB in bf16
// (4.8 us), while the two products are 4*B*H*T^2*D = 0.33 GFLOP (4.9 us on
// the f32 CUDA cores, 0.33 us at the bf16 tensor-core rate); the lse adds
// B*H*T f32 (0.13 MB, 0.04 us).  So at that
// shape the kernel is bound by memory and by launch latency; at T >= 1k it
// is bound by operations, which this design runs on the CUDA cores.
//
// Design (simple first): one block of 4 warps per (bh, 16-row query tile).
// Each warp owns 4 query rows; per staged 32-key tile of K and V in shared
// memory (f32, K row pitch D+1 so lanes hit distinct banks), lane j scores
// key j, the warp reduces max and sum with shuffles, and each lane
// accumulates up to 4 output columns (lane, lane+32, ...) with p broadcast
// by shuffle.  No padding of D or T in device memory: the block masks the
// ragged tile itself.  Left for later: tensor cores (mma.sync / wgmma),
// TMA or cp.async double buffering of the K/V tiles, and one block reusing
// its K/V tiles for all query tiles of a head.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 16;               // query rows per block
constexpr int kBlockK = 32;               // keys per staged tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kBlockQ / kWarps;   // query rows per warp
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the PV product sees it: rounded to the input dtype
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<T>(p));
}

// dropout_keep's lowbias32-style mixer (ops/attention.py); wraps mod 2^32
__device__ __forceinline__ uint32_t dropout_hash(uint32_t seed, uint32_t bh,
                                                 uint32_t qpos, uint32_t kpos) {
  uint32_t h = seed * 0x9E3779B9u + bh * 0x85EBCA6Bu + qpos * 0xC2B2AE35u +
               kpos * 0x27D4EB2Fu;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// DC = ceil(D / 32): output columns per lane
template <typename T, int DC>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t, int d,
                 int n_qtiles, float scale, uint32_t seed, int use_dropout,
                 uint32_t thresh, float inv_keep) {
  constexpr int DP = DC * 32;
  __shared__ float q_s[kBlockQ][DP];
  __shared__ float k_s[kBlockK][DP + 1];
  __shared__ float v_s[kBlockK][DP];

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(bh) * t * d;

  for (int i = tid; i < kBlockQ * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    q_s[r][c] = (q0 + r < t) ? to_f32(q[base + static_cast<size_t>(q0 + r) * d + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed; q_s is written
    for (int i = tid; i < kBlockK * d; i += blockDim.x) {
      const int j = i / d, c = i - j * d;
      const bool ok = k0 + j < t;
      const size_t off = base + static_cast<size_t>(k0 + j) * d + c;
      k_s[j][c] = ok ? to_f32(k[off]) : 0.f;
      v_s[j][c] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    const int kpos = k0 + lane;
    const int n_keys = min(kBlockK, t - k0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      const int qpos = q0 + row;
      if (qpos < t) {  // uniform across the warp
        float s = 0.f;
        for (int c = 0; c < d; ++c) s = fmaf(q_s[row][c], k_s[lane][c], s);
        s = kpos < t ? s * scale : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(s));
        const float alpha = expf(m[r] - m_new);
        float p = expf(s - m_new);
        l[r] = alpha * l[r] + warp_sum(p);  // the normalizer sums the raw p
        if (use_dropout) {
          const bool keep = (dropout_hash(seed, bh, qpos, kpos) & 0xFFFFFFu) >= thresh;
          p = keep ? p * inv_keep : 0.f;
        }
        p = round_p<T>(p);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
        for (int j = 0; j < n_keys; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pj, v_s[j][lane + 32 * c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos < t) {
      const float inv_l = 1.f / l[r];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = lane + 32 * c;
        if (col < d) o[base + static_cast<size_t>(qpos) * d + col] = from_f32<T>(acc[r][c] * inv_l);
      }
      if (lse != nullptr && lane == 0) {
        lse[static_cast<size_t>(bh) * t + qpos] = m[r] + logf(fmaxf(l[r], 1e-30f));
      }
    }
  }
}

template <typename T, int DC>
void launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
            int t, int d, float scale, uint32_t seed, int use_dropout, uint32_t thresh,
            float inv_keep, cudaStream_t stream) {
  const int n_qtiles = (t + kBlockQ - 1) / kBlockQ;
  flash_fwd_kernel<T, DC><<<bh * n_qtiles, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, t, d, n_qtiles, scale, seed, use_dropout, thresh, inv_keep);
}

template <typename T>
void dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
              int t, int d, float scale, uint32_t seed, int use_dropout, uint32_t thresh,
              float inv_keep, cudaStream_t stream) {
  switch ((d + 31) / 32) {
    case 1: launch<T, 1>(q, k, v, o, lse, bh, t, d, scale, seed, use_dropout, thresh, inv_keep, stream); break;
    case 2: launch<T, 2>(q, k, v, o, lse, bh, t, d, scale, seed, use_dropout, thresh, inv_keep, stream); break;
    case 3: launch<T, 3>(q, k, v, o, lse, bh, t, d, scale, seed, use_dropout, thresh, inv_keep, stream); break;
    default: launch<T, 4>(q, k, v, o, lse, bh, t, d, scale, seed, use_dropout, thresh, inv_keep, stream); break;
  }
}

}  // namespace

// q, k, v, o: contiguous (bh, t, d) arrays on the device, all f32 (is_bf16 = 0)
// or all bf16 (is_bf16 = 1); 1 <= d <= 128.  lse: null, or a contiguous
// (bh, t) f32 array that receives the row log-sum-exp.  seed >= 0; thresh and inv_keep
// are dropout_keep's threshold on the low 24 hash bits and 1/(1-rate).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int t, int d, int is_bf16, float scale, int seed,
                         int use_dropout, int thresh, float inv_keep, void* stream) {
  const long long n_qtiles = (t + kBlockQ - 1) / kBlockQ;
  if (bh < 1 || t < 1 || d < 1 || d > 128 || seed < 0 || thresh < 0 ||
      static_cast<long long>(bh) * n_qtiles > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dispatch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), bh, t, d, scale, static_cast<uint32_t>(seed),
                            use_dropout, static_cast<uint32_t>(thresh), inv_keep, s);
  } else {
    dispatch<float>(q, k, v, o, static_cast<float*>(lse), bh, t, d, scale, static_cast<uint32_t>(seed),
                    use_dropout, static_cast<uint32_t>(thresh), inv_keep, s);
  }
  return static_cast<int>(cudaGetLastError());
}
