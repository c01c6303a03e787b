// Blocked flash-attention backward for Hopper (sm_90a), CUDA C++ with plain C
// entries: one kernel for dQ, one for dK and dV.
//
// Replaces the TPU kernels ops/attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel of the JAX package (Pallas, both launched by
// _flash_backward_blocked's pl.pallas_call).  Same function, for each
// bh = b*H + h, query row i and key j < T:
//   p_ij   = exp(scale * q_i.k_j - lse_i)          (lse from the forward)
//   dpv_ij = dO_i . v_j, times keep_ij / (1 - rate) when dropout is on
//   ds_ij  = p_ij * (dpv_ij - delta_i)             (delta = rowsum(dO * O))
//   dQ_i   = scale * sum_j ds_ij k_j               (ds rounded to k's dtype)
//   dK_j   = scale * sum_i ds_ij q_i               (ds rounded to q's dtype)
//   dV_j   = sum_i p_ij keep_ij / (1 - rate) dO_i  (p stays f32: dO is f32 there)
// with the keep mask regenerated from dropout_keep's hash of (seed, bh,
// qpos, kpos), never stored.  Inputs f32 or bf16; every product is an f32
// FMA (the TPU pins Precision.HIGHEST for f32); outputs in the input dtype.
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32 without tensor cores):
// at the serving shape B=64, H=12, T=41, D=64 in f32, dQ reads q, k, v, dO
// (32.2 MB), lse and delta (0.25 MB) and writes dQ (8.1 MB): 40.6 MB, 12.1 us;
// dK/dV writes two outputs: 48.6 MB, 14.5 us.  Their operations, 6 and 8 *
// B*H*T^2*D (0.50 and 0.66 GFLOP, 7.4 and 9.9 us on the f32 CUDA cores), are
// below that at T = 41 and above it at T >= 1k, where this design runs them on
// the CUDA cores.
//
// Design (simple first).  The TPU grids carry an accumulator across a
// sequential grid axis; Hopper blocks run in any order, so each block owns
// its output rows and loops over the other side itself:
//   * dQ: one block of 4 warps per (bh, 16-query tile); each warp owns 4
//     query rows; per staged 32-key tile of K and V (f32 in shared memory,
//     row pitch D+1 so lanes hit distinct banks) lane j scores key j, forms
//     ds, and the warp accumulates dQ's columns (lane, lane+32, ...) with ds
//     broadcast by shuffle;
//   * dK/dV: one block per (bh, 16-key tile); each warp owns 4 keys; per
//     staged 32-query tile of Q and dO (with its lse and delta) lane i takes
//     query i, and the warp accumulates dK and dV the same way.
// No atomics, so the result is the same from run to run; no padding of T or D
// in device memory: the blocks mask the ragged tiles.  Left for later: tensor
// cores (mma.sync / wgmma), cp.async or TMA double buffering, and reusing the
// staged tiles across more output rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOwn = 16;                  // output rows a block owns
constexpr int kTile = 32;                 // rows per staged tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kOwn / kWarps;      // output rows per warp

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x as a product with a T operand sees it: rounded to T
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
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

struct Dropout {
  uint32_t seed;
  int on;
  uint32_t thresh;   // keep iff low 24 hash bits >= thresh
  float inv_keep;    // 1 / (1 - rate)
};

// Shared-memory floats of either kernel: kOwn rows at pitch DP (read as
// broadcasts) and kTile rows at pitch DP+1 (read lane-strided), two of each,
// plus the staged tile's lse and delta.
template <int DP> constexpr size_t smem_bytes() {
  return (2 * kOwn * DP + 2 * kTile * (DP + 1) + 2 * kTile) * sizeof(float);
}

// DC = ceil(D / 32): output columns per lane
template <typename T, int DC>
__global__ void __launch_bounds__(kWarps * 32)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int t, int d,
              int n_tiles, float scale, Dropout drop) {
  constexpr int DP = DC * 32;
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kOwn][DP]
  float* do_s = q_s + kOwn * DP;            // [kOwn][DP]
  float* k_s = do_s + kOwn * DP;            // [kTile][DP + 1]
  float* v_s = k_s + kTile * (DP + 1);      // [kTile][DP + 1]

  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kOwn;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(bh) * t * d;

  for (int i = tid; i < kOwn * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    const bool ok = q0 + r < t;
    const size_t off = base + static_cast<size_t>(q0 + r) * d + c;
    q_s[r * DP + c] = ok ? to_f32(q[off]) : 0.f;
    do_s[r * DP + c] = ok ? to_f32(dout[off]) : 0.f;
  }

  float lse_r[kRows], delta_r[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    lse_r[r] = qpos < t ? lse[static_cast<size_t>(bh) * t + qpos] : 0.f;
    delta_r[r] = qpos < t ? delta[static_cast<size_t>(bh) * t + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed; q_s and do_s are written
    for (int i = tid; i < kTile * d; i += blockDim.x) {
      const int j = i / d, c = i - j * d;
      const bool ok = k0 + j < t;
      const size_t off = base + static_cast<size_t>(k0 + j) * d + c;
      k_s[j * (DP + 1) + c] = ok ? to_f32(k[off]) : 0.f;
      v_s[j * (DP + 1) + c] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    const int kpos = k0 + lane;
    const int n_keys = min(kTile, t - k0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      const int qpos = q0 + row;
      if (qpos < t) {  // uniform across the warp
        float s = 0.f, dpv = 0.f;
        for (int c = 0; c < d; ++c) {
          s = fmaf(q_s[row * DP + c], k_s[lane * (DP + 1) + c], s);
          dpv = fmaf(do_s[row * DP + c], v_s[lane * (DP + 1) + c], dpv);
        }
        float ds = 0.f;
        if (kpos < t) {
          const float p = expf(s * scale - lse_r[r]);
          if (drop.on) {
            const bool keep = (dropout_hash(drop.seed, bh, qpos, kpos) & 0xFFFFFFu) >= drop.thresh;
            dpv = keep ? dpv * drop.inv_keep : 0.f;
          }
          ds = round_to<T>(p * (dpv - delta_r[r]));
        }
        for (int j = 0; j < n_keys; ++j) {
          const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
          for (int c = 0; c < DC; ++c)
            acc[r][c] = fmaf(dsj, k_s[j * (DP + 1) + lane + 32 * c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos < t) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = lane + 32 * c;
        if (col < d) dq[base + static_cast<size_t>(qpos) * d + col] = from_f32<T>(acc[r][c] * scale);
      }
    }
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kWarps * 32)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
               int t, int d, int n_tiles, float scale, Dropout drop) {
  constexpr int DP = DC * 32;
  extern __shared__ float smem[];
  float* k_s = smem;                        // [kOwn][DP]
  float* v_s = k_s + kOwn * DP;             // [kOwn][DP]
  float* q_s = v_s + kOwn * DP;             // [kTile][DP + 1]
  float* do_s = q_s + kTile * (DP + 1);     // [kTile][DP + 1]
  float* lse_s = do_s + kTile * (DP + 1);   // [kTile]
  float* delta_s = lse_s + kTile;           // [kTile]

  const int bh = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * kOwn;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(bh) * t * d;

  for (int i = tid; i < kOwn * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    const bool ok = k0 + r < t;
    const size_t off = base + static_cast<size_t>(k0 + r) * d + c;
    k_s[r * DP + c] = ok ? to_f32(k[off]) : 0.f;
    v_s[r * DP + c] = ok ? to_f32(v[off]) : 0.f;
  }

  float acc_dk[kRows][DC], acc_dv[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;
  }

  for (int q0 = 0; q0 < t; q0 += kTile) {
    __syncthreads();  // the previous tile is consumed; k_s and v_s are written
    for (int i = tid; i < kTile * d; i += blockDim.x) {
      const int j = i / d, c = i - j * d;
      const bool ok = q0 + j < t;
      const size_t off = base + static_cast<size_t>(q0 + j) * d + c;
      q_s[j * (DP + 1) + c] = ok ? to_f32(q[off]) : 0.f;
      do_s[j * (DP + 1) + c] = ok ? to_f32(dout[off]) : 0.f;
    }
    if (tid < kTile) {
      const bool ok = q0 + tid < t;
      lse_s[tid] = ok ? lse[static_cast<size_t>(bh) * t + q0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[static_cast<size_t>(bh) * t + q0 + tid] : 0.f;
    }
    __syncthreads();

    const int qpos = q0 + lane;
    const int n_q = min(kTile, t - q0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      const int kpos = k0 + row;
      if (kpos < t) {  // uniform across the warp
        float s = 0.f, dpv = 0.f;
        for (int c = 0; c < d; ++c) {
          s = fmaf(q_s[lane * (DP + 1) + c], k_s[row * DP + c], s);
          dpv = fmaf(do_s[lane * (DP + 1) + c], v_s[row * DP + c], dpv);
        }
        float pe = 0.f, ds = 0.f;
        if (qpos < t) {  // padded queries contribute 0
          const float p = expf(s * scale - lse_s[lane]);
          pe = p;
          if (drop.on) {
            const bool keep = (dropout_hash(drop.seed, bh, qpos, kpos) & 0xFFFFFFu) >= drop.thresh;
            pe = keep ? p * drop.inv_keep : 0.f;
            dpv = keep ? dpv * drop.inv_keep : 0.f;
          }
          ds = round_to<T>(p * (dpv - delta_s[lane]));
        }
        for (int j = 0; j < n_q; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pe, j);
          const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            acc_dv[r][c] = fmaf(pj, do_s[j * (DP + 1) + lane + 32 * c], acc_dv[r][c]);
            acc_dk[r][c] = fmaf(dsj, q_s[j * (DP + 1) + lane + 32 * c], acc_dk[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kpos = k0 + warp * kRows + r;
    if (kpos < t) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = lane + 32 * c;
        if (col < d) {
          const size_t off = base + static_cast<size_t>(kpos) * d + col;
          dk[off] = from_f32<T>(acc_dk[r][c] * scale);
          dv[off] = from_f32<T>(acc_dv[r][c]);
        }
      }
    }
  }
}

// Grants a kernel more than the default 48 KB of dynamic shared memory when
// it needs it (D > 96 in f32 tiles).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;  // dq for the dQ kernel; dk and dv for the other
  int bh, t, d;
  float scale;
  Dropout drop;
  cudaStream_t stream;
};

template <typename T, int DC>
cudaError_t launch(const Args& a, bool want_dq) {
  constexpr size_t smem = smem_bytes<DC * 32>();
  const int n_tiles = (a.t + kOwn - 1) / kOwn;
  const auto* q = static_cast<const T*>(a.q);
  const auto* k = static_cast<const T*>(a.k);
  const auto* v = static_cast<const T*>(a.v);
  const auto* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (want_dq) {
    err = allow_smem(bwd_dq_kernel<T, DC>, smem);
    if (err != cudaSuccess) return err;
    bwd_dq_kernel<T, DC><<<a.bh * n_tiles, kWarps * 32, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.t, a.d, n_tiles,
        a.scale, a.drop);
  } else {
    err = allow_smem(bwd_dkv_kernel<T, DC>, smem);
    if (err != cudaSuccess) return err;
    bwd_dkv_kernel<T, DC><<<a.bh * n_tiles, kWarps * 32, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.t, a.d, n_tiles, a.scale, a.drop);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, bool want_dq) {
  switch ((a.d + 31) / 32) {
    case 1: return launch<T, 1>(a, want_dq);
    case 2: return launch<T, 2>(a, want_dq);
    case 3: return launch<T, 3>(a, want_dq);
    default: return launch<T, 4>(a, want_dq);
  }
}

int run(const Args& a, int is_bf16, int seed, int thresh, bool want_dq) {
  const long long n_tiles = (a.t + kOwn - 1) / kOwn;
  if (a.bh < 1 || a.t < 1 || a.d < 1 || a.d > 128 || seed < 0 || thresh < 0 ||
      static_cast<long long>(a.bh) * n_tiles > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(is_bf16 ? dispatch<__nv_bfloat16>(a, want_dq)
                                  : dispatch<float>(a, want_dq));
}

}  // namespace

// q, k, v, dout (the output's cotangent) and the outputs: contiguous (bh, t, d)
// arrays on the device, all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1);
// 1 <= d <= 128.  lse and delta: contiguous (bh, t) f32.  seed >= 0; thresh
// and inv_keep are dropout_keep's threshold on the low 24 hash bits and
// 1/(1-rate).  Each launches on `stream` and returns cudaGetLastError().
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int t,
                            int d, int is_bf16, float scale, int seed, int use_dropout,
                            int thresh, float inv_keep, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, nullptr, bh, t, d, scale,
               Dropout{static_cast<uint32_t>(seed), use_dropout, static_cast<uint32_t>(thresh),
                       inv_keep},
               static_cast<cudaStream_t>(stream)};
  return run(a, is_bf16, seed, thresh, true);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int t, int d, int is_bf16, float scale, int seed,
                             int use_dropout, int thresh, float inv_keep, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               nullptr, dk, dv, bh, t, d, scale,
               Dropout{static_cast<uint32_t>(seed), use_dropout, static_cast<uint32_t>(thresh),
                       inv_keep},
               static_cast<cudaStream_t>(stream)};
  return run(a, is_bf16, seed, thresh, false);
}
