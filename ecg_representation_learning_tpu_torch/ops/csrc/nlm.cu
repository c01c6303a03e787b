// 1-D non-local means over rows, for Hopper (sm_90a), CUDA C++ with a plain C
// entry.
//
// Replaces two TPU kernels of the JAX package:
//   * ops/nlm_pallas.py::_nlm_kernel (launched by _nlm_pallas_2d), entry
//     nlm_rows below;
//   * tools/nlm_sol_probe.py::_variant_kernel (launched by _run_variant), the
//     same kernel with parts switched off for cost attribution, entry
//     nlm_variant below (template switches BOX, EXP, MIRROR, ACCUM).
//
// What it computes, for each row of x (R, n) with its inverse bandwidth
// hinv = 1/h, for every shift magnitude s < sch:
//   ssd_s[k]  = (x[k] - x[k+s])^2   where 0 <= k and k+s < n, else 0
//   d_s[p]    = sum_{k=p-pw}^{p+pw} ssd_s[k]          (the Darbon distance)
//   w_s[p]    = exp(-d_s[p] * hinv)
//   +s term:  num[i] += w_s[i] x[i+s],   z[i] += w_s[i]      if i+s < n
//   -s term:  num[i] += w_s[i-s] x[i-s], z[i] += w_s[i-s]    if s > 0, i-s > 0
// (the -s distance is d_s at i-s: d_{-s}[i] = d_s[i-s]), for interior
// i in [pw+1, n-pw); out = num / (z + eps) there and x elsewhere.  eps is the
// f64 machine epsilon for nlm_rows and 1e-12 for nlm_variant, as the two TPU
// kernels have it.  An all-zero row has h = 0, hinv = inf and d = 0, so
// -0 * inf is NaN and the row comes out NaN, as in the JAX package.
//
// The TPU kernel pads n to 128 lanes (at least n + pw) and rolls circularly,
// relying on zeroed pad lanes; here the masks are explicit, so any n and any
// R work with no padding.
//
// Design (first, simple): one block owns (row, segment of T = threads * 8
// positions), keeps the num/z accumulators of its positions in registers and
// loops over s itself (the TPU's sequential grid axis).  Per s it stages the
// SSD of the positions it needs in shared memory, forms the weights of those
// positions once (box sum + expf) into shared memory, and accumulates both
// terms.  For n <= 4096 a row is one segment, which then also holds every
// -s weight it reads; a longer row's segment forms the weights of its window
// shifted by -s too.  Only the weights that some term reads are formed, so a
// full search (sch = n) costs about half of R * n * sch.  expf is the
// accurate one (no --use_fast_math); num and z use unfused IEEE multiply-adds
// in the plain version's order.
//
// Bound on the H100: about 20 operations per (row, position, s) whose weight
// is needed (SSD, box sum, scale, exp, masks, four accumulations) against
// 8 bytes per element of x in and out, so it is bound by operations: at
// (768, 2500), full search, 4.8e10 operations, 0.72 ms at 67 TFLOP/s.  This
// design spends ~2 * pw + 1 shared loads and adds per weight on the box sum.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kPer = 8;            // positions per thread
constexpr int kMaxThreads = 512;   // segment <= 4096 positions

struct Params {
  const float* x;
  const float* hinv;
  float* out;
  int n, sch, pw, seg;
  float eps;
};

__device__ __forceinline__ void hull(int& lo, int& hi, int a, int b) {
  if (a < b) {
    lo = min(lo, a);
    hi = max(hi, b);
  }
}

// ssd_s[k] for k in [klo, khi) into buf[k - base]
__device__ __forceinline__ void fill_ssd(float* buf, int base, int klo, int khi,
                                         const float* __restrict__ xr, int n, int s) {
  for (int k = klo + threadIdx.x; k < khi; k += blockDim.x) {
    float v = 0.f;
    if (k >= 0 && k + s < n) {
      const float d = __fsub_rn(xr[k], xr[k + s]);
      v = __fmul_rn(d, d);
    }
    buf[k - base] = v;
  }
}

// w_s[p] for p in [plo, phi) into w[p - base], from ssd staged at
// ssd[k - (base - pw)]
template <bool BOX, bool EXP>
__device__ __forceinline__ void fill_weights(float* w, const float* ssd, int base,
                                             int plo, int phi, int pw, float hinv) {
  for (int p = plo + threadIdx.x; p < phi; p += blockDim.x) {
    const float* taps = ssd + (p - base);
    float d;
    if (BOX) {
      d = taps[0];
      for (int t = 1; t <= 2 * pw; ++t) d = __fadd_rn(d, taps[t]);
    } else {
      d = taps[pw];
    }
    w[p - base] = EXP ? expf(__fmul_rn(-d, hinv)) : __fmul_rn(d, hinv);
  }
}

template <bool BOX, bool EXP, bool MIRROR, bool ACCUM>
__global__ void __launch_bounds__(kMaxThreads) nlm_kernel(Params p) {
  extern __shared__ float smem[];
  const int n = p.n, pw = p.pw, T = p.seg;
  const int row = blockIdx.x;
  const int a = blockIdx.y * T;             // first position of the segment
  const int span = T + 2 * pw;
  float* ssd_own = smem;                    // ssd at k = a - pw + j
  float* w_own = ssd_own + span;            // w at p = a + j
  float* ssd_mir = w_own + T;               // ssd at k = a - s - pw + j (split rows)
  float* w_mir = ssd_mir + span;            // w at p = a - s + j
  const float* __restrict__ xr = p.x + static_cast<size_t>(row) * n;
  const float hinv = p.hinv[row];
  const int own_lo = max(a, pw + 1);        // interior positions of the segment
  const int own_hi = min(a + T, n - pw);
  const int r = BOX ? pw : 0;               // SSD halo of a weight

  float num[kPer], z[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) num[c] = z[c] = 0.f;

  for (int s = 0; s < p.sch; ++s) {
    const bool mirror = ACCUM && MIRROR && s > 0;
    // the weights this step reads: in the segment [lo, hi), before it [mlo, mhi)
    int lo = INT_MAX, hi = INT_MIN, mlo = 0, mhi = 0;
    if (ACCUM) {
      hull(lo, hi, own_lo, min(own_hi, n - s));
      if (mirror) {
        hull(lo, hi, max(max(own_lo - s, 1), a), own_hi - s);
        mlo = max(own_lo - s, 1);
        mhi = min(own_hi - s, a);
      }
    } else {
      hull(lo, hi, own_lo, own_hi);
    }
    if (lo < hi) fill_ssd(ssd_own, a - pw, lo - r, hi + r, xr, n, s);
    if (mlo < mhi) fill_ssd(ssd_mir, a - s - pw, mlo - r, mhi + r, xr, n, s);
    __syncthreads();
    if (lo < hi) fill_weights<BOX, EXP>(w_own, ssd_own, a, lo, hi, pw, hinv);
    if (mlo < mhi) fill_weights<BOX, EXP>(w_mir, ssd_mir, a - s, mlo, mhi, pw, hinv);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int i = a + c * blockDim.x + threadIdx.x;
      if (i < own_lo || i >= own_hi) continue;
      if (!ACCUM) {
        const float w = w_own[i - a];
        num[c] = __fadd_rn(num[c], w);
        z[c] = __fadd_rn(z[c], w);
        continue;
      }
      if (i + s < n) {
        const float w = w_own[i - a];
        num[c] = __fadd_rn(num[c], __fmul_rn(w, xr[i + s]));
        z[c] = __fadd_rn(z[c], w);
      }
      if (mirror && i - s > 0) {
        const int q = i - s;
        const float w = q >= a ? w_own[q - a] : w_mir[q - (a - s)];
        num[c] = __fadd_rn(num[c], __fmul_rn(w, xr[q]));
        z[c] = __fadd_rn(z[c], w);
      }
    }
    // the next step's SSD writes wait at its first barrier for these reads
  }

  float* outr = p.out + static_cast<size_t>(row) * n;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int i = a + c * blockDim.x + threadIdx.x;
    if (i >= min(a + T, n)) continue;
    const bool interior = i >= pw + 1 && i < n - pw;
    outr[i] = interior ? __fdiv_rn(num[c], __fadd_rn(z[c], p.eps)) : xr[i];
  }
}

template <bool BOX, bool EXP, bool MIRROR, bool ACCUM>
int launch(const void* x, const void* hinv, void* out, int rows, int n, int sch, int pw,
           float eps, void* stream) {
  if (rows < 1 || n < 1 || sch < 1 || pw < 0) return static_cast<int>(cudaErrorInvalidValue);
  int threads = (n + kPer - 1) / kPer;
  threads = min(kMaxThreads, max(32, (threads + 31) / 32 * 32));
  const int seg = threads * kPer;
  const int segs = (n + seg - 1) / seg;
  if (segs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t floats = static_cast<size_t>(seg + 2 * pw + seg) * (segs > 1 ? 2 : 1);
  const size_t smem = floats * sizeof(float);
  auto kernel = nlm_kernel<BOX, EXP, MIRROR, ACCUM>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Params p{static_cast<const float*>(x), static_cast<const float*>(hinv),
                 static_cast<float*>(out), n, sch, pw, seg, eps};
  kernel<<<dim3(rows, segs), threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (rows, n) f32 contiguous on the device; hinv: (rows,) f32, 1/h per
// row.  sch: shift magnitudes 0 .. sch-1; pw: patch half-width.  Launches one
// kernel on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for arguments it does not take).
extern "C" int nlm_rows(const void* x, const void* hinv, void* out, int rows, int n,
                        int sch, int pw, void* stream) {
  return launch<true, true, true, true>(x, hinv, out, rows, n, sch, pw,
                                        2.220446049250313e-16f, stream);
}

// The attribution variants: nlm_rows with the box sum (boxtree: else d = ssd
// at the position itself), the exp (use_exp: else w = d * hinv), the -s term
// (mirror) or the masked accumulation (accum: else num and z add the
// unmasked w of every step, and there is no -s term) switched off.
extern "C" int nlm_variant(const void* x, const void* hinv, void* out, int rows, int n,
                           int sch, int pw, int boxtree, int use_exp, int mirror, int accum,
                           void* stream) {
  const float eps = 1e-12f;
  const int key = (boxtree ? 8 : 0) | (use_exp ? 4 : 0) | (mirror ? 2 : 0) | (accum ? 1 : 0);
#define NLM_CASE(K, B, E, M, A) \
  case K: return launch<B, E, M, A>(x, hinv, out, rows, n, sch, pw, eps, stream);
  switch (key) {
    NLM_CASE(0, false, false, false, false)
    NLM_CASE(1, false, false, false, true)
    NLM_CASE(2, false, false, true, false)
    NLM_CASE(3, false, false, true, true)
    NLM_CASE(4, false, true, false, false)
    NLM_CASE(5, false, true, false, true)
    NLM_CASE(6, false, true, true, false)
    NLM_CASE(7, false, true, true, true)
    NLM_CASE(8, true, false, false, false)
    NLM_CASE(9, true, false, false, true)
    NLM_CASE(10, true, false, true, false)
    NLM_CASE(11, true, false, true, true)
    NLM_CASE(12, true, true, false, false)
    NLM_CASE(13, true, true, false, true)
    NLM_CASE(14, true, true, true, false)
    NLM_CASE(15, true, true, true, true)
  }
#undef NLM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
