// The Bernoulli dropout sites of the ViT block for Hopper (sm_90a), CUDA C++
// with a plain C entry: each site's mask applied together with the
// elementwise operation beside it, one launch forward and one backward.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it into its neighbours.  Eager PyTorch ran it as a chain of kernels
// (the mask cast to bool, the scale, `where`, then GELU or the residual add,
// and the mirror of each in the backward), each reading and writing the
// whole activation; here each direction of a site is one pass.  Two kinds:
//
//   gelu_dropout (the MLP hidden): h = where(keep, A(A(gelu(a)) * inv), 0),
//     A the activation's type; its backward reads g, the mask and a and
//     writes da = A(A(where(keep, g * inv, 0)) * gelu'(a)).
//   dropout_add (the attention output and the MLP output): out = x +
//     where(keep, Y(y * inv), 0) in the wider of x's and y's types; its
//     backward reads g and the mask and writes dy = where(keep, Y(Y(g) *
//     inv), 0) (the gradient of x is g itself, which the caller passes on).
//
// Rounding repeats the chain's: a PyTorch division by a Python scalar
// multiplies by the f32 reciprocal `inv` (the caller's), GELU's erf form and
// its derivative are computed in f32 as PyTorch's kernels write them and
// rounded to A before the scale, and the residual sum is one f32 add.  The
// products and sums that the chain rounds apart are __fmul_rn / __fadd_rn
// here, so the compiler cannot contract them into an FMA.  `keep` is the
// Bernoulli draw itself, drawn as bool (one byte, 0 or 1).
//
// Bound on the H100 (3.35 TB/s): a pure stream of a few bytes per element
// (gelu_dropout 5 B forward, 7 B backward in bf16; dropout_add 11 B forward,
// 7 B backward with a bf16 branch and an f32 residual), against ~30 f32
// operations for erf and exp, so bytes set the pace.  The design moves each byte once in
// 16-byte transactions: a thread takes 8 elements per step (one 16-byte
// load of bf16, two of f32, one 8-byte load of bool), issues every load of
// the step before its arithmetic, and walks the tensor in a grid-stride loop
// over at most 8 blocks of 256 threads per SM; elements past the last whole
// group of 8, and every element of a call whose pointers are not all 16-byte
// aligned, go one at a time.  A launch runs on the caller's stream, allocates
// nothing and does not synchronise, so a CUDA graph captures it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;            // elements a thread takes per step
constexpr int kBlocksPerSm = 8;
// PyTorch's GELU constants, M_SQRT1_2 and M_2_SQRTPI * M_SQRT1_2 * 0.5 taken
// in double and rounded to f32 (-std=c++17 leaves math.h's M_ names out)
constexpr double kSqrt1_2 = 0.70710678118654752440;
constexpr float kAlpha = kSqrt1_2;
constexpr float kBeta = 1.12837916709551257390 * kSqrt1_2 * 0.5;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ bool kept(uint8_t m) { return m != 0; }

// W elements at p: one element, or kVec in 16-byte (8-byte for bytes) loads
template <int W, class T>
__device__ __forceinline__ void load(const T* __restrict__ p, T (&v)[W]) {
  if constexpr (W == 1) {
    v[0] = p[0];
  } else if constexpr (W * sizeof(T) == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    memcpy(v, &u, 8);
  } else {
#pragma unroll
    for (int k = 0; k < int(W * sizeof(T) / 16); ++k) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[k];
      memcpy(reinterpret_cast<char*>(v) + 16 * k, &u, 16);
    }
  }
}

template <int W, class T>
__device__ __forceinline__ void store(T* __restrict__ p, const T (&v)[W]) {
  if constexpr (W == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int k = 0; k < int(W * sizeof(T) / 16); ++k) {
      uint4 u;
      memcpy(&u, reinterpret_cast<const char*>(v) + 16 * k, 16);
      reinterpret_cast<uint4*>(p)[k] = u;
    }
  }
}

// PyTorch's GELU (erf form) and its derivative's factor, in f32
__device__ __forceinline__ float gelu(float x) {
  return x * 0.5f * (1.f + erff(x * kAlpha));
}
__device__ __forceinline__ float gelu_grad(float dy, float x) {
  const float cdf = 0.5f * (1.f + erff(x * kAlpha));
  const float pdf = expf(-0.5f * x * x) * kBeta;
  return dy * (cdf + x * pdf);
}

template <class A>
struct GeluDropoutFwd {
  const A* a;
  const uint8_t* keep;
  A* h;
  float inv;
  template <int W> __device__ __forceinline__ void run(long long e) const {
    A av[W], hv[W];
    uint8_t mv[W];
    load<W>(a + e, av);
    load<W>(keep + e, mv);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float g = to_f(from_f<A>(gelu(to_f(av[i]))));
      hv[i] = from_f<A>(kept(mv[i]) ? __fmul_rn(g, inv) : 0.f);
    }
    store<W>(h + e, hv);
  }
};

template <class A>
struct GeluDropoutBwd {
  const A* g;
  const uint8_t* keep;
  const A* a;
  A* da;
  float inv;
  template <int W> __device__ __forceinline__ void run(long long e) const {
    A gv[W], av[W], dv[W];
    uint8_t mv[W];
    load<W>(g + e, gv);
    load<W>(keep + e, mv);
    load<W>(a + e, av);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float dy = to_f(from_f<A>(kept(mv[i]) ? __fmul_rn(to_f(gv[i]), inv) : 0.f));
      dv[i] = from_f<A>(gelu_grad(dy, to_f(av[i])));
    }
    store<W>(da + e, dv);
  }
};

template <class Y, class R>
using Sum = std::conditional_t<std::is_same_v<Y, float> || std::is_same_v<R, float>, float, bf16>;

template <class Y, class R>
struct DropoutAddFwd {
  const Y* y;
  const uint8_t* keep;
  const R* x;
  Sum<Y, R>* out;
  float inv;
  template <int W> __device__ __forceinline__ void run(long long e) const {
    Y yv[W];
    R xv[W];
    uint8_t mv[W];
    Sum<Y, R> ov[W];
    load<W>(y + e, yv);
    load<W>(keep + e, mv);
    load<W>(x + e, xv);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float d = to_f(from_f<Y>(kept(mv[i]) ? __fmul_rn(to_f(yv[i]), inv) : 0.f));
      ov[i] = from_f<Sum<Y, R>>(__fadd_rn(to_f(xv[i]), d));
    }
    store<W>(out + e, ov);
  }
};

template <class G, class Y>
struct DropoutAddBwd {
  const G* g;
  const uint8_t* keep;
  Y* dy;
  float inv;
  template <int W> __device__ __forceinline__ void run(long long e) const {
    G gv[W];
    uint8_t mv[W];
    Y dv[W];
    load<W>(g + e, gv);
    load<W>(keep + e, mv);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float gy = to_f(from_f<Y>(to_f(gv[i])));   // the cast to y's type
      dv[i] = from_f<Y>(kept(mv[i]) ? __fmul_rn(gy, inv) : 0.f);
    }
    store<W>(dy + e, dv);
  }
};

// groups of kVec while every pointer is 16-byte aligned (vec), then the rest
// one element at a time, both over a grid-stride loop
template <class Op>
__global__ void __launch_bounds__(kThreads) site_kernel(Op op, long long n, bool vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long groups = vec ? n / kVec : 0;
  for (long long q = tid; q < groups; q += stride) op.template run<kVec>(q * kVec);
  for (long long e = groups * kVec + tid; e < n; e += stride) op.template run<1>(e);
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 132;
  }
  return counts[dev];
}

template <class Op>
int launch(const Op& op, long long n, bool vec, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long work = vec ? (n + kVec - 1) / kVec : n;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  long long grid = (work + kThreads - 1) / kThreads;
  if (grid > cap) grid = cap;
  site_kernel<<<static_cast<int>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      op, n, vec);
  return static_cast<int>(cudaGetLastError());
}

template <class T> struct Tag { using type = T; };

// f(Tag<f32>) or f(Tag<bf16>) by a type code (0 f32, 1 bf16)
template <class F> int by_dtype(int code, F&& f) {
  if (code == 0) return f(Tag<float>{});
  if (code == 1) return f(Tag<bf16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each entry: n elements, contiguous, on the device of the current stream;
// a type code is 0 for f32 and 1 for bf16, the mask is bool, and inv is the
// f32 reciprocal of the keep probability.  Returns cudaGetLastError() after
// the launch.

// h = dropout(gelu(a)); a and h of one type.
extern "C" int gelu_dropout_forward(const void* a, const void* keep, void* h, long long n,
                                    int a_code, float inv, void* stream) {
  const bool vec = aligned(a) && aligned(keep) && aligned(h);
  return by_dtype(a_code, [&](auto at) {
    using A = typename decltype(at)::type;
    const GeluDropoutFwd<A> op{static_cast<const A*>(a), static_cast<const uint8_t*>(keep),
                               static_cast<A*>(h), inv};
    return launch(op, n, vec, stream);
  });
}

// da from g (the gradient of h), the mask and a; g, a and da of one type.
extern "C" int gelu_dropout_backward(const void* g, const void* keep, const void* a, void* da,
                                     long long n, int a_code, float inv, void* stream) {
  const bool vec = aligned(g) && aligned(keep) && aligned(a) && aligned(da);
  return by_dtype(a_code, [&](auto at) {
    using A = typename decltype(at)::type;
    const GeluDropoutBwd<A> op{static_cast<const A*>(g), static_cast<const uint8_t*>(keep),
                               static_cast<const A*>(a), static_cast<A*>(da), inv};
    return launch(op, n, vec, stream);
  });
}

// out = x + dropout(y); out is f32 unless x and y are both bf16.
extern "C" int dropout_add_forward(const void* y, const void* keep, const void* x, void* out,
                                   long long n, int y_code, int x_code, float inv,
                                   void* stream) {
  const bool vec = aligned(y) && aligned(keep) && aligned(x) && aligned(out);
  return by_dtype(y_code, [&](auto yt) {
    using Y = typename decltype(yt)::type;
    return by_dtype(x_code, [&](auto xt) {
      using R = typename decltype(xt)::type;
      const DropoutAddFwd<Y, R> op{static_cast<const Y*>(y), static_cast<const uint8_t*>(keep),
                                   static_cast<const R*>(x), static_cast<Sum<Y, R>*>(out), inv};
      return launch(op, n, vec, stream);
    });
  });
}

// dy from g (the gradient of out, of out's type g_code) and the mask.
extern "C" int dropout_add_backward(const void* g, const void* keep, void* dy, long long n,
                                    int g_code, int y_code, float inv, void* stream) {
  const bool vec = aligned(g) && aligned(keep) && aligned(dy);
  return by_dtype(g_code, [&](auto gt) {
    using G = typename decltype(gt)::type;
    return by_dtype(y_code, [&](auto yt) {
      using Y = typename decltype(yt)::type;
      const DropoutAddBwd<G, Y> op{static_cast<const G*>(g), static_cast<const uint8_t*>(keep),
                                  static_cast<Y*>(dy), inv};
      return launch(op, n, vec, stream);
    });
  });
}
