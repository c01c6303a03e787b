// The glue of the DeepSeek MoE layer (models/moe.py, DeepseekMoe) for Hopper
// (sm_90a), CUDA C++ with a plain C entry: the passes that move rows between
// the router and the output, each touching only the rows routed to the held
// experts.  Six entries, forward and backward of three operations:
//
//   permute:  xp[i] = X(xs[order[i] / k]) for buffer rows i < count (the cast
//             to the experts' type fused into the gather); backward gx[s] =
//             sum over the token's held choices j, in j order, of f32(g[pos[s,
//             j]]): one f32 add a choice, as `gx += where(held, g[pos], 0)`.
//   swiglu:   a = A(A(silu(h_gate)) * h_up) for rows < count, rounding where
//             F.silu and the product round; backward, from h and da, the
//             gate and up halves' gradients as autograd computes them
//             (du = A(da * A(silu(g))), dg = A(silu'(A(da * u), g))).
//   combine:  out[s] = sum over the held j, in j order, of f32(y[pos[s, j]]) *
//             gates[s, j], a multiply-add a choice (as addcmul_ compiles on
//             the card); backward dgates[s, j] = <y[pos[s, j]], dout[s]>
//             for a held choice and 0 otherwise (a warp's sum), and for rows
//             i < count dy[i] = Y(dout[order[i] / k] * gates[order[i]]).
//
// Replaces no TPU kernel: the JAX package's Switch layer dispatches with
// one-hot einsums and has no dropless layer.  The layer keeps a static buffer
// of r = T * min(k, held experts) rows so that a CUDA graph can capture it,
// and the held experts receive a share of those rows that only the device
// knows (offs[-1], the last of the grouped GEMMs' row ends).  Every pass here
// is bound by bytes (a copy, a cast or a sum of a few rows a token, a handful
// of operations a byte), so the design moves only the bytes the held rows
// need: a row pass loads the count from device memory at its start and walks
// buffer rows below it, and a token pass reads the rows of a token's held
// choices and nothing else.  No pass reads or writes a buffer row at or past
// the count, so those rows may hold anything.  Each row or token is one warp's
// (rows of 1,408 to 2,816 elements: 2.8 to 11 KB), every output row written
// by one warp: no atomics, and sums in a fixed order.  A row pass's lanes take
// 8 elements a step in 16-byte loads and stores (two for f32).  A token pass's
// lanes take 4 columns a step: one 16-byte store of f32 sums (8 sums a lane in
// two stores 32 bytes apart ran at a sixth of the card's store rate) and an
// 8-byte load of each held bf16 row, over a row unrolled 16 times so that a
// token's gathers are in flight together; lanes j < k read the token's choices
// and the warp shares them by shuffles.  The grid is persistent and set by the
// static shapes (at most 8 blocks of 8 warps an SM), so a graph replay
// launches the same grid whatever the count.  Every row's width is a
// multiple of 8 elements and every row tensor starts on 16 bytes (the entries
// refuse anything else, and ops/moe_glue.py raises before it gets here), so
// each load and store of a row is a full vector.
//
// Rounding follows the PyTorch kernels that the layer ran before: products
// and sums that those round apart are __fmul_rn / __fadd_rn here, so that
// the compiler cannot contract them, and the one they fuse __fmaf_rn; silu is x / (1 + expf(-x)) and its
// derivative (dy * s) * (1 + x * (1 - s)), s = 1 / (1 + expf(-x)), with the
// inner multiply-add contracted as nvcc contracts PyTorch's expression.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;            // elements a lane takes per step of a row pass
constexpr int kTokVec = 4;         // columns a lane takes per step of a token pass
constexpr int kMaxK = 8;           // choices a token makes (top-k)
constexpr int kBlocksPerSm = 8;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// W elements at p (aligned to their size): one 8-byte load or 16-byte loads
template <int W, class T>
__device__ __forceinline__ void load(const T* __restrict__ p, T (&v)[W]) {
  if constexpr (W * sizeof(T) == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    memcpy(v, &u, 8);
  } else {
    static_assert(W * sizeof(T) % 16 == 0, "a row is loaded in 8- or 16-byte vectors");
#pragma unroll
    for (int q = 0; q < int(W * sizeof(T) / 16); ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[q];
      memcpy(reinterpret_cast<char*>(v) + 16 * q, &u, 16);
    }
  }
}

template <int W, class T>
__device__ __forceinline__ void store(T* __restrict__ p, const T (&v)[W]) {
  static_assert(W * sizeof(T) % 16 == 0, "a row pass stores 16-byte vectors");
#pragma unroll
  for (int q = 0; q < int(W * sizeof(T) / 16); ++q) {
    uint4 u;
    memcpy(&u, reinterpret_cast<const char*>(v) + 16 * q, 16);
    reinterpret_cast<uint4*>(p)[q] = u;
  }
}

// kTokVec f32 sums of a token's row at p in one 16-byte store
__device__ __forceinline__ void store_sums(float* __restrict__ p, const float (&v)[kTokVec]) {
  static_assert(kTokVec == 4, "a token pass stores 4 sums a lane");
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ long long warp_id() {
  return static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
}
__device__ __forceinline__ long long warp_count() {
  return static_cast<long long>(gridDim.x) * kWarps;
}

// the held rows: the device-side count (int32 or int64), at most `rows`
__device__ __forceinline__ long long held_count(const void* count, int wide, long long rows) {
  const long long n = wide ? *static_cast<const long long*>(count)
                           : static_cast<long long>(*static_cast<const int*>(count));
  return n < rows ? n : rows;
}

// A token's held choices: a bit per choice j, with its buffer row and gate.
struct Choices {
  unsigned mask;
  int row[kMaxK];
  float gate[kMaxK];
};

// lane j < k reads choice j; the warp learns them all by shuffles
__device__ __forceinline__ Choices choices(const long long* pos, const uint8_t* held,
                                           const float* gates, long long s, int k) {
  const int lane = lane_id();
  bool h = false;
  int row = 0;
  float gate = 0.f;
  if (lane < k) {
    h = held[s * k + lane] != 0;
    if (h) {
      row = static_cast<int>(pos[s * k + lane]);
      if (gates) gate = gates[s * k + lane];
    }
  }
  Choices c;
  c.mask = __ballot_sync(0xffffffffu, h);
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    c.row[j] = __shfl_sync(0xffffffffu, row, j);
    c.gate[j] = __shfl_sync(0xffffffffu, gate, j);
  }
  return c;
}

// PyTorch's silu and its derivative, in f32
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}
__device__ __forceinline__ float silu_grad(float dy, float x) {
  const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
  return __fmul_rn(__fmul_rn(dy, s), __fmaf_rn(x, __fsub_rn(1.f, s), 1.f));
}

// ------------------------------------------------------------------ passes
// Each op's run<W>(item, c) does columns c..c+W-1 of one row or token.

template <class X, class O>
struct PermuteFwd {   // row i < count: xp[i] = O(xs[order[i] / k])
  const X* xs;
  const long long* order;
  O* xp;
  long long d;
  int k;
  template <int W> __device__ __forceinline__ void run(long long i, long long c) const {
    X v[W];
    O o[W];
    load<W>(xs + (order[i] / k) * d + c, v);
#pragma unroll
    for (int e = 0; e < W; ++e) o[e] = from_f<O>(to_f(v[e]));
    store<W>(xp + i * d + c, o);
  }
};

template <class A>
struct SwigluFwd {    // row i < count: a[i] = A(A(silu(gate)) * up)
  const A* h;
  A* a;
  long long f;
  template <int W> __device__ __forceinline__ void run(long long i, long long c) const {
    A g[W], u[W], o[W];
    load<W>(h + i * 2 * f + c, g);
    load<W>(h + i * 2 * f + f + c, u);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      o[e] = from_f<A>(__fmul_rn(to_f(from_f<A>(silu(to_f(g[e])))), to_f(u[e])));
    }
    store<W>(a + i * f + c, o);
  }
};

template <class A>
struct SwigluBwd {    // row i < count: dh[i] = [dgate | dup]
  const A* h;
  const A* da;
  A* dh;
  long long f;
  template <int W> __device__ __forceinline__ void run(long long i, long long c) const {
    A g[W], u[W], d[W], dg[W], du[W];
    load<W>(h + i * 2 * f + c, g);
    load<W>(h + i * 2 * f + f + c, u);
    load<W>(da + i * f + c, d);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float s = to_f(from_f<A>(silu(to_f(g[e]))));        // F.silu's output
      const float ds = to_f(from_f<A>(__fmul_rn(to_f(d[e]), to_f(u[e]))));
      du[e] = from_f<A>(__fmul_rn(to_f(d[e]), s));
      dg[e] = from_f<A>(silu_grad(ds, to_f(g[e])));
    }
    store<W>(dh + i * 2 * f + c, dg);
    store<W>(dh + i * 2 * f + f + c, du);
  }
};

template <class Y>
struct CombineDy {    // row i < count: dy[i] = Y(dout[order[i] / k] * gates[order[i]])
  const float* dout;
  const float* gates;
  const long long* order;
  Y* dy;
  long long d;
  int k;
  template <int W> __device__ __forceinline__ void run(long long i, long long c) const {
    const long long p = order[i];
    const float w = gates[p];
    float g[W];
    Y o[W];
    load<W>(dout + (p / k) * d + c, g);
#pragma unroll
    for (int e = 0; e < W; ++e) o[e] = from_f<Y>(__fmul_rn(g[e], w));
    store<W>(dy + i * d + c, o);
  }
};

// the row of `item` in groups of kVec, over the warp's lanes
template <class Op>
__device__ __forceinline__ void row_pass(const Op& op, long long item, long long width) {
#pragma unroll 4
  for (long long c = lane_id() * kVec; c < width; c += 32 * kVec) op.template run<kVec>(item, c);
}

template <class Op>
__global__ void __launch_bounds__(kThreads) rows_kernel(Op op, const void* count, int wide,
                                                        long long rows, long long width) {
  const long long n = held_count(count, wide, rows);
  for (long long i = warp_id(); i < n; i += warp_count()) row_pass(op, i, width);
}

// token s: out[s] = sum of the held choices' gated rows of y, in j order
template <class Y>
__device__ __forceinline__ void combine_cols(const Y* y, const Choices& ch, float* out,
                                             long long d, long long c) {
  float acc[kTokVec];
#pragma unroll
  for (int e = 0; e < kTokVec; ++e) acc[e] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (ch.mask >> j & 1u) {
      Y v[kTokVec];
      load<kTokVec>(y + static_cast<long long>(ch.row[j]) * d + c, v);
#pragma unroll
      for (int e = 0; e < kTokVec; ++e) acc[e] = __fmaf_rn(to_f(v[e]), ch.gate[j], acc[e]);
    }
  }
  store_sums(out + c, acc);
}

template <class Y>
__global__ void __launch_bounds__(kThreads) combine_fwd_kernel(
    const Y* y, const float* gates, const long long* pos, const uint8_t* held, float* out,
    long long tokens, long long d, int k) {
  const int lane = lane_id();
  for (long long s = warp_id(); s < tokens; s += warp_count()) {
    const Choices ch = choices(pos, held, gates, s, k);
    float* o = out + s * d;
#pragma unroll 16
    for (long long c = lane * kTokVec; c < d; c += 32 * kTokVec) combine_cols(y, ch, o, d, c);
  }
}

// token s: gx[s] = sum of f32(g) over the held choices' rows, in j order
template <class G>
__device__ __forceinline__ void gather_sum_cols(const G* g, const Choices& ch, float* gx,
                                                long long d, long long c) {
  float acc[kTokVec];
#pragma unroll
  for (int e = 0; e < kTokVec; ++e) acc[e] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (ch.mask >> j & 1u) {
      G v[kTokVec];
      load<kTokVec>(g + static_cast<long long>(ch.row[j]) * d + c, v);
#pragma unroll
      for (int e = 0; e < kTokVec; ++e) acc[e] = __fadd_rn(acc[e], to_f(v[e]));
    }
  }
  store_sums(gx + c, acc);
}

template <class G>
__global__ void __launch_bounds__(kThreads) permute_bwd_kernel(
    const G* g, const long long* pos, const uint8_t* held, float* gx, long long tokens,
    long long d, int k) {
  const int lane = lane_id();
  for (long long s = warp_id(); s < tokens; s += warp_count()) {
    const Choices ch = choices(pos, held, nullptr, s, k);
    float* o = gx + s * d;
#pragma unroll 16
    for (long long c = lane * kTokVec; c < d; c += 32 * kTokVec) gather_sum_cols(g, ch, o, d, c);
  }
}

// token s: each held choice's partial dot products of its row of y with dout[s]
template <class Y>
__device__ __forceinline__ void dot_cols(const Y* y, const float* dout, const Choices& ch,
                                         float (&dot)[kMaxK], long long d, long long c) {
  float g[kTokVec];
  load<kTokVec>(dout + c, g);
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (ch.mask >> j & 1u) {
      Y v[kTokVec];
      load<kTokVec>(y + static_cast<long long>(ch.row[j]) * d + c, v);
#pragma unroll
      for (int e = 0; e < kTokVec; ++e) dot[j] = __fmaf_rn(to_f(v[e]), g[e], dot[j]);
    }
  }
}

// warps [0, tokens): dgates of token s; warps [tokens, tokens + count): dy of
// buffer row i
template <class Y>
__global__ void __launch_bounds__(kThreads) combine_bwd_kernel(
    const Y* y, const float* gates, const float* dout, const long long* pos,
    const uint8_t* held, const long long* order, const void* count, int wide, float* dgates,
    Y* dy, long long tokens, long long rows, long long d, int k) {
  const int lane = lane_id();
  const long long items = tokens + held_count(count, wide, rows);
  const CombineDy<Y> row_op{dout, gates, order, dy, d, k};
  for (long long w = warp_id(); w < items; w += warp_count()) {
    if (w >= tokens) {
      row_pass(row_op, w - tokens, d);
      continue;
    }
    const Choices ch = choices(pos, held, nullptr, w, k);
    float dot[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) dot[j] = 0.f;
    if (ch.mask) {   // a token with no held choice reads nothing
      const float* g = dout + w * d;
#pragma unroll 16
      for (long long c = lane * kTokVec; c < d; c += 32 * kTokVec) dot_cols(y, g, ch, dot, d, c);
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (ch.mask >> j & 1u) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], off);
        }
      }
    }
    if (lane < k) {
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j == lane) dgates[w * k + j] = dot[j];
      }
    }
  }
}

// rows `width` elements wide starting at each of `p`: kVec-element vectors
// that start on 16 bytes
bool rows_fit(long long width, std::initializer_list<const void*> p) {
  if (width < 1 || width % kVec != 0) return false;
  for (const void* q : p) {
    if ((reinterpret_cast<uintptr_t>(q) & 15) != 0) return false;
  }
  return true;
}

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

// blocks for `items` warps of work, at most kBlocksPerSm an SM: fixed by the
// static shapes, whatever the device-side count
int grid_for(long long items) {
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  long long grid = (items + kWarps - 1) / kWarps;
  if (grid > cap) grid = cap;
  return static_cast<int>(grid < 1 ? 1 : grid);
}

// one launch of `kernel` over `items` warps of work on `stream`
template <class... P, class... A>
int launch(void (*kernel)(P...), long long items, void* stream, A... args) {
  kernel<<<grid_for(items), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <class T> struct Tag { using type = T; };

// f(Tag<f32>) or f(Tag<bf16>) by a type code (0 f32, 1 bf16)
template <class F> int by_dtype(int code, F&& f) {
  if (code == 0) return f(Tag<float>{});
  if (code == 1) return f(Tag<bf16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

bool valid_k(int k) { return k >= 1 && k <= kMaxK; }

}  // namespace

// Each entry: contiguous tensors on the device of the current stream; a type
// code is 0 for f32 and 1 for bf16; `count` points at the held rows (offs[-1],
// int64 when count_wide is set, else int32); `order` and `pos` are int64,
// `held` bool, `gates`, `dgates`, `out`, `gx` and `dout` f32.  `rows` is the
// buffer's static row count r, `tokens` the token count T, k at most 8.  Every
// row tensor starts on 16 bytes and its width (d, f) is a multiple of 8.
// Returns cudaErrorInvalidValue for anything else, and otherwise
// cudaGetLastError() after the launch.

// xp (rows, d) of out_code from xs (tokens, d) of x_code: rows < count.
extern "C" int moe_permute_forward(const void* xs, const void* order, const void* count,
                                   int count_wide, void* xp, long long rows, long long d, int k,
                                   int x_code, int out_code, void* stream) {
  if (!valid_k(k) || rows < 1 || !rows_fit(d, {xs, xp})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return by_dtype(x_code, [&](auto xt) {
    using X = typename decltype(xt)::type;
    return by_dtype(out_code, [&](auto ot) {
      using O = typename decltype(ot)::type;
      const PermuteFwd<X, O> op{static_cast<const X*>(xs), static_cast<const long long*>(order),
                                static_cast<O*>(xp), d, k};
      return launch(rows_kernel<PermuteFwd<X, O>>, rows, stream, op, count, count_wide, rows, d);
    });
  });
}

// gx (tokens, d) f32 from g (rows, d) of g_code: every token.
extern "C" int moe_permute_backward(const void* g, const void* pos, const void* held, void* gx,
                                    long long tokens, long long d, int k, int g_code,
                                    void* stream) {
  if (!valid_k(k) || tokens < 1 || !rows_fit(d, {g, gx})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return by_dtype(g_code, [&](auto gt) {
    using G = typename decltype(gt)::type;
    return launch(permute_bwd_kernel<G>, tokens, stream, static_cast<const G*>(g),
                  static_cast<const long long*>(pos), static_cast<const uint8_t*>(held),
                  static_cast<float*>(gx), tokens, d, k);
  });
}

// a (rows, f) from h (rows, 2f), both of code: rows < count.
extern "C" int moe_swiglu_forward(const void* h, const void* count, int count_wide, void* a,
                                  long long rows, long long f, int code, void* stream) {
  if (rows < 1 || !rows_fit(f, {h, a})) return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype(code, [&](auto at) {
    using A = typename decltype(at)::type;
    const SwigluFwd<A> op{static_cast<const A*>(h), static_cast<A*>(a), f};
    return launch(rows_kernel<SwigluFwd<A>>, rows, stream, op, count, count_wide, rows, f);
  });
}

// dh (rows, 2f) from h (rows, 2f) and da (rows, f), all of code: rows < count.
extern "C" int moe_swiglu_backward(const void* h, const void* da, const void* count,
                                   int count_wide, void* dh, long long rows, long long f,
                                   int code, void* stream) {
  if (rows < 1 || !rows_fit(f, {h, da, dh})) return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype(code, [&](auto at) {
    using A = typename decltype(at)::type;
    const SwigluBwd<A> op{static_cast<const A*>(h), static_cast<const A*>(da),
                          static_cast<A*>(dh), f};
    return launch(rows_kernel<SwigluBwd<A>>, rows, stream, op, count, count_wide, rows, f);
  });
}

// out (tokens, d) f32 from y (rows, d) of y_code and gates (tokens, k): every token.
extern "C" int moe_combine_forward(const void* y, const void* gates, const void* pos,
                                   const void* held, void* out, long long tokens, long long d,
                                   int k, int y_code, void* stream) {
  if (!valid_k(k) || tokens < 1 || !rows_fit(d, {y, out})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return by_dtype(y_code, [&](auto yt) {
    using Y = typename decltype(yt)::type;
    return launch(combine_fwd_kernel<Y>, tokens, stream, static_cast<const Y*>(y),
                  static_cast<const float*>(gates), static_cast<const long long*>(pos),
                  static_cast<const uint8_t*>(held), static_cast<float*>(out), tokens, d, k);
  });
}

// dgates (tokens, k) f32 for every token and dy (rows, d) of y_code for rows
// < count, from y, gates, dout (tokens, d) f32 and order (tokens * k).
extern "C" int moe_combine_backward(const void* y, const void* gates, const void* dout,
                                    const void* pos, const void* held, const void* order,
                                    const void* count, int count_wide, void* dgates, void* dy,
                                    long long tokens, long long rows, long long d, int k,
                                    int y_code, void* stream) {
  if (!valid_k(k) || tokens < 1 || rows < 1 || !rows_fit(d, {y, dout, dy})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return by_dtype(y_code, [&](auto yt) {
    using Y = typename decltype(yt)::type;
    return launch(combine_bwd_kernel<Y>, tokens + rows, stream, static_cast<const Y*>(y),
                  static_cast<const float*>(gates), static_cast<const float*>(dout),
                  static_cast<const long long*>(pos), static_cast<const uint8_t*>(held),
                  static_cast<const long long*>(order), count, count_wide,
                  static_cast<float*>(dgates), static_cast<Y*>(dy), tokens, rows, d, k);
  });
}
