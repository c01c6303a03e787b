// The FusedAdamW tail for Hopper (sm_90a), CUDA C++ with a plain C entry:
// the global gradient norm with the clip and non-finite scalars (launch 1),
// then the AdamW update of every parameter leaf (launch 2).
//
// Replaces the TPU kernel ops/adamw_pallas.py::_kernel of the JAX package
// (Pallas, launched per leaf by adamw_update_leaf's pl.pallas_call) and the
// XLA reduction around it in train/optim.py::FusedAdamW.apply.  Element by
// element, the update is
//   g'  = finite ? g * scale : 0        (select, so a NaN g cannot leak)
//   mu' = b1 * mu + (1 - b1) * g'
//   nu' = b2 * nu + (1 - b2) * g'^2
//   p'  = p - lr * ((mu' / bc1) / (sqrt(nu' / bc2) + eps) + wd * p)
// with [scale, lr, bc1, bc2, finite] read from a device array, so a step
// needs no host sync.  nu and p are f32; mu is f32 or bf16 (computed in
// f32, stored rounded to nearest even).  Each operation is done in the plain
// version's order with IEEE rounding and no FMA contraction (__fmul_rn and
// friends), so the update agrees with the plain PyTorch version bit for bit.
//
// g is the step's mean gradient, g = (g_1 + ... + g_n) / accum (no division
// at accum 1), made as each kernel reads it: a leaf's gradient is one f32
// tensor (autograd's sum over the microbatches, n = 1) or the bf16 gradients
// of the leaf's compute copy, one per microbatch (n = accum), each widened
// exactly and added in microbatch order, as autograd's accumulation added
// them in f32 -- so neither the gradients' casts to f32, nor their sum, nor
// the division by accum is a pass of its own.  A leaf with a compute copy
// (the bf16 tensor its layer's forward reads in place of casting the
// parameter; train/loop.py's ComputeCopies) gets the copy written from the
// updated p in the update's pass, rounded to nearest even as the cast would
// round it, on every step (a non-finite, zeroed step too).
//
// Launch 1 (adamw_norm_kernel) reads every gradient once: each block sums
// the squares of kNormRows chunks in f64 (exact products of f32 values) and
// writes one partial; the last block to finish (a ticket counter, no float atomics)
// sums the partials in a fixed order, takes the f32 norm and writes
// grad_norm, scalars[0] = scale (min(1, clip / max(norm, 1e-16)), or 1
// without a clip; 1 on a non-finite norm under zero_nonfinite), scalars[4] =
// finite, and count_out = count_in + !isfinite(norm).  The partials' order
// does not depend on which block finishes last, so two runs give the same
// bits.  lr, bc1 and bc2 arrive in scalars[1..3], and the address of every
// leaf's gradient in gptrs, by one pinned H2D copy on the stream before it;
// or lr, bc1 and bc2 sit in device memory (a training step's tape) and the
// finishing thread copies them into scalars[1..3], so a CUDA graph replaying
// the launches takes each step's values and holds no host copy of them.
// With a norm given by the caller, launch 1 is one thread that only writes
// the scalars (adamw_scalars_kernel).
//
// Across the ranks of a mesh (ops/adamw.py's NormReduce) launch 1 takes a
// weight per leaf, 1 / the leaf's number of copies on the mesh (exact for
// meshes of powers of two), adds each table row's squares times its leaf's
// weight, and its last block writes the f64 sum instead of the scalars; the
// caller all-reduces that sum over the ranks, and launch 2 reads it: every
// block takes the norm and the clip and non-finite scalars from it at its
// start (the same code as launch 1's last block, so every rank and block
// agrees), and block 0 writes grad_norm, scalars 0 and 4 and the counter.
// Two launches and one collective a step, no host sync; on one rank the
// launches are the ones above, unchanged.
//
// Bound on the H100 (SXM, 3.35 TB/s), ViT-base's 85.7 M parameters: the
// update reads g, mu, nu, p and writes mu, nu, p, 28 bytes per parameter
// with an f32 g and f32 mu (24 with bf16 mu; a leaf on the copy route reads
// 2 bytes of g a microbatch and writes 2 of its copy), 2.40 GB, 0.716 ms,
// against about 15 operations per parameter (0.02 ms on the f32 CUDA
// cores); the norm reads g once, 343 MB, 0.102 ms.  Both are bound by
// bytes, so the design moves each byte once in the widest transaction and
// keeps enough of them in flight:
// - 16-byte loads and stores (float4 for an f32 g, nu, p; four bf16 as 8
//   bytes for mu, a bf16 g and the copy), every pointer __restrict__, and
//   each thread issues all its loads (kUnroll groups of four elements)
//   before any arithmetic or store;
// - streaming cache hints (__ldcs / __stcs, evict-first): 2.4 GB passes
//   once through a 50 MB L2 and nothing is read twice;
// - bytes in flight: a block has 256 threads x kUnroll x 4 loads of 16 bytes
//   (64 KB with f32 mu) outstanding, against the ~18 KB per SM that 3.35 TB/s
//   at ~0.7 us of latency needs (Little's law), with several blocks per SM;
// - no leaf search in the kernel: the host builds, with the leaf pointers, a
//   block table of one 56-byte row per block -- the p, mu, nu and copy
//   addresses at the block's first element, that element's index in its
//   leaf, the leaf, the block's element count (<= kChunk), whether p and nu
//   are 16-byte and mu and the copy 4-element aligned, and the leaf's number
//   of bf16 gradient parts -- kept for as long as the parameters, moments and
//   copies stay where they are.  A block reads its row, issues its p, mu and
//   nu loads, and reads its gradients' addresses from gptrs (accum entries a
//   leaf, a few KB that stay in cache; gradients move every step, so they are
//   not in the table).  Vector loads with this much in flight are the Hopper
//   design for a pure stream; TMA bulk copies were not used: they would stage
//   through shared memory what a register can hold, for no fewer bytes.
// A leaf of any size takes the same path: a chunk's last count % 4 elements
// (the 71-wide head bias) go one per thread; a leaf whose p, mu, nu or copy
// is not aligned runs its chunks one element per thread.  A gradient that is
// not aligned is read one element at a time: in the update inside the
// vector path; in the norm an f32 one over the whole chunk, one element per
// thread, bf16 parts in the groups of aligned ones (same bits).  Gradients of
// more than two parts (accum > 2) are read at the arithmetic, one element at
// a time.  Each update block runs the code of its gradient's kind alone (a
// template argument); a norm block whose rows all hold f32 gradients runs
// the f32 code alone, and one of mixed rows branches on each row's kind.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                      // groups of 4 elements per thread
constexpr int kChunk = kThreads * 4 * kUnroll;  // elements per block
constexpr int kWarps = kThreads / 32;
constexpr int kNormRows = 4;                    // block-table rows per norm block
constexpr int kSumBatch = 8;                    // partials in flight per thread, last block

// one row of the block table (seven int64 in memory, 56 bytes)
struct Block {
  long long p, mu, nu, copy;  // addresses of the block's first element (copy 0: none)
  long long start;            // that element's index in its leaf
  int leaf, count;            // the leaf (its gradients: gptrs[leaf * accum ...]);
                              // elements, 0..kChunk
  int vec, parts;             // vec 1: p, nu 16-byte aligned, mu and copy 4-element
                              // aligned; parts 0: one f32 gradient, n: n bf16 ones
};

struct Consts {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

struct Step {
  float scale, lr, bc1, bc2;
  bool finite;
};

struct Tail {
  float clip;
  int has_clip, zero_nonfinite;
  float* scalars;        // [scale, lr, bc1, bc2, finite]; 0 and 4 written here
  const float* lr_bc;    // null, or [lr, bc1, bc2] copied into scalars[1..3] here
  float* norm_out;       // may be null
  const int* count_in;   // both null, or both set
  int* count_out;
};

__device__ __forceinline__ Step load_step(const float* __restrict__ s) {
  return Step{s[0], s[1], s[2], s[3], s[4] > 0.f};
}

// the clip scale and the finite flag from the f32 norm
__device__ __forceinline__ void clip_scalars(float norm, const Tail& t, float& scale,
                                             float& flag) {
  const bool finite = isfinite(norm);
  scale = 1.f;
  if (t.has_clip) {   // NaN passes through both selects, as in clamp / jnp.minimum
    const float r = __fdiv_rn(t.clip, norm < 1e-16f ? 1e-16f : norm);
    scale = r > 1.f ? 1.f : r;
  }
  flag = 1.f;
  if (t.zero_nonfinite) {
    if (!finite) scale = 1.f;
    flag = finite ? 1.f : 0.f;
  }
}

// the plain version's operations, in its order
__device__ __forceinline__ void adam(float g, float mu, float nu, float p, const Step& s,
                                     const Consts& c, float& mo, float& vo, float& po) {
  const float gi = s.finite ? __fmul_rn(g, s.scale) : 0.f;
  mo = __fadd_rn(__fmul_rn(c.b1, mu), __fmul_rn(c.one_minus_b1, gi));
  vo = __fadd_rn(__fmul_rn(c.b2, nu), __fmul_rn(c.one_minus_b2, __fmul_rn(gi, gi)));
  float upd = __fdiv_rn(__fdiv_rn(mo, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vo, s.bc2)), c.eps));
  if (c.wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(c.wd, p));
  po = __fsub_rn(p, __fmul_rn(s.lr, upd));
}

__device__ __forceinline__ float bf16_bits_to_f32(unsigned int bits16) {
  return __uint_as_float(bits16 << 16);
}
__device__ __forceinline__ unsigned int f32_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));   // round to nearest even
}

// four mu values as one 16-byte (f32) or 8-byte (bf16) transaction
template <typename MuT> struct Mu4;
template <> struct Mu4<float> {
  using V = float4;
  static __device__ __forceinline__ V load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void get(const V& v, float (&out)[4]) {
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&in)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(in[0], in[1], in[2], in[3]));
  }
};
template <> struct Mu4<__nv_bfloat16> {
  using V = uint2;
  static __device__ __forceinline__ V load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void get(const V& v, float (&out)[4]) {
    out[0] = bf16_bits_to_f32(v.x & 0xffffu); out[1] = bf16_bits_to_f32(v.x >> 16);
    out[2] = bf16_bits_to_f32(v.y & 0xffffu); out[3] = bf16_bits_to_f32(v.y >> 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&in)[4]) {
    const uint2 v = make_uint2(f32_to_bf16_bits(in[0]) | (f32_to_bf16_bits(in[1]) << 16),
                               f32_to_bf16_bits(in[2]) | (f32_to_bf16_bits(in[3]) << 16));
    __stcs(reinterpret_cast<uint2*>(p), v);
  }
};

__device__ __forceinline__ float mu_f32(float x) { return x; }
__device__ __forceinline__ float mu_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename MuT> __device__ __forceinline__ MuT mu_from(float x);
template <> __device__ __forceinline__ float mu_from<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 mu_from<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename MuT>
__device__ __forceinline__ void update_one(float* __restrict__ p, float gi,
                                           MuT* __restrict__ mu, float* __restrict__ nu,
                                           __nv_bfloat16* __restrict__ copy, int e,
                                           const Step& s, const Consts& c) {
  float m, v, q;
  adam(gi, mu_f32(mu[e]), __ldcs(nu + e), __ldcs(p + e), s, c, m, v, q);
  mu[e] = mu_from<MuT>(m);
  __stcs(nu + e, v);
  __stcs(p + e, q);
  if (copy) copy[e] = __float2bfloat16(q);
}

// ---- the gradient: g = (g_1 + ... + g_parts) / accum, element by element
// (a leaf of one f32 gradient: g_1 alone).  The division is made from a
// thread's Mean: inv = 1 / accum where accum is a power of two (the product
// with it is the correctly rounded quotient), else 0 (a true division)
struct Mean {
  int accum;
  float inv;
};

__device__ __forceinline__ Mean make_mean(int accum) {
  return Mean{accum, (accum & (accum - 1)) == 0 ? __frcp_rn(static_cast<float>(accum)) : 0.f};
}

__device__ __forceinline__ float over_accum(float s, const Mean& m) {
  if (m.accum == 1) return s;
  if (m.inv != 0.f) return __fmul_rn(s, m.inv);
  return __fdiv_rn(s, static_cast<float>(m.accum));
}

__device__ __forceinline__ float bf16_at(long long addr, long long i) {
  return bf16_bits_to_f32(__ldcs(reinterpret_cast<const unsigned short*>(addr) + i));
}

// four bf16 values: one 8-byte load, or where unaligned one at a time
__device__ __forceinline__ uint2 load_bf16x4(long long addr, bool vec, int q) {
  const unsigned short* x = reinterpret_cast<const unsigned short*>(addr);
  if (vec) return __ldcs(reinterpret_cast<const uint2*>(x) + q);
  const unsigned int e0 = __ldcs(x + 4 * q), e1 = __ldcs(x + 4 * q + 1),
                     e2 = __ldcs(x + 4 * q + 2), e3 = __ldcs(x + 4 * q + 3);
  return make_uint2(e0 | (e1 << 16), e2 | (e3 << 16));
}

__device__ __forceinline__ void widen4(unsigned int lo, unsigned int hi, float (&out)[4]) {
  out[0] = bf16_bits_to_f32(lo & 0xffffu); out[1] = bf16_bits_to_f32(lo >> 16);
  out[2] = bf16_bits_to_f32(hi & 0xffffu); out[3] = bf16_bits_to_f32(hi >> 16);
}

// A leaf's gradient at a block's first element, as two words a0, a1: for
// one f32 gradient or one or two bf16 parts, the first two parts'
// addresses (a1 = a0 for one part); for more parts, the leaf's row of
// gptrs and the block's first element in the leaf.  vec: an f32 gradient
// 16-byte aligned, bf16 parts 8-byte aligned
struct GradAt {
  long long a0, a1;
  bool vec;
};

__device__ __forceinline__ GradAt grad_at(const long long* __restrict__ gptrs, int leaf,
                                          int accum, int parts, long long start) {
  const long long* row = gptrs + static_cast<long long>(leaf) * accum;
  if (parts > 2) return GradAt{reinterpret_cast<long long>(row), start, true};
  const long long bytes = parts == 0 ? 4 : 2;
  const long long a0 = row[0] + start * bytes, a1 = parts == 2 ? row[1] + start * bytes : a0;
  return GradAt{a0, a1, (parts == 0 ? a0 & 15 : (a0 | a1) & 7) == 0};
}

// A gradient's kind: 0 one f32 tensor; 1 or 2 bf16 parts; -1 more parts.
// load_group(at, kind, q) loads the bits of group q (elements 4q..4q+3 of
// the block): an f32 gradient's four floats as one 16-byte load where it is
// aligned, else one at a time; one or two bf16 parts' four values each (x, y;
// z, w) as one 8-byte load each where aligned, else one at a time; more
// parts nothing (they are read at group_mean).  group_mean makes the group's
// mean gradient from those bits, elem_mean element e's, loading it.  A kernel
// that passes a kind known at compile time runs that kind's code alone
__device__ __forceinline__ uint4 load_group(const GradAt& at, int kind, int q) {
  if (kind == 0) {
    const float* x = reinterpret_cast<const float*>(at.a0);
    const float4 v = at.vec ? __ldcs(reinterpret_cast<const float4*>(x) + q)
                            : make_float4(__ldcs(x + 4 * q), __ldcs(x + 4 * q + 1),
                                          __ldcs(x + 4 * q + 2), __ldcs(x + 4 * q + 3));
    return make_uint4(__float_as_uint(v.x), __float_as_uint(v.y), __float_as_uint(v.z),
                      __float_as_uint(v.w));
  }
  if (kind == 1 || kind == 2) {
    const uint2 v0 = load_bf16x4(at.a0, at.vec, q);
    const uint2 v1 = kind == 2 ? load_bf16x4(at.a1, at.vec, q) : make_uint2(0u, 0u);
    return make_uint4(v0.x, v0.y, v1.x, v1.y);
  }
  return make_uint4(0u, 0u, 0u, 0u);
}

// element e's parts summed in microbatch order (more parts: parts of them)
__device__ __forceinline__ float elem_sum(const GradAt& at, int kind, int parts, int e) {
  if (kind == 0) return __ldcs(reinterpret_cast<const float*>(at.a0) + e);
  if (kind == 1 || kind == 2) {
    const float s = bf16_at(at.a0, e);
    return kind == 2 ? __fadd_rn(s, bf16_at(at.a1, e)) : s;
  }
  const long long* row = reinterpret_cast<const long long*>(at.a0);
  float s = bf16_at(row[0], at.a1 + e);
  for (int k = 1; k < parts; ++k) s = __fadd_rn(s, bf16_at(row[k], at.a1 + e));
  return s;
}

__device__ __forceinline__ float elem_mean(const GradAt& at, int kind, int parts, const Mean& m,
                                           int e) {
  return over_accum(elem_sum(at, kind, parts, e), m);
}

__device__ __forceinline__ void group_mean(uint4 r, const GradAt& at, int kind, int parts,
                                           const Mean& m, int q, float (&out)[4]) {
  if (kind == 0) {
    out[0] = __uint_as_float(r.x); out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z); out[3] = __uint_as_float(r.w);
  } else if (kind == 1 || kind == 2) {
    widen4(r.x, r.y, out);
    if (kind == 2) {
      float second[4];
      widen4(r.z, r.w, second);
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = __fadd_rn(out[j], second[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = elem_sum(at, kind, parts, 4 * q + j);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = over_accum(out[j], m);
}

// kKind: the block's gradient kind (load_group), a compile-time constant
template <typename MuT, int kKind>
__device__ __forceinline__ void update_block(const Block& b, const long long* __restrict__ gptrs,
                                             int accum, const Step& s, const Consts& c) {
  float* __restrict__ p = reinterpret_cast<float*>(b.p);
  MuT* __restrict__ mu = reinterpret_cast<MuT*>(b.mu);
  float* __restrict__ nu = reinterpret_cast<float*>(b.nu);
  __nv_bfloat16* __restrict__ copy = reinterpret_cast<__nv_bfloat16*>(b.copy);
  const int count = b.count;
  const int parts = b.parts;
  const GradAt g = grad_at(gptrs, b.leaf, accum, kKind < 0 ? parts : kKind, b.start);
  const Mean m = make_mean(accum);
  if (!b.vec) {   // a leaf with an unaligned p, mu, nu or copy: one element per thread
    for (int e = threadIdx.x; e < count; e += kThreads) {
      update_one(p, elem_mean(g, kKind, parts, m, e), mu, nu, copy, e, s, c);
    }
    return;
  }
  const int n4 = count >> 2;   // whole groups of 4 in this block
  float4 pv[kUnroll], vv[kUnroll];
  uint4 gv[kUnroll];
  typename Mu4<MuT>::V mv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {   // every load first: p, mu, nu from the row,
    const int q = u * kThreads + threadIdx.x;
    if (q < n4) {
      mv[u] = Mu4<MuT>::load(mu + 4 * q);
      vv[u] = __ldcs(reinterpret_cast<const float4*>(nu) + q);
      pv[u] = __ldcs(reinterpret_cast<const float4*>(p) + q);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {   // then g, once its addresses are in
    const int q = u * kThreads + threadIdx.x;
    if (q < n4) gv[u] = load_group(g, kKind, q);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int q = u * kThreads + threadIdx.x;
    if (q < n4) {
      float gi[4];
      group_mean(gv[u], g, kKind, parts, m, q, gi);
      const float vi[4] = {vv[u].x, vv[u].y, vv[u].z, vv[u].w};
      const float pi[4] = {pv[u].x, pv[u].y, pv[u].z, pv[u].w};
      float mi[4], mo[4], vo[4], po[4];
      Mu4<MuT>::get(mv[u], mi);
#pragma unroll
      for (int j = 0; j < 4; ++j) adam(gi[j], mi[j], vi[j], pi[j], s, c, mo[j], vo[j], po[j]);
      Mu4<MuT>::store(mu + 4 * q, mo);
      __stcs(reinterpret_cast<float4*>(nu) + q, make_float4(vo[0], vo[1], vo[2], vo[3]));
      __stcs(reinterpret_cast<float4*>(p) + q, make_float4(po[0], po[1], po[2], po[3]));
      if (copy) Mu4<__nv_bfloat16>::store(copy + 4 * q, po);
    }
  }
  const int e = 4 * n4 + threadIdx.x;   // the last count % 4 elements
  if (e < count) update_one(p, elem_mean(g, kKind, parts, m, e), mu, nu, copy, e, s, c);
}

// sum: null to read the scale and finite flag from scalars[0] and [4];
// else the mesh-wide f64 sum of squares, from which every block takes them
// (and block 0 writes t's norm and counter; scalars are then only read).
// Each block runs its gradient kind's update_block
template <typename MuT>
__global__ void __launch_bounds__(kThreads, 2)
adamw_update_kernel(const Block* __restrict__ blocks, const long long* __restrict__ gptrs,
                    int accum, const float* __restrict__ scalars, Consts c,
                    const double* __restrict__ sum, Tail t) {
  const Block b = blocks[blockIdx.x];
  Step s;
  if (sum) {
    const float norm = static_cast<float>(sqrt(*sum));
    float scale, flag;
    clip_scalars(norm, t, scale, flag);
    s = Step{scale, scalars[1], scalars[2], scalars[3], flag > 0.f};
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      if (t.norm_out) *t.norm_out = norm;
      if (t.count_out) *t.count_out = *t.count_in + (isfinite(norm) ? 0 : 1);
    }
  } else {
    s = load_step(scalars);
  }
  switch (b.parts) {
    case 0: update_block<MuT, 0>(b, gptrs, accum, s, c); break;
    case 1: update_block<MuT, 1>(b, gptrs, accum, s, c); break;
    case 2: update_block<MuT, 2>(b, gptrs, accum, s, c); break;
    default: update_block<MuT, -1>(b, gptrs, accum, s, c);
  }
}

// sum over the block in a fixed order: a butterfly within each warp (every
// lane ends with the same sum), then warp 0 does the same over the warps'
// sums.  Returns the total in thread 0.
__device__ __forceinline__ double block_sum(double x, double* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = __dadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = __dadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ double sq(float x) {
  const double d = x;
  return __dmul_rn(d, d);   // exact: 24-bit significands
}

// clip scale, finite flag, norm and counter from the f32 norm; one thread
__device__ __forceinline__ void finish(float norm, const Tail& t) {
  float scale, flag;
  clip_scalars(norm, t, scale, flag);
  t.scalars[0] = scale;
  t.scalars[4] = flag;
  if (t.lr_bc) {
    t.scalars[1] = t.lr_bc[0];
    t.scalars[2] = t.lr_bc[1];
    t.scalars[3] = t.lr_bc[2];
  }
  if (t.norm_out) *t.norm_out = norm;
  if (t.count_out) *t.count_out = *t.count_in + (isfinite(norm) ? 0 : 1);
}

// acc plus the squares of a row's elements past its groups, in order: its
// last count % 4 elements, one per thread, or all of a row whose f32
// gradient is not 16-byte aligned (it has no groups), one element per thread
__device__ __forceinline__ double tail_sq(double acc, const GradAt& at, int kind, int parts,
                                          int count, const Mean& m) {
  if (kind == 0 && !at.vec) {
    for (int e = threadIdx.x; e < count; e += kThreads) {
      acc = __dadd_rn(acc, sq(elem_mean(at, kind, parts, m, e)));
    }
    return acc;
  }
  const int e = 4 * (count >> 2) + threadIdx.x;
  return e < count ? __dadd_rn(acc, sq(elem_mean(at, kind, parts, m, e))) : acc;
}

// The squares of kNormRows block-table rows' mean gradients, summed in f64
// in a fixed order: every row's group loads first, so that no row's loads
// wait on another's; then the groups' squares in row order; then each row's
// last count % 4 elements, or all of a row whose f32 g is not 16-byte
// aligned, one element per thread (kWeighted: a row's groups and its last
// elements, times its leaf's weight, row after row).  kF32: every row holds
// one f32 gradient, so the kind is known at compile time
template <bool kWeighted, bool kF32>
__device__ __forceinline__ double norm_rows(const GradAt (&at)[kNormRows],
                                            const int (&count)[kNormRows],
                                            const int (&parts)[kNormRows],
                                            const double (&w)[kNormRows], const Mean& m) {
  uint4 gv[kNormRows][kUnroll];
  int kind[kNormRows], n4[kNormRows];
#pragma unroll
  for (int r = 0; r < kNormRows; ++r) {
    kind[r] = kF32 ? 0 : parts[r] <= 2 ? parts[r] : -1;
    n4[r] = kind[r] == 0 && !at[r].vec ? 0 : count[r] >> 2;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = u * kThreads + threadIdx.x;
      gv[r][u] = q < n4[r] ? load_group(at[r], kind[r], q) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  double acc = 0.0;
#pragma unroll
  for (int r = 0; r < kNormRows; ++r) {
    double row_acc = 0.0;
    double& into = kWeighted ? row_acc : acc;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = u * kThreads + threadIdx.x;
      if (q < n4[r]) {
        float gi[4];
        group_mean(gv[r][u], at[r], kind[r], parts[r], m, q, gi);
#pragma unroll
        for (int j = 0; j < 4; ++j) into = __dadd_rn(into, sq(gi[j]));
      }
    }
    if (kWeighted) {
      row_acc = tail_sq(row_acc, at[r], kind[r], parts[r], count[r], m);
      acc = __dadd_rn(acc, __dmul_rn(w[r], row_acc));
    }
  }
  if (!kWeighted) {
#pragma unroll
    for (int r = 0; r < kNormRows; ++r) acc = tail_sq(acc, at[r], kind[r], parts[r], count[r], m);
  }
  return acc;
}

// kWeighted: each row's squares times leaf_weight[its leaf], and the last
// block writes the total to sum_out instead of finishing
template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
adamw_norm_kernel(const Block* __restrict__ blocks, const long long* __restrict__ gptrs,
                  int accum, int n_rows, double* __restrict__ partials,
                  unsigned int* __restrict__ ticket, Tail t,
                  const double* __restrict__ leaf_weight, double* __restrict__ sum_out) {
  __shared__ double warp_sums[kWarps];
  __shared__ bool last;
  // kNormRows rows of the block table: the rows' entries, then their
  // gradients' addresses, then their squares (norm_rows; the f32 code alone
  // where every row holds one f32 gradient)
  GradAt at[kNormRows];
  long long start[kNormRows];
  double w[kNormRows];
  int count[kNormRows], parts[kNormRows], leaf[kNormRows];
  bool f32 = true;
#pragma unroll
  for (int r = 0; r < kNormRows; ++r) {
    const int row = blockIdx.x * kNormRows + r;
    const bool in = row < n_rows;
    const Block* b = blocks + (in ? row : 0);
    leaf[r] = b->leaf;
    count[r] = in ? b->count : 0;
    parts[r] = in ? b->parts : 0;
    start[r] = b->start;
    f32 = f32 && parts[r] == 0;
  }
#pragma unroll
  for (int r = 0; r < kNormRows; ++r) {
    at[r] = grad_at(gptrs, leaf[r], accum, parts[r], start[r]);
    w[r] = kWeighted ? leaf_weight[leaf[r]] : 0.0;
  }
  const Mean m = make_mean(accum);
  double acc = f32 ? norm_rows<kWeighted, true>(at, count, parts, w, m)
                   : norm_rows<kWeighted, false>(at, count, parts, w, m);
  acc = block_sum(acc, warp_sums);
  const int n_parts = gridDim.x;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    __threadfence();   // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(n_parts - 1);
  }
  __syncthreads();
  if (!last) return;
  // the last block: thread i adds partials i, i + 256, ... in order, the
  // same whichever block it is, kSumBatch loads in flight at a time
  double total = 0.0;
  for (int i0 = threadIdx.x; i0 < n_parts; i0 += kThreads * kSumBatch) {
    double v[kSumBatch];
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) {
      const int i = i0 + k * kThreads;
      v[k] = i < n_parts ? __ldcg(partials + i) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) total = __dadd_rn(total, v[k]);
  }
  __syncthreads();   // warp_sums is reused
  total = block_sum(total, warp_sums);
  if (threadIdx.x == 0) {
    if (kWeighted) {
      *sum_out = total;
    } else {
      finish(static_cast<float>(sqrt(total)), t);
    }
    *ticket = 0;   // ready for the next launch
  }
}

__global__ void adamw_scalars_kernel(const float* __restrict__ norm, Tail t) { finish(*norm, t); }

}  // namespace

// Elements per block: a leaf of n elements takes max(1, ceil(n / this)) rows
// of the block table.
extern "C" int adamw_chunk_elems() { return kChunk; }

// Block-table rows per block of launch 1: it has ceil(n_rows / this) blocks,
// and as many partials.
extern "C" int adamw_norm_rows() { return kNormRows; }

// Launch 1.  blocks: (n_rows, 7) int64 on the device, the rows of Block;
// gptrs: accum int64 a leaf on the device, the addresses of its gradients
// (a leaf of one f32 gradient: the first, the rest unread); accum >= 1: the
// number of microbatches, the divisor of every leaf's gradient sum;
// partials: ceil(n_rows / kNormRows) f64 of scratch; ticket: one u32, 0
// between launches.
// given_norm: null to take the norm of every block's g, else one f32 on the
// device (then blocks, gptrs, partials and ticket are not read).  scalars: 5
// f32 on the device, of which 0 and 4 are written.  lr_bc: null, or 3 f32 on
// the device that are copied into scalars[1..3].  norm_out (f32), count_in
// and count_out (int32) may be null.  leaf_weight: null, or one f64 per leaf
// on the device; then the weighted sum of squares goes to sum_out (one f64
// on the device) and nothing else is written.  Returns cudaGetLastError().
extern "C" int adamw_norm(const void* blocks, const void* gptrs, int accum, int n_rows,
                          void* partials,
                          void* ticket, const void* given_norm, float clip, int has_clip,
                          int zero_nonfinite, void* scalars, const void* lr_bc,
                          void* norm_out, const void* count_in, void* count_out,
                          const void* leaf_weight, void* sum_out, void* stream) {
  const Tail t{clip, has_clip, zero_nonfinite, static_cast<float*>(scalars),
               static_cast<const float*>(lr_bc), static_cast<float*>(norm_out),
               static_cast<const int*>(count_in), static_cast<int*>(count_out)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (given_norm) {
    adamw_scalars_kernel<<<1, 1, 0, s>>>(static_cast<const float*>(given_norm), t);
  } else {
    if (n_rows < 1 || accum < 1 || (leaf_weight != nullptr) != (sum_out != nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto* bl = static_cast<const Block*>(blocks);
    const auto* gp = static_cast<const long long*>(gptrs);
    auto* parts = static_cast<double*>(partials);
    auto* tk = static_cast<unsigned int*>(ticket);
    const int grid = (n_rows + kNormRows - 1) / kNormRows;
    if (leaf_weight) {
      adamw_norm_kernel<true><<<grid, kThreads, 0, s>>>(
          bl, gp, accum, n_rows, parts, tk, t, static_cast<const double*>(leaf_weight),
          static_cast<double*>(sum_out));
    } else {
      adamw_norm_kernel<false><<<grid, kThreads, 0, s>>>(bl, gp, accum, n_rows, parts, tk, t,
                                                         nullptr, nullptr);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch 2.  blocks, gptrs and accum as above; scalars: 5 f32 on the device
// [scale, lr, bc1, bc2, finite].  mu_bf16 says whether every mu is bf16 (1)
// or f32 (0).  one_minus_b1/b2 are 1 - b1 and 1 - b2 as the caller rounds
// them.  sum: null, or the mesh-wide f64 sum of squares (launch 1 with leaf
// weights, then the caller's all-reduce): the scale and finite flag come from
// it with clip, has_clip and zero_nonfinite, and block 0 writes norm_out and
// count_out (each may be null; count_in with count_out).  Returns
// cudaGetLastError().
extern "C" int adamw_update(const void* blocks, const void* gptrs, int accum, int n_blocks,
                            const void* scalars, int mu_bf16, float b1, float one_minus_b1,
                            float b2, float one_minus_b2, float eps, float wd, const void* sum,
                            float clip, int has_clip, int zero_nonfinite, void* norm_out,
                            const void* count_in, void* count_out, void* stream) {
  if (n_blocks < 1 || accum < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Consts c{b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  const Tail t{clip, has_clip, zero_nonfinite, nullptr, nullptr, static_cast<float*>(norm_out),
               static_cast<const int*>(count_in), static_cast<int*>(count_out)};
  const auto* su = static_cast<const double*>(sum);
  const auto* bl = static_cast<const Block*>(blocks);
  const auto* gp = static_cast<const long long*>(gptrs);
  const auto* sc = static_cast<const float*>(scalars);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mu_bf16) {
    adamw_update_kernel<__nv_bfloat16><<<n_blocks, kThreads, 0, s>>>(bl, gp, accum, sc, c, su,
                                                                     t);
  } else {
    adamw_update_kernel<float><<<n_blocks, kThreads, 0, s>>>(bl, gp, accum, sc, c, su, t);
  }
  return static_cast<int>(cudaGetLastError());
}
