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
// Bound on the H100: about 21 operations per (row, position, s) whose weight
// is needed (SSD, box sum, scale, exp, masks, four accumulations) against
// 8 bytes per element of x in and out, so it is bound by operations: at
// (768, 2500), full search, 5.0e10 operations, 0.75 ms at 67 TFLOP/s.  The
// work is bound by the instruction rate: every weight costs its SSD, its box sum, an accurate
// expf (~8 instructions; no --use_fast_math) and the accumulations, and the
// design spends as few further instructions per weight as it can.
//
// Design.  The shift axis is a sum, so it is split over the C <= 8 blocks of
// a thread block cluster, and each block carries num/z partials of its
// positions in registers.  Shifts are dealt out round robin, shift s to the
// block of rank s mod C, so the blocks get equal shares although a shift's
// work falls as s grows.  At the end every block stores its partials in its
// shared memory, and block r sums positions [r, r+1) * ceil(n/C) of all C
// blocks in rank order through distributed shared memory (map_shared_rank):
// a fixed order and no float atomics, so two calls give the same bits.
// C is chosen at launch from the card (choose_cluster): the kernel is bound
// by each SM's issue rate, not by how many blocks an SM holds at once (on
// the H100, 192 rows at C = 1, at most two blocks per SM, took 3.0 ms and
// 768 rows, six per SM, 9.3 ms), so a launch takes about as long as the
// blocks its busiest SM runs, each 1/C of a row's shifts:
// ceil(blocks * C / SMs) / C.  C is the smallest of 1..8 within 5 % of the
// least such cost, since a larger C stages the row and reduces more often:
// C = 1 for the chain's 768 rows, 2 for 192.  The occupancy query checks that
// a block fits on an SM.  Every f32 sum leaves out the s = 0 term, the one
// large term at a QRS sample (weight 1 on the sample itself), and adds it
// last, so the small terms are not dropped.  The box sum is add-only in both
// branches: never a running sum that subtracts the tap leaving the window,
// whose rounding after a QRS-sized SSD would carry into the small distances
// that follow it.  Two branches:
//
// * Register branch (pw == 10, n <= 4096; the denoise chain's rows).  A block
//   owns a row, staged once in shared memory with zero pads.  Thread t owns
//   the K = 11 positions [11t, 11t+11) and keeps its own x window (K + 2pw =
//   31 values) in registers for the whole call.  Per shift it reads x[k+s]
//   for its window (stride K between lanes, K odd, so a warp's 32 reads fall
//   on 32 banks with no skew), forms the 31 SSDs and the 11 box sums in
//   registers (van Herk / Gil-Werman with K <= 2pw+1: every window is a
//   suffix of [c, K-2] + the common core [K-1, 2pw] + a prefix of
//   [2pw+1, c+2pw], about 4 adds per weight), the 11 weights and their +s
//   terms (x[i+s] is already in registers).  For the -s term it writes the
//   weights into the shift's shared row.  B = kShifts shifts share one
//   __syncthreads: a thread forms the +s terms of its B next shifts, writing
//   B weight rows, then after the barrier reads w_s[i-s] and x[i-s] of all B;
//   two sets of rows let the next batch write while no one reads.
//   Recomputing the -s distance from the thread's own window instead would
//   need no barrier but a second SSD, box sum and expf per weight (~15 more
//   instructions against ~3 shared accesses).  K and B were chosen by timing
//   builds side by side on the H100 (tools/nlm_design.py): K = 11 runs the
//   chain's rows in 8 warps per block at 2 blocks per SM, faster than K = 9,
//   13 and 15, and B = 1 beat 2 and 4 at K = 11 (at K = 15, B = 4 was ahead).
//   A run
//   whose window touches a row edge or the interior's bound checks each SSD
//   and term against its position; only those two loops branch on it, so
//   one copy of the box sum and the exp serves every run and the loop's code
//   stays small (a build with a separately unrolled masked copy, one that
//   paired two rows per block so that no thread idles at large shifts, and
//   one that read the window from shared memory to free registers all ran
//   slower on the H100).
//
// * Generic branch (any other pw, and rows longer than 4096: the segmented
//   path).  A block owns a segment of T = threads * 8 positions of one row
//   and walks its shifts one at a time: it stages the SSD of the positions
//   it needs (its segment plus the pw halos, and for a split row the window
//   shifted by -s, whose weights the -s term reads) in shared memory, scans
//   each aligned block of 2pw+1 SSDs into prefix and exclusive-suffix sums
//   (one thread per block), forms each weight as suffix + prefix (one add),
//   and accumulates both terms into registers; three barriers per shift.  x
//   is read through L1, so a row of any length runs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kPW = 10;                 // the register branch's patch half-width
constexpr int kK = 11;                  // positions per thread (odd: no bank conflicts)
constexpr int kWin = kK + 2 * kPW;      // a thread's SSD window
constexpr int kResMax = 4096;           // longest row the register branch stages
constexpr int kResThreads = (kResMax + kK - 1) / kK / 32 * 32 + 32;   // 384
constexpr int kGenPer = 8;              // positions per thread, generic branch
constexpr int kGenThreads = 512;        // generic segment <= 4096 positions
constexpr int kShifts = 1;              // B: shifts per barrier, register branch
constexpr int kMaxCluster = 8;

static_assert(kK <= 2 * kPW + 1, "the core box sum needs K <= 2 pw + 1");
static_assert(kK % 2 == 1, "K odd keeps stride-K shared reads off shared banks");

struct Params {
  const float* x;
  const float* hinv;
  float* out;
  int n, sch, pw, seg, segs, C;         // sch: shifts that contribute (clamped)
  float eps;
};

// The positions whose weight step s reads: the +s term's interior i with
// i+s < n, the -s term's i-s > 0 (ACCUM); every interior position otherwise.
template <bool MIRROR, bool ACCUM>
__device__ __forceinline__ void needed(int n, int pw, int s, int& lo, int& hi) {
  lo = pw + 1;
  hi = n - pw;
  if (!ACCUM) return;
  hi = min(hi, n - s);
  if (MIRROR && s > 0) {
    lo = max(1, pw + 1 - s);
    hi = max(hi, n - pw - s);
  }
}

// w = exp(-d / h) (EXP) or d / h, from d and hinv = 1/h
template <bool EXP>
__device__ __forceinline__ float weight_of(float d, float hinv) {
  return EXP ? expf(__fmul_rn(-d, hinv)) : __fmul_rn(d, hinv);
}

// Blocks of one cluster hold partial num (part[0, T)) and z (part[T, 2T)) of
// positions [a, a+T); block r finishes positions [a + r*chunk, ...) by summing
// the C partials in rank order, then the s = 0 term, and writes out =
// num / (z + eps) on the interior, x elsewhere.  The loops skip s = 0: its
// weight w0 (d = 0, so 1, or NaN for an all-zero row) is the one large term
// at a QRS sample, and an f32 sum that starts with it drops the small terms
// after it; added last, it rounds once.
template <bool EXP, bool ACCUM>
__device__ __forceinline__ void reduce_store(float* part, int T, int a, const Params& p,
                                             float hinv, const float* __restrict__ xr,
                                             float* __restrict__ outr) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int len = min(T, p.n - a);
  const int chunk = (len + C - 1) / C;
  const int hi = min(len, (rank + 1) * chunk);
  const float w0 = weight_of<EXP>(0.f, hinv);
  for (int j = rank * chunk + threadIdx.x; j < hi; j += blockDim.x) {
    float num = 0.f, z = 0.f;
    for (int q = 0; q < C; ++q) {
      const float* rp = cl.map_shared_rank(part, q);
      num = __fadd_rn(num, rp[j]);
      z = __fadd_rn(z, rp[T + j]);
    }
    const int i = a + j;
    const bool interior = i >= p.pw + 1 && i < p.n - p.pw;
    if (p.sch > 0) {
      num = ACCUM ? fmaf(w0, xr[i], num) : __fadd_rn(num, w0);
      z = __fadd_rn(z, w0);
    }
    outr[i] = interior ? __fdiv_rn(num, __fadd_rn(z, p.eps)) : xr[i];
  }
  cl.sync();   // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------- register branch

// One shift's weights of positions [i0, i0+K) and their +s terms.  xs[k] =
// x[k] of the staged row (zeros around [0, n)), wrow[p] the shift's weight
// row, xk the thread's window x[i0-pw .. i0+K-1+pw].  A run whose window touches a row edge or the interior's bound
// checks every SSD and term against its own position; the others skip the
// checks.  Only the SSD and the accumulation differ between the two: one
// copy of the box sum and the exp serves both, which keeps the loop's code
// small.
template <bool BOX, bool EXP, bool MIRROR, bool ACCUM>
__device__ __forceinline__ void plus_run(const float* xs, float* wrow, const float (&xk)[kWin],
                                         float (&num)[kK], float (&z)[kK], int i0, int s,
                                         int n, float hinv) {
  const bool masked = !(i0 >= kPW + 1 && i0 + kK + kPW + s <= n);
  float ssd[kWin], xp[kK];
  if (masked) {
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      if (!BOX && (j < kPW || j >= kPW + kK)) continue;
      const int k = i0 - kPW + j;
      const float xv = xs[min(k + s, n)];
      const float d = __fsub_rn(xk[j], xv);
      ssd[j] = k >= 0 && k + s < n ? __fmul_rn(d, d) : 0.f;
      if (j >= kPW && j < kPW + kK) xp[j - kPW] = xv;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      if (!BOX && (j < kPW || j >= kPW + kK)) continue;
      const float xv = xs[i0 - kPW + j + s];
      const float d = __fsub_rn(xk[j], xv);
      ssd[j] = __fmul_rn(d, d);
      if (j >= kPW && j < kPW + kK) xp[j - kPW] = xv;
    }
  }
  float w[kK];
  if (BOX) {
    // window c = ssd[c .. c+2pw]: suffix S[c] of [c, K-2], the core
    // [K-1, 2pw] shared by all K windows, prefix P[c] of [2pw+1, c+2pw]
    constexpr int W = 2 * kPW + 1;
    float core = ssd[kK - 1];
#pragma unroll
    for (int j = kK; j < W; ++j) core = __fadd_rn(core, ssd[j]);
    float suf[kK], pre[kK];
    suf[kK - 1] = 0.f;
#pragma unroll
    for (int c = kK - 2; c >= 0; --c) suf[c] = c == kK - 2 ? ssd[c] : __fadd_rn(ssd[c], suf[c + 1]);
    pre[0] = 0.f;
#pragma unroll
    for (int c = 1; c < kK; ++c) pre[c] = c == 1 ? ssd[W] : __fadd_rn(pre[c - 1], ssd[c + W - 1]);
#pragma unroll
    for (int c = 0; c < kK; ++c) {
      const float d = c < kK - 1 ? __fadd_rn(suf[c], core) : core;
      w[c] = weight_of<EXP>(c > 0 ? __fadd_rn(d, pre[c]) : d, hinv);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kK; ++c) w[c] = weight_of<EXP>(ssd[kPW + c], hinv);
  }
  if (ACCUM && MIRROR) {
#pragma unroll
    for (int c = 0; c < kK; ++c) wrow[i0 + c] = w[c];
  }
  if (masked) {
#pragma unroll
    for (int c = 0; c < kK; ++c) {
      const int i = i0 + c;
      if (!(i >= kPW + 1 && i < n - kPW && (!ACCUM || i + s < n))) continue;
      num[c] = ACCUM ? fmaf(w[c], xp[c], num[c]) : __fadd_rn(num[c], w[c]);
      z[c] = __fadd_rn(z[c], w[c]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kK; ++c) {
      num[c] = ACCUM ? fmaf(w[c], xp[c], num[c]) : __fadd_rn(num[c], w[c]);
      z[c] = __fadd_rn(z[c], w[c]);
    }
  }
}

// One shift's -s terms of positions [i0, i0+K): w_s[i-s] from the shared row
// that the owners of i-s wrote before the barrier, and x[i-s].
__device__ __forceinline__ void minus_run(const float* xs, const float* wrow,
                                          float (&num)[kK], float (&z)[kK], int i0, int s,
                                          int n) {
  const bool masked = !(i0 - s >= 1 && i0 >= kPW + 1 && i0 + kK <= n - kPW);
#pragma unroll
  for (int c = 0; c < kK; ++c) {
    const int i = i0 + c, q = i - s;
    if (masked && !(i >= kPW + 1 && i < n - kPW && q > 0)) continue;
    const float w = wrow[q];
    num[c] = fmaf(w, xs[q], num[c]);
    z[c] = __fadd_rn(z[c], w);
  }
}

// A block owns one row and the shifts s = rank, rank + C, ... of its cluster
// rank (s > 0; reduce_store adds s = 0), kShifts of them per barrier.  Thread
// t owns positions [Kt, Kt+K); row arrays are indexed by position through
// offsets.
template <bool BOX, bool EXP, bool MIRROR, bool ACCUM>
__global__ void __launch_bounds__(kResThreads) nlm_res_kernel(Params p) {
  extern __shared__ float smem[];
  const int n = p.n, TK = p.seg;
  const int row = blockIdx.x / p.C, rank = blockIdx.x % p.C;
  const int lx = kPW + TK + kPW + 1;
  float* xs = smem + kPW;                    // xs[k] = x[k], zero outside [0, n)
  float* wbuf = smem + lx;                   // two sets of kShifts weight rows of TK
  const float* __restrict__ xr = p.x + static_cast<size_t>(row) * n;
  const float hinv = p.hinv[row];
  for (int j = threadIdx.x; j < lx; j += blockDim.x) {
    const int k = j - kPW;
    smem[j] = k >= 0 && k < n ? xr[k] : 0.f;
  }
  __syncthreads();

  const int i0 = threadIdx.x * kK;
  float xk[kWin], num[kK], z[kK];
#pragma unroll
  for (int j = 0; j < kWin; ++j) xk[j] = xs[i0 - kPW + j];
#pragma unroll
  for (int c = 0; c < kK; ++c) num[c] = z[c] = 0.f;

  int buf = 0;
  for (int s0 = rank; s0 < p.sch; s0 += kShifts * p.C) {
    // a batch: the block's next kShifts shifts s0, s0 + C, ...
#pragma unroll 1
    for (int b = 0; b < kShifts; ++b) {
      const int s = s0 + b * p.C;
      if (s == 0 || s >= p.sch) continue;
      int lo, hi;
      needed<MIRROR, ACCUM>(n, kPW, s, lo, hi);
      if (i0 < hi && i0 + kK > lo)
        plus_run<BOX, EXP, MIRROR, ACCUM>(xs, wbuf + (buf * kShifts + b) * TK, xk, num, z,
                                          i0, s, n, hinv);
    }
    if (ACCUM && MIRROR) {
      __syncthreads();   // the batch's weight rows are written
#pragma unroll 1
      for (int b = 0; b < kShifts; ++b) {
        const int s = s0 + b * p.C;
        if (s == 0 || s >= p.sch) continue;
        if (i0 + kK - 1 - s >= 1 && i0 + kK - 1 >= kPW + 1 && i0 < n - kPW)
          minus_run(xs, wbuf + (buf * kShifts + b) * TK, num, z, i0, s, n);
      }
      buf ^= 1;          // the next batch writes the other rows
    }
  }
  __syncthreads();       // every read of the weight rows is done
#pragma unroll
  for (int c = 0; c < kK; ++c) {
    wbuf[i0 + c] = num[c];
    wbuf[TK + i0 + c] = z[c];
  }
  reduce_store<EXP, ACCUM>(wbuf, TK, 0, p, hinv, xr, p.out + static_cast<size_t>(row) * n);
}

// ---------------------------------------------------------------- generic branch

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

// Over buf[jlo, jhi), cut into blocks [mW, (m+1)W): the exclusive suffix
// sum of each block into suf (0 at a block's first entry, else the sum from
// the entry to the block's end) and, in place, the prefix sum from the
// block's first entry.  A window of W taps from j0 is then suf[j0] +
// buf[j0+W-1]: adds only.  One thread per block.
__device__ __forceinline__ void scan_blocks(float* buf, float* suf, int jlo, int jhi, int W) {
  if (jlo >= jhi) return;
  const int m1 = (jhi - 1) / W;
  for (int m = jlo / W + threadIdx.x; m <= m1; m += blockDim.x) {
    const int b = m * W, st = max(b, jlo), en = min(b + W, jhi);
    float acc = 0.f;
    for (int j = en - 1; j >= st; --j) {
      acc = __fadd_rn(acc, buf[j]);
      suf[j] = j == b ? 0.f : acc;
    }
    acc = 0.f;
    for (int j = st; j < en; ++j) {
      acc = __fadd_rn(acc, buf[j]);
      buf[j] = acc;
    }
  }
}

// w_s[p] for p in [plo, phi) into w[p - base], from the scanned SSD of
// k = p - pw .. p + pw at index p - base (scan) or the SSD at p (!BOX)
template <bool BOX, bool EXP>
__device__ __forceinline__ void fill_weights(float* w, const float* pre, const float* suf,
                                             int base, int plo, int phi, int pw, float hinv) {
  for (int p = plo + threadIdx.x; p < phi; p += blockDim.x) {
    const int j0 = p - base;
    const float d = BOX ? __fadd_rn(suf[j0], pre[j0 + 2 * pw]) : pre[j0 + pw];
    w[j0] = weight_of<EXP>(d, hinv);
  }
}

template <bool BOX, bool EXP, bool MIRROR, bool ACCUM>
__global__ void __launch_bounds__(kGenThreads) nlm_gen_kernel(Params p) {
  extern __shared__ float smem[];
  const int n = p.n, pw = p.pw, T = p.seg;
  const int cluster = blockIdx.x / p.C, rank = blockIdx.x % p.C;
  const int row = cluster / p.segs;
  const int a = (cluster % p.segs) * T;     // first position of the segment
  const int span = T + 2 * pw;
  float* ssd_own = smem;                    // ssd at k = a - pw + j, then its prefix sums
  float* suf_own = ssd_own + span;
  float* w_own = suf_own + span;            // w at p = a + j
  float* ssd_mir = w_own + T;               // the same at k = a - s - pw + j (split rows)
  float* suf_mir = ssd_mir + span;
  float* w_mir = suf_mir + span;            // w at p = a - s + j
  const float* __restrict__ xr = p.x + static_cast<size_t>(row) * n;
  const float hinv = p.hinv[row];
  const int own_lo = max(a, pw + 1);        // interior positions of the segment
  const int own_hi = min(a + T, n - pw);
  const int r = BOX ? pw : 0;               // SSD halo of a weight

  float num[kGenPer], z[kGenPer];
#pragma unroll
  for (int c = 0; c < kGenPer; ++c) num[c] = z[c] = 0.f;

  for (int s = rank; s < p.sch; s += p.C) {
    if (s == 0) continue;    // reduce_store adds s = 0
    const bool mirror = ACCUM && MIRROR;
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
    if (BOX) {
      if (lo < hi) scan_blocks(ssd_own, suf_own, lo - a, hi + 2 * pw - a, 2 * pw + 1);
      if (mlo < mhi) scan_blocks(ssd_mir, suf_mir, mlo - a + s, mhi + 2 * pw - a + s, 2 * pw + 1);
      __syncthreads();
    }
    if (lo < hi) fill_weights<BOX, EXP>(w_own, ssd_own, suf_own, a, lo, hi, pw, hinv);
    if (mlo < mhi) fill_weights<BOX, EXP>(w_mir, ssd_mir, suf_mir, a - s, mlo, mhi, pw, hinv);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kGenPer; ++c) {
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
        num[c] = fmaf(w, xr[i + s], num[c]);
        z[c] = __fadd_rn(z[c], w);
      }
      if (mirror && i - s > 0) {
        const int q = i - s;
        const float w = q >= a ? w_own[q - a] : w_mir[q - (a - s)];
        num[c] = fmaf(w, xr[q], num[c]);
        z[c] = __fadd_rn(z[c], w);
      }
    }
    // the next step's SSD writes wait at its first barrier for these reads
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kGenPer; ++c) {
    const int j = c * blockDim.x + threadIdx.x;
    smem[j] = num[c];
    smem[T + j] = z[c];
  }
  reduce_store<EXP, ACCUM>(smem, T, a, p, hinv, xr, p.out + static_cast<size_t>(row) * n);
}

// ---------------------------------------------------------------- launch

// argmin over c in [1, cmax] of ceil(blocks * c / sms) / c, the smallest c
// within 5 % of the least (cost_c <= 1.05 cost_min, in integers)
int choose_cluster(long long blocks, int sms, int cmax) {
  long long best_w = 0;
  int best_c = 0;
  long long waves[kMaxCluster + 1];
  for (int c = 1; c <= cmax; ++c) {
    waves[c] = (blocks * c + sms - 1) / sms;
    if (best_c == 0 || waves[c] * best_c < best_w * c) {
      best_w = waves[c];
      best_c = c;
    }
  }
  for (int c = 1; c <= cmax; ++c)
    if (waves[c] * best_c * 20 <= best_w * c * 21) return c;
  return best_c;
}

// The launch plan of one call: branch, block shape, shared memory, and the
// kernel to launch.
template <bool BOX, bool EXP, bool MIRROR, bool ACCUM>
struct Plan {
  bool res;
  int threads, seg, segs, steps_sch;
  long long blocks;   // clusters: one per (row, segment)
  size_t smem;
  void (*kernel)(Params);

  Plan(int rows, int n, int sch, int pw) {
    // shifts past the row add nothing to a masked accumulation
    steps_sch = ACCUM ? std::min(sch, std::max(n - pw - 1, 0)) : sch;
    res = pw == kPW && n <= kResMax;
    size_t floats;
    if (res) {   // a block per row
      threads = ((n + kK - 1) / kK + 31) / 32 * 32;
      seg = threads * kK;
      segs = 1;
      blocks = rows;
      floats = static_cast<size_t>(2 * kPW + seg + 1) + 2 * kShifts * static_cast<size_t>(seg);
    } else {     // a block per (row, segment)
      threads = (n + kGenPer - 1) / kGenPer;
      threads = std::min(kGenThreads, std::max(32, (threads + 31) / 32 * 32));
      seg = threads * kGenPer;
      segs = (n + seg - 1) / seg;
      blocks = static_cast<long long>(rows) * segs;
      floats = static_cast<size_t>(2 * (seg + 2 * pw) + seg) * (segs > 1 ? 2 : 1);
    }
    smem = floats * sizeof(float);
    kernel = res ? nlm_res_kernel<BOX, EXP, MIRROR, ACCUM> : nlm_gen_kernel<BOX, EXP, MIRROR, ACCUM>;
  }

  // The cluster size C (see the header): choose_cluster over the card's SMs;
  // the occupancy query checks that a block of this shape fits on an SM.
  cudaError_t cluster(int& C) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && smem > 48 * 1024)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
    C = choose_cluster(blocks, sms, std::max(1, std::min(kMaxCluster, steps_sch)));
    return cudaSuccess;
  }
};

template <bool BOX, bool EXP, bool MIRROR, bool ACCUM>
int launch(const void* x, const void* hinv, void* out, int rows, int n, int sch, int pw,
           float eps, void* stream) {
  if (rows < 1 || n < 1 || sch < 1 || pw < 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan<BOX, EXP, MIRROR, ACCUM> plan(rows, n, sch, pw);
  int C = 1;
  cudaError_t e = plan.cluster(C);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (plan.blocks * C > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(x), static_cast<const float*>(hinv),
                 static_cast<float*>(out), n, plan.steps_sch, pw, plan.seg, plan.segs, C, eps};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(plan.blocks * C));
  cfg.blockDim = dim3(plan.threads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, plan.kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (rows, n) f32 contiguous on the device; hinv: (rows,) f32, 1/h per
// row.  sch: shift magnitudes 0 .. sch-1; pw: patch half-width.  Launches one
// kernel on `stream` and returns its launch error (cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int nlm_rows(const void* x, const void* hinv, void* out, int rows, int n,
                        int sch, int pw, void* stream) {
  return launch<true, true, true, true>(x, hinv, out, rows, n, sch, pw,
                                        2.220446049250313e-16f, stream);
}

// The cluster size nlm_rows launches with for these arguments on the current
// device, or minus its CUDA error.
extern "C" int nlm_rows_cluster(int rows, int n, int sch, int pw) {
  if (rows < 1 || n < 1 || sch < 1 || pw < 0) return -static_cast<int>(cudaErrorInvalidValue);
  Plan<true, true, true, true> plan(rows, n, sch, pw);
  int C = 1;
  const cudaError_t e = plan.cluster(C);
  return e == cudaSuccess ? C : -static_cast<int>(e);
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
