// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the TPU kernels ops/attention.py::_flash_kernel and
// ::_flash_kernel_lse of the JAX package (Pallas, launched through
// _flash_forward's pl.pallas_call; the second also emits the row
// log-sum-exp for the blocked backward).  Same function:
// for each (bh = b*H + h, query row) the online-softmax attention
// softmax(scale * q.k^T) . v over keys 0..T-1 (or the band's, below), with
//   * an f32 running max m, sum l and accumulator, output in the input dtype;
//   * keys at positions >= T masked to NEG_INF = -1e30;
//   * for bf16 inputs, p rounded to bf16 before the PV product (as the TPU
//     kernel's p.astype(v.dtype)); for f32 inputs IEEE f32 products (no TF32);
//   * optional attention-probability dropout: l sums the raw p, the keep mask
//     is the counter hash dropout_keep(seed, bh, qpos, kpos, rate) computed
//     here in uint32 arithmetic, kept entries are scaled by 1/(1-rate);
//   * with an lse array, the row m + log(max(l, 1e-30)) in f32.
//
// Bounds on the H100 SXM (3.35 TB/s; 67 TFLOP/s f32 on the CUDA cores,
// 989 TFLOP/s bf16 on the tensor cores), q, k, v read once and o written
// once against the two products' 4*B*H*T^2*D operations:
//   (64, 12, 41, 64)  f32  32.2 MB -> 9.6 us (bytes; the products 4.9 us)
//   (64, 12, 41, 64)  bf16 16.1 MB -> 4.8 us (bytes; the products 0.33 us)
//   (2, 12, 1024, 64) bf16 6.4 GFLOP -> 6.5 us (operations; bytes 3.8 us)
//   (1, 4, 2049, 64)  f32  4.3 GFLOP -> 64 us (operations; bytes 2.5 us)
// So the serving shape is bound by memory and launch latency, and long
// sequences by the products: on the tensor cores in bf16, on the CUDA cores
// in f32 (no tensor-core route meets the f32 path's 1e-5 without TF32 error).
//
// Design.  A block owns one (bh, query tile) and walks the head's keys in
// 64-key tiles held in a 2-stage shared-memory ring: tile j+1 is copied with
// cp.async (16-byte copies that zero-fill rows >= T and columns >= D) while
// tile j is computed.  The query tile covers a whole 41-row serving head, so
// its K/V are read once.  Rows whose D * size is not a multiple of 16 bytes,
// or tensors not 16-byte aligned, take the same kernel's scalar-load branch.
//   bf16: one warpgroup (4 warps) per 64 query rows; a block holds two
//   warpgroups (128 rows) sharing each K/V tile unless that leaves more rows
//   on the busiest SM (at T = 1024 with 24 heads, 192 wide blocks on 132 SMs
//   put 256 rows on some SMs, 384 narrow ones at most 192).  Q, K and V
//   tiles sit in the tensor cores' 128-byte-swizzle layout (64-column
//   panels), and both products are wgmma: S = Q K^T as m64n64k16 from shared
//   memory, O += P V with P as registers (the accumulator layout is the
//   A-operand layout, rounded to bf16 in place) and V from shared memory,
//   MN-major.  The softmax runs on the accumulator fragments: each thread
//   masks and hashes its own (qpos, kpos), a row's max takes 2 shuffles
//   across the quad that shares it, each thread keeps a partial raw-p sum
//   reduced once at the end, and O is rescaled only when a max moved.  The
//   output is staged through the warp's own Q rows and stored 16 bytes per
//   thread; one lane per row writes the lse.
//   f32: 256 threads over a 64 x 64 score tile, each a 4 x 4 block (rows
//   ty + 16i, keys tx + 16j) built as outer products from float4 reads of
//   Q and K rows (8 loads per 64 FMAs; K's row pitch DP + 4 keeps the reads
//   conflict-free); a row's max is reduced over the 16 threads sharing it,
//   P goes through shared memory, and O += P V is the same register tiling
//   (4 rows x 4 columns per 64 of D).
// Band and grouped KV heads (beyond the TPU kernels; flash_mask.cuh): a query
// row i may see keys j <= i (causal) and j >= i - window, and k, v may hold
// fewer heads than q (query head h reads KV head h / (heads / kv_heads), read
// in place: no expanded copy).  A block walks only the key tiles that meet its
// rows' band (key_tiles), and masks elements only in the tiles across the
// band's edge: a masked score is -1e30 for the row max and its p is set to 0
// (a row whose keys so far are all masked has max -1e30, and exp2 of its
// masked scores would not be 0).  Banded launches go tile-major, a causal
// one's last query tiles (the most keys) first.  f32 takes the band as a
// template argument, so its unbanded kernels are the ones from before the band.
// At Trinity's attention, q (2, 32, 8192, 128) and k, v (2, 4, ...) bf16, the
// 2,047-key window takes 0.46 of the causal full layer's time (visible pairs
// 0.4375; tools/flash_band_probe.py).
// Left for later: TMA loads and warp-specialised producers for bf16, whose
// softmax (bound by the special-function unit's exp2) does not yet overlap
// the products of the same warpgroup; 8 x 8 register tiles for f32 (4 x 4
// needs 0.5 FMA per shared-memory byte, half of what keeps the CUDA cores
// fed).
#include "hopper.cuh"
#include "flash_mask.cuh"

namespace {

constexpr int kBlockK = 64;               // keys per staged K/V tile
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                             // null: no lse output
  int t, d;
  float scale;
  uint32_t seed;
  const int* seed_dev;                    // non-null: read the seed here (kernel_seed)
  uint32_t bh_offset;                     // added to bh in the dropout hash
  int use_dropout;
  uint32_t thresh;
  float inv_keep;
  int heads, kv_heads;                    // q's heads and k/v's a batch row (flash_mask.cuh)
  int causal, window;                     // the band: keys j <= i, j >= i - window (-1: none)
};

// p after dropout (kept entries scaled by inv_keep); l has summed the raw p
__device__ __forceinline__ float drop(const Params& p, uint32_t seed, float x, int bh,
                                      int qpos, int kpos) {
  const uint32_t hash = dropout_hash(seed, p.bh_offset + bh, qpos, kpos);
  const bool keep = (hash & 0xFFFFFFu) >= p.thresh;
  return keep ? x * p.inv_keep : 0.f;
}

// ---------------------------------------------------------------- bf16 path

// NW warps = NW/4 warpgroups of 64 query rows; DP = D padded to 64 or 128
template <int NW, int DP, bool ALIGNED>
__global__ void __launch_bounds__(NW * 32, (NW == 8 && DP == 64) ? 2 : 1)
flash_fwd_bf16(const Params p) {
  constexpr int BQ = 16 * NW;             // query rows per block
  constexpr int NT = 32 * NW;
  constexpr int KS = DP / 16;             // k16 steps of Q K^T over D
  constexpr int NP = DP / 64;             // 64-column panels
  constexpr int CH = DP / 8;              // 16-byte chunks per tile row
  constexpr uint32_t kPanelQ = BQ * 128, kPanelK = kBlockK * 128;   // bytes
  extern __shared__ uint4 smem_u4[];
  const uint32_t raw = smem_u32(smem_u4);  // the swizzle follows the address:
  bf16* q_s = reinterpret_cast<bf16*>(     // tiles start 1024-byte aligned
      reinterpret_cast<char*>(smem_u4) + (((raw + 1023u) & ~1023u) - raw));  // [BQ][DP]
  bf16* k_s = q_s + BQ * DP;                        // [2][kBlockK][DP]
  bf16* v_s = k_s + 2 * kBlockK * DP;               // [2][kBlockK][DP]

  const int t = p.t, d = p.d;
  const uint32_t seed = kernel_seed(p.use_dropout, p.seed, p.seed_dev);
  const int n_qtiles = (t + BQ - 1) / BQ;
  const bool band = banded(p.causal, p.window);
  int bh, qt;
  block_tile(gridDim.x / n_qtiles, n_qtiles, band, p.causal, &bh, &qt);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const size_t base = static_cast<size_t>(bh) * t * d;
  const size_t kv_base = static_cast<size_t>(kv_row(bh, p.heads, p.kv_heads)) * t * d;
  const bf16* qg = static_cast<const bf16*>(p.q) + base;
  const bf16* kg = static_cast<const bf16*>(p.k) + kv_base;
  const bf16* vg = static_cast<const bf16*>(p.v) + kv_base;
  int j0, j1;                             // the key tiles the block's band meets
  key_tiles(p.causal, p.window, q0, q0 + BQ, t, kBlockK, &j0, &j1);
  const int row0 = q0 + warp * 16 + g;    // this thread's rows: row0, row0 + 8
  const uint32_t q_addr = smem_u32(q_s) + (warp >> 2) * 64 * 128;  // the warpgroup's rows

  load_tile_bf16<BQ, DP, ALIGNED>(q_s, qg, q0, t, d, tid, NT);
  load_tile_bf16<kBlockK, DP, ALIGNED>(k_s, kg, j0 * kBlockK, t, d, tid, NT);
  load_tile_bf16<kBlockK, DP, ALIGNED>(v_s, vg, j0 * kBlockK, t, d, tid, NT);
  cp_async_commit();

  float acc[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    cp_async_wait<0>();                   // tile j has landed
    fence_proxy_async();
    __syncthreads();                      // ... for all; tile j-1 is consumed
    if (j + 1 < j1) {                     // tile j+1 loads while tile j computes
      load_tile_bf16<kBlockK, DP, ALIGNED>(k_s + (st ^ 1) * kBlockK * DP, kg,
                                           (j + 1) * kBlockK, t, d, tid, NT);
      load_tile_bf16<kBlockK, DP, ALIGNED>(v_s + (st ^ 1) * kBlockK * DP, vg,
                                           (j + 1) * kBlockK, t, d, tid, NT);
      cp_async_commit();
    }
    const uint32_t k_addr = smem_u32(k_s + st * kBlockK * DP);
    const uint32_t v_addr = smem_u32(v_s + st * kBlockK * DP);

    // S = Q K^T for the warpgroup's 64 rows x 64 keys; a k16 step advances
    // 32 bytes along a 128-byte row, then to the next panel
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(s, gmma_desc(q_addr + (kk >> 2) * kPanelQ + (kk & 3) * 32, 16, 1024),
               gmma_desc(k_addr + (kk >> 2) * kPanelK + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // online softmax on the fragments: s[4nb + e] is (row0 + 8(e/2), key
    // k0 + 8nb + 2tq + e%2)
    const int k0 = j * kBlockK;
    // a tile across the band's edge masks its elements: a masked p is 0
    // (a row may have seen no key yet, so its max does not zero it)
    const bool edge = band && !interior(p.causal, p.window, q0, BQ, k0, kBlockK);
    uint32_t seen = 0xFFFFFFFFu;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * p.scale;
      const int kpos = k0 + (i >> 2) * 8 + 2 * tq + (i & 1);
      if (k0 + kBlockK > t && kpos >= t) x = kNegInf;
      if (edge && !visible(p.causal, p.window, row0 + 8 * ((i >> 1) & 1), kpos)) {
        x = kNegInf;
        seen &= ~(1u << i);
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float neg[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2_ftz((m[h] - mx[h]) * kLog2e);
      m[h] = mx[h];
      l[h] *= alpha[h];
      neg[h] = -mx[h] * kLog2e;
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a max moved
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[pn][i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float x = exp2_ftz(fmaf(s[i], kLog2e, neg[h]));
      if (edge && !((seen >> i) & 1u)) x = 0.f;
      l[h] += x;                          // the normalizer sums the raw p
      if (p.use_dropout)
        x = drop(p, seed, x, bh, row0 + 8 * h, k0 + (i >> 2) * 8 + 2 * tq + (i & 1));
      s[i] = x;
    }

    // O += P V: P's accumulator fragments, rounded to bf16, are the A
    // operand in registers; V (keys x D, D contiguous) is B, MN-major, a k16
    // step 16 rows (2048 bytes) on
    uint32_t pa[kBlockK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(pa);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) fence_regs(acc[pn]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
        wgmma_rs(acc[pn], pa[kk], gmma_desc(v_addr + pn * kPanelK + kk * 2048, kPanelK, 1024));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) fence_regs(acc[pn]);
    fence_regs(pa);
  }

  // epilogue: row sums over the quad, normalize, stage the warp's 16 rows in
  // its own Q rows, store 16 bytes per thread
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
    const int row = row0 + 8 * h;
    if (p.lse != nullptr && tq == 0 && row < t)
      p.lse[static_cast<size_t>(bh) * t + row] = m[h] + logf(fmaxf(l[h], 1e-30f));
  }
  __syncthreads();                        // every warpgroup's reads of Q are done
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      *reinterpret_cast<uint32_t*>(q_s + swz<BQ>(warp * 16 + g + 8 * h, 8 * pn + (i >> 2)) +
                                   2 * tq) =
          pack_bf16(acc[pn][i] * inv[h], acc[pn][i + 1] * inv[h]);
    }
  __syncwarp();
  bf16* og = static_cast<bf16*>(p.o) + base;
  const int r_base = q0 + warp * 16;
  if (ALIGNED) {
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = i - r * CH;
      if (r_base + r < t && c * 8 < d)
        *reinterpret_cast<uint4*>(og + static_cast<size_t>(r_base + r) * d + c * 8) =
            *reinterpret_cast<const uint4*>(q_s + swz<BQ>(warp * 16 + r, c));
    }
  } else {
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = i / DP, c = i - r * DP;
      if (r_base + r < t && c < d)
        og[static_cast<size_t>(r_base + r) * d + c] = q_s[swz<BQ>(warp * 16 + r, c >> 3) + (c & 7)];
    }
  }
}

// ----------------------------------------------------------------- f32 path

constexpr int kF32Threads = 256;          // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kF32Rows = 64;              // query rows per block
constexpr int kPPitch = kBlockK + 16;     // P row pitch: the two rows a warp
                                          // writes land 16 banks apart

// rows [r0, r0 + 64) of a (t, d) f32 matrix into a [64][pitch] tile, zeros
// outside it (columns up to DP)
template <int DP, bool ALIGNED>
__device__ __forceinline__ void load_tile_f32(float* s, int pitch, const float* g, int r0,
                                              int t, int d, int tid) {
  load_rows_f32<kF32Rows, DP, kF32Threads, ALIGNED>(s, pitch, g, r0, t, d, tid);
}

// DP = D padded to 64 or 128; BAND: causal or a window (flash_mask.cuh).  The
// band is a template argument here, so the unbanded instantiation compiles to
// the kernel as it was before the band, the same f32 operations contracted the
// same way (a branch between the exp and the sum moved nvcc's contractions)
template <int DP, bool ALIGNED, bool BAND>
__global__ void __launch_bounds__(kF32Threads, DP == 64 ? 2 : 1)
flash_fwd_f32(const Params p) {
  constexpr int QP = DP + 4;              // Q/K row pitch: float4 reads of 8
                                          // consecutive rows hit distinct banks
  constexpr int NC = DP / 64;             // output column groups per thread
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);   // [64][QP]
  float* k_s = q_s + kF32Rows * QP;                 // [2][kBlockK][QP]
  float* v_s = k_s + 2 * kBlockK * QP;              // [2][kBlockK][DP]
  float* p_s = v_s + 2 * kBlockK * DP;              // [64][kPPitch]

  const int t = p.t, d = p.d;
  const uint32_t seed = kernel_seed(p.use_dropout, p.seed, p.seed_dev);
  const int n_qtiles = (t + kF32Rows - 1) / kF32Rows;
  constexpr bool band = BAND;
  int bh, qt;
  block_tile(gridDim.x / n_qtiles, n_qtiles, band, p.causal, &bh, &qt);
  const int q0 = qt * kF32Rows;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = static_cast<size_t>(bh) * t * d;
  const size_t kv_base = static_cast<size_t>(kv_row(bh, p.heads, p.kv_heads)) * t * d;
  const float* qg = static_cast<const float*>(p.q) + base;
  const float* kg = static_cast<const float*>(p.k) + kv_base;
  const float* vg = static_cast<const float*>(p.v) + kv_base;
  int j0 = 0, j1 = (t + kBlockK - 1) / kBlockK;   // the key tiles the band meets
  if (BAND) key_tiles(p.causal, p.window, q0, q0 + kF32Rows, t, kBlockK, &j0, &j1);
  const int dq = (d + 3) & ~3;            // columns read; zero past d

  load_tile_f32<DP, ALIGNED>(q_s, QP, qg, q0, t, d, tid);
  load_tile_f32<DP, ALIGNED>(k_s, QP, kg, j0 * kBlockK, t, d, tid);
  load_tile_f32<DP, ALIGNED>(v_s, DP, vg, j0 * kBlockK, t, d, tid);
  cp_async_commit();

  // this thread: rows ty + 16i (i < 4); score keys tx + 16jj (jj < 4); output
  // columns 4tx + 64c (c < NC)
  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    cp_async_wait<0>();                   // tile j has landed
    __syncthreads();                      // ... for all; tile j-1 and P are consumed
    if (j + 1 < j1) {                     // tile j+1 loads while tile j computes
      load_tile_f32<DP, ALIGNED>(k_s + (st ^ 1) * kBlockK * QP, QP, kg, (j + 1) * kBlockK,
                                 t, d, tid);
      load_tile_f32<DP, ALIGNED>(v_s + (st ^ 1) * kBlockK * DP, DP, vg, (j + 1) * kBlockK,
                                 t, d, tid);
      cp_async_commit();
    }
    const float* ks = k_s + st * kBlockK * QP;
    const float* vs = v_s + st * kBlockK * DP;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < dq; c += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * QP + c);
        b[i] = *reinterpret_cast<const float4*>(ks + (tx + 16 * i) * QP + c);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(a[i].x, b[jj].x, s[i][jj]);
          s[i][jj] = fmaf(a[i].y, b[jj].y, s[i][jj]);
          s[i][jj] = fmaf(a[i].z, b[jj].z, s[i][jj]);
          s[i][jj] = fmaf(a[i].w, b[jj].w, s[i][jj]);
        }
    }

    const int k0 = j * kBlockK;
    const bool edge = band && !interior(p.causal, p.window, q0, kF32Rows, k0, kBlockK);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float x = s[i][jj] * p.scale;
        if (k0 + tx + 16 * jj >= t) x = kNegInf;
        if (edge && !visible(p.causal, p.window, q0 + ty + 16 * i, k0 + tx + 16 * jj)) x = kNegInf;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // the 16 threads of row ty + 16i
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2_ftz((m[i] - mx) * kLog2e);
      m[i] = mx;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
      const float neg = -mx * kLog2e;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float x = exp2_ftz(fmaf(s[i][jj], kLog2e, neg));
        if (edge && !visible(p.causal, p.window, q0 + ty + 16 * i, k0 + tx + 16 * jj)) x = 0.f;
        l[i] += x;                        // the normalizer sums the raw p
        if (p.use_dropout) x = drop(p, seed, x, bh, q0 + ty + 16 * i, k0 + tx + 16 * jj);
        p_s[(ty + 16 * i) * kPPitch + tx + 16 * jj] = x;
      }
    }
    __syncthreads();

    // O += P V over the tile's keys (P is 0 and V is zero-filled past t)
    const int kn = min(kBlockK, t - k0);
    for (int kk = 0; kk < kn; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPPitch + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + (kk + e) * DP + 4 * tx + 64 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(acc[i][c], lane_of(pr[i], e), vv);
        }
      }
    }
  }

  float* og = static_cast<float*>(p.o) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * tx + 64 * c;
      const float4 out = make_float4(acc[i][c].x * inv, acc[i][c].y * inv, acc[i][c].z * inv,
                                     acc[i][c].w * inv);
      float* dst = og + static_cast<size_t>(row) * d + col;
      if (ALIGNED) {
        if (col < d) *reinterpret_cast<float4*>(dst) = out;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) dst[e] = lane_of(out, e);
      }
    }
    if (p.lse != nullptr && tx == 0)
      p.lse[static_cast<size_t>(bh) * t + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ------------------------------------------------------------------ launch

cudaError_t launch(void (*kernel)(Params), int blocks, int threads, size_t smem,
                   cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NW, int DP, bool ALIGNED>
cudaError_t run_bf16(int bh, const Params& p, cudaStream_t stream) {
  const int n_qtiles = (p.t + 16 * NW - 1) / (16 * NW);
  const size_t smem = static_cast<size_t>(16 * NW + 4 * kBlockK) * DP * sizeof(bf16) + 1024;
  return launch(flash_fwd_bf16<NW, DP, ALIGNED>, bh * n_qtiles, 32 * NW, smem, stream, p);
}

template <int DP, bool ALIGNED, bool BAND>
cudaError_t run_f32(int bh, const Params& p, cudaStream_t stream) {
  const int n_qtiles = (p.t + kF32Rows - 1) / kF32Rows;
  const size_t smem = (static_cast<size_t>(kF32Rows + 2 * kBlockK) * (DP + 4) +
                       2 * kBlockK * DP + kF32Rows * kPPitch) * sizeof(float);
  return launch(flash_fwd_f32<DP, ALIGNED, BAND>, bh * n_qtiles, kF32Threads, smem, stream, p);
}

// bf16 takes 128-row blocks (two warpgroups sharing each K/V tile) unless
// 64-row blocks leave fewer query rows on the busiest SM
template <int DP, bool ALIGNED>
cudaError_t run(int bh, int is_bf16, const Params& p, cudaStream_t stream) {
  if (!is_bf16)
    return banded(p.causal, p.window) ? run_f32<DP, ALIGNED, true>(bh, p, stream)
                                      : run_f32<DP, ALIGNED, false>(bh, p, stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long narrow = static_cast<long long>(bh) * ((p.t + 63) / 64);
  const long long wide = static_cast<long long>(bh) * ((p.t + 127) / 128);
  return 128 * ((wide + sms - 1) / sms) <= 64 * ((narrow + sms - 1) / sms)
             ? run_bf16<8, DP, ALIGNED>(bh, p, stream)
             : run_bf16<4, DP, ALIGNED>(bh, p, stream);
}

}  // namespace

// q, o: contiguous (bh, t, d) arrays on the device, all f32 (is_bf16 = 0) or
// all bf16 (is_bf16 = 1); 1 <= d <= 128.  bh = batch * heads; k and v hold
// kv_heads heads a batch row (heads a multiple of kv_heads), query head h
// reading KV head h / (heads / kv_heads).  causal: query i sees keys j <= i;
// window >= 0: keys j >= i - window; -1: no bound.  lse: null, or a contiguous
// (bh, t) f32 array that receives the row log-sum-exp.  seed >= 0, or seed_dev
// the address of an int32 seed on the device, which the kernel reads instead
// (a CUDA graph then replays the launch with whatever seed is there); thresh
// and inv_keep are dropout_keep's threshold on the low 24 hash bits and 1/(1-rate); the mask
// of the launch's head bh hashes bh_offset + bh (mod 2^32), so a rank holding
// rows of a larger batch draws that batch's masks.
// Launches on `stream` and returns the launch's CUDA error code (0: none).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int t, int d, int heads, int kv_heads, int causal,
                         int window, int is_bf16, float scale, int seed, const void* seed_dev,
                         int bh_offset, int use_dropout, int thresh, float inv_keep,
                         void* stream) {
  const long long n_qtiles = (t + kBlockK - 1) / kBlockK;
  if (bh < 1 || t < 1 || d < 1 || d > 128 || (!seed_dev && seed < 0) || thresh < 0 ||
      static_cast<long long>(bh) * n_qtiles > 0x7FFFFFFFLL || heads < 1 || kv_heads < 1 ||
      heads % kv_heads || bh % heads || window < -1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{q, k, v, o, static_cast<float*>(lse), t, d, scale,
                 static_cast<uint32_t>(seed), static_cast<const int*>(seed_dev),
                 static_cast<uint32_t>(bh_offset), use_dropout,
                 static_cast<uint32_t>(thresh), inv_keep, heads, kv_heads, causal != 0,
                 window};
  // cp.async moves 16-byte pieces: rows of a multiple of 16 bytes, 16-byte
  // aligned arrays; anything else takes the kernels' scalar-load branch
  const size_t elem = is_bf16 ? 2 : 4;
  const uintptr_t addrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const bool aligned = (d * elem) % 16 == 0 && addrs % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 64) {
    err = aligned ? run<64, true>(bh, is_bf16, p, s) : run<64, false>(bh, is_bf16, p, s);
  } else {
    err = aligned ? run<128, true>(bh, is_bf16, p, s) : run<128, false>(bh, is_bf16, p, s);
  }
  return static_cast<int>(err);
}
