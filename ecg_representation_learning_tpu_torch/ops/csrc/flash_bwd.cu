// Blocked flash-attention backward for Hopper (sm_90a), CUDA C++ with plain C
// entries: one kernel for dQ, one for dK and dV.
//
// Replaces the TPU kernels ops/attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel of the JAX package (Pallas, both launched by
// _flash_backward_blocked's pl.pallas_call).  Same function, for each
// bh = b*H + h, query row i and key j < T (or the band's keys, below):
//   p_ij   = exp(scale * q_i.k_j - lse_i)          (lse from the forward)
//   dpv_ij = dO_i . v_j, times keep_ij / (1 - rate) when dropout is on
//   ds_ij  = p_ij * (dpv_ij - delta_i)             (delta = rowsum(dO * O))
//   dQ_i   = scale * sum_j ds_ij k_j               (ds rounded to k's dtype)
//   dK_j   = scale * sum_i ds_ij q_i               (ds rounded to q's dtype)
//   dV_j   = sum_i p_ij keep_ij / (1 - rate) dO_i
// with keys >= T masked, padded queries contributing 0, and the keep mask
// regenerated from dropout_keep's hash of (seed, bh, qpos, kpos), never
// stored.  Sums in f32, outputs in the input dtype.  f32 inputs: IEEE f32
// products (the TPU pins Precision.HIGHEST), no TF32.  bf16 inputs: the
// products run on the tensor cores, exact for bf16 q, k, v, dO and the
// bf16-rounded ds; the dV product also takes p_eff rounded to bf16 (the TPU's
// default-precision f32 product rounds it the same way).
//
// Bounds on the H100 SXM (3.35 TB/s; 67 TFLOP/s f32 on the CUDA cores,
// 989 TFLOP/s bf16 on the tensor cores): q, k, v, dO read once with the f32
// lse and delta, dQ (6 * B*H*T^2*D operations) or dK and dV (8 *) written
// once (chip_smoke.py flash_bwd_bound), in us, dQ / dK-dV:
//   (64, 12, 41, 64)  f32   12.1 / 14.5 (bytes)
//   (64, 12, 41, 64)  bf16   6.1 /  7.3 (bytes)
//   (2, 12, 1024, 64) bf16   9.8 / 13.0 (operations)
//   (1, 4, 2049, 64)  f32     96 /  128 (operations)
//
// Design.  The TPU grids carry an accumulator across a sequential grid axis;
// Hopper blocks run in any order, so a block owns 64-row tiles of its output
// (no atomics: the result is the same from run to run) and walks the other
// side of the head in 64-row tiles held in a shared-memory ring.  f32: a
// 2-stage ring, tile j+1 copied with cp.async (16-byte copies that zero-fill
// rows >= T and columns >= D; 4-byte copies for the walked tile's lse and
// delta) while tile j is computed.  bf16 with rows of a multiple of 16 bytes
// in 16-byte aligned arrays (every call of the training paths): the
// warp-specialised kernels below, fed by TMA.  Other bf16 calls: the same
// products in the same order, every thread staging the walked tiles with
// scalar loads (bwd_dq_bf16, bwd_dkv_bf16); other f32 calls: the f32
// kernels' scalar-load branch.  The owned tile covers a whole 41-row training
// head, so the head's other side is read once.
//   bf16, on wgmma: a warpgroup (4 warps) owns 64 output rows; a block of two
//   warpgroups (128 rows) shares each walked tile unless that leaves more rows
//   on the busiest SM (the forward's rule).  Tiles sit in the 128-byte swizzle
//   (64-column panels), so one layout serves the K-major reads of a product's
//   operand and the MN-major reads of the same tile as the B of the next.
//     dQ: S = Q K^T and dP = dO V^T from shared memory (SS), then p, the key
//     mask, the dropout mask and dS on the accumulator fragments (each thread
//     its own (qpos, kpos); a row's lse and delta in registers), and
//     dQ += dS K with dS rounded to bf16 in registers (RS, K MN-major).
//     dK/dV: S^T = K Q^T and dP^T = V dO^T (SS); on the fragments a thread's
//     columns are queries, so lse and delta come from the staged tile; then
//     dV += P_eff^T dO and dK += dS^T Q (RS, dO and Q MN-major).
//   The two score products are issued together and p is formed while the
//   second runs.  dK is scaled, both outputs staged through the owned tiles'
//   shared memory and stored 16 bytes per thread.
//   Warp specialisation (bwd_dq_bf16_ws, bwd_dkv_bf16_ws): NW/4 consumer
//   warpgroups and one producer warpgroup.  The producer's first thread loads
//   the owned tiles once and each walked tile by TMA from 3-D tensor maps
//   (d, t, rows: boxes of 64 columns x 64 rows of one head row, written in
//   the 128-byte swizzle the descriptors read; coordinates past t or d read
//   zeros, and never the next head's rows) into a ring of S stages, as deep
//   as fits the block's share of the SM (up to 8: at 8 warps 5 stages for dQ
//   and 4 for dK/dV at D 128, 8 at D 64).  Each stage has a full mbarrier
//   (the TMA's bytes; for dK/dV also the producer warp's 32 lanes, whose
//   4-byte cp.asyncs copy the tile's lse and delta, zeros past t) and an
//   empty one (an arrival a consumer warpgroup).  The producer fetches the
//   four maps at the block's start.  setmaxnreg leaves the producer 24
//   registers and gives the consumers 240 (8 warps: 384 threads entering at
//   168) or 232 (4 warps, two blocks an SM).  The consumers meet at no block
//   barrier: a warpgroup issues a tile's two score products in its turn
//   (named barriers 1 and 2, warpgroup 0 first), so the other warpgroup's
//   products run while this one forms p and dS, and it frees the stage once
//   its last product of the tile is in.  Every output element sums the same
//   k16 products in the same order as the scalar-load kernels: the same bits.
//   (Issuing a tile's last products and the next tile's score products as
//   one turn, without a wait between, was slower at every probe shape and
//   spilled dK/dV's registers at D 128.)  Reached on the H100 SXM (700 W),
//   share of the FLOP bound, dQ / dK-dV (tools/flash_band_probe.py, bf16):
//   q (2, 32, 8192, 128), k, v (2, 4, 8192, 128) causal 0.46 / 0.42 (0.38 /
//   0.40 when every thread copied the walked tiles by cp.async), window
//   2,047 0.43 / 0.36 (0.36 / 0.34); (2, 12, 2048, 64) bidirectional 0.26 /
//   0.25 (0.27 / 0.25): the 32-tile walks there pay each block's prologue.
//   f32, on the CUDA cores: 256 threads over 64 x 64 score tiles, each a 4 x 4
//   block (rows ty + 16i, columns tx + 16jj) of outer products from float4
//   reads (row pitch D + 4: conflict-free); the same tiling forms dpv.  dS
//   (and p_eff) go through shared memory into a second register-tiled
//   product, 4 rows x 4 columns per 64 of D.  A head of at most 48 rows takes
//   48-row tiles (3 x 3 per thread), so a 41-row head computes 9 of the 16
//   groups of 16 x 16 scores.  A walk of one tile allocates one stage, so a
//   41-row head leaves room for two blocks per SM; dK/dV at D > 64 keeps one
//   stage (two would not fit in 227 KB) and loads the next tile after the
//   current one is consumed.
// What this does about the old design's limits: the bf16 products left the
// CUDA cores for the tensor cores; no product reads shared memory per FMA
// (wgmma reads its operands through descriptors; f32 does 64 FMAs per 8
// float4 reads); the second product takes dS and P_eff from the accumulator
// fragments (bf16) or as float4 rows (f32) instead of a shuffle per key;
// 64-row tiles replace 16-row blocks of serial rows, so a T = 1024 head stages
// each walked tile 16 times, not 64; cp.async double-buffers the f32 walk;
// and in bf16 the loads left the consumers' issue slots and registers for a
// producer warp and TMA, and the two warpgroups no longer wait for each other
// at every tile.
// Band and grouped KV heads (flash_mask.cuh), as the forward: dQ walks the key
// tiles that meet its rows' band; dK/dV owns a KV head's key tile and walks,
// for each query head of its group in turn, the query tiles that meet the band
// (one ring across the group's heads), so the group's sum stays in the
// accumulators: no atomics, the same bits every run, no expanded k/v or
// per-head dK/dV in memory.  Masked elements of the tiles across the band's
// edge get p = 0.  f32 takes the band as a template argument (the unbanded
// kernels are the ones from before the band).
// Left for later: one fused dQ + dK/dV pass, 8 x 8 f32 register tiles,
// 3xTF32 split products for f32.
#include <cuda.h>   // CUtensorMap and its enums; the encoder comes through the runtime

#include "hopper.cuh"
#include "flash_mask.cuh"

namespace {

constexpr int kBlock = 64;                // rows of a walked tile; a warpgroup's rows
constexpr int kF32Threads = 256;          // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kPPitch = kBlock + 16;      // dS / p_eff row pitch: the two rows a
                                          // warp writes land 16 banks apart

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;                               // the dQ kernels' output
  void* dk;                               // the dK/dV kernels' outputs
  void* dv;
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

// query row g of KV row kvbh's group
__device__ __forceinline__ int group_row(const Params& p, int kvbh, int g) {
  const int grp = p.heads / p.kv_heads;
  return (kvbh / p.kv_heads) * p.heads + (kvbh % p.kv_heads) * grp + g;
}

__device__ __forceinline__ bool kept(const Params& p, uint32_t seed, int bh, int qpos,
                                     int kpos) {
  return (dropout_hash(seed, p.bh_offset + bh, qpos, kpos) & 0xFFFFFFu) >= p.thresh;
}

// 4-byte global -> shared copy; src_bytes 0 writes a zero and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// lse and delta of queries [q0, q0 + ROWS) into rows_s[0, ROWS) and
// [ROWS, 2 ROWS), zeros past t (threads 0 .. 2 ROWS - 1)
template <int ROWS>
__device__ __forceinline__ void load_lse_delta(float* rows_s, const Params& p, size_t row_base,
                                               int q0, int t, int tid) {
  if (tid < 2 * ROWS) {
    const int r = tid < ROWS ? tid : tid - ROWS;
    const bool ok = q0 + r < t;
    const float* src = (tid < ROWS ? p.lse : p.delta) + row_base;
    cp_async4(rows_s + tid, ok ? src + q0 + r : src, ok ? 4 : 0);
  }
}

// number of ring stages: one when the walk is a single tile (a head of at
// most one tile, walked by itself: grp, the query heads walked, is 1)
__host__ __device__ __forceinline__ int ring_stages(int t, int grp, bool two_fit) {
  return ((t > kBlock || grp > 1) && two_fit) ? 2 : 1;
}

// ---------------------------------------------------------------- bf16 path

// the warp's 16 output rows x DP of acc (times mul) into its rows of a
// swizzled tile, then stored 16 bytes per thread to rows [r_base, r_base + 16)
template <int ROWS, int DP, bool ALIGNED>
__device__ __forceinline__ void store_rows_bf16(bf16* s, float (&acc)[DP / 64][32], float mul,
                                                bf16* og, int r_base, int t, int d, int warp,
                                                int lane) {
  constexpr int CH = DP / 8;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int pn = 0; pn < DP / 64; ++pn)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      *reinterpret_cast<uint32_t*>(s + swz<ROWS>(warp * 16 + g + 8 * h, 8 * pn + (i >> 2)) +
                                   2 * tq) = pack_bf16(acc[pn][i] * mul, acc[pn][i + 1] * mul);
    }
  __syncwarp();
  if (ALIGNED) {
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = i - r * CH;
      if (r_base + r < t && c * 8 < d)
        *reinterpret_cast<uint4*>(og + static_cast<size_t>(r_base + r) * d + c * 8) =
            *reinterpret_cast<const uint4*>(s + swz<ROWS>(warp * 16 + r, c));
    }
  } else {
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = i / DP, c = i - r * DP;
      if (r_base + r < t && c < d)
        og[static_cast<size_t>(r_base + r) * d + c] = s[swz<ROWS>(warp * 16 + r, c >> 3) + (c & 7)];
    }
  }
}

// kernel #3, bf16, for unaligned rows (scalar loads): NW warps = NW/4
// warpgroups of 64 query rows; DP = D padded to 64 or 128.  Shared: Q, dO
// [BQ][DP]; the ring [stages][K, V][64][DP].
template <int NW, int DP>
__global__ void __launch_bounds__(NW * 32, 1)
bwd_dq_bf16(const Params p) {
  constexpr bool ALIGNED = false;
  constexpr int BQ = 16 * NW;             // query rows per block
  constexpr int NT = 32 * NW;
  constexpr int KS = DP / 16;             // k16 steps over D
  constexpr int NP = DP / 64;             // 64-column panels
  constexpr uint32_t kPanelQ = BQ * 128, kPanelK = kBlock * 128;   // bytes
  extern __shared__ uint4 smem_u4[];
  const uint32_t raw = smem_u32(smem_u4);  // the swizzle follows the address:
  bf16* q_s = reinterpret_cast<bf16*>(     // tiles start 1024-byte aligned
      reinterpret_cast<char*>(smem_u4) + (((raw + 1023u) & ~1023u) - raw));
  bf16* do_s = q_s + BQ * DP;
  bf16* kv_s = do_s + BQ * DP;

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
  const bf16* kg = static_cast<const bf16*>(p.k) + kv_base;
  const bf16* vg = static_cast<const bf16*>(p.v) + kv_base;
  int j0, j1;                             // the key tiles the block's band meets
  key_tiles(p.causal, p.window, q0, q0 + BQ, t, kBlock, &j0, &j1);
  const int row0 = q0 + warp * 16 + g;    // this thread's rows: row0, row0 + 8
  const uint32_t wg_rows = (warp >> 2) * 64 * 128;
  const uint32_t q_addr = smem_u32(q_s) + wg_rows, do_addr = smem_u32(do_s) + wg_rows;

  load_tile_bf16<BQ, DP, ALIGNED>(q_s, static_cast<const bf16*>(p.q) + base, q0, t, d, tid, NT);
  load_tile_bf16<BQ, DP, ALIGNED>(do_s, static_cast<const bf16*>(p.dout) + base, q0, t, d,
                                  tid, NT);
  load_tile_bf16<kBlock, DP, ALIGNED>(kv_s, kg, j0 * kBlock, t, d, tid, NT);
  load_tile_bf16<kBlock, DP, ALIGNED>(kv_s + kBlock * DP, vg, j0 * kBlock, t, d, tid, NT);
  cp_async_commit();

  // the rows' lse in base 2 and delta (0 past t: those rows are not stored)
  const float sl2 = p.scale * kLog2e;
  float nl[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t at = static_cast<size_t>(bh) * t + row0 + 8 * h;
    nl[h] = row0 + 8 * h < t ? -p.lse[at] * kLog2e : 0.f;
    dl[h] = row0 + 8 * h < t ? p.delta[at] : 0.f;
  }

  float acc[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    cp_async_wait<0>();                   // tile j has landed
    fence_proxy_async();
    __syncthreads();                      // ... for all; tile j-1 is consumed
    if (j + 1 < j1) {                     // tile j+1 loads while tile j computes
      bf16* nxt = kv_s + (st ^ 1) * 2 * kBlock * DP;
      load_tile_bf16<kBlock, DP, ALIGNED>(nxt, kg, (j + 1) * kBlock, t, d, tid, NT);
      load_tile_bf16<kBlock, DP, ALIGNED>(nxt + kBlock * DP, vg, (j + 1) * kBlock, t, d, tid, NT);
      cp_async_commit();
    }
    const uint32_t k_addr = smem_u32(kv_s + st * 2 * kBlock * DP);
    const uint32_t v_addr = k_addr + kBlock * DP * 2;

    // S = Q K^T and dP = dO V^T for the warpgroup's 64 rows x 64 keys; a k16
    // step advances 32 bytes along a 128-byte row, then to the next panel
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(s, gmma_desc(q_addr + (kk >> 2) * kPanelQ + (kk & 3) * 32, 16, 1024),
               gmma_desc(k_addr + (kk >> 2) * kPanelK + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(dp, gmma_desc(do_addr + (kk >> 2) * kPanelQ + (kk & 3) * 32, 16, 1024),
               gmma_desc(v_addr + (kk >> 2) * kPanelK + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait_n<1>();                    // S is in; dP still runs
    fence_regs(s);

    // p on the fragments: s[4nb + e] is (row0 + 8(e/2), key k0 + 8nb + 2tq + e%2)
    const int k0 = j * kBlock;
    const bool edge = band && !interior(p.causal, p.window, q0, BQ, k0, kBlock);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = exp2_ftz(fmaf(s[i], sl2, nl[(i >> 1) & 1]));
      const int kpos = k0 + (i >> 2) * 8 + 2 * tq + (i & 1);
      if (k0 + kBlock > t && kpos >= t) x = 0.f;
      if (edge && !visible(p.causal, p.window, row0 + 8 * ((i >> 1) & 1), kpos)) x = 0.f;
      s[i] = x;
    }
    wgmma_wait();
    fence_regs(dp);

    // dS = p (dpv - delta), the dropout mask on dpv; rounded to bf16 it is
    // the A operand of dQ += dS K: k16 step kk takes s[8kk .. 8kk + 7] in pairs
    uint32_t da[kBlock / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * kk + 2 * a + e;
          float dpv = dp[i];
          if (p.use_dropout)
            dpv = kept(p, seed, bh, row0 + 8 * (a & 1), k0 + (i >> 2) * 8 + 2 * tq + e)
                      ? dpv * p.inv_keep : 0.f;
          ds[e] = s[i] * (dpv - dl[a & 1]);
        }
        da[kk][a] = pack_bf16(ds[0], ds[1]);
      }
    fence_regs(da);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) fence_regs(acc[pn]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk)
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)   // K (keys x D) as B, MN-major: 2048 bytes per k16
        wgmma_rs(acc[pn], da[kk], gmma_desc(k_addr + pn * kPanelK + kk * 2048, kPanelK, 1024));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) fence_regs(acc[pn]);
    fence_regs(da);
  }

  __syncthreads();                        // every warpgroup's reads of Q are done
  store_rows_bf16<BQ, DP, ALIGNED>(q_s, acc, p.scale, static_cast<bf16*>(p.dq) + base,
                                   q0 + warp * 16, t, d, warp, lane);
}

// kernel #4, bf16, for unaligned rows: NW/4 warpgroups of 64 keys.  Shared:
// K, V [BK][DP]; the ring [stages][Q, dO][64][DP]; then [stages][lse,
// delta][64] f32.
template <int NW, int DP>
__global__ void __launch_bounds__(NW * 32, 1)
bwd_dkv_bf16(const Params p) {
  constexpr bool ALIGNED = false;
  constexpr int BK = 16 * NW;             // keys per block
  constexpr int NT = 32 * NW;
  constexpr int KS = DP / 16;
  constexpr int NP = DP / 64;
  constexpr uint32_t kPanelK = BK * 128, kPanelQ = kBlock * 128;   // bytes
  extern __shared__ uint4 smem_u4[];
  const uint32_t raw = smem_u32(smem_u4);
  bf16* k_s = reinterpret_cast<bf16*>(
      reinterpret_cast<char*>(smem_u4) + (((raw + 1023u) & ~1023u) - raw));
  bf16* v_s = k_s + BK * DP;
  bf16* qd_s = v_s + BK * DP;

  const int t = p.t, d = p.d;
  const uint32_t seed = kernel_seed(p.use_dropout, p.seed, p.seed_dev);
  const int n_ktiles = (t + BK - 1) / BK;
  const bool band = banded(p.causal, p.window);
  int kvbh, kt;                           // a KV row: its group's query rows are walked
  block_tile(gridDim.x / n_ktiles, n_ktiles, band, false, &kvbh, &kt);
  const int k0 = kt * BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const size_t base = static_cast<size_t>(kvbh) * t * d;
  int i0, i1;                             // the query tiles the block's band meets
  query_tiles(p.causal, p.window, k0, k0 + BK, t, kBlock, &i0, &i1);
  const int n_band = i1 - i0;
  const int n_walk = (p.heads / p.kv_heads) * n_band;   // every query row of the group
  // walked tile w: query row group_row(w / n_band), queries from (i0 + w % n_band) * 64
  auto walk_row = [&](int w) { return group_row(p, kvbh, w / n_band); };
  auto walk_q0 = [&](int w) { return (i0 + w % n_band) * kBlock; };
  auto load_walk = [&](bf16* dst, float* rows, int w) {
    const size_t qb = static_cast<size_t>(walk_row(w)) * t;
    const int q1 = walk_q0(w);
    load_tile_bf16<kBlock, DP, ALIGNED>(dst, static_cast<const bf16*>(p.q) + qb * d, q1, t, d,
                                        tid, NT);
    load_tile_bf16<kBlock, DP, ALIGNED>(dst + kBlock * DP, static_cast<const bf16*>(p.dout) +
                                        qb * d, q1, t, d, tid, NT);
    load_lse_delta<kBlock>(rows, p, qb, q1, t, tid);
  };
  float* rows_s = reinterpret_cast<float*>(qd_s + ring_stages(t, p.heads / p.kv_heads, true) * 2 * kBlock * DP);
  const int key0 = k0 + warp * 16 + g;    // this thread's keys: key0, key0 + 8
  const uint32_t wg_rows = (warp >> 2) * 64 * 128;
  const uint32_t k_addr = smem_u32(k_s) + wg_rows, v_addr = smem_u32(v_s) + wg_rows;

  load_tile_bf16<BK, DP, ALIGNED>(k_s, static_cast<const bf16*>(p.k) + base, k0, t, d, tid, NT);
  load_tile_bf16<BK, DP, ALIGNED>(v_s, static_cast<const bf16*>(p.v) + base, k0, t, d, tid, NT);
  load_walk(qd_s, rows_s, 0);
  cp_async_commit();

  const float sl2 = p.scale * kLog2e;
  float acc_k[NP][32], acc_v[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[pn][i] = acc_v[pn][i] = 0.f;

  for (int j = 0; j < n_walk; ++j) {
    const int st = j & 1;
    cp_async_wait<0>();                   // tile j has landed
    fence_proxy_async();
    __syncthreads();                      // ... for all; tile j-1 is consumed
    if (j + 1 < n_walk) {                 // tile j+1 loads while tile j computes
      load_walk(qd_s + (st ^ 1) * 2 * kBlock * DP, rows_s + (st ^ 1) * 2 * kBlock, j + 1);
      cp_async_commit();
    }
    const int bh = walk_row(j);           // the walked query row (its dropout masks)
    const uint32_t q_addr = smem_u32(qd_s + st * 2 * kBlock * DP);
    const uint32_t do_addr = q_addr + kBlock * DP * 2;
    const float* lse_s = rows_s + st * 2 * kBlock;
    const float* dl_s = lse_s + kBlock;

    // S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys x 64 queries
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(s, gmma_desc(k_addr + (kk >> 2) * kPanelK + (kk & 3) * 32, 16, 1024),
               gmma_desc(q_addr + (kk >> 2) * kPanelQ + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(dp, gmma_desc(v_addr + (kk >> 2) * kPanelK + (kk & 3) * 32, 16, 1024),
               gmma_desc(do_addr + (kk >> 2) * kPanelQ + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait_n<1>();
    fence_regs(s);

    // p on the fragments: s[4nb + e] is (key key0 + 8(e/2), query
    // q0 + 8nb + 2tq + e%2), so lse and delta are per column; queries >= t
    // contribute 0
    const int q0 = walk_q0(j);
    const bool edge = band && !interior(p.causal, p.window, q0, kBlock, k0, BK);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = (i >> 2) * 8 + 2 * tq + (i & 1);
      float x = exp2_ftz(fmaf(s[i], sl2, -lse_s[c] * kLog2e));
      if (q0 + kBlock > t && q0 + c >= t) x = 0.f;
      if (edge && !visible(p.causal, p.window, q0 + c, key0 + 8 * ((i >> 1) & 1))) x = 0.f;
      s[i] = x;
    }
    wgmma_wait();
    fence_regs(dp);

    // P_eff^T and dS^T in bf16 pairs: the A operands of dV += P_eff^T dO and
    // dK += dS^T Q
    uint32_t pa[kBlock / 16][4], da[kBlock / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float pe[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * kk + 2 * a + e;
          const int c = (i >> 2) * 8 + 2 * tq + e;
          float dpv = dp[i];
          pe[e] = s[i];
          if (p.use_dropout) {
            const bool keep = kept(p, seed, bh, q0 + c, key0 + 8 * (a & 1));
            pe[e] = keep ? s[i] * p.inv_keep : 0.f;
            dpv = keep ? dpv * p.inv_keep : 0.f;
          }
          ds[e] = s[i] * (dpv - dl_s[c]);
        }
        pa[kk][a] = pack_bf16(pe[0], pe[1]);
        da[kk][a] = pack_bf16(ds[0], ds[1]);
      }
    fence_regs(pa);
    fence_regs(da);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      fence_regs(acc_k[pn]);
      fence_regs(acc_v[pn]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk)
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {   // dO and Q (queries x D) as B, MN-major
        wgmma_rs(acc_v[pn], pa[kk], gmma_desc(do_addr + pn * kPanelQ + kk * 2048, kPanelQ, 1024));
        wgmma_rs(acc_k[pn], da[kk], gmma_desc(q_addr + pn * kPanelQ + kk * 2048, kPanelQ, 1024));
      }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      fence_regs(acc_k[pn]);
      fence_regs(acc_v[pn]);
    }
    fence_regs(pa);
    fence_regs(da);
  }

  __syncthreads();                        // every warpgroup's reads of K and V are done
  store_rows_bf16<BK, DP, ALIGNED>(k_s, acc_k, p.scale, static_cast<bf16*>(p.dk) + base,
                                   k0 + warp * 16, t, d, warp, lane);
  store_rows_bf16<BK, DP, ALIGNED>(v_s, acc_v, 1.f, static_cast<bf16*>(p.dv) + base,
                                   k0 + warp * 16, t, d, warp, lane);
}

// ------------------------------------------- bf16 path, warp-specialised

// q, k, v and dout as (rows, t, d) bf16 tensor maps read in boxes of 64
// columns x 64 rows of one head, written in the 128-byte swizzle
struct TileMaps {
  CUtensorMap q, k, v, dout;
};

// the four maps fetched ahead of the first loads (at the block's start)
__device__ __forceinline__ void prefetch_maps(const TileMaps& m) {
  prefetch_tensormap(&m.q);
  prefetch_tensormap(&m.k);
  prefetch_tensormap(&m.v);
  prefetch_tensormap(&m.dout);
}

constexpr int kMaxStages = 8;             // the ring's deepest
constexpr int kTurnBar = 1;               // named barriers 1, 2: warpgroup 0's, 1's turn

// dynamic shared memory of a warp-specialised block with `stages` ring
// stages: 1024 bytes of alignment slack; the owned tiles (2 x rows x DP
// bf16); each stage's two walked tiles (2 x 64 x DP bf16) and for dK/dV its
// lse and delta (2 x 64 f32); the full and empty mbarrier of each stage and
// the owned tiles' mbarrier
__host__ __device__ constexpr int ws_smem(int nw, int dp, bool dkv, int stages) {
  return 1024 + 2 * 16 * nw * dp * 2 + stages * (2 * kBlock * dp * 2 + (dkv ? 2 * kBlock * 4 : 0)) +
         (2 * stages + 1) * 8;
}

// the ring's depth: as many stages as fit the block's share of an SM, the
// 227 KB a block may use at 8 warps (one block an SM), half an SM's 228 KB
// less the 1 KB reserved a block at 4 warps (two blocks an SM)
__host__ __device__ constexpr int ws_stages(int nw, int dp, bool dkv) {
  int s = kMaxStages;
  while (s > 1 && ws_smem(nw, dp, dkv, s) > (nw == 8 ? 232448 : 233472 / 2 - 1024)) --s;
  return s;
}

// the consumers' registers after the producer warpgroup gives up its own
// (24 a thread): 8 warps, 384 threads entering at 168 each; 4 warps, 256
// threads entering at 128 each, two blocks an SM
template <int NW> __device__ __forceinline__ void consumer_regs() {
  if constexpr (NW == 8) setmaxnreg_inc<240>();
  else setmaxnreg_inc<232>();
}

// the owned tile (rows r0 .. r0 + 16 NW of head row `head`) of `map` into
// shared memory at s, one box a warpgroup's 64 rows and 64-column panel
template <int NW, int DP>
__device__ __forceinline__ void tma_owned(bf16* s, const CUtensorMap& map, uint64_t* bar, int r0,
                                          int head) {
#pragma unroll
  for (int pn = 0; pn < DP / 64; ++pn)
#pragma unroll
    for (int h = 0; h < NW / 4; ++h)
      tma_load_3d(s + pn * 16 * NW * 64 + h * 64 * 64, &map, bar, 64 * pn, r0 + 64 * h, head);
}

// a walked tile (rows r0 .. r0 + 64 of head row `head`) into s
template <int DP>
__device__ __forceinline__ void tma_walked(bf16* s, const CUtensorMap& map, uint64_t* bar, int r0,
                                           int head) {
#pragma unroll
  for (int pn = 0; pn < DP / 64; ++pn)
    tma_load_3d(s + pn * kBlock * 64, &map, bar, 64 * pn, r0, head);
}

// the two score products of a walked tile for the warpgroup's 64 rows x 64
// columns, each committed as a group (the first first): s = A0 B0^T and
// dp = A1 B1^T, every operand K-major in the 128-byte swizzle (a k16 step
// advances 32 bytes along a 128-byte row, then to the next panel)
template <int DP, uint32_t PANEL_A, uint32_t PANEL_B>
__device__ __forceinline__ void score_products(float (&s)[32], float (&dp)[32], uint32_t a0,
                                               uint32_t b0, uint32_t a1, uint32_t b1) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss(s, gmma_desc(a0 + (kk >> 2) * PANEL_A + (kk & 3) * 32, 16, 1024),
             gmma_desc(b0 + (kk >> 2) * PANEL_B + (kk & 3) * 32, 16, 1024), kk > 0);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss(dp, gmma_desc(a1 + (kk >> 2) * PANEL_A + (kk & 3) * 32, 16, 1024),
             gmma_desc(b1 + (kk >> 2) * PANEL_B + (kk & 3) * 32, 16, 1024), kk > 0);
  wgmma_commit();
}

// kernel #3, bf16, warp-specialised: NW/4 consumer warpgroups of 64 query
// rows (warps 0 .. NW - 1), then a producer warpgroup whose first thread
// loads Q and dO once and the walked K and V tiles into a ring of stages,
// each with a full and an empty mbarrier.  The products and their order are
// bwd_dq_bf16's.  Shared: Q, dO [BQ][DP]; the ring [S][K, V][64][DP]; the
// mbarriers.
template <int NW, int DP>
__global__ void __launch_bounds__(NW * 32 + 128, NW == 8 ? 1 : 2)
bwd_dq_bf16_ws(const __grid_constant__ Params p, const __grid_constant__ TileMaps m) {
  constexpr int BQ = 16 * NW;
  constexpr int NC = 32 * NW;             // consumer threads
  constexpr int NP = DP / 64;
  constexpr int S = ws_stages(NW, DP, false);
  constexpr uint32_t kPanelQ = BQ * 128, kPanelK = kBlock * 128;   // bytes
  constexpr uint32_t kTile = kBlock * DP * 2;                        // a walked tile's bytes
  extern __shared__ uint4 smem_u4[];
  const uint32_t raw = smem_u32(smem_u4);
  bf16* q_s = reinterpret_cast<bf16*>(
      reinterpret_cast<char*>(smem_u4) + (((raw + 1023u) & ~1023u) - raw));
  bf16* do_s = q_s + BQ * DP;
  bf16* kv_s = do_s + BQ * DP;
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + S * 2 * kBlock * DP);
  uint64_t* empty = full + S;
  uint64_t* owned = empty + S;

  const int t = p.t, d = p.d;
  const int n_qtiles = (t + BQ - 1) / BQ;
  const bool band = banded(p.causal, p.window);
  int bh, qt;
  block_tile(gridDim.x / n_qtiles, n_qtiles, band, p.causal, &bh, &qt);
  const int q0 = qt * BQ;
  int j0, j1;                             // the key tiles the block's band meets
  key_tiles(p.causal, p.window, q0, q0 + BQ, t, kBlock, &j0, &j1);
  const int tid = threadIdx.x;

  if (tid == NC) {
    prefetch_maps(m);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NW / 4);       // one arrival a consumer warpgroup
    }
    mbar_init(owned, 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  if (tid >= NC) {                        // the producer warpgroup
    setmaxnreg_dec<24>();
    if (tid == NC) {
      const int kvr = kv_row(bh, p.heads, p.kv_heads);
      mbar_arrive_expect_tx(owned, 2 * BQ * DP * 2);
      tma_owned<NW, DP>(q_s, m.q, owned, q0, bh);
      tma_owned<NW, DP>(do_s, m.dout, owned, q0, bh);
      int st = 0;
      uint32_t ph = 0;
      for (int j = j0; j < j1; ++j) {
        if (j - j0 >= S) mbar_wait(&empty[st], ph ^ 1);   // stage st's last tile is consumed
        bf16* dst = kv_s + st * 2 * kBlock * DP;
        mbar_arrive_expect_tx(&full[st], 2 * kTile);
        tma_walked<DP>(dst, m.k, &full[st], j * kBlock, kvr);
        tma_walked<DP>(dst + kBlock * DP, m.v, &full[st], j * kBlock, kvr);
        if (++st == S) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {                                // the consumer warpgroups
    consumer_regs<NW>();
    const uint32_t seed = kernel_seed(p.use_dropout, p.seed, p.seed_dev);
    const int lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
    const int g = lane >> 2, tq = lane & 3;
    const size_t base = static_cast<size_t>(bh) * t * d;
    const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
    const uint32_t wg_rows = wg * 64 * 128;
    const uint32_t q_addr = smem_u32(q_s) + wg_rows, do_addr = smem_u32(do_s) + wg_rows;

    const float sl2 = p.scale * kLog2e;
    float nl[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = static_cast<size_t>(bh) * t + row0 + 8 * h;
      nl[h] = row0 + 8 * h < t ? -p.lse[at] * kLog2e : 0.f;
      dl[h] = row0 + 8 * h < t ? p.delta[at] : 0.f;
    }
    float acc[NP][32];
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;

    if (NW == 8 && wg == 1) named_arrive(kTurnBar, 256);   // warpgroup 0 goes first
    mbar_wait(owned, 0);
    int st = 0;
    uint32_t ph = 0;
    for (int j = j0; j < j1; ++j) {
      mbar_wait(&full[st], ph);           // tile j has landed
      const uint32_t k_addr = smem_u32(kv_s + st * 2 * kBlock * DP);
      const uint32_t v_addr = k_addr + kBlock * DP * 2;

      // S = Q K^T and dP = dO V^T, issued in this warpgroup's turn; the other
      // warpgroup's turn follows, so its products run while this one forms dS
      float s[32], dp[32];
      if (NW == 8) named_sync(kTurnBar + wg, 256);
      wgmma_fence();
      score_products<DP, kPanelQ, kPanelK>(s, dp, q_addr, k_addr, do_addr, v_addr);
      if (NW == 8 && (wg == 0 || j + 1 < j1)) named_arrive(kTurnBar + (wg ^ 1), 256);
      wgmma_wait_n<1>();
      fence_regs(s);

      const int k0 = j * kBlock;
      const bool edge = band && !interior(p.causal, p.window, q0, BQ, k0, kBlock);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = exp2_ftz(fmaf(s[i], sl2, nl[(i >> 1) & 1]));
        const int kpos = k0 + (i >> 2) * 8 + 2 * tq + (i & 1);
        if (k0 + kBlock > t && kpos >= t) x = 0.f;
        if (edge && !visible(p.causal, p.window, row0 + 8 * ((i >> 1) & 1), kpos)) x = 0.f;
        s[i] = x;
      }
      wgmma_wait();
      fence_regs(dp);

      uint32_t da[kBlock / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * kk + 2 * a + e;
            float dpv = dp[i];
            if (p.use_dropout)
              dpv = kept(p, seed, bh, row0 + 8 * (a & 1), k0 + (i >> 2) * 8 + 2 * tq + e)
                        ? dpv * p.inv_keep : 0.f;
            ds[e] = s[i] * (dpv - dl[a & 1]);
          }
          da[kk][a] = pack_bf16(ds[0], ds[1]);
        }
      fence_regs(da);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) fence_regs(acc[pn]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
#pragma unroll
        for (int pn = 0; pn < NP; ++pn)
          wgmma_rs(acc[pn], da[kk], gmma_desc(k_addr + pn * kPanelK + kk * 2048, kPanelK, 1024));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) fence_regs(acc[pn]);
      fence_regs(da);
      if ((tid & 127) == 0) mbar_arrive(&empty[st]);   // this warpgroup is done with it
      if (++st == S) {
        st = 0;
        ph ^= 1;
      }
    }
    // each warp stages its own rows of Q, which only its warpgroup read
    store_rows_bf16<BQ, DP, true>(q_s, acc, p.scale, static_cast<bf16*>(p.dq) + base,
                                  q0 + warp * 16, t, d, warp, lane);
  }
}

// kernel #4, bf16, warp-specialised: NW/4 consumer warpgroups of 64 keys,
// then a producer warpgroup whose first warp loads K and V once and walks the
// group's query heads, then their band's query tiles, into the ring: Q and dO
// by TMA from its first thread, the tile's lse and delta by 4-byte cp.async
// from each of its 32 lanes (zeros past t), each lane's copies counted on the
// stage's full mbarrier (1 + 32 arrivals).  The products and their order are
// bwd_dkv_bf16's.  Shared: K, V [BK][DP]; the ring [S][Q, dO][64][DP]; then
// [S][lse, delta][64] f32; the mbarriers.
template <int NW, int DP>
__global__ void __launch_bounds__(NW * 32 + 128, NW == 8 ? 1 : 2)
bwd_dkv_bf16_ws(const __grid_constant__ Params p, const __grid_constant__ TileMaps m) {
  constexpr int BK = 16 * NW;
  constexpr int NC = 32 * NW;
  constexpr int NP = DP / 64;
  constexpr int S = ws_stages(NW, DP, true);
  constexpr uint32_t kPanelK = BK * 128, kPanelQ = kBlock * 128;
  constexpr uint32_t kTile = kBlock * DP * 2;
  extern __shared__ uint4 smem_u4[];
  const uint32_t raw = smem_u32(smem_u4);
  bf16* k_s = reinterpret_cast<bf16*>(
      reinterpret_cast<char*>(smem_u4) + (((raw + 1023u) & ~1023u) - raw));
  bf16* v_s = k_s + BK * DP;
  bf16* qd_s = v_s + BK * DP;
  float* rows_s = reinterpret_cast<float*>(qd_s + S * 2 * kBlock * DP);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_s + S * 2 * kBlock);
  uint64_t* empty = full + S;
  uint64_t* owned = empty + S;

  const int t = p.t, d = p.d;
  const int n_ktiles = (t + BK - 1) / BK;
  const bool band = banded(p.causal, p.window);
  int kvbh, kt;
  block_tile(gridDim.x / n_ktiles, n_ktiles, band, false, &kvbh, &kt);
  const int k0 = kt * BK;
  int i0, i1;
  query_tiles(p.causal, p.window, k0, k0 + BK, t, kBlock, &i0, &i1);
  const int n_band = i1 - i0;
  const int n_walk = (p.heads / p.kv_heads) * n_band;
  // walked tile w: query row group_row(w / n_band), queries from (i0 + w % n_band) * 64
  auto walk_row = [&](int w) { return group_row(p, kvbh, w / n_band); };
  auto walk_q0 = [&](int w) { return (i0 + w % n_band) * kBlock; };
  const int tid = threadIdx.x;

  if (tid == NC) {
    prefetch_maps(m);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1 + 32);        // the TMA's expect-tx, each lane's cp.asyncs
      mbar_init(&empty[s], NW / 4);
    }
    mbar_init(owned, 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  if (tid >= NC) {
    setmaxnreg_dec<24>();
    if (tid < NC + 32) {                  // the producer warp
      const int lane = tid - NC;
      if (lane == 0) {
        mbar_arrive_expect_tx(owned, 2 * BK * DP * 2);
        tma_owned<NW, DP>(k_s, m.k, owned, k0, kvbh);
        tma_owned<NW, DP>(v_s, m.v, owned, k0, kvbh);
      }
      int st = 0;
      uint32_t ph = 0;
      for (int w = 0; w < n_walk; ++w) {
        if (w >= S) mbar_wait(&empty[st], ph ^ 1);
        const int qr = walk_row(w), q1 = walk_q0(w);
        if (lane == 0) {
          bf16* dst = qd_s + st * 2 * kBlock * DP;
          mbar_arrive_expect_tx(&full[st], 2 * kTile);
          tma_walked<DP>(dst, m.q, &full[st], q1, qr);
          tma_walked<DP>(dst + kBlock * DP, m.dout, &full[st], q1, qr);
        }
        float* rows = rows_s + st * 2 * kBlock;
        const size_t qb = static_cast<size_t>(qr) * t;
#pragma unroll
        for (int i = 0; i < 4; ++i) {     // [lse, delta][64]: 4 a lane
          const int at = lane + 32 * i, r = at & (kBlock - 1);
          const bool ok = q1 + r < t;
          const float* src = (at < kBlock ? p.lse : p.delta) + qb;
          cp_async4(rows + at, ok ? src + q1 + r : src, ok ? 4 : 0);
        }
        cp_async_mbar_arrive(&full[st]);
        if (++st == S) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    consumer_regs<NW>();
    const uint32_t seed = kernel_seed(p.use_dropout, p.seed, p.seed_dev);
    const int lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
    const int g = lane >> 2, tq = lane & 3;
    const size_t base = static_cast<size_t>(kvbh) * t * d;
    const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
    const uint32_t wg_rows = wg * 64 * 128;
    const uint32_t k_addr = smem_u32(k_s) + wg_rows, v_addr = smem_u32(v_s) + wg_rows;

    const float sl2 = p.scale * kLog2e;
    float acc_k[NP][32], acc_v[NP][32];
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_k[pn][i] = acc_v[pn][i] = 0.f;

    if (NW == 8 && wg == 1) named_arrive(kTurnBar, 256);
    mbar_wait(owned, 0);
    int st = 0;
    uint32_t ph = 0;
    for (int j = 0; j < n_walk; ++j) {
      mbar_wait(&full[st], ph);
      const int bh = walk_row(j);         // the walked query row (its dropout masks)
      const uint32_t q_addr = smem_u32(qd_s + st * 2 * kBlock * DP);
      const uint32_t do_addr = q_addr + kBlock * DP * 2;
      const float* lse_s = rows_s + st * 2 * kBlock;
      const float* dl_s = lse_s + kBlock;

      float s[32], dp[32];
      if (NW == 8) named_sync(kTurnBar + wg, 256);
      wgmma_fence();
      score_products<DP, kPanelK, kPanelQ>(s, dp, k_addr, q_addr, v_addr, do_addr);
      if (NW == 8 && (wg == 0 || j + 1 < n_walk)) named_arrive(kTurnBar + (wg ^ 1), 256);
      wgmma_wait_n<1>();
      fence_regs(s);

      const int q0 = walk_q0(j);
      const bool edge = band && !interior(p.causal, p.window, q0, kBlock, k0, BK);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = (i >> 2) * 8 + 2 * tq + (i & 1);
        float x = exp2_ftz(fmaf(s[i], sl2, -lse_s[c] * kLog2e));
        if (q0 + kBlock > t && q0 + c >= t) x = 0.f;
        if (edge && !visible(p.causal, p.window, q0 + c, key0 + 8 * ((i >> 1) & 1))) x = 0.f;
        s[i] = x;
      }
      wgmma_wait();
      fence_regs(dp);

      uint32_t pa[kBlock / 16][4], da[kBlock / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float pe[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * kk + 2 * a + e;
            const int c = (i >> 2) * 8 + 2 * tq + e;
            float dpv = dp[i];
            pe[e] = s[i];
            if (p.use_dropout) {
              const bool keep = kept(p, seed, bh, q0 + c, key0 + 8 * (a & 1));
              pe[e] = keep ? s[i] * p.inv_keep : 0.f;
              dpv = keep ? dpv * p.inv_keep : 0.f;
            }
            ds[e] = s[i] * (dpv - dl_s[c]);
          }
          pa[kk][a] = pack_bf16(pe[0], pe[1]);
          da[kk][a] = pack_bf16(ds[0], ds[1]);
        }
      fence_regs(pa);
      fence_regs(da);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        fence_regs(acc_k[pn]);
        fence_regs(acc_v[pn]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) {
          wgmma_rs(acc_v[pn], pa[kk], gmma_desc(do_addr + pn * kPanelQ + kk * 2048, kPanelQ, 1024));
          wgmma_rs(acc_k[pn], da[kk], gmma_desc(q_addr + pn * kPanelQ + kk * 2048, kPanelQ, 1024));
        }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        fence_regs(acc_k[pn]);
        fence_regs(acc_v[pn]);
      }
      fence_regs(pa);
      fence_regs(da);
      if ((tid & 127) == 0) mbar_arrive(&empty[st]);
      if (++st == S) {
        st = 0;
        ph ^= 1;
      }
    }
    store_rows_bf16<BK, DP, true>(k_s, acc_k, p.scale, static_cast<bf16*>(p.dk) + base,
                                  k0 + warp * 16, t, d, warp, lane);
    store_rows_bf16<BK, DP, true>(v_s, acc_v, 1.f, static_cast<bf16*>(p.dv) + base,
                                  k0 + warp * 16, t, d, warp, lane);
  }
}

// ----------------------------------------------------------------- f32 path

// the G x G register tile of a 16G x 16G product of two row-major tiles at
// pitch QP: acc[i][jj] = a-row (ty + 16i) . b-row (tx + 16jj) over columns
// [0, dq4)
template <int G, int QP>
__device__ __forceinline__ void score_tile(float (&acc)[G][G], const float* a, const float* b,
                                           int ty, int tx, int dq4) {
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int jj = 0; jj < G; ++jj) acc[i][jj] = 0.f;
#pragma unroll 4
  for (int c = 0; c < dq4; c += 4) {
    float4 x[G], y[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * QP + c);
      y[i] = *reinterpret_cast<const float4*>(b + (tx + 16 * i) * QP + c);
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        acc[i][jj] = fmaf(x[i].x, y[jj].x, acc[i][jj]);
        acc[i][jj] = fmaf(x[i].y, y[jj].y, acc[i][jj]);
        acc[i][jj] = fmaf(x[i].z, y[jj].z, acc[i][jj]);
        acc[i][jj] = fmaf(x[i].w, y[jj].w, acc[i][jj]);
      }
  }
}

// rows (ty + 16i) of acc (times mul) to og's rows r0 + ty + 16i < t,
// columns 4tx + 64c < d
template <int G, int NC, bool ALIGNED>
__device__ __forceinline__ void store_rows_f32(float* og, const float4 (&acc)[G][NC], float mul,
                                               int r0, int t, int d, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= t) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * tx + 64 * c;
      const float4 out = make_float4(acc[i][c].x * mul, acc[i][c].y * mul, acc[i][c].z * mul,
                                     acc[i][c].w * mul);
      float* dst = og + static_cast<size_t>(row) * d + col;
      if (ALIGNED) {
        if (col < d) *reinterpret_cast<float4*>(dst) = out;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) dst[e] = lane_of(out, e);
      }
    }
  }
}

// kernel #3, f32: R = 16G query rows per block (G = 4, or 3 for a head of
// at most 48 rows).  Shared: Q, dO [R][DP + 4]; dS [R][kPPitch]; the ring
// [stages][K, V][R][DP + 4].  BAND (causal or a window) is a template
// argument, as in the f32 forward: the unbanded instantiation is the kernel
// as it was before the band, contracted the same way.
template <int G, int DP, bool ALIGNED, bool BAND>
__global__ void __launch_bounds__(kF32Threads, DP == 64 ? 2 : 1)
bwd_dq_f32(const Params p) {
  constexpr int R = 16 * G;
  constexpr int QP = DP + 4;              // row pitch: float4 reads of 8
                                          // consecutive rows hit distinct banks
  constexpr int NC = DP / 64;             // output column groups per thread
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);
  float* do_s = q_s + R * QP;
  float* ds_s = do_s + R * QP;
  float* kv_s = ds_s + R * kPPitch;

  const int t = p.t, d = p.d;
  const uint32_t seed = kernel_seed(p.use_dropout, p.seed, p.seed_dev);
  const int n_qtiles = (t + R - 1) / R;
  constexpr bool band = BAND;
  int bh, qt;
  block_tile(gridDim.x / n_qtiles, n_qtiles, band, p.causal, &bh, &qt);
  const int q0 = qt * R;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = static_cast<size_t>(bh) * t * d;
  const size_t kv_base = static_cast<size_t>(kv_row(bh, p.heads, p.kv_heads)) * t * d;
  const float* kg = static_cast<const float*>(p.k) + kv_base;
  const float* vg = static_cast<const float*>(p.v) + kv_base;
  int j0 = 0, j1 = (t + R - 1) / R;       // the key tiles the block's band meets
  if (BAND) key_tiles(p.causal, p.window, q0, q0 + R, t, R, &j0, &j1);
  const int dq4 = (d + 3) & ~3;           // columns read; zero past d

  load_rows_f32<R, DP, kF32Threads, ALIGNED>(q_s, QP, static_cast<const float*>(p.q) + base, q0,
                                             t, d, tid);
  load_rows_f32<R, DP, kF32Threads, ALIGNED>(do_s, QP, static_cast<const float*>(p.dout) + base,
                                             q0, t, d, tid);
  load_rows_f32<R, DP, kF32Threads, ALIGNED>(kv_s, QP, kg, j0 * R, t, d, tid);
  load_rows_f32<R, DP, kF32Threads, ALIGNED>(kv_s + R * QP, QP, vg, j0 * R, t, d, tid);
  cp_async_commit();

  // this thread: rows ty + 16i; score keys tx + 16jj; output columns 4tx + 64c
  const float sl2 = p.scale * kLog2e;
  float nl[G], dl[G];
  float4 acc[G][NC];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int row = q0 + ty + 16 * i;
    const size_t at = static_cast<size_t>(bh) * t + row;
    nl[i] = row < t ? -p.lse[at] * kLog2e : 0.f;
    dl[i] = row < t ? p.delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    cp_async_wait<0>();                   // tile j has landed
    __syncthreads();                      // ... for all; tile j-1 and dS are consumed
    if (j + 1 < j1) {                     // tile j+1 loads while tile j computes
      float* nxt = kv_s + (st ^ 1) * 2 * R * QP;
      load_rows_f32<R, DP, kF32Threads, ALIGNED>(nxt, QP, kg, (j + 1) * R, t, d, tid);
      load_rows_f32<R, DP, kF32Threads, ALIGNED>(nxt + R * QP, QP, vg, (j + 1) * R, t, d, tid);
      cp_async_commit();
    }
    const float* ks = kv_s + st * 2 * R * QP;
    const float* vs = ks + R * QP;

    float s[G][G], dp[G][G];
    score_tile<G, QP>(s, q_s, ks, ty, tx, dq4);
    score_tile<G, QP>(dp, do_s, vs, ty, tx, dq4);
    const int k0 = j * R;
    const bool edge = band && !interior(p.causal, p.window, q0, R, k0, R);
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        float pr = kpos < t ? exp2_ftz(fmaf(s[i][jj], sl2, nl[i])) : 0.f;
        if (edge && !visible(p.causal, p.window, q0 + ty + 16 * i, kpos)) pr = 0.f;
        float dpv = dp[i][jj];
        if (p.use_dropout) dpv = kept(p, seed, bh, q0 + ty + 16 * i, kpos) ? dpv * p.inv_keep : 0.f;
        ds_s[(ty + 16 * i) * kPPitch + tx + 16 * jj] = pr * (dpv - dl[i]);
      }
    __syncthreads();

    // dQ += dS K over the tile's keys (dS is 0 and K zero-filled past t)
    const int kn = min(R, t - k0);
    for (int kk = 0; kk < kn; kk += 4) {
      float4 dr[G];
#pragma unroll
      for (int i = 0; i < G; ++i)
        dr[i] = *reinterpret_cast<const float4*>(ds_s + (ty + 16 * i) * kPPitch + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(ks + (kk + e) * QP + 4 * tx + 64 * c);
#pragma unroll
          for (int i = 0; i < G; ++i) fma4(acc[i][c], lane_of(dr[i], e), kv);
        }
      }
    }
  }

  store_rows_f32<G, NC, ALIGNED>(static_cast<float*>(p.dq) + base, acc, p.scale, q0, t, d, ty,
                                 tx);
}

// kernel #4, f32: R = 16G keys per block.  Shared: K, V [R][DP + 4];
// p_eff^T and dS^T [R][kPPitch]; the ring [stages][Q, dO][R][DP + 4]; then
// [stages][lse, delta][R].  Two stages fit only at DP = 64.  BAND as dQ's.
template <int G, int DP, bool ALIGNED, bool BAND>
__global__ void __launch_bounds__(kF32Threads, DP == 64 ? 2 : 1)
bwd_dkv_f32(const Params p) {
  constexpr int R = 16 * G;
  constexpr int QP = DP + 4;
  constexpr int NC = DP / 64;
  extern __shared__ float4 smem_f4[];
  float* k_s = reinterpret_cast<float*>(smem_f4);
  float* v_s = k_s + R * QP;
  float* pe_s = v_s + R * QP;
  float* ds_s = pe_s + R * kPPitch;
  float* qd_s = ds_s + R * kPPitch;

  const int t = p.t, d = p.d;
  const uint32_t seed = kernel_seed(p.use_dropout, p.seed, p.seed_dev);
  const int n_ktiles = (t + R - 1) / R;
  constexpr bool band = BAND;
  int kvbh, kt;                           // a KV row: its group's query rows are walked
  block_tile(gridDim.x / n_ktiles, n_ktiles, band, false, &kvbh, &kt);
  const int k0 = kt * R;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = static_cast<size_t>(kvbh) * t * d;
  int i0 = 0, i1 = (t + R - 1) / R;       // the query tiles the block's band meets
  if (BAND) query_tiles(p.causal, p.window, k0, k0 + R, t, R, &i0, &i1);
  const int n_band = i1 - i0;
  const int n_walk = (p.heads / p.kv_heads) * n_band;   // every query row of the group
  const int stages = ring_stages(t, p.heads / p.kv_heads, DP == 64);
  float* rows_s = qd_s + stages * 2 * R * QP;
  const int dq4 = (d + 3) & ~3;
  // walked tile w: query row group_row(w / n_band), queries from (i0 + w % n_band) * R
  auto walk_row = [&](int w) { return group_row(p, kvbh, w / n_band); };
  auto walk_q0 = [&](int w) { return (i0 + w % n_band) * R; };

  auto load_walk = [&](int st, int w) {   // Q, dO, lse, delta of walked tile w
    float* dst = qd_s + st * 2 * R * QP;
    const size_t qb = static_cast<size_t>(walk_row(w)) * t;
    const int q1 = walk_q0(w);
    load_rows_f32<R, DP, kF32Threads, ALIGNED>(dst, QP, static_cast<const float*>(p.q) + qb * d,
                                               q1, t, d, tid);
    load_rows_f32<R, DP, kF32Threads, ALIGNED>(dst + R * QP, QP,
                                               static_cast<const float*>(p.dout) + qb * d, q1, t,
                                               d, tid);
    load_lse_delta<R>(rows_s + st * 2 * R, p, qb, q1, t, tid);
    cp_async_commit();
  };
  load_rows_f32<R, DP, kF32Threads, ALIGNED>(k_s, QP, static_cast<const float*>(p.k) + base, k0,
                                             t, d, tid);
  load_rows_f32<R, DP, kF32Threads, ALIGNED>(v_s, QP, static_cast<const float*>(p.v) + base, k0,
                                             t, d, tid);
  load_walk(0, 0);

  // this thread: keys ty + 16i; score queries tx + 16jj; output columns 4tx + 64c
  const float sl2 = p.scale * kLog2e;
  float4 acc_k[G][NC], acc_v[G][NC];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j = 0; j < n_walk; ++j) {
    const int st = stages == 2 ? (j & 1) : 0;
    cp_async_wait<0>();                   // tile j has landed
    __syncthreads();                      // ... for all; tile j-1 and p_eff, dS are consumed
    if (stages == 2 && j + 1 < n_walk) load_walk(st ^ 1, j + 1);
    const int bh = walk_row(j);           // the walked query row (its dropout masks)
    const float* qs = qd_s + st * 2 * R * QP;
    const float* dos = qs + R * QP;
    const float* lse_s = rows_s + st * 2 * R;
    const float* dl_s = lse_s + R;

    float s[G][G], dp[G][G];
    score_tile<G, QP>(s, k_s, qs, ty, tx, dq4);
    score_tile<G, QP>(dp, v_s, dos, ty, tx, dq4);
    const int q0 = walk_q0(j);
    const bool edge = band && !interior(p.causal, p.window, q0, R, k0, R);
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      const int c = tx + 16 * jj;
      const float nl = -lse_s[c] * kLog2e, dl = dl_s[c];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float pr = q0 + c < t ? exp2_ftz(fmaf(s[i][jj], sl2, nl)) : 0.f;
        if (edge && !visible(p.causal, p.window, q0 + c, k0 + ty + 16 * i)) pr = 0.f;
        float pe = pr, dpv = dp[i][jj];
        if (p.use_dropout) {
          const bool keep = kept(p, seed, bh, q0 + c, k0 + ty + 16 * i);
          pe = keep ? pr * p.inv_keep : 0.f;
          dpv = keep ? dpv * p.inv_keep : 0.f;
        }
        pe_s[(ty + 16 * i) * kPPitch + c] = pe;
        ds_s[(ty + 16 * i) * kPPitch + c] = pr * (dpv - dl);
      }
    }
    __syncthreads();

    // dV += P_eff^T dO and dK += dS^T Q over the tile's queries
    const int qn = min(R, t - q0);
    for (int qq = 0; qq < qn; qq += 4) {
      float4 pr[G], dr[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        pr[i] = *reinterpret_cast<const float4*>(pe_s + (ty + 16 * i) * kPPitch + qq);
        dr[i] = *reinterpret_cast<const float4*>(ds_s + (ty + 16 * i) * kPPitch + qq);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 gv = *reinterpret_cast<const float4*>(dos + (qq + e) * QP + 4 * tx + 64 * c);
          const float4 qv = *reinterpret_cast<const float4*>(qs + (qq + e) * QP + 4 * tx + 64 * c);
#pragma unroll
          for (int i = 0; i < G; ++i) {
            fma4(acc_v[i][c], lane_of(pr[i], e), gv);
            fma4(acc_k[i][c], lane_of(dr[i], e), qv);
          }
        }
      }
    }
    if (stages == 1 && j + 1 < n_walk) {  // one stage: the next tile waits for this one
      __syncthreads();
      load_walk(0, j + 1);
    }
  }

  store_rows_f32<G, NC, ALIGNED>(static_cast<float*>(p.dk) + base, acc_k, p.scale, k0, t, d, ty,
                                 tx);
  store_rows_f32<G, NC, ALIGNED>(static_cast<float*>(p.dv) + base, acc_v, 1.f, k0, t, d, ty, tx);
}

// ------------------------------------------------------------------ launch

template <typename... Args>
cudaError_t launch(void (*kernel)(Args...), int blocks, int threads, size_t smem,
                   cudaStream_t stream, const Args&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// bh: the launch's rows (query rows for dQ, KV rows for dK/dV)
template <int NW, int DP>
cudaError_t run_bf16(int bh, bool want_dq, const Params& p, cudaStream_t stream) {
  const int rows = 16 * NW;
  const int blocks = bh * ((p.t + rows - 1) / rows);
  const size_t stages = ring_stages(p.t, want_dq ? 1 : p.heads / p.kv_heads, true);
  const size_t tiles = (2 * rows + stages * 2 * kBlock) * DP * sizeof(bf16) + 1024;
  if (want_dq) return launch(bwd_dq_bf16<NW, DP>, blocks, 32 * NW, tiles, stream, p);
  return launch(bwd_dkv_bf16<NW, DP>, blocks, 32 * NW,
                tiles + stages * 2 * kBlock * sizeof(float), stream, p);
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// a contiguous (rows, t, d) bf16 array as a 3-D map (d, t, rows) read in
// boxes of 64 columns x 64 rows of one head row, written in the 128-byte
// swizzle: coordinates at or past t or d read zeros, as the cp.async
// zero fill does
bool tile_map(CUtensorMap* map, const void* base, int rows, int t, int d) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(t) * d * 2};   // bytes, dims 1 and 2
  const cuuint32_t box[3] = {64, kBlock, 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the warp-specialised kernels; q_rows and kv_rows: the heads of q (and
// dout) and of k and v in all
template <int NW, int DP>
cudaError_t run_ws(int bh, bool want_dq, const Params& p, int q_rows, int kv_rows,
                   cudaStream_t stream) {
  TileMaps m;
  if (!tile_map(&m.q, p.q, q_rows, p.t, p.d) || !tile_map(&m.k, p.k, kv_rows, p.t, p.d) ||
      !tile_map(&m.v, p.v, kv_rows, p.t, p.d) || !tile_map(&m.dout, p.dout, q_rows, p.t, p.d))
    return cudaErrorInvalidValue;
  const int rows = 16 * NW;
  const int blocks = bh * ((p.t + rows - 1) / rows);
  const int threads = 32 * NW + 128;
  if (want_dq)
    return launch(bwd_dq_bf16_ws<NW, DP>, blocks, threads,
                  ws_smem(NW, DP, false, ws_stages(NW, DP, false)), stream, p, m);
  return launch(bwd_dkv_bf16_ws<NW, DP>, blocks, threads,
                ws_smem(NW, DP, true, ws_stages(NW, DP, true)), stream, p, m);
}

template <int G, int DP, bool ALIGNED, bool BAND>
cudaError_t run_f32_g(int bh, bool want_dq, const Params& p, cudaStream_t stream) {
  constexpr size_t R = 16 * G, kTile = R * (DP + 4);
  const int blocks = bh * ((p.t + R - 1) / R);
  if (want_dq) {
    const size_t smem =
        (2 * kTile + R * kPPitch + ring_stages(p.t, 1, true) * 2 * kTile) * sizeof(float);
    return launch(bwd_dq_f32<G, DP, ALIGNED, BAND>, blocks, kF32Threads, smem, stream, p);
  }
  const size_t smem = (2 * kTile + 2 * R * kPPitch +
                       ring_stages(p.t, p.heads / p.kv_heads, DP == 64) * (2 * kTile + 2 * R)) *
                       sizeof(float);
  return launch(bwd_dkv_f32<G, DP, ALIGNED, BAND>, blocks, kF32Threads, smem, stream, p);
}

// a head of at most 48 rows takes 48-row tiles: a 41-row head computes no
// fourth 16-row group of scores
template <int DP, bool ALIGNED, bool BAND>
cudaError_t run_f32(int bh, bool want_dq, const Params& p, cudaStream_t stream) {
  return p.t <= 48 ? run_f32_g<3, DP, ALIGNED, BAND>(bh, want_dq, p, stream)
                   : run_f32_g<4, DP, ALIGNED, BAND>(bh, want_dq, p, stream);
}

// bf16 takes 128-row blocks (two warpgroups sharing each walked tile) unless
// 64-row blocks leave fewer rows on the busiest SM, as the forward does;
// aligned bf16 calls take the warp-specialised kernels (TMA)
template <int DP, bool ALIGNED>
cudaError_t run(int bh, int is_bf16, bool want_dq, const Params& p, int q_rows, int kv_rows,
                cudaStream_t stream) {
  if (!is_bf16)
    return banded(p.causal, p.window) ? run_f32<DP, ALIGNED, true>(bh, want_dq, p, stream)
                                      : run_f32<DP, ALIGNED, false>(bh, want_dq, p, stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long narrow = static_cast<long long>(bh) * ((p.t + 63) / 64);
  const long long wide = static_cast<long long>(bh) * ((p.t + 127) / 128);
  const bool eight = 128 * ((wide + sms - 1) / sms) <= 64 * ((narrow + sms - 1) / sms);
  if (ALIGNED)
    return eight ? run_ws<8, DP>(bh, want_dq, p, q_rows, kv_rows, stream)
                 : run_ws<4, DP>(bh, want_dq, p, q_rows, kv_rows, stream);
  return eight ? run_bf16<8, DP>(bh, want_dq, p, stream) : run_bf16<4, DP>(bh, want_dq, p, stream);
}

// whether the calling thread's last launch took the warp-specialised route
thread_local int last_ws = 0;

int dispatch(const Params& p, int bh, int is_bf16, int seed, int thresh, bool want_dq,
             void* stream) {
  last_ws = 0;
  const long long n_tiles = (p.t + kBlock - 1) / kBlock;
  if (bh < 1 || p.t < 1 || p.d < 1 || p.d > 128 || (!p.seed_dev && seed < 0) || thresh < 0 ||
      static_cast<long long>(bh) * n_tiles > 0x7FFFFFFFLL || p.heads < 1 || p.kv_heads < 1 ||
      p.heads % p.kv_heads || bh % p.heads || p.window < -1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int q_rows = bh, kv_rows = bh / p.heads * p.kv_heads;
  if (!want_dq) bh = kv_rows;             // dK/dV: a block a KV row's key tile
  // cp.async and TMA move 16-byte pieces: rows of a multiple of 16 bytes,
  // 16-byte aligned arrays; anything else takes the scalar-load kernels
  const size_t elem = is_bf16 ? 2 : 4;
  const uintptr_t addrs =
      reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
      reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.dout) |
      reinterpret_cast<uintptr_t>(want_dq ? p.dq : p.dk) |
      reinterpret_cast<uintptr_t>(want_dq ? p.dq : p.dv);
  const bool aligned = (p.d * elem) % 16 == 0 && addrs % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.d <= 64) {
    err = aligned ? run<64, true>(bh, is_bf16, want_dq, p, q_rows, kv_rows, s)
                  : run<64, false>(bh, is_bf16, want_dq, p, q_rows, kv_rows, s);
  } else {
    err = aligned ? run<128, true>(bh, is_bf16, want_dq, p, q_rows, kv_rows, s)
                  : run<128, false>(bh, is_bf16, want_dq, p, q_rows, kv_rows, s);
  }
  last_ws = err == cudaSuccess && is_bf16 && aligned;
  return static_cast<int>(err);
}

}  // namespace

// q, dout (the output's cotangent) and dq: contiguous (bh, t, d) arrays on the
// device, all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); 1 <= d <= 128.
// bh = batch * heads; k, v, dk and dv hold kv_heads heads a batch row, query
// head h reading KV head h / (heads / kv_heads); causal and window as the
// forward's (flash_mask.cuh).  lse and delta: contiguous (bh, t) f32.  seed >= 0, or seed_dev
// the address of an int32 seed on the device, read by the kernel instead; thresh
// and inv_keep are dropout_keep's threshold on the low 24 hash bits and
// 1/(1-rate); the masks hash bh_offset + bh, as the forward's.  Each launches
// on `stream` and returns the launch's CUDA error code (0: none).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int t,
                            int d, int heads, int kv_heads, int causal, int window,
                            int is_bf16, float scale, int seed, const void* seed_dev,
                            int bh_offset, int use_dropout, int thresh, float inv_keep,
                            void* stream) {
  const Params p{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                 dq, nullptr, nullptr, t, d, scale, static_cast<uint32_t>(seed),
                 static_cast<const int*>(seed_dev), static_cast<uint32_t>(bh_offset),
                 use_dropout, static_cast<uint32_t>(thresh), inv_keep, heads, kv_heads,
                 causal != 0, window};
  return dispatch(p, bh, is_bf16, seed, thresh, true, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int t, int d, int heads, int kv_heads, int causal, int window,
                             int is_bf16, float scale, int seed, const void* seed_dev,
                             int bh_offset, int use_dropout, int thresh, float inv_keep,
                             void* stream) {
  const Params p{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                 nullptr, dk, dv, t, d, scale, static_cast<uint32_t>(seed),
                 static_cast<const int*>(seed_dev), static_cast<uint32_t>(bh_offset),
                 use_dropout, static_cast<uint32_t>(thresh), inv_keep, heads, kv_heads,
                 causal != 0, window};
  return dispatch(p, bh, is_bf16, seed, thresh, false, stream);
}

// 1 if the calling thread's last launch of flash_bwd_dq or flash_bwd_dkv
// took the warp-specialised kernels (aligned bf16 arrays), else 0
extern "C" int flash_bwd_last_ws() { return last_ws; }
