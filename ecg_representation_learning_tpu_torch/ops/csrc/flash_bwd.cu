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
// side of the head in 64-row tiles held in a 2-stage shared-memory ring:
// tile j+1 is copied with cp.async (16-byte copies that zero-fill rows >= T
// and columns >= D; 4-byte copies for the walked tile's lse and delta) while
// tile j is computed.  The owned tile covers a whole 41-row training head,
// so the head's other side is read once.  Rows whose D * size is not a
// multiple of 16 bytes, or tensors not 16-byte aligned, take the same
// kernels' scalar-load branch.
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
// each walked tile 16 times, not 64; and cp.async double-buffers the walk.
// Left for later: TMA and producer warps, one fused dQ + dK/dV pass, 8 x 8
// f32 register tiles, 3xTF32 split products for f32.
#include "hopper.cuh"

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
};

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

// number of ring stages: one when the walk is a single tile
__host__ __device__ __forceinline__ int ring_stages(int t, bool two_fit) {
  return (t > kBlock && two_fit) ? 2 : 1;
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

// kernel #3, bf16: NW warps = NW/4 warpgroups of 64 query rows; DP = D padded
// to 64 or 128.  Shared: Q, dO [BQ][DP]; the ring [stages][K, V][64][DP].
template <int NW, int DP, bool ALIGNED>
__global__ void __launch_bounds__(NW * 32, 1)
bwd_dq_bf16(const Params p) {
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
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const size_t base = static_cast<size_t>(bh) * t * d;
  const bf16* kg = static_cast<const bf16*>(p.k) + base;
  const bf16* vg = static_cast<const bf16*>(p.v) + base;
  const int n_kt = (t + kBlock - 1) / kBlock;
  const int row0 = q0 + warp * 16 + g;    // this thread's rows: row0, row0 + 8
  const uint32_t wg_rows = (warp >> 2) * 64 * 128;
  const uint32_t q_addr = smem_u32(q_s) + wg_rows, do_addr = smem_u32(do_s) + wg_rows;

  load_tile_bf16<BQ, DP, ALIGNED>(q_s, static_cast<const bf16*>(p.q) + base, q0, t, d, tid, NT);
  load_tile_bf16<BQ, DP, ALIGNED>(do_s, static_cast<const bf16*>(p.dout) + base, q0, t, d,
                                  tid, NT);
  load_tile_bf16<kBlock, DP, ALIGNED>(kv_s, kg, 0, t, d, tid, NT);
  load_tile_bf16<kBlock, DP, ALIGNED>(kv_s + kBlock * DP, vg, 0, t, d, tid, NT);
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

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    cp_async_wait<0>();                   // tile j has landed
    fence_proxy_async();
    __syncthreads();                      // ... for all; tile j-1 is consumed
    if (j + 1 < n_kt) {                   // tile j+1 loads while tile j computes
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
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = exp2_ftz(fmaf(s[i], sl2, nl[(i >> 1) & 1]));
      if (k0 + kBlock > t && k0 + (i >> 2) * 8 + 2 * tq + (i & 1) >= t) x = 0.f;
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

// kernel #4, bf16: NW/4 warpgroups of 64 keys.  Shared: K, V [BK][DP]; the
// ring [stages][Q, dO][64][DP]; then [stages][lse, delta][64] f32.
template <int NW, int DP, bool ALIGNED>
__global__ void __launch_bounds__(NW * 32, 1)
bwd_dkv_bf16(const Params p) {
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
  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const size_t base = static_cast<size_t>(bh) * t * d;
  const size_t row_base = static_cast<size_t>(bh) * t;
  const bf16* qg = static_cast<const bf16*>(p.q) + base;
  const bf16* dog = static_cast<const bf16*>(p.dout) + base;
  const int n_qt = (t + kBlock - 1) / kBlock;
  float* rows_s = reinterpret_cast<float*>(qd_s + ring_stages(t, true) * 2 * kBlock * DP);
  const int key0 = k0 + warp * 16 + g;    // this thread's keys: key0, key0 + 8
  const uint32_t wg_rows = (warp >> 2) * 64 * 128;
  const uint32_t k_addr = smem_u32(k_s) + wg_rows, v_addr = smem_u32(v_s) + wg_rows;

  load_tile_bf16<BK, DP, ALIGNED>(k_s, static_cast<const bf16*>(p.k) + base, k0, t, d, tid, NT);
  load_tile_bf16<BK, DP, ALIGNED>(v_s, static_cast<const bf16*>(p.v) + base, k0, t, d, tid, NT);
  load_tile_bf16<kBlock, DP, ALIGNED>(qd_s, qg, 0, t, d, tid, NT);
  load_tile_bf16<kBlock, DP, ALIGNED>(qd_s + kBlock * DP, dog, 0, t, d, tid, NT);
  load_lse_delta<kBlock>(rows_s, p, row_base, 0, t, tid);
  cp_async_commit();

  const float sl2 = p.scale * kLog2e;
  float acc_k[NP][32], acc_v[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[pn][i] = acc_v[pn][i] = 0.f;

  for (int j = 0; j < n_qt; ++j) {
    const int st = j & 1;
    cp_async_wait<0>();                   // tile j has landed
    fence_proxy_async();
    __syncthreads();                      // ... for all; tile j-1 is consumed
    if (j + 1 < n_qt) {                   // tile j+1 loads while tile j computes
      const int q1 = (j + 1) * kBlock;
      bf16* nxt = qd_s + (st ^ 1) * 2 * kBlock * DP;
      load_tile_bf16<kBlock, DP, ALIGNED>(nxt, qg, q1, t, d, tid, NT);
      load_tile_bf16<kBlock, DP, ALIGNED>(nxt + kBlock * DP, dog, q1, t, d, tid, NT);
      load_lse_delta<kBlock>(rows_s + (st ^ 1) * 2 * kBlock, p, row_base, q1, t, tid);
      cp_async_commit();
    }
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
    const int q0 = j * kBlock;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = (i >> 2) * 8 + 2 * tq + (i & 1);
      float x = exp2_ftz(fmaf(s[i], sl2, -lse_s[c] * kLog2e));
      if (q0 + kBlock > t && q0 + c >= t) x = 0.f;
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
// [stages][K, V][R][DP + 4].
template <int G, int DP, bool ALIGNED>
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
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * R;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = static_cast<size_t>(bh) * t * d;
  const float* kg = static_cast<const float*>(p.k) + base;
  const float* vg = static_cast<const float*>(p.v) + base;
  const int n_kt = (t + R - 1) / R;
  const int dq4 = (d + 3) & ~3;           // columns read; zero past d

  load_rows_f32<R, DP, kF32Threads, ALIGNED>(q_s, QP, static_cast<const float*>(p.q) + base, q0,
                                             t, d, tid);
  load_rows_f32<R, DP, kF32Threads, ALIGNED>(do_s, QP, static_cast<const float*>(p.dout) + base,
                                             q0, t, d, tid);
  load_rows_f32<R, DP, kF32Threads, ALIGNED>(kv_s, QP, kg, 0, t, d, tid);
  load_rows_f32<R, DP, kF32Threads, ALIGNED>(kv_s + R * QP, QP, vg, 0, t, d, tid);
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

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    cp_async_wait<0>();                   // tile j has landed
    __syncthreads();                      // ... for all; tile j-1 and dS are consumed
    if (j + 1 < n_kt) {                   // tile j+1 loads while tile j computes
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
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        const float pr = kpos < t ? exp2_ftz(fmaf(s[i][jj], sl2, nl[i])) : 0.f;
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
// [stages][lse, delta][R].  Two stages fit only at DP = 64.
template <int G, int DP, bool ALIGNED>
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
  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * R;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = static_cast<size_t>(bh) * t * d;
  const size_t row_base = static_cast<size_t>(bh) * t;
  const float* qg = static_cast<const float*>(p.q) + base;
  const float* dog = static_cast<const float*>(p.dout) + base;
  const int n_qt = (t + R - 1) / R;
  const int stages = ring_stages(t, DP == 64);
  float* rows_s = qd_s + stages * 2 * R * QP;
  const int dq4 = (d + 3) & ~3;

  auto load_walk = [&](int st, int q1) {  // Q, dO, lse, delta of queries from q1
    float* dst = qd_s + st * 2 * R * QP;
    load_rows_f32<R, DP, kF32Threads, ALIGNED>(dst, QP, qg, q1, t, d, tid);
    load_rows_f32<R, DP, kF32Threads, ALIGNED>(dst + R * QP, QP, dog, q1, t, d, tid);
    load_lse_delta<R>(rows_s + st * 2 * R, p, row_base, q1, t, tid);
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

  for (int j = 0; j < n_qt; ++j) {
    const int st = stages == 2 ? (j & 1) : 0;
    cp_async_wait<0>();                   // tile j has landed
    __syncthreads();                      // ... for all; tile j-1 and p_eff, dS are consumed
    if (stages == 2 && j + 1 < n_qt) load_walk(st ^ 1, (j + 1) * R);
    const float* qs = qd_s + st * 2 * R * QP;
    const float* dos = qs + R * QP;
    const float* lse_s = rows_s + st * 2 * R;
    const float* dl_s = lse_s + R;

    float s[G][G], dp[G][G];
    score_tile<G, QP>(s, k_s, qs, ty, tx, dq4);
    score_tile<G, QP>(dp, v_s, dos, ty, tx, dq4);
    const int q0 = j * R;
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      const int c = tx + 16 * jj;
      const float nl = -lse_s[c] * kLog2e, dl = dl_s[c];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float pr = q0 + c < t ? exp2_ftz(fmaf(s[i][jj], sl2, nl)) : 0.f;
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
    if (stages == 1 && j + 1 < n_qt) {    // one stage: the next tile waits for this one
      __syncthreads();
      load_walk(0, (j + 1) * R);
    }
  }

  store_rows_f32<G, NC, ALIGNED>(static_cast<float*>(p.dk) + base, acc_k, p.scale, k0, t, d, ty,
                                 tx);
  store_rows_f32<G, NC, ALIGNED>(static_cast<float*>(p.dv) + base, acc_v, 1.f, k0, t, d, ty, tx);
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
cudaError_t run_bf16(int bh, bool want_dq, const Params& p, cudaStream_t stream) {
  const int rows = 16 * NW;
  const int blocks = bh * ((p.t + rows - 1) / rows);
  const size_t stages = ring_stages(p.t, true);
  const size_t tiles = (2 * rows + stages * 2 * kBlock) * DP * sizeof(bf16) + 1024;
  if (want_dq) return launch(bwd_dq_bf16<NW, DP, ALIGNED>, blocks, 32 * NW, tiles, stream, p);
  return launch(bwd_dkv_bf16<NW, DP, ALIGNED>, blocks, 32 * NW,
                tiles + stages * 2 * kBlock * sizeof(float), stream, p);
}

template <int G, int DP, bool ALIGNED>
cudaError_t run_f32_g(int bh, bool want_dq, const Params& p, cudaStream_t stream) {
  constexpr size_t R = 16 * G, kTile = R * (DP + 4);
  const int blocks = bh * ((p.t + R - 1) / R);
  if (want_dq) {
    const size_t smem =
        (2 * kTile + R * kPPitch + ring_stages(p.t, true) * 2 * kTile) * sizeof(float);
    return launch(bwd_dq_f32<G, DP, ALIGNED>, blocks, kF32Threads, smem, stream, p);
  }
  const size_t smem = (2 * kTile + 2 * R * kPPitch +
                       ring_stages(p.t, DP == 64) * (2 * kTile + 2 * R)) * sizeof(float);
  return launch(bwd_dkv_f32<G, DP, ALIGNED>, blocks, kF32Threads, smem, stream, p);
}

// a head of at most 48 rows takes 48-row tiles: a 41-row head computes no
// fourth 16-row group of scores
template <int DP, bool ALIGNED>
cudaError_t run_f32(int bh, bool want_dq, const Params& p, cudaStream_t stream) {
  return p.t <= 48 ? run_f32_g<3, DP, ALIGNED>(bh, want_dq, p, stream)
                   : run_f32_g<4, DP, ALIGNED>(bh, want_dq, p, stream);
}

// bf16 takes 128-row blocks (two warpgroups sharing each walked tile) unless
// 64-row blocks leave fewer rows on the busiest SM, as the forward does
template <int DP, bool ALIGNED>
cudaError_t run(int bh, int is_bf16, bool want_dq, const Params& p, cudaStream_t stream) {
  if (!is_bf16) return run_f32<DP, ALIGNED>(bh, want_dq, p, stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long narrow = static_cast<long long>(bh) * ((p.t + 63) / 64);
  const long long wide = static_cast<long long>(bh) * ((p.t + 127) / 128);
  return 128 * ((wide + sms - 1) / sms) <= 64 * ((narrow + sms - 1) / sms)
             ? run_bf16<8, DP, ALIGNED>(bh, want_dq, p, stream)
             : run_bf16<4, DP, ALIGNED>(bh, want_dq, p, stream);
}

int dispatch(const Params& p, int bh, int is_bf16, int seed, int thresh, bool want_dq,
             void* stream) {
  const long long n_tiles = (p.t + kBlock - 1) / kBlock;
  if (bh < 1 || p.t < 1 || p.d < 1 || p.d > 128 || (!p.seed_dev && seed < 0) || thresh < 0 ||
      static_cast<long long>(bh) * n_tiles > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // cp.async moves 16-byte pieces: rows of a multiple of 16 bytes, 16-byte
  // aligned arrays; anything else takes the kernels' scalar-load branch
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
    err = aligned ? run<64, true>(bh, is_bf16, want_dq, p, s)
                  : run<64, false>(bh, is_bf16, want_dq, p, s);
  } else {
    err = aligned ? run<128, true>(bh, is_bf16, want_dq, p, s)
                  : run<128, false>(bh, is_bf16, want_dq, p, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// q, k, v, dout (the output's cotangent) and the outputs: contiguous (bh, t, d)
// arrays on the device, all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1);
// 1 <= d <= 128.  lse and delta: contiguous (bh, t) f32.  seed >= 0, or seed_dev
// the address of an int32 seed on the device, read by the kernel instead; thresh
// and inv_keep are dropout_keep's threshold on the low 24 hash bits and
// 1/(1-rate); the masks hash bh_offset + bh, as the forward's.  Each launches
// on `stream` and returns the launch's CUDA error code (0: none).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int t,
                            int d, int is_bf16, float scale, int seed, const void* seed_dev,
                            int bh_offset, int use_dropout, int thresh, float inv_keep,
                            void* stream) {
  const Params p{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                 dq, nullptr, nullptr, t, d, scale, static_cast<uint32_t>(seed),
                 static_cast<const int*>(seed_dev), static_cast<uint32_t>(bh_offset),
                 use_dropout, static_cast<uint32_t>(thresh), inv_keep};
  return dispatch(p, bh, is_bf16, seed, thresh, true, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int t, int d, int is_bf16, float scale, int seed,
                             const void* seed_dev, int bh_offset, int use_dropout,
                             int thresh, float inv_keep, void* stream) {
  const Params p{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                 nullptr, dk, dv, t, d, scale, static_cast<uint32_t>(seed),
                 static_cast<const int*>(seed_dev), static_cast<uint32_t>(bh_offset),
                 use_dropout, static_cast<uint32_t>(thresh), inv_keep};
  return dispatch(p, bh, is_bf16, seed, thresh, false, stream);
}
