// Device helpers shared by the port's attention kernels for Hopper (sm_90a):
// flash_fwd.cu (forward) and flash_bwd.cu (backward).  _build.py hashes this
// header into every library's name, so an edit rebuilds each of them.
//
//   * dropout_hash: the counter hash of ops/attention.py's dropout_keep;
//   * cp.async 16-byte copies with zero fill, and the tile loaders built on
//     them (bf16 tiles in the tensor cores' 128-byte swizzle, f32 tiles at a
//     padded row pitch), each with a scalar-load branch for rows that are not
//     a multiple of 16 bytes;
//   * wgmma: matrix descriptors, the fence / commit / wait instructions, the
//     register pins, and the m64n64k16 bf16 -> f32 products with A from shared
//     memory (SS) or from registers (RS);
//   * warp specialisation: mbarriers (init, arrive, expect-tx, parity wait,
//     the arrive of a thread's finished cp.asyncs), TMA tile loads from a
//     tensor map and its prefetch, named barriers and setmaxnreg;
//   * small f32 helpers of the register-tiled CUDA-core paths.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

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

// The dropout seed of a launch: read from device memory when seed_dev is set
// (a training step's tape, so that a CUDA graph replaying the launch reads the
// step's new seed), else the value passed.  Read once, at the kernel's start,
// and only when dropout is on.
__device__ __forceinline__ uint32_t kernel_seed(int use_dropout, uint32_t seed,
                                                const int* seed_dev) {
  return (use_dropout && seed_dev) ? static_cast<uint32_t>(*seed_dev) : seed;
}

// 2^x on the special-function unit (2 ulp, as exp2f); results below 2^-126
// flush to 0, which no sum or product of p here can see
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- bf16 tiles

// A bf16 tile of ROWS rows x DP columns is stored as DP/64 panels of
// [ROWS][64]: a panel row is 128 bytes, and its eight 16-byte chunks are
// XORed with r % 8.  With panels 1024-byte aligned this is the tensor cores'
// 128-byte swizzle, which wgmma reads through a matrix descriptor; it also
// spreads the 8 rows of one chunk over 8 bank groups.
template <int ROWS> __device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * ROWS * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// rows [r0, r0 + ROWS) of a (t, d) bf16 matrix into a swizzled tile, zeros
// outside it
template <int ROWS, int DP, bool ALIGNED>
__device__ __forceinline__ void load_tile_bf16(bf16* s, const bf16* g, int r0, int t, int d,
                                               int tid, int nthreads) {
  constexpr int CH = DP / 8;
  if (ALIGNED) {                                   // d % 8 == 0
    for (int i = tid; i < ROWS * CH; i += nthreads) {
      const int r = i / CH, c = i - r * CH;
      const bool ok = r0 + r < t && c * 8 < d;
      cp_async16(s + swz<ROWS>(r, c), ok ? g + static_cast<size_t>(r0 + r) * d + c * 8 : g,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += nthreads) {
      const int r = i / DP, c = i - r * DP;
      s[swz<ROWS>(r, c >> 3) + (c & 7)] =
          (r0 + r < t && c < d) ? g[static_cast<size_t>(r0 + r) * d + c] : __float2bfloat16(0.f);
    }
  }
}

// makes this thread's shared-memory writes (cp.async or plain stores)
// visible to the tensor cores' reads, which go through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------------- wgmma

// wgmma matrix descriptor of a 128-byte-swizzled operand at shared address
// `addr`: leading and stride byte offsets, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// waits until at most N committed groups are still in flight
template <int N> __device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins registers that an in-flight wgmma reads or writes: the compiler may
// neither move their other uses across this point nor reuse them before it
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d = A . B (+ d if accumulate) for the warpgroup's 64 rows x 64 columns,
// k = 16, bf16 -> f32: A (64 x 16) and B (16 x 64), both K-major, in shared
// memory.  d[4j + e] of warp w is row 16w + g + 8(e/2), column 8j + 2q + e%2
// (g = lane/4, q = lane%4), the m16n8 accumulator layout per 8 columns.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
// the same with A in registers (the m16n8k16 A-fragment layout per warp) and
// B (16 x 64) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ------------------------------------------------------- warp specialisation

// an mbarrier in shared memory that completes a phase after `count` arrivals
// (and, where a phase expects bytes, once they have landed); call from one
// thread, then fence_mbarrier_init and a block barrier before any use
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival that also makes the current phase wait for `bytes` more bytes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// one arrival on `bar` once every cp.async this thread issued so far has
// landed; counted among the arrivals the barrier was initialised with
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// a TMA load of the box at (c0, c1, c2) of the 3-D tensor map at `map` (a
// __grid_constant__ parameter) into shared memory at `dst`, its bytes
// counted on `bar`; elements outside the tensor read zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// fetches a tensor map (a __grid_constant__ parameter) ahead of its first
// TMA load
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// named barrier `id` (1..15; 0 is __syncthreads') over `n` threads: sync
// waits for them all, arrive counts this warp and goes on
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// a warpgroup's register count from here on (every warp of it executes this)
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ----------------------------------------------------------------- f32 tiles

// rows [r0, r0 + ROWS) of a (t, d) f32 matrix into a [ROWS][pitch] tile,
// zeros outside it (columns up to DP), by NT threads
template <int ROWS, int DP, int NT, bool ALIGNED>
__device__ __forceinline__ void load_rows_f32(float* s, int pitch, const float* g, int r0,
                                              int t, int d, int tid) {
  constexpr int CH = DP / 4;
  if (ALIGNED) {                                   // d % 4 == 0
    for (int i = tid; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = i - r * CH;
      const bool ok = r0 + r < t && c * 4 < d;
      cp_async16(s + r * pitch + c * 4,
                 ok ? g + static_cast<size_t>(r0 + r) * d + c * 4 : g, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i - r * DP;
      s[r * pitch + c] = (r0 + r < t && c < d) ? g[static_cast<size_t>(r0 + r) * d + c] : 0.f;
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

}  // namespace
