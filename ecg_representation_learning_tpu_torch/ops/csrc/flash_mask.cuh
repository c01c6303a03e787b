// The attention mask of the flash kernels (flash_fwd.cu, flash_bwd.cu) beyond
// the sequence's end, and their grouped KV heads.  _build.py hashes this
// header into every library's name, as hopper.cuh.
//
//   * causal: query i sees keys j <= i;
//   * a left window W >= 0: query i sees keys j >= i - W (W = -1: no bound);
//   * grouped KV heads: k and v hold kv_heads heads a batch row, q holds
//     heads = G * kv_heads, and query head h reads KV head h / G.
//
// A row always sees its own key, so no row is wholly masked.  A block visits
// only the tiles of the other side that meet its band (key_tiles,
// query_tiles) and masks elements only in the tiles that cross the band's
// edge (interior_*); with neither causal nor a window every tile is visited
// and nothing is masked, as before either existed.
#pragma once

namespace {

__host__ __device__ __forceinline__ bool banded(int causal, int window) {
  return causal || window >= 0;
}

__device__ __forceinline__ bool visible(int causal, int window, int qpos, int kpos) {
  return (!causal || kpos <= qpos) && (window < 0 || kpos >= qpos - window);
}

// the tiles [*first, *last) of `width` keys that query rows [q0, q1) see
__host__ __device__ __forceinline__ void key_tiles(int causal, int window, int q0, int q1, int t,
                                                   int width, int* first, int* last) {
  const int lo = window < 0 ? 0 : (q0 - window > 0 ? q0 - window : 0);
  const int hi = causal ? (q1 < t ? q1 : t) : t;
  *first = lo / width;
  *last = (hi + width - 1) / width;
}

// the tiles [*first, *last) of `width` queries that see key rows [k0, k1)
__host__ __device__ __forceinline__ void query_tiles(int causal, int window, int k0, int k1, int t,
                                                     int width, int* first, int* last) {
  const int lo = causal ? k0 : 0;
  const int hi = window < 0 ? t : (k1 + window < t ? k1 + window : t);
  *first = lo / width;
  *last = (hi + width - 1) / width;
}

// whether every query of [q0, q0 + nq) sees every key of [k0, k0 + nk)
__device__ __forceinline__ bool interior(int causal, int window, int q0, int nq, int k0, int nk) {
  return (!causal || k0 + nk - 1 <= q0) && (window < 0 || k0 >= q0 + nq - 1 - window);
}

// the KV row (batch row * kv_heads + KV head) that query row bh reads
__device__ __forceinline__ int kv_row(int bh, int heads, int kv_heads) {
  return (bh / heads) * kv_heads + (bh % heads) / (heads / kv_heads);
}

// block blockIdx.x's (row, tile) of `rows` rows of `tiles` tiles: row-major
// unbanded (the order before the mask existed); banded, tile-major, so the
// heaviest tiles of every row start first: the last ones first when
// `reverse` (a causal query tile sees more keys the later it is)
__device__ __forceinline__ void block_tile(int rows, int tiles, bool band, bool reverse, int* row,
                                           int* tile) {
  const int b = blockIdx.x;
  if (!band) {
    *row = b / tiles;
    *tile = b % tiles;
    return;
  }
  *row = b % rows;
  *tile = reverse ? tiles - 1 - b / rows : b / rows;
}

}  // namespace
