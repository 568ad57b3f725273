// What both backward kernels of flash attention share (flash_mha_bwd.cu on
// the CUDA cores, flash_mha_bwd_wgmma.cu on the tensor cores): the mode
// parameters and flash_mha.cu's visibility predicate, per pair and per
// tile.  Query i sits at position q_offset + i; key j is visible to it
//   causal:     q_offset + i >= j, and with a window also
//               (j > q_offset + i - window or j < sink);
//   non-causal: always (window and sink do not apply);
//   rho:        keep[i / block_q][j / block_kv] != 0 when a keep matrix is
//               given, at the caller's block granularity (which need not
//               align with a kernel's tiles);
// and never past Sq or Skv.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_bwd {

struct Params {
  int Sq, Skv, Hq, Hkv, causal, q_offset, window, sink;
  int block_q, block_kv, n_kv_blocks;
  float scale;
};

// Whether query i sees key j.
__device__ __forceinline__ bool visible(const Params& p,
                                        const int32_t* __restrict__ keep,
                                        int i, int j) {
  if (i >= p.Sq || j >= p.Skv) return false;
  if (p.causal) {
    const int qp = p.q_offset + i;
    if (qp < j) return false;
    if (p.window && !(j > qp - p.window || j < p.sink)) return false;
  }
  if (keep != nullptr &&
      keep[(i / p.block_q) * p.n_kv_blocks + j / p.block_kv] == 0)
    return false;
  return true;
}

// Whether every pair of the TM queries from i0 and the TN keys from t0 is
// visible: such a tile skips the per-element test.
template <int TM, int TN>
__device__ __forceinline__ bool tile_full(const Params& p,
                                          const int32_t* keep, int i0,
                                          int t0) {
  const int i1 = i0 + TM - 1, t1 = t0 + TN - 1;
  if (keep != nullptr || i1 >= p.Sq || t1 >= p.Skv) return false;
  if (!p.causal) return true;
  if (p.q_offset + i0 < t1) return false;
  return !p.window || t0 > p.q_offset + i1 - p.window || t1 < p.sink;
}

// Whether queries [i0, i1] and keys [t0, t1] hold any visible pair (the
// tile-level tests of the forward: causal edge, window, keep matrix).
__device__ inline bool tile_live(const Params& p,
                                 const int32_t* __restrict__ keep, int i0,
                                 int i1, int t0, int t1) {
  if (p.causal) {
    if (p.q_offset + i1 < t0) return false;       // every key in the future
    if (p.window && t0 >= p.sink && t1 <= p.q_offset + i0 - p.window)
      return false;                               // left of every window
  }
  if (keep == nullptr) return true;
  for (int qb = i0 / p.block_q; qb <= i1 / p.block_q; ++qb)
    for (int kb = t0 / p.block_kv; kb <= t1 / p.block_kv; ++kb)
      if (keep[qb * p.n_kv_blocks + kb]) return true;
  return false;
}

// The query range [begin, end) that can see keys [t0, t1], in whole tiles
// of `tile` queries from 0 (causal: from the tile of the first query that
// sees t0; with a window and no sink among the keys: up to the last query
// whose window reaches t1).
__device__ __forceinline__ void query_range(const Params& p, int t0, int t1,
                                            int tile, int& begin, int& end) {
  begin = 0;
  end = p.Sq;
  if (p.causal) {
    begin = max(0, t0 - p.q_offset) / tile * tile;
    if (p.window && t0 >= p.sink)
      end = max(0, min(end, t1 + p.window - p.q_offset));
  }
}

}  // namespace flash_bwd
