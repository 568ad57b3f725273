// Backward of the flash-attention kernel on Hopper's tensor cores (bf16 at
// D = 64, 96 and 128).
//
// No Pallas kernel has a backward: the JAX reference gives the TPU kernel
// kernels/flash_attention/kernel.py::flash_mha_pallas no VJP and trains
// through its jnp mha.  The port sends every CUDA tensor to flash_mha.cu,
// so training on the card needs this gradient.  It computes the gradient of
// flash_mha.cu's function in every mode (causal with q_offset, sink +
// window, the rho keep matrix, non-causal; GQA): dq, dk and dv from q, k,
// v, the forward's output o, its fp32 log-sum-exp lse [B,Hq,Sq] and dout,
// with FlashAttention-2's recompute formulas (s = q.k * scale):
//   delta_i = sum_d dout_i,d o_i,d
//   P_ij    = exp(s_ij - lse_i) where key j is visible to query i, else 0
//   dV_j    = sum_i P_ij dout_i            dP_ij = dout_i . v_j
//   dS_ij   = P_ij (dP_ij - delta_i)
//   dQ_i    = scale sum_j dS_ij k_j        dK_j  = scale sum_i dS_ij q_i
// P and dS are rounded to bf16 before the products that take them (dV,
// dK, dQ), as the tensor cores need; every sum is fp32.  The plain version
// that does the same arithmetic is ref.flash_mha_bwd_ref(round_bf16=True).
// The G query heads of a KV head sum into its dK and dV.  Visibility is
// flash_mha_bwd.cuh's predicate, shared with the CUDA-core kernel
// (flash_mha_bwd.cu, which keeps fp32 and D 16).
//
// Bound: 10 x (visible pairs) x D operations (the five products S, dP, dV,
// dK, dQ over the visible pairs) at the 989 TFLOP/s bf16 peak, far above
// the bytes it must move: at minicpm-2b's training attention (B 2, S 4,096
// causal, 36 heads of 64) 386.6 GFLOP, 0.391 ms.  This design issues seven
// products (the dQ kernel recomputes S and dP, so that no two blocks add
// into one gradient and two calls give the same bits), so 0.55 ms is its
// own floor at the peak.
//
// Three launches:
// 1. prep: one warp per (b, i, h) row writes delta_i and lse_i log2(e)
//    (+inf for a row that sees nothing and for the padding past Sq, so that
//    such rows' P is exp2(-inf) = 0 with no test) into [B, Hq, sq_pad]
//    buffers, sq_pad a multiple of 128, whose 64-row slices are whole
//    16-byte-aligned bulk copies.
// 2. dK/dV: one block per (b, KV head, 128 keys); a producer warpgroup,
//    of which one thread issues every load, and two consumer warpgroups of
//    64 keys each (setmaxnreg moves the producer's registers to them).  K
//    and V arrive once by TMA and stay in shared memory as wgmma's A
//    operand (keys as M).  The producer walks the G query heads of the KV
//    head and, for each, the 64-query tiles that can see the block's keys
//    (tile_live: causal edge, window, keep matrix), streaming Q, dO and
//    the tile's lse and delta through a 3-stage ring guarded by mbarriers
//    (full: the bytes landed; empty: all 8 consumer warps are done).  Per
//    tile a consumer issues S^T = K Q^T and dP^T = V dO^T as m64n64k16
//    chains into fp32 (Q and dO stored [queries, D] are K-major B
//    operands); P^T = exp2(S^T scale log2e - lse log2e) with lse and delta
//    per column (query) read from the stage; dS^T = P^T (dP^T - delta).
//    P^T and dS^T, rounded to bf16 in registers, are directly the register
//    A operands of dV += P^T dO and dK += dS^T Q (dO and Q are then the
//    MN-major, transposed B operands, N = D).  dK and dV stay in fp32
//    registers and are stored once, dK scaled once.
// 3. dQ: one block per (b, query head, 128 queries), two consumer
//    warpgroups of 64 queries; Q, dO and the rows' lse and delta stay put,
//    64-key K and V tiles stream through the same kind of ring (tile_live
//    again; causal: up to the last key the block's queries can see).  S = Q
//    K^T and dP = dO V^T (K-major B), P and dS as above with lse and delta
//    per row, dQ += dS K with dS in bf16 registers (K the MN-major B).
// Every live tile issues the same wgmma sequence, with no data-dependent
// branch around it (ptxas serializes wgmmas otherwise): masks set scores
// to -inf (tiles that are wholly visible skip the per-element test), rows
// past Sq and keys past Skv come in as TMA's zeros and are not stored.
// Rows are loaded through 4-D tensor maps over [B, S, H, D] in place, in
// boxes of 64 head-dim columns with the 128-byte swizzle: D 64 is one box,
// D 128 two, D 96 two with the second box's last 32 columns outside the
// tensor, read as zeros.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <math.h>
#include <stdio.h>

#include "hopper.cuh"
#include "flash_mha_bwd.cuh"

namespace {

using namespace hopper;
using flash_bwd::Params;
using flash_bwd::query_range;
using flash_bwd::tile_full;
using flash_bwd::tile_live;
using flash_bwd::visible;

constexpr int BLOCK = 128;       // keys of a dK/dV block, queries of a dQ block
constexpr int TILE = 64;         // queries (dK/dV) or keys (dQ) of a stage
constexpr int WG = 64;           // rows of a consumer warpgroup (wgmma M)
constexpr int STAGES = 3;
constexpr int THREADS = 384;     // producer warpgroup + 2 consumers
constexpr int PREP_THREADS = 256;
constexpr int ROW = 128;         // bytes of one swizzled box row: 64 bf16
// a tile of `rows` rows kept as two 64-column boxes (D 96 / 128; D 64
// fills the first), each box on a 1024-byte boundary
constexpr int BLOCK_BYTES = BLOCK * 2 * ROW;
constexpr int TILE_BYTES = TILE * 2 * ROW;
// a dK/dV stage: Q, dO, then lse log2e and delta of its 64 queries
constexpr int DKDV_STAGE = 2 * TILE_BYTES + 1024;
// a dQ stage: K, V
constexpr int DQ_STAGE = 2 * TILE_BYTES;
// 1024 bytes of slack to align the tiles; barriers and tile starts after
constexpr size_t DKDV_SMEM = 1024 + 2 * BLOCK_BYTES + STAGES * DKDV_STAGE
                             + 128;
constexpr size_t DQ_SMEM = 1024 + 2 * BLOCK_BYTES + STAGES * DQ_STAGE + 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t NEG_INF_BITS = 0xff800000u;
// a failed tensor-map encoding returns TENSOR_MAP_ERROR - its CUresult
// (-1000 without the CUDA driver's entry point)
constexpr int TENSOR_MAP_ERROR = -4000;

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void release(uint64_t* empty, int stage,
                                        int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[stage]);
}

// the K-step k16 number kk of a K-major operand: box kk / 4, 32 bytes a
// step inside its 128-byte rows; `rows` rows to a box
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int rows,
                                           int kk) {
  return desc_sw128(tile + (kk / 4) * rows * ROW + (kk % 4) * 32, 16, 1024);
}

// acc (m64nD) += a (bf16 A fragments of 64 K rows) times the MN-major B
// tile of 64 K rows x D columns (two-box tile of TILE rows)
template <int D>
__device__ __forceinline__ void mma_rs_tile(float (&acc)[D / 2],
                                            const uint32_t (&a)[TILE / 16][4],
                                            const uint8_t* b) {
#pragma unroll
  for (int t = 0; t < TILE / 16; ++t) {
    const uint64_t desc = desc_sw128(b + t * 16 * ROW, TILE * ROW, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs_bf16_tb(acc, a[t], desc, 1);
    else if constexpr (D == 96)
      wgmma_m64n96k16_rs_bf16_tb(acc, a[t], desc, 1);
    else
      wgmma_m64n64k16_rs_bf16_tb(acc, a[t], desc, 1);
  }
}

// c (m64n64) = A B^T over D: both K-major, A the warpgroup's 64 rows of a
// BLOCK-row tile, B a TILE-row tile
template <int D>
__device__ __forceinline__ void mma_ss_chain(float (&c)[TILE / 2],
                                             const uint8_t* a,
                                             const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss_bf16(c, desc_k(a, BLOCK, kk), desc_k(b, TILE, kk),
                            kk > 0);
}

// bf16 A fragments of an m64n64 accumulator: the layout of 16 columns is
// that of an A fragment of one k16 step
__device__ __forceinline__ void to_frags(uint32_t (&a)[TILE / 16][4],
                                         const float (&c)[TILE / 2]) {
#pragma unroll
  for (int t = 0; t < TILE / 16; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[t][r] = pack_bf16(c[8 * t + 2 * r], c[8 * t + 2 * r + 1]);
}

// Sets to -inf the scores of an m64n64 accumulator that are not visible.
// The thread holds rows row0 and row0 + 8 and columns col0 + 8j + {0, 1};
// `keys_are_rows` says which axis holds the keys.
__device__ __forceinline__ void mask_scores(float (&s)[TILE / 2],
                                            const Params& p,
                                            const int32_t* __restrict__ keep,
                                            int row0, int col0,
                                            bool keys_are_rows) {
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r, col = col0 + 8 * j + c;
        const bool vis = keys_are_rows ? visible(p, keep, col, row)
                                       : visible(p, keep, row, col);
        if (!vis) s[4 * j + 2 * r + c] = __uint_as_float(NEG_INF_BITS);
      }
}

// Stores rows row0 and row0 + 8 (those below S) of an m64nD accumulator,
// times `mul`, as bf16 into the [B, S, H, D] tensor `dst` at (b, ., h).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           const float (&acc)[D / 2],
                                           float mul, int b, int S, int H,
                                           int h, int row0, int col0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i >= S) continue;
    __nv_bfloat16* out =
        dst + ((static_cast<int64_t>(b) * S + i) * H + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// ---- 1. delta and lse log2(e), padded -------------------------------------

template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse2,
                float* __restrict__ delta, int B, int sq_pad, Params p) {
  // row (b * sq_pad + i) * Hq + h: neighbouring warps read neighbouring
  // rows of o and dout
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (PREP_THREADS / 32)
                      + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(B) * sq_pad * p.Hq) return;
  const int h = static_cast<int>(row % p.Hq);
  const int64_t bi = row / p.Hq;
  const int i = static_cast<int>(bi % sq_pad);
  const int b = static_cast<int>(bi / sq_pad);
  float acc = 0.f;
  if (i < p.Sq) {
    const int64_t src = ((static_cast<int64_t>(b) * p.Sq + i) * p.Hq + h) * D;
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + src + c));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dout + src + c));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t dst = (static_cast<int64_t>(b) * p.Hq + h) * sq_pad + i;
    float l = INFINITY;
    if (i < p.Sq) {
      const float x = lse[(static_cast<int64_t>(b) * p.Hq + h) * p.Sq + i];
      if (x != -INFINITY) l = x * LOG2E;
    }
    lse2[dst] = l;
    delta[dst] = acc;
  }
}

// ---- 2. dK, dV: one block per (b, KV head, 128 keys) ----------------------

template <int D>
__device__ __forceinline__ void dkdv_consume(
    const Params& p, const int32_t* __restrict__ keep,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    const uint8_t* sk, const uint8_t* sv, const uint8_t* stages,
    uint64_t* full, uint64_t* empty, uint64_t* kvbar,
    const volatile int* tile_i0, int t0, int hk, int b) {
  constexpr int NA = D / 2;        // dK / dV values per thread (m64nD)
  constexpr int NS = TILE / 2;     // S^T values per thread (m64n64)
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int first = t0 + WG * cw;                // the warpgroup's first key
  const int row0 = first + 16 * warp + lane / 4;  // keys row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = p.scale * LOG2E;
  const uint8_t* k_wg = sk + WG * cw * ROW;
  const uint8_t* v_wg = sv + WG * cw * ROW;

  float dka[NA], dva[NA], s[NS], dp[NS];
  uint32_t pa[TILE / 16][4], da[TILE / 16][4];
#pragma unroll
  for (int c = 0; c < NA; ++c) dka[c] = dva[c] = 0.f;
#pragma unroll
  for (int c = 0; c < NS; ++c) s[c] = dp[c] = 0.f;

  mbar_wait(kvbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&full[stage], phase);
    const int i0 = tile_i0[stage];
    if (i0 < 0) break;
    const uint8_t* sq = stages + stage * DKDV_STAGE;
    const uint8_t* sdo = sq + TILE_BYTES;
    const float* lse_s = reinterpret_cast<const float*>(sq + 2 * TILE_BYTES);
    const float* del_s = lse_s + TILE;

    // S^T = K Q^T, dP^T = V dO^T (keys as M, the tile's queries as N)
    wgmma_fence();
    mma_ss_chain<D>(s, k_wg, sq);
    wgmma_commit();
    mma_ss_chain<D>(dp, v_wg, sdo);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P^T, with lse per column (query)
    if (!tile_full<TILE, WG>(p, keep, i0, first))
      mask_scores(s, p, keep, row0, i0 + col0, true);
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + col0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s[4 * j + 2 * r] = exp2_approx(fmaf(s[4 * j + 2 * r], scale_log2, -l.x));
        s[4 * j + 2 * r + 1] =
            exp2_approx(fmaf(s[4 * j + 2 * r + 1], scale_log2, -l.y));
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS^T = P^T (dP^T - delta), delta per column
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(del_s + 8 * j + col0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dp[4 * j + 2 * r] = s[4 * j + 2 * r] * (dp[4 * j + 2 * r] - d.x);
        dp[4 * j + 2 * r + 1] =
            s[4 * j + 2 * r + 1] * (dp[4 * j + 2 * r + 1] - d.y);
      }
    }
    // dV += P^T dO, dK += dS^T Q
    to_frags(pa, s);
    to_frags(da, dp);
    wgmma_fence();
    mma_rs_tile<D>(dva, pa, sdo);
    mma_rs_tile<D>(dka, da, sq);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    release(empty, stage, lane);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows<D>(dk, dka, p.scale, b, p.Skv, p.Hkv, hk, row0, col0);
  store_rows<D>(dv, dva, 1.f, b, p.Skv, p.Hkv, hk, row0, col0);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta,
                      const int32_t* __restrict__ keep,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, Params p, int sq_pad) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + BLOCK_BYTES;
  uint8_t* stages = sv + BLOCK_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * DKDV_STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;
  volatile int* tile_i0 = reinterpret_cast<volatile int*>(kvbar + 1);

  const int t0 = blockIdx.x * BLOCK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);    // every consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      tma_prefetch(&tdo);
      constexpr int NB = (D + 63) / 64;   // 64-column boxes of a row
      mbar_arrive_expect_tx(kvbar, 2 * BLOCK * NB * ROW);
      for (int nb = 0; nb < NB; ++nb) {
        tma_load_4d(sk + nb * BLOCK * ROW, &tk, kvbar, 64 * nb, hk, t0, b);
        tma_load_4d(sv + nb * BLOCK * ROW, &tv, kvbar, 64 * nb, hk, t0, b);
      }
      const int t1 = min(t0 + BLOCK, p.Skv) - 1;
      int i_begin, i_end;
      query_range(p, t0, t1, TILE, i_begin, i_end);
      const int G = p.Hq / p.Hkv;
      int stage = 0;
      uint32_t phase = 0;
      for (int g = 0; g < G; ++g) {
        const int h = hk * G + g;
        for (int i0 = i_begin; i0 < i_end; i0 += TILE) {
          if (!tile_live(p, keep, i0, min(i0 + TILE, p.Sq) - 1, t0, t1))
            continue;
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = stages + stage * DKDV_STAGE;
          tile_i0[stage] = i0;
          mbar_arrive_expect_tx(&full[stage],
                                2 * TILE * NB * ROW + 2 * TILE * 4);
          for (int nb = 0; nb < NB; ++nb) {
            tma_load_4d(st + nb * TILE * ROW, &tq, &full[stage], 64 * nb, h,
                        i0, b);
            tma_load_4d(st + TILE_BYTES + nb * TILE * ROW, &tdo,
                        &full[stage], 64 * nb, h, i0, b);
          }
          const int64_t r = (static_cast<int64_t>(b) * p.Hq + h) * sq_pad + i0;
          bulk_load(st + 2 * TILE_BYTES, lse2 + r, TILE * 4, &full[stage]);
          bulk_load(st + 2 * TILE_BYTES + TILE * 4, delta + r, TILE * 4,
                    &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      mbar_wait(&empty[stage], phase ^ 1);
      tile_i0[stage] = -1;         // end of the tiles
      mbar_arrive(&full[stage]);
    }
  } else {
    setmaxnreg_inc<232>();
    dkdv_consume<D>(p, keep, dk, dv, sk, sv, stages, full, empty, kvbar,
                    tile_i0, t0, hk, b);
  }
}

// ---- 3. dQ: one block per (b, query head, 128 queries) --------------------

template <int D>
__device__ __forceinline__ void dq_consume(
    const Params& p, const int32_t* __restrict__ keep,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, const uint8_t* sq, const uint8_t* sdo,
    const uint8_t* stages, uint64_t* full, uint64_t* empty, uint64_t* qbar,
    const volatile int* tile_t0, int i0, int h, int b, int sq_pad) {
  constexpr int NA = D / 2;        // dQ values per thread (m64nD)
  constexpr int NS = TILE / 2;     // S values per thread (m64n64)
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int first = i0 + WG * cw;                // the warpgroup's first row
  const int row0 = first + 16 * warp + lane / 4;  // rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = p.scale * LOG2E;
  const uint8_t* q_wg = sq + WG * cw * ROW;
  const uint8_t* do_wg = sdo + WG * cw * ROW;
  // the rows' lse log2e and delta (padded past Sq: +inf and 0)
  const int64_t rbase = (static_cast<int64_t>(b) * p.Hq + h) * sq_pad;
  const float l2[2] = {lse2[rbase + row0], lse2[rbase + row0 + 8]};
  const float dl[2] = {delta[rbase + row0], delta[rbase + row0 + 8]};

  float dqa[NA], s[NS], dp[NS];
  uint32_t da[TILE / 16][4];
#pragma unroll
  for (int c = 0; c < NA; ++c) dqa[c] = 0.f;
#pragma unroll
  for (int c = 0; c < NS; ++c) s[c] = dp[c] = 0.f;

  mbar_wait(qbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&full[stage], phase);
    const int t0 = tile_t0[stage];
    if (t0 < 0) break;
    const uint8_t* skt = stages + stage * DQ_STAGE;
    const uint8_t* svt = skt + TILE_BYTES;

    // S = Q K^T, dP = dO V^T (the warpgroup's queries as M, keys as N)
    wgmma_fence();
    mma_ss_chain<D>(s, q_wg, skt);
    wgmma_commit();
    mma_ss_chain<D>(dp, do_wg, svt);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    if (!tile_full<WG, TILE>(p, keep, first, t0))
      mask_scores(s, p, keep, row0, t0 + col0, false);
#pragma unroll
    for (int c = 0; c < NS; ++c)
      s[c] = exp2_approx(fmaf(s[c], scale_log2, -l2[(c >> 1) & 1]));
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int c = 0; c < NS; ++c)
      dp[c] = s[c] * (dp[c] - dl[(c >> 1) & 1]);
    to_frags(da, dp);
    // dQ += dS K
    wgmma_fence();
    mma_rs_tile<D>(dqa, da, skt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    release(empty, stage, lane);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows<D>(dq, dqa, p.scale, b, p.Sq, p.Hq, h, row0, col0);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta,
                    const int32_t* __restrict__ keep,
                    __nv_bfloat16* __restrict__ dq, Params p, int sq_pad) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sdo = sq + BLOCK_BYTES;
  uint8_t* stages = sdo + BLOCK_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * DQ_STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  volatile int* tile_t0 = reinterpret_cast<volatile int*>(qbar + 1);

  const int i0 = blockIdx.x * BLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      tma_prefetch(&tdo);
      constexpr int NB = (D + 63) / 64;
      mbar_arrive_expect_tx(qbar, 2 * BLOCK * NB * ROW);
      for (int nb = 0; nb < NB; ++nb) {
        tma_load_4d(sq + nb * BLOCK * ROW, &tq, qbar, 64 * nb, h, i0, b);
        tma_load_4d(sdo + nb * BLOCK * ROW, &tdo, qbar, 64 * nb, h, i0, b);
      }
      const int i_last = min(i0 + BLOCK, p.Sq) - 1;
      int kv_end = p.Skv;
      if (p.causal) kv_end = min(kv_end, p.q_offset + i_last + 1);
      int stage = 0;
      uint32_t phase = 0;
      for (int t0 = 0; t0 < kv_end; t0 += TILE) {
        if (!tile_live(p, keep, i0, i_last, t0, min(t0 + TILE, p.Skv) - 1))
          continue;
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = stages + stage * DQ_STAGE;
        tile_t0[stage] = t0;
        mbar_arrive_expect_tx(&full[stage], 2 * TILE * NB * ROW);
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(st + nb * TILE * ROW, &tk, &full[stage], 64 * nb, hk,
                      t0, b);
          tma_load_4d(st + TILE_BYTES + nb * TILE * ROW, &tv, &full[stage],
                      64 * nb, hk, t0, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_wait(&empty[stage], phase ^ 1);
      tile_t0[stage] = -1;
      mbar_arrive(&full[stage]);
    }
  } else {
    setmaxnreg_inc<232>();
    dq_consume<D>(p, keep, lse2, delta, dq, sq, sdo, stages, full, empty,
                  qbar, tile_t0, i0, h, b, sq_pad);
  }
}

// [B, S, H, D] bf16 rows as a 4-D tensor map (D innermost), boxes of 64
// head-dim columns x `rows` positions of one head
inline int bshd_map(CUtensorMap* map, const void* base, int B, int S, int H,
                    int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * D;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                      strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, const int32_t* keep,
           float* aux, void* dq, void* dk, void* dv, int B, const Params& p,
           int sq_pad, cudaStream_t stream) {
  const size_t elem = 2ull * D;
  if (p.Skv == 0)                  // every row sees nothing
    return static_cast<int>(cudaMemsetAsync(
        dq, 0, elem * B * p.Sq * p.Hq, stream));
  int e;
  if (p.Sq == 0) {                 // no query: no gradient reaches k, v
    const size_t bytes = elem * B * p.Skv * p.Hkv;
    if ((e = static_cast<int>(cudaMemsetAsync(dk, 0, bytes, stream))) != 0)
      return e;
    return static_cast<int>(cudaMemsetAsync(dv, 0, bytes, stream));
  }
  float* lse2 = aux;
  float* delta = aux + static_cast<int64_t>(B) * p.Hq * sq_pad;
  // runtime calls first: they make the device's primary context current
  // on this thread, which cuTensorMapEncodeTiled needs (autograd
  // runs the backward on a thread of its own)
  auto dkdv = bwd_dkdv_wgmma_kernel<D>;
  auto dqk = bwd_dq_wgmma_kernel<D>;
  if ((e = static_cast<int>(cudaFuncSetAttribute(
           dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(DKDV_SMEM)))) != 0 ||
      (e = static_cast<int>(cudaFuncSetAttribute(
           dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(DQ_SMEM)))) != 0)
    return e;
  const int64_t rows = static_cast<int64_t>(B) * sq_pad * p.Hq;
  const int64_t prep_blocks = (rows + PREP_THREADS / 32 - 1)
                              / (PREP_THREADS / 32);
  if (prep_blocks > 2147483647LL) return -3;
  bwd_prep_kernel<D><<<static_cast<unsigned>(prep_blocks), PREP_THREADS, 0,
                       stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, lse2, delta, B, sq_pad,
      p);
  if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  CUtensorMap tq_t, tdo_t, tk_b, tv_b, tq_b, tdo_b, tk_t, tv_t;
  int r;
  if ((r = bshd_map(&tq_t, q, B, p.Sq, p.Hq, D, TILE)) ||
      (r = bshd_map(&tdo_t, dout, B, p.Sq, p.Hq, D, TILE)) ||
      (r = bshd_map(&tk_b, k, B, p.Skv, p.Hkv, D, BLOCK)) ||
      (r = bshd_map(&tv_b, v, B, p.Skv, p.Hkv, D, BLOCK)) ||
      (r = bshd_map(&tq_b, q, B, p.Sq, p.Hq, D, BLOCK)) ||
      (r = bshd_map(&tdo_b, dout, B, p.Sq, p.Hq, D, BLOCK)) ||
      (r = bshd_map(&tk_t, k, B, p.Skv, p.Hkv, D, TILE)) ||
      (r = bshd_map(&tv_t, v, B, p.Skv, p.Hkv, D, TILE)))
    return TENSOR_MAP_ERROR - r;
  dim3 grid_kv((p.Skv + BLOCK - 1) / BLOCK, p.Hkv, B);
  dkdv<<<grid_kv, THREADS, DKDV_SMEM, stream>>>(
      tq_t, tk_b, tv_b, tdo_t, lse2, delta, keep,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), p,
      sq_pad);
  if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  dim3 grid_q((p.Sq + BLOCK - 1) / BLOCK, p.Hq, B);
  dqk<<<grid_q, THREADS, DQ_SMEM, stream>>>(
      tq_b, tk_t, tv_t, tdo_b, lse2, delta, keep,
      static_cast<__nv_bfloat16*>(dq), p, sq_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq [B,Sq,Hq,D]; k, v, dk, dv [B,Skv,Hkv,D]: bf16 (dtype 1),
// contiguous and 16-byte aligned; D 64, 96 or 128; lse fp32 [B,Hq,Sq] from
// the forward; keep null or int32 [Sq/block_q, n_kv_blocks], as
// flash_mha_launch takes it; aux fp32 scratch of 2 x B x Hq x sq_pad
// floats, sq_pad a multiple of 128 at least Sq.  Three launches on
// `stream` (prep, dK/dV, dQ); every element of dq, dk and dv is written.
// Returns 0, a cudaError_t code, -1 / -2 / -3 for an unsupported head dim
// / dtype / shape, or TENSOR_MAP_ERROR - r when a tensor map cannot be
// encoded (r the CUresult, -1000 for a CUDA driver without the entry
// point).
// Never synchronises.
extern "C" int flash_mha_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* keep, void* aux,
    void* dq, void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
    int D, int causal, int q_offset, int window, int sink, int block_q,
    int block_kv, int n_kv_blocks, int sq_pad, int dtype, void* stream) {
  if (dtype != 1) return -2;
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 ||
      sq_pad % BLOCK != 0 || sq_pad < Sq ||
      (keep != nullptr && (block_q <= 0 || block_kv <= 0)))
    return -3;
  Params p{Sq, Skv, Hq, Hkv, causal, q_offset, window, sink, block_q,
           block_kv, n_kv_blocks, 1.0f / sqrtf(static_cast<float>(D))};
  const float* l = static_cast<const float*>(lse);
  const int32_t* kp = static_cast<const int32_t*>(keep);
  float* a = static_cast<float*>(aux);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, o, dout, l, kp, a, dq, dk, dv, B, p,
                               sq_pad, s);
    case 96: return launch<96>(q, k, v, o, dout, l, kp, a, dq, dk, dv, B, p,
                               sq_pad, s);
    case 128: return launch<128>(q, k, v, o, dout, l, kp, a, dq, dk, dv, B,
                                 p, sq_pad, s);
  }
  return -1;
}

extern "C" const char* flash_mha_bwd_wgmma_error_string(int code) {
  switch (code) {
    case -1: return "unsupported head dim (64, 96 or 128 on the tensor cores)";
    case -2: return "unsupported dtype (bfloat16 on the tensor cores)";
    case -3: return "unsupported shape (heads, batch, keep blocks or padding)";
  }
  if (code <= TENSOR_MAP_ERROR + 1000) {
    static thread_local char msg[112];
    snprintf(msg, sizeof msg, "tensor map encoding failed (%d: a CUresult, "
             "or -1000 for no cuTensorMapEncodeTiled in the CUDA driver)",
             TENSOR_MAP_ERROR - code);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
