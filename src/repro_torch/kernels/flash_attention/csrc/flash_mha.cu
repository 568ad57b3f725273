// Flash attention with the fidelity knobs (Hopper).
//
// Replaces the JAX reference's TPU kernel
// kernels/flash_attention/kernel.py::flash_mha_pallas (body _kernel).
// It computes the same function: for every (batch row b, query head h)
// the Sq queries of q [B,Sq,Hq,D] attend to k/v [B,Skv,Hkv,D] of KV head
// h / G (GQA, G = Hq / Hkv) with an fp32 online softmax, and the output
// [B,Sq,Hq,D] has q's dtype.  Query i sits at position q_offset + i.
// Visibility of key j to query i:
//   causal:  q_offset + i >= j, and with a window also
//            (j > q_offset + i - window or j < sink);
//   non-causal: every key (window and sink do not apply);
//   rho:     keep[i / block_q][j / block_kv] != 0 when a keep matrix
//            [Sq/block_q, Skv/block_kv] is given, at the CALLER's block
//            granularity (not a kernel's tiles).
// Masked probabilities are set to 0 explicitly (the Pallas body relies
// on exp(NEG_INF - m) and a later real maximum; here a row that sees
// nothing keeps l = 0 and returns 0, as the reference's mha does).
//
// Bound at the serving path's deepest shape (ardit-self-forcing, B = 1,
// Sq = 2640, Hq = Hkv = 12, D = 128, Skv = 21,197, bf16): 4*Sq*Skv*D*Hq
// = 343.8 GFLOP against ~0.15 GB of q/k/v/out, i.e. ~2,300 FLOP/byte,
// far above the H100's ~295 bf16 FLOP/byte ridge: operations-bound,
// 0.348 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// For training, both kernels also write each row's log-sum-exp of its
// scaled visible scores, lse = m + log l in fp32 (-inf for a row that
// sees nothing), when given an lse buffer; flash_mha_bwd.cu recomputes
// P from it.  Serving passes null and launches exactly as before.
//
// Three kernels; the wrapper picks one by dtype and head dim.
//
// bf16 at D = 96 or 128: flash_mha_wgmma, on
// the tensor cores.  A block owns 128 queries of one (b, head): a producer
// warpgroup, of which one thread issues TMA, and two consumer warpgroups
// of 64 query rows each (setmaxnreg moves the producer's registers to
// them).  Q arrives once by TMA and stays in shared memory as wgmma's A
// operand.  K and V come in 128-key tiles through a 3-stage ring guarded
// by mbarriers (full: TMA bytes landed; empty: all 8 consumer warps are
// done with the stage).  Rows are loaded through 4-D tensor maps
// [B, S, H, D] in place, in boxes of 64 head-dim columns with the
// 128-byte swizzle: D = 128 is two boxes; D = 96 too, the
// second box's last 32 columns lying outside the tensor and read as
// zeros.  TMA
// writes zeros past Sq and Skv as well.  S = Q K^T is an m64n128k16 bf16
// wgmma chain into fp32 registers (K stored [keys, D] is already the
// K-major B operand); masks and the online softmax work in the
// accumulator's register layout, with row maxima and sums reduced over
// the 4 lanes that share a row.  P is rounded to bf16 in registers and
// is directly the register A operand of O += P V (V stored [keys, D] is
// the MN-major, transposed B operand), O in fp32 registers.  Each tile
// issues S = Q K^T and then the previous tile's P V, so that P V runs
// while this tile's softmax does; the two consumer warpgroups take turns
// at issuing (named barriers), so that one's softmax overlaps the
// other's products.  Every tile issues the same wgmma sequence, with no
// data-dependent branch around it (ptxas serializes wgmmas otherwise):
// rows past Sq are computed and not stored, and the first tile's P V
// adds P = 0.  Masked scores become -inf against a running maximum that
// starts at -1e30, so a masked probability is exactly 0, also over the
// zero rows past Skv.  The producer skips tiles in which every (query,
// key) pair is masked (outside window and sink, rho-dropped for all of
// the block's query blocks) and stops at the last key a causal block
// can see; a tile start of -1 in the stage's slot ends the consumers'
// loop.  Unlike the TPU kernel, which keeps P in fp32, P enters P V in
// bf16, as SDPA does.
//
// bf16 at D = 64 (whisper-medium, granite-moe, minicpm-2b, qwen3-moe):
// flash_mha_wgmma64, the same arithmetic laid out for a head dim whose
// products are half as long as D 128's while the softmax is not.  At
// D 64 a 128 x 128 tile's exponentials take as long on the SFU (16 a
// clock an SM) as its two products on the tensor cores, and a short key
// axis (whisper's 1,500) leaves a one-tile block little work to hide its
// start and its stores behind.  So:
//   * persistent blocks: one block per SM walks items of 192 queries of
//     one (b, head), dealt in snake order (`ops.fwd_blocks` / `fwd_items`
//     mirror it): non-causal with the query tile fastest, so the items in
//     flight share a (b, KV head)'s K/V in L2; causal heaviest tile
//     first, so each block's sum of work evens out.  The producer loads
//     the next item's Q (two Q buffers) and first K/V tiles while the
//     consumers finish the current one;
//   * three consumer warpgroups of 64 rows (192 queries a K/V tile
//     read, against 128: a third less L2 traffic a query) taking turns at
//     issuing; setmaxnreg gives them 160 registers, the producer 32;
//     Q and each K/V stage one 64-column box, a 4-stage ring of 128 keys;
//   * the first tile of an item is peeled: it issues S only, the next
//     tile's P V overwrites O (scale-d 0) and the item ends with one P V,
//     so no product over P = 0 is issued; every item issues this same
//     sequence (a tile's last-of-item bit rides in its slot, an item
//     with no visible tile is one slot of -1);
//   * O is rescaled only when one of the warp's row maxima moved (a
//     warp-uniform test outside every wgmma), before the P V that adds to
//     it is issued; a lane keeps its share of a row's sum and the lanes
//     add theirs once, at the item's end;
//   * the softmax sits in each branch of the mask test, so that ptxas
//     keeps it ahead of the wait for the P V in flight;
//   * the output goes through a staging tile per warpgroup and a TMA
//     store that runs while the next item starts;
//   * each mode is its own instantiation (non-causal: only the key axis'
//     end is masked; causal: the diagonal too; window, sink or rho: the
//     general mask and the producer's skipping of dead tiles), so a call
//     carries no other mode's mask code and its registers.
//
// fp32 (the reduced configs), and bf16 at D = 16: flash_mha_kernel, the
// first port, on the CUDA cores.  A block owns 64 queries of one head
// and loops over Skv in 64-key tiles; K/V tiles are staged in shared
// memory as fp32 (bf16 widened on load), scores and P.V are fp32 FMAs on
// a 4x4 register tile per thread, the row-wise softmax reduces across a
// half-warp with shuffles, and the accumulator stays in registers.
// Tails are masked, the loop stops at the last key any of the block's
// queries can see, and fully masked tiles are skipped without loading.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <math.h>
#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int BLOCK_M = 64;     // queries per block
constexpr int BLOCK_N = 64;     // keys per tile
constexpr int THREADS = 256;    // 16 x 16 threads, 4x4 outputs each
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
__host__ __device__ constexpr int kp_floats() {
  // K tile [BLOCK_N][D+1]; the P tile [BLOCK_M][BLOCK_N+1] reuses it
  return BLOCK_N * (D + 1) > BLOCK_M * (BLOCK_N + 1)
             ? BLOCK_N * (D + 1) : BLOCK_M * (BLOCK_N + 1);
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (BLOCK_M * (D + 4) + kp_floats<D>()
                          + BLOCK_N * D);
}

struct Params {
  int Sq, Skv, Hq, Hkv, causal, q_offset, window, sink;
  int block_q, block_kv, n_kv_blocks;
  float scale;
};

// Whether query i (absolute position qp) sees key j.
__device__ __forceinline__ bool visible(const Params& p,
                                        const int32_t* __restrict__ keep,
                                        int i, int qp, int j) {
  if (j >= p.Skv) return false;
  if (p.causal) {
    if (qp < j) return false;
    if (p.window && !(j > qp - p.window || j < p.sink)) return false;
  }
  if (keep != nullptr &&
      keep[(i / p.block_q) * p.n_kv_blocks + j / p.block_kv] == 0)
    return false;
  return true;
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ keep,
                 T* __restrict__ out, float* __restrict__ lse, Params p) {
  constexpr int QS = D + 4;          // padded row strides (bank spread)
  constexpr int KS = D + 1;
  constexpr int PS = BLOCK_N + 1;
  constexpr int DC = D / 16;         // accumulator columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;                                  // [BLOCK_M][QS]
  float* Ks = Qs + BLOCK_M * QS;                     // [BLOCK_N][KS]
  float* Ps = Ks;                                    // [BLOCK_M][PS]
  float* Vs = Ks + kp_floats<D>();                   // [BLOCK_N][D]

  const int i0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;           // rows ty + 16*r
  const int tx = tid % 16;           // columns tx + 16*c
  const int i_last = min(i0 + BLOCK_M, p.Sq) - 1;

  // ---- the block's queries ----------------------------------------------
  for (int idx = tid; idx < BLOCK_M * D; idx += THREADS) {
    const int row = idx / D, c = idx % D;
    const int i = i0 + row;
    float val = 0.f;
    if (i < p.Sq) {
      const int64_t off =
          ((static_cast<int64_t>(b) * p.Sq + i) * p.Hq + h) * D + c;
      val = to_f32(q[off]);
    }
    Qs[row * QS + c] = val;
  }

  // keys past the last one any query of the block can see are never
  // visible (causal), so the tile loop stops there
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(kv_end, p.q_offset + i_last + 1);

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = NEG_INF;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int t0 = 0; t0 < kv_end; t0 += BLOCK_N) {
    const int t_last = min(t0 + BLOCK_N, kv_end) - 1;
    // skip a tile in which every (query, key) pair is masked
    if (p.causal && p.window && t0 >= p.sink &&
        t_last <= p.q_offset + i0 - p.window)
      continue;                      // left of every query's window
    if (keep != nullptr) {
      // any kept (q block, kv block) pair over the tile's keys and the
      // block's queries; the barrier also fences the previous tile
      const int qb0 = i0 / p.block_q, qb1 = i_last / p.block_q;
      const int kb0 = t0 / p.block_kv, kb1 = t_last / p.block_kv;
      const int nk = kb1 - kb0 + 1;
      int any = 0;
      for (int e = tid; e < (qb1 - qb0 + 1) * nk; e += THREADS)
        any |= keep[(qb0 + e / nk) * p.n_kv_blocks + kb0 + e % nk];
      if (!__syncthreads_or(any)) continue;
    } else {
      __syncthreads();               // previous tile's readers are done
    }

    for (int idx = tid; idx < BLOCK_N * D; idx += THREADS) {
      const int tok = idx / D, c = idx % D;
      const int t = t0 + tok;
      float kv = 0.f, vv = 0.f;
      if (t <= t_last) {
        const int64_t off =
            ((static_cast<int64_t>(b) * p.Skv + t) * p.Hkv + hk) * D + c;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[tok * KS + c] = kv;
      Vs[tok * D + c] = vv;
    }
    __syncthreads();

    // scores s = (q . k) * scale on a 4x4 register tile
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float a[4], bk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Qs[(ty + 16 * r) * QS + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * KS + kk];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(a[r], bk[j], s[r][j]);
    }

    // row-wise online softmax; a row's 64 columns live on the 16 lanes
    // of one half-warp
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      bool vis[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        vis[j] = i < p.Sq && t <= t_last &&
                 visible(p, keep, i, p.q_offset + i, t);
        s[r][j] = vis[j] ? s[r][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = expf(m_i[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // masked probabilities are 0, not exp(NEG_INF - m_new): a row
        // whose keys so far are all masked keeps l = 0
        s[r][j] = vis[j] ? expf(s[r][j] - m_new) : 0.f;
        rs += s[r][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[r] = l_i[r] * alpha + rs;
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }

    __syncthreads();                 // every thread is done with Ks
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * r) * PS + tx + 16 * j] = s[r][j];
    __syncthreads();

    // acc += P . V over the tile's keys
    const int n_tok = t_last - t0 + 1;
    for (int nn = 0; nn < n_tok; ++nn) {
      float pr[4], vr[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = Ps[(ty + 16 * r) * PS + nn];
#pragma unroll
      for (int c = 0; c < DC; ++c) vr[c] = Vs[nn * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c)
          acc[r][c] = fmaf(pr[r], vr[c], acc[r][c]);
    }
  }

  // ---- finalize: acc / l, rows that see nothing give 0 (lse -inf) ------
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= p.Sq) continue;
    const float inv = l_i[r] == 0.f ? 0.f : 1.f / l_i[r];
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * p.Hq + h) * p.Sq + i] =
          l_i[r] == 0.f ? -INFINITY : m_i[r] + logf(l_i[r]);
    const int64_t row = (static_cast<int64_t>(b) * p.Sq + i) * p.Hq + h;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(out + row * D + tx + 16 * c, acc[r][c] * inv);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v,
           const int32_t* keep, void* out, float* lse, int B,
           const Params& p, cudaStream_t stream) {
  auto kern = flash_mha_kernel<D, T>;
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((p.Sq + BLOCK_M - 1) / BLOCK_M, p.Hq, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), keep, static_cast<T*>(out), lse, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_t(const void* q, const void* k, const void* v,
             const int32_t* keep, void* out, float* lse, int B,
             const Params& p, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch<D, float>(q, k, v, keep, out, lse, B, p, stream);
    case 1: return launch<D, __nv_bfloat16>(q, k, v, keep, out, lse, B, p,
                                            stream);
  }
  return -2;
}

// ---- bf16 on the tensor cores ---------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BM = 128;          // queries per block: 2 consumer warpgroups
constexpr int BN = 128;          // keys per ring stage
constexpr int STAGES = 3;
constexpr int THREADS = 384;     // producer warpgroup + 2 consumers
constexpr int ROW = 128;         // bytes of one swizzled box row: 64 bf16
// room for two 64-column boxes (D 96 / 128)
constexpr int Q_BYTES = BM * 2 * ROW;
constexpr int KV_BYTES = BN * 2 * ROW;   // K (or V) of one stage
constexpr int STAGE_BYTES = 2 * KV_BYTES;
// 1024 bytes of slack to align the tiles, the barriers and tile starts
constexpr size_t SMEM_BYTES = 1024 + Q_BYTES + STAGES * STAGE_BYTES + 128;
constexpr float LOG2E = 1.4426950408889634f;

// Whether a tile [t0, t_last] has any visible (query, key) pair for the
// block's queries [i0, i_last]: the producer loads only such tiles.
__device__ bool tile_live(const Params& p, const int32_t* __restrict__ keep,
                          int i0, int i_last, int t0, int t_last) {
  if (p.causal && p.window && t0 >= p.sink &&
      t_last <= p.q_offset + i0 - p.window)
    return false;                  // left of every query's window
  if (keep == nullptr) return true;
  for (int qb = i0 / p.block_q; qb <= i_last / p.block_q; ++qb)
    for (int kb = t0 / p.block_kv; kb <= t_last / p.block_kv; ++kb)
      if (keep[qb * p.n_kv_blocks + kb]) return true;
  return false;
}

// Whether some pair of a warpgroup's 64 rows (from `first`) and the tile
// at t0 may be masked: the tile then takes the per-element test.
__device__ __forceinline__ bool tile_needs_mask(const Params& p, bool rho,
                                                int first, int t0) {
  if (rho || t0 + BN > p.Skv) return true;
  if (!p.causal) return false;
  const int qp_lo = p.q_offset + first, qp_hi = qp_lo + 63;
  if (t0 + BN - 1 > qp_lo) return true;
  return p.window && !(t0 > qp_hi - p.window || t0 + BN - 1 < p.sink);
}

// O += P V over a tile's keys in k16 steps (16 rows of V each)
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2],
                                        const uint32_t (&pa)[BN / 16][4],
                                        const uint8_t* sv) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < BN / 16; ++t) {
    const uint64_t desc = desc_sw128(sv + t * 16 * ROW, BN * ROW, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs_bf16_tb(o, pa[t], desc, 1);
    else
      wgmma_m64n96k16_rs_bf16_tb(o, pa[t], desc, 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ void release(uint64_t* empty, int stage,
                                        int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[stage]);
}

// Sets to -inf the scores of a tile that this thread's two rows (row0,
// row0 + 8) may not see: rows past Sq, keys past Skv or the causal edge,
// keys outside window and sink, rho-dropped blocks.
template <int NS>
__device__ __forceinline__ void mask_tile(float (&s)[NS], const Params& p,
                                          const int32_t* __restrict__ keep,
                                          int row0, int col0, int t0) {
  int hi[2], win[2];                // last visible key; window's first key
  const int32_t* krow[2];           // the row's line of the keep matrix
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    const int qp = p.q_offset + i;
    hi[r] = i < p.Sq ? p.Skv - 1 : -1;
    win[r] = INT_MIN;
    if (p.causal) {
      hi[r] = min(hi[r], qp);
      if (p.window) win[r] = qp - p.window + 1;
    }
    krow[r] = keep != nullptr && i < p.Sq
                  ? keep + (i / p.block_q) * p.n_kv_blocks : nullptr;
  }
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = t0 + 8 * j + col0 + c;
      const int kb = keep != nullptr ? key / p.block_kv : 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bool vis = key <= hi[r] && (key >= win[r] || key < p.sink);
        if (krow[r] != nullptr) vis = vis && krow[r][kb] != 0;
        if (!vis) s[4 * j + 2 * r + c] = __int_as_float(0xff800000);  // -inf
      }
    }
}

template <int D>
__device__ __forceinline__ void consume(
    const Params& p, const int32_t* __restrict__ keep,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    const uint8_t* sq, const uint8_t* skv,
    uint64_t* full, uint64_t* empty, uint64_t* qbar,
    const volatile int* tile_t0, int i0, int h, int b) {
  constexpr int NO = D / 2;        // O values per thread (m64nD)
  constexpr int NS = BN / 2;       // S values per thread (m64nBN)
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int first = i0 + 64 * cw;            // the warpgroup's first row
  const int row0 = first + 16 * warp + lane / 4;   // rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = p.scale * LOG2E;
  const uint8_t* q_wg = sq + 64 * cw * ROW;

  float o[NO], s[NS];
  uint32_t pa[BN / 16][4];          // P of the previous tile, bf16 pairs
#pragma unroll
  for (int c = 0; c < NO; ++c) o[c] = 0.f;
#pragma unroll
  for (int c = 0; c < NS; ++c) s[c] = 0.f;
#pragma unroll
  for (int t = 0; t < BN / 16; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[t][r] = 0u;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // The two consumer warpgroups take turns at issuing their products
  // (named barriers 1 and 2), so that one's softmax runs while the
  // other's products occupy the tensor cores; warpgroup 0 goes first.
  // Every tile issues the same wgmma sequence (rows past Sq are
  // computed and not stored; the first tile's P V adds P = 0 times its
  // own V): wgmmas under data-dependent branches would be serialized.
  if (cw == 1) named_arrive(1, 256);
  mbar_wait(qbar, 0);
  int stage = 0, prev = -1;         // prev: the stage P V still reads
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&full[stage], phase);
    const int t0 = tile_t0[stage];
    if (t0 < 0) break;
    named_sync(1 + cw, 256);
    // S = Q K^T over D in k16 steps: box kk/4, 32 bytes a step inside it
    const uint8_t* sk = skv + stage * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk % 4) * 32;
      wgmma_m64n128k16_ss_bf16(
          s, desc_sw128(q_wg + (kk / 4) * BM * ROW + off, 16, 1024),
          desc_sw128(sk + (kk / 4) * BN * ROW + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    // the previous tile's O += P V runs during this tile's softmax
    pv_tile<D>(o, pa, skv + (prev >= 0 ? prev : stage) * STAGE_BYTES +
                          KV_BYTES);
    named_arrive(2 - cw, 256);
    wgmma_wait<1>();
    fence_regs(s);

    if (tile_needs_mask(p, keep != nullptr, first, t0))
      mask_tile(s, p, keep, row0, col0, t0);
    // row maxima over the 4 lanes of a row, in the log2 domain (scale >
    // 0, so the maximum of the raw scores scales with them)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int c = 0; c < NS; ++c)
      mx[(c >> 1) & 1] = fmaxf(mx[(c >> 1) & 1], s[c]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // the running maximum stays >= NEG_INF: masked scores give 0
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      s[c] = exp2_approx(fmaf(s[c], scale_log2, -m[(c >> 1) & 1]));
      rs[(c >> 1) & 1] += s[c];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }

    wgmma_wait<0>();
    fence_regs(o);
    if (prev >= 0) release(empty, prev, lane);
#pragma unroll
    for (int c = 0; c < NO; ++c) o[c] *= alpha[(c >> 1) & 1];
    // P in bf16: the accumulator layout of 16 keys is an A fragment
#pragma unroll
    for (int t = 0; t < BN / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (cw == 0) named_sync(1, 256);  // warpgroup 1's last turn
  if (prev >= 0) {
    pv_tile<D>(o, pa, skv + prev * STAGE_BYTES + KV_BYTES);
    wgmma_wait<0>();
    fence_regs(o);
    release(empty, prev, lane);
  }

  // finalize: O / l, rows that see nothing give 0 (lse -inf), rows past
  // Sq unstored; m is in the log2 domain, lse in the natural one
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i >= p.Sq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    if (lse != nullptr && lane % 4 == 0)
      lse[(static_cast<int64_t>(b) * p.Hq + h) * p.Sq + i] =
          l[r] == 0.f ? -INFINITY : (m[r] + log2f(l[r])) / LOG2E;
    __nv_bfloat16* dst =
        out + ((static_cast<int64_t>(b) * p.Sq + i) * p.Hq + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_mha_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const int32_t* __restrict__ keep,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* skv = sq + Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(skv + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  volatile int* tile_t0 = reinterpret_cast<volatile int*>(qbar + 1);

  const int i0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);    // every consumer warp
    }
    mbar_init(qbar, 1);
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
      constexpr int NB = (D + 63) / 64;   // 64-column boxes of a row
      mbar_arrive_expect_tx(qbar, BM * NB * ROW);
      tma_load_4d(sq, &tq, qbar, 0, h, i0, b);
      if (NB == 2) tma_load_4d(sq + BM * ROW, &tq, qbar, 64, h, i0, b);
      const int i_last = min(i0 + BM, p.Sq) - 1;
      int kv_end = p.Skv;
      if (p.causal) kv_end = min(kv_end, p.q_offset + i_last + 1);
      int stage = 0;
      uint32_t phase = 0;
      for (int t0 = 0; t0 < kv_end; t0 += BN) {
        if (!tile_live(p, keep, i0, i_last, t0, min(t0 + BN, kv_end) - 1))
          continue;
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* sk = skv + stage * STAGE_BYTES;
        uint8_t* sv = sk + KV_BYTES;
        tile_t0[stage] = t0;
        mbar_arrive_expect_tx(&full[stage], 2 * BN * NB * ROW);
        tma_load_4d(sk, &tk, &full[stage], 0, hk, t0, b);
        tma_load_4d(sv, &tv, &full[stage], 0, hk, t0, b);
        if (NB == 2) {
          tma_load_4d(sk + BN * ROW, &tk, &full[stage], 64, hk, t0, b);
          tma_load_4d(sv + BN * ROW, &tv, &full[stage], 64, hk, t0, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_wait(&empty[stage], phase ^ 1);
      tile_t0[stage] = -1;         // end of the tiles
      mbar_arrive(&full[stage]);
    }
  } else {
    setmaxnreg_inc<232>();
    consume<D>(p, keep, out, lse, sq, skv, full, empty, qbar, tile_t0, i0, h,
               b);
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

// The host's per-call cost.  A tensor map is a pure function of
// bshd_map's arguments (pointer, dims, hence strides, box), so encoded
// maps are kept in a cache keyed by them and a hit is always right; a
// kernel's shared-memory attribute is set once per device.
struct MapKey {
  const void* base;
  int B, S, H, D, rows;
  bool operator==(const MapKey& o) const {
    return base == o.base && B == o.B && S == o.S && H == o.H && D == o.D &&
           rows == o.rows;
  }
};

class MapCache {
 public:
  bool find(const MapKey& key, CUtensorMap* map) {
    std::lock_guard<std::mutex> lock(mu_);
    for (int i = 0; i < n_; ++i)
      if (keys_[i] == key) {
        *map = maps_[i];
        return true;
      }
    return false;
  }
  void put(const MapKey& key, const CUtensorMap& map) {
    std::lock_guard<std::mutex> lock(mu_);
    const int i = n_ < N ? n_++ : next_++ % N;   // round-robin once full
    keys_[i] = key;
    maps_[i] = map;
  }

 private:
  static constexpr int N = 256;
  std::mutex mu_;
  MapKey keys_[N];
  CUtensorMap maps_[N];
  int n_ = 0, next_ = 0;
};

inline MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

// The maps of `n` keys into `maps`.  On a miss the kernel's
// shared-memory attribute is set first: a runtime call that makes the
// device's primary context current on this thread, which
// cuTensorMapEncodeTiled needs (autograd may recompute a checkpointed
// forward on a thread of its own); otherwise it is set once per device.
// Returns 0, a cudaError_t code, or -4 when a map cannot be encoded.  At
// most 4 keys.
template <typename Kernel>
int maps_and_attribute(Kernel kern, size_t smem, std::atomic<uint64_t>& set,
                       const MapKey* keys, CUtensorMap* maps, int n) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  bool found[4], hit = true;
  for (int i = 0; i < n; ++i) {
    found[i] = map_cache().find(keys[i], &maps[i]);
    hit = hit && found[i];
  }
  const uint64_t bit = 1ull << (dev & 63);
  if (!hit || !(set.load() & bit)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    set.fetch_or(bit);
  }
  if (hit) return 0;
  for (int i = 0; i < n; ++i) {
    if (found[i]) continue;
    const MapKey& k = keys[i];
    if (bshd_map(&maps[i], k.base, k.B, k.S, k.H, k.D, k.rows)) return -4;
    map_cache().put(k, maps[i]);
  }
  return 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int32_t* keep,
           void* out, float* lse, int B, const Params& p,
           cudaStream_t stream) {
  if (p.Skv == 0) {                // every row sees nothing (the wrapper
                                   // fills lse with -inf)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, 2ull * B * p.Sq * p.Hq * D, stream));
  }
  static std::atomic<uint64_t> attribute_set{0};
  auto kern = flash_mha_wgmma_kernel<D>;
  const MapKey keys[3] = {{q, B, p.Sq, p.Hq, D, BM},
                          {k, B, p.Skv, p.Hkv, D, BN},
                          {v, B, p.Skv, p.Hkv, D, BN}};
  CUtensorMap maps[3];
  const int err = maps_and_attribute(kern, SMEM_BYTES, attribute_set, keys,
                                     maps, 3);
  if (err) return err;
  dim3 grid((p.Sq + BM - 1) / BM, p.Hq, B);
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], keep, static_cast<__nv_bfloat16*>(out), lse,
      p);
  return static_cast<int>(cudaGetLastError());
}


// ---- bf16 at D = 64: persistent blocks of three consumer warpgroups ----

namespace d64 {

constexpr int WGS = 3;                 // consumer warpgroups, 64 rows each
constexpr int BM = 64 * WGS;           // queries per item
constexpr int THREADS = 128 * (WGS + 1);
constexpr int Q_BYTES = BM * ROW;      // one 64-column box
constexpr int NS = BN / 2;             // S values per thread (m64n128)
constexpr int NO = 32;                 // O values per thread (m64n64)
constexpr int TURN_BAR = 1;            // named barriers 1..3: turns
constexpr int STORE_BAR = 1 + WGS;     // 4..6: a warpgroup's staging

// The persistent schedule (ops.fwd_items mirrors it).  Items are ranked
// and dealt to the blocks in snake order: block j takes rank m G + j in
// even rounds m and m G + G - 1 - j in odd ones (G blocks), so that where
// ranks fall in cost each block's sum evens out.  Returns -1 past the
// last item.
__device__ __forceinline__ int item_rank(int m, int n_items) {
  const int G = gridDim.x, j = blockIdx.x;
  const int r = m * G + ((m & 1) ? G - 1 - j : j);
  return r < n_items ? r : -1;
}

// Rank r's (query tile, head, batch row).  Non-causal items cost the
// same: the query tile varies fastest, so the items in flight share a
// (b, KV head)'s K/V in L2.  Causal items fall in cost with the query
// tile: ranked by tile, last (heaviest) first, then head, then batch.
__device__ __forceinline__ void item_of(int r, int n_qt, int Hq, int B,
                                        int causal, int& qt, int& h,
                                        int& b) {
  int hb;
  if (causal) {
    qt = n_qt - 1 - r / (B * Hq);
    hb = r % (B * Hq);
  } else {
    qt = r % n_qt;
    hb = r / n_qt;
  }
  h = hb % Hq;
  b = hb / Hq;
}

template <int STAGES>
__device__ __forceinline__ void advance_ring(int& stage, uint32_t& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// S = Q K^T over the 64 columns: four k16 steps, 32 bytes apart in the box
__device__ __forceinline__ void qk(float (&s)[NS], const uint8_t* q_wg,
                                   const uint8_t* sk) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16_ss_bf16(s, desc_sw128(q_wg + kk * 32, 16, 1024),
                             desc_sw128(sk + kk * 32, 16, 1024), kk > 0);
  wgmma_commit();
}

// O (+)= P V over a tile's keys in k16 steps; scale0 = 0 overwrites O
__device__ __forceinline__ void pv(float (&o)[NO],
                                   const uint32_t (&pa)[BN / 16][4],
                                   const uint8_t* sv, int scale0) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < BN / 16; ++t)
    wgmma_m64n64k16_rs_bf16_tb(
        o, pa[t], desc_sw128(sv + t * 16 * ROW, BN * ROW, 1024),
        t == 0 ? scale0 : 1);
  wgmma_commit();
}

// The online softmax of one tile in the log2 domain: s becomes P, m and l
// advance; returns whether one of the thread's two row maxima moved
// (alpha then holds their rescaling factors, else 1).  FIRST: the item's
// first tile, whose l starts at the tile's sum.  m is the row's maximum
// (reduced over the 4 lanes of a row), l this thread's share of the row
// sum: the lanes' shares add up once, when the item ends.
template <bool FIRST>
__device__ __forceinline__ bool softmax(float (&s)[NS], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        float scale_log2) {
  float mx[2] = {NEG_INF, NEG_INF}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NS; ++c)
    mx[(c >> 1) & 1] = fmaxf(mx[(c >> 1) & 1], s[c]);
  bool moved = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // the running maximum stays >= NEG_INF: masked scores give 0
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = 1.f;
    if (!FIRST && m_new > m[r]) {
      alpha[r] = exp2_approx(m[r] - m_new);
      moved = true;
    }
    m[r] = m_new;
  }
  const float neg_m[2] = {-m[0], -m[1]};
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    s[c] = exp2_approx(fmaf(s[c], scale_log2, neg_m[(c >> 1) & 1]));
    rs[(c >> 1) & 1] += s[c];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = FIRST ? rs[r] : l[r] * alpha[r] + rs[r];
  return moved;
}

// O *= alpha row by row, where one of the warp's row maxima moved (a
// warp-uniform test: no wgmma sits under it); O is not in flight
__device__ __forceinline__ void rescale(float (&o)[NO], const float (&alpha)[2],
                                        bool moved) {
  if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
    for (int c = 0; c < NO; ++c) o[c] *= alpha[(c >> 1) & 1];
  }
}

// P in bf16: the accumulator layout of 16 keys is an A fragment
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4],
                                       const float (&s)[NS]) {
#pragma unroll
  for (int t = 0; t < BN / 16; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
}

// O / l in bf16 into the warpgroup's staging rows `so_wg` in the 128-byte
// swizzle (their previous store has read them), then one TMA store of the
// 64 rows from `first` (rows past Sq are not written); rows that see
// nothing give 0 (lse -inf).  l arrives as each lane's share of its row
// sums; m is in the log2 domain, lse in the natural one.
__device__ __forceinline__ void store_rows(
    const Params& p, const CUtensorMap* to, float* __restrict__ lse,
    const float (&o)[NO], const float (&m)[2], float (&l)[2],
    uint8_t* so_wg, int cw, int first, int h, int b) {
  const int tw = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int lr0 = 16 * (tw / 32) + lane / 4, col0 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {             // the row sums over its 4 lanes
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  named_sync(STORE_BAR + cw, 128);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = lr0 + 8 * r, i = first + lr;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    uint8_t* dst = so_wg + lr * ROW + col0 * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + ((j ^ (lr & 7)) << 4)) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (lse != nullptr && lane % 4 == 0 && i < p.Sq)
      lse[(static_cast<int64_t>(b) * p.Hq + h) * p.Sq + i] =
          l[r] == 0.f ? -INFINITY : (m[r] + log2f(l[r])) / LOG2E;
  }
  fence_proxy_async();
  named_sync(STORE_BAR + cw, 128);
  if (tw == 0 && first < p.Sq) {
    tma_store_4d(to, so_wg, 0, h, first, b);
    bulk_commit();
  }
}

constexpr int STAGES = 4;
constexpr int KV_BYTES = BN * ROW;     // K (or V) of one stage
constexpr int STAGE_BYTES = 2 * KV_BYTES;
constexpr int O_BYTES = 64 * ROW;      // a warpgroup's staged output rows
// two Q buffers, the output staging, the ring; barriers and tile slots
constexpr size_t SMEM_BYTES =
    1024 + 2 * Q_BYTES + WGS * O_BYTES + STAGES * STAGE_BYTES + 256;

// keys t0 + col >= Skv score -inf (a non-causal item's last tile)
__device__ __forceinline__ void mask_tail(float (&s)[NS], int col0,
                                          int n_keys) {
  const int lim = n_keys - col0;       // columns 8 j + c from this lane's
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (8 * j + c >= lim) {
        s[4 * j + c] = __int_as_float(0xff800000);
        s[4 * j + 2 + c] = __int_as_float(0xff800000);
      }
}

// Rows past Sq, keys past Skv or past the causal edge score -inf (causal
// without window, sink or rho)
__device__ __forceinline__ void mask_causal(float (&s)[NS], const Params& p,
                                            int row0, int col0, int t0) {
  int lim[2];                          // last visible column 8 j + c
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    lim[r] = (i < p.Sq ? min(p.Skv - 1, p.q_offset + i) : -1) - t0 - col0;
  }
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (8 * j + c > lim[r]) s[4 * j + 2 * r + c] = __int_as_float(0xff800000);
}

// The modes, each its own instantiation, so that a call carries only its
// mode's mask code (the general one's costs registers)
enum Mode { NONCAUSAL = 0, CAUSAL = 1, MASKED = 2 };   // MASKED: window,
                                                       // sink or rho

// The scores' masks, then the online softmax.  Non-causal items see every
// key but those past Skv; causal ones mask the tiles that cross the
// diagonal or the key axis' end; the rest take tile_needs_mask's test and
// mask_tile.  Each branch holds its own softmax: after a join the softmax
// would share a block with the wgmma wait that follows it, which ptxas
// then schedules first, and the softmax would no longer overlap the P V
// in flight.
template <int MODE, bool FIRST>
__device__ __forceinline__ bool mask_softmax(
    float (&s)[NS], const Params& p, const int32_t* __restrict__ keep,
    int first, int row0, int col0, int t0, float (&m)[2], float (&l)[2],
    float (&alpha)[2], float scale_log2) {
  if constexpr (MODE == NONCAUSAL) {
    if (t0 + BN > p.Skv) {
      mask_tail(s, col0, p.Skv - t0);
      return softmax<FIRST>(s, m, l, alpha, scale_log2);
    }
  } else if constexpr (MODE == CAUSAL) {
    if (t0 + BN > p.Skv || t0 + BN - 1 > p.q_offset + first) {
      mask_causal(s, p, row0, col0, t0);
      return softmax<FIRST>(s, m, l, alpha, scale_log2);
    }
  } else if (tile_needs_mask(p, keep != nullptr, first, t0)) {
    mask_tile(s, p, keep, row0, col0, t0);
    return softmax<FIRST>(s, m, l, alpha, scale_log2);
  }
  return softmax<FIRST>(s, m, l, alpha, scale_log2);
}

template <int MODE>
__device__ __forceinline__ void consume(
    const Params& p, const int32_t* __restrict__ keep, const CUtensorMap* to,
    float* __restrict__ lse, const uint8_t* sq, const uint8_t* skv,
    uint8_t* so, uint64_t* full, uint64_t* empty, uint64_t* qfull,
    uint64_t* qempty, const volatile int* slot, int B, int n_qt,
    int n_items) {
  const int cw = threadIdx.x / 128 - 1;
  const int tw = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int warp = tw / 32;
  const int col0 = 2 * (lane % 4);
  const int lr0 = 16 * warp + lane / 4;      // rows lr0, lr0 + 8 of 64
  const float scale_log2 = p.scale * LOG2E;
  const int turn = TURN_BAR + cw, next_turn = TURN_BAR + (cw + 1) % WGS;
  uint8_t* so_wg = so + cw * O_BYTES;

  float o[NO], s[NS];
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int c = 0; c < NO; ++c) o[c] = 0.f;
#pragma unroll
  for (int c = 0; c < NS; ++c) s[c] = 0.f;

  // The warpgroups take turns at issuing their products, 0, 1, 2, 0, ...
  // across tiles and items (every warpgroup runs every tile); the last
  // one's arrival opens warpgroup 0's first turn.
  if (cw == WGS - 1) named_arrive(TURN_BAR, 256);
  int stage = 0;
  uint32_t phase = 0;
  for (int k = 0, r = item_rank(0, n_items); r >= 0;
       r = item_rank(++k, n_items)) {
    int qt, h, b;
    item_of(r, n_qt, p.Hq, B, p.causal, qt, h, b);
    const int first = qt * BM + 64 * cw;     // the warpgroup's first row
    const int row0 = first + lr0;
    const int qb = k & 1;
    const uint8_t* q_wg = sq + qb * Q_BYTES + 64 * cw * ROW;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    mbar_wait(&qfull[qb], (k >> 1) & 1);
    mbar_wait(&full[stage], phase);
    int info = slot[stage];
    if (info < 0) {                          // no visible tile: O = 0
      release(empty, stage, lane);
      advance_ring<STAGES>(stage, phase);
#pragma unroll
      for (int c = 0; c < NO; ++c) o[c] = 0.f;
    } else {
      // the first tile: S only
      int t0 = info >> 1;
      bool last = info & 1;
      named_sync(turn, 256);
      qk(s, q_wg, skv + stage * STAGE_BYTES);
      named_arrive(next_turn, 256);
      wgmma_wait<0>();
      fence_regs(s);
      bool moved = mask_softmax<MODE, true>(s, p, keep, first, row0, col0, t0,
                                          m, l, alpha, scale_log2);
      pack_p(pa, s);
      int prev = stage, scale0 = 0;          // the first P V overwrites O
      advance_ring<STAGES>(stage, phase);
      while (!last) {
        mbar_wait(&full[stage], phase);
        info = slot[stage];
        t0 = info >> 1;
        last = info & 1;
        named_sync(turn, 256);
        qk(s, q_wg, skv + stage * STAGE_BYTES);
        // O to the previous tile's maximum, then the previous tile's
        // O += P V, which runs during this tile's softmax
        rescale(o, alpha, moved);
        pv(o, pa, skv + prev * STAGE_BYTES + KV_BYTES, scale0);
        named_arrive(next_turn, 256);
        wgmma_wait<1>();
        fence_regs(s);
        moved = mask_softmax<MODE, false>(s, p, keep, first, row0, col0, t0, m,
                                        l, alpha, scale_log2);
        wgmma_wait<0>();
        fence_regs(o);
        release(empty, prev, lane);
        pack_p(pa, s);
        prev = stage;
        scale0 = 1;
        advance_ring<STAGES>(stage, phase);
      }
      // the last tile's P V
      named_sync(turn, 256);
      rescale(o, alpha, moved);
      pv(o, pa, skv + prev * STAGE_BYTES + KV_BYTES, scale0);
      named_arrive(next_turn, 256);
      wgmma_wait<0>();
      fence_regs(o);
      release(empty, prev, lane);
    }
    release(qempty, qb, lane);
    if (tw == 0) bulk_wait_read();          // the last store has read so_wg
    store_rows(p, to, lse, o, m, l, so_wg, cw, first, h, b);
  }
  if (cw == 0) named_sync(TURN_BAR, 256);  // the last one's turn
  if (tw == 0) bulk_wait_all();
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
flash_mha_wgmma64_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap to,
                         const int32_t* __restrict__ keep,
                         float* __restrict__ lse, Params p, int B,
                         int n_qt, int n_items) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* so = sq + 2 * Q_BYTES;
  uint8_t* skv = so + WGS * O_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(skv + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 2;
  // a stage's tile: 2 * t0 + (last tile of its item), or -1 for an item
  // with no visible tile
  volatile int* slot = reinterpret_cast<volatile int*>(qempty + 2);

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * WGS);  // every consumer warp
    }
    for (int st = 0; st < 2; ++st) {
      mbar_init(&qfull[st], 1);
      mbar_init(&qempty[st], 4 * WGS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    setmaxnreg_dec<32>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      tma_prefetch(&to);
      int stage = 0;
      uint32_t phase = 0;
      for (int k = 0, r = item_rank(0, n_items); r >= 0;
           r = item_rank(++k, n_items)) {
        int qt, h, b;
        item_of(r, n_qt, p.Hq, B, p.causal, qt, h, b);
        const int i0 = qt * BM, hk = h / (p.Hq / p.Hkv);
        const int qb = k & 1;
        mbar_wait(&qempty[qb], ((k >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&qfull[qb], Q_BYTES);
        tma_load_4d(sq + qb * Q_BYTES, &tq, &qfull[qb], 0, h, i0, b);
        const int i_last = min(i0 + BM, p.Sq) - 1;
        int kv_end = p.Skv;
        if (p.causal) kv_end = min(kv_end, p.q_offset + i_last + 1);
        // the item's live tiles (all up to kv_end unless MASKED), each
        // published with whether it is the last: the next live one is
        // found before a tile goes out
        auto next_live = [&](int t0) {
          for (; t0 < kv_end; t0 += BN)
            if (MODE != MASKED || tile_live(p, keep, i0, i_last, t0,
                                            min(t0 + BN, kv_end) - 1))
              return t0;
          return -1;
        };
        int t0 = next_live(0);
        if (t0 < 0) {
          mbar_wait(&empty[stage], phase ^ 1);
          slot[stage] = -1;
          mbar_arrive(&full[stage]);
          advance_ring<STAGES>(stage, phase);
        }
        while (t0 >= 0) {
          const int tn = next_live(t0 + BN);
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* sk = skv + stage * STAGE_BYTES;
          slot[stage] = 2 * t0 + (tn < 0);
          mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
          tma_load_4d(sk, &tk, &full[stage], 0, hk, t0, b);
          tma_load_4d(sk + KV_BYTES, &tv, &full[stage], 0, hk, t0, b);
          advance_ring<STAGES>(stage, phase);
          t0 = tn;
        }
      }
    }
  } else {
    setmaxnreg_inc<160>();
    consume<MODE>(p, keep, &to, lse, sq, skv, so, full, empty, qfull, qempty,
                  slot, B, n_qt, n_items);
  }
}

// n_blocks: the persistent grid (ops.fwd_blocks: one block per SM, at
// most one per item)
template <int MODE>
int launch_mode(const void* q, const void* k, const void* v,
                const int32_t* keep, void* out, float* lse, int B,
                const Params& p, int n_blocks, cudaStream_t stream) {
  const int n_qt = (p.Sq + BM - 1) / BM;
  const long long n_items = static_cast<long long>(B) * p.Hq * n_qt;
  if (n_blocks <= 0 || n_blocks > n_items || n_items > INT_MAX) return -3;
  static std::atomic<uint64_t> attribute_set{0};
  const MapKey keys[4] = {{q, B, p.Sq, p.Hq, 64, BM},
                          {k, B, p.Skv, p.Hkv, 64, BN},
                          {v, B, p.Skv, p.Hkv, 64, BN},
                          {out, B, p.Sq, p.Hq, 64, 64}};
  CUtensorMap maps[4];
  auto kern = flash_mha_wgmma64_kernel<MODE>;
  const int err = maps_and_attribute(kern, SMEM_BYTES, attribute_set, keys,
                                     maps, 4);
  if (err) return err;
  kern<<<n_blocks, THREADS, SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], keep, lse, p, B, n_qt,
      static_cast<int>(n_items));
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, const int32_t* keep,
           void* out, float* lse, int B, const Params& p, int n_blocks,
           cudaStream_t stream) {
  if (p.Skv == 0) {                // every row sees nothing (the wrapper
                                   // fills lse with -inf)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, 2ull * B * p.Sq * p.Hq * 64, stream));
  }
  // (the wrapper takes rho only on the causal schedule, window and sink
  // only causal)
  const int mode = !p.causal ? NONCAUSAL
                   : (p.window || p.sink || keep != nullptr) ? MASKED
                                                            : CAUSAL;
  switch (mode) {
    case NONCAUSAL:
      return launch_mode<NONCAUSAL>(q, k, v, keep, out, lse, B, p, n_blocks,
                                    stream);
    case CAUSAL:
      return launch_mode<CAUSAL>(q, k, v, keep, out, lse, B, p, n_blocks,
                                 stream);
  }
  return launch_mode<MASKED>(q, k, v, keep, out, lse, B, p, n_blocks, stream);
}

}  // namespace d64

}  // namespace tc


}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
// keep: null, or int32 [Sq/block_q, n_kv_blocks] with n_kv_blocks =
// Skv/block_kv.  lse: null (serving), or fp32 [B, Hq, Sq] that receives
// each row's log-sum-exp of its scaled visible scores (-inf for a row
// that sees nothing), which the backward (flash_mha_bwd.cu) reads.  Returns 0, a cudaError_t code, or -1 / -2 / -3 for an
// unsupported head dim / dtype / shape.  Launches on `stream`; never
// synchronises.
extern "C" int flash_mha_launch(
    const void* q, const void* k, const void* v, const void* keep,
    void* out, void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    int causal,
    int q_offset, int window, int sink, int block_q, int block_kv,
    int n_kv_blocks, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 ||
      (keep != nullptr && (block_q <= 0 || block_kv <= 0)))
    return -3;
  Params p{Sq, Skv, Hq, Hkv, causal, q_offset, window, sink, block_q,
           block_kv, n_kv_blocks, 1.0f / sqrtf(static_cast<float>(D))};
  const int32_t* kp = static_cast<const int32_t*>(keep);
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_t<16>(q, k, v, kp, out, lp, B, p, dtype, s);
    case 64: return launch_t<64>(q, k, v, kp, out, lp, B, p, dtype, s);
    case 96: return launch_t<96>(q, k, v, kp, out, lp, B, p, dtype, s);
    case 128: return launch_t<128>(q, k, v, kp, out, lp, B, p, dtype, s);
  }
  return -1;
}

// The tensor-core kernels: bf16 q, k, v and out, D = 64, 96 or 128, the
// arguments of flash_mha_launch (dtype must be 1) and, at D 64, the
// persistent grid n_blocks (ops.fwd_blocks; ignored at D 96 / 128).  q,
// k, v and out must be 16-byte aligned.  Returns as flash_mha_launch, or
// -4 when a tensor map cannot be encoded (alignment, or a driver without
// the entry point).
extern "C" int flash_mha_wgmma_launch(
    const void* q, const void* k, const void* v, const void* keep,
    void* out, void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    int causal,
    int q_offset, int window, int sink, int block_q, int block_kv,
    int n_kv_blocks, int dtype, int n_blocks, void* stream) {
  if (dtype != 1) return -2;
  if (B == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 ||
      (keep != nullptr && (block_q <= 0 || block_kv <= 0)))
    return -3;
  Params p{Sq, Skv, Hq, Hkv, causal, q_offset, window, sink, block_q,
           block_kv, n_kv_blocks, 1.0f / sqrtf(static_cast<float>(D))};
  const int32_t* kp = static_cast<const int32_t*>(keep);
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return tc::d64::launch(q, k, v, kp, out, lp, B, p, n_blocks, s);
    case 96: return tc::launch<96>(q, k, v, kp, out, lp, B, p, s);
    case 128: return tc::launch<128>(q, k, v, kp, out, lp, B, p, s);
  }
  return -1;
}

extern "C" const char* flash_mha_error_string(int code) {
  switch (code) {
    case -1: return "unsupported head dim (16, 64, 96 or 128; 64, 96 or 128 "
                    "on the tensor cores)";
    case -2: return "unsupported dtype (float32 or bfloat16; bfloat16 on "
                    "the tensor cores)";
    case -3: return "unsupported shape (heads, batch, keep blocks or "
                    "persistent blocks)";
    case -4: return "tensor map encoding failed (alignment, or no "
                    "cuTensorMapEncodeTiled in the driver)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
