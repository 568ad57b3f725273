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
// Four kernels of flash_mha; the wrapper picks one by dtype, head dim and
// mode (ops.fwd_instance).  A fifth, the seeded form below, is an op of
// its own (ops.flash_mha_seeded).
//
// bf16 at D = 96, and at D = 128 in every mode but the plain causal one:
// flash_mha_wgmma, on the tensor cores.  A block owns 128 queries of one (b, head): a producer
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
// bf16 at D = 128, causal without window, sink or rho (minitron-8b's and
// internvl2-26b's prefill): flash_mha_wgmma128, the D 64 design carried
// to D 128 where the card's resources allow, changed where the H100 said
// otherwise (PERF.md, the ablations at row 3c):
//   * two consumer warpgroups of 64 rows (items of 128 queries), not
//     three: each thread keeps O (64 fp32), S (64 fp32) and P (32 bf16
//     pairs) live, more than three warpgroups' 160 registers hold;
//     setmaxnreg gives them 232, the producer 40;
//   * persistent blocks, one an SM, take items as they come free from an
//     atomic counter (the wrapper zeroes it), in the order of ops.fwd_item:
//     by (batch row, KV head), then query tile, heaviest first, then head,
//     so the items in flight read one or two K/V prefixes in L2 and the
//     last items are the lightest;
//   * where the KV group's size is even, a cluster of two blocks takes two
//     heads of one group at one query tile, whose K/V tiles are the same:
//     each block loads one 64-column box of a tile and multicasts it into
//     both, so L2 sends each K/V byte to two SMs (the K/V stages' empty
//     barriers count both blocks' consumers; block 0 fetches the items);
//   * only the diagonal, the key axis' end and rows past Sq are masked (a
//     tile strictly below the diagonal takes no test), the producer walks
//     keys [0, q_offset + the item's last row], O is rescaled only when
//     a warp's row maxima moved, before the P V that adds to it is issued;
//     the softmax follows the mask branch's join (one softmax in each
//     branch, as at D 64, was slower here);
//   * K and V have rings of their own, 2 and 3 stages: K is released once
//     S has read it, V only once P V has, a tile later, so V's ring is
//     the deeper; the producer loads K a tile ahead of V, and an item's
//     first K before its Q; Q is released after the item's last S, so the
//     next item's Q loads during its last softmax;
//   * the output leaves through a staging tile per warpgroup and TMA
//     stores that run while the next item starts.
// Shared memory is the constraint (232,448 bytes a block): the general
// kernel's 1 KB + Q 32 KB + 3 stages of K and V (192 KB) leave no room
// for staging.  Here:
//   Q (32 KB) + output staging (2 x 16 KB) + K ring (2 x 32 KB) + V ring
//   (3 x 32 KB) = 224 KB, + 1 KB for alignment + 256 bytes of barriers
//   and slots = 230,656 bytes
// (3 K and 2 V stages were 1% slower; a second Q buffer with 2 + 2
// stages, and 3 + 3 with O stored from registers, slower still).
//
// The seeded form, flash_mha_seeded_kernel (bf16 at D 96 and 128): the
// in-chunk segment of attention.paged_mha, which replaces no TPU kernel
// (the reference runs that segment as jnp).  Each query row attends to
// its chunk's own keys, all visible, and its online softmax starts from
// kernel 1's partials of the same row over the paged context
// (paged_chunk_attention.cu: m in natural units, l, acc in fp32; a row
// that sees nothing holds m = -1e30, l = 0, acc = 0), so that the merge,
// the divide and the output's [B, S, H, D] layout are this launch's and
// no fp32 score tensor is made.  Bound: 4 Sq Skv D Hq operations (134.6
// GFLOP a row and layer at 4,680 tokens, 12 heads of 128; 0.136 ms at 989
// TFLOP/s) against ~90 MB of q, k, v, partials and output: operations-
// bound.  It is the D 128 instance's code without its clusters, with the
// mask of the key axis' end only, at D 96 too (two 64-column boxes, the
// second half zeros; O m64n96): the consumers load the seed into O, m
// (times log2 e) and l (one lane's share) when an item starts, every P V
// accumulates, and the first tile's softmax rescales the seed.  Items of
// 128 queries of one (b, head), all of one cost, in (b, KV head)-major
// order, so that a head's chunk K/V stays in L2 while its query tiles
// run.  K and V may be head-range views (elastic SP2): their maps take
// the view's position stride.
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
// head-dim columns x `rows` positions of one head; ss: the stride of a
// position in elements (a head-range view of a wider tensor), 0: H D
inline int bshd_map(CUtensorMap* map, const void* base, int B, int S, int H,
                    int D, int rows, long long ss) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * D;
  const cuuint64_t pos = ss > 0 ? 2ull * ss : row * H;
  const cuuint64_t strides[3] = {row, pos, pos * S};
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
  long long ss;                  // bshd_map's position stride; 0: dense
  bool operator==(const MapKey& o) const {
    return base == o.base && B == o.B && S == o.S && H == o.H && D == o.D &&
           rows == o.rows && ss == o.ss;
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
    if (bshd_map(&maps[i], k.base, k.B, k.S, k.H, k.D, k.rows, k.ss))
      return -4;
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


// ---- bf16 at D = 128, causal without window, sink or rho: persistent ----
// ---- and the seeded non-causal form at D = 96 and 128 -------------------

namespace d128 {

using d64::advance_ring;
using d64::mask_causal;
using d64::mask_tail;
using d64::pack_p;
using d64::softmax;

constexpr int WGS = 2;                 // consumer warpgroups, 64 rows each
constexpr int BM = 64 * WGS;           // queries per item
constexpr int THREADS = 128 * (WGS + 1);
constexpr int NB = 2;                  // 64-column boxes of a row (D 96:
                                       // the second box half zeros)
constexpr int Q_BYTES = BM * NB * ROW;
constexpr int KV_BYTES = BN * NB * ROW;   // K or V of one tile
constexpr int O_BYTES = 64 * NB * ROW;    // a warpgroup's staged output
constexpr int Q_BUFS = 1;              // 2: the next item's Q loads early
constexpr int K_STAGES = 2, V_STAGES = 3;
constexpr int NS = BN / 2;             // S values per thread (m64n128)
constexpr int TURN_BAR = 1;            // named barriers 1..2: turns
constexpr int STORE_BAR = 1 + WGS;     // 3..4: a warpgroup's staging
// the Q buffers, the output staging, the K and V rings; barriers and slots
constexpr size_t SMEM_BYTES = 1024 + Q_BUFS * Q_BYTES + WGS * O_BYTES +
                              (K_STAGES + V_STAGES) * KV_BYTES + 256;
static_assert(SMEM_BYTES <= 232448, "a block's shared memory on the H100");

// Rank r's (query tile, head, batch row) for blocks of PER heads (PER = 2:
// a cluster's pair of blocks, head h and h + 1 of one KV group; the block
// adds its rank in the cluster to h): ranked by (batch row, KV head), then
// query tile, heaviest first, then the heads within the KV group, so the
// items in flight read one or two K/V prefixes (ops.fwd_item mirrors it
// at PER = 1; PER = 2 takes its ranks two by two)
template <int PER>
__device__ __forceinline__ void item_of(int r, int n_qt, const Params& p,
                                        int& qt, int& h, int& b) {
  const int G = p.Hq / p.Hkv, t = r / (G / PER), bhk = t / n_qt;
  qt = n_qt - 1 - t % n_qt;
  h = (bhk % p.Hkv) * G + PER * (r % (G / PER));
  b = bhk / p.Hkv;
}

// S = Q K^T over D in k16 steps: box kk / 4, 32 bytes a step inside it
template <int D>
__device__ __forceinline__ void qk(float (&s)[NS], const uint8_t* q_wg,
                                   const uint8_t* sk) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;
    wgmma_m64n128k16_ss_bf16(
        s, desc_sw128(q_wg + (kk / 4) * BM * ROW + off, 16, 1024),
        desc_sw128(sk + (kk / 4) * BN * ROW + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O (+)= P V over a tile's keys in k16 steps; scale0 = 0 overwrites O
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2],
                                   const uint32_t (&pa)[BN / 16][4],
                                   const uint8_t* sv, int scale0) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < BN / 16; ++t) {
    const uint64_t desc = desc_sw128(sv + t * 16 * ROW, BN * ROW, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs_bf16_tb(o, pa[t], desc, t == 0 ? scale0 : 1);
    else
      wgmma_m64n96k16_rs_bf16_tb(o, pa[t], desc, t == 0 ? scale0 : 1);
  }
  wgmma_commit();
}

// The tile's mask, then the online softmax after the join (at D 128
// faster than a softmax in each branch, which doubles the loop's code).
// CAUSAL: where the tile crosses the diagonal or the key axis' end; else
// (the seeded form) only the key axis' end.
template <bool CAUSAL, bool FIRST>
__device__ __forceinline__ bool mask_then_softmax(
    float (&s)[NS], const Params& p, int first, int row0, int col0, int t0,
    float (&m)[2], float (&l)[2], float (&alpha)[2], float scale_log2) {
  if constexpr (CAUSAL) {
    if (t0 + BN > p.Skv || t0 + BN - 1 > p.q_offset + first)
      mask_causal(s, p, row0, col0, t0);
  } else {
    if (t0 + BN > p.Skv) mask_tail(s, col0, p.Skv - t0);
  }
  return softmax<FIRST>(s, m, l, alpha, scale_log2);
}

// O *= alpha row by row, where one of the warp's row maxima moved (a
// warp-uniform test: no wgmma sits under it); O is not in flight
template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO], const float (&alpha)[2],
                                        bool row_moved) {
  if (__any_sync(0xffffffffu, row_moved)) {
#pragma unroll
    for (int c = 0; c < NO; ++c) o[c] *= alpha[(c >> 1) & 1];
  }
}

// A warp is done with a K or V stage: its arrival on the stage's empty
// barrier, and with PAIR on the other block's too (whose producer writes
// the stage's other half into this block)
template <bool PAIR>
__device__ __forceinline__ void release_kv(uint64_t* empty, int stage,
                                           int lane, uint32_t peer) {
  __syncwarp();
  if (lane == 0) {
    mbar_arrive(&empty[stage]);
    if (PAIR) mbar_arrive_remote(&empty[stage], peer);
  }
}

// O / l in bf16 into the warpgroup's two staging boxes `so_wg` in the
// 128-byte swizzle (their previous store has read them), then two TMA
// stores of the 64 rows from `first` (rows past Sq are not written; at
// D 96 the second box's columns past 96 neither); rows that see nothing
// give 0 (lse -inf).  l arrives as each lane's share of its row sums; m is
// in the log2 domain, lse in the natural one.
template <int D>
__device__ __forceinline__ void store_rows(
    const Params& p, const CUtensorMap* to, float* __restrict__ lse,
    const float (&o)[D / 2], const float (&m)[2], float (&l)[2],
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
    for (int j = 0; j < D / 8; ++j)        // columns 8 j..: box j / 8
      *reinterpret_cast<uint32_t*>(dst + (j / 8) * 64 * ROW +
                                   (((j % 8) ^ (lr & 7)) << 4)) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (lse != nullptr && lane % 4 == 0 && i < p.Sq)
      lse[(static_cast<int64_t>(b) * p.Hq + h) * p.Sq + i] =
          l[r] == 0.f ? -INFINITY : (m[r] + log2f(l[r])) / LOG2E;
  }
  fence_proxy_async();
  named_sync(STORE_BAR + cw, 128);
  if (tw == 0 && first < p.Sq) {
    tma_store_4d(to, so_wg, 0, h, first, b);
    tma_store_4d(to, so_wg + 64 * ROW, 64, h, first, b);
    bulk_commit();
  }
}

// The shared memory's barriers and slots
struct Bars {
  uint64_t *kfull, *kempty, *vfull, *vempty, *qfull, *qempty;
  uint64_t *rfull, *rempty;     // PAIR: the cluster's next rank
  volatile int* slot;           // a K stage's tile: 2 t0 + (last tile of
                                // its item), or -1: the item has none
  volatile int* item_slot;      // a Q buffer's item rank, -1: no more
  int* rank_slot;               // PAIR: the rank block 0 fetched
};

// The seeded form's partials of every row (kernel 1's, paged_chunk_
// attention.cu): m (natural units: scores x scale) and l [B, Hq, Sq], acc
// [B, Hq, Sq, D], fp32; a row that sees nothing holds m = -1e30, l = 0,
// acc = 0
struct Seed {
  const float* __restrict__ m;
  const float* __restrict__ l;
  const float* __restrict__ acc;
};

// The seeded form's start of an item: each of the thread's two rows takes
// its partial as its running maximum (in the log2 domain), sum and O, in
// the accumulator's layout; l as the share of the row's first lane (the
// lanes' shares add up at the store).  Rows past Sq start empty.
template <int D>
__device__ __forceinline__ void seed_rows(const Seed& seed, const Params& p,
                                          float (&o)[D / 2], float (&m)[2],
                                          float (&l)[2], int row0, int col0,
                                          int h, int b, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    const bool live = i < p.Sq;
    const int64_t row =
        (static_cast<int64_t>(b) * p.Hq + h) * p.Sq + (live ? i : 0);
    m[r] = live ? seed.m[row] * LOG2E : NEG_INF;
    l[r] = live && lane % 4 == 0 ? seed.l[row] : 0.f;
    const float2* src = reinterpret_cast<const float2*>(seed.acc + row * D +
                                                        col0);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 x = live ? __ldg(src + 4 * j) : make_float2(0.f, 0.f);
      o[4 * j + 2 * r] = x.x;
      o[4 * j + 2 * r + 1] = x.y;
    }
  }
}

// SEEDED: the non-causal form whose rows start from `seed` (O holds it:
// every P V accumulates, and an item with no tile keeps it); else causal,
// from an empty state, the first tile's P V overwriting O.
template <int D, bool PAIR, bool SEEDED>
__device__ __forceinline__ void consume(
    const Params& p, const CUtensorMap* to, float* __restrict__ lse,
    const Seed& seed, const uint8_t* sq, const uint8_t* sk,
    const uint8_t* sv, uint8_t* so, const Bars& bar, int n_qt,
    uint32_t cta) {
  constexpr int NO = D / 2;              // O values per thread (m64nD)
  const int cw = threadIdx.x / 128 - 1;
  const int tw = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int col0 = 2 * (lane % 4);
  const int lr0 = 16 * (tw / 32) + lane / 4;  // rows lr0, lr0 + 8 of 64
  const float scale_log2 = p.scale * LOG2E;
  const int turn = TURN_BAR + cw, next_turn = TURN_BAR + (cw + 1) % WGS;
  const uint32_t peer = cta ^ 1;
  uint8_t* so_wg = so + cw * O_BYTES;

  float o[NO], s[NS];
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int c = 0; c < NO; ++c) o[c] = 0.f;
#pragma unroll
  for (int c = 0; c < NS; ++c) s[c] = 0.f;

  // The warpgroups take turns at issuing their products, 0, 1, 0, ...
  // across tiles and items; warpgroup 1's arrival opens 0's first turn.
  if (cw == WGS - 1) named_arrive(TURN_BAR, 256);
  int ks = 0, vs = 0;
  uint32_t kph = 0, vph = 0;
  for (int k = 0;; ++k) {
    const int qb = k % Q_BUFS;
    mbar_wait(&bar.qfull[qb], (k / Q_BUFS) & 1);
    const int r = bar.item_slot[qb];         // the item's rank; -1: done
    if (r < 0) break;
    int qt, h, b;
    item_of<PAIR ? 2 : 1>(r, n_qt, p, qt, h, b);
    h += cta;
    const int first = qt * BM + 64 * cw;     // the warpgroup's first row
    const int row0 = first + lr0;
    const uint8_t* q_wg = sq + qb * Q_BYTES + 64 * cw * ROW;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    if constexpr (SEEDED)
      seed_rows<D>(seed, p, o, m, l, row0, col0, h, b, lane);
    mbar_wait(&bar.kfull[ks], kph);
    int info = bar.slot[ks];
    // Q is released once the item's last S has read it, so that the next
    // item's Q loads during this one's last softmax, P V and store
    if (info < 0) {                          // no visible tile: O = 0, or
      release_kv<PAIR>(bar.kempty, ks, lane, peer);   // the seed
      advance_ring<K_STAGES>(ks, kph);
      release(bar.qempty, qb, lane);
      if constexpr (!SEEDED) {
#pragma unroll
        for (int c = 0; c < NO; ++c) o[c] = 0.f;
      }
    } else {
      // the first tile: S only
      int t0 = info >> 1;
      bool last = info & 1;
      named_sync(turn, 256);
      qk<D>(s, q_wg, sk + ks * KV_BYTES);
      named_arrive(next_turn, 256);
      wgmma_wait<0>();
      fence_regs(s);
      release_kv<PAIR>(bar.kempty, ks, lane, peer);
      advance_ring<K_STAGES>(ks, kph);
      if (last) release(bar.qempty, qb, lane);
      bool moved = mask_then_softmax<!SEEDED, !SEEDED>(
          s, p, first, row0, col0, t0, m, l, alpha, scale_log2);
      pack_p(pa, s);
      int scale0 = SEEDED;                   // the first P V overwrites O,
      while (!last) {                        // or adds to the seed
        mbar_wait(&bar.kfull[ks], kph);
        info = bar.slot[ks];
        t0 = info >> 1;
        last = info & 1;
        mbar_wait(&bar.vfull[vs], vph);      // the previous tile's V
        named_sync(turn, 256);
        qk<D>(s, q_wg, sk + ks * KV_BYTES);
        // O to the previous tile's maximum, then the previous tile's
        // O += P V, which runs during this tile's softmax
        rescale(o, alpha, moved);
        pv<D>(o, pa, sv + vs * KV_BYTES, scale0);
        named_arrive(next_turn, 256);
        wgmma_wait<1>();
        fence_regs(s);
        release_kv<PAIR>(bar.kempty, ks, lane, peer);
        advance_ring<K_STAGES>(ks, kph);
        if (last) release(bar.qempty, qb, lane);
        moved = mask_then_softmax<!SEEDED, false>(s, p, first, row0, col0,
                                                  t0, m, l, alpha,
                                                  scale_log2);
        wgmma_wait<0>();
        fence_regs(o);
        release_kv<PAIR>(bar.vempty, vs, lane, peer);
        advance_ring<V_STAGES>(vs, vph);
        pack_p(pa, s);
        scale0 = 1;
      }
      // the last tile's P V
      mbar_wait(&bar.vfull[vs], vph);
      named_sync(turn, 256);
      rescale(o, alpha, moved);
      pv<D>(o, pa, sv + vs * KV_BYTES, scale0);
      named_arrive(next_turn, 256);
      wgmma_wait<0>();
      fence_regs(o);
      release_kv<PAIR>(bar.vempty, vs, lane, peer);
      advance_ring<V_STAGES>(vs, vph);
    }
    if (tw == 0) bulk_wait_read();          // the last store has read so_wg
    store_rows<D>(p, to, lse, o, m, l, so_wg, cw, first, h, b);
  }
  if (cw == 0) named_sync(TURN_BAR, 256);  // the last one's turn
  if (tw == 0) bulk_wait_all();
}

// The next item's rank from the counter the wrapper zeroes, so that a
// block that finishes early takes more.  PAIR: block 0 of the cluster
// fetches it and stores it into both blocks' rank slot (once both have
// read the last one); each block's producer reads its own.
template <bool PAIR>
__device__ __forceinline__ int fetch(int* sched, const Bars& bar, int k,
                                     uint32_t cta) {
  if (!PAIR) return atomicAdd(sched, 1);
  if (cta == 0) {
    const int r = atomicAdd(sched, 1);
    mbar_wait(bar.rempty, (k & 1) ^ 1);
    *bar.rank_slot = r;
    st_cluster(bar.rank_slot, r, 1);
    mbar_arrive(bar.rfull);
    mbar_arrive_cluster(bar.rfull, 1);
  }
  mbar_wait_cluster(bar.rfull, k & 1);
  const int r = *reinterpret_cast<volatile int*>(bar.rank_slot);
  if (cta == 0) {
    mbar_arrive(bar.rempty);
  } else {
    mbar_arrive_cluster(bar.rempty, 0);
  }
  return r;
}

// A block's whole work, for both kernels below (the maps lie in their
// parameter space).  PAIR: a cluster of two blocks takes heads h and h + 1
// of one KV group at one query tile, whose K/V tiles are the same: each
// block loads one of a tile's two 64-column boxes and multicasts it into
// both, so that L2 sends each K/V byte to two SMs at once.  The K and V
// stages' empty barriers count both blocks' consumer warps.
template <int D, bool PAIR, bool SEEDED>
__device__ __forceinline__ void run(const CUtensorMap* tq,
                                    const CUtensorMap* tk,
                                    const CUtensorMap* tv,
                                    const CUtensorMap* to,
                                    float* __restrict__ lse, const Seed& seed,
                                    int* __restrict__ sched, const Params& p,
                                    int n_qt, int n_ranks) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* so = sq + Q_BUFS * Q_BYTES;
  uint8_t* sk = so + WGS * O_BYTES;
  uint8_t* sv = sk + K_STAGES * KV_BYTES;
  Bars bar;
  bar.kfull = reinterpret_cast<uint64_t*>(sv + V_STAGES * KV_BYTES);
  bar.kempty = bar.kfull + K_STAGES;
  bar.vfull = bar.kempty + K_STAGES;
  bar.vempty = bar.vfull + V_STAGES;
  bar.qfull = bar.vempty + V_STAGES;
  bar.qempty = bar.qfull + Q_BUFS;
  bar.rfull = bar.qempty + Q_BUFS;
  bar.rempty = bar.rfull + 1;
  bar.slot = reinterpret_cast<volatile int*>(bar.rempty + 1);
  bar.item_slot = bar.slot + K_STAGES;
  bar.rank_slot = const_cast<int*>(bar.item_slot + Q_BUFS);
  const uint32_t cta = PAIR ? cluster_ctarank() : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < K_STAGES; ++st) {
      mbar_init(&bar.kfull[st], 1);
      mbar_init(&bar.kempty[st], 4 * WGS * (PAIR ? 2 : 1));
    }
    for (int st = 0; st < V_STAGES; ++st) {
      mbar_init(&bar.vfull[st], 1);
      mbar_init(&bar.vempty[st], 4 * WGS * (PAIR ? 2 : 1));
    }
    for (int st = 0; st < Q_BUFS; ++st) {
      mbar_init(&bar.qfull[st], 1);
      mbar_init(&bar.qempty[st], 4 * WGS);
    }
    mbar_init(bar.rfull, 1);
    mbar_init(bar.rempty, 2);
    mbar_fence_init();
  }
  // the other block's barriers are ready before any arrival on them
  if constexpr (PAIR) cluster_sync(); else __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread fetches the items and issues every
    // load, each item's keys [0, q_offset + its last row] (SEEDED: every
    // key) in order, a tile's K one tile ahead of its V (K is released
    // after S, V only after P V), the item's first K before its Q (a K
    // stage frees up before the Q buffer does)
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(tq);
      tma_prefetch(tk);
      tma_prefetch(tv);
      tma_prefetch(to);
      int ks = 0, vs = 0;
      uint32_t kph = 0, vph = 0;
      // PAIR: this block's box of each K / V tile, multicast to both
      const int box0 = PAIR ? static_cast<int>(cta) : 0;
      const int n_box = PAIR ? 1 : NB;
      for (int k = 0;; ++k) {
        const int r = fetch<PAIR>(sched, bar, k, cta);
        const int qb = k % Q_BUFS;
        if (r >= n_ranks) {
          mbar_wait(&bar.qempty[qb], ((k / Q_BUFS) & 1) ^ 1);
          bar.item_slot[qb] = -1;
          mbar_arrive(&bar.qfull[qb]);
          break;
        }
        int qt, h, b;
        item_of<PAIR ? 2 : 1>(r, n_qt, p, qt, h, b);
        h += cta;
        const int i0 = qt * BM, hk = h / (p.Hq / p.Hkv);
        const int kv_end =
            SEEDED ? p.Skv : min(p.Skv, p.q_offset + min(i0 + BM, p.Sq));
        const int n_t = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;
        for (int t = 0; t <= n_t; ++t) {
          if (t < n_t || n_t == 0) {
            // K of tile t, or one slot of -1 for an item with no tile
            mbar_wait(&bar.kempty[ks], kph ^ 1);
            uint8_t* dst = sk + ks * KV_BYTES;
            if (n_t == 0) {
              bar.slot[ks] = -1;
              mbar_arrive(&bar.kfull[ks]);
            } else {
              bar.slot[ks] = 2 * t * BN + (t == n_t - 1);
              mbar_arrive_expect_tx(&bar.kfull[ks], KV_BYTES);
              for (int x = box0; x < box0 + n_box; ++x) {
                if (PAIR)
                  tma_load_4d_multicast(dst + x * BN * ROW, tk,
                                        &bar.kfull[ks], 64 * x, hk, t * BN,
                                        b, 0x3);
                else
                  tma_load_4d(dst + x * BN * ROW, tk, &bar.kfull[ks],
                              64 * x, hk, t * BN, b);
              }
            }
            advance_ring<K_STAGES>(ks, kph);
          }
          if (t == 0) {
            uint8_t* sqb = sq + qb * Q_BYTES;
            mbar_wait(&bar.qempty[qb], ((k / Q_BUFS) & 1) ^ 1);
            bar.item_slot[qb] = r;
            mbar_arrive_expect_tx(&bar.qfull[qb], Q_BYTES);
            tma_load_4d(sqb, tq, &bar.qfull[qb], 0, h, i0, b);
            tma_load_4d(sqb + BM * ROW, tq, &bar.qfull[qb], 64, h, i0, b);
          } else {
            mbar_wait(&bar.vempty[vs], vph ^ 1);
            uint8_t* dst = sv + vs * KV_BYTES;
            mbar_arrive_expect_tx(&bar.vfull[vs], KV_BYTES);
            for (int x = box0; x < box0 + n_box; ++x) {
              if (PAIR)
                tma_load_4d_multicast(dst + x * BN * ROW, tv,
                                      &bar.vfull[vs], 64 * x, hk,
                                      (t - 1) * BN, b, 0x3);
              else
                tma_load_4d(dst + x * BN * ROW, tv, &bar.vfull[vs], 64 * x,
                            hk, (t - 1) * BN, b);
            }
            advance_ring<V_STAGES>(vs, vph);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    consume<D, PAIR, SEEDED>(p, to, lse, seed, sq, sk, sv, so, bar, n_qt,
                             cta);
  }
  // no block exits while the other may still write or arrive on its
  // shared memory
  if constexpr (PAIR) cluster_sync();
}

// The causal instance (D 128)
template <bool PAIR>
__global__ void __launch_bounds__(THREADS, 1)
flash_mha_wgmma128_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to,
                          float* __restrict__ lse, int* __restrict__ sched,
                          Params p, int n_qt, int n_ranks) {
  run<128, PAIR, false>(&tq, &tk, &tv, &to, lse, Seed{}, sched, p, n_qt,
                        n_ranks);
}

// The seeded form (D 96 and 128; no clusters: the AR-DiT's KV groups are
// of one head)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_mha_seeded_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap to, Seed seed,
                        int* __restrict__ sched, Params p, int n_qt,
                        int n_ranks) {
  run<D, false, true>(&tq, &tk, &tv, &to, nullptr, seed, sched, p, n_qt,
                      n_ranks);
}

// n_blocks: the persistent grid (ops.fwd_blocks at the item's 128
// queries: one block per SM, at most one per item; rounded down to whole
// clusters of two where the KV group's size is even, which then takes
// the PAIR instance); sched: one int32 the wrapper zeroes, the items'
// counter.  Only the causal mode without window, sink or rho.
int launch(const void* q, const void* k, const void* v, const int32_t* keep,
           void* out, float* lse, int B, const Params& p, int n_blocks,
           int* sched, cudaStream_t stream) {
  if (!p.causal || p.window || p.sink || keep != nullptr || !sched)
    return -3;
  if (p.Skv == 0) {                // every row sees nothing (the wrapper
                                   // fills lse with -inf)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, 2ull * B * p.Sq * p.Hq * 128, stream));
  }
  const int n_qt = (p.Sq + BM - 1) / BM;
  const long long n_items = static_cast<long long>(B) * p.Hq * n_qt;
  if (n_blocks <= 0 || n_blocks > n_items || n_items > INT_MAX) return -3;
  const bool pair = (p.Hq / p.Hkv) % 2 == 0 && n_blocks >= 2;
  const MapKey keys[4] = {{q, B, p.Sq, p.Hq, 128, BM},
                          {k, B, p.Skv, p.Hkv, 128, BN},
                          {v, B, p.Skv, p.Hkv, 128, BN},
                          {out, B, p.Sq, p.Hq, 128, 64}};
  CUtensorMap maps[4];
  if (!pair) {
    static std::atomic<uint64_t> attribute_set{0};
    auto kern = flash_mha_wgmma128_kernel<false>;
    const int err = maps_and_attribute(kern, SMEM_BYTES, attribute_set, keys,
                                       maps, 4);
    if (err) return err;
    kern<<<n_blocks, THREADS, SMEM_BYTES, stream>>>(
        maps[0], maps[1], maps[2], maps[3], lse, sched, p, n_qt,
        static_cast<int>(n_items));
    return static_cast<int>(cudaGetLastError());
  }
  static std::atomic<uint64_t> attribute_set{0};
  auto kern = flash_mha_wgmma128_kernel<true>;
  const int err = maps_and_attribute(kern, SMEM_BYTES, attribute_set, keys,
                                     maps, 4);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks & ~1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, maps[0], maps[1], maps[2], maps[3], lse, sched, p, n_qt,
      static_cast<int>(n_items / 2));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The seeded form: n_blocks and sched as for the causal instance; k and v
// read through their position stride kv_ss (elements; 0: dense), so that a
// head-range view of a wider tensor is read in place.
template <int D>
int launch_seeded(const void* q, const void* k, const void* v,
                  const Seed& seed, void* out, int B, const Params& p,
                  long long kv_ss, int n_blocks, int* sched,
                  cudaStream_t stream) {
  const int n_qt = (p.Sq + BM - 1) / BM;
  const long long n_items = static_cast<long long>(B) * p.Hq * n_qt;
  if (p.Skv <= 0 || !sched || n_blocks <= 0 || n_blocks > n_items ||
      n_items > INT_MAX)
    return -3;
  const MapKey keys[4] = {{q, B, p.Sq, p.Hq, D, BM},
                          {k, B, p.Skv, p.Hkv, D, BN, kv_ss},
                          {v, B, p.Skv, p.Hkv, D, BN, kv_ss},
                          {out, B, p.Sq, p.Hq, D, 64}};
  CUtensorMap maps[4];
  static std::atomic<uint64_t> attribute_set{0};
  auto kern = flash_mha_seeded_kernel<D>;
  const int err = maps_and_attribute(kern, SMEM_BYTES, attribute_set, keys,
                                     maps, 4);
  if (err) return err;
  kern<<<n_blocks, THREADS, SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], seed, sched, p, n_qt,
      static_cast<int>(n_items));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace d128

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
// arguments of flash_mha_launch (dtype must be 1) and the persistent grid
// n_blocks (ops.fwd_blocks): at D 64 every call's; at D 128, n_blocks > 0
// takes the causal instance without window, sink or rho (ops.fwd_instance
// names the calls that do; -3 for another mode) and 0 the general kernel;
// ignored at D 96.  sched: the D 128 causal instance's item counter, one
// int32 zeroed before the launch (null elsewhere).  q, k, v and out must
// be 16-byte aligned.  Returns as flash_mha_launch, or
// -4 when a tensor map cannot be encoded (alignment, or a driver without
// the entry point).
extern "C" int flash_mha_wgmma_launch(
    const void* q, const void* k, const void* v, const void* keep,
    void* out, void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    int causal,
    int q_offset, int window, int sink, int block_q, int block_kv,
    int n_kv_blocks, int dtype, int n_blocks, void* sched, void* stream) {
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
    case 128:
      return n_blocks > 0
                 ? tc::d128::launch(q, k, v, kp, out, lp, B, p, n_blocks,
                                    static_cast<int*>(sched), s)
                 : tc::launch<128>(q, k, v, kp, out, lp, B, p, s);
  }
  return -1;
}

// The seeded form (flash_mha_seeded_kernel): bf16 q [B,Sq,Hq,D] attends to
// bf16 k/v [B,Skv,Hkv,D] (Skv >= 1), every key visible, each row's online
// softmax starting from its partial m, l [B,Hq,Sq] and acc [B,Hq,Sq,D]
// (fp32, m in natural units: kernel 1's outputs); out [B,Sq,Hq,D] bf16 is
// acc / l over both (0 where l is 0).  k and v: position stride kv_ss
// elements (0: dense), batch stride Skv kv_ss, heads dense; q, k, v and
// out 16-byte aligned.  D 96 or 128; n_blocks and sched as for the D 128
// causal instance (ops.fwd_blocks; one int32 zeroed before the launch).
// Returns as flash_mha_wgmma_launch.
extern "C" int flash_mha_seeded_launch(
    const void* q, const void* k, const void* v, const void* m,
    const void* l, const void* acc, void* out, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, long long kv_ss, int n_blocks, void* sched,
    void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return -3;
  Params p{Sq, Skv, Hq, Hkv, 0, 0, 0, 0, 0, 0, 0,
           1.0f / sqrtf(static_cast<float>(D))};
  const tc::d128::Seed seed{static_cast<const float*>(m),
                            static_cast<const float*>(l),
                            static_cast<const float*>(acc)};
  int* sp = static_cast<int*>(sched);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 96:
      return tc::d128::launch_seeded<96>(q, k, v, seed, out, B, p, kv_ss,
                                         n_blocks, sp, s);
    case 128:
      return tc::d128::launch_seeded<128>(q, k, v, seed, out, B, p, kv_ss,
                                          n_blocks, sp, s);
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
