// Chunk-query paged attention partials over the paged KV pool (Hopper).
//
// Replaces the JAX reference's TPU kernel
// kernels/paged_attention/kernel.py::paged_chunk_attention_pallas
// (bodies _chunk_kernel / _chunk_kernel_nomask).  It computes the same
// function: for every (batch row b, KV head h) the Sq*G query rows of q
// [B,Sq,Hq,D] attend to the visible tokens of the pages named by
// block_table[b, :] in the pool k/v [P,page,Hkv,D], and the kernel
// returns UNNORMALISED fp32 online-softmax partials
//     m, l [B,Hkv,G,Sq]   acc [B,Hkv,G,Sq,D]
// (the layout attention.paged_mha merges with the chunk's own KV).
// Visibility is either the per-token page_mask [B, n*page] (uint8) or,
// when page_mask is null, each page's valid prefix: `sink` tokens on
// table entry 0 and `chunk_tokens` on the others.  When the hints are
// given (paged_mha always gives them) only that prefix is read, masked
// or not; tokens past it are never visible.  Masked scores are set to
// NEG_INF and their probabilities to 0 explicitly, a row that sees
// nothing keeps m = NEG_INF, l = 0, acc = 0, and pages whose mask slice
// is all false (page_any == 0) are skipped, which also keeps hole rows
// remapped to the stream's sink page from contributing.
//
// The TPU kernel holds all R = Sq*G query rows of a (b, h) in one block
// with a [R, D] fp32 accumulator in VMEM (1.35 MB at full width), which
// fits neither shared memory nor registers and would give only B*Hkv
// blocks for 132 SMs.  Here a block owns a tile of query rows (row r =
// query r / G of query head h*G + r % G) and loops over the table
// entries (skipping invisible pages) and, within each page, over the
// valid extent in tiles of tokens.  A row's result depends only on its
// own q, pages, table and mask: never on B, Hkv, a view's head offset or
// the grid (elastic SP2's half-head launches equal the full one bit for
// bit).  The pools are read through their page and token strides: a view
// pool[..., lo:hi, :] of a wider pool (SP2's shards) is read in place.
//
// Bound at the main path's shape (ardit-self-forcing, Sq = 2640,
// Hq = Hkv = 12, D = 128, page = 2640, bf16 pool, 7-chunk window:
// ctx = 77 + 7*2640 = 18557 visible tokens, B = 2): per (b, h) the
// kernel does 4*R*D*ctx FLOPs against ctx*D*2*2 bytes of K and V, i.e.
// R ~ 2,600 FLOP/byte, far above the H100's ~295 bf16 FLOP/byte ridge:
// it is compute-bound, 0.60 TFLOP per call, 0.609 ms at the 989 TFLOP/s
// bf16 tensor-core peak.
//
// Three kernels; the wrapper picks one by dtype, head dim and group
// (ops.chunk_instance).
//
// bf16 queries over bf16 pages at D = 96, G dividing 64
// (ardit-causal-forcing): paged_chunk_attention_wgmma96_kernel, the
// general tensor-core design below made persistent.  At the causal-forcing
// shape (B 2, 16 heads, 2,640 rows a head) the general grid of 128-row
// blocks is 672 blocks, 5.1 waves of 132 run as 6, and each 128-column
// tile carried 32 zero columns.  Here one block an SM takes items from an
// atomic counter the wrapper zeroes (ops.chunk_items mirrors the order):
// an item is 192 rows (three consumer warpgroups of 64) of one (b, KV
// head) over one part of the context, the parts cut every 128 key tiles
// of the table's extents (1b's 148 tiles: 128 + 20), full parts ranked
// first, then (b, KV head) and row tile, so the short last parts fill the
// blocks' ends (ops.chunk_items: max / mean work 1.014 at 1b, against
// 1.18 with whole items).  Each warpgroup writes its part's (O, m, l) to
// scratch and counts it done (acq_rel atomics); the last part to finish
// merges every part's slot in part order, so a row's result does not
// depend on which finishes last, nor on B, Hkv, the view or the SMs.
// Tiles are 96 columns: three 32-column TMA boxes in the 64-byte swizzle
// (desc_sw64), S in six k16 steps, P V one n96 product a k16 step.  Three
// warpgroups leave 160 registers a thread, too few for S, P and O live
// together (ptxas then serializes the wgmmas), so each warpgroup runs a
// tile's S, softmax and P V in turn, and the other two warpgroups'
// products cover its softmax; its row sums stay per lane until the item
// ends.  Shared memory: two Q buffers of 36 KB (the next item's Q loads
// during this one) and three 48 KB stages of K and V: 222,848 B.
//
// bf16 queries over bf16 or e4m3 pages at D = 96 or 128, G dividing 128
// (every other full-width call, and D 96's groups of 128):
// paged_chunk_attention_wgmma, on the tensor
// cores, after flash_mha's tensor-core kernel.  Grid (ceil(R/128), Hkv,
// B).  A block owns 128 rows: one producer warpgroup and two consumer
// warpgroups of 64 rows (setmaxnreg moves the producer's registers to
// them).  Q arrives once by TMA through a 4-D tensor map over q [B, Sq,
// Hq, D] (a box of 128/G positions x G heads; rows past Sq are zeros,
// computed and not stored) and stays in shared memory as wgmma's A
// operand.  Warp 0 of the producer walks block_table[b, :]: it skips
// entries with page_any == 0, cuts each page's extent (sink tokens on
// entry 0, chunk_tokens on the others, the page without the hint) into
// 128-token tiles (a 2640-token page is 20 full tiles and one of 80; the
// sink's 77 tokens one tile), stages each tile's 128 visibility bytes
// (page_mask and the extent; the same for every row of b) with a flag,
// all visible or mixed, leaves out a tile no token of which is visible
// (exact: hidden tokens move neither m nor l), and issues one TMA box per
// tile for K and for V through 4-D tensor maps over the pool view
// [n_pages, extent, Hkv, D] built from the view's own strides.  The
// maps' token extent is the valid prefix (one map for entry 0, one for
// the others), so TMA writes zeros past it and a box never reads a
// page's tail nor crosses into the next page.  A head-range view is the
// map's base address plus lo*D elements, so SP2 stays copy-free; every
// stride is a multiple of 16 bytes at D 96 and 128 in bf16 and e4m3.
// The consumers run S = Q K^T and O += P V as flash_mha's tensor-core
// kernel does (bf16 wgmma into fp32, the online softmax in the
// accumulator layout, P rounded to bf16 as the A operand of P V, the
// previous tile's P V overlapping this tile's softmax, the warpgroups
// taking turns through named barriers, the same wgmma sequence on every
// tile); only mixed tiles test their columns against the staged bytes,
// and hidden scores become -inf, so their probabilities are exactly 0.
// The running maximum lives in the log2 domain and is stored in natural
// units (scores x scale); a row that sees nothing stores exactly m =
// -1e30, l = 0, acc = 0.  Unlike the TPU kernel, which keeps P in fp32,
// P enters P V in bf16, as SDPA does.
//
// Shared memory, by page dtype (of the 232,448 bytes a block may use):
// bf16 pages take Q (32 KB) and a ring of three 64 KB K/V stages:
// 231,040 B with the alignment slack, visibility bytes and barriers.
// e4m3 pages are brought by TMA into a staging ring of two 32 KB stages
// (K and V, rows of D bytes, unswizzled), and producer warps 1-3 widen
// them to bf16 in the 128-byte swizzle of one of two 64 KB stages (exact:
// every e4m3 value is a bf16 value), so Q + 2 x 64 KB + 2 x 32 KB:
// 231,168 B.  Three bf16 stages and the e4m3
// staging would not fit.  With two stages the widening would wait for
// the consumers' P V of the stage it refills, so K and V have barriers
// of their own: K's slot frees after the tile's S = Q K^T, V's after its
// P V one tile later, and the converters fill each as it frees.
//
// fp32 queries or pages (the reduced configs), D = 16, bf16 queries over
// fp32 pages: paged_chunk_attention_kernel, the first port, on the CUDA
// cores.  A block owns 64 query rows; K/V tiles of 64 tokens are staged
// in shared memory as fp32 (bf16 / fp32 / fp8-e4m3 converted on load),
// scores and P.V are fp32 FMAs on a 4x4 register tile per thread, the
// row-wise online softmax is reduced across a half-warp with shuffles,
// and the accumulator stays in registers.  Offsets into the pool are
// 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <climits>

#include "hopper.cuh"

namespace {

constexpr int BLOCK_M = 64;     // query rows per block
constexpr int BLOCK_N = 64;     // KV tokens per tile
constexpr int THREADS = 256;    // 16 x 16 threads, 4x4 outputs each
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
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
                          + BLOCK_N * D + BLOCK_N);
}

template <int D, typename QT, typename KT>
__global__ void __launch_bounds__(THREADS)
paged_chunk_attention_kernel(const QT* __restrict__ q,
                             const KT* __restrict__ k_pages,
                             const KT* __restrict__ v_pages,
                             const int32_t* __restrict__ block_table,
                             const uint8_t* __restrict__ page_mask,
                             const uint8_t* __restrict__ page_any,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out,
                             float* __restrict__ acc_out,
                             int Sq, int Hq, int Hkv, int page, int n,
                             int sink, int chunk_tokens,
                             int64_t kv_page_stride, int64_t kv_tok_stride,
                             float scale) {
  constexpr int QS = D + 4;          // padded row strides (bank spread)
  constexpr int KS = D + 1;
  constexpr int PS = BLOCK_N + 1;
  constexpr int DC = D / 16;         // accumulator columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;                                  // [BLOCK_M][QS]
  float* Ks = Qs + BLOCK_M * QS;                     // [BLOCK_N][KS]
  float* Ps = Ks;                                    // [BLOCK_M][PS]
  constexpr int KP = kp_floats<D>();
  float* Vs = Ks + KP;                               // [BLOCK_N][D]
  float* vis = Vs + BLOCK_N * D;                     // [BLOCK_N]

  const int G = Hq / Hkv;
  const int R = Sq * G;
  const int r0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;           // rows ty + 16*i
  const int tx = tid % 16;           // columns tx + 16*j
  const bool hinted = sink > 0 && chunk_tokens > 0;

  // ---- the block's query rows (row r = s*G + g) ------------------------
  for (int idx = tid; idx < BLOCK_M * D; idx += THREADS) {
    const int row = idx / D, c = idx % D;
    const int r = r0 + row;
    float val = 0.f;
    if (r < R) {
      const int s = r / G, g = r % G;
      const int64_t off =
          ((static_cast<int64_t>(b) * Sq + s) * Hq + h * G + g) * D + c;
      val = to_f32(q[off]);
    }
    Qs[row * QS + c] = val;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int e = 0; e < n; ++e) {
    // pages with no visible token contribute m=NEG_INF, l+=0, acc+=0:
    // skipping them is identical to computing them
    if (!page_any[static_cast<int64_t>(b) * n + e]) continue;
    const int64_t pid = block_table[static_cast<int64_t>(b) * n + e];
    int limit = hinted ? (e == 0 ? sink : chunk_tokens) : page;
    limit = limit < page ? limit : page;
    const uint8_t* mrow =
        page_mask ? page_mask + (static_cast<int64_t>(b) * n + e) * page
                  : nullptr;

    for (int t0 = 0; t0 < limit; t0 += BLOCK_N) {
      __syncthreads();               // previous tile's readers are done
      for (int idx = tid; idx < BLOCK_N * D; idx += THREADS) {
        const int tok = idx / D, c = idx % D;
        const int t = t0 + tok;
        float kv = 0.f, vv = 0.f;
        if (t < limit) {
          const int64_t off = pid * kv_page_stride + t * kv_tok_stride
                              + h * D + c;
          kv = to_f32(k_pages[off]);
          vv = to_f32(v_pages[off]);
        }
        Ks[tok * KS + c] = kv;
        Vs[tok * D + c] = vv;
      }
      for (int tok = tid; tok < BLOCK_N; tok += THREADS) {
        const int t = t0 + tok;
        vis[tok] = (t < limit && (mrow == nullptr || mrow[t])) ? 1.f : 0.f;
      }
      __syncthreads();

      // scores s = (q . k) * scale on a 4x4 register tile
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int k = 0; k < D; ++k) {
        float a[4], kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * KS + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
      }

      bool vj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) vj[j] = vis[tx + 16 * j] != 0.f;

      // row-wise online softmax; a row's 64 columns live on the 16
      // lanes of one half-warp
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = vj[j] ? s[i][j] * scale : NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_i[i], mx);
        const float alpha = expf(m_i[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // exp(NEG_INF - NEG_INF) == 1 on an all-masked row: zero the
          // masked probabilities explicitly so l is not polluted
          s[i][j] = vj[j] ? expf(s[i][j] - m_new) : 0.f;
          rs += s[i][j];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l_i[i] = l_i[i] * alpha + rs;
        m_i[i] = m_new;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      }

      __syncthreads();               // every thread is done with Ks
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
      __syncthreads();

      // acc += P . V over the tile's valid tokens
      const int n_tok = limit - t0 < BLOCK_N ? limit - t0 : BLOCK_N;
      for (int nn = 0; nn < n_tok; ++nn) {
        float p[4], v[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PS + nn];
#pragma unroll
        for (int c = 0; c < DC; ++c) v[c] = Vs[nn * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], v[c], acc[i][c]);
      }
    }
  }

  // ---- partials out, in the [B,Hkv,G,Sq(,D)] layout ---------------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= R) continue;
    const int s = r / G, g = r % G;
    const int64_t row = ((static_cast<int64_t>(b) * Hkv + h) * G + g) * Sq + s;
    if (tx == 0) {
      m_out[row] = m_i[i];
      l_out[row] = l_i[i];
    }
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_out[row * D + tx + 16 * c] = acc[i][c];
  }
}

struct Args {
  const void* q; const void* k; const void* v; const int32_t* bt;
  const uint8_t* mask; const uint8_t* any;
  float* m; float* l; float* acc;
  int B, Sq, Hq, Hkv, page, n, sink, chunk_tokens;
  int64_t page_stride, tok_stride;
  cudaStream_t stream;
};

template <int D, typename QT, typename KT>
int launch(const Args& a) {
  auto kern = paged_chunk_attention_kernel<D, QT, KT>;
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int R = a.Sq * (a.Hq / a.Hkv);
  dim3 grid((R + BLOCK_M - 1) / BLOCK_M, a.Hkv, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), a.bt, a.mask, a.any, a.m, a.l, a.acc,
      a.Sq, a.Hq, a.Hkv, a.page, a.n, a.sink, a.chunk_tokens,
      a.page_stride, a.tok_stride, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename QT>
int launch_kv(const Args& a, int kv_dtype) {
  switch (kv_dtype) {
    case 0: return launch<D, QT, float>(a);
    case 1: return launch<D, QT, __nv_bfloat16>(a);
    case 2: return launch<D, QT, __nv_fp8_e4m3>(a);
  }
  return -2;
}

template <int D>
int launch_q(const Args& a, int q_dtype, int kv_dtype) {
  switch (q_dtype) {
    case 0: return launch_kv<D, float>(a, kv_dtype);
    case 1: return launch_kv<D, __nv_bfloat16>(a, kv_dtype);
  }
  return -3;
}

// ---- bf16 queries on the tensor cores ---------------------------------------

namespace tc {

using namespace hopper;

constexpr int BM = 128;          // query rows per block: 2 consumer warpgroups
constexpr int BN = 128;          // tokens per ring stage
constexpr int THREADS = 384;     // producer warpgroup + 2 consumers
constexpr int ROW = 128;         // bytes of one swizzled box row: 64 bf16
constexpr int Q_BYTES = BM * 2 * ROW;    // two 64-column boxes
constexpr int KV_BYTES = BN * 2 * ROW;   // K (or V) of one stage, bf16
constexpr int STAGE_BYTES = 2 * KV_BYTES;
constexpr int STAGE8_BYTES = 2 * BN * 128;   // K and V of one stage, e4m3
constexpr int CONVERTERS = 96;   // producer warps 1-3 (e4m3 pages)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The rings, by page dtype: three bf16 stages; or, for e4m3 pages, two
// bf16 stages fed by two e4m3 staging stages.  Beside them: Q, 128
// visibility bytes per stage, barriers and per-stage tile words.
template <bool KV8>
struct Ring {
  static constexpr int STAGES = KV8 ? 2 : 3;
  static constexpr int STAGES8 = KV8 ? 2 : 0;
  static constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES +
                                 STAGES8 * STAGE8_BYTES +
                                 (STAGES + STAGES8) * BN + 256;
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

struct Params {
  const int32_t* table;     // [B, n]
  const uint8_t* mask;      // [B, n * page] or null
  const uint8_t* any;       // [B, n]
  float* m;                 // [B, Hkv, G, Sq]
  float* l;
  float* acc;               // [B, Hkv, G, Sq, D]
  int Sq, Hkv, G, n, page;
  int ext0, ext1;           // valid prefix of entry 0 / of the others
  float scale_log2;
};

// The consumers' ring barriers.  K and V of a stage each have a full
// barrier (the tile has landed) and an empty one (every consumer warp is
// done with it): K is done after the tile's S = Q K^T, V only after its
// P V, one tile later.  With e4m3 pages the converters fill K and V
// apart, K as soon as its slot is free, so the widening overlaps the
// products; with bf16 pages TMA fills both at once, and the V barriers
// are the K ones (one empty barrier taking both sets of arrivals).
struct Bars {
  uint64_t* full_k;
  uint64_t* full_v;
  uint64_t* empty_k;
  uint64_t* empty_v;
};

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

// Sets to -inf the scores of the columns (tokens) of a mixed tile that
// its visibility bytes hide: a token's visibility is the same for every
// query row of b, so one 16-bit load serves a column pair of both rows.
__device__ __forceinline__ void mask_cols(float (&s)[BN / 2],
                                          const uint8_t* vis, int col0) {
  const float ninf = __int_as_float(0xff800000);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const uint32_t pair =
        *reinterpret_cast<const uint16_t*>(vis + 8 * j + col0);
    if (!(pair & 0xffu)) s[4 * j] = s[4 * j + 2] = ninf;
    if (!(pair >> 8)) s[4 * j + 1] = s[4 * j + 3] = ninf;
  }
}

template <int D, int STAGES>
__device__ __forceinline__ void consume(
    const Params& p, const uint8_t* sq, const uint8_t* skv, const Bars& bars,
    uint64_t* qbar, const volatile int* info, const uint8_t* vis, int r0,
    int h, int b) {
  constexpr int NO = D / 2;        // O values per thread (m64nD)
  constexpr int NS = BN / 2;       // S values per thread (m64nBN)
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int rloc = 64 * cw + 16 * warp + lane / 4;   // rows rloc, rloc + 8
  const int col0 = 2 * (lane % 4);
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

  // As in flash_mha's tensor-core kernel: the two consumer warpgroups take
  // turns at issuing their products (named barriers 1 and 2), and every
  // tile issues the same wgmma sequence (rows past Sq*G are computed and
  // not stored; the first tile's P V adds P = 0 times its own V).
  if (cw == 1) named_arrive(1, 256);
  mbar_wait(qbar, 0);
  int stage = 0, prev = -1;         // prev: the stage P V still reads
  uint32_t phase = 0, prev_phase = 0;
  for (;;) {
    mbar_wait(&bars.full_k[stage], phase);
    if (info[2 * stage] < 0) break;
    const bool mixed = info[2 * stage + 1] != 0;
    // the V this tile's P V reads: the previous tile's (the first tile's
    // P = 0 times its own)
    const int vs = prev >= 0 ? prev : stage;
    mbar_wait(&bars.full_v[vs], prev >= 0 ? prev_phase : phase);
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
    pv_tile<D>(o, pa, skv + vs * STAGE_BYTES + KV_BYTES);
    named_arrive(2 - cw, 256);
    wgmma_wait<1>();
    fence_regs(s);

    // hidden tokens' scores become -inf: their probabilities are then
    // exactly 0 (2^-inf), against a running maximum that starts at -1e30
    if (mixed) mask_cols(s, vis + stage * BN, col0);
    release(bars.empty_k, stage, lane);   // K, the words and bytes read
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
      const float m_new = fmaxf(m[r], mx[r] * p.scale_log2);
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      s[c] = exp2_approx(fmaf(s[c], p.scale_log2, -m[(c >> 1) & 1]));
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
    if (prev >= 0) release(bars.empty_v, prev, lane);
#pragma unroll
    for (int c = 0; c < NO; ++c) o[c] *= alpha[(c >> 1) & 1];
    // P in bf16: the accumulator layout of 16 keys is an A fragment
#pragma unroll
    for (int t = 0; t < BN / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
    prev = stage;
    prev_phase = phase;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (cw == 0) named_sync(1, 256);  // warpgroup 1's last turn
  if (prev >= 0) {
    mbar_wait(&bars.full_v[prev], prev_phase);
    pv_tile<D>(o, pa, skv + prev * STAGE_BYTES + KV_BYTES);
    wgmma_wait<0>();
    fence_regs(o);
    release(bars.empty_v, prev, lane);
  }

  // partials out in the [B,Hkv,G,Sq(,D)] layout, m in natural units
  // (scores x scale); a row that saw nothing keeps exactly (-1e30, 0, 0)
  const int R = p.Sq * p.G;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + rloc + 8 * r;
    if (row >= R) continue;
    const int i = row / p.G, g = row - i * p.G;
    const int64_t at =
        ((static_cast<int64_t>(b) * p.Hkv + h) * p.G + g) * p.Sq + i;
    if (lane % 4 == 0) {
      p.m[at] = m[r] == NEG_INF ? NEG_INF : m[r] * LN2;
      p.l[at] = l[r];
    }
    float* dst = p.acc + at * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
  }
}

// Warp 0 of the producer warpgroup, all 32 lanes: walks block_table[b, :]
// and, for every tile that some token of it is visible in, stages the
// tile's 128 visibility bytes (4 a lane) and its words (valid tokens,
// mixed), then lane 0 issues the TMA loads of its K and V rows into stage
// `stage` of the ring it feeds (bf16: the consumers' ring, two 64-column
// boxes each; e4m3: the staging ring, one unswizzled box of D bytes a
// row each).  Ends with a tile word of -1.
template <int D, bool KV8, int STAGES>
__device__ __forceinline__ void produce(
    const Params& p, const CUtensorMap* tq, const CUtensorMap* tk0,
    const CUtensorMap* tk1, const CUtensorMap* tv0, const CUtensorMap* tv1,
    uint8_t* sq, uint8_t* ring, uint64_t* full, uint64_t* empty,
    uint64_t* qbar, volatile int* info, uint8_t* vis, int r0, int h, int b) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    tma_prefetch(tq);
    tma_prefetch(tk0);
    tma_prefetch(tk1);
    tma_prefetch(tv0);
    tma_prefetch(tv1);
    // rows r0 .. r0 + 127 are (query i, group g) = (r / G, r % G): a box
    // of 128 / G positions x the G query heads of KV head h
    mbar_arrive_expect_tx(qbar, Q_BYTES);
    tma_load_4d(sq, tq, qbar, 0, h * p.G, r0 / p.G, b);
    tma_load_4d(sq + BM * ROW, tq, qbar, 64, h * p.G, r0 / p.G, b);
  }
  constexpr uint32_t BYTES = KV8 ? 2 * BN * D : STAGE_BYTES;
  constexpr int SLOT = KV8 ? STAGE8_BYTES : STAGE_BYTES;
  int stage = 0;
  uint32_t phase = 0;
  const int64_t row_bn = static_cast<int64_t>(b) * p.n;
  for (int e = 0; e < p.n; ++e) {
    // a page no token of which is visible contributes nothing: skipping
    // it is exact
    if (!p.any[row_bn + e]) continue;
    const int pid = p.table[row_bn + e];
    const int limit = e == 0 ? p.ext0 : p.ext1;
    const CUtensorMap* tk = e == 0 ? tk0 : tk1;
    const CUtensorMap* tv = e == 0 ? tv0 : tv1;
    const uint8_t* mrow =
        p.mask ? p.mask + (row_bn + e) * p.page : nullptr;
    for (int t0 = 0; t0 < limit; t0 += BN) {
      const int nvalid = min(BN, limit - t0);
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * lane + c;
        bool v = col < nvalid;
        if (v && mrow != nullptr) v = mrow[t0 + col] != 0;
        word |= static_cast<uint32_t>(v) << (8 * c);
      }
      // a tile that no token of is visible is left out: exact, since a
      // hidden token moves neither m nor l
      if (!__any_sync(0xffffffffu, word != 0)) continue;
      const bool all = __all_sync(0xffffffffu, word == 0x01010101u);
      mbar_wait(&empty[stage], phase ^ 1);
      reinterpret_cast<uint32_t*>(vis + stage * BN)[lane] = word;
      if (lane == 0) {
        info[2 * stage] = nvalid;
        info[2 * stage + 1] = all ? 0 : 1;
      }
      __syncwarp();
      if (lane == 0) {
        uint8_t* dk = ring + stage * SLOT;
        mbar_arrive_expect_tx(&full[stage], BYTES);
        if constexpr (KV8) {
          tma_load_4d(dk, tk, &full[stage], 0, h, t0, pid);
          tma_load_4d(dk + BN * 128, tv, &full[stage], 0, h, t0, pid);
        } else {
          uint8_t* dv = dk + KV_BYTES;
          tma_load_4d(dk, tk, &full[stage], 0, h, t0, pid);
          tma_load_4d(dk + BN * ROW, tk, &full[stage], 64, h, t0, pid);
          tma_load_4d(dv, tv, &full[stage], 0, h, t0, pid);
          tma_load_4d(dv + BN * ROW, tv, &full[stage], 64, h, t0, pid);
        }
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  mbar_wait(&empty[stage], phase ^ 1);
  if (lane == 0) {
    info[2 * stage] = -1;          // end of the tiles
    mbar_arrive(&full[stage]);
  }
}

// One staged e4m3 tile (rows of D bytes) widened to bf16 in the 128-byte
// swizzle of a consumer stage's K or V slot, 16 values (one 16-byte chunk
// of a row) a step, by the 96 converter threads (c: this one's index).
template <int D>
__device__ __forceinline__ void widen_tile(const uint8_t* src, uint8_t* dst,
                                           int c) {
  constexpr int CHUNKS = BN * (D / 16);    // 16-byte chunks of one tile
  for (int idx = c; idx < CHUNKS; idx += CONVERTERS) {
    int row, j;
    if constexpr (D == 128) {
      chunk_of(idx, row, j);               // rows of 128 bytes: no conflict
    } else {
      row = idx / (D / 16);
      j = idx - row * (D / 16);
    }
    uint4 lo, hi;
    widen_e4m3x16(*reinterpret_cast<const uint4*>(src + row * D + 16 * j),
                  lo, hi);
    st_sw128_bf16x16(dst, BN * ROW, row, j, lo, hi);
  }
}

// Producer warps 1-3 for e4m3 pages: each staged tile's K, then its V,
// is widened into the consumer stage's K and V slots, each as soon as
// that slot is free (K's after the previous use's S, V's only after its
// P V); the tile words and visibility bytes go along with K.  Every
// converter thread arrives on the slot's full barrier after a proxy
// fence (wgmma reads what plain stores wrote).
template <int D>
__device__ __forceinline__ void convert(
    const uint8_t* ring8, uint8_t* skv, uint64_t* full8, uint64_t* empty8,
    const Bars& bars, const volatile int* info8, volatile int* info,
    const uint8_t* vis8, uint8_t* vis) {
  constexpr int STAGES = Ring<true>::STAGES, STAGES8 = Ring<true>::STAGES8;
  const int c = threadIdx.x - 32;
  const int lane = threadIdx.x % 32;
  int s8 = 0, s16 = 0;
  uint32_t ph8 = 0, ph16 = 0;
  for (;;) {
    mbar_wait(&full8[s8], ph8);
    const int nvalid = info8[2 * s8], mixed = info8[2 * s8 + 1];
    const uint8_t* src = ring8 + s8 * STAGE8_BYTES;
    uint8_t* dst = skv + s16 * STAGE_BYTES;
    mbar_wait(&bars.empty_k[s16], ph16 ^ 1);
    if (nvalid >= 0) {
      widen_tile<D>(src, dst, c);
      if (c < BN / 4)
        reinterpret_cast<uint32_t*>(vis + s16 * BN)[c] =
            reinterpret_cast<const uint32_t*>(vis8 + s8 * BN)[c];
    }
    if (c == 0) {
      info[2 * s16] = nvalid;
      info[2 * s16 + 1] = mixed;
    }
    fence_proxy_async();
    mbar_arrive(&bars.full_k[s16]);
    if (nvalid < 0) break;
    mbar_wait(&bars.empty_v[s16], ph16 ^ 1);
    widen_tile<D>(src + BN * 128, dst + KV_BYTES, c);
    fence_proxy_async();
    mbar_arrive(&bars.full_v[s16]);
    release(empty8, s8, lane);
    if (++s8 == STAGES8) {
      s8 = 0;
      ph8 ^= 1;
    }
    if (++s16 == STAGES) {
      s16 = 0;
      ph16 ^= 1;
    }
  }
}

template <int D, bool KV8>
__global__ void __launch_bounds__(THREADS, 1)
paged_chunk_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk0,
                                   const __grid_constant__ CUtensorMap tk1,
                                   const __grid_constant__ CUtensorMap tv0,
                                   const __grid_constant__ CUtensorMap tv1,
                                   Params p) {
  using RG = Ring<KV8>;
  constexpr int STAGES = RG::STAGES, STAGES8 = RG::STAGES8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* skv = sq + Q_BYTES;
  uint8_t* ring8 = skv + STAGES * STAGE_BYTES;
  uint8_t* vis = ring8 + STAGES8 * STAGE8_BYTES;
  uint8_t* vis8 = vis + STAGES * BN;
  // bf16 pages: full and empty per stage; e4m3 pages: full and empty per
  // stage for K and for V, then the staging ring's
  uint64_t* bar0 = reinterpret_cast<uint64_t*>(vis8 + STAGES8 * BN);
  constexpr int NB = KV8 ? 4 : 2;            // barriers per consumer stage
  const Bars bars{bar0, bar0 + (KV8 ? 2 : 0) * STAGES,
                  bar0 + STAGES, bar0 + (KV8 ? 3 : 1) * STAGES};
  uint64_t* full8 = bar0 + NB * STAGES;
  uint64_t* empty8 = full8 + STAGES8;
  uint64_t* qbar = empty8 + STAGES8;
  volatile int* info = reinterpret_cast<volatile int*>(qbar + 1);
  volatile int* info8 = info + 2 * STAGES;

  const int r0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      // full: TMA's one arrival, or every converter thread; empty: every
      // consumer warp, after S and (bf16, the same barrier) after P V
      mbar_init(&bars.full_k[st], KV8 ? CONVERTERS : 1);
      mbar_init(&bars.empty_k[st], KV8 ? 8 : 16);
      if constexpr (KV8) {
        mbar_init(&bars.full_v[st], CONVERTERS);
        mbar_init(&bars.empty_v[st], 8);
      }
    }
    for (int st = 0; st < STAGES8; ++st) {
      mbar_init(&full8[st], 1);
      mbar_init(&empty8[st], CONVERTERS / 32);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      if constexpr (KV8)
        produce<D, true, STAGES8>(p, &tq, &tk0, &tk1, &tv0, &tv1, sq, ring8,
                                  full8, empty8, qbar, info8, vis8, r0, h,
                                  b);
      else
        produce<D, false, STAGES>(p, &tq, &tk0, &tk1, &tv0, &tv1, sq, skv,
                                  bars.full_k, bars.empty_k, qbar, info, vis,
                                  r0, h, b);
    } else if constexpr (KV8) {
      convert<D>(ring8, skv, full8, empty8, bars, info8, info, vis8, vis);
    }
  } else {
    setmaxnreg_inc<232>();
    consume<D, STAGES>(p, sq, skv, bars, qbar, info, vis, r0, h, b);
  }
}

// The pool view [n_pages, page, Hkv, D] as a 4-D tensor map from its own
// strides (in elements: page, token; heads and D dense), with `extent`
// tokens per page: TMA writes zeros past it, so a box never reads a
// page's tail past its valid prefix nor the next page.  bf16: boxes of 64
// head-dim columns in the 128-byte swizzle; e4m3: boxes of D bytes,
// unswizzled (the converters read them).
inline int pool_map(CUtensorMap* map, const void* base, bool kv8, int D,
                    int Hkv, int extent, int n_pages, int64_t page_stride,
                    int64_t tok_stride) {
  const cuuint64_t elt = kv8 ? 1 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(extent),
                              static_cast<cuuint64_t>(n_pages)};
  const cuuint64_t strides[3] = {
      elt * D, elt * static_cast<cuuint64_t>(tok_stride),
      elt * static_cast<cuuint64_t>(page_stride)};
  const cuuint32_t box[4] = {kv8 ? static_cast<cuuint32_t>(D) : 64u, 1, BN,
                             1};
  return encode_tiled(map,
                      kv8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      4, base, dims, strides, box,
                      kv8 ? CU_TENSOR_MAP_SWIZZLE_NONE
                          : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, bool KV8>
int launch(const Args& a, int n_pages) {
  const int G = a.Hq / a.Hkv;
  const bool hinted = a.sink > 0 && a.chunk_tokens > 0;
  const int ext0 = hinted && a.sink < a.page ? a.sink : a.page;
  const int ext1 = hinted && a.chunk_tokens < a.page ? a.chunk_tokens : a.page;
  Params p{a.bt, a.mask, a.any, a.m, a.l, a.acc, a.Sq, a.Hkv, G, a.n,
           a.page, ext0, ext1, LOG2E / sqrtf(static_cast<float>(D))};
  // q [B, Sq, Hq, D] bf16: boxes of 64 columns x G heads x BM / G rows
  CUtensorMap tq, tk0, tk1, tv0, tv1;
  const cuuint64_t qd[4] = {static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(a.Hq),
                            static_cast<cuuint64_t>(a.Sq),
                            static_cast<cuuint64_t>(a.B)};
  const cuuint64_t qs[3] = {2ull * D, 2ull * D * a.Hq, 2ull * D * a.Hq * a.Sq};
  const cuuint32_t qb[4] = {64, static_cast<cuuint32_t>(G),
                            static_cast<cuuint32_t>(BM / G), 1};
  if (encode_tiled(&tq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, a.q, qd, qs,
                   qb) ||
      pool_map(&tk0, a.k, KV8, D, a.Hkv, p.ext0, n_pages, a.page_stride,
               a.tok_stride) ||
      pool_map(&tk1, a.k, KV8, D, a.Hkv, p.ext1, n_pages, a.page_stride,
               a.tok_stride) ||
      pool_map(&tv0, a.v, KV8, D, a.Hkv, p.ext0, n_pages, a.page_stride,
               a.tok_stride) ||
      pool_map(&tv1, a.v, KV8, D, a.Hkv, p.ext1, n_pages, a.page_stride,
               a.tok_stride))
    return -4;
  auto kern = paged_chunk_attention_wgmma_kernel<D, KV8>;
  constexpr size_t smem = Ring<KV8>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sq * G + BM - 1) / BM, a.Hkv, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(tq, tk0, tk1, tv0, tv1, p);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 pages at D = 96: persistent blocks over parts of the context ----

namespace d96 {

constexpr int D = 96;
// three consumer warpgroups of 64 rows (an item's rows, ops.CHUNK_ROWS):
// each one's softmax has the two others' products to hide behind
constexpr int WGS = 3;
constexpr int BM = 64 * WGS;
constexpr int THREADS = 128 * (WGS + 1);
constexpr int TURN_BAR = 1;               // named barriers 1..WGS: turns
constexpr int STORE_BAR = 1 + WGS;        // a warpgroup's own barrier
// registers per thread after setmaxnreg: the producer warpgroup's and the
// consumers' (the block's 64 K registers)
constexpr int PRODUCER_REGS = 32;
constexpr int CONSUMER_REGS = 160;
// the tiles' layout: three 32-column boxes in the 64-byte swizzle (24 KB a
// tile, no zero-filled columns)
constexpr int BOX = 32;                   // head-dim columns of a TMA box
constexpr int ROW = 2 * BOX;              // bytes of a box row
constexpr int NBOX = D / BOX;
constexpr int KSTEPS = BOX / 16;          // k16 steps in a box
constexpr int Q_BYTES = BM * NBOX * ROW;
constexpr int KV_BYTES = BN * NBOX * ROW; // K (or V) of one tile
constexpr int STAGE_BYTES = 2 * KV_BYTES;
constexpr int Q_BUFS = 2;                 // the next item's Q loads early
constexpr int STAGES = 3;
constexpr int NO = D / 2;                 // O values per thread (m64n96)
constexpr int NS = BN / 2;                // S values per thread (m64n128)
constexpr int SLOT = NO + 4;              // a thread's partial: O, m, l
constexpr size_t SMEM = 1024 + Q_BUFS * Q_BYTES + STAGES * STAGE_BYTES +
                        STAGES * BN + 256;
static_assert(SMEM <= 232448, "over the 227 KB a block may use");

struct Params {
  const int32_t* table;     // [B, n]
  const uint8_t* mask;      // [B, n * page] or null
  const uint8_t* any;       // [B, n]
  float* m;                 // [B, Hkv, G, Sq]
  float* l;
  float* acc;               // [B, Hkv, G, Sq, D]
  int* sched;               // [0]: the item counter; [1 + u]: unit u's
                            // parts done (the wrapper zeroes both)
  float* scratch;           // [units, n_parts, SLOT, 128] (null: one part)
  int B, Sq, Hkv, G, n, page;
  int ext0, ext1;           // valid prefix of entry 0 / of the others
  int T0, T1;               // key tiles of entry 0 / of the others
  int n_pos;                // key-tile positions: T0 + (n - 1) T1
  int part_tiles, n_parts;  // a part: part_tiles positions, the last less
  int n_rt, n_items;        // row tiles of BM; items
  float scale_log2;
};

// Rank r's item (ops.chunk_item mirrors it): parts first, so that every
// row tile's first parts (the longest) come before any last part, then
// batch row, KV head and row tile, so that the items in flight share a
// (b, KV head)'s K and V in L2
__device__ __forceinline__ void item_of(const Params& p, int r, int& part,
                                        int& b, int& h, int& rt) {
  rt = r % p.n_rt;
  int t = r / p.n_rt;
  h = t % p.Hkv;
  t /= p.Hkv;
  b = t % p.B;
  part = t / p.B;
}

// The online softmax of a tile's scores in the log2 domain: the row
// maxima over the 4 lanes of a row, P = 2^(s scale - m) in place, this
// lane's share of the row sums into l (the lanes' shares add up when the
// item ends); alpha: the factor the rows' O takes to the new maximum
__device__ __forceinline__ void softmax(float (&s)[NS], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        float scale) {
  float mx[2] = {NEG_INF, NEG_INF}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NS; ++c)
    mx[(c >> 1) & 1] = fmaxf(mx[(c >> 1) & 1], s[c]);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float& mr = mx[x];
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    const float m_new = fmaxf(m[x], mr * scale);
    alpha[x] = exp2_approx(m[x] - m_new);
    m[x] = m_new;
  }
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    s[c] = exp2_approx(fmaf(s[c], scale, -m[(c >> 1) & 1]));
    rs[(c >> 1) & 1] += s[c];
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) l[x] = l[x] * alpha[x] + rs[x];
}

// a wgmma descriptor of a tile in the boxes' swizzle (SBO: eight rows)
__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo) {
  return desc_sw64(smem, lbo, 8 * ROW);
}

// atomicAdd with acquire and release at GPU scope: after a block barrier,
// it orders the block's earlier writes before it (release is cumulative)
// and later reads after the other blocks' writes it observes
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// the first key-tile position of table entry e
__device__ __forceinline__ int entry_pos(const Params& p, int e) {
  return e == 0 ? 0 : p.T0 + (e - 1) * p.T1;
}

// O += P V over a tile's keys in k16 steps: V's boxes are the n96
// operand's column blocks (LBO: one box to the next)
__device__ __forceinline__ void pv_tile(float (&o)[NO],
                                        const uint32_t (&pa)[BN / 16][4],
                                        const uint8_t* sv) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < BN / 16; ++t)
    wgmma_m64n96k16_rs_bf16_tb(o, pa[t], desc(sv + t * 16 * ROW, BN * ROW),
                               1);
  wgmma_commit();
}

// The warpgroup's 64 rows of an item out: straight to m, l, acc when the
// context is one part; else into the part's scratch slot, and the last of
// the unit's parts to finish merges every part's slot in part order (so
// the result does not depend on which finishes last) and stores it.
__device__ __forceinline__ void store_rows(const Params& p, float (&o)[NO],
                                           float (&m)[2], float (&l)[2],
                                           volatile int* done, int part,
                                           int b, int h, int rt, int cw) {
  const int tw = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {             // the row sums over its 4 lanes
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (p.n_parts > 1) {
    const int64_t unit =
        ((static_cast<int64_t>(b) * p.Hkv + h) * p.n_rt + rt) * WGS + cw;
    float* base = p.scratch + unit * p.n_parts * (SLOT * 128) + tw;
    float* mine = base + part * (SLOT * 128);
#pragma unroll
    for (int c = 0; c < NO; ++c) mine[c * 128] = o[c];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mine[(NO + r) * 128] = m[r];
      mine[(NO + 2 + r) * 128] = l[r];
    }
    named_sync(STORE_BAR + cw, 128);
    if (tw == 0) done[cw] = atomic_add_acq_rel(p.sched + 1 + unit, 1);
    named_sync(STORE_BAR + cw, 128);
    // (the next write of done[cw] follows the next item's first sync,
    // which every thread reaches after this read)
    if (done[cw] != p.n_parts - 1) return;
    float mx[2] = {NEG_INF, NEG_INF};
    for (int k = 0; k < p.n_parts; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r] = fmaxf(mx[r], __ldcg(base + k * (SLOT * 128) +
                                    (NO + r) * 128));
#pragma unroll
    for (int c = 0; c < NO; ++c) o[c] = 0.f;
    l[0] = l[1] = 0.f;
    for (int k = 0; k < p.n_parts; ++k) {
      const float* src = base + k * (SLOT * 128);
      float w[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // a part at the maximum weighs exactly 1: a row whose other parts
        // see nothing gets the one part's partial bit for bit
        const float mk = __ldcg(src + (NO + r) * 128);
        w[r] = mk == mx[r] ? 1.f : exp2_approx(mk - mx[r]);
        l[r] = fmaf(__ldcg(src + (NO + 2 + r) * 128), w[r], l[r]);
      }
#pragma unroll
      for (int c = 0; c < NO; ++c)
        o[c] = fmaf(__ldcg(src + c * 128), w[(c >> 1) & 1], o[c]);
    }
    m[0] = mx[0];
    m[1] = mx[1];
  }
  // partials out in the [B,Hkv,G,Sq(,D)] layout, m in natural units
  // (scores x scale); a row that saw nothing keeps exactly (-1e30, 0, 0)
  const int R = p.Sq * p.G;
  const int col0 = 2 * (lane % 4);
  const int rloc = rt * BM + 64 * cw + 16 * (tw / 32) + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rloc + 8 * r;
    if (row >= R) continue;
    const int i = row / p.G, g = row - i * p.G;
    const int64_t at =
        ((static_cast<int64_t>(b) * p.Hkv + h) * p.G + g) * p.Sq + i;
    if (lane % 4 == 0) {
      p.m[at] = m[r] == NEG_INF ? NEG_INF : m[r] * LN2;
      p.l[at] = l[r];
    }
    float* dst = p.acc + at * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
  }
}

// The consumer warpgroups: for each item the producer hands over (its rank
// in the Q buffer's slot; -1: no more), each of the item's tiles in turn:
// S = Q K^T, the mask, the softmax, O's rescale and P V (the other two
// warpgroups' products cover this one's softmax, and S, P and O are never
// all live), turns through named barriers 1..3, the same wgmma sequence on
// every tile, until the item's end word; then its rows out.  The end
// word's stage and the Q buffer are released at once, so the next item's
// Q and tiles load meanwhile.
__device__ __forceinline__ void consume(
    const Params& p, const uint8_t* sq, const uint8_t* skv, uint64_t* full,
    uint64_t* empty, uint64_t* qfull, uint64_t* qempty,
    const volatile int* info, const volatile int* item_slot,
    const uint8_t* vis, volatile int* done) {
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32;
  const int col0 = 2 * (lane % 4);
  const float scale = p.scale_log2;

  float o[NO], s[NS];
  uint32_t pa[BN / 16][4];          // P of the tile, bf16 pairs
#pragma unroll
  for (int c = 0; c < NS; ++c) s[c] = 0.f;

  // the warpgroups take turns at issuing their products, 0, 1, 2, 0, ..
  // across tiles and items; the last one's arrival opens 0's first turn
  const int turn = TURN_BAR + cw, next_turn = TURN_BAR + (cw + 1) % WGS;
  if (cw == WGS - 1) named_arrive(TURN_BAR, 256);
  int stage = 0;
  uint32_t phase = 0;
  for (int k = 0;; ++k) {
    const int qb = k % Q_BUFS;
    mbar_wait(&qfull[qb], (k / Q_BUFS) & 1);
    const int r = item_slot[qb];
    if (r < 0) break;
    int part, b, h, rt;
    item_of(p, r, part, b, h, rt);
    const uint8_t* q_wg = sq + qb * Q_BYTES + 64 * cw * ROW;
#pragma unroll
    for (int c = 0; c < NO; ++c) o[c] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    for (;;) {
      mbar_wait(&full[stage], phase);
      if (info[2 * stage] < 0) break;
      const bool mixed = info[2 * stage + 1] != 0;
      const uint8_t* sk = skv + stage * STAGE_BYTES;
      named_sync(turn, 256);
      // S = Q K^T over D 96 in k16 steps: box kk / KSTEPS, 32 bytes a
      // step inside its rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % KSTEPS) * 32;
        wgmma_m64n128k16_ss_bf16(
            s, desc(q_wg + (kk / KSTEPS) * BM * ROW + off, 16),
            desc(sk + (kk / KSTEPS) * BN * ROW + off, 16), kk > 0);
      }
      wgmma_commit();
      named_arrive(next_turn, 256);
      wgmma_wait<0>();
      fence_regs(s);
      // hidden tokens' scores become -inf, then the softmax; K, the words
      // and the bytes are released once read, V after P V
      if (mixed) mask_cols(s, vis + stage * BN, col0);
      release(empty, stage, lane);
      float alpha[2];
      softmax(s, m, l, alpha, scale);
#pragma unroll
      for (int c = 0; c < NO; ++c) o[c] *= alpha[(c >> 1) & 1];
#pragma unroll
      for (int t = 0; t < BN / 16; ++t)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[t][x] = pack_bf16(s[8 * t + 2 * x], s[8 * t + 2 * x + 1]);
      pv_tile(o, pa, sk + KV_BYTES);
      wgmma_wait<0>();
      fence_regs(o);
      release(empty, stage, lane);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    // the end word's stage (both of each warp's arrivals), and Q: every S
    // of the item has completed
    release(empty, stage, lane);
    release(empty, stage, lane);
    release(qempty, qb, lane);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    store_rows(p, o, m, l, done, part, b, h, rt, cw);
  }
  if (cw == 0) named_sync(TURN_BAR, 256);  // the last one's last turn
}

// Warp 0 of the producer warpgroup, all 32 lanes: takes items from the
// counter as its Q buffers free up (lane 0's atomicAdd), loads each item's
// Q (three boxes of 128 / G positions x G heads), then walks the table
// entries of the item's part (key-tile positions [part x part_tiles, +
// part_tiles)), skipping entries with page_any == 0 and tiles no token
// of which is visible, and stages each tile as the general instance does
// (visibility bytes, words, three 32-column boxes each of K and V); ends
// the item with a word of -1 and the kernel with a Q slot of -1.
__device__ __forceinline__ void produce(
    const Params& p, const CUtensorMap* tq, const CUtensorMap* tk0,
    const CUtensorMap* tk1, const CUtensorMap* tv0, const CUtensorMap* tv1,
    uint8_t* sq, uint8_t* skv, uint64_t* full, uint64_t* empty,
    uint64_t* qfull, uint64_t* qempty, volatile int* info,
    volatile int* item_slot, uint8_t* vis) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    tma_prefetch(tq);
    tma_prefetch(tk0);
    tma_prefetch(tk1);
    tma_prefetch(tv0);
    tma_prefetch(tv1);
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int k = 0;; ++k) {
    const int qb = k % Q_BUFS;
    mbar_wait(&qempty[qb], ((k / Q_BUFS) & 1) ^ 1);
    int r = 0;
    if (lane == 0) r = atomicAdd(p.sched, 1);
    r = __shfl_sync(0xffffffffu, r, 0);
    if (r >= p.n_items) {
      if (lane == 0) {
        item_slot[qb] = -1;
        mbar_arrive(&qfull[qb]);
      }
      break;
    }
    int part, b, h, rt;
    item_of(p, r, part, b, h, rt);
    if (lane == 0) {
      // rows rt*128 .. +127 are (query i, group g) = (row / G, row % G)
      uint8_t* dq = sq + qb * Q_BYTES;
      item_slot[qb] = r;
      mbar_arrive_expect_tx(&qfull[qb], Q_BYTES);
#pragma unroll
      for (int x = 0; x < NBOX; ++x)
        tma_load_4d(dq + x * BM * ROW, tq, &qfull[qb], BOX * x, h * p.G,
                    rt * BM / p.G, b);
    }
    const int p0 = part * p.part_tiles;
    const int p1 = min(p0 + p.part_tiles, p.n_pos);
    const int64_t row_bn = static_cast<int64_t>(b) * p.n;
    for (int e = p0 < p.T0 ? 0 : 1 + (p0 - p.T0) / p.T1;
         e < p.n && entry_pos(p, e) < p1; ++e) {
      // a page no token of which is visible contributes nothing
      if (!p.any[row_bn + e]) continue;
      const int pid = p.table[row_bn + e];
      const int base = entry_pos(p, e);
      const int limit = e == 0 ? p.ext0 : p.ext1;
      const CUtensorMap* tk = e == 0 ? tk0 : tk1;
      const CUtensorMap* tv = e == 0 ? tv0 : tv1;
      const uint8_t* mrow =
          p.mask ? p.mask + (row_bn + e) * p.page : nullptr;
      const int ta = max(p0 - base, 0);
      const int tb = min(p1 - base, e == 0 ? p.T0 : p.T1);
      for (int t = ta; t < tb; ++t) {
        const int t0 = t * BN;
        const int nvalid = min(BN, limit - t0);
        uint32_t word = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 4 * lane + c;
          bool v = col < nvalid;
          if (v && mrow != nullptr) v = mrow[t0 + col] != 0;
          word |= static_cast<uint32_t>(v) << (8 * c);
        }
        if (!__any_sync(0xffffffffu, word != 0)) continue;
        const bool all = __all_sync(0xffffffffu, word == 0x01010101u);
        mbar_wait(&empty[stage], phase ^ 1);
        reinterpret_cast<uint32_t*>(vis + stage * BN)[lane] = word;
        if (lane == 0) {
          info[2 * stage] = nvalid;
          info[2 * stage + 1] = all ? 0 : 1;
        }
        __syncwarp();
        if (lane == 0) {
          uint8_t* dk = skv + stage * STAGE_BYTES;
          mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
#pragma unroll
          for (int x = 0; x < NBOX; ++x) {
            tma_load_4d(dk + x * BN * ROW, tk, &full[stage], BOX * x, h, t0,
                        pid);
            tma_load_4d(dk + KV_BYTES + x * BN * ROW, tv, &full[stage],
                        BOX * x, h, t0, pid);
          }
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    mbar_wait(&empty[stage], phase ^ 1);
    if (lane == 0) {
      info[2 * stage] = -1;          // end of the item
      mbar_arrive(&full[stage]);
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
paged_chunk_attention_wgmma96_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk0,
                                     const __grid_constant__ CUtensorMap tk1,
                                     const __grid_constant__ CUtensorMap tv0,
                                     const __grid_constant__ CUtensorMap tv1,
                                     Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* skv = sq + Q_BUFS * Q_BYTES;
  uint8_t* vis = skv + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(vis + STAGES * BN);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + Q_BUFS;
  volatile int* info = reinterpret_cast<volatile int*>(qempty + Q_BUFS);
  volatile int* item_slot = info + 2 * STAGES;
  volatile int* done = item_slot + Q_BUFS;       // one slot a warpgroup

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      // full: TMA's one arrival; empty: every consumer warp after S and
      // after P V
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8 * WGS);
    }
    for (int st = 0; st < Q_BUFS; ++st) {
      mbar_init(&qfull[st], 1);
      mbar_init(&qempty[st], 4 * WGS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32)
      produce(p, &tq, &tk0, &tk1, &tv0, &tv1, sq, skv, full, empty, qfull,
              qempty, info, item_slot, vis);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume(p, sq, skv, full, empty, qfull, qempty, info, item_slot, vis,
            done);
  }
}

// The pool view [n_pages, page, Hkv, 96] as a 4-D tensor map from its own
// strides (in elements) with `extent` tokens per page, in boxes of BOX
// head-dim columns x BN tokens in the boxes' swizzle
constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_64B;

inline int pool_map(CUtensorMap* map, const void* base, int Hkv, int extent,
                    int n_pages, int64_t page_stride, int64_t tok_stride) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(extent),
                              static_cast<cuuint64_t>(n_pages)};
  const cuuint64_t strides[3] = {2ull * D,
                                 2ull * static_cast<cuuint64_t>(tok_stride),
                                 2ull * static_cast<cuuint64_t>(page_stride)};
  const cuuint32_t box[4] = {BOX, 1, BN, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                      strides, box, SWIZZLE);
}

// n_blocks: the persistent grid (ops: one block per SM, at most one per
// item); sched: 1 + B * Hkv * n_rt * WGS int32 the wrapper zeroes;
// scratch: B * Hkv * n_rt * WGS * n_parts * SLOT * 128 floats when the
// context is cut into more than one part of part_tiles key tiles.
int launch(const Args& a, int n_pages, int part_tiles, int n_blocks,
           int* sched, float* scratch) {
  const int G = a.Hq / a.Hkv;
  const bool hinted = a.sink > 0 && a.chunk_tokens > 0;
  Params p{};
  p.table = a.bt;
  p.mask = a.mask;
  p.any = a.any;
  p.m = a.m;
  p.l = a.l;
  p.acc = a.acc;
  p.sched = sched;
  p.scratch = scratch;
  p.B = a.B;
  p.Sq = a.Sq;
  p.Hkv = a.Hkv;
  p.G = G;
  p.n = a.n;
  p.page = a.page;
  p.ext0 = hinted && a.sink < a.page ? a.sink : a.page;
  p.ext1 = hinted && a.chunk_tokens < a.page ? a.chunk_tokens : a.page;
  p.T0 = (p.ext0 + BN - 1) / BN;
  p.T1 = (p.ext1 + BN - 1) / BN;
  p.n_pos = a.n > 0 ? p.T0 + (a.n - 1) * p.T1 : 0;
  p.part_tiles = part_tiles;
  p.n_parts = p.n_pos > part_tiles ? (p.n_pos + part_tiles - 1) / part_tiles
                                   : 1;
  p.n_rt = (a.Sq * G + BM - 1) / BM;
  p.scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  const long long n_items =
      static_cast<long long>(p.n_parts) * a.B * a.Hkv * p.n_rt;
  if (part_tiles <= 0 || n_items > INT_MAX || n_blocks <= 0 ||
      n_blocks > n_items || sched == nullptr ||
      (p.n_parts > 1 && scratch == nullptr))
    return -5;
  p.n_items = static_cast<int>(n_items);
  // q [B, Sq, Hq, 96] bf16: boxes of BOX columns x G heads x BM / G rows
  CUtensorMap tq, tk0, tk1, tv0, tv1;
  const cuuint64_t qd[4] = {static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(a.Hq),
                            static_cast<cuuint64_t>(a.Sq),
                            static_cast<cuuint64_t>(a.B)};
  const cuuint64_t qs[3] = {2ull * D, 2ull * D * a.Hq, 2ull * D * a.Hq * a.Sq};
  const cuuint32_t qb[4] = {BOX, static_cast<cuuint32_t>(G),
                            static_cast<cuuint32_t>(BM / G), 1};
  if (encode_tiled(&tq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, a.q, qd, qs, qb,
                   SWIZZLE) ||
      pool_map(&tk0, a.k, a.Hkv, p.ext0, n_pages, a.page_stride,
               a.tok_stride) ||
      pool_map(&tk1, a.k, a.Hkv, p.ext1, n_pages, a.page_stride,
               a.tok_stride) ||
      pool_map(&tv0, a.v, a.Hkv, p.ext0, n_pages, a.page_stride,
               a.tok_stride) ||
      pool_map(&tv1, a.v, a.Hkv, p.ext1, n_pages, a.page_stride,
               a.tok_stride))
    return -4;
  auto kern = paged_chunk_attention_wgmma96_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<n_blocks, THREADS, SMEM, a.stream>>>(tq, tk0, tk1, tv0, tv1, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace d96

}  // namespace tc

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn (KV only).
// page_stride / tok_stride: the pools' strides (in elements) of their
// page and token dims: page * Hkv * D and Hkv * D for a dense pool.
// Returns 0, a cudaError_t code, or -1 / -2 / -3 for an unsupported head
// dim / KV dtype / query dtype.  Launches on `stream`; never synchronises.
extern "C" int paged_chunk_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* page_mask, const void* page_any,
    void* m, void* l, void* acc, int B, int Sq, int Hq, int Hkv, int D,
    int page, int n, int sink, int chunk_tokens, int q_dtype, int kv_dtype,
    long long page_stride, long long tok_stride, void* stream) {
  Args a{q, k_pages, v_pages, static_cast<const int32_t*>(block_table),
         static_cast<const uint8_t*>(page_mask),
         static_cast<const uint8_t*>(page_any), static_cast<float*>(m),
         static_cast<float*>(l), static_cast<float*>(acc), B, Sq, Hq, Hkv,
         page, n, sink, chunk_tokens, page_stride, tok_stride,
         static_cast<cudaStream_t>(stream)};
  if (B == 0 || Sq == 0) return 0;
  switch (D) {
    case 16: return launch_q<16>(a, q_dtype, kv_dtype);
    case 96: return launch_q<96>(a, q_dtype, kv_dtype);
    case 128: return launch_q<128>(a, q_dtype, kv_dtype);
  }
  return -1;
}

// The tensor-core kernel: the arguments of paged_chunk_attention_launch
// and the pool's page count; q bf16 (q_dtype 1), pages bf16 or e4m3
// (kv_dtype 1 or 2), D 96 or 128, a group G = Hq / Hkv that divides 128.
// q and the pools must be 16-byte aligned, and the pools' strides
// multiples of 16 bytes.  Returns as paged_chunk_attention_launch, or -4
// when a tensor map cannot be encoded, -5 for the group.
extern "C" int paged_chunk_attention_wgmma_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* page_mask, const void* page_any,
    void* m, void* l, void* acc, int B, int Sq, int Hq, int Hkv, int D,
    int page, int n, int sink, int chunk_tokens, int q_dtype, int kv_dtype,
    long long page_stride, long long tok_stride, int n_pages,
    void* stream) {
  Args a{q, k_pages, v_pages, static_cast<const int32_t*>(block_table),
         static_cast<const uint8_t*>(page_mask),
         static_cast<const uint8_t*>(page_any), static_cast<float*>(m),
         static_cast<float*>(l), static_cast<float*>(acc), B, Sq, Hq, Hkv,
         page, n, sink, chunk_tokens, page_stride, tok_stride,
         static_cast<cudaStream_t>(stream)};
  if (B == 0 || Sq == 0) return 0;
  if (q_dtype != 1) return -3;
  if (kv_dtype != 1 && kv_dtype != 2) return -2;
  if (Hkv <= 0 || Hq % Hkv || 128 % (Hq / Hkv) || B > 65535 ||
      Hkv > 65535 || n_pages <= 0)
    return -5;
  const bool kv8 = kv_dtype == 2;
  switch (D) {
    case 96: return kv8 ? tc::launch<96, true>(a, n_pages)
                        : tc::launch<96, false>(a, n_pages);
    case 128: return kv8 ? tc::launch<128, true>(a, n_pages)
                         : tc::launch<128, false>(a, n_pages);
  }
  return -1;
}

// The D 96 instance (bf16 q over bf16 pages at D 96): the arguments of
// paged_chunk_attention_wgmma_launch, then the persistent grid n_blocks,
// the part length part_tiles (key tiles; ops.CHUNK_PART_TILES), sched
// (1 + B * Hkv * ceil(Sq * G / 192) * 3 zeroed int32) and scratch (null,
// or the parts' partials: ops.chunk_scratch_floats).  The group must
// divide an item's 192 rows.  Returns as paged_chunk_attention_wgmma_launch.
extern "C" int paged_chunk_attention_wgmma96_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* page_mask, const void* page_any,
    void* m, void* l, void* acc, int B, int Sq, int Hq, int Hkv, int D,
    int page, int n, int sink, int chunk_tokens, int q_dtype, int kv_dtype,
    long long page_stride, long long tok_stride, int n_pages, int part_tiles,
    int n_blocks, void* sched, void* scratch, void* stream) {
  Args a{q, k_pages, v_pages, static_cast<const int32_t*>(block_table),
         static_cast<const uint8_t*>(page_mask),
         static_cast<const uint8_t*>(page_any), static_cast<float*>(m),
         static_cast<float*>(l), static_cast<float*>(acc), B, Sq, Hq, Hkv,
         page, n, sink, chunk_tokens, page_stride, tok_stride,
         static_cast<cudaStream_t>(stream)};
  if (B == 0 || Sq == 0) return 0;
  if (D != 96) return -1;
  if (q_dtype != 1) return -3;
  if (kv_dtype != 1) return -2;
  if (Hkv <= 0 || Hq % Hkv || tc::d96::BM % (Hq / Hkv) || n_pages <= 0)
    return -5;
  return tc::d96::launch(a, n_pages, part_tiles, n_blocks,
                         static_cast<int*>(sched),
                         static_cast<float*>(scratch));
}

extern "C" const char* paged_chunk_attention_error_string(int code) {
  switch (code) {
    case -1: return "unsupported head dim (16, 96 or 128; 96 or 128 on the "
                    "tensor cores)";
    case -2: return "unsupported KV dtype";
    case -3: return "unsupported query dtype";
    case -4: return "tensor map encoding failed (alignment, or no "
                    "cuTensorMapEncodeTiled in the driver)";
    case -5: return "unsupported shape (the group Hq / Hkv must divide 128; "
                    "heads, batch or pages; the D 96 instance's grid, "
                    "counters or scratch)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
