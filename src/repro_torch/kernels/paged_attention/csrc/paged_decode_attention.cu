// One-token decode attention over the paged KV pool (Hopper).
//
// Replaces the JAX reference's TPU kernel
// kernels/paged_attention/kernel.py::paged_decode_attention_pallas
// (body _kernel).  It computes the same function: for every batch row b
// and KV head h the G = Hq / Hkv query rows of q [B,Hq,D] attend to the
// first lengths[b] tokens of the logical sequence whose pages are named
// by block_table[b, :] in the pool k/v [P,page,Hkv,D] (token t lives in
// page block_table[b, t / page] at offset t % page), and the kernel
// writes the finalised softmax(q k^T / sqrt(D)) v as [B,Hq,D] in q's
// dtype.  q is fp32 or bf16 and the pages fp32, bf16 or fp8-e4m3, either
// with either q; the CUDA-core kernel widens all to fp32, as the TPU
// kernel does, and the tensor-core path multiplies bf16 (e4m3 widened to
// bf16 exactly) into fp32 and rounds P to bf16 before P V.  No token at
// or past lengths[b] is used (a page's tail may be read, never used),
// and no page wholly past it is read, nor its block-table entry.  A row
// with lengths[b] == 0 gives 0, as the TPU kernel does (l == 0 -> 1).
//
// Design.  The TPU kernel walks the pages of one (b, h) in order on its
// grid's last axis and carries the online softmax in VMEM.  Two kernels
// share this file:
//   * the tensor-core path (paged_decode_mma_kernel, bf16 q over bf16 or
//     e4m3 pages at D 64 / 128 with G <= 8; described at its
//     definition): split over the sequence into units of up to 2,048
//     tokens, K/V by TMA through the page table, mma.sync with the tokens
//     as M, and a combine launch;
//   * the CUDA-core kernel (fp32 q or pages, and the other head dims):
//     one block of four warps owns (b, h, a group of up to GT query
//     rows); the warps take interleaved steps of tokens, each its own
//     online softmax, and merge their (m, l, acc) through shared memory
//     at the end.  Within a warp, LPT = D/8 lanes share a token: each lane
//     loads 8 consecutive elements of the token's K and V row (16 bytes
//     in bf16, 8 in e4m3, widened to fp32 in registers), holds the GT
//     query rows' matching 8 elements in registers, and the dot products
//     are summed across the LPT lanes with shuffles; the TPW = 32/LPT
//     tokens of a pass sit on the warp's lane groups, and a warp step is
//     ITER passes, whose loads are all issued before the arithmetic.
//     Softmax and accumulation are fp32.
//
// Bound at the main path's shape (minitron-8b decode_32k: B = 128,
// Hq = 32, Hkv = 8, D = 128, bf16, 32,768 tokens of context): each
// (b, h) reads 2 x 32768 x 128 x 2 bytes of K and V for 4 x 4 x 32768 x
// 128 FLOPs, 2 FLOP/byte, far below the H100's ~295 FLOP/byte ridge, so
// the kernel is memory-bound: 17.2 GB of visible K/V is 5.1 ms at 3.35
// TB/s.  The CUDA-core kernel reaches about half of that rate: 16 lanes
// share a token, with shuffle reductions per query row and one exp per
// token and row, and one block per (b, h) leaves the longest streams
// alone at the end; the tensor-core path removes those three costs.

#include "hopper.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p,
                                      float (&o)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_fp8x2_e4m3* h = reinterpret_cast<const __nv_fp8x2_e4m3*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = static_cast<float2>(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D, int GT, typename QT, typename KT>
__global__ void __launch_bounds__(THREADS)
paged_decode_attention_kernel(const QT* __restrict__ q,
                              const KT* __restrict__ k_pages,
                              const KT* __restrict__ v_pages,
                              const int32_t* __restrict__ block_table,
                              const int32_t* __restrict__ lengths,
                              QT* __restrict__ out, int Hq, int Hkv,
                              int page, int n, float scale) {
  constexpr int LPT = D / 8;               // lanes per token
  constexpr int TPW = 32 / LPT;            // tokens per warp pass
  constexpr int ITER = GT >= 8 ? 1 : 8 / GT;
  constexpr int STEP = TPW * ITER;         // tokens per warp step

  __shared__ float sm_m[WARPS][GT];
  __shared__ float sm_l[WARPS][GT];
  __shared__ float sm_acc[WARPS][GT][D];

  const int G = Hq / Hkv;
  const int n_gc = (G + GT - 1) / GT;
  const int gc = blockIdx.x % n_gc;
  const int h = blockIdx.x / n_gc;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane / LPT;             // the lane's token of a pass
  const int dc = lane % LPT;               // its 8 elements: dc*8 ..
  const int g0 = gc * GT;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > n * page ? n * page : len);

  float qr[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g0 + g < G) {
      load8(q + (static_cast<int64_t>(b) * Hq + h * G + g0 + g) * D + dc * 8,
            qr[g]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) qr[g][j] = 0.f;
    }
  }
  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }

  const int64_t tok_stride = static_cast<int64_t>(Hkv) * D;
  const int32_t* row = block_table + static_cast<int64_t>(b) * n;
  // base < len is uniform across the warp, so every lane reaches every
  // shuffle; the token at (base, pass 0, slot 0) is valid in each step
  for (int base = warp * STEP; base < len; base += WARPS * STEP) {
    float kv[ITER][8], vv[ITER][8];
    bool ok[ITER];
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int t = base + it * TPW + slot;
      ok[it] = t < len;
      if (ok[it]) {
        const int64_t pid = row[t / page];
        const int64_t off = (pid * page + t % page) * tok_stride + h * D
                            + dc * 8;
        load8(k_pages + off, kv[it]);
        load8(v_pages + off, vv[it]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kv[it][j] = vv[it][j] = 0.f;
      }
    }
    float s[ITER][GT];
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) dot = fmaf(qr[g][j], kv[it][j], dot);
#pragma unroll
        for (int o = LPT / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[it][g] = ok[it] ? dot * scale : NEG_INF;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int it = 1; it < ITER; ++it) mx = fmaxf(mx, s[it][g]);
#pragma unroll
      for (int o = LPT; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] *= alpha;
#pragma unroll
      for (int it = 0; it < ITER; ++it) {
        const float p = ok[it] ? expf(s[it][g] - m_new) : 0.f;
        l[g] += p;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(p, vv[it][j], acc[g][j]);
      }
    }
  }

  // each lane summed its own token slot: add the slots up (m is uniform
  // across the warp), then merge the warps through shared memory
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int o = LPT; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sm_acc[warp][g][dc * 8 + j] = acc[g][j];
      if (dc == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GT * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    if (g0 + g >= G) continue;
    float mm = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w][g] - mm);
      ll += sm_l[w][g] * c;
      aa += sm_acc[w][g][d] * c;
    }
    ll = ll == 0.f ? 1.f : ll;
    store(out + (static_cast<int64_t>(b) * Hq + h * G + g0 + g) * D + d,
          aa / ll);
  }
}

struct Args {
  const void* q; const void* k; const void* v; const int32_t* bt;
  const int32_t* len; void* out;
  int B, Hq, Hkv, page, n;
  cudaStream_t stream;
};

template <int D, int GT, typename QT, typename KT>
int launch(const Args& a) {
  const int G = a.Hq / a.Hkv;
  dim3 grid(a.Hkv * ((G + GT - 1) / GT), a.B);
  paged_decode_attention_kernel<D, GT, QT, KT>
      <<<grid, THREADS, 0, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), a.bt, a.len, static_cast<QT*>(a.out),
      a.Hq, a.Hkv, a.page, a.n, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename QT, typename KT>
int launch_g(const Args& a) {
  const int G = a.Hq / a.Hkv;
  if (G <= 1) return launch<D, 1, QT, KT>(a);
  if (G <= 2) return launch<D, 2, QT, KT>(a);
  if (G <= 4) return launch<D, 4, QT, KT>(a);
  return launch<D, 8, QT, KT>(a);     // groups of 8 query rows per block
}

template <typename QT, typename KT>
int launch_d(const Args& a, int D) {
  switch (D) {
    case 16: return launch_g<16, QT, KT>(a);
    case 32: return launch_g<32, QT, KT>(a);
    case 64: return launch_g<64, QT, KT>(a);
    case 128: return launch_g<128, QT, KT>(a);
  }
  return -1;
}

template <typename QT>
int launch_kv(const Args& a, int D, int kv_dtype) {
  switch (kv_dtype) {
    case 0: return launch_d<QT, float>(a, D);
    case 1: return launch_d<QT, __nv_bfloat16>(a, D);
    case 2: return launch_d<QT, __nv_fp8_e4m3>(a, D);
  }
  return -2;
}

// ---- the tensor-core path: bf16 q over bf16 or e4m3 pages, D 64 / 128 ----
//
// Split over the sequence (flash-decoding): block (u, h, b) takes the
// unit of `unit` tokens [u * unit, (u + 1) * unit) of stream b's visible
// tokens for KV head h (a block whose unit starts at or past lengths[b]
// exits at once: the plan is the grid itself, made on the device from
// lengths, with no host sync) and writes fp32 partials (m, l, acc) of
// its G query rows; decode_combine_kernel merges a stream's units and
// writes the output in q's dtype.
// K/V by TMA through the page table: warp 0 stages the unit's entries
// of block_table[b, :] in shared memory, then one lane walks them and
// issues, per tile of TT = 32 tokens, one box per (page, KV head) and
// column half of K and of V through 4-D tensor maps over the pool into a
// ring of STAGES tiles (a box that starts at or past lengths[b] is not
// issued: no page wholly past a stream's length is read).
// Products on the tensor cores with the tokens as M (mma.sync
// m16n8k16): each consumer warp takes every fourth tile with its own
// online softmax; S^T = K q^T (A: 16 tokens x 16 of D from the K tile by
// ldmatrix, B: the G <= 8 query rows, padded to 8, held in registers),
// then O^T += V^T P^T (A: V transposed by ldmatrix.trans, B: P rounded
// to bf16 and moved into B's layout by movmatrix).  e4m3 pages are
// widened to bf16 (exact) in registers: ldmatrix moves bytes, so K's
// reduction index and V's output rows are permuted to what it delivers
// (q is loaded in the same permutation; the store undoes the other).
// Tokens at or past lengths[b] in a tile (a page's tail) get a score of
// -inf and their V entries are zeroed in registers, so garbage there
// (even NaN) is never used.  Softmax, m, l and acc stay in fp32; the
// warps merge through shared memory at the end.
namespace tc {

using namespace hopper;

constexpr int TT = 32;                   // tokens per tile
constexpr int STAGES = 4;
constexpr int CWARPS = 4;                // consumer warps (warps 1-4)
constexpr int TTHREADS = 32 * (CWARPS + 1);
constexpr int MAX_UNIT = 2048;           // tokens of a unit, at most
constexpr int MAX_ENTRIES = MAX_UNIT / 8 + 2;   // staged table entries
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D, bool KV8>
struct Geo {
  static constexpr int RB = D * (KV8 ? 1 : 2);       // bytes of a row
  static constexpr int NBOX = RB > 128 ? 2 : 1;      // column halves
  static constexpr int BOXW = RB / NBOX;             // 128 or 64 bytes
  static constexpr int TILE = TT * RB;               // K (or V) of a tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int MERGE = CWARPS * (16 + 8 * D) * 4;
  static constexpr int RING = STAGES * STAGE > MERGE ? STAGES * STAGE : MERGE;
  static constexpr size_t SMEM = 1024 + RING + MAX_ENTRIES * 4 +
                                 2 * STAGES * 8;
};

// byte offset of 16-byte chunk `ch` (of the whole row) of row `row` in a
// tile kept as NBOX column boxes of TT rows, each in the TMA swizzle of
// its row width (128 bytes: SW128; 64 bytes: SW64)
template <int D, bool KV8>
__device__ __forceinline__ int tile_off(int row, int ch) {
  using G = Geo<D, KV8>;
  constexpr int CPB = G::BOXW / 16;                  // chunks per box row
  const int box = ch / CPB, c = ch % CPB;
  const int sw = G::BOXW == 128 ? (row & 7) : ((row >> 1) & 3);
  return box * TT * G::BOXW + row * G::BOXW + ((c ^ sw) << 4);
}

struct TParams {
  const __nv_bfloat16* q;        // [B, Hq, D]
  const int32_t* table;          // [B, n]
  const int32_t* lengths;        // [B]
  float* m;                      // [B, Hq, U] (natural units)
  float* l;
  float* acc;                    // [B, Hq, U, D]
  int Hq, Hkv, page, n, unit, U;
  float scale_log2;
};

template <int D, bool KV8>
__global__ void __launch_bounds__(TTHREADS)
paged_decode_mma_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, TParams p) {
  using G = Geo<D, KV8>;
  const float NINF = __int_as_float(0xff800000);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int32_t* entries = reinterpret_cast<int32_t*>(ring + G::RING);
  uint64_t* full = reinterpret_cast<uint64_t*>(entries + MAX_ENTRIES);
  uint64_t* empty = full + STAGES;

  const int u = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  int len = p.lengths[b];
  len = len < 0 ? 0 : (len > p.n * p.page ? p.n * p.page : len);
  const int u0 = u * p.unit;
  if (u0 >= len) return;                   // nothing visible in this unit
  const int end = min(len, u0 + p.unit);
  const int ntiles = (end - u0 + TT - 1) / TT;
  const int e0 = u0 / p.page;
  const int ne = (end - 1) / p.page - e0 + 1;
  const int G8 = p.Hq / p.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  if (warp == 0)
    for (int e = lane; e < ne; e += 32)
      entries[e] = p.table[static_cast<int64_t>(b) * p.n + e0 + e];
  __syncthreads();

  if (warp == 0) {
    // the producer: one lane issues every box of every tile in order
    if (lane == 0) {
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      const int pb = p.page < TT ? p.page : TT;     // tokens per box
      const uint32_t box_bytes = pb * G::BOXW;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        const int t = u0 + i * TT;
        const int nb = (min(TT, end - t) + pb - 1) / pb;   // boxes issued
        mbar_arrive_expect_tx(&full[s], 2u * G::NBOX * nb * box_bytes);
        uint8_t* dk = ring + s * G::STAGE;
        for (int j = 0; j < nb; ++j) {
          const int tok = t + j * pb;
          const int pid = entries[tok / p.page - e0];
          const int off = tok % p.page;
#pragma unroll
          for (int x = 0; x < G::NBOX; ++x) {
            const int col = x * G::BOXW / (KV8 ? 1 : 2);
            uint8_t* at = dk + x * TT * G::BOXW + j * pb * G::BOXW;
            tma_load_4d(at, &tk, &full[s], col, h, off, pid);
            tma_load_4d(at + G::TILE, &tv, &full[s], col, h, off, pid);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warps 1-4 ----
  const int cw = warp - 1;
  const int c = lane % 4, g = lane / 4;
  // q^T as B fragments (k = D, n = the G query rows; rows >= G are 0),
  // in the reduction order the K fragments use
  uint32_t qb[D / 16][2];
  {
    const __nv_bfloat16* qr =
        p.q + (static_cast<int64_t>(b) * p.Hq + h * G8 + g) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int d0 = KV8 ? 16 * kk + 4 * c : 16 * kk + 2 * c;
      const int d1 = KV8 ? d0 + 2 : d0 + 8;
      qb[kk][0] = g < G8 ? *reinterpret_cast<const uint32_t*>(qr + d0) : 0u;
      qb[kk][1] = g < G8 ? *reinterpret_cast<const uint32_t*>(qr + d1) : 0u;
    }
  }
  float o[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  float m[2] = {NINF, NINF}, l[2] = {0.f, 0.f};
  const int mi = lane / 8, r8 = lane % 8;

  for (int i = cw; i < ntiles; i += CWARPS) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* sk = ring + s * G::STAGE;
    const uint8_t* sv = sk + G::TILE;
    const int valid = min(TT, end - (u0 + i * TT));

    // S^T = K q^T, two 16-token sub-tiles
    float sc[2][4];
#pragma unroll
    for (int st = 0; st < 2; ++st) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[st][e] = 0.f;
      const int row = 16 * st + (mi & 1) * 8 + r8;
      if constexpr (!KV8) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, sk + tile_off<D, KV8>(row, 2 * kk + (mi >> 1)));
          // a[0]: tokens 0-7 / D 0-7, a[1]: tokens 8-15, a[2]: D 8-15
          const uint32_t af[4] = {a[0], a[1], a[2], a[3]};
          mma_m16n8k16_bf16(sc[st], af, qb[kk][0], qb[kk][1]);
        }
      } else {
#pragma unroll
        for (int kp = 0; kp < D / 32; ++kp) {
          uint32_t a[4];
          ldmatrix_x4(a, sk + tile_off<D, KV8>(row, 2 * kp + (mi >> 1)));
          // a[0] / a[1]: tokens 0-7 / 8-15 of 16-byte chunk 2kp, a[2] /
          // a[3] of chunk 2kp + 1; each 4 bytes: D 4c .. 4c + 3
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const uint32_t lo = a[2 * x], hi = a[2 * x + 1];
            const uint32_t af[4] = {widen_e4m3x2(lo), widen_e4m3x2(hi),
                                    widen_e4m3x2(lo >> 16),
                                    widen_e4m3x2(hi >> 16)};
            mma_m16n8k16_bf16(sc[st], af, qb[2 * kp + x][0],
                              qb[2 * kp + x][1]);
          }
        }
      }
    }

    // online softmax per query column (log2 domain); hidden tokens -inf
    float mx[2] = {NINF, NINF};
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 16 * st + g + (e >= 2 ? 8 : 0);
        sc[st][e] = tok < valid ? sc[st][e] * p.scale_log2 : NINF;
        mx[e & 1] = fmaxf(mx[e & 1], sc[st][e]);
      }
    float alpha[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int o2 = 4; o2 < 32; o2 <<= 1)
        mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], o2));
      const float m_new = fmaxf(m[x], mx[x]);
      alpha[x] = exp2_approx(m[x] - m_new);
      m[x] = m_new;
      l[x] *= alpha[x];
    }
    uint32_t pb[2][2];
#pragma unroll
    for (int st = 0; st < 2; ++st) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[st][e] = exp2_approx(sc[st][e] - m[e & 1]);
        l[e & 1] += sc[st][e];
      }
      pb[st][0] = movmatrix_trans(pack_bf16(sc[st][0], sc[st][1]));
      pb[st][1] = movmatrix_trans(pack_bf16(sc[st][2], sc[st][3]));
    }
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][e] *= alpha[e & 1];

    // O^T += V^T P^T; V entries of hidden tokens zeroed in registers
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int t0 = 16 * st + 2 * c;
      const uint32_t mk0 = (t0 < valid ? 0xffffu : 0u) |
                           (t0 + 1 < valid ? 0xffff0000u : 0u);
      const uint32_t mk1 = (t0 + 8 < valid ? 0xffffu : 0u) |
                           (t0 + 9 < valid ? 0xffff0000u : 0u);
      if constexpr (!KV8) {
        const int row = 16 * st + (mi >= 2 ? 8 : 0) + r8;
#pragma unroll
        for (int mt = 0; mt < D / 16; ++mt) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, sv + tile_off<D, KV8>(row, 2 * mt + (mi & 1)));
          const uint32_t af[4] = {a[0] & mk0, a[1] & mk0, a[2] & mk1,
                                  a[3] & mk1};
          mma_m16n8k16_bf16(o[mt], af, pb[st][0], pb[st][1]);
        }
      } else {
        const int row = 16 * st + (mi & 1) * 8 + r8;
#pragma unroll
        for (int mp = 0; mp < D / 32; ++mp) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, sv + tile_off<D, KV8>(row, 2 * mp + (mi >> 1)));
          // a[2x] / a[2x+1]: tokens 0-7 / 8-15 of chunk 2mp + x; bytes
          // (token 2c, even D), (2c, odd), (2c+1, even), (2c+1, odd)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const uint32_t t07 = a[2 * x], t8f = a[2 * x + 1];
            const uint32_t af[4] = {
                widen_e4m3x2(__byte_perm(t07, 0, 0x20)) & mk0,
                widen_e4m3x2(__byte_perm(t07, 0, 0x31)) & mk0,
                widen_e4m3x2(__byte_perm(t8f, 0, 0x20)) & mk1,
                widen_e4m3x2(__byte_perm(t8f, 0, 0x31)) & mk1};
            mma_m16n8k16_bf16(o[2 * mp + x], af, pb[st][0], pb[st][1]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // l over the warp's lanes of a column; then the four warps merge
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int o2 = 4; o2 < 32; o2 <<= 1)
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], o2);
  named_sync(1, 32 * CWARPS);              // every tile consumed: reuse ring
  float* mw = reinterpret_cast<float*>(ring) + cw * (16 + 8 * D);
  float* lw = mw + 8;
  float* ow = mw + 16;
  if (g == 0) {
    mw[2 * c] = m[0];
    mw[2 * c + 1] = m[1];
    lw[2 * c] = l[0];
    lw[2 * c + 1] = l[1];
  }
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = KV8 ? 16 * mt + 2 * g + (e >> 1)
                        : 16 * mt + g + (e >= 2 ? 8 : 0);
      ow[(2 * c + (e & 1)) * D + d] = o[mt][e];
    }
  named_sync(1, 32 * CWARPS);
  const float* base = reinterpret_cast<const float*>(ring);
  for (int idx = tid - 32; idx < G8 * D; idx += 32 * CWARPS) {
    const int gg = idx / D, d = idx - gg * D;
    float mm = NINF;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) mm = fmaxf(mm, base[w * (16 + 8 * D) + gg]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) {
      const float* bw = base + w * (16 + 8 * D);
      const float f = exp2_approx(bw[gg] - mm);
      ll += bw[8 + gg] * f;
      aa += bw[16 + gg * D + d] * f;
    }
    const int64_t row = (static_cast<int64_t>(b) * p.Hq + h * G8 + gg) * p.U + u;
    p.acc[row * D + d] = aa;
    if (d == 0) {
      p.m[row] = mm * LN2;
      p.l[row] = ll;
    }
  }
}

// merges the units of each (b, query head): one block of D threads
template <int D, typename OT>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ acc,
                      const int32_t* __restrict__ lengths, OT* __restrict__ out,
                      int Hq, int cap, int unit, int U) {
  const float NINF = __int_as_float(0xff800000);
  const int row = blockIdx.x;                // b * Hq + query head
  const int b = row / Hq, d = threadIdx.x;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int nu = (len + unit - 1) / unit;
  const float* mr = m + static_cast<int64_t>(row) * U;
  const float* lr = l + static_cast<int64_t>(row) * U;
  const float* ar = acc + static_cast<int64_t>(row) * U * D + d;
  float mm = NINF;
  for (int x = 0; x < nu; ++x) mm = fmaxf(mm, mr[x]);
  float ll = 0.f, aa = 0.f;
  for (int x = 0; x < nu; ++x) {
    const float f = expf(mr[x] - mm);
    ll += lr[x] * f;
    aa += ar[static_cast<int64_t>(x) * D] * f;
  }
  store(out + static_cast<int64_t>(row) * D + d, aa / (ll == 0.f ? 1.f : ll));
}

// the pool [n_pages, page, Hkv, D] as a 4-D tensor map: boxes of one
// column half (BOXW bytes) x one KV head x min(page, TT) tokens x 1 page
template <int D, bool KV8>
int pool_map(CUtensorMap* map, const void* base, int Hkv, int page,
             int n_pages) {
  using G = Geo<D, KV8>;
  const cuuint64_t elt = KV8 ? 1 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(page),
                              static_cast<cuuint64_t>(n_pages)};
  const cuuint64_t strides[3] = {elt * D, elt * D * Hkv,
                                 elt * D * Hkv * page};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::BOXW / elt), 1,
                             static_cast<cuuint32_t>(page < TT ? page : TT),
                             1};
  return encode_tiled(map,
                      KV8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      4, base, dims, strides, box,
                      G::BOXW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int D, bool KV8>
int launch(const void* q, const void* k, const void* v, const int32_t* bt,
           const int32_t* lengths, void* out, float* pm, float* pl,
           float* pacc, int B, int Hq, int Hkv, int page, int n, int n_pages,
           int unit, cudaStream_t stream) {
  CUtensorMap tk, tv;
  if (pool_map<D, KV8>(&tk, k, Hkv, page, n_pages) ||
      pool_map<D, KV8>(&tv, v, Hkv, page, n_pages))
    return -4;
  const int U = (n * page + unit - 1) / unit;
  TParams p{static_cast<const __nv_bfloat16*>(q), bt, lengths, pm, pl, pacc,
            Hq, Hkv, page, n, unit, U,
            LOG2E / sqrtf(static_cast<float>(D))};
  auto kern = paged_decode_mma_kernel<D, KV8>;
  constexpr size_t smem = Geo<D, KV8>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(U, Hkv, B), TTHREADS, smem, stream>>>(tk, tv, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine_kernel<D, __nv_bfloat16><<<B * Hq, D, 0, stream>>>(
      pm, pl, pacc, lengths, static_cast<__nv_bfloat16*>(out), Hq, n * page,
      unit, U);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn (pages
// only).  q and the output share q_dtype; both pools have kv_dtype.
// Returns 0, a cudaError_t code, or -1 / -2 for an unsupported head dim
// / dtype.  Launches on `stream`; never synchronises.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* lengths, void* out, int B, int Hq,
    int Hkv, int D, int page, int n, int q_dtype, int kv_dtype,
    void* stream) {
  Args a{q, k_pages, v_pages, static_cast<const int32_t*>(block_table),
         static_cast<const int32_t*>(lengths), out, B, Hq, Hkv, page, n,
         static_cast<cudaStream_t>(stream)};
  if (B == 0 || Hq == 0) return 0;
  switch (q_dtype) {
    case 0: return launch_kv<float>(a, D, kv_dtype);
    case 1: return launch_kv<__nv_bfloat16>(a, D, kv_dtype);
  }
  return -2;
}

// The tensor-core path: q bf16 [B, Hq, D], pages bf16 (kv_dtype 1) or
// e4m3 (2) [n_pages, page, Hkv, D], D 64 or 128, G = Hq / Hkv <= 8,
// page 8, 16 or a multiple of 32, `unit` a multiple of 32 up to 2048
// tokens.  pm / pl (B*Hq*U floats) and pacc (B*Hq*U*D floats), U =
// ceil(n * page / unit), are the units' partials (scratch); out [B, Hq,
// D] bf16.  q and the pools must be 16-byte aligned.  Returns 0, a
// cudaError_t code, -1 / -2 for the head dim / dtype, -4 when a tensor
// map cannot be encoded, -5 for the shape.  Two launches (the units,
// then the combine) on `stream`; never synchronises.
extern "C" int paged_decode_attention_mma_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* lengths, void* out, void* pm,
    void* pl, void* pacc, int B, int Hq, int Hkv, int D, int page, int n,
    int n_pages, int kv_dtype, int unit, void* stream) {
  if (B == 0 || Hq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > 8 || B > 65535 || Hkv > 65535 ||
      n_pages <= 0 || n <= 0 || unit <= 0 || unit % tc::TT ||
      unit > tc::MAX_UNIT ||
      !(page == 8 || page == 16 || (page > 0 && page % tc::TT == 0)))
    return -5;
  const int32_t* bt = static_cast<const int32_t*>(block_table);
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  float* m = static_cast<float*>(pm);
  float* l = static_cast<float*>(pl);
  float* acc = static_cast<float*>(pacc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype != 1 && kv_dtype != 2) return -2;
  const bool kv8 = kv_dtype == 2;
  switch (D) {
    case 64:
      return kv8 ? tc::launch<64, true>(q, k_pages, v_pages, bt, ln, out, m,
                                        l, acc, B, Hq, Hkv, page, n, n_pages,
                                        unit, s)
                 : tc::launch<64, false>(q, k_pages, v_pages, bt, ln, out, m,
                                         l, acc, B, Hq, Hkv, page, n, n_pages,
                                         unit, s);
    case 128:
      return kv8 ? tc::launch<128, true>(q, k_pages, v_pages, bt, ln, out, m,
                                         l, acc, B, Hq, Hkv, page, n, n_pages,
                                         unit, s)
                 : tc::launch<128, false>(q, k_pages, v_pages, bt, ln, out, m,
                                          l, acc, B, Hq, Hkv, page, n,
                                          n_pages, unit, s);
  }
  return -1;
}

extern "C" const char* paged_decode_attention_error_string(int code) {
  switch (code) {
    case -1: return "unsupported head dim (16, 32, 64 or 128)";
    case -2: return "unsupported dtype (q float32 or bfloat16; pages "
                    "float32, bfloat16 or float8_e4m3fn)";
    case -4: return "tensor map encoding failed (alignment, or no "
                    "cuTensorMapEncodeTiled in the driver)";
    case -5: return "unsupported shape on the tensor cores (G <= 8, page "
                    "8, 16 or a multiple of 32, unit a multiple of 32 up "
                    "to 2048)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
