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
// Design.  The TPU kernel holds all R = Sq*G query rows of a (b, h) in
// one block with a [R, D] fp32 accumulator in VMEM (1.35 MB at full
// width), which fits neither shared memory nor registers and would give
// only B*Hkv blocks for 132 SMs.  Here the grid is (ceil(R/64), Hkv, B):
// a block owns 64 query rows, loops over the table entries (skipping
// invisible pages) and, within each page, over the valid extent in
// tiles of 64 tokens (the ragged tail of a 2640-token page is masked).
// K/V tiles are staged in shared memory as fp32 (bf16 / fp32 / fp8-e4m3
// converted on load), scores and P.V are fp32 FMAs on a 4x4 register
// tile per thread, the row-wise online softmax is reduced across a
// half-warp with shuffles, and the accumulator stays in registers.
// Offsets into the pool are 64-bit, and the pool is read through its
// page and token strides: a view pool[..., lo:hi, :] of a wider pool
// (elastic SP2's half-head shards) is read in place, with no copy; only
// the inner two dims (heads, D) must be dense.
//
// Bound at the main path's shapes (ardit-self-forcing, Sq = 2640,
// Hq = Hkv = 12, D = 128, page = 2640, bf16 pool, 7-chunk window:
// ctx = 77 + 7*2640 = 18557 visible tokens, B = 4): per (b, h) the
// kernel does 4*R*D*ctx FLOPs against ctx*D*2*2 bytes of K and V, i.e.
// R ~ 2,600 FLOP/byte, far above the H100's ~295 bf16 FLOP/byte ridge:
// it is compute-bound.  1.20 TFLOP per call is 1.22 ms at the 989
// TFLOP/s bf16 tensor-core peak (K/V traffic alone is 0.14 ms).  This
// simple design runs on the fp32 CUDA cores (67 TFLOP/s peak, so at
// least ~18 ms), re-reads Q from shared memory for every tile, doubles
// shared-memory traffic by widening K/V to fp32, issues synchronous
// loads that do not overlap compute, and fits two blocks per SM.  What
// it leaves on the table is wgmma on bf16 tiles with TMA-fed K/V rings
// and warp specialisation: work for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

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

extern "C" const char* paged_chunk_attention_error_string(int code) {
  switch (code) {
    case -1: return "unsupported head dim (16, 96 or 128)";
    case -2: return "unsupported KV dtype";
    case -3: return "unsupported query dtype";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
