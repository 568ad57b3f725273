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
//            granularity (not this kernel's 64-wide tiles).
// Masked probabilities are set to 0 explicitly (the Pallas body relies
// on exp(NEG_INF - m) and a later real maximum; here a row that sees
// nothing keeps l = 0 and returns 0, as the reference's mha does).
//
// Design.  The TPU grid walks (b, h, q block, kv block) in order and
// carries m/l/acc in VMEM across the kv axis.  Here the grid is
// (ceil(Sq/64), Hq, B): a block owns 64 queries of one head and loops
// over Skv in tiles of 64 keys inside the block, so the online softmax
// needs no cross-block pass.  The lengths are ragged on the serving
// path (Sq = 2640, Skv = 77 + w*2640 + 2640): tails are masked, and the
// loop stops at the last key any of the block's queries can see.  A
// K/V tile in which every (query, key) pair is masked (causal, outside
// window and sink, or rho-dropped for all of the block's query blocks)
// is skipped without loading it.  K/V tiles are staged in shared memory
// as fp32 (bf16 widened on load), scores and P.V are fp32 FMAs on a 4x4
// register tile per thread, the row-wise softmax reduces across a
// half-warp with shuffles, and the accumulator stays in registers.
//
// Bound at the serving path's deepest shape (ardit-self-forcing, B = 1,
// Sq = 2640, Hq = Hkv = 12, D = 128, Skv = 21,197, bf16): 4*Sq*Skv*D*Hq
// = 343.8 GFLOP against ~0.15 GB of q/k/v/out, i.e. ~2,300 FLOP/byte,
// far above the H100's ~295 bf16 FLOP/byte ridge: operations-bound,
// 0.348 ms at the 989 TFLOP/s bf16 tensor-core peak.  This simple design
// runs on the fp32 CUDA cores (67 TFLOP/s peak), re-reads Q from shared
// memory for every tile, widens K/V to fp32 in shared memory and issues
// synchronous loads: expect ~50x its bound.  wgmma on bf16 tiles with
// TMA-fed K/V rings is work for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
                 T* __restrict__ out, Params p) {
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

  // ---- finalize: acc / l, rows that see nothing give 0 -------------------
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= p.Sq) continue;
    const float inv = l_i[r] == 0.f ? 0.f : 1.f / l_i[r];
    const int64_t row = (static_cast<int64_t>(b) * p.Sq + i) * p.Hq + h;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(out + row * D + tx + 16 * c, acc[r][c] * inv);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v,
           const int32_t* keep, void* out, int B, const Params& p,
           cudaStream_t stream) {
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
      static_cast<const T*>(v), keep, static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_t(const void* q, const void* k, const void* v,
             const int32_t* keep, void* out, int B, const Params& p,
             int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch<D, float>(q, k, v, keep, out, B, p, stream);
    case 1: return launch<D, __nv_bfloat16>(q, k, v, keep, out, B, p,
                                            stream);
  }
  return -2;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
// keep: null, or int32 [Sq/block_q, n_kv_blocks] with n_kv_blocks =
// Skv/block_kv.  Returns 0, a cudaError_t code, or -1 / -2 / -3 for an
// unsupported head dim / dtype / shape.  Launches on `stream`; never
// synchronises.
extern "C" int flash_mha_launch(
    const void* q, const void* k, const void* v, const void* keep,
    void* out, int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
    int q_offset, int window, int sink, int block_q, int block_kv,
    int n_kv_blocks, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 ||
      (keep != nullptr && (block_q <= 0 || block_kv <= 0)))
    return -3;
  Params p{Sq, Skv, Hq, Hkv, causal, q_offset, window, sink, block_q,
           block_kv, n_kv_blocks, 1.0f / sqrtf(static_cast<float>(D))};
  const int32_t* kp = static_cast<const int32_t*>(keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_t<16>(q, k, v, kp, out, B, p, dtype, s);
    case 96: return launch_t<96>(q, k, v, kp, out, B, p, dtype, s);
    case 128: return launch_t<128>(q, k, v, kp, out, B, p, dtype, s);
  }
  return -1;
}

extern "C" const char* flash_mha_error_string(int code) {
  switch (code) {
    case -1: return "unsupported head dim (16, 96 or 128)";
    case -2: return "unsupported dtype (float32 or bfloat16)";
    case -3: return "unsupported shape (heads, batch or keep blocks)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
