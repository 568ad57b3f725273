// Backward of the flash-attention kernel (Hopper, CUDA cores).
//
// The JAX reference trains attention through its jnp mha and gives the
// TPU kernel kernels/flash_attention/kernel.py::flash_mha_pallas no VJP;
// the port's mha sends every CUDA tensor to flash_mha.cu, so training on
// the card needs this gradient.  It computes, for the function of
// flash_mha.cu in every mode (causal with q_offset, sink + window, the
// rho keep matrix, non-causal; GQA), dq, dk and dv from q, k, v, the
// forward's output o, its fp32 log-sum-exp lse [B,Hq,Sq] and dout, with
// FlashAttention-2's recompute formulas (s = q.k * scale):
//   delta_i = sum_d dout_i,d o_i,d
//   P_ij    = exp(s_ij - lse_i) where key j is visible to query i, else 0
//   dV_j    = sum_i P_ij dout_i            dP_ij = dout_i . v_j
//   dS_ij   = P_ij (dP_ij - delta_i)
//   dQ_i    = scale sum_j dS_ij k_j        dK_j  = scale sum_i dS_ij q_i
// The G query heads of a KV head sum into its dK and dV.  A row that
// sees nothing has lse = -inf and contributes nothing.  Visibility is
// flash_mha.cu's predicate, the same function.
//
// Three launches, no atomics, so two calls give the same bits:
// 1. delta: one warp per (b, i, h) row.
// 2. dK/dV: one block per (b, KV head, 64-key tile).  K and V of the
//    tile stay in shared memory; the block loops over the group's G
//    query heads and over the 64-query tiles that see any of its keys
//    (causal: from the tile's first key on; window: up to its last key
//    plus the window; rho: kept block pairs only), recomputing P^T and
//    dP^T on a 4x4 register tile per thread, then dV += P^T dout and
//    dK += dS^T q through shared memory.  dK and dV stay in registers.
// 3. dQ: one block per (b, query head, 64-query tile), looping over the
//    visible key tiles as the forward does: S and dP again, then
//    dQ += dS k.
// Everything is fp32 on the CUDA cores (bf16 inputs widened on load,
// outputs rounded once at the store); the tensor cores are later work.
//
// Bound: 10 x (visible pairs) x D operations (the five products over the
// visible pairs: S, dP, dV, dQ, dK; this kernel issues seven, as it
// recomputes S and dP in the dQ pass) at the bf16 tensor-core peak; at
// minicpm-2b's training attention (B 2, S 4,096 causal, 36 heads of 64)
// that is 386.6 GFLOP, 0.391 ms.  fp32 FMAs on the CUDA cores top out
// at 67 TFLOP/s, so this first form runs far above that bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <math.h>

namespace {

constexpr int BM = 64;          // queries per tile
constexpr int BN = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16 threads, 4x4 of a 64x64 tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Params {
  int Sq, Skv, Hq, Hkv, causal, q_offset, window, sink;
  int block_q, block_kv, n_kv_blocks;
  float scale;
};

// flash_mha.cu's predicate: whether query i (row of q) sees key j.
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

// Whether every (query, key) pair of the 64 x 64 tile at (i0, t0) is
// visible: such a tile skips the per-element test.
__device__ __forceinline__ bool tile_full(const Params& p,
                                          const int32_t* keep, int i0,
                                          int t0) {
  const int i1 = i0 + BM - 1, t1 = t0 + BN - 1;
  if (keep != nullptr || i1 >= p.Sq || t1 >= p.Skv) return false;
  if (!p.causal) return true;
  if (p.q_offset + i0 < t1) return false;
  return !p.window || t0 > p.q_offset + i1 - p.window || t1 < p.sink;
}

// Whether queries [i0, i1] and keys [t0, t1] hold any visible pair (the
// tile-level tests of the forward: causal edge, window, keep matrix).
__device__ bool tile_live(const Params& p, const int32_t* __restrict__ keep,
                          int i0, int i1, int t0, int t1) {
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

// rows [r0, r0 + 64) of a [B, S, H, D] tensor's head h into fp32 shared
// memory with row stride D + 1, zeros past S
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int b, int r0, int S, int H, int h) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int row = idx / D, c = idx % D;
    const int r = r0 + row;
    float val = 0.f;
    if (r < S)
      val = to_f32(src[((static_cast<int64_t>(b) * S + r) * H + h) * D + c]);
    dst[row * (D + 1) + c] = val;
  }
}

// ---- 1. delta = rowsum(dout * o) -------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int B, Params p) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (THREADS / 32)
                      + threadIdx.x / 32;          // (b * Sq + i) * Hq + h
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(B) * p.Sq * p.Hq) return;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc += to_f32(o[row * D + c]) * to_f32(dout[row * D + c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % p.Hq);
    const int64_t bi = row / p.Hq;
    const int i = static_cast<int>(bi % p.Sq);
    const int b = static_cast<int>(bi / p.Sq);
    delta[(static_cast<int64_t>(b) * p.Hq + h) * p.Sq + i] = acc;
  }
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // four 64-row tiles of stride D + 1, one 64 x 65 product tile, lse and
  // delta of 64 rows
  return sizeof(float) * (4 * 64 * (D + 1) + 64 * 65 + 2 * 64);
}

// ---- 2. dK, dV: one block per (b, KV head, key tile) -----------------------

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int32_t* __restrict__ keep, T* __restrict__ dk,
                T* __restrict__ dv, Params p) {
  constexpr int RS = D + 1;        // row stride of the staged tiles
  constexpr int PS = BM + 1;       // row stride of the product tile
  constexpr int DC = D / 16;       // head-dim columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                // [BN][RS]
  float* Vs = Ks + BN * RS;        // [BN][RS]
  float* Qs = Vs + BN * RS;        // [BM][RS]
  float* dOs = Qs + BM * RS;       // [BM][RS]
  float* Ps = dOs + BM * RS;       // [BN][PS]: P^T, then dS^T
  float* lse_s = Ps + BN * PS;     // [BM]
  float* delta_s = lse_s + BM;     // [BM]

  const int t0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int tid = threadIdx.x;
  const int ty = tid / 16;         // key rows ty + 16 r
  const int tx = tid % 16;         // query / head-dim columns tx + 16 c
  const int t1 = min(t0 + BN, p.Skv) - 1;

  load_rows<D>(Ks, k, b, t0, p.Skv, p.Hkv, hk);
  load_rows<D>(Vs, v, b, t0, p.Skv, p.Hkv, hk);

  // the query range that can see the tile's keys
  int i_begin = 0, i_end = p.Sq;
  if (p.causal) {
    i_begin = max(0, t0 - p.q_offset) / BM * BM;
    if (p.window && t0 >= p.sink)
      i_end = max(0, min(i_end, t1 + p.window - p.q_offset));
  }

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int i0 = i_begin; i0 < i_end; i0 += BM) {
      const int i1 = min(i0 + BM, p.Sq) - 1;
      if (!tile_live(p, keep, i0, i1, t0, t1)) continue;
      __syncthreads();             // the previous tile's readers are done
      load_rows<D>(Qs, q, b, i0, p.Sq, p.Hq, h);
      load_rows<D>(dOs, dout, b, i0, p.Sq, p.Hq, h);
      if (tid < BM) {
        const int i = i0 + tid;
        const int64_t r = (static_cast<int64_t>(b) * p.Hq + h) * p.Sq + i;
        lse_s[tid] = i < p.Sq ? lse[r] : -INFINITY;
        delta_s[tid] = i < p.Sq ? delta[r] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T on the thread's 4 keys x 4 queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kr[4], vr[4], qc[4], oc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          kr[r] = Ks[(ty + 16 * r) * RS + d];
          vr[r] = Vs[(ty + 16 * r) * RS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qc[j] = Qs[(tx + 16 * j) * RS + d];
          oc[j] = dOs[(tx + 16 * j) * RS + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[r][j] = fmaf(kr[r], qc[j], s[r][j]);
            dp[r][j] = fmaf(vr[r], oc[j], dp[r][j]);
          }
      }
      const bool full = tile_full(p, keep, i0, t0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx + 16 * j;
        const float l = lse_s[qi];
        const float dl = delta_s[qi];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bool vis = l != -INFINITY &&
                           (full || visible(p, keep, i0 + qi, t0 + ty + 16 * r));
          const float pr = vis ? expf(fmaf(s[r][j], p.scale, -l)) : 0.f;
          s[r][j] = pr;                            // P^T
          dp[r][j] = pr * (dp[r][j] - dl);         // dS^T
        }
      }

      // dV += P^T dO
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty + 16 * r) * PS + tx + 16 * j] = s[r][j];
      __syncthreads();
#pragma unroll 4
      for (int qi = 0; qi < BM; ++qi) {
        float pr[4], oc[DC];
#pragma unroll
        for (int r = 0; r < 4; ++r) pr[r] = Ps[(ty + 16 * r) * PS + qi];
#pragma unroll
        for (int c = 0; c < DC; ++c) oc[c] = dOs[qi * RS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            dv_acc[r][c] = fmaf(pr[r], oc[c], dv_acc[r][c]);
      }
      __syncthreads();

      // dK += dS^T Q (scaled once at the store)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty + 16 * r) * PS + tx + 16 * j] = dp[r][j];
      __syncthreads();
#pragma unroll 4
      for (int qi = 0; qi < BM; ++qi) {
        float sr[4], qc[DC];
#pragma unroll
        for (int r = 0; r < 4; ++r) sr[r] = Ps[(ty + 16 * r) * PS + qi];
#pragma unroll
        for (int c = 0; c < DC; ++c) qc[c] = Qs[qi * RS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            dk_acc[r][c] = fmaf(sr[r], qc[c], dk_acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + ty + 16 * r;
    if (t >= p.Skv) continue;
    const int64_t row = ((static_cast<int64_t>(b) * p.Skv + t) * p.Hkv + hk);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store(dk + row * D + tx + 16 * c, dk_acc[r][c] * p.scale);
      store(dv + row * D + tx + 16 * c, dv_acc[r][c]);
    }
  }
}

// ---- 3. dQ: one block per (b, query head, query tile) ----------------------

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int32_t* __restrict__ keep, T* __restrict__ dq,
              Params p) {
  constexpr int RS = D + 1;
  constexpr int PS = BN + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                // [BM][RS]
  float* dOs = Qs + BM * RS;       // [BM][RS]
  float* Ks = dOs + BM * RS;       // [BN][RS]
  float* Vs = Ks + BN * RS;        // [BN][RS]
  float* Ps = Vs + BN * RS;        // [BM][PS]: dS
  float* lse_s = Ps + BM * PS;     // [BM]
  float* delta_s = lse_s + BM;     // [BM]

  const int i0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;         // query rows ty + 16 r
  const int tx = tid % 16;         // key / head-dim columns tx + 16 c
  const int i1 = min(i0 + BM, p.Sq) - 1;

  load_rows<D>(Qs, q, b, i0, p.Sq, p.Hq, h);
  load_rows<D>(dOs, dout, b, i0, p.Sq, p.Hq, h);
  if (tid < BM) {
    const int i = i0 + tid;
    const int64_t r = (static_cast<int64_t>(b) * p.Hq + h) * p.Sq + i;
    lse_s[tid] = i < p.Sq ? lse[r] : -INFINITY;
    delta_s[tid] = i < p.Sq ? delta[r] : 0.f;
  }

  int kv_end = p.Skv;
  if (p.causal) kv_end = min(kv_end, p.q_offset + i1 + 1);

  float dq_acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[r][c] = 0.f;

  for (int t0 = 0; t0 < kv_end; t0 += BN) {
    const int t1 = min(t0 + BN, p.Skv) - 1;
    if (!tile_live(p, keep, i0, i1, t0, t1)) continue;
    __syncthreads();               // the previous tile's readers are done
    load_rows<D>(Ks, k, b, t0, p.Skv, p.Hkv, hk);
    load_rows<D>(Vs, v, b, t0, p.Skv, p.Hkv, hk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[4], orow[4], kc[4], vc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qr[r] = Qs[(ty + 16 * r) * RS + d];
        orow[r] = dOs[(ty + 16 * r) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j] = Ks[(tx + 16 * j) * RS + d];
        vc[j] = Vs[(tx + 16 * j) * RS + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = fmaf(qr[r], kc[j], s[r][j]);
          dp[r][j] = fmaf(orow[r], vc[j], dp[r][j]);
        }
    }
    const bool full = tile_full(p, keep, i0, t0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = ty + 16 * r;
      const float l = lse_s[qi];
      const float dl = delta_s[qi];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = l != -INFINITY &&
                         (full || visible(p, keep, i0 + qi, t0 + tx + 16 * j));
        const float pr = vis ? expf(fmaf(s[r][j], p.scale, -l)) : 0.f;
        Ps[qi * PS + tx + 16 * j] = pr * (dp[r][j] - dl);
      }
    }
    __syncthreads();
    // dQ += dS K (scaled once at the store)
#pragma unroll 4
    for (int kj = 0; kj < BN; ++kj) {
      float sr[4], kc[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) sr[r] = Ps[(ty + 16 * r) * PS + kj];
#pragma unroll
      for (int c = 0; c < DC; ++c) kc[c] = Ks[kj * RS + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c)
          dq_acc[r][c] = fmaf(sr[r], kc[c], dq_acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= p.Sq) continue;
    const int64_t row = (static_cast<int64_t>(b) * p.Sq + i) * p.Hq + h;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(dq + row * D + tx + 16 * c, dq_acc[r][c] * p.scale);
  }
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, const int32_t* keep,
           float* delta, void* dq, void* dk, void* dv, int B,
           const Params& p, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  constexpr size_t smem = smem_bytes<D>();
  int e;
  if ((e = set_smem(bwd_dkdv_kernel<D, T>, smem)) != 0) return e;
  if ((e = set_smem(bwd_dq_kernel<D, T>, smem)) != 0) return e;
  const int64_t rows = static_cast<int64_t>(B) * p.Sq * p.Hq;
  if (rows > 0) {
    const int64_t blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
    if (blocks > 2147483647LL) return -3;
    bwd_delta_kernel<D, T><<<static_cast<unsigned>(blocks), THREADS, 0,
                             stream>>>(static_cast<const T*>(o), do_, delta,
                                       B, p);
    if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  }
  if (p.Skv > 0) {
    dim3 grid((p.Skv + BN - 1) / BN, p.Hkv, B);
    bwd_dkdv_kernel<D, T><<<grid, THREADS, smem, stream>>>(
        q_, k_, v_, do_, lse, delta, keep, static_cast<T*>(dk),
        static_cast<T*>(dv), p);
    if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  }
  if (p.Sq > 0) {
    dim3 grid((p.Sq + BM - 1) / BM, p.Hq, B);
    bwd_dq_kernel<D, T><<<grid, THREADS, smem, stream>>>(
        q_, k_, v_, do_, lse, delta, keep, static_cast<T*>(dq), p);
    if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  }
  return 0;
}

template <int D>
int launch_t(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, const int32_t* keep,
             float* delta, void* dq, void* dk, void* dv, int B,
             const Params& p, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch<D, float>(q, k, v, o, dout, lse, keep, delta, dq,
                                    dk, dv, B, p, s);
    case 1: return launch<D, __nv_bfloat16>(q, k, v, o, dout, lse, keep,
                                            delta, dq, dk, dv, B, p, s);
  }
  return -2;
}

}  // namespace

// q, o, dout, dq [B,Sq,Hq,D]; k, v, dk, dv [B,Skv,Hkv,D], all of one
// dtype (0 = float32, 1 = bfloat16) and contiguous; lse and the scratch
// delta fp32 [B,Hq,Sq]; keep null or int32 [Sq/block_q, n_kv_blocks], as
// flash_mha_launch takes it.  Three launches on `stream` (delta, dK/dV,
// dQ); every element of dq, dk and dv is written.  Returns 0, a
// cudaError_t code, or -1 / -2 / -3 for an unsupported head dim / dtype /
// shape.  Never synchronises.
extern "C" int flash_mha_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* keep, void* delta,
    void* dq, void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
    int D, int causal, int q_offset, int window, int sink, int block_q,
    int block_kv, int n_kv_blocks, int dtype, void* stream) {
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 ||
      (keep != nullptr && (block_q <= 0 || block_kv <= 0)))
    return -3;
  Params p{Sq, Skv, Hq, Hkv, causal, q_offset, window, sink, block_q,
           block_kv, n_kv_blocks, 1.0f / sqrtf(static_cast<float>(D))};
  const float* l = static_cast<const float*>(lse);
  const int32_t* kp = static_cast<const int32_t*>(keep);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_t<16>(q, k, v, o, dout, l, kp, dl, dq, dk, dv, B,
                                 p, dtype, s);
    case 64: return launch_t<64>(q, k, v, o, dout, l, kp, dl, dq, dk, dv, B,
                                 p, dtype, s);
    case 96: return launch_t<96>(q, k, v, o, dout, l, kp, dl, dq, dk, dv, B,
                                 p, dtype, s);
    case 128: return launch_t<128>(q, k, v, o, dout, l, kp, dl, dq, dk, dv,
                                   B, p, dtype, s);
  }
  return -1;
}

extern "C" const char* flash_mha_bwd_error_string(int code) {
  switch (code) {
    case -1: return "unsupported head dim (16, 64, 96 or 128)";
    case -2: return "unsupported dtype (float32 or bfloat16)";
    case -3: return "unsupported shape (heads, batch or keep blocks)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
