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
// dtype.  As in the TPU kernel, q (fp32 or bf16) and the pages (fp32,
// bf16 or fp8-e4m3, either with either q) are widened to fp32, whatever
// their dtypes.  Tokens at or past lengths[b] are never read, and neither is
// the block-table entry of a page wholly past it.  A row with
// lengths[b] == 0 gives 0, as the TPU kernel does (l == 0 -> 1).
//
// Design.  The TPU kernel walks the pages of one (b, h) in order on its
// grid's last axis and carries the online softmax in VMEM.  Here one
// block of four warps owns (b, h, a group of up to GT query rows); the
// warps take interleaved steps of tokens, each its own online softmax,
// and merge their (m, l, acc) through shared memory at the end.  Within
// a warp, LPT = D/8 lanes share a token: each lane loads 8 consecutive
// elements of the token's K and V row (16 bytes in bf16, 8 in e4m3,
// widened to fp32 in registers), holds the GT
// query rows' matching 8 elements in registers, and the dot products
// are summed across the LPT lanes with shuffles; the TPW = 32/LPT
// tokens of a pass sit on the warp's lane groups, and a warp step is
// ITER passes, whose loads are all issued before the arithmetic.  The
// K/V tile is thus shared by every query row of the KV head (GQA) and
// never staged in shared memory.  Softmax and accumulation are fp32.
//
// Bound at the main path's shape (minitron-8b decode_32k: B = 128,
// Hq = 32, Hkv = 8, D = 128, bf16, 32,768 tokens of context): each
// (b, h) reads 2 x 32768 x 128 x 2 bytes of K and V for 4 x 4 x 32768 x
// 128 FLOPs, 2 FLOP/byte, far below the H100's ~295 FLOP/byte ridge, so
// the kernel is memory-bound: 17.2 GB of visible K/V is 5.1 ms at 3.35
// TB/s.  The design issues 16-byte loads only, keeps several in flight
// per lane, and has 1024 blocks at that shape for 132 SMs; what it
// leaves on the table is a split of long sequences over more blocks
// (flash-decoding) when B x Hkv is small, and TMA-fed K/V rings.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

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

extern "C" const char* paged_decode_attention_error_string(int code) {
  switch (code) {
    case -1: return "unsupported head dim (16, 32, 64 or 128)";
    case -2: return "unsupported dtype (q float32 or bfloat16; pages "
                    "float32, bfloat16 or float8_e4m3fn)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
