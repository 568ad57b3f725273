// Scaled fp8-e4m3 matmul with fp32 accumulation (Hopper).
//
// Replaces the JAX reference's TPU kernel
// kernels/fp8_matmul/kernel.py::fp8_matmul_pallas (body _kernel).  It
// computes the same function:
//     out[m, n] = (sum_k x_q[m, k] * w_q[k, n]) * sx[m] * sw[n]
// for x_q [M,K] and w_q [K,N] in float8_e4m3fn (row-major), sx [M,1]
// and sw [1,N] in fp32, summed in fp32 with both scales folded in once,
// at the end, and written in fp32 or bf16.  The TPU kernel asserts that
// M, N and K divide its 128-blocks; here any M, N, K are taken: tiles
// past an edge load zeros and their outputs are not written.
//
// Design.  A classic CUDA-core GEMM: a block owns a 128 x 128 tile of
// the output, 256 threads each hold an 8 x 8 fp32 accumulator in
// registers, and the K loop stages 32-deep slices of x_q and w_q in
// shared memory, decoded from e4m3 to fp32 on the way in (16-byte
// global loads where K, N are multiples of 16, bytes otherwise), with
// x_q's slice transposed so each thread reads its 8 rows and 8 columns
// as two float4s each.  Every product of two e4m3 values is exact in
// fp32, and every partial sum stays in fp32 FMAs: Hopper's fp8 tensor
// cores keep fewer bits than fp32 while they accumulate, and a kernel
// on them would have to promote its partial sums into fp32 registers
// every 128 of K to match an fp32-summed reference this closely.
//
// Bound at the main path's shape (minitron-8b's FFN up-projection over
// one 32,768-token prompt: M 32768, K 4096, N 16384): 2MNK = 4.40 TFLOP,
// 2.22 ms at the H100's 1,979 TFLOP/s dense fp8 rate (the 2.35 GB it
// moves take 0.70 ms), so it is compute-bound.  This design runs on the
// fp32 CUDA cores (67 TFLOP/s peak): at least 66 ms, 30x its bound.
// What it leaves on the table is the tensor cores (wgmma on e4m3 tiles
// fed by TMA, with the fp32 promotion above): work for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;      // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ float fp8(uint8_t byte) {
  __nv_fp8_e4m3 v;
  v.__x = byte;
  return static_cast<float>(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename OT>
__global__ void __launch_bounds__(THREADS)
fp8_matmul_kernel(const uint8_t* __restrict__ xq,
                  const uint8_t* __restrict__ wq,
                  const float* __restrict__ sx,
                  const float* __restrict__ sw, OT* __restrict__ out,
                  int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM];    // x_q slice, k-major
  __shared__ __align__(16) float Bs[BK][BN];    // w_q slice

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const bool vec_x = (K % 16) == 0;
  const bool vec_w = (N % 16) == 0;

  // staging assignment: 16 bytes of each slice per thread
  const int ar = tid >> 1, ac = (tid & 1) * 16;      // x_q: row, k
  const int bk = tid >> 3, bc = (tid & 7) * 16;      // w_q: k, column

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int64_t gm = m0 + ar;
      const int gk = k0 + ac;
      alignas(16) uint8_t b[16];
      if (vec_x && gm < M && gk < K) {
        *reinterpret_cast<uint4*>(b) =
            *reinterpret_cast<const uint4*>(xq + gm * K + gk);
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c)
          b[c] = (gm < M && gk + c < K) ? xq[gm * K + gk + c] : 0;
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) As[ac + c][ar] = fp8(b[c]);
    }
    {
      const int gk = k0 + bk;
      const int64_t gn = n0 + bc;
      alignas(16) uint8_t b[16];
      if (vec_w && gk < K && gn < N) {
        *reinterpret_cast<uint4*>(b) = *reinterpret_cast<const uint4*>(
            wq + static_cast<int64_t>(gk) * N + gn);
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c)
          b[c] = (gk < K && gn + c < N)
                     ? wq[static_cast<int64_t>(gk) * N + gn + c] : 0;
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) Bs[bk][bc + c] = fp8(b[c]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  // both scales folded in once, in the reference's order: (acc*sx)*sw
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gm = m0 + ty * 8 + i;
    if (gm >= M) continue;
    const float s = sx[gm];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t gn = n0 + tx * 8 + j;
      if (gn < N) store(out + gm * N + gn, acc[i][j] * s * sw[gn]);
    }
  }
}

template <typename OT>
int launch(const uint8_t* xq, const uint8_t* wq, const float* sx,
           const float* sw, void* out, int M, int N, int K,
           cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fp8_matmul_kernel<OT><<<grid, THREADS, 0, stream>>>(
      xq, wq, sx, sw, static_cast<OT*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out dtype codes: 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t
// code, or -1 for an unsupported out dtype / -2 for a grid too large.
// Launches on `stream`; never synchronises.
extern "C" int fp8_matmul_launch(const void* x_q, const void* w_q,
                                 const void* sx, const void* sw, void* out,
                                 int M, int N, int K, int out_dtype,
                                 void* stream) {
  if (M == 0 || N == 0) return 0;
  if ((M + BM - 1) / BM > 65535) return -2;
  const uint8_t* xq = static_cast<const uint8_t*>(x_q);
  const uint8_t* wq = static_cast<const uint8_t*>(w_q);
  const float* sxf = static_cast<const float*>(sx);
  const float* swf = static_cast<const float*>(sw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return launch<float>(xq, wq, sxf, swf, out, M, N, K, st);
    case 1: return launch<__nv_bfloat16>(xq, wq, sxf, swf, out, M, N, K, st);
  }
  return -1;
}

extern "C" const char* fp8_matmul_error_string(int code) {
  switch (code) {
    case -1: return "unsupported out dtype (float32 or bfloat16)";
    case -2: return "M too large for the grid (at most 65535 x 128 rows)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
