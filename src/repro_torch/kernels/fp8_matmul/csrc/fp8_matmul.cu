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
// Bound at the main path's shape (minitron-8b's FFN up-projection over
// one 32,768-token prompt: M 32768, K 4096, N 16384): 2MNK = 4.40 TFLOP,
// 2.22 ms at the H100's 1,979 TFLOP/s dense fp8 rate (the 2.35 GB it
// moves take 0.70 ms), so it is compute-bound.
//
// Two kernels; the wrapper picks one by shape.
//
// K and N multiples of 16 (every model shape): fp8_matmul_wgmma, on the
// tensor cores.  w_q is first transposed to w_t [N,K] by a small kernel
// in the same call (fp8 wgmma takes B only K-major).  A block owns a
// 128 x 128 output tile: a producer warpgroup, of which one thread issues
// TMA, and two consumer warpgroups of 64 rows each (setmaxnreg moves the
// producer's registers to them).  128-byte K slices of x_q and w_t (one
// 128-byte swizzled row per output row or column) come through a 4-stage
// ring guarded by mbarriers; TMA writes zeros past M, N and K.  Each
// stage is four m64n128k32 e4m3 wgmmas, in chunks of two (64 of K) into
// two fp32 accumulators in turn, each chunk started from 0 and added
// into a third set of fp32 registers while the next one runs: the tensor
// cores keep only about 14 bits while they accumulate fp8 products
// (DeepSeek-V3 technical report, "Increasing Accumulation Precision"),
// and promoting the partial sums keeps the result near an fp32 sum.
// Every 64 of K, not every 128: with all-positive operands (truncation
// bias all one way) a 128-deep chain misses the limit the tests hold
// this kernel to, 5e-4 of max |out|; a 32-deep one costs more fp32 adds
// than the CUDA cores keep up with.  Blocks walk the output in groups of
// 16 row blocks so that the tiles of x_q and w_t in flight stay in L2.
//
// K or N not a multiple of 16 (TMA needs 16-byte row strides):
// fp8_matmul_kernel, the first port, on the CUDA cores.  A block owns a
// 128 x 128 output tile, 256 threads each hold an 8 x 8 fp32 accumulator
// in registers, and the K loop stages 32-deep slices of x_q and w_q in
// shared memory, decoded from e4m3 to fp32 on the way in (16-byte global
// loads where K, N are multiples of 16, bytes otherwise), with x_q's
// slice transposed so each thread reads its 8 rows and 8 columns as two
// float4s each.  Every product of two e4m3 values is exact in fp32, and
// every partial sum stays in fp32 FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ---- e4m3 on the tensor cores ---------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BM = 128;           // output rows per block: 2 consumer WGs
constexpr int BN = 128;           // output columns per block
constexpr int BK = 128;           // K per ring stage: one swizzled row
constexpr int STAGES = 4;
constexpr int THREADS = 384;      // producer warpgroup + 2 consumers
constexpr int TILE_BYTES = 128 * BK;          // x_q or w_t of one stage
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr size_t SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 128;
constexpr int GROUP_M = 16;       // row blocks walked together (L2 reuse)
// k32 steps per promoted chunk (two chunks a stage): the accumulator is
// added into the fp32 sum and restarted after every 64 of K
constexpr int CHUNK = BK / 32 / 2;
constexpr int TT = 64;            // transpose tile (bytes a side)

// w_q [K, N] -> w_t [N, K] (K contiguous: wgmma's K-major B operand),
// 64 x 64-byte tiles through shared memory; K and N multiples of 4.
__global__ void __launch_bounds__(256)
transpose_kernel(const uint8_t* __restrict__ w, uint8_t* __restrict__ wt,
                 int K, int N) {
  __shared__ __align__(4) uint8_t tile[TT][TT + 4];
  const int k0 = blockIdx.y * TT, n0 = blockIdx.x * TT;
  const int c4 = (threadIdx.x % 16) * 4;
  for (int r = threadIdx.x / 16; r < TT; r += 16) {
    const int k = k0 + r, n = n0 + c4;
    uint32_t v = 0;
    if (k < K && n < N)
      v = *reinterpret_cast<const uint32_t*>(
          w + static_cast<int64_t>(k) * N + n);
    *reinterpret_cast<uint32_t*>(&tile[r][c4]) = v;
  }
  __syncthreads();
  for (int r = threadIdx.x / 16; r < TT; r += 16) {
    const int n = n0 + r, k = k0 + c4;
    if (n < N && k < K)
      *reinterpret_cast<uint32_t*>(wt + static_cast<int64_t>(n) * K + k) =
          uint32_t(tile[c4][r]) | uint32_t(tile[c4 + 1][r]) << 8 |
          uint32_t(tile[c4 + 2][r]) << 16 | uint32_t(tile[c4 + 3][r]) << 24;
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void release(uint64_t* empty, int stage, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[stage]);
}

// CHUNK k32 steps of the stage from step kk0 into acc, started from 0
__device__ __forceinline__ void issue_chunk(float (&acc)[64], const uint8_t* a,
                                            const uint8_t* b, int kk0) {
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < CHUNK; ++i)
    wgmma_m64n128k32_ss_e4m3(acc, desc_sw128(a + 32 * (kk0 + i), 16, 1024),
                             desc_sw128(b + 32 * (kk0 + i), 16, 1024), i > 0);
  wgmma_commit();
}

// promotion every CHUNK k32 steps: a stage's two chunks run into two
// accumulators, and the first is added into the fp32 sum while the
// second runs on the tensor cores; nothing is in flight across stages
__device__ __forceinline__ void consume_promoted(
    const uint8_t* tiles, uint64_t* full, uint64_t* empty, int n_k, int cw,
    int lane, float (&sum)[64]) {
  float acc0[64], acc1[64];
#pragma unroll
  for (int c = 0; c < 64; ++c) acc0[c] = acc1[c] = sum[c] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < n_k; ++kb) {
    mbar_wait(&full[stage], phase);
    const uint8_t* a = tiles + stage * STAGE_BYTES + cw * 64 * BK;
    const uint8_t* b = tiles + stage * STAGE_BYTES + TILE_BYTES;
    issue_chunk(acc0, a, b, 0);
    issue_chunk(acc1, a, b, CHUNK);
    wgmma_wait<1>();
    fence_regs(acc0);
#pragma unroll
    for (int c = 0; c < 64; ++c) sum[c] += acc0[c];
    wgmma_wait<0>();
    fence_regs(acc1);
    release(empty, stage, lane);
#pragma unroll
    for (int c = 0; c < 64; ++c) sum[c] += acc1[c];
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// one accumulator chain over all of K, no promotion (tests only: shows
// what the promotion buys)
__device__ __forceinline__ void consume_unpromoted(
    const uint8_t* tiles, uint64_t* full, uint64_t* empty, int n_k, int cw,
    int lane, float (&sum)[64]) {
#pragma unroll
  for (int c = 0; c < 64; ++c) sum[c] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < n_k; ++kb) {
    mbar_wait(&full[stage], phase);
    const uint8_t* a = tiles + stage * STAGE_BYTES + cw * 64 * BK;
    const uint8_t* b = tiles + stage * STAGE_BYTES + TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_m64n128k32_ss_e4m3(sum, desc_sw128(a + 32 * kk, 16, 1024),
                               desc_sw128(b + 32 * kk, 16, 1024),
                               kk > 0 || kb > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sum);
    release(empty, stage, lane);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <typename OT, bool PROMOTE>
__global__ void __launch_bounds__(THREADS, 1)
fp8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        const float* __restrict__ sx,
                        const float* __restrict__ sw, OT* __restrict__ out,
                        int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  // output tile: groups of GROUP_M row blocks, N walked inside a group
  const int grid_m = (M + BM - 1) / BM, grid_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * grid_n;
  const int first_m = (blockIdx.x / per_group) * GROUP_M;
  const int rows_g = min(grid_m - first_m, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % rows_g) * BM;
  const int n0 = (in_group / rows_g) * BN;
  const int n_k = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);    // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&ta);
      tma_prefetch(&tb);
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < n_k; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* a = tiles + stage * STAGE_BYTES;
        mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
        tma_load_2d(a, &ta, &full[stage], kb * BK, m0);
        tma_load_2d(a + TILE_BYTES, &tb, &full[stage], kb * BK, n0);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    float sum[64];
    if constexpr (PROMOTE)
      consume_promoted(tiles, full, empty, n_k, cw, lane, sum);
    else
      consume_unpromoted(tiles, full, empty, n_k, cw, lane, sum);

    // both scales folded in once, in the reference's order: (acc*sx)*sw;
    // N is a multiple of 16, so a column pair is in or out together
    const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * cw + 16 * warp + lane / 4 + 8 * r;
      if (row >= M) continue;
      const float s = sx[row];
      OT* dst = out + static_cast<int64_t>(row) * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col0 + 8 * j;
        if (col < N)
          store2(dst + col, sum[4 * j + 2 * r] * s * sw[col],
                 sum[4 * j + 2 * r + 1] * s * sw[col + 1]);
      }
    }
  }
}

// [rows, K] bytes, K contiguous, as a 2-D tensor map of 128 x 128 boxes
inline int rows_map(CUtensorMap* map, const void* base, int rows, int K) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {BK, 128};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims,
                      strides, box);
}

template <typename OT>
int launch(const uint8_t* xq, const uint8_t* wq, uint8_t* wt, const float* sx,
           const float* sw, void* out, int M, int N, int K, int promote,
           cudaStream_t stream) {
  dim3 tgrid((N + TT - 1) / TT, (K + TT - 1) / TT);
  transpose_kernel<<<tgrid, 256, 0, stream>>>(wq, wt, K, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap ta, tb;
  if (rows_map(&ta, xq, M, K) || rows_map(&tb, wt, N, K)) return -4;
  auto kern = promote ? fp8_matmul_wgmma_kernel<OT, true>
                      : fp8_matmul_wgmma_kernel<OT, false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks =
      static_cast<int64_t>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks > INT32_MAX) return -2;
  kern<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, stream>>>(
      ta, tb, sx, sw, static_cast<OT*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

// The tensor-core kernel: the arguments of fp8_matmul_launch, plus w_t,
// scratch of N x K bytes that receives w_q transposed, and `promote` (1:
// the wgmma accumulator is added into the fp32 sum and restarted after
// every 64 of K; 0, for tests only: one accumulator chain over all of
// K).  K and N must be nonzero multiples of 16, x_q 16-byte aligned.
// Returns as fp8_matmul_launch, or -3 for K or N, -4 when a tensor map
// cannot be encoded.
extern "C" int fp8_matmul_wgmma_launch(const void* x_q, const void* w_q,
                                       const void* sx, const void* sw,
                                       void* out, void* w_t, int M, int N,
                                       int K, int out_dtype, int promote,
                                       void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || K % 16 || N % 16) return -3;
  const uint8_t* xq = static_cast<const uint8_t*>(x_q);
  const uint8_t* wq = static_cast<const uint8_t*>(w_q);
  uint8_t* wt = static_cast<uint8_t*>(w_t);
  const float* sxf = static_cast<const float*>(sx);
  const float* swf = static_cast<const float*>(sw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return tc::launch<float>(xq, wq, wt, sxf, swf, out, M, N, K,
                                     promote, st);
    case 1: return tc::launch<__nv_bfloat16>(xq, wq, wt, sxf, swf, out, M,
                                             N, K, promote, st);
  }
  return -1;
}

extern "C" const char* fp8_matmul_error_string(int code) {
  switch (code) {
    case -1: return "unsupported out dtype (float32 or bfloat16)";
    case -2: return "output too large for the grid";
    case -3: return "the tensor-core kernel needs K and N multiples of 16";
    case -4: return "tensor map encoding failed (alignment, or no "
                    "cuTensorMapEncodeTiled in the driver)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
