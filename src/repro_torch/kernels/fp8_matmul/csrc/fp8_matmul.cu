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
// 2.22 ms at the H100's 1,979 TFLOP/s dense fp8 rate, 4.447 ms at the
// 989 TFLOP/s bf16 rate that an exact sum runs at (the 2.35 GB it moves
// take 0.70 ms), so it is compute-bound.
//
// Two kernels; the wrapper picks one by shape.
//
// K and N multiples of 16 (every model shape): fp8_matmul_wgmma, on the
// tensor cores, summing as exactly as the reference.  Hopper's e4m3 wgmma
// keeps only about 14 bits while it accumulates (DeepSeek-V3 technical
// report, "Increasing Accumulation Precision"), which misses the
// reference's 1e-5 at the reference's own shapes.  So the e4m3 operands
// are widened to bf16 in shared memory, which is exact (every e4m3 value
// is a bf16 value), and multiplied on bf16 wgmma into fp32: the product
// of two e4m3 values is exact, and the sum is fp32.  The bound is then
// the bf16 rate, half the fp8 one (4.447 ms at minitron-8b's FFN, below).
// A block owns a 128 x 128 output tile: one thread of the producer
// warpgroup issues TMA loads of 128-deep K slices of x_q [128 rows of M]
// and w_q [128 rows of K] as they lie in memory (e4m3, unswizzled) into a
// 3-stage ring; two consumer warpgroups of 64 rows each (setmaxnreg moves
// the producer's registers to them) widen each slice to bf16 in the
// 128-byte swizzle (64-column boxes) of one of two bf16 stages, and run
// m64n128k16 bf16 wgmmas on it, x K-major and w read MN-major (the
// transposed-B form), so w_q needs no transpose.  The widening of slice
// k + 1 runs while slice k's products are on the tensor cores: three
// dedicated warps proved too few for it (one warp per scheduler is
// latency-bound: about 3,500 cycles a 32 KB slice on an H100, 2,200 of
// them the shared-memory loads and stores alone, against about 1,400 for
// the slice's products).  TMA writes zeros past M, N and K.  Each stage is
// eight k16 steps, in chunks of four (64 of K) into one fp32 accumulator,
// each chunk started from 0 and added into the fp32 sum in registers when
// it is done: the fp32 accumulation of Hopper's tensor cores truncates,
// so a long all-positive chain drifts (on an H100, one chain over K =
// 4,096 all-positive terms gave 2.67e-6 of max |out|, the promoted sum
// 6.0e-7).  One accumulator, not two in turn, leaves the registers that
// the widening needs.  Blocks walk the output in groups of
// 16 row blocks so that the tiles of x_q and w_q in flight stay in L2.
// Shared memory: 2 x 64 KB of bf16 stages + 3 x 32 KB of e4m3 stages =
// 229,376 B (+ alignment and barriers).
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

// ---- the tensor cores, summing exactly ------------------------------------

namespace tc {

using namespace hopper;

constexpr int BM = 128;           // output rows per block: 2 consumer WGs
constexpr int BN = 128;           // output columns per block
constexpr int BK = 128;           // K per ring stage
constexpr int STAGES8 = 3;        // e4m3 ring (TMA -> consumers)
constexpr int THREADS = 384;      // producer warpgroup + 2 consumers
constexpr int TILE8 = 128 * BK;               // x_q or w_q of one stage, e4m3
constexpr int STAGE8_BYTES = 2 * TILE8;
constexpr int BOX = 128 * 128;                // one 64-column bf16 box
constexpr int TILE_BYTES = 2 * BOX;           // x or w of one stage, bf16
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
// two bf16 stages: the products read one while the other is widened
constexpr size_t SMEM_BYTES =
    1024 + 2 * STAGE_BYTES + STAGES8 * STAGE8_BYTES + 128;
constexpr int GROUP_M = 16;       // row blocks walked together (L2 reuse)
// k16 steps per promoted chunk (two chunks a stage): the accumulator is
// added into the fp32 sum and restarted after every 64 of K
constexpr int CHUNK = BK / 16 / 2;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// CHUNK k16 steps of the stage from step kk0 into acc, started from 0.  A
// (x, K-major) and B (w, N contiguous: MN-major) are 64-column boxes;
// step kk reads A's box kk/4 at byte 32 (kk % 4) of each row and B's k
// rows 16 kk .. 16 kk + 15 of both N boxes (LBO: the box stride).
__device__ __forceinline__ void issue_chunk(float (&acc)[64], const uint8_t* a,
                                            const uint8_t* b, int kk0) {
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    const int kk = kk0 + i;
    wgmma_m64n128k16_ss_bf16_tb(
        acc, desc_sw128(a + (kk / 4) * BOX + 32 * (kk % 4), 16, 1024),
        desc_sw128(b + kk * 16 * 128, BOX, 1024), i > 0);
  }
  wgmma_commit();
}

// Four 16-byte chunks of a staged e4m3 tile (128-byte rows) widened to
// bf16 in the 128-byte swizzle of a bf16 tile: chunks idx0 + step * u
// (u < 4) of rows shifted by row0, their loads all issued first.  The
// chunks are spread so that no bank is met twice (chunk_of).
__device__ __forceinline__ void widen4(const uint8_t* src, uint8_t* dst,
                                       int idx0, int step, int row0) {
  uint4 in[4];
  int row[4], j[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    chunk_of(idx0 + step * u, row[u], j[u]);
    row[u] += row0;
    in[u] = *reinterpret_cast<const uint4*>(src + row[u] * 128 + 16 * j[u]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    uint4 lo, hi;
    widen_e4m3x16(in[u], lo, hi);
    st_sw128_bf16x16(dst, BOX, row[u], j[u], lo, hi);
  }
}

// The consumers.  Each stage of K is two chunks of four k16 steps (64 of
// K) into one fp32 accumulator, each chunk started from 0 and added into
// the fp32 sum when it is done.  While the tensor cores run a chunk, the
// two warpgroups widen half of the next staged slice into the other bf16
// stage (t: the thread's index of 256; each warpgroup its own 64 rows of
// x, then both together the 128 k rows of w); a named barrier over both
// warpgroups closes the stage (the next slice complete, this one's
// products done).
__device__ __forceinline__ void consume(
    uint8_t* tiles, const uint8_t* tiles8, uint64_t* full8,
    uint64_t* empty8, int n_k, int cw, int lane, float (&sum)[64]) {
  const int t = threadIdx.x - 128;
  float acc[64];
#pragma unroll
  for (int c = 0; c < 64; ++c) acc[c] = sum[c] = 0.f;
  mbar_wait(&full8[0], 0);
  widen4(tiles8, tiles, t % 128, 128, 64 * cw);
  widen4(tiles8 + TILE8, tiles + TILE_BYTES, t, 256, 0);
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty8[0]);
  named_sync(1, 256);
  int s8 = 1 % STAGES8;
  uint32_t ph8 = STAGES8 == 1;
  for (int kb = 0; kb < n_k; ++kb) {
    const uint8_t* a = tiles + (kb & 1) * STAGE_BYTES + cw * 64 * 128;
    const uint8_t* b = tiles + (kb & 1) * STAGE_BYTES + TILE_BYTES;
    uint8_t* next = tiles + ((kb + 1) & 1) * STAGE_BYTES;
    const uint8_t* src = tiles8 + s8 * STAGE8_BYTES;
    const bool more = kb + 1 < n_k;
    issue_chunk(acc, a, b, 0);
    if (more) {
      mbar_wait(&full8[s8], ph8);
      widen4(src, next, t % 128, 128, 64 * cw);
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int c = 0; c < 64; ++c) sum[c] += acc[c];
    issue_chunk(acc, a, b, CHUNK);
    if (more) {
      widen4(src + TILE8, next + TILE_BYTES, t, 256, 0);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty8[s8]);
      if (++s8 == STAGES8) {
        s8 = 0;
        ph8 ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int c = 0; c < 64; ++c) sum[c] += acc[c];
    named_sync(1, 256);
  }
}

template <typename OT>
__global__ void __launch_bounds__(THREADS, 1)
fp8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        const float* __restrict__ sx,
                        const float* __restrict__ sw, OT* __restrict__ out,
                        int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* tiles8 = tiles + 2 * STAGE_BYTES;
  uint64_t* full8 =
      reinterpret_cast<uint64_t*>(tiles8 + STAGES8 * STAGE8_BYTES);
  uint64_t* empty8 = full8 + STAGES8;

  // output tile: groups of GROUP_M row blocks, N walked inside a group
  const int grid_m = (M + BM - 1) / BM, grid_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * grid_n;
  const int first_m = (blockIdx.x / per_group) * GROUP_M;
  const int rows_g = min(grid_m - first_m, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % rows_g) * BM;
  const int n0 = (in_group / rows_g) * BN;
  const int n_k = (K + BK - 1) / BK;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES8; ++st) {
      mbar_init(&full8[st], 1);
      mbar_init(&empty8[st], 8);           // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      // one thread issues every load: e4m3 K slices of x_q [128 rows of M]
      // and w_q [128 rows of K], as they are in memory
      tma_prefetch(&ta);
      tma_prefetch(&tb);
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < n_k; ++kb) {
        mbar_wait(&empty8[stage], phase ^ 1);
        uint8_t* a = tiles8 + stage * STAGE8_BYTES;
        mbar_arrive_expect_tx(&full8[stage], STAGE8_BYTES);
        tma_load_2d(a, &ta, &full8[stage], kb * BK, m0);
        tma_load_2d(a + TILE8, &tb, &full8[stage], n0, kb * BK);
        if (++stage == STAGES8) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32;
    float sum[64];
    consume(tiles, tiles8, full8, empty8, n_k, cw, lane, sum);

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

// [rows, cols] bytes, cols contiguous, as a 2-D tensor map of 128 x 128
// boxes, unswizzled (the converters read the staged rows as they are)
inline int rows_map(CUtensorMap* map, const void* base, int rows, int cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {128, 128};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename OT>
int launch(const uint8_t* xq, const uint8_t* wq, const float* sx,
           const float* sw, void* out, int M, int N, int K,
           cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (rows_map(&ta, xq, M, K) || rows_map(&tb, wq, K, N)) return -4;
  auto kern = fp8_matmul_wgmma_kernel<OT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
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

// The tensor-core kernel: the arguments of fp8_matmul_launch.  K and N
// must be nonzero multiples of 16, x_q and w_q 16-byte aligned.  Returns
// as fp8_matmul_launch, or -3 for K or N, -4 when a tensor map cannot be
// encoded.
extern "C" int fp8_matmul_wgmma_launch(const void* x_q, const void* w_q,
                                       const void* sx, const void* sw,
                                       void* out, int M, int N, int K,
                                       int out_dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || K % 16 || N % 16) return -3;
  const uint8_t* xq = static_cast<const uint8_t*>(x_q);
  const uint8_t* wq = static_cast<const uint8_t*>(w_q);
  const float* sxf = static_cast<const float*>(sx);
  const float* swf = static_cast<const float*>(sw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return tc::launch<float>(xq, wq, sxf, swf, out, M, N, K, st);
    case 1: return tc::launch<__nv_bfloat16>(xq, wq, sxf, swf, out, M, N,
                                             K, st);
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
