// Mamba-2 SSD chunked scan (Hopper).
//
// Replaces the JAX reference's TPU kernel
// kernels/ssd_scan/kernel.py::ssd_pallas (body _kernel).  It computes
// the same function as ref.ssd_ref with n_groups = 1: for x [B,S,H,P],
// dt [B,S,H] (fp32), A [H] (fp32), Bm / Cm [B,S,1,N] and an optional
// fp32 init_state [B,H,P,N], in chunks of q = min(chunk, S) tokens
// (the last chunk zero-padded: dt = x = B = C = 0, so padded rows
// neither decay nor feed the state):
//   cs       = inclusive cumsum over the chunk of dt * A
//   y_intra  = ((C B^T) o L o dt_j) X,   L[i,j] = exp(cs_i - cs_j), i >= j
//   y_inter  = (C o exp(cs)) @ entering_state^T
//   state'   = exp(cs_last) * state + (B o dt o exp(cs_last - cs))^T X
// y = y_intra + y_inter in x's dtype; the final state [B,H,P,N] in fp32.
//
// Design.  The TPU grid (B, H, NC) walks the chunks of a (b, h) in order
// and carries the [N, P] state in VMEM.  On the card that would give
// B * H = 96 blocks (B = 2, H = 48) for 132 SMs, each walking 256 chunks
// in turn at S = 32,768.  Two kernels share the file:
//   * the tensor-core kernel (ssd_wgmma_kernel, bf16 x/B/C at (P, N) =
//     (64, 128), mamba2-780m's shape; described at its definition): one
//     block per (b, chunk, group of 6 heads), one C B^T per block shared
//     by its heads, every product on wgmma, the state chained across
//     chunks through L2 (no round trip of the chunk states);
//   * the CUDA-core kernels (fp32, jamba-v0.1-52b's (64, 16) and the
//     reduced configs' (16, 16)), the SSD's three-pass form launched by
//     one call:
//     1. chunk_state, grid (NC, H, B): cs, the chunk's own state
//        contribution (B o dt o exp(cs_last - cs))^T X [P,N] and its decay
//        exp(cs_last), written to fp32 scratch [B,H,NC,P,N] / [B,H,NC];
//     2. state_pass, grid (P*N / 256, B*H): one thread per state element
//        walks the chunks in order, replacing each chunk's contribution in
//        place by the state ENTERING that chunk, and writes the final
//        state;
//     3. chunk_out, grid (NC, H, B): C B^T, the masked decay weights W,
//        W X and (C o exp(cs)) @ entering^T, summed and stored; every
//        product in fp32 (tiles widened to fp32 in shared memory, register
//        tiles of 8 x 8 / 8 x P/16 per thread).
// Both read x, B and C in the model layout in place (batch and token
// strides given; (h, p) and n contiguous), not through the TPU wrapper's
// transposes.  exp(cs_i - cs_j) is evaluated only where i >= j (above
// the diagonal it can overflow, and inf * 0 is NaN).  The chunk length is
// a run-time q <= 128 (tiles are 128 rows, rows past q are zero).
//
// Bound at the chip check's shape (mamba2-780m at full width: B = 2,
// S = 32,768, H = 48, P = 64, N = 128, q = 128, NC = 256, bf16 x/B/C):
// 854.6 MB of x, y, dt, B, C and the final state, 0.255 ms at 3.35 TB/s.
// The function needs, per (b, chunk), the lower triangle of C B^T
// (q(q+1)N, B and C being shared by the heads) and per (b, h, chunk)
// the triangle of W X (q(q+1)P) plus 4qNP for the inter-chunk output
// and the chunk state: 130.1 GFLOP, 0.132 ms at the 989 TFLOP/s bf16
// tensor-core peak.  So the bound is bytes, 0.255 ms.  The tensor-core
// kernel is far from it: a block's phases (the W build, each product,
// the chain's L2 round trips, the stores) run one after another with 8
// warps to an SM, and the chain orders the chunks (PERF.md).

#include "hopper.cuh"

namespace {

constexpr int QT = 128;          // chunk tile rows (the largest q)
constexpr int THREADS = 256;     // 16 x 16 threads
constexpr int RQ = QT / 16;      // chunk rows per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* x;                 // [B,S,H,P] with strides x_bs, x_ts
  const float* dt;               // [B,S,H] contiguous
  const float* A;                // [H]
  const void* Bm;                // [B,S,1,N] with strides b_bs, b_ts
  const void* Cm;                // [B,S,1,N] with strides c_bs, c_ts
  const float* init;             // [B,H,P,N] or null
  void* y;                       // [B,S,H,P] contiguous
  float* states;                 // scratch [B,H,NC,P,N]
  float* decay;                  // scratch [B,H,NC]
  float* final_state;            // [B,H,P,N]
  int B, S, H, q, nc;
  long long x_bs, x_ts, b_bs, b_ts, c_bs, c_ts;
};

// dt of chunk c of (b, h) (0 past the sequence and past q) and the
// inclusive cumsum of dt * A, in order, as the reference's cumsum; rows
// past q repeat the last value.  Ends with a barrier.
__device__ void chunk_cumsum(const Args& a, int b, int h, int c,
                             float* dts, float* cs) {
  for (int i = threadIdx.x; i < QT; i += THREADS) {
    const int t = c * a.q + i;
    dts[i] = (i < a.q && t < a.S)
                 ? a.dt[(static_cast<int64_t>(b) * a.S + t) * a.H + h]
                 : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float Ah = a.A[h];
    float run = 0.f;
    for (int i = 0; i < QT; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[i], Ah));   // dA, then the sum
      cs[i] = run;
    }
  }
  __syncthreads();
}

// ---- pass 1: each chunk's own state contribution and decay --------------
template <int P, int N, typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state_kernel(Args a) {
  constexpr int RP = (P + 15) / 16;  // state rows p per thread
  constexpr int CN = (N + 15) / 16;  // state columns n per thread
  extern __shared__ float smem[];
  float* dts = smem;                 // [QT]
  float* cs = dts + QT;              // [QT]
  float* wj = cs + QT;               // [QT] dt * exp(cs_last - cs)
  float* Xs = wj + QT;               // [QT][P]
  float* Bs = Xs + QT * P;           // [QT][N] B o dt o decay_to_end

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);

  chunk_cumsum(a, b, h, c, dts, cs);
  const float cs_last = cs[a.q - 1];
  for (int i = tid; i < QT; i += THREADS)
    wj[i] = i < a.q ? __fmul_rn(dts[i], expf(cs_last - cs[i])) : 0.f;
  __syncthreads();
  for (int idx = tid; idx < QT * P; idx += THREADS) {
    const int j = idx / P, p = idx % P;
    const int t = c * a.q + j;
    Xs[idx] = (j < a.q && t < a.S)
                  ? to_f32(x[b * a.x_bs + t * a.x_ts +
                             static_cast<int64_t>(h) * P + p])
                  : 0.f;
  }
  for (int idx = tid; idx < QT * N; idx += THREADS) {
    const int j = idx / N, n = idx % N;
    const int t = c * a.q + j;
    Bs[idx] = (j < a.q && t < a.S)
                  ? __fmul_rn(to_f32(Bm[b * a.b_bs + t * a.b_ts + n]), wj[j])
                  : 0.f;
  }
  __syncthreads();

  // state[p][n] = sum_j x[j][p] * Bs[j][n]
  float acc[RP][CN];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int k = 0; k < CN; ++k) acc[r][k] = 0.f;
#pragma unroll 4
  for (int j = 0; j < a.q; ++j) {
    float xv[RP], bv[CN];
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int p = ty + 16 * r;
      xv[r] = p < P ? Xs[j * P + p] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < CN; ++k) {
      const int n = tx + 16 * k;
      bv[k] = n < N ? Bs[j * N + n] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int k = 0; k < CN; ++k) acc[r][k] = fmaf(xv[r], bv[k], acc[r][k]);
  }
  const int64_t bhc = (static_cast<int64_t>(b) * a.H + h) * a.nc + c;
  float* out = a.states + bhc * P * N;
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int k = 0; k < CN; ++k) {
      const int p = ty + 16 * r, n = tx + 16 * k;
      if (p < P && n < N) out[p * N + n] = acc[r][k];
    }
  if (tid == 0) a.decay[bhc] = expf(cs_last);
}

// ---- pass 2: the recurrence over chunks, in place ------------------------
// states[b,h,c] := state entering chunk c;  s = s * decay_c + contribution_c
__global__ void __launch_bounds__(THREADS)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ decay,
                      const float* __restrict__ init,
                      float* __restrict__ final_state, int nc, int PN) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int64_t bh = blockIdx.y;
  if (e >= PN) return;
  float s = init != nullptr ? init[bh * PN + e] : 0.f;
  float* st = states + bh * nc * PN + e;
  const float* d = decay + bh * nc;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const float contrib = st[static_cast<int64_t>(c) * PN];
    st[static_cast<int64_t>(c) * PN] = s;
    s = __fadd_rn(__fmul_rn(s, d[c]), contrib);
  }
  final_state[bh * PN + e] = s;
}

// ---- pass 3: the chunk's output -----------------------------------------
template <int P, int N>
__host__ __device__ constexpr int out_smem_floats() {
  // dt, cs, exp(cs); C [QT][N+1]; B [QT][N+1] then W [QT][QT+1];
  // X [QT][P]; entering state [P][N+1]
  return 3 * QT + QT * (N + 1)
         + (QT * (N + 1) > QT * (QT + 1) ? QT * (N + 1) : QT * (QT + 1))
         + QT * P + P * (N + 1);
}

template <int P, int N, typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_out_kernel(Args a) {
  constexpr int NS = N + 1;          // padded row strides (bank spread)
  constexpr int WS = QT + 1;
  constexpr int CP = (P + 15) / 16;  // output columns p per thread
  extern __shared__ float smem[];
  float* dts = smem;                 // [QT]
  float* cs = dts + QT;              // [QT]
  float* ecs = cs + QT;              // [QT] exp(cs)
  float* Cs = ecs + QT;              // [QT][NS]  C, then C o exp(cs)
  float* Bs = Cs + QT * NS;          // [QT][NS]  B
  float* Ws = Bs;                    // [QT][WS]  W, once C B^T is done
  float* Xs = Bs + (QT * NS > QT * WS ? QT * NS : QT * WS);   // [QT][P]
  float* Ss = Xs + QT * P;           // [P][NS] entering state

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);

  chunk_cumsum(a, b, h, c, dts, cs);
  for (int i = tid; i < QT; i += THREADS) ecs[i] = expf(cs[i]);
  for (int idx = tid; idx < QT * N; idx += THREADS) {
    const int i = idx / N, n = idx % N;
    const int t = c * a.q + i;
    const bool live = i < a.q && t < a.S;
    Cs[i * NS + n] = live ? to_f32(Cm[b * a.c_bs + t * a.c_ts + n]) : 0.f;
    Bs[i * NS + n] = live ? to_f32(Bm[b * a.b_bs + t * a.b_ts + n]) : 0.f;
  }
  __syncthreads();

  // C B^T on an 8 x 8 register tile: rows i = ty + 16 r, cols j = tx + 16 k
  float w[RQ][RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int k = 0; k < RQ; ++k) w[r][k] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float cv[RQ], bv[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) cv[r] = Cs[(ty + 16 * r) * NS + n];
#pragma unroll
    for (int k = 0; k < RQ; ++k) bv[k] = Bs[(tx + 16 * k) * NS + n];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int k = 0; k < RQ; ++k) w[r][k] = fmaf(cv[r], bv[k], w[r][k]);
  }
  // W = (C B^T) o L o dt_j: the exponent only where i >= j (and i < q)
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int k = 0; k < RQ; ++k) {
      const int j = tx + 16 * k;
      w[r][k] = (i >= j && i < a.q)
                    ? __fmul_rn(__fmul_rn(w[r][k], expf(cs[i] - cs[j])),
                                dts[j])
                    : 0.f;
    }
  }
  __syncthreads();                   // every thread is done with Bs and Cs

#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int k = 0; k < RQ; ++k)
      Ws[(ty + 16 * r) * WS + tx + 16 * k] = w[r][k];
  for (int idx = tid; idx < QT * N; idx += THREADS) {
    const int i = idx / N, n = idx % N;
    Cs[i * NS + n] = __fmul_rn(Cs[i * NS + n], ecs[i]);
  }
  for (int idx = tid; idx < QT * P; idx += THREADS) {
    const int j = idx / P, p = idx % P;
    const int t = c * a.q + j;
    Xs[idx] = (j < a.q && t < a.S)
                  ? to_f32(x[b * a.x_bs + t * a.x_ts +
                             static_cast<int64_t>(h) * P + p])
                  : 0.f;
  }
  const int64_t bhc = (static_cast<int64_t>(b) * a.H + h) * a.nc + c;
  const float* entering = a.states + bhc * P * N;
  for (int idx = tid; idx < P * N; idx += THREADS)
    Ss[(idx / N) * NS + idx % N] = entering[idx];
  __syncthreads();

  // y_intra[i][p] = sum_j W[i][j] X[j][p];
  // y_inter[i][p] = sum_n (C o exp(cs))[i][n] S[p][n]
  float yi[RQ][CP], ye[RQ][CP];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int k = 0; k < CP; ++k) yi[r][k] = ye[r][k] = 0.f;
#pragma unroll 4
  for (int j = 0; j < a.q; ++j) {
    float wv[RQ], xv[CP];
#pragma unroll
    for (int r = 0; r < RQ; ++r) wv[r] = Ws[(ty + 16 * r) * WS + j];
#pragma unroll
    for (int k = 0; k < CP; ++k) {
      const int p = tx + 16 * k;
      xv[k] = p < P ? Xs[j * P + p] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int k = 0; k < CP; ++k) yi[r][k] = fmaf(wv[r], xv[k], yi[r][k]);
  }
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float cv[RQ], sv[CP];
#pragma unroll
    for (int r = 0; r < RQ; ++r) cv[r] = Cs[(ty + 16 * r) * NS + n];
#pragma unroll
    for (int k = 0; k < CP; ++k) {
      const int p = tx + 16 * k;
      sv[k] = p < P ? Ss[p * NS + n] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int k = 0; k < CP; ++k) ye[r][k] = fmaf(cv[r], sv[k], ye[r][k]);
  }

  T* y = static_cast<T*>(a.y);
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = ty + 16 * r;
    const int t = c * a.q + i;
    if (i >= a.q || t >= a.S) continue;
    const int64_t row = (static_cast<int64_t>(b) * a.S + t) * a.H + h;
#pragma unroll
    for (int k = 0; k < CP; ++k) {
      const int p = tx + 16 * k;
      if (p < P) store(y + row * P + p, __fadd_rn(yi[r][k], ye[r][k]));
    }
  }
}

template <typename K>
int allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int P, int N, typename T>
int launch(const Args& a, cudaStream_t stream) {
  const size_t state_smem = sizeof(float) * (3 * QT + QT * P + QT * N);
  const size_t out_smem = sizeof(float) * out_smem_floats<P, N>();
  int e = allow_smem(ssd_chunk_state_kernel<P, N, T>, state_smem);
  if (e) return e;
  e = allow_smem(ssd_chunk_out_kernel<P, N, T>, out_smem);
  if (e) return e;
  const dim3 grid(a.nc, a.H, a.B);
  ssd_chunk_state_kernel<P, N, T><<<grid, THREADS, state_smem, stream>>>(a);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const dim3 pass_grid((P * N + THREADS - 1) / THREADS, a.B * a.H);
  ssd_state_pass_kernel<<<pass_grid, THREADS, 0, stream>>>(
      a.states, a.decay, a.init, a.final_state, a.nc, P * N);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  ssd_chunk_out_kernel<P, N, T><<<grid, THREADS, out_smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N>
int launch_t(const Args& a, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch<P, N, float>(a, stream);
    case 1: return launch<P, N, __nv_bfloat16>(a, stream);
  }
  return -2;
}

// ---- the tensor-core kernel: bf16 x / B / C at (P, N) = (64, 128) --------
//
// One block of two consumer warpgroups owns (b, chunk, a group of up to
// HG = 6 heads).  Thread 0 brings C and B of the chunk ([128 x 128] bf16,
// two 64-column boxes each) and the heads' X tiles ([128 x 64] bf16, one
// box each, through a ring of 3 slots) by TMA through tensor maps over
// the strided model-layout views.  Warpgroup wg owns chunk rows 64wg ..
// 64wg + 63 of the products over rows:
//   CB = C B^T once for the group (m64n128, both operands K-major), kept
//   in shared memory as fp32;
//   per head: W = CB o L o dt_j (L = exp(cs_i - cs_j) only where i >= j)
//   rounded to bf16 in registers, y = W X (m64n64, X MN-major); the chunk
//   state contrib[p][n] = sum_j (X o w)[j][p] B[j][n] (w_j = dt_j
//   exp(cs_last - cs_j)), warpgroup wg owning n 64wg .. 64wg + 63, with
//   X o w a bf16 hi + lo pair from ldmatrix.trans; then the state entering
//   the chunk, y += exp(cs_i) (C state^T) with the state rounded to bf16
//   in shared memory (the operand plan below says why); y goes out
//   through a staging tile by one TMA store per head.
// The state is carried across chunks as a chained scan: blocks take
// tickets in order from an atomic counter (chunk-major), so the block of
// chunk c - 1 of the same (b, head group) holds an earlier ticket and is
// resident or done.  Per head, each warp reads the part of the state
// that the same warp of chunk c - 1's block wrote, into one of two fp32
// slots [2, B, H, P, N] (slot (c - 1) % 2: rewritten only two chunks
// later, after chunk c has read it), once that warp's flag says chunk
// c - 1 is done (a flag per (b, h, warp): no block-wide barrier on the
// chain's path); it writes state * exp(cs_last) + contrib to slot c % 2
// (the final state for the last chunk), fences, and raises its flag.
// Only the frontier's states (6.3 MB at the chip check's shape) travel,
// in L2, instead of 805 MB of chunk states written and read back.
namespace tc {

using namespace hopper;

constexpr int TP = 64, TN = 128, HG = 6;
constexpr int TTHREADS = 256;
constexpr int ROWB = 128;                    // bytes of a swizzled box row
constexpr int TILE = QT * ROWB;              // [128 rows x 64 bf16]: 16 KB
constexpr int ST_HALF = TP * ROWB;           // [64 p x 64 n] bf16: 8 KB
constexpr int C_OFF = 0;
constexpr int B_OFF = 2 * TILE;
constexpr int X_OFF = 4 * TILE;
// The operand plan: an fp32 operand goes to the tensor cores as a bf16
// hi + lo pair (two products, ~16 significant bits) or as one bf16
// rounding.  X o w, whose rounding every later chunk's state inherits, is
// a pair; W and the entering state of C state^T take one rounding
// (settled on the CPU against the reference: y stays within 1 of the 2
// bf16 ulps it is held to, where X o w as one rounding would leave the
// final state off by 2e-3 of its magnitude, against 1e-4).
// ref.ssd_kernel_emulation rounds the same way.
constexpr int XS = 3;                        // X ring slots
constexpr int Y_OFF = X_OFF + XS * TILE;     // y staging for the TMA store
constexpr int S_OFF = Y_OFF + TILE;          // the state in bf16: 16 KB
constexpr int CB_OFF = S_OFF + 2 * ST_HALF;
// CB, fp32, each thread's 64 values apart ([wg][value pair][thread]: it
// reads back only what it wrote, a pair a load)
constexpr int F_OFF = CB_OFF + QT * TN * 4;  // cs, exp(cs), w, dt: [HG][QT]
constexpr int BAR_OFF = F_OFF + 4 * HG * QT * 4;
constexpr size_t TSMEM = 1024 + BAR_OFF + 8 * (XS + 1) + 16;
static_assert(TSMEM <= 232448, "over the 227 KB a block may use");
constexpr float LOG2E = 1.4426950408889634f;

struct TParams {
  const float* dt;           // [B,S,H]
  const float* A;            // [H]
  const float* init;         // [B,H,P,N] or null
  float* final_state;        // [B,H,P,N]
  float* slots;              // [2,B,H,P,N]
  int* flags;                // [B*H*8] chunks published per warp, then
                             // the ticket counter; zeroed
  int B, S, H, q, nc, ng;
};

// an fp32 pair as a bf16 hi pair and the bf16 pair of what hi leaves
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// Lane 0 of the warp spins until *flag >= target (backing off, so the
// blocks that wait do not crowd L2); the warp then goes on together.
// Traps after about 2^35 cycles (~17 s) instead of holding the card
// forever.
__device__ __forceinline__ void warp_wait_flag(const int* flag, int target,
                                               int lane) {
  if (lane == 0) {
    long long start = 0;
    while (ld_acquire_gpu(flag) < target) {
      __nanosleep(64);
      if (start == 0) {
        start = clock64();
      } else if (clock64() - start > (1ll << 35)) {
        __trap();
      }
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(TTHREADS, 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tcm,
                 const __grid_constant__ CUtensorMap ty, TParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sC = sm + C_OFF;
  uint8_t* sB = sm + B_OFF;
  uint8_t* sX = sm + X_OFF;
  uint8_t* sY = sm + Y_OFF;
  uint8_t* sS = sm + S_OFF;
  float* f_cs = reinterpret_cast<float*>(sm + F_OFF);
  float* f_ecs = f_cs + HG * QT;
  float* f_w = f_ecs + HG * QT;
  float* f_dt = f_w + HG * QT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
  int* s_ticket = reinterpret_cast<int*>(bars + XS + 1);

  const int tid = threadIdx.x;
  if (tid == 0) {
    *s_ticket = atomicAdd(p.flags + p.B * p.H * 8, 1);
    for (int i = 0; i <= XS; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int ticket = *s_ticket;
  const int c = ticket / (p.B * p.ng);
  const int rest = ticket - c * p.B * p.ng;
  const int b = rest / p.ng;
  const int h0 = (rest - b * p.ng) * HG;
  const int nh = min(HG, p.H - h0);
  const int t0 = c * p.q;
  const int qv = min(p.q, p.S - t0);         // valid rows of the chunk

  if (tid == 0) {
    tma_prefetch(&tx);
    tma_prefetch(&tb);
    tma_prefetch(&tcm);
    mbar_arrive_expect_tx(&bars[0], 4 * TILE);
    tma_load_4d(sC, &tcm, &bars[0], 0, 0, t0, b);
    tma_load_4d(sC + TILE, &tcm, &bars[0], 64, 0, t0, b);
    tma_load_4d(sB, &tb, &bars[0], 0, 0, t0, b);
    tma_load_4d(sB + TILE, &tb, &bars[0], 64, 0, t0, b);
    for (int k = 0; k < min(nh, XS); ++k) {
      mbar_arrive_expect_tx(&bars[1 + k], TILE);
      tma_load_4d(sX + k * TILE, &tx, &bars[1 + k], 0, h0 + k, t0, b);
    }
  }

  // dt of the group's heads (0 past the chunk's valid rows, so rows of
  // the next chunk or past S neither decay nor feed anything), then per
  // head a warp's scan of dt * A, exp(cs) and w_j
  for (int idx = tid; idx < HG * QT; idx += TTHREADS) {
    const int k = idx / QT, i = idx - k * QT;
    f_dt[idx] = (k < nh && i < qv)
                    ? p.dt[(static_cast<int64_t>(b) * p.S + t0 + i) * p.H +
                           h0 + k]
                    : 0.f;
  }
  __syncthreads();
  const int warp_all = tid / 32, lane = tid % 32;
  if (warp_all < nh) {
    const int k = warp_all;
    const float Ah = p.A[h0 + k];
    float v[4], run = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      run = __fadd_rn(run, __fmul_rn(f_dt[k * QT + 4 * lane + r], Ah));
      v[r] = run;
    }
    float incl = run;                        // inclusive scan of lane sums
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, u);
    }
    const float before = __shfl_up_sync(0xffffffffu, incl, 1);
    const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = k * QT + 4 * lane + r;
      const float cs = lane == 0 ? v[r] : __fadd_rn(before, v[r]);
      f_cs[i] = cs;
      f_ecs[i] = expf(cs);
      f_w[i] = __fmul_rn(f_dt[i], expf(last - cs));
    }
  }
  __syncthreads();

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int col = 2 * (lane % 4);
  const int r_lo = 64 * wg + 16 * warp + lane / 4;   // chunk rows r_lo, +8
  const int pr = 16 * warp + lane / 4;                // state rows pr, +8

  // CB = C B^T for this warpgroup's 64 rows, shared by the heads: kept in
  // shared memory, so that its 64 registers are free during the heads
  float2* f_cb = reinterpret_cast<float2*>(sm + CB_OFF) + wg * 32 * 128 +
                 tid % 128;
  {
  float cb[64];
  mbar_wait(&bars[0], 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TN / 16; ++kk) {
    const int off = (kk / 4) * TILE + (kk % 4) * 32;
    wgmma_m64n128k16_ss_bf16(cb,
                             desc_sw128(sC + off + 64 * wg * ROWB, 16, 1024),
                             desc_sw128(sB + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(cb);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    f_cb[i * 128] = make_float2(cb[2 * i], cb[2 * i + 1]);
  }

  const int64_t PN = static_cast<int64_t>(TP) * TN;
  const int64_t slot = static_cast<int64_t>(p.B) * p.H * PN;
  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k;
    const float* cs = f_cs + k * QT;
    const float* wv = f_w + k * QT;
    const float* dtv = f_dt + k * QT;
    const uint8_t* xs = sX + (k % XS) * TILE;
    mbar_wait(&bars[1 + k % XS], (k / XS) & 1);

    // y = W X, W rounded to bf16 from CB
    float yacc[32];
    {
      uint32_t wh[8][4];
      const float cs_r[2] = {cs[r_lo], cs[r_lo + 8]};
#pragma unroll
      for (int kj = 0; kj < 8; ++kj)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int t = 2 * kj + u, i = r_lo + 8 * r, j = 16 * kj + 8 * u + col;
            // CB, cs and dt of columns j, j + 1 as pairs (one load each)
            const float2 cbp = f_cb[(2 * t + r) * 128];
            const float2 csj = *reinterpret_cast<const float2*>(cs + j);
            const float2 dtj = *reinterpret_cast<const float2*>(dtv + j);
            const float cbv[2] = {cbp.x, cbp.y}, csv[2] = {csj.x, csj.y},
                        dtw[2] = {dtj.x, dtj.y};
            float w2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float L = exp2_approx((cs_r[r] - csv[e]) * LOG2E);
              w2[e] = i >= j + e
                          ? __fmul_rn(__fmul_rn(cbv[e], L), dtw[e])
                          : 0.f;
            }
            wh[kj][2 * u + r] = pack_bf16(w2[0], w2[1]);
          }
      wgmma_fence();
#pragma unroll
      for (int kj = 0; kj < 8; ++kj) {
        const uint64_t dx = desc_sw128(xs + kj * 16 * ROWB, TILE, 1024);
        wgmma_m64n64k16_rs_bf16_tb(yacc, wh[kj], dx, kj > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(yacc);
    }

    // contrib[p][n] for n in 64wg .. 64wg + 63: (X o w)^T B
    float contrib[32];
    {
      uint32_t xh[8][4], xl[8][4];
      const int m = lane / 8;
#pragma unroll
      for (int kj = 0; kj < 8; ++kj) {
        const int j = 16 * kj + (m >= 2 ? 8 : 0) + lane % 8;
        const int ch = 2 * warp + (m & 1);
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, xs + j * ROWB + ((ch ^ (j & 7)) << 4));
        const int j0 = 16 * kj + col;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = j0 + (e >= 2 ? 8 : 0);
          const float2 xv = bf16x2_to_float2(r4[e]);
          split_pair(__fmul_rn(xv.x, wv[jj]), __fmul_rn(xv.y, wv[jj + 1]),
                     xh[kj][e], xl[kj][e]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kj = 0; kj < 8; ++kj) {
        const uint64_t db =
            desc_sw128(sB + wg * TILE + kj * 16 * ROWB, TILE, 1024);
        wgmma_m64n64k16_rs_bf16_tb(contrib, xh[kj], db, kj > 0);
        wgmma_m64n64k16_rs_bf16_tb(contrib, xl[kj], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(contrib);
    }

    // the state entering the chunk: chunk c - 1's outgoing state (chunk
    // 0: init_state or zeros).  Both warpgroups are past the previous
    // head's C state^T before the state tile is rewritten.
    const int64_t bh = static_cast<int64_t>(b) * p.H + h;
    if (tid == 0) bulk_wait_read();        // y staging free again
    __syncthreads();
    // X of head k is read: its slot takes head k + XS
    if (tid == 0 && k + XS < nh) {
      mbar_arrive_expect_tx(&bars[1 + k % XS], TILE);
      tma_load_4d(sX + (k % XS) * TILE, &tx, &bars[1 + k % XS], 0,
                  h0 + k + XS, t0, b);
    }
    // this warp's part of the state was written by the same warp of
    // chunk c - 1's block, which raised its flag after
    int* flag = p.flags + bh * 8 + tid / 32;
    const float* s_in = c == 0 ? p.init
                               : p.slots + ((c - 1) & 1) * slot + bh * PN;
    if (c == 0 && s_in != nullptr) s_in += bh * PN;
    if (c > 0) warp_wait_flag(flag, c, lane);
    float2 si[8][2];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        si[t][r] = s_in == nullptr
                       ? make_float2(0.f, 0.f)
                       : __ldcg(reinterpret_cast<const float2*>(
                             s_in + (pr + 8 * r) * TN + 64 * wg + 8 * t +
                             col));
    // the outgoing state for chunk c + 1, then this warp's flag (first:
    // the next chunk's block waits for it), or the final state
    const float decay = expf(cs[QT - 1]);
    const bool last = c == p.nc - 1;
    float* s_out = last ? p.final_state + bh * PN
                        : p.slots + (c & 1) * slot + bh * PN;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pp = pr + 8 * r, n = 64 * wg + 8 * t + col;
        const float2 so = make_float2(
            __fadd_rn(__fmul_rn(si[t][r].x, decay), contrib[4 * t + 2 * r]),
            __fadd_rn(__fmul_rn(si[t][r].y, decay),
                      contrib[4 * t + 2 * r + 1]));
        __stcg(reinterpret_cast<float2*>(s_out + pp * TN + n), so);
      }
    if (!last) {
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release_gpu(flag, c + 1);
    }
    // the entering state in bf16 as C state^T's operand
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pp = pr + 8 * r;
        const int at = wg * ST_HALF + pp * ROWB + ((t ^ (pp & 7)) << 4) +
                       col * 2;
        *reinterpret_cast<uint32_t*>(sS + at) =
            pack_bf16(si[t][r].x, si[t][r].y);
      }
    fence_proxy_async();
    __syncthreads();

    // y += exp(cs_i) (C state^T)
    float yi[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TN / 16; ++kk) {
      const int off = (kk / 4) * TILE + (kk % 4) * 32;
      const uint64_t da = desc_sw128(sC + off + 64 * wg * ROWB, 16, 1024);
      const int so = (kk / 4) * ST_HALF + (kk % 4) * 32;
      wgmma_m64n64k16_ss_bf16(yi, da, desc_sw128(sS + so, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yi);
    // y into the staging tile (the previous head's store has read it) in
    // the 128-byte swizzle, then one TMA store of the chunk's q rows (rows
    // past S are not written)
    uint8_t* ys = sY;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r_lo + 8 * r;
      const float e = f_ecs[k * QT + i];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        *reinterpret_cast<uint32_t*>(ys + i * ROWB + ((t ^ (i & 7)) << 4) +
                                     col * 2) = pack_bf16(
            __fadd_rn(yacc[4 * t + 2 * r], __fmul_rn(e, yi[4 * t + 2 * r])),
            __fadd_rn(yacc[4 * t + 2 * r + 1],
                      __fmul_rn(e, yi[4 * t + 2 * r + 1])));
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      tma_store_4d(&ty, ys, 0, h, t0, b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();
}

// a [.., S, rows, cols] bf16 view as a 4-D tensor map: dims (cols, rows,
// S, B), strides in elements for rows, S and B; boxes of 64 columns x 1
// row x `tokens` tokens, the 128-byte swizzle; TMA zero-fills past S on
// loads and leaves it unwritten on stores
inline int view_map(CUtensorMap* map, const void* base, int cols, int rows,
                    int S, int B, long long row_stride, long long s_stride,
                    long long b_stride, int tokens = QT) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * row_stride, 2ull * s_stride,
                                 2ull * b_stride};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(tokens), 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                      strides, box);
}

template <typename Kern>
int launch_wgmma(Kern kern, const CUtensorMap& tx, const CUtensorMap& tb,
                 const CUtensorMap& tcm, const CUtensorMap& ty,
                 const TParams& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(TSMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = static_cast<long long>(p.B) * p.nc * p.ng;
  kern<<<static_cast<unsigned>(blocks), TTHREADS, TSMEM, stream>>>(
      tx, tb, tcm, ty, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y alike; dt, A,
// init_state, the scratch and the final state are float32).  Strides are
// in elements.  states: scratch of B*H*nc*P*N floats, decay: B*H*nc.
// Returns 0, a cudaError_t code, or -1 / -2 / -3 for an unsupported
// (P, N) / dtype / shape.  Launches on `stream`; never synchronises.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init_state, void* y, void* states,
    void* decay, void* final_state, int B, int S, int H, int P, int N,
    int q, long long x_bs, long long x_ts, long long b_bs, long long b_ts,
    long long c_bs, long long c_ts, int dtype, void* stream) {
  if (q <= 0 || q > QT || B <= 0 || S <= 0 || H <= 0 || B > 65535 ||
      H > 65535 || static_cast<long long>(B) * H > 65535)
    return -3;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
         Bm, Cm, static_cast<const float*>(init_state), y,
         static_cast<float*>(states), static_cast<float*>(decay),
         static_cast<float*>(final_state), B, S, H, q, (S + q - 1) / q,
         x_bs, x_ts, b_bs, b_ts, c_bs, c_ts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128) return launch_t<64, 128>(a, dtype, s);
  if (P == 64 && N == 16) return launch_t<64, 16>(a, dtype, s);
  if (P == 16 && N == 16) return launch_t<16, 16>(a, dtype, s);
  return -1;
}

// The tensor-core kernel (bf16 x, Bm, Cm at (P, N) = (64, 128)): the
// arguments of ssd_scan_launch without P, N and dtype, and instead of the
// chunk-state scratch: slots, 2*B*H*P*N floats, and flags, B*H*8 + 1
// ints set to 0 (the chain's per-warp flags and the ticket counter).  The
// views' strides must be multiples of 8 elements and their bases 16-byte
// aligned (TMA).  Returns 0, a cudaError_t code, -3 for the shape or -4
// when a tensor map cannot be encoded.
extern "C" int ssd_scan_wgmma_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init_state, void* y, void* final_state,
    void* slots, void* flags, int B, int S, int H, int q, long long x_bs,
    long long x_ts, long long b_bs, long long b_ts, long long c_bs,
    long long c_ts, void* stream) {
  if (q <= 0 || q > QT || B <= 0 || S <= 0 || H <= 0) return -3;
  const int nc = (S + q - 1) / q;
  tc::TParams p{static_cast<const float*>(dt), static_cast<const float*>(A),
                static_cast<const float*>(init_state),
                static_cast<float*>(final_state),
                static_cast<float*>(slots), static_cast<int*>(flags), B, S,
                H, q, nc,
                (H + tc::HG - 1) / tc::HG};
  // y [B, S, H, P] contiguous, stored a chunk of q rows a box
  CUtensorMap tx, tb, tcm, ty;
  if (tc::view_map(&tx, x, tc::TP, H, S, B, tc::TP, x_ts, x_bs) ||
      tc::view_map(&tb, Bm, tc::TN, 1, S, B, tc::TN, b_ts, b_bs) ||
      tc::view_map(&tcm, Cm, tc::TN, 1, S, B, tc::TN, c_ts, c_bs) ||
      tc::view_map(&ty, y, tc::TP, H, S, B, tc::TP,
                   static_cast<long long>(H) * tc::TP,
                   static_cast<long long>(S) * H * tc::TP, q))
    return -4;
  return tc::launch_wgmma(tc::ssd_wgmma_kernel, tx, tb, tcm, ty, p,
                          static_cast<cudaStream_t>(stream));
}

extern "C" const char* ssd_scan_error_string(int code) {
  switch (code) {
    case -1: return "unsupported (P, N): (64, 128), (64, 16) or (16, 16)";
    case -2: return "unsupported dtype (float32 or bfloat16)";
    case -3: return "unsupported shape (chunk length 1-128, B * H <= 65535)";
    case -4: return "tensor map encoding failed (alignment of the views' "
                    "bases or strides, or no cuTensorMapEncodeTiled)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
