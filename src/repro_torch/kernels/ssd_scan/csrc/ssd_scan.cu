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
// in turn at S = 32,768.  So the scan runs as the SSD's three-pass form,
// all three launched by one call:
//   1. chunk_state, grid (NC, H, B): cs, the chunk's own state
//      contribution (B o dt o exp(cs_last - cs))^T X [P,N] and its decay
//      exp(cs_last), written to fp32 scratch [B,H,NC,P,N] / [B,H,NC];
//   2. state_pass, grid (P*N / 256, B*H): one thread per state element
//      walks the chunks in order, replacing each chunk's contribution in
//      place by the state ENTERING that chunk, and writes the final
//      state;
//   3. chunk_out, grid (NC, H, B): C B^T, the masked decay weights W,
//      W X and (C o exp(cs)) @ entering^T, summed and stored.
// Every product accumulates in fp32 on the CUDA cores (tiles widened to
// fp32 in shared memory, register tiles of 8 x 8 / 8 x P/16 per thread).
// x, B and C are read in the model layout in place (batch and token
// strides given; (h, p) and n contiguous), not through the TPU wrapper's
// transposes.  exp(cs_i - cs_j) is evaluated only where i >= j (above
// the diagonal it can overflow, and inf * 0 is NaN), and the terms keep
// the reference's forms: C o exp(cs) and B o (dt o exp(cs_last - cs)),
// with separately rounded products where the reference rounds them.
// The chunk length is a run-time q <= 128 (tiles are 128 rows, rows past
// q are zero); (P, N) are compile-time.
//
// Bound at the chip check's shape (mamba2-780m at full width: B = 2,
// S = 32,768, H = 48, P = 64, N = 128, q = 128, NC = 256, bf16 x/B/C):
// 854.6 MB of x, y, dt, B, C and the final state, 0.255 ms at 3.35 TB/s.
// The function needs, per (b, chunk), the lower triangle of C B^T
// (q(q+1)N, B and C being shared by the heads) and per (b, h, chunk)
// the triangle of W X (q(q+1)P) plus 4qNP for the inter-chunk output
// and the chunk state: 130.1 GFLOP, 0.132 ms at the 989 TFLOP/s bf16
// tensor-core peak.  So the bound is bytes, 0.255 ms.
// This simple design runs on the fp32 CUDA cores (67 TFLOP/s peak),
// computes the full Q x Q products, recomputes C B^T for every head,
// and writes / reads the 805 MB of fp32 entering states once.  wgmma
// on bf16 tiles, one C B^T per (b, chunk) shared by the heads, and the
// state pass fused into a chunk-ordered persistent kernel are work for
// a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
  if (P == 16 && N == 16) return launch_t<16, 16>(a, dtype, s);
  return -1;
}

extern "C" const char* ssd_scan_error_string(int code) {
  switch (code) {
    case -1: return "unsupported (P, N): (64, 128) or (16, 16)";
    case -2: return "unsupported dtype (float32 or bfloat16)";
    case -3: return "unsupported shape (chunk length 1-128, B * H <= 65535)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
