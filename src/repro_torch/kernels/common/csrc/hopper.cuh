// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// mbarriers, clusters (ranks, barriers, remote arrivals and stores), TMA
// tiled loads (also multicast to a cluster's blocks) and stores, wgmma
// shared-memory descriptors and the
// wgmma.mma_async shapes the kernels use, e4m3 tiles widened to bf16 in
// the swizzled layout wgmma reads, ldmatrix / movmatrix / mma.sync for
// warp-level products, named barriers, register re-allocation between
// warpgroups, and, on the host,
// cuTensorMapEncodeTiled through the runtime's driver entry point (so a
// library needs no -lcuda link).
//
// The conventions every user of this header follows:
//   * a tile that wgmma reads is written with the 128-byte swizzle (by
//     TMA, or by threads widening an e4m3 tile) and starts on a 1024-byte
//     boundary of shared memory: rows of 128 bytes (64 bf16 values),
//     eight rows to a 1024-byte atom (a tile of 16-value rows: the
//     32-byte swizzle, `desc_sw32`; of 32-value rows: the 64-byte
//     swizzle, `desc_sw64`);
//   * a "full" barrier per ring stage is armed by the producer with the
//     stage's byte count (arrive.expect_tx) and completes when TMA has
//     written them; an "empty" barrier per stage completes when every
//     consumer warp has arrived on it after its last wgmma on the stage;
//   * both sides track one phase bit per pass over the ring: consumers
//     wait "full" with it, the producer waits "empty" with its inverse
//     (so its first pass over the ring does not wait).
#pragma once

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; follow it with a block-wide barrier
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to the phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// spins until the phase of parity `parity` has completed (acquire: what
// the arriving threads wrote before arriving is visible afterwards).  A
// phase that never completes (a fault in a kernel's ring) traps after
// about 2^35 cycles (~17 s) instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
  }
}

// ---- clusters -------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster arrives, then waits for the
// others (release / acquire at cluster scope): after the barriers are
// initialised, and before a block whose shared memory the others write
// or arrive on may exit
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the shared::cluster address of `p`'s offset in block `cta` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_u32(p)), "r"(cta));
  return r;
}

// one arrival on the barrier at `bar`'s offset in block `cta`, a signal
// only (release at CTA scope, as for a local arrival): enough where what it
// releases is shared memory that this thread's wgmmas have finished
// reading; far cheaper than the cluster-scope release below
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t cta) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n"
               :: "r"(cluster_addr(bar, cta)) : "memory");
}

// one arrival on the barrier at `bar`'s offset in block `cta` (release at
// cluster scope: what this thread wrote before, st_cluster included, is
// visible to its waiters in mbar_wait_cluster)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(cluster_addr(bar, cta)) : "memory");
}

// v at `p`'s offset in block `cta`'s shared memory
__device__ __forceinline__ void st_cluster(int* p, int v, uint32_t cta) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n"
               :: "r"(cluster_addr(p, cta)), "r"(v) : "memory");
}

// mbar_wait with acquire at cluster scope: what another block of the
// cluster wrote before arriving (mbar_arrive_cluster) is visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
  }
}

// ---- TMA ------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// one box of a 2-D tensor map into shared memory; completion is counted
// in bytes on `bar`.  Coordinates are elements, innermost first; parts
// of the box outside the tensor are written as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// tma_load_4d into the shared memory of every block of the cluster in
// `mask` (bit i: block i), at dst's offset in each, the completion counted
// on the barrier at bar's offset in each
__device__ __forceinline__ void tma_load_4d_multicast(
    void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
    int c3, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "h"(mask)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into shared
// memory, both ends 16-byte aligned; completion is counted in bytes on
// `bar`, as for a tensor-map load
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)),
         "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one box of a 4-D tensor map from shared memory to global memory (the
// parts of the box outside the tensor are not written); a bulk group:
// commit, then wait before the shared memory is written again
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until every committed bulk store has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// waits until every committed bulk store has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// orders this thread's generic-proxy writes to shared memory (plain
// stores) before later async-proxy reads of them (wgmma operands); place
// before the arrive that releases the tile to its readers
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- softmax arithmetic ------------------------------------------------------

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to a bf16 pair (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- e4m3 -> bf16 in shared memory -------------------------------------------

// 16 e4m3 values (16 bytes) widened to bf16: lo holds values 0-7, hi
// 8-15.  Exact: every e4m3 value, NaN included, is a bf16 value.  (An
// integer form with one bf16 multiply, tried on an H100, was slower than
// these conversion instructions.)
__device__ __forceinline__ void widen_e4m3x16(uint4 in, uint4& lo, uint4& hi) {
  const __nv_fp8x2_e4m3* p = reinterpret_cast<const __nv_fp8x2_e4m3*>(&in);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = static_cast<float2>(p[i]);
    w[i] = pack_bf16(f.x, f.y);
  }
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

// Which 16-byte chunk j of which row a thread widens, for tiles of
// 128-byte rows (8 chunks): chunk number idx goes to j = idx % 8 of one
// of two rows, so that the 8 threads of a quarter warp read 8 distinct
// chunks of the unswizzled e4m3 rows and write 8 distinct 16-byte bank
// groups of the swizzled bf16 boxes (rows of opposite parity take
// opposite halves of the swizzle): no bank is met twice.
__device__ __forceinline__ void chunk_of(int idx, int& row, int& j) {
  j = idx & 7;
  row = ((idx >> 4) << 1) | (((idx >> 2) ^ (idx >> 3)) & 1);
}

// Stores bf16 columns 16j .. 16j+15 of row `row` (lo: the first 8, hi:
// the last 8) into a tile kept as 64-column boxes of 128-byte rows in
// the 128-byte swizzle (box b of the tile at tile + b * box_bytes, each
// box on a 1024-byte boundary): the layout TMA writes and wgmma reads.
__device__ __forceinline__ void st_sw128_bf16x16(uint8_t* tile, int box_bytes,
                                                 int row, int j, uint4 lo,
                                                 uint4 hi) {
  uint8_t* r = tile + (j >> 2) * box_bytes + row * 128;
  const int c = 2 * (j & 3), x = row & 7;
  *reinterpret_cast<uint4*>(r + ((c ^ x) << 4)) = lo;
  *reinterpret_cast<uint4*>(r + (((c + 1) ^ x) << 4)) = hi;
}

// ---- named barriers (ids 1-15; 0 is __syncthreads) ---------------------------

// waits until `threads` threads (a multiple of 32) have reached barrier
// `id` by a sync or an arrive
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
// counts this thread at barrier `id` without waiting
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- warpgroup register re-allocation ----------------------------------------

// executed by all four warps of a warpgroup together, on both sides of a
// branch that never reconverges
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle
// (layout type 1 in bits 62-63).  Addresses and byte offsets are encoded
// in 16-byte units: start address in bits 0-13, the leading byte offset
// (LBO) in 16-29, the stride byte offset (SBO) in 32-45.
//   K-major (K contiguous, one 128-byte row per M/N index): SBO = 1024,
//     the step between 8-row atoms; LBO is unused.  A k-step inside the
//     128-byte row moves the start address by its bytes (32 for k16 in
//     bf16): the swizzle is a function of the address.
//   MN-major (M/N contiguous, one 128-byte row per K index; bf16 only):
//     SBO = 1024, the step between groups of 8 K rows; LBO = the step
//     between 64-wide M/N column blocks.
__device__ __forceinline__ uint64_t desc_sw128(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (uint64_t(1) << 62);
}

// The same descriptor for a tile in the 64-byte swizzle (layout type 2):
// rows of 64 bytes (32 bf16 values), the four 16-byte chunks of a row
// permuted by address bits 7-8 within each eight-row, 512-byte atom (what
// TMA's CU_TENSOR_MAP_SWIZZLE_64B writes).
//   K-major (one 64-byte row per M/N index): SBO = 512, the step between
//     8-row atoms; LBO is unused; a k16 step moves the start by 32 bytes.
//   MN-major (one 64-byte row per K index, 32 M/N values; bf16 only):
//     SBO = 512, the step between groups of 8 K rows; LBO = the step
//     between 32-wide M/N column blocks.
__device__ __forceinline__ uint64_t desc_sw64(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (uint64_t(2) << 62);
}

// The same descriptor for a tile in the 32-byte swizzle (layout type 3):
// rows of 32 bytes (16 bf16 values), the two 16-byte halves of a row
// swapped in rows 4-7 of each eight-row, 256-byte atom (address bit 4
// XOR bit 7).
//   K-major (one 32-byte row per M/N index, a k16 step the whole row):
//     SBO = 256, the step between 8-row atoms; LBO is unused.
//   MN-major (one 32-byte row per K index, 16 M/N values; bf16 only):
//     SBO = 256, the step between groups of 8 K rows; LBO = the step
//     between 16-wide M/N column blocks.
__device__ __forceinline__ uint64_t desc_sw32(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (uint64_t(3) << 62);
}

// orders register and shared-memory writes before the next wgmma reads
// them (accumulators or register A fragments changed by other code)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// pins registers that an in-flight wgmma writes: the compiler may not move
// their reads or writes across this point (place after wgmma_wait and
// before a wgmma that accumulates into them)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// The shapes in use.  D (fp32, m64nN: N/2 values per thread) is laid out
// as in mma.sync's C fragment, repeated over N/8 column blocks: thread t
// of the warpgroup (warp w = t/32, lane l = t%32) holds rows
// 16w + l/4 (d[4j], d[4j+1]) and 16w + l/4 + 8 (d[4j+2], d[4j+3]), at
// columns 8j + 2(l%4) and 8j + 2(l%4) + 1.  A register A fragment (bf16,
// m64k16) is four 32-bit registers per thread with the same row/column
// rule over the 16 columns (a[0]: row l/4, columns 2(l%4)..+1; a[1]: row
// +8; a[2]: columns +8; a[3]: both), so an m64nN accumulator rounded to
// bf16 pairs is the A operand of the next product, 16 columns at a time.
// scale_d = 0 overwrites D; 1 accumulates.

// bf16 x bf16 -> fp32, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss_bf16(float (&d)[64], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// bf16 x bf16 -> fp32, A K-major and B MN-major in shared memory
// (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n128k16_ss_bf16_tb(float (&d)[64],
    uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// bf16 x bf16 -> fp32, A in registers, B MN-major in shared memory
// (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n128k16_rs_bf16_tb(float (&d)[64],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n96k16_rs_bf16_tb(float (&d)[48],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}


// bf16 x bf16 -> fp32, m64n64: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss_bf16(float (&d)[32],
    uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// bf16 x bf16 -> fp32, m64n64: A in registers, B MN-major in shared
// memory (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64k16_rs_bf16_tb(float (&d)[32],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// bf16 x bf16 -> fp32, m64n16: A in registers, B MN-major in shared
// memory (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n16k16_rs_bf16_tb(float (&d)[8],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// ---- warp-level tensor-core operands and mma.sync ----------------------------

// four 8x8 b16 matrices from shared memory (lane i gives the address of
// row i % 8 of matrix i / 8); thread t receives row t / 4, b16 columns
// 2(t % 4) and 2(t % 4) + 1 of each, or of its transpose with .trans
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// an 8x8 b16 matrix held one row per 4 lanes (thread t: row t / 4,
// columns 2(t % 4), +1) transposed in registers
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// d += a b, m16n8k16, bf16 in, fp32 out (mma.sync fragment layouts:
// a[0] row t/4, columns 2(t%4)..+1; a[1] row +8; a[2] columns +8;
// a[3] both; b[0] rows (k) 2(t%4)..+1 of column t/4, b[1] rows +8;
// d[0..1] row t/4, columns 2(t%4)..+1, d[2..3] row +8)
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two e4m3 values (the low 16 bits of x) widened to a bf16 pair, exact
__device__ __forceinline__ uint32_t widen_e4m3x2(uint32_t x) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(x & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return pack_bf16(f.x, f.y);
}

// ---- host -----------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, looked up once through the
// runtime (no link against libcuda); null when the driver lacks it.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// A tiled tensor map with zero fill outside the tensor, in the 128-byte
// swizzle (what wgmma reads) unless another is asked for (a staging tile
// that plain loads read: CU_TENSOR_MAP_SWIZZLE_NONE, rows of the box's
// inner bytes back to back).  dims and box innermost first; strides in
// bytes for dims 1..rank-1.  Returns 0, or a nonzero CUresult (-1000
// without the driver entry point).
inline int encode_tiled(CUtensorMap* map, CUtensorMapDataType dtype,
                        uint32_t rank, const void* base,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box,
                        CUtensorMapSwizzle swizzle =
                            CU_TENSOR_MAP_SWIZZLE_128B) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return -1000;
  cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  CUresult r = encode(map, dtype, rank, const_cast<void*>(base), dims,
                      strides, box, elem_strides,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return static_cast<int>(r);
}

}  // namespace hopper
