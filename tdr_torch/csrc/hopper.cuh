// Hopper (sm_90a) plumbing shared by the port's wgmma kernels
// (fused_head.cu, fused_flat.cu): mbarriers, TMA and cp.async loads that
// complete on an mbarrier, wgmma descriptors and instructions, setmaxnreg,
// the tensor-map encoder, and the ring geometry and group-of-8 epilogue the
// two kernels share.  Raw PTX, so a source that includes it builds in
// seconds.
//
// The ring: persistent CTAs of 384 threads.  Warpgroup 0 is the producer
// (it gives up registers); warpgroups 1 and 2 are consumers, each owning 64
// query rows of a 128-query x 256-document output tile with a
// wgmma m64n256 accumulator (128 f32 or s32 registers a thread).  Each
// shared-memory stage holds one 128-byte-deep slice of both operands under
// the 128-byte swizzle: A, 128 rows x 128 B (16 KB, K-major) and B, 256
// documents x 128 B (32 KB), K-major for fused_flat (E is documents-major)
// or MN-major for fused_head (the head is documents-contiguous), stored as
// four 64-document blocks of 64 depth rows.  A stage is full when its bytes
// have landed (TMA transaction count, or cp.async arrivals) and empty when
// every consumer warp has released it.  The producer runs ahead across
// tiles, so one tile's epilogue overlaps the next tile's loads.  A kernel
// whose CTA keeps one query tile may instead hold that tile's whole depth
// of A resident (up to kResidentSlices slices, loaded once on the `qfull`
// barrier) and ring B alone through the bytes left (resident_stages): the
// same shared memory either way.  The f32 bodies (3xTF32, documents on M)
// have a ring and an epilogue of their own, in the section below
// `f32 operands on the tensor cores`.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kThreads = 384;          // producer warpgroup + 2 consumers
constexpr int kTileM = 128;            // queries per tile
constexpr int kTileN = 256;            // documents per tile
constexpr int kSliceBytes = 128;       // depth of one stage, in bytes
constexpr int kStages = 4;
constexpr int kABytes = kTileM * kSliceBytes;     // 16 KB
constexpr int kBBytes = kTileN * kSliceBytes;     // 32 KB
// Per consumer warpgroup, two tiles' worth (double-buffered by tile) of
// per-document epilogue operands: 256 bias and 256 scale floats.
constexpr int kSideFloats = 2 * kTileN;
constexpr int kSideBytes = 2 * 2 * kSideFloats * 4;               // 8 KB
// A resident A slab of kt slices leaves the B ring the rest of the ring's
// bytes: 4 stages up to 4 slices (512 bytes of depth a row), 3 stages at 5
// or 6 (768 bytes: D = 384 bf16), the most the slab may hold.
constexpr int kRingBytes = kStages * (kABytes + kBBytes);
constexpr int kResidentSlices = 6;
__host__ __device__ constexpr int resident_stages(int kt) {
  return (kRingBytes - kt * kABytes) / kBBytes < kStages
             ? (kRingBytes - kt * kABytes) / kBBytes
             : kStages;
}
static_assert(resident_stages(kResidentSlices) >= 2,
              "the resident slab must leave a ring");
constexpr int kSmemBytes = kRingBytes + kSideBytes
                           + (2 * kStages + 1) * 8 + 1024;  // + barriers, alignment
constexpr int kConsumerWarps = 8;      // arrivals that empty a stage

struct Ring {
  uint8_t* a;          // a_bytes (A stages, or the resident slab), 1024-aligned
  uint8_t* b;          // B stages of kBBytes
  float* side;         // [consumer warpgroup][tile parity][kSideFloats]
  uint64_t* full;      // kStages
  uint64_t* empty;     // kStages
  uint64_t* qfull;     // 1: the resident slab has landed
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// a_bytes: kStages x kABytes for a ring of both operands, or the resident
// slab; B takes b_stages stages after it.
__device__ __forceinline__ Ring carve_ring(uint8_t* raw,
                                           int a_bytes = kStages * kABytes,
                                           int b_stages = kStages) {
  uint8_t* base = (uint8_t*)(((uintptr_t)raw + 1023) & ~(uintptr_t)1023);
  Ring r;
  r.a = base;
  r.b = base + a_bytes;
  r.side = (float*)(r.b + b_stages * kBBytes);
  r.full = (uint64_t*)((uint8_t*)r.side + kSideBytes);
  r.empty = r.full + kStages;
  r.qfull = r.empty + kStages;
  return r;
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

// ---- loads -----------------------------------------------------------------

// 2-D TMA load of one box into shared memory, completing on `bar`.
// c0 is the innermost (contiguous) coordinate, in elements.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// 16-byte cp.async; src_bytes = 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Barrier among `count` threads (a warpgroup: 128) on hardware barrier id.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A consumer warpgroup's start of a tile: its 128 threads copy the tile's
// 256 floats of `v0` (and of `v1`, if given) from document n0 on into `side`
// (zeros past N) with cp.async.  wait_side() before reading them.
__device__ __forceinline__ void load_side(float* side, const float* v0,
                                          const float* v1, int n0, int N) {
  const int c = threadIdx.x % 128;         // 16-byte chunk: 64 per vector
  const float* v = c < 64 ? v0 : v1;
  if (v != nullptr) {
    const int n = n0 + (c & 63) * 4;
    const bool ok = n < N;                  // N is a multiple of 64
    cp_async16(smem_u32(side + c * 4), ok ? (const void*)(v + n)
                                          : (const void*)v0, ok ? 16 : 0);
  }
  cp_async_commit();
}

// Waits for this thread's side copies, then for the warpgroup's (barrier
// 1 + w), so every thread sees the whole tile's operands.
__device__ __forceinline__ void wait_side(int w) {
  cp_async_wait_all();
  named_barrier(1 + w, 128);
}

// Arrive on `bar` once every cp.async this thread issued so far has landed;
// the arrival is one of those counted by mbar_init.
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Orders generic-proxy shared-memory writes (cp.async) before the async
// proxy's reads (wgmma) that follow in this thread.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- warpgroup registers and wgmma ------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers are written behind its back).
__device__ __forceinline__ void fence_operands(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operands(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor for the 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, each in 16-byte units.
//  K-major (rows of 128 B of depth): LBO unused (1), SBO = 1024 B, the step
//    from one group of 8 rows to the next; a k step adds its bytes of depth
//    (32 B) to the start address inside the swizzle atom.
//  MN-major (rows of 64 documents, 128 B, one per depth index): LBO = the
//    step from one 64-document block to the next, SBO = 1024 B, the step from
//    one group of 8 depth rows to the next; a k16 step adds 16 rows (2 KB).
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
         | (uint64_t)1 << 62;
}

// D += A * B over 16 (bf16) or 32 (s8) of depth: A 64 x K from shared
// memory (K-major), B K x 256 (kTransB = 0: K-major, 1: MN-major).  D is the
// warpgroup's 64 x 256 accumulator, 128 registers a thread.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16_bf16(float (&d)[128],
                                                      uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %130;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
      "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
      "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
      "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
      "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
      "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
      "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
      "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db));
}

// D += A * B over 8 of tf32 depth: A 64 x 8 from registers (this thread's
// four .b32 elements of the PTX ISA's m64nNk8 A fragment, low 13 bits
// zero), B 8 x 128 from shared memory (K-major).  D is the warpgroup's
// 64 x 128 f32 accumulator, 64 registers a thread; acc_d = 0 overwrites it
// instead of adding.  tf32 has no transpose bit: both operands are
// K-major.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db, int acc_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc_d));
}

// ---- the group-of-8 epilogue ------------------------------------------------

// Stores the group-of-8 maxima of one warpgroup's m64n256 accumulator tile.
// score(i, e) is the f32 score of accumulator element 4i + e, which is (PTX
// ISA, wgmma register fragment of D) row 16 * warp + lane / 4 + 8 * (e >> 1)
// and column 8i + 2 * (lane % 4) + (e & 1) of the warpgroup's 64 x 256
// tile.  So group i (columns 8i .. 8i + 7) lies in the four lanes of a quad,
// two columns each: a pair max in the thread, then a reduce-scatter over the
// quad (two shuffle rounds, 24 shuffles a row instead of 64) leaves lane j
// holding groups 16k + 4j + u (k = 0, 1; u = 0..3), which it stores as two
// 16-byte stores a row; a quad writes 64 contiguous bytes.  q_lo is the
// global row of e = 0, 1; g0 the tile's first group; groups at or past ng
// (a ragged last tile) are not stored.  ng is a multiple of 4.
template <typename Score>
__device__ __forceinline__ void store_group_max(Score score, float* out, int ng,
                                                int q_lo, int g0) {
  const int lane = threadIdx.x & 31;
  const int j = lane & 3;
  const bool b1 = (j & 2) != 0, b0 = (j & 1) != 0;
  float lo[32], hi[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    lo[i] = fmaxf(score(i, 0), score(i, 1));
    hi[i] = fmaxf(score(i, 2), score(i, 3));
  }
  // round 1, partner lane ^ 2: keep the groups whose j has this lane's bit 1
  float alo[16], ahi[16];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int j0 = 0; j0 < 2; ++j0)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = k * 8 + j0 * 4 + u;
        const int g_lo = 16 * k + 4 * j0 + u, g_hi = g_lo + 8;
        const float kl = b1 ? lo[g_hi] : lo[g_lo], sl = b1 ? lo[g_lo] : lo[g_hi];
        const float kh = b1 ? hi[g_hi] : hi[g_lo], sh = b1 ? hi[g_lo] : hi[g_hi];
        alo[p] = fmaxf(kl, __shfl_xor_sync(0xffffffffu, sl, 2));
        ahi[p] = fmaxf(kh, __shfl_xor_sync(0xffffffffu, sh, 2));
      }
  // round 2, partner lane ^ 1: keep the groups whose j has this lane's bit 0
  float rlo[8], rhi[8];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p0 = k * 8 + u, p1 = p0 + 4;
      const float kl = b0 ? alo[p1] : alo[p0], sl = b0 ? alo[p0] : alo[p1];
      const float kh = b0 ? ahi[p1] : ahi[p0], sh = b0 ? ahi[p0] : ahi[p1];
      rlo[k * 4 + u] = fmaxf(kl, __shfl_xor_sync(0xffffffffu, sl, 1));
      rhi[k * 4 + u] = fmaxf(kh, __shfl_xor_sync(0xffffffffu, sh, 1));
    }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int g = g0 + 16 * k + 4 * j;
    if (g < ng) {
      *reinterpret_cast<float4*>(out + (size_t)q_lo * ng + g) = make_float4(
          rlo[4 * k], rlo[4 * k + 1], rlo[4 * k + 2], rlo[4 * k + 3]);
      *reinterpret_cast<float4*>(out + (size_t)(q_lo + 8) * ng + g) =
          make_float4(rhi[4 * k], rhi[4 * k + 1], rhi[4 * k + 2],
                      rhi[4 * k + 3]);
    }
  }
}

// ---- f32 operands on the tensor cores: 3xTF32 --------------------------------
//
// The f32 bodies of fused_head.cu and fused_flat.cu.  A tf32 operand keeps
// 10 of f32's 23 mantissa bits, so one TF32 product is off by up to 2^-11
// of |x y|.  Split each f32 operand x into big = tf32(x) and small =
// tf32(x - big), both rounded to nearest (cvt.rna; x - big is exact in
// f32), and sum big*big + big*small + small*big in f32: |x - big - small|
// <= 2^-22 |x|, and the dropped small*small is below 2^-22 |x y|, so each
// product is within about 2^-21 of |x y|.  BM25 head entries and query
// weights are non-negative (K2's sums do not cancel: rtol about 1e-6);
// K3's inner products of unit vectors err by about 1e-6 absolute.
//
// wgmma takes tf32 from shared memory only K-major (the transpose bit
// exists for 16-bit types), and the head is documents-contiguous.  So
// documents go on M, with A read from the landed stage into registers
// (any layout will do) and split there (two cvt.rna and a subtraction, no
// second tile), and queries on N, with B = the query operand by TMA,
// split by the wrapper before the launch and stacked as (2 Qp, D) f32:
// big rows, then small rows.  Both are K-major as stored.  The products
// of each 32-deep slice are summed apart and added in with f32 adds that
// round to nearest (f32_products says why).
//
// A tile is 256 documents x 128 queries: each consumer warpgroup owns 128
// documents as two m64n128 sums (64 registers a thread each) and one
// m64n128 partial accumulator, and each 32-deep slice issues 3 x 2 wgmma
// m64n128k8 per 8 of depth.  A stage
// holds B big (16 KB), B small (16 KB) and the A slice (a_bytes); three
// stages.  The epilogue reduces a group of 8 documents (8 accumulator rows,
// across lane bits 2-4) by shuffles, stages the (128 queries x 32 groups)
// maxima in shared memory and stores them 16 bytes a thread.

constexpr int kF32Docs = 256;               // documents per tile (M)
constexpr int kF32Queries = 128;            // queries per tile (N)
constexpr int kF32Depth = kSliceBytes / 4;  // f32 depth of one stage
constexpr int kF32Stages = 3;
constexpr int kF32BBytes = kF32Queries * kSliceBytes;     // big or small: 16 KB
constexpr int kF32OutStride = kF32Docs / 8 + 1;           // floats a staged row
constexpr int kF32OutBytes = kF32Queries * kF32OutStride * 4;
__host__ __device__ constexpr int f32_stage_bytes(int a_bytes) {
  return 2 * kF32BBytes + a_bytes;
}
__host__ __device__ constexpr int f32_smem_bytes(int a_bytes) {
  return kF32Stages * f32_stage_bytes(a_bytes) + kF32OutBytes
         + 2 * kF32Stages * 8 + 1024;       // + barriers, alignment
}

struct F32Ring {
  uint8_t* stage;      // kF32Stages x stage_bytes, 1024-aligned: B big, B small, A
  int stage_bytes;
  float* staged;       // kF32Queries x kF32OutStride group maxima
  uint64_t* full;      // kF32Stages
  uint64_t* empty;     // kF32Stages
};

__device__ __forceinline__ F32Ring carve_f32_ring(uint8_t* raw, int a_bytes) {
  F32Ring r;
  r.stage = (uint8_t*)(((uintptr_t)raw + 1023) & ~(uintptr_t)1023);
  r.stage_bytes = f32_stage_bytes(a_bytes);
  r.staged = (float*)(r.stage + kF32Stages * r.stage_bytes);
  r.full = (uint64_t*)((uint8_t*)r.staged + kF32OutBytes);
  r.empty = r.full + kF32Stages;
  return r;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

// A consumer warpgroup's products of one tile over kt slices: sum[m] (its
// documents 64m .. 64m + 63) += A · Bᵀ in 3xTF32.  a_at(sa, m, k, h) reads
// the f32 A element of this thread's fragment row (PTX ISA, m64nNk8 tf32 A
// fragment: row 16 * warp + lane / 4 + 8h of the m-tile, depth k of the
// slice) from the stage's A slice sa.
//   The tensor cores add each product into their f32 accumulator with
// truncation, so a long sum drifts by up to an ulp of the running total per
// step (3 D / 8 steps here): at the dense bench's shape that broke atol
// 1e-5.  So each slice's 12 products per m-tile start a fresh partial sum
// `part` (32 of depth, a small total), and the warpgroup adds it into `sum`
// with round-to-nearest f32 adds once its products are done.  One commit
// group per 8 of depth, waited one behind, keeps two fragments live; the
// wait for a whole m-tile before its flush is covered by the other
// warpgroup's products.  (s, ph) walk the ring across tiles.
template <typename AAt>
__device__ __forceinline__ void f32_products(float (&sum)[2][64],
                                             const F32Ring& ring, AAt a_at,
                                             int kt, int& s, uint32_t& ph) {
  const int lane = threadIdx.x & 31;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.0f;
  for (int k = 0; k < kt; ++k) {
    mbar_wait(&ring.full[s], ph);
    const uint8_t* st = ring.stage + s * ring.stage_bytes;
    const uint32_t bb = smem_u32(st), bs = bb + kF32BBytes;
    const uint8_t* sa = st + 2 * kF32BBytes;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t big[4], small[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)   // a0..a3: (row, k), (row+8, k), (row, k+4), (row+8, k+4)
          tf32_split(a_at(sa, m, 8 * kk + (lane & 3) + 4 * (r >> 1), r & 1),
                     big[r], small[r]);
        const uint64_t db = make_desc(bb + kk * 32, 16, 1024);
        const uint64_t ds = make_desc(bs + kk * 32, 16, 1024);
        wgmma_fence();
        wgmma_m64n128k8_tf32(part, big, ds, kk > 0);
        wgmma_m64n128k8_tf32(part, small, db, 1);
        wgmma_m64n128k8_tf32(part, big, db, 1);
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
      fence_operands(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[m][i] = __fadd_rn(sum[m][i], part[i]);
    }
    if (lane == 0) mbar_arrive(&ring.empty[s]);
    if (++s == kF32Stages) { s = 0; ph ^= 1; }
  }
}

// One reduce-scatter round over lanes: of each pair (a[lo], a[hi]) whose
// indices differ in bit P, this lane keeps the one `bit` picks and sends
// the other to lane ^ X; b[k] is the max of the kept and the received.
template <int P, int X, int N>
__device__ __forceinline__ void max_scatter(const float (&a)[N],
                                            float (&b)[N / 2], bool bit) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const int lo = ((k >> P) << (P + 1)) | (k & ((1 << P) - 1));
    const int hi = lo | (1 << P);
    const float keep = bit ? a[hi] : a[lo], send = bit ? a[lo] : a[hi];
    b[k] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, X));
  }
}

// Stages the group-of-8 maxima of one warp's 16 document rows of an
// m64n128 accumulator (documents on M).  score(k) is the f32 score of
// element k = 4i + e, which is (PTX ISA, wgmma D fragment) document row
// lane / 4 + 8 (e >> 1) of the warp's 16 and query 8i + 2 (lane % 4) +
// (e & 1).  A group of 8 documents is one e >> 1 over the lanes lane / 4 =
// 0..7: three reduce-scatter rounds (32 + 16 + 8 shuffles, not 3 x 64) keep
// index bits e & 1, i & 1 and i & 2 by lane bits 2, 3 and 4 and leave each
// lane 8 maxima: group g0 + (k & 1) of query 8i + 2 (lane % 4) + e0, with
// e0 = lane bit 2 and i = lane bit 3 + 2 (lane bit 4) + 4 (k >> 1).  The
// 32 lanes' queries differ mod 32, so with rows of kF32OutStride (33)
// floats the stores hit 32 banks.
template <typename Score>
__device__ __forceinline__ void stage_group_max_docs(Score score,
                                                     float* staged, int g0) {
  const int lane = threadIdx.x & 31;
  float v[64], r1[32], r2[16], r3[8];
#pragma unroll
  for (int k = 0; k < 64; ++k) v[k] = score(k);
  max_scatter<0, 4>(v, r1, (lane >> 2) & 1);
  max_scatter<1, 8>(r1, r2, (lane >> 3) & 1);
  max_scatter<1, 16>(r2, r3, (lane >> 4) & 1);
  const int q0 = 8 * (((lane >> 3) & 1) + 2 * ((lane >> 4) & 1))
                 + 2 * (lane & 3) + ((lane >> 2) & 1);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    staged[(q0 + 32 * (k >> 1)) * kF32OutStride + g0 + (k & 1)] = r3[k];
}

// The staged (kF32Queries x 32 groups) maxima to out (queries major, ng
// groups a row), 16 bytes a thread, 8 threads a query row; thread t of
// nthreads.  Groups at or past ng (a ragged last tile) are not stored; ng
// is a multiple of 4.
__device__ __forceinline__ void store_staged(const float* staged, float* out,
                                             int ng, int q0, int g0, int t,
                                             int nthreads) {
  for (int c = t; c < kF32Queries * 8; c += nthreads) {
    const int q = c >> 3, j = (c & 7) * 4;
    if (g0 + j < ng) {
      const float* sv = staged + q * kF32OutStride + j;
      *reinterpret_cast<float4*>(out + (size_t)(q0 + q) * ng + g0 + j) =
          make_float4(sv[0], sv[1], sv[2], sv[3]);
    }
  }
}

// A whole consumer tile's epilogue, both warpgroups (256 threads, named
// barrier 1): stage each warp's maxima, then store the tile's rows.  The
// first barrier keeps the previous tile's stores ahead of this tile's
// staging.  score(m, k, h) is the score of element k of accumulator m for
// the document row of half h.
template <typename Score>
__device__ __forceinline__ void f32_epilogue(Score score, float* staged,
                                             float* out, int ng, int q0,
                                             int g0, int w) {
  const int warp = (threadIdx.x % 128) >> 5;
  named_barrier(1, 256);
#pragma unroll
  for (int m = 0; m < 2; ++m)
    stage_group_max_docs([&](int k) { return score(m, k, (k >> 1) & 1); },
                         staged, 16 * w + 8 * m + 2 * warp);
  named_barrier(1, 256);
  store_staged(staged, out, ng, q0, g0, threadIdx.x - 128, 256);
}

// ---- host side --------------------------------------------------------------

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda of its own.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A row-major (rows, cols) matrix of elem_bytes-wide elements as a 2-D
// tensor map: boxes of box_rows x (128 bytes), 128-byte swizzle, elements
// outside the matrix read as zero.  Returns false if encoding failed.
static inline bool encode_2d(CUtensorMap* map, const void* base,
                             CUtensorMapDataType dtype, int elem_bytes,
                             int rows, int cols, int box_rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  cuuint32_t box[2] = {(cuuint32_t)(kSliceBytes / elem_bytes),
                       (cuuint32_t)box_rows};
  cuuint32_t estr[2] = {1, 1};
  return fn(map, dtype, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Readies `kernel` for a launch on the current device: once per device,
// allows it smem_bytes of dynamic shared memory (above the 48 KB default)
// and reads the SM count into the caller's per-device cache.  *sms is the
// grid's CTA limit (one persistent CTA per SM).
constexpr int kMaxDevices = 64;

static inline cudaError_t prepare(const void* kernel, int (&cache)[kMaxDevices],
                                  int* sms, int smem_bytes = kSmemBytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return e;
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cache[dev] = n;
  }
  *sms = cache[dev];
  return cudaSuccess;
}

}  // namespace hopper
