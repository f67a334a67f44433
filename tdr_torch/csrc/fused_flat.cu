// Fused dense flat-search block-max, phase 1 of the exact flat top-k,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_flat_topk` (tdr/ops/pallas_flat.py, body
// `_make_kernel`).  For queries q and documents n it computes
//     s[q, n] = alpha * dot(Q[q], E[n]) + bias[n]       (bf16, f32 in 3xTF32)
//     s[q, n] = alpha * ((acc[q, n] * dscale[n]) * qscale[q]) + bias[n]  (int8)
// with acc the exact int32 dot product of the int8 codes, and writes only
// the maximum over each group of 8 consecutive documents, out[q, n / 8].
// The (Q, N) score matrix never reaches device memory; phase 2 (group
// top-k, exact f32 rescore, 2-key sort) is torch code in
// tdr_torch/ops/fused_flat.py.  The epilogue's f32 operations use
// __fmul_rn / __fadd_rn in the JAX kernel's order, so they round where the
// plain torch version rounds (no contraction into an FMA).
//
// Layouts: Q (Qp, D) row-major in the embeddings' dtype, Qp a multiple of
// 128; E (N, D) row-major (documents major), N a multiple of 64; a row of
// D elements is a multiple of 64 bytes; bias, dscale (N,) and qscale (Qp,)
// f32; out (Qp, N / 8) f32, queries major (the JAX kernel writes the
// transpose, (N / 8, Qp)).
//
// What bounds it on this card (H100 SXM at its 700 W limit: 3.35 TB/s,
// 989 TFLOP/s bf16, 1,979 TOP/s int8):
//   * the dense pass (Q = 2000 padded to 2048, N = 268,032, D = 384, bf16):
//     412 GFLOP, 0.416 ms of operations, against 0.47 GB of bytes (0.21 GB
//     of embeddings, 0.27 GB of group maxima), 0.142 ms: bound by
//     operations, so the product must run at the tensor cores' rate, which
//     only wgmma reaches;
//   * the bench shape (Q = 256, N = 262,144, D = 256): bound by bytes,
//     0.0504 ms in bf16 and 0.0307 ms in int8 (the embeddings and the group
//     maxima), against 0.034 and 0.017 ms of tensor work.
// The design (bf16 and int8, one templated body):
//   * the ring of hopper.cuh: persistent CTAs, warpgroup 0's first thread
//     issues the TMA loads, two consumer warpgroups each run wgmma over 64
//     queries x 256 documents (m64n256k16 bf16 -> f32, or m64n256k32 s8 ->
//     s32, exact).  Q and E are both K-major (the "TN" case), loaded as
//     128-byte-deep boxes under the 128-byte swizzle, so both element types
//     consume 32 bytes of depth per instruction and share every address;
//     only the instruction and the epilogue differ.
//   * each CTA keeps one query tile and walks every (CTAs / query tiles)-th
//     embedding tile, so the query tiles of one embedding tile run at about
//     the same time: the embeddings cross HBM once, and the 1.5 MB of
//     queries sit in L2.
//   * L2 -> SM traffic.  Re-reading both operands for every 128 x 256 tile
//     moves 4.9 GB at the dense pass (3.3 GB of embeddings: 206 MB for
//     each of 16 query tiles; 1.6 GB of 96 KB query slabs, one per tile).
//     So a row of up to 768 bytes (D = 384 bf16) keeps its query tile's
//     whole depth resident in shared memory, loaded once per CTA, and the
//     ring carries embedding slices alone: 3.3 GB.  The slab takes ring
//     bytes: 4 stages remain up to 512-byte rows, 3 at 768.  Deeper rows
//     stream both operands through the 4-stage ring.  Measured by
//     tdr_torch/tools/flat_variants.py (NVIDIA H100 80GB HBM3, 700 W; the
//     ranges span three processes): at the dense pass the loads alone
//     take 0.258-0.263 ms resident against 0.347-0.371 ms streamed, but the
//     whole kernel only 0.621-0.635 ms against 0.645-0.658 ms, because with
//     the products in the traffic is no longer what limits it: without its
//     epilogue the kernel takes 0.506-0.508 ms resident, 0.519-0.530 ms
//     streamed, against 0.416 ms of tensor work.
//   * the ring runs across tiles: the producer loads the next tile's slices
//     while the consumers run this tile's epilogue.
//   * epilogue: scales and bias in f32 as above, then the group-of-8 max
//     over the wgmma accumulator (hopper.cuh's store_group_max: 16-byte
//     stores); documents past N (the last tile, N a multiple of 64) read
//     as zero through the TMA and their groups are never stored.
//   * f32 (`FlatIndex` with f32 embeddings): on the tensor cores in
//     3xTF32 (hopper.cuh: the accuracy argument, the orientation and the
//     epilogue).  Documents on M: the consumers read the TMA-loaded,
//     swizzled embedding slice (A) into registers and split it there; the
//     queries are B, split by the wrapper and stacked (2 Qp, D), by TMA.
//     A tile is 256 documents x 128 queries, 3 stages of 64 KB, query
//     tiles of one document tile neighbours.  The epilogue keeps the
//     __fmul_rn / __fadd_rn order above.  Bounds at three TF32 products:
//     0.208 ms at the bench shape (Q = 256, N = 262,144, D = 256; bytes
//     0.091 ms) and 2.50 ms at the dense pass (Q = 2000, D = 384; bytes
//     0.204 ms).  L2 -> SM traffic: each query tile reads the embeddings
//     and each tile its queries' split slab, 0.54 + 0.54 GB at the bench
//     shape and 6.6 + 6.6 GB at the dense pass (16 query tiles; 393 KB of
//     split queries per tile).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.629 ms
// at the dense pass (66% of its bound), 0.066 ms bf16 and 0.054 ms int8
// at the bench shape (76% and 57%).  What is left is mostly the epilogue
// (0.11-0.13 ms at the dense pass), which both consumer warpgroups run at
// once while the tensor cores idle: overlapping it needs warpgroups on
// different tiles or a second set of accumulators, which the register file
// does not hold at 64 x 256 a warpgroup.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

// One CTA keeps one query tile (qt = blockIdx.x % n_qt) and walks every
// (gridDim.x / n_qt)-th document tile, so the CTAs that share a document
// tile run it at about the same time.  kResident: the query tile's whole
// depth is loaded once and stays in shared memory, and the ring carries
// embedding slices alone; else both operands stream through the ring.
template <bool kInt8, bool kResident>
__global__ void __launch_bounds__(hopper::kThreads, 1) fused_flat_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap emap, const float* __restrict__ bias,
    const float* __restrict__ dscale, const float* __restrict__ qscale,
    float* __restrict__ out, int n_qt, int kt, int N, float alpha) {
  using namespace hopper;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kElems = kInt8 ? kSliceBytes : kSliceBytes / 2;
  const int stages = kResident ? resident_stages(kt) : kStages;
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = kResident ? carve_ring(smem_raw, kt * kABytes, stages)
                              : carve_ring(smem_raw);
  const int n_dt = (N + kTileN - 1) / kTileN;
  const int qt = blockIdx.x % n_qt;
  const int dt0 = blockIdx.x / n_qt, dstep = gridDim.x / n_qt;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumerWarps);
    }
    mbar_init(ring.qfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread, both operands by TMA --------------------------
    setmaxnreg_dec<40>();
    if (tid == 0) {
      if constexpr (kResident) {
        mbar_arrive_expect_tx(ring.qfull, kt * kABytes);
        for (int k = 0; k < kt; ++k)
          tma_load_2d(ring.a + k * kABytes, &qmap, k * kElems, qt * kTileM,
                      ring.qfull);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int dt = dt0; dt < n_dt; dt += dstep) {
        for (int k = 0; k < kt; ++k) {
          mbar_wait(&ring.empty[s], ph ^ 1);
          if constexpr (kResident) {
            mbar_arrive_expect_tx(&ring.full[s], kBBytes);
          } else {
            mbar_arrive_expect_tx(&ring.full[s], kABytes + kBBytes);
            tma_load_2d(ring.a + s * kABytes, &qmap, k * kElems, qt * kTileM,
                        &ring.full[s]);
          }
          tma_load_2d(ring.b + s * kBBytes, &emap, k * kElems, dt * kTileN,
                      &ring.full[s]);
          if (++s == stages) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers: 64 queries x 256 documents each ------------------------
    setmaxnreg_inc<232>();
    const int w = wg - 1;
    const int warp = tid >> 5, lane = tid & 31;
    const int ng = N / 8;
    const int q_lo = qt * kTileM + w * 64 + warp * 16 + (lane >> 2);
    float qs[2] = {1.0f, 1.0f};
    if constexpr (kInt8) {
      qs[0] = qscale[q_lo];
      qs[1] = qscale[q_lo + 8];
    }
    if constexpr (kResident) mbar_wait(ring.qfull, 0);
    int s = 0;
    uint32_t ph = 0;
    Acc acc[128];
    for (int dt = dt0, it = 0; dt < n_dt; dt += dstep, ++it) {
      const int n0 = dt * kTileN;
      float* side = ring.side + (w * 2 + (it & 1)) * kSideFloats;
      load_side(side, bias, kInt8 ? dscale : nullptr, n0, N);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = Acc(0);
      fence_operands(acc);
      int prev = -1;
      for (int k = 0; k < kt; ++k) {
        mbar_wait(&ring.full[s], ph);
        const uint32_t a = smem_u32(ring.a + (kResident ? k : s) * kABytes
                                    + w * 64 * 128);
        const uint32_t b = smem_u32(ring.b + s * kBBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = make_desc(a + kk * 32, 16, 1024);
          const uint64_t db = make_desc(b + kk * 32, 16, 1024);
          if constexpr (kInt8)
            wgmma_m64n256k32_s8(acc, da, db);
          else
            wgmma_m64n256k16_bf16<0>(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();                // the previous slice's products
        if (prev >= 0 && lane == 0) mbar_arrive(&ring.empty[prev]);
        prev = s;
        if (++s == stages) { s = 0; ph ^= 1; }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&ring.empty[prev]);

      wait_side(w);
      const float* sb = side + 2 * (lane & 3);   // bias, then dscale
      auto score = [&](int i, int e) {
        float v;
        if constexpr (kInt8)
          v = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + e]),
                                  sb[kTileN + 8 * i + (e & 1)]),
                        qs[e >> 1]);
        else
          v = acc[4 * i + e];
        return __fadd_rn(__fmul_rn(alpha, v), sb[8 * i + (e & 1)]);
      };
      store_group_max(score, out, ng, q_lo, n0 / 8);
    }
  }
}

// ---- f32 embeddings: 3xTF32 on the tensor cores (hopper.cuh) --------------
// The A slice is 256 documents x 128 bytes by TMA under the 128-byte
// swizzle: element (d, k) sits in 16-byte chunk (k / 4) ^ (d % 8) of row
// d.  A fragment load's 8 quads read 8 documents with d % 8 = 0..7 at one
// k / 4, so the chunks differ and the 32 words hit 32 banks.
constexpr int kF32ABytes = hopper::kF32Docs * hopper::kSliceBytes;   // 32 KB
constexpr int kF32Smem = hopper::f32_smem_bytes(kF32ABytes);

__global__ void __launch_bounds__(hopper::kThreads, 1) fused_flat_f32_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap emap, const float* __restrict__ bias,
    float* __restrict__ out, int n_qt, int Qp, int kt, int N, float alpha) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const F32Ring ring = carve_f32_ring(smem_raw, kF32ABytes);
  const int tiles = n_qt * ((N + kF32Docs - 1) / kF32Docs);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread, split queries and embeddings by TMA --------
    setmaxnreg_dec<40>();
    if (tid == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int qt = t % n_qt, dt = t / n_qt;
        for (int k = 0; k < kt; ++k) {
          mbar_wait(&ring.empty[s], ph ^ 1);
          uint8_t* st = ring.stage + s * ring.stage_bytes;
          mbar_arrive_expect_tx(&ring.full[s], 2 * kF32BBytes + kF32ABytes);
          tma_load_2d(st, &qmap, k * kF32Depth, qt * kF32Queries,
                      &ring.full[s]);
          tma_load_2d(st + kF32BBytes, &qmap, k * kF32Depth,
                      Qp + qt * kF32Queries, &ring.full[s]);
          tma_load_2d(st + 2 * kF32BBytes, &emap, k * kF32Depth,
                      dt * kF32Docs, &ring.full[s]);
          if (++s == kF32Stages) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers: 128 documents x 128 queries each ----------------------
    setmaxnreg_inc<232>();
    const int w = wg - 1;
    const int warp = tid >> 5, lane = tid & 31;
    const int ng = N / 8;
    const int row = 128 * w + 16 * warp + (lane >> 2);   // + 64m + 8h
    int s = 0;
    uint32_t ph = 0;
    float sum[2][64];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int qt = t % n_qt, n0 = (t / n_qt) * kF32Docs;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[m][i] = 0.0f;
      // A(d, k): row d of the swizzled slice (d % 8 = row % 8)
      f32_products(sum, ring, [&](const uint8_t* sa, int m, int k, int h) {
        return *reinterpret_cast<const float*>(
            sa + (row + 64 * m + 8 * h) * kSliceBytes
            + ((((k >> 2) ^ (row & 7))) << 4) + (k & 3) * 4);
      }, kt, s, ph);
      float b[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = n0 + row + 64 * m + 8 * h;
          b[m][h] = d < N ? bias[d] : 0.0f;
        }
      f32_epilogue([&](int m, int k, int h) {
        return __fadd_rn(__fmul_rn(alpha, sum[m][k]), b[m][h]);
      }, ring.staged, out, ng, qt * kF32Queries, n0 / 8, w);
    }
  }
}

template <bool kInt8, bool kResident>
int launch_mode(const void* Q, const void* E, const float* bias,
                const float* dscale, const float* qscale, float* out, int Qp,
                int D, int N, float alpha, void* stream) {
  using namespace hopper;
  const int esize = kInt8 ? 1 : 2;
  const CUtensorMapDataType dt = kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap, emap;
  if (!encode_2d(&qmap, Q, dt, esize, Qp, D, kTileM) ||
      !encode_2d(&emap, E, dt, esize, N, D, kTileN))
    return (int)cudaErrorInvalidValue;
  static int sm_cache[kMaxDevices] = {};
  int sms = 0;
  const cudaError_t e = prepare(
      (const void*)fused_flat_wgmma_kernel<kInt8, kResident>, sm_cache, &sms);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = Qp / kTileM;
  const int n_dt = (N + kTileN - 1) / kTileN;
  const int kt = (D * esize + kSliceBytes - 1) / kSliceBytes;
  // CTAs per query tile: as many as fill the SMs, each with a tile at least
  int per = sms / n_qt;
  if (per < 1) per = 1;
  if (per > n_dt) per = n_dt;
  fused_flat_wgmma_kernel<kInt8, kResident><<<per * n_qt, kThreads, kSmemBytes,
                                              (cudaStream_t)stream>>>(
      qmap, emap, bias, dscale, qscale, out, n_qt, kt, N, alpha);
  return (int)cudaGetLastError();
}

// The query tile stays resident when its depth fits the slab (rows of up
// to 768 bytes); deeper rows stream through the ring.
template <bool kInt8>
int launch_flat(const void* Q, const void* E, const float* bias,
                const float* dscale, const float* qscale, float* out, int Qp,
                int D, int N, float alpha, void* stream) {
  const int kt = (D * (kInt8 ? 1 : 2) + hopper::kSliceBytes - 1)
                 / hopper::kSliceBytes;
  const bool resident = kt <= hopper::kResidentSlices;
  return resident ? launch_mode<kInt8, true>(Q, E, bias, dscale, qscale, out,
                                             Qp, D, N, alpha, stream)
                  : launch_mode<kInt8, false>(Q, E, bias, dscale, qscale, out,
                                              Qp, D, N, alpha, stream);
}

}  // namespace

extern "C" int tdr_fused_flat_bf16(const void* Q, const void* E,
                                   const float* bias, float* out, int Qp,
                                   int D, int N, float alpha, void* stream) {
  return launch_flat<false>(Q, E, bias, nullptr, nullptr, out, Qp, D, N,
                            alpha, stream);
}

extern "C" int tdr_fused_flat_int8(const void* Q, const void* E,
                                   const float* bias, const float* dscale,
                                   const float* qscale, float* out, int Qp,
                                   int D, int N, float alpha, void* stream) {
  return launch_flat<true>(Q, E, bias, dscale, qscale, out, Qp, D, N, alpha,
                           stream);
}

// Qs: (2 Qp, D) f32, tf32_split(Q) stacked, big rows first.
extern "C" int tdr_fused_flat_f32(const float* Qs, const float* E,
                                  const float* bias, float* out, int Qp,
                                  int D, int N, float alpha, void* stream) {
  using namespace hopper;
  CUtensorMap qmap, emap;
  if (!encode_2d(&qmap, Qs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2 * Qp, D,
                 kF32Queries) ||
      !encode_2d(&emap, E, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, D,
                 kF32Docs))
    return (int)cudaErrorInvalidValue;
  static int sm_cache[kMaxDevices] = {};
  int sms = 0;
  const cudaError_t e = prepare((const void*)fused_flat_f32_kernel, sm_cache,
                                &sms, kF32Smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = Qp / kF32Queries;
  const int tiles = n_qt * ((N + kF32Docs - 1) / kF32Docs);
  const int grid = tiles < sms ? tiles : sms;
  const int kt = (D + kF32Depth - 1) / kF32Depth;
  fused_flat_f32_kernel<<<grid, kThreads, kF32Smem, (cudaStream_t)stream>>>(
      qmap, emap, bias, out, n_qt, Qp, kt, N, alpha);
  return (int)cudaGetLastError();
}
