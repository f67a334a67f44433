// Fused sparse-head block-max, phase 1 of the full-vocab-head BM25 top-k,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_head_topk` (tdr/ops/pallas_flat.py, body
// `_make_head_kernel`).  For queries q and documents n it computes
//     s[q, n] = sum_{j < n_active} Wc[q, j] * head[rows[j], n] + bias[n]
// with f32 accumulation and writes only the maximum over each group of 8
// consecutive documents, out[q, n / 8].  rows lists the head slots that
// some query of the batch uses, first and ascending; Wc holds their
// slot-summed weights (tdr_torch/ops/fused_head.py builds both on the
// device).  A slot no query uses has an all-zero column of W, so this is
// W · head with the zero columns skipped.  The (Q, N) score matrix never
// reaches device memory; phase 2 is torch code in fused_head.py.
//
// Layouts: Wc (Qp, D) row-major in the head's dtype, Qp a multiple of 128;
// head (D, N) row-major, N a multiple of 128, D a multiple of 8; rows (D,)
// int32; n_active one int32 in device memory, read by the kernel (no host
// sync); bias (N,) f32; out (Qp, N / 8) f32, queries major.
//
// What bounds it on this card (H100 SXM at its 700 W limit: 3.35 TB/s,
// 989 TFLOP/s bf16), at the en shape (D = 4096, N = 262,144, Q = 256,
// bf16):
//   * whole head: 2.15 GB of head, 0.652 ms of bytes against 0.556 ms of
//     tensor work;
//   * active rows: a batch of 256 en queries uses 1,037 distinct head rows,
//     0.54 GB + 33.5 MB of output, 0.173 ms of bytes against 139 GFLOP,
//     0.141 ms.  Both are near the line where bytes and operations balance,
//     so the product must run at the tensor cores' rate, which only wgmma
//     reaches.
// The design (bf16):
//   * only the active rows are streamed: the loop runs over ceil(n_active /
//     64) slices of 64 depth rows; a slice row at or past n_active is
//     zero-filled in shared memory (cp.async with 0 source bytes, no read),
//     and meets the zero columns of Wc past n_active.  n_active = 0 leaves
//     the group maxima of the bias.
//   * the ring of hopper.cuh: persistent CTAs, warpgroup 0 produces, two
//     consumer warpgroups each run wgmma m64n256k16 over 64 queries x 256
//     documents.  A (a 128 x 64 slice of Wc, K-major) comes by 2-D TMA; the
//     gathered head rows (MN-major B) cannot come by one TMA box, so the
//     producer's four warps issue 16-byte cp.async, one warp instruction
//     per 512-byte row segment, to the addresses a 128-byte-swizzled box
//     would use, and arrive on the stage's mbarrier with
//     cp.async.mbarrier.arrive.noinc.  wgmma takes
//     MN-major bf16 B through its transpose bit: no ldmatrix.trans.  Four
//     stages of 48 KB keep up to 192 KB in flight per SM, against about
//     25 KB that 3.35 TB/s x 1 us spread over 132 SMs asks for.
//   * tile order: the query tiles of one document tile are neighbours, so
//     the head crosses HBM once and its second read comes from L2.
//     L2 -> SM traffic at the en shape: the head rows twice (1.09 GB) and
//     Wc once per tile (2,048 tiles x 128 x 1,088 x 2 B = 0.57 GB).  A
//     cluster multicast of the shared operand would halve it.
//   * epilogue: the bias, then the group-of-8 max over the wgmma
//     accumulator (hopper.cuh's store_group_max: 16-byte stores).
//   * f32 heads (`--head-dtype float32`): the same active rows, on the
//     tensor cores in 3xTF32 (hopper.cuh: the accuracy argument, the
//     orientation and the epilogue).  tf32 wgmma reads shared memory only
//     K-major and the head is documents-contiguous, so documents go on M:
//     the consumers read A (head rows x 256 documents, gathered by
//     cp.async as above into depth rows padded to 1056 bytes, which keeps
//     the 32-bit fragment loads free of bank conflicts) into registers and
//     split it there; Wc is B, split by the wrapper and stacked (2 Qp, D),
//     by TMA.  A tile is 256 documents x 128 queries, 3 stages of 65 KB.
//     At the en shape (Q = 256, 1,025 active rows) the work is 3 x 137.6
//     GFLOP of TF32, 0.834 ms at 495 TFLOP/s, against 0.331 ms of bytes.
//     L2 -> SM traffic: each of the 2 query tiles reads the head rows
//     (1.07 GB, the second read from L2, its tile a neighbour), and each of
//     the 2,048 tiles re-reads its 128 queries' split Wc (128 x 1,056 x 8
//     B = 1.08 MB): 2.2 GB of each, 4.4 GB in all.  A cluster multicast of
//     the split Wc to two document tiles would halve the second term.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.317 ms
// at the en shape with 1,025 active rows (54% of their 0.171 ms bound),
// 1.19 ms with all 4,096 rows active (55% of the whole-head bound).  Both consumer
// warpgroups run the epilogue at once while the tensor cores idle; that is
// the next thing to overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kDepth = hopper::kSliceBytes / 2;   // bf16 depth rows a slice

__global__ void __launch_bounds__(hopper::kThreads, 1) fused_head_wgmma_kernel(
    const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ H, const int* __restrict__ rows,
    const int* __restrict__ n_active_p, const float* __restrict__ bias,
    float* __restrict__ out, int n_qt, int N) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = carve_ring(smem_raw);
  const int n_active = *n_active_p;
  const int kt = (n_active + kDepth - 1) / kDepth;
  const int tiles = n_qt * ((N + kTileN - 1) / kTileN);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 128 + 1);      // 128 cp.async + 1 TMA arrival
      mbar_init(&ring.empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: A by TMA, the gathered head rows by cp.async ----------
    setmaxnreg_dec<40>();
    // warp wp fills depth rows wp, wp + 4, ...: one 512-byte row segment
    // (the tile's 256 documents) per instruction, lane = 16-byte chunk
    const int wp = tid >> 5, lane = tid & 31;
    const int doc = lane * 8;
    const int blk = lane >> 3, cc = lane & 7;  // 64-document block, chunk
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int qt = t % n_qt, n0 = (t / n_qt) * kTileN;
      const bool dok = n0 + doc < N;
      for (int k = 0; k < kt; ++k) {
        // lane i < 16 looks up the head row of depth row wp + 4i
        const int dl = k * kDepth + wp + 4 * (lane & 15);
        const int rl = dl < n_active ? rows[dl] : -1;
        mbar_wait(&ring.empty[s], ph ^ 1);
        if (tid == 0) {
          mbar_arrive_expect_tx(&ring.full[s], kABytes);
          tma_load_2d(ring.a + s * kABytes, &wmap, k * kDepth, qt * kTileM,
                      &ring.full[s]);
        }
        uint8_t* bst = ring.b + s * kBBytes + blk * 8192;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int j = wp + 4 * i;
          const int r = __shfl_sync(0xffffffffu, rl, i);
          const bool ok = r >= 0 && dok;
          // the swizzled place a 128-byte-swizzled TMA box would use
          cp_async16(smem_u32(bst + j * 128 + ((cc ^ (j & 7)) << 4)),
                     ok ? (const void*)(H + (size_t)r * N + n0 + doc)
                        : (const void*)H,
                     ok ? 16 : 0);
        }
        cp_async_arrive_noinc(&ring.full[s]);
        if (++s == kStages) { s = 0; ph ^= 1; }
      }
    }
  } else {
    // ---- consumers: 64 queries x 256 documents each ------------------------
    setmaxnreg_inc<232>();
    const int w = wg - 1;
    const int warp = tid >> 5, lane = tid & 31;
    const int ng = N / 8;
    int s = 0;
    uint32_t ph = 0;
    float acc[128];
    for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
      const int qt = t % n_qt, n0 = (t / n_qt) * kTileN;
      float* side = ring.side + (w * 2 + (it & 1)) * kSideFloats;
      load_side(side, bias, nullptr, n0, N);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      fence_operands(acc);
      int prev = -1;
      for (int k = 0; k < kt; ++k) {
        mbar_wait(&ring.full[s], ph);
        fence_proxy_async();            // the cp.async writes, for wgmma
        const uint32_t a = smem_u32(ring.a + s * kABytes + w * 64 * 128);
        const uint32_t b = smem_u32(ring.b + s * kBBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n256k16_bf16<1>(acc, make_desc(a + kk * 32, 16, 1024),
                                   make_desc(b + kk * 2048, 8192, 1024));
        wgmma_commit();
        wgmma_wait<1>();                // the previous slice's products
        if (prev >= 0 && lane == 0) mbar_arrive(&ring.empty[prev]);
        prev = s;
        if (++s == kStages) { s = 0; ph ^= 1; }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&ring.empty[prev]);

      wait_side(w);
      const float* sb = side + 2 * (lane & 3);
      auto score = [&](int i, int e) {
        return acc[4 * i + e] + sb[8 * i + (e & 1)];
      };
      store_group_max(score, out, ng,
                      qt * kTileM + w * 64 + warp * 16 + (lane >> 2), n0 / 8);
    }
  }
}

// ---- f32 heads: 3xTF32 on the tensor cores (hopper.cuh) -------------------
// A depth row of the stage holds 256 documents, padded from 1024 to 1056
// bytes (264 words, 8 mod 32): a fragment load's quad reads 4 depths of
// one document and its 8 quads 8 documents, so word 8k + d covers 32
// banks.
constexpr int kF32ARow = hopper::kF32Docs * 4 + 32;
constexpr int kF32ABytes = hopper::kF32Depth * kF32ARow;          // 33 KB
constexpr int kF32Smem = hopper::f32_smem_bytes(kF32ABytes);

__global__ void __launch_bounds__(hopper::kThreads, 1) fused_head_f32_kernel(
    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ H,
    const int* __restrict__ rows, const int* __restrict__ n_active_p,
    const float* __restrict__ bias, float* __restrict__ out, int n_qt,
    int Qp, int N) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const F32Ring ring = carve_f32_ring(smem_raw, kF32ABytes);
  const int n_active = *n_active_p;
  const int kt = (n_active + kF32Depth - 1) / kF32Depth;
  const int tiles = n_qt * ((N + kF32Docs - 1) / kF32Docs);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(&ring.full[s], 128 + 1);      // 128 cp.async + 1 TMA arrival
      mbar_init(&ring.empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: split Wc by TMA, the gathered head rows by cp.async ----
    setmaxnreg_dec<40>();
    // warp wp fills depth rows wp, wp + 4, ...: two 512-byte segments a
    // row (the tile's 256 documents), lane = 16-byte chunk
    const int wp = tid >> 5, lane = tid & 31;
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int qt = t % n_qt, n0 = (t / n_qt) * kF32Docs;
      for (int k = 0; k < kt; ++k) {
        // lane i < 8 looks up the head row of depth row wp + 4i
        const int dl = k * kF32Depth + wp + 4 * (lane & 7);
        const int rl = dl < n_active ? rows[dl] : -1;
        mbar_wait(&ring.empty[s], ph ^ 1);
        uint8_t* st = ring.stage + s * ring.stage_bytes;
        if (tid == 0) {
          mbar_arrive_expect_tx(&ring.full[s], 2 * kF32BBytes);
          tma_load_2d(st, &wmap, k * kF32Depth, qt * kF32Queries,
                      &ring.full[s]);
          tma_load_2d(st + kF32BBytes, &wmap, k * kF32Depth,
                      Qp + qt * kF32Queries, &ring.full[s]);
        }
        uint8_t* ast = st + 2 * kF32BBytes;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = wp + 4 * i;
          const int r = __shfl_sync(0xffffffffu, rl, i);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int doc = (lane + 32 * half) * 4;
            const bool ok = r >= 0 && n0 + doc < N;
            cp_async16(smem_u32(ast + j * kF32ARow + doc * 4),
                       ok ? (const void*)(H + (size_t)r * N + n0 + doc)
                          : (const void*)H,
                       ok ? 16 : 0);
          }
        }
        cp_async_arrive_noinc(&ring.full[s]);
        if (++s == kF32Stages) { s = 0; ph ^= 1; }
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
      // A(d, k) = head row k of the slice at document d: depth-major
      f32_products(sum, ring, [&](const uint8_t* sa, int m, int k, int h) {
        return *reinterpret_cast<const float*>(
            sa + k * kF32ARow + (row + 64 * m + 8 * h) * 4);
      }, kt, s, ph);
      float b[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = n0 + row + 64 * m + 8 * h;
          b[m][h] = d < N ? bias[d] : 0.0f;
        }
      f32_epilogue([&](int m, int k, int h) { return sum[m][k] + b[m][h]; },
                   ring.staged, out, ng, qt * kF32Queries, n0 / 8, w);
    }
  }
}

}  // namespace

extern "C" int tdr_fused_head_bf16(const void* Wc, const void* H,
                                   const int* rows, const int* n_active,
                                   const float* bias, float* out, int Qp,
                                   int D, int N, void* stream) {
  using namespace hopper;
  CUtensorMap wmap;
  if (!encode_2d(&wmap, Wc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Qp, D,
                 kTileM))
    return (int)cudaErrorInvalidValue;
  static int sm_cache[kMaxDevices] = {};
  int sms = 0;
  const cudaError_t e =
      prepare((const void*)fused_head_wgmma_kernel, sm_cache, &sms);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = Qp / kTileM;
  const int tiles = n_qt * ((N + kTileN - 1) / kTileN);
  const int grid = tiles < sms ? tiles : sms;
  fused_head_wgmma_kernel<<<grid, kThreads, kSmemBytes,
                            (cudaStream_t)stream>>>(
      wmap, (const __nv_bfloat16*)H, rows, n_active, bias, out, n_qt, N);
  return (int)cudaGetLastError();
}

// Ws: (2 Qp, D) f32, tf32_split(Wc) stacked, big rows first.
extern "C" int tdr_fused_head_f32(const float* Ws, const float* H,
                                  const int* rows, const int* n_active,
                                  const float* bias, float* out, int Qp,
                                  int D, int N, void* stream) {
  using namespace hopper;
  CUtensorMap wmap;
  if (!encode_2d(&wmap, Ws, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2 * Qp, D,
                 kF32Queries))
    return (int)cudaErrorInvalidValue;
  static int sm_cache[kMaxDevices] = {};
  int sms = 0;
  const cudaError_t e = prepare((const void*)fused_head_f32_kernel, sm_cache,
                                &sms, kF32Smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = Qp / kF32Queries;
  const int tiles = n_qt * ((N + kF32Docs - 1) / kF32Docs);
  const int grid = tiles < sms ? tiles : sms;
  fused_head_f32_kernel<<<grid, kThreads, kF32Smem, (cudaStream_t)stream>>>(
      wmap, H, rows, n_active, bias, out, n_qt, Qp, N);
  return (int)cudaGetLastError();
}
