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
//   * f32 (tests and small indexes): plain FMA on CUDA cores, 64 x 64 tiles,
//     each thread owning one group of 8 documents for 2 queries, over the
//     whole head (the wrapper scatters Wc back to head-slot columns).
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

constexpr int FQ = 64;    // queries per block (f32 path)
constexpr int FN = 64;    // documents per block
constexpr int FK = 16;    // depth of one shared-memory slice

__global__ void __launch_bounds__(256) fused_head_f32_kernel(
    const float* __restrict__ W, const float* __restrict__ H,
    const float* __restrict__ bias, float* __restrict__ out, int D, int N) {
  __shared__ float Ws[FK][FQ];
  __shared__ float Hs[FK][FN];
  const int tid = threadIdx.x;
  const int tg = tid & 7;     // group of 8 documents within the tile
  const int tq = tid >> 3;    // pair of queries within the tile
  const int q0 = blockIdx.x * FQ;
  const int n0 = blockIdx.y * FN;
  const int ng = N / 8;

  float acc[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[r][u] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += FK) {
    {
      const int q = tid >> 2, kc = (tid & 3) * 4;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + kc + u;
        Ws[kc + u][q] = k < D ? W[(size_t)(q0 + q) * D + k] : 0.0f;
      }
    }
    {
      const int kr = tid >> 4, nc = (tid & 15) * 4;
      const int k = k0 + kr;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        Hs[kr][nc + u] = k < D ? H[(size_t)k * N + n0 + nc + u] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float w0 = Ws[kk][tq * 2], w1 = Ws[kk][tq * 2 + 1];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float h = Hs[kk][tg * 8 + u];
        acc[0][u] = fmaf(w0, h, acc[0][u]);
        acc[1][u] = fmaf(w1, h, acc[1][u]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = acc[r][0] + bias[n0 + tg * 8];
#pragma unroll
    for (int u = 1; u < 8; ++u) m = fmaxf(m, acc[r][u] + bias[n0 + tg * 8 + u]);
    out[(size_t)(q0 + tq * 2 + r) * ng + n0 / 8 + tg] = m;
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

extern "C" int tdr_fused_head_f32(const float* W, const float* H,
                                  const float* bias, float* out, int Qp, int D,
                                  int N, void* stream) {
  dim3 grid(Qp / FQ, N / FN);
  fused_head_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(W, H, bias,
                                                                 out, D, N);
  return (int)cudaGetLastError();
}
