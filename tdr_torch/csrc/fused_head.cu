// Fused sparse-head block-max, phase 1 of the full-vocab-head BM25 top-k,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_head_topk` (tdr/ops/pallas_flat.py, body
// `_make_head_kernel`).  For queries q and documents n it computes
//     s[q, n] = sum_d W[q, d] * head[d, n] + bias[n]
// with f32 accumulation and writes only the maximum over each group of 8
// consecutive documents, out[q, n / 8].  The (Q, N) score matrix never
// reaches device memory; phase 2 (group top-k, exact rescore, 2-key sort)
// is torch code in tdr_torch/ops/fused_head.py.
//
// Layouts: W (Qp, D) row-major in the head's dtype, Qp a multiple of 128;
// head (D, N) row-major, N a multiple of 128, D a multiple of 8; bias (N,)
// f32; out (Qp, N / 8) f32 (queries major, so phase 2's top-k runs along
// contiguous rows).
//
// What bounds it on this card: at the en shape (D = 4096, N = 262144,
// Q = 256, bf16) the head read is 2.15 GB, 0.64 ms at 3.35 TB/s, against
// 0.55 ms of bf16 tensor work at 989 TFLOP/s: memory bound, but only just,
// so the product has to run on the tensor cores.  The design:
//   * bf16: a 2-D grid of (128 queries) x (128 documents) tiles; 8 warps,
//     each 64 queries x 32 documents, with mma.sync m16n8k16 (bf16 in, f32
//     accumulate) fed by ldmatrix from a two-stage cp.async ring over
//     32-deep slices of D.  The two query tiles of one document tile are
//     adjacent in launch order, so the second read of each head tile comes
//     from L2 and the head crosses HBM about once.  In the epilogue the
//     bias is added and the group-of-8 maximum is a pair max inside the
//     thread and two shuffles inside each quad of lanes; one lane per group
//     stores, four neighbouring groups per 16 bytes.
//   * f32 (tests and small indexes): plain FMA on CUDA cores, 64 x 64 tiles,
//     each thread owning one group of 8 documents for 2 queries.
// wgmma/TMA and a deeper ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // queries per block
constexpr int BN = 128;       // documents per block
constexpr int BK = 32;        // depth of one shared-memory slice
constexpr int AS = BK + 8;    // A row stride (bf16): 80 B, ldmatrix conflict-free
constexpr int BS = BN + 8;    // B row stride (bf16): 272 B, ldmatrix conflict-free

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(256) fused_head_bf16_kernel(
    const __nv_bfloat16* __restrict__ W, const __nv_bfloat16* __restrict__ H,
    const float* __restrict__ bias, float* __restrict__ out, int D, int N) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM * AS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK * BS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;   // 0..1: 64 queries each
  const int wn = warp & 3;    // 0..3: 32 documents each
  const int q0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ng = N / 8;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  // D is a multiple of 8, so each 16-byte chunk is wholly inside or outside
  // [0, D); chunks outside are zero-filled (src_bytes = 0).
  auto load_slice = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 256;          // 128 rows x 4 chunks
      const int row = c >> 2, kc = (c & 3) * 8;
      const int k = k0 + kc;
      const __nv_bfloat16* src = W + (size_t)(q0 + row) * D + (k < D ? k : 0);
      cp_async16(smem_u32(&As[stage][row * AS + kc]), src, k < D ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 256;          // 32 rows x 16 chunks
      const int row = c >> 4, nc = (c & 15) * 8;
      const int k = k0 + row;
      const __nv_bfloat16* src = H + (size_t)(k < D ? k : 0) * N + n0 + nc;
      cp_async16(smem_u32(&Bs[stage][row * BS + nc]), src, k < D ? 16 : 0);
    }
  };

  const int KT = (D + BK - 1) / BK;
  load_slice(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_slice((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();                      // possibly empty: keeps the count
    cp_async_wait_1();                      // slice kt has landed
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 64 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = kk + (lane >> 4) * 8;
        ldmatrix_x4(a[i], smem_u32(&As[st][row * AS + col]));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = wn * 32 + j * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b[2 * j][0], b[2 * j][1], b[2 * j + 1][0],
                          b[2 * j + 1][1], smem_u32(&Bs[st][krow * BS + col]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();                        // stage st is free for reuse
  }

  // Epilogue.  Fragment of tile (i, j): this lane holds queries g and g + 8
  // at documents 2*tig and 2*tig + 1 of the 8-document group j.
  const int g = lane >> 2;
  const int tig = lane & 3;
  float lo[4][4], hi[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nb = n0 + wn * 32 + j * 8 + tig * 2;
    const float b0 = bias[nb], b1 = bias[nb + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float l = fmaxf(acc[i][j][0] + b0, acc[i][j][1] + b1);
      float h = fmaxf(acc[i][j][2] + b0, acc[i][j][3] + b1);
      l = fmaxf(l, __shfl_xor_sync(0xffffffffu, l, 1));
      h = fmaxf(h, __shfl_xor_sync(0xffffffffu, h, 1));
      l = fmaxf(l, __shfl_xor_sync(0xffffffffu, l, 2));
      h = fmaxf(h, __shfl_xor_sync(0xffffffffu, h, 2));
      lo[i][j] = l;
      hi[i][j] = h;
    }
  }
  // lane tig stores group tig: four neighbouring groups per query row
  const int grp = (n0 + wn * 32) / 8 + tig;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = tig == 0 ? lo[i][0] : tig == 1 ? lo[i][1]
                  : tig == 2 ? lo[i][2] : lo[i][3];
    const float h = tig == 0 ? hi[i][0] : tig == 1 ? hi[i][1]
                  : tig == 2 ? hi[i][2] : hi[i][3];
    const int q = q0 + wm * 64 + i * 16 + g;
    out[(size_t)q * ng + grp] = l;
    out[(size_t)(q + 8) * ng + grp] = h;
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

extern "C" int tdr_fused_head_bf16(const void* W, const void* H,
                                   const float* bias, float* out, int Qp,
                                   int D, int N, void* stream) {
  dim3 grid(Qp / BM, N / BN);
  fused_head_bf16_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)W, (const __nv_bfloat16*)H, bias, out, D, N);
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
