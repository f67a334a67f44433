// Fused dense flat-search block-max, phase 1 of the exact flat top-k,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_flat_topk` (tdr/ops/pallas_flat.py, body
// `_make_kernel`).  For queries q and documents n it computes
//     s[q, n] = alpha * dot(Q[q], E[n]) + bias[n]                 (bf16, f32)
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
// What bounds it on this card: at the dense path's shape (Q = 2000 padded
// to 2048, N = 268,032, D = 384, bf16) the product is 0.42 TFLOP, 0.43 ms
// at 989 TFLOP/s, against a 0.21 GB embedding read, 0.06 ms at 3.35 TB/s:
// bound by operations, so the product runs on the tensor cores.  At the
// bench shape (Q = 256, D = 256) the two are close (0.034 ms of bf16 work,
// 0.050 ms of bytes).  The design:
//   * bf16 and int8 share one kernel: a 2-D grid of (128 queries) x (128
//     documents) tiles; 8 warps, each 64 queries x 32 documents, with
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) or m16n8k32 (s8 in, s32
//     accumulate), fed by ldmatrix from a two-stage cp.async ring over
//     64-byte slices of D.  E is documents-major, i.e. already K-contiguous
//     for mma's "col" B operand, so B needs no ldmatrix .trans, and one
//     ldmatrix address pattern serves both element types (both mma shapes
//     consume 32 bytes of depth).  The query tiles of one document tile are
//     adjacent in launch order, so the embeddings cross HBM about once.
//     Epilogue: scales and bias in f32, the group-of-8 maximum as a pair
//     max inside the thread and two shuffles inside each quad of lanes.
//   * f32 (tests and small indexes): plain FMA on CUDA cores (no TF32),
//     64 x 64 tiles, each thread owning one group of 8 documents for 2
//     queries.
// TMA, wgmma and a deeper ring are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;       // queries per block
constexpr int BN = 128;       // documents per block
constexpr int BKB = 64;       // bytes of depth per shared-memory slice
constexpr int SS = BKB + 16;  // row stride in bytes: 80, ldmatrix conflict-free

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

// 16 x 8 x (32 bytes of depth): bf16 -> f32
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 x 8 x (32 bytes of depth): s8 -> s32, exact
__device__ __forceinline__ void mma(int* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

template <typename Acc>
__global__ void __launch_bounds__(256) fused_flat_mma_kernel(
    const uint8_t* __restrict__ Q, const uint8_t* __restrict__ E,
    const float* __restrict__ bias, const float* __restrict__ dscale,
    const float* __restrict__ qscale, float* __restrict__ out, int row_bytes,
    int N, float alpha) {
  constexpr bool kInt8 = std::is_same<Acc, int>::value;
  __shared__ __align__(128) uint8_t As[2][BM * SS];
  __shared__ __align__(128) uint8_t Bs[2][BN * SS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;   // 0..1: 64 queries each
  const int wn = warp & 3;    // 0..3: 32 documents each
  const int q0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ng = N / 8;

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = Acc(0);

  // 128 rows x 4 chunks of 16 bytes for each operand; documents past N are
  // zero-filled (src_bytes = 0) and never stored.
  auto load_slice = [&](int stage, int kb) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 256;
      const int row = c >> 2, cb = (c & 3) * 16;
      cp_async16(smem_u32(&As[stage][row * SS + cb]),
                 Q + (size_t)(q0 + row) * row_bytes + kb + cb, 16);
      const int n = n0 + row;
      const bool ok = n < N;
      cp_async16(smem_u32(&Bs[stage][row * SS + cb]),
                 E + (size_t)(ok ? n : 0) * row_bytes + kb + cb, ok ? 16 : 0);
    }
  };

  const int KT = row_bytes / BKB;
  load_slice(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_slice((kt + 1) & 1, (kt + 1) * BKB);
    cp_async_commit();                      // possibly empty: keeps the count
    cp_async_wait_1();                      // slice kt has landed
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kb = 0; kb < BKB; kb += 32) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 64 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int cb = kb + (lane >> 4) * 16;
        ldmatrix_x4(a[i], smem_u32(&As[st][row * SS + cb]));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // matrices: (docs 0-7, bytes 0-15), (0-7, 16-31), (8-15, 0-15),
        // (8-15, 16-31) of this 16-document pair of n8 tiles
        const int row = wn * 32 + j * 16 + (lane & 7) + (lane >> 4) * 8;
        const int cb = kb + ((lane >> 3) & 1) * 16;
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(&Bs[st][row * SS + cb]));
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], a[i], b[j]);
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
    const bool ok = nb < N;                 // the whole group is in or out
    const float b0 = ok ? bias[nb] : 0.0f, b1 = ok ? bias[nb + 1] : 0.0f;
    float d0 = 1.0f, d1 = 1.0f;
    if constexpr (kInt8) {
      d0 = ok ? dscale[nb] : 0.0f;
      d1 = ok ? dscale[nb + 1] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + wm * 64 + i * 16 + g;
      float v[4];
      if constexpr (kInt8) {
        const float qs_lo = qscale[q], qs_hi = qscale[q + 8];
        v[0] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][0]), d0), qs_lo);
        v[1] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][1]), d1), qs_lo);
        v[2] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2]), d0), qs_hi);
        v[3] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][3]), d1), qs_hi);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] = acc[i][j][r];
      }
      const float l = fmaxf(__fadd_rn(__fmul_rn(alpha, v[0]), b0),
                            __fadd_rn(__fmul_rn(alpha, v[1]), b1));
      const float h = fmaxf(__fadd_rn(__fmul_rn(alpha, v[2]), b0),
                            __fadd_rn(__fmul_rn(alpha, v[3]), b1));
      lo[i][j] = group_max(l);
      hi[i][j] = group_max(h);
    }
  }
  // lane tig stores group tig: four neighbouring groups per query row
  const int grp = (n0 + wn * 32) / 8 + tig;
  if (grp < ng) {
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
}

constexpr int FQ = 64;    // queries per block (f32 path)
constexpr int FN = 64;    // documents per block
constexpr int FK = 16;    // depth of one shared-memory slice

__global__ void __launch_bounds__(256) fused_flat_f32_kernel(
    const float* __restrict__ Q, const float* __restrict__ E,
    const float* __restrict__ bias, float* __restrict__ out, int D, int N,
    float alpha) {
  __shared__ float Qs[FK][FQ];
  __shared__ float Es[FK][FN];
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

  const int lr = tid >> 2, kc = (tid & 3) * 4;   // loader: row, 4 of depth
  for (int k0 = 0; k0 < D; k0 += FK) {
    const float4 qv = *reinterpret_cast<const float4*>(
        Q + (size_t)(q0 + lr) * D + k0 + kc);
    const float4 ev = *reinterpret_cast<const float4*>(
        E + (size_t)(n0 + lr) * D + k0 + kc);
    Qs[kc][lr] = qv.x; Qs[kc + 1][lr] = qv.y;
    Qs[kc + 2][lr] = qv.z; Qs[kc + 3][lr] = qv.w;
    Es[kc][lr] = ev.x; Es[kc + 1][lr] = ev.y;
    Es[kc + 2][lr] = ev.z; Es[kc + 3][lr] = ev.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float w0 = Qs[kk][tq * 2], w1 = Qs[kk][tq * 2 + 1];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float e = Es[kk][tg * 8 + u];
        acc[0][u] = fmaf(w0, e, acc[0][u]);
        acc[1][u] = fmaf(w1, e, acc[1][u]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int nb = n0 + tg * 8;
    float m = __fadd_rn(__fmul_rn(alpha, acc[r][0]), bias[nb]);
#pragma unroll
    for (int u = 1; u < 8; ++u)
      m = fmaxf(m, __fadd_rn(__fmul_rn(alpha, acc[r][u]), bias[nb + u]));
    out[(size_t)(q0 + tq * 2 + r) * ng + n0 / 8 + tg] = m;
  }
}

}  // namespace

extern "C" int tdr_fused_flat_bf16(const void* Q, const void* E,
                                   const float* bias, float* out, int Qp,
                                   int D, int N, float alpha, void* stream) {
  dim3 grid(Qp / BM, (N + BN - 1) / BN);
  fused_flat_mma_kernel<float><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)Q, (const uint8_t*)E, bias, nullptr, nullptr, out,
      D * 2, N, alpha);
  return (int)cudaGetLastError();
}

extern "C" int tdr_fused_flat_int8(const void* Q, const void* E,
                                   const float* bias, const float* dscale,
                                   const float* qscale, float* out, int Qp,
                                   int D, int N, float alpha, void* stream) {
  dim3 grid(Qp / BM, (N + BN - 1) / BN);
  fused_flat_mma_kernel<int><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)Q, (const uint8_t*)E, bias, dscale, qscale, out, D, N,
      alpha);
  return (int)cudaGetLastError();
}

extern "C" int tdr_fused_flat_f32(const float* Q, const float* E,
                                  const float* bias, float* out, int Qp,
                                  int D, int N, float alpha, void* stream) {
  dim3 grid(Qp / FQ, N / FN);
  fused_flat_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      Q, E, bias, out, D, N, alpha);
  return (int)cudaGetLastError();
}
