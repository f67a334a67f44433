// Dense head-row score accumulation, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `head_scores_pallas` (tdr/ops/pallas_score.py,
// body `_head_kernel`).  For each query q it computes
//     out[q, n] = sum_{t < min(n_active[q], T)} qw[q, t] * rows[slot[q, t], n]
// in f32, with the terms compacted head-first by the caller (a stable sort
// on ~active, `_prep_terms`), so the sum runs in the JAX kernel's term
// order.  Each step is __fmul_rn then __fadd_rn (no FMA), as the Pallas
// kernel's `out += qw * row` and the plain torch version round, so the
// kernel and its plain version agree bit for bit.
//
// Layouts: rows (D, N) row-major, bf16 or f32, N a multiple of 4; slot and
// qw (Q, T) int32 / f32, T <= 64; n_active (Q,) int32; out (Q, N) f32.
//
// What bounds it on this card: memory.  Each query reads its active rows
// once (n_active * N * element bytes) and writes its N f32 scores; two
// flops per row element read.  The design: a grid of (document chunk of
// 1024) x (query); 256 threads, each owning 4 neighbouring documents of one
// query, so a warp reads 256 (f32: 512) contiguous bytes of a row per term
// and writes 512 contiguous bytes of scores.  The slots and weights of the
// block's query sit in shared memory.  The TPU kernel kept the (1, N)
// accumulator in VMEM across a sequential term grid axis; here the term
// loop runs inside the thread and the accumulator is 4 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                       // documents per thread
constexpr int kChunk = kThreads * kVec;       // documents per block
constexpr int kMaxTerms = 64;

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) head_scores_kernel(
    const T* __restrict__ rows, const int* __restrict__ slots,
    const float* __restrict__ qw, const int* __restrict__ n_active,
    float* __restrict__ out, int T_, int N) {
  __shared__ int s_slot[kMaxTerms];
  __shared__ float s_w[kMaxTerms];
  const int q = blockIdx.y;
  const int na = min(n_active[q], T_);
  if (threadIdx.x < na) {
    s_slot[threadIdx.x] = slots[(size_t)q * T_ + threadIdx.x];
    s_w[threadIdx.x] = qw[(size_t)q * T_ + threadIdx.x];
  }
  __syncthreads();
  const int n = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (n >= N) return;
  float acc[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < na; ++t) {
    float v[kVec];
    load4(rows + (size_t)s_slot[t] * N + n, v);
    const float w = s_w[t];
#pragma unroll
    for (int u = 0; u < kVec; ++u) acc[u] = __fadd_rn(acc[u], __fmul_rn(w, v[u]));
  }
  *reinterpret_cast<float4*>(out + (size_t)q * N + n) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <typename T>
int launch(const void* rows, const int* slots, const float* qw,
           const int* n_active, float* out, int Q, int T_, int N,
           void* stream) {
  dim3 grid((N + kChunk - 1) / kChunk, Q);
  head_scores_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)rows, slots, qw, n_active, out, T_, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdr_head_scores_bf16(const void* rows, const int* slots,
                                    const float* qw, const int* n_active,
                                    float* out, int Q, int T, int N,
                                    void* stream) {
  return launch<__nv_bfloat16>(rows, slots, qw, n_active, out, Q, T, N, stream);
}

extern "C" int tdr_head_scores_f32(const void* rows, const int* slots,
                                   const float* qw, const int* n_active,
                                   float* out, int Q, int T, int N,
                                   void* stream) {
  return launch<float>(rows, slots, qw, n_active, out, Q, T, N, stream);
}
