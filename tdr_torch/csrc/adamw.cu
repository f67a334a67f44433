// The AdamW update of a whole param group, one launch a device, written
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: tdr's optimizer is optax.adamw
// (tdr/train/contrastive.py), whose update XLA fuses into one pass a leaf.
// PyTorch's foreach path (torch.optim.AdamW on CUDA parameters, the step
// kept on the host) runs the same update as eight passes over memory, one
// an operation: the decay's mul_, lerp_, mul_, addcmul_, the sqrt's
// temporary, div_, add_ and addcdiv_, 80 bytes a parameter in f32.  Here
// one pass reads the parameter, its gradient and both moments and writes
// the parameter and both moments: 28 bytes.
//
// What it computes, per element, in f32 and at the foreach path's rounding
// points (each operation rounded once; an fma where the foreach kernel's
// a + s * b is contracted into one):
//   p = p * decay                          decay = 1 - lr * wd
//   m = m + w1 * (g - m)                   lerp toward g, w1 = 1 - beta1
//   v = (v * beta2) + omb2 * (g * g)       omb2 = 1 - beta2
//   p = p + step * (m / (sqrt(v) / bc2s + eps))
// with step = -lr / (1 - beta1^t) and bc2s = sqrt(1 - beta2^t), computed on
// the host from the step count t in double and rounded to f32, as the
// foreach path rounds its Python scalars.  IEEE sqrt and division, no fast
// math: the result stays within a few ulps of the foreach path.
//
// What bounds it on this card: memory (a dozen flops for 28 bytes).  At
// the MoE train cell's 2.630B parameters a step moves 73.6 GB: 22.0 ms at
// 3.35 TB/s.
//
// The design: a table of chunks in device memory, built once on the host
// (tdr_torch/ops/adamw.py, chunk_table) and kept while the parameters and
// moments stay where they are.  Each row holds the data pointers of one
// parameter and its two moments, the parameter's index in the launch, a
// start offset and a length: a tensor of any size is cut into chunks of at
// most CHUNK elements, so MiniLM's hundred small tensors and the MoE's
// 369M-element expert stacks share one launch.  The gradients' pointers
// come with the launch itself, up to kMaxTensors of them by value in the
// kernel's parameters: autograd hands back each step's gradients in new
// storage, so a table that held them would be built and copied every step
// (__grid_constant__: the kernel reads them from the constant bank, no
// copy a thread).  A persistent grid (as many 256-thread blocks as fit on
// the card) strides over the chunks.  Inside a chunk the threads take
// 16-byte vectors, four in flight a thread and array before the first
// update, neighbouring threads on neighbouring vectors; the elements
// before the first 16-byte boundary and after the last vector are taken
// one by one.  Where the four pointers of a chunk do not share their
// alignment, the whole chunk goes one element at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // 16-byte vectors in flight a thread
constexpr int kMaxTensors = 1024; // gradients a launch: 8 KB of parameters

// One row of the chunk table: six int64s, as chunk_table lays them out.
struct Chunk {
  long long p, m, v;              // data pointers: param, exp_avg, exp_avg_sq
  long long tensor;               // the param's index in the launch's Grads
  long long start, len;           // elements [start, start + len) of each
};
static_assert(sizeof(Chunk) == 48, "a chunk-table row is six int64s");

struct Grads {
  const float* g[kMaxTensors];
};

struct Scalars {
  float decay, w1, beta2, omb2, step, bc2s, eps;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Scalars& s) {
  p = __fmul_rn(p, s.decay);
  m = __fmaf_rn(s.w1, __fsub_rn(g, m), m);
  v = __fmaf_rn(s.omb2, __fmul_rn(g, g), __fmul_rn(v, s.beta2));
  const float denom = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), s.bc2s), s.eps);
  p = __fmaf_rn(s.step, __fdiv_rn(m, denom), p);
}

__device__ __forceinline__ void update4(float4& p, const float4& g,
                                        float4& m, float4& v,
                                        const Scalars& s) {
  update(p.x, g.x, m.x, v.x, s);
  update(p.y, g.y, m.y, v.y, s);
  update(p.z, g.z, m.z, v.z, s);
  update(p.w, g.w, m.w, v.w, s);
}

__device__ __forceinline__ void update_one(float* p, const float* g,
                                           float* m, float* v, long long i,
                                           const Scalars& s) {
  float pi = p[i], mi = m[i], vi = v[i];
  update(pi, g[i], mi, vi, s);
  p[i] = pi;
  m[i] = mi;
  v[i] = vi;
}

__global__ void __launch_bounds__(kThreads)
tdr_adamw_kernel(const Chunk* __restrict__ table, int n_chunks,
                 const __grid_constant__ Grads grads, Scalars s) {
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = table[c];
    float* p = reinterpret_cast<float*>(ch.p) + ch.start;
    const float* g = grads.g[ch.tensor] + ch.start;
    float* m = reinterpret_cast<float*>(ch.m) + ch.start;
    float* v = reinterpret_cast<float*>(ch.v) + ch.start;
    const long long n = ch.len;
    const uintptr_t a = reinterpret_cast<uintptr_t>(p) & 15;
    const bool shared = (reinterpret_cast<uintptr_t>(g) & 15) == a &&
                        (reinterpret_cast<uintptr_t>(m) & 15) == a &&
                        (reinterpret_cast<uintptr_t>(v) & 15) == a;
    // elements before the first 16-byte boundary (all of them where the
    // pointers' alignments differ), then whole vectors, then the rest
    long long head = shared ? (long long)(((16 - a) & 15) >> 2) : n;
    if (head > n) head = n;
    const long long nvec = (n - head) >> 2;
    const long long tail = head + 4 * nvec;
    for (long long i = threadIdx.x; i < head; i += kThreads)
      update_one(p, g, m, v, i, s);
    for (long long i = tail + threadIdx.x; i < n; i += kThreads)
      update_one(p, g, m, v, i, s);

    float4* __restrict__ p4 = reinterpret_cast<float4*>(p + head);
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g + head);
    float4* __restrict__ m4 = reinterpret_cast<float4*>(m + head);
    float4* __restrict__ v4 = reinterpret_cast<float4*>(v + head);
    for (long long base = threadIdx.x; base < nvec;
         base += (long long)kUnroll * kThreads) {
      float4 P[kUnroll], G[kUnroll], M[kUnroll], V[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + (long long)u * kThreads;
        if (i < nvec) {
          P[u] = p4[i];
          G[u] = g4[i];
          M[u] = m4[i];
          V[u] = v4[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + (long long)u * kThreads;
        if (i < nvec) {
          update4(P[u], G[u], M[u], V[u], s);
          p4[i] = P[u];
          m4[i] = M[u];
          v4[i] = V[u];
        }
      }
    }
  }
}

}  // namespace

// The persistent grid on the current device: the blocks of tdr_adamw that
// fit on all its SMs at once.
extern "C" int tdr_adamw_blocks(int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tdr_adamw_kernel, kThreads, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = per_sm * sms;
  if (e == cudaSuccess && *blocks < 1) e = cudaErrorInvalidConfiguration;
  return (int)e;
}

// table: n_chunks rows of six int64s (chunk_table's), on the device;
// grads: n_tensors gradient data pointers, in host memory, in the order of
// the table's tensor indices; the scalars as the header says.  Updates
// every chunk's param, exp_avg and exp_avg_sq in place.
extern "C" int tdr_adamw(const void* table, int n_chunks, int blocks,
                         const long long* grads, int n_tensors, float decay,
                         float w1, float beta2, float omb2, float step,
                         float bc2s, float eps, void* stream) {
  if (n_chunks < 0 || blocks < 1 || n_tensors < 0 || n_tensors > kMaxTensors)
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  Grads g{};
  for (int i = 0; i < n_tensors; ++i)
    g.g[i] = reinterpret_cast<const float*>(grads[i]);
  const Scalars s{decay, w1, beta2, omb2, step, bc2s, eps};
  tdr_adamw_kernel<<<n_chunks < blocks ? n_chunks : blocks, kThreads, 0,
                     (cudaStream_t)stream>>>(
      static_cast<const Chunk*>(table), n_chunks, g, s);
  return (int)cudaGetLastError();
}
