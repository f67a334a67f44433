// LayerNorm over the rows of a (rows, D) activation, forward and backward,
// written for Hopper (sm_90a).
//
// Replaces no TPU kernel: tdr's encoder (tdr/models/encoder.py) leaves its
// flax nn.LayerNorm(dtype=float32) to XLA, which fuses it.  PyTorch ran the
// port's plain version (tdr_torch/ops/layer_norm.py, layer_norm_plain) as a
// chain of generic elementwise kernels, each a pass over the rows in f32,
// with about twice as many passes back through autograd and their f32
// intermediates kept alive.  Here one launch reads each row once and writes
// it once, each way.
//
// What it computes, at the plain version's rounding points (flax's fast
// variance; only the sums run in another order):
//   forward, per row x of D values (bf16 or f32), in f32:
//     mean = sum(x) / D,  raw = sum(x * x) / D - mean * mean,
//     rstd = rsqrt(max(raw, 0) + eps),  y = (x - mean) * (rstd * w) + b,
//   y in f32, and (mean, rstd) saved per row (8 bytes), rstd negated where
//   the clamp was active (raw < 0);
//   backward, with xh = (x - mean) * rstd and g = dy * w:
//     dx = ((g - sum(g) / D) - xh * sum(g * xh) / D) * rstd,
//   the xh term dropped where the clamp was active (no gradient flows
//   through the variance there, as clamp_min's backward), dx rounded to x's
//   dtype;  dw = the sum over rows of dy * xh, db = the sum of dy, as
//   per-block partial sums and then one reduction kernel that adds them in
//   a fixed order: no float atomics, so a step repeats bit for bit.  x-hat
//   is recomputed from x and the saved statistics, not kept in f32.
//
// What bounds it on this card: memory (a few flops a byte).  At the train
// path's shape, 262,144 rows x 384 with x in bf16, the forward reads 201 MB
// and writes 403 MB of y and 2 MB of statistics: 0.181 ms at 3.35 TB/s.
// The backward reads x, dy (f32) and the statistics and writes dx: 807 MB,
// 0.241 ms.
//
// The design: a group of 32 * W threads takes a row (one warp up to
// D = 512, two at BERT's 768), each thread NC chunks of 4 neighbouring
// values (chunk j * 32W + lane), so a row stays in registers from its load
// through its sums to its output, and a warp's loads of one chunk index are
// contiguous: 8 bytes a thread for bf16 (a 384-wide row is 96 chunks, 3 a
// lane, 24 bytes), 16 for f32 and for the f32 output.  Any D that is a
// multiple of 4 up to 8,192 is taken (W up to 8, NC up to 8).  Row sums are
// warp shuffles (a butterfly: every lane gets the same bits), and for W > 1
// the W warps' partials meet in 8 float2s of shared memory; no row goes
// through shared memory.  The forward launches one 256-thread block per
// 256 / 32W rows (32,768 blocks at the train shape).  The backward runs a
// persistent grid, as many blocks as fit on the card at once, each group
// walking rows at the grid's stride with its columns' weights and dw/db
// partials in registers; the block's groups then add their partials in
// group order through shared memory (2D floats, only when a block holds
// several groups), and the reduction kernel sums the blocks' partials per
// column, each warp a strided share of the blocks, then the warps in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;     // 4-value chunks a thread holds

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  // round to nearest even, as torch's f32 -> bf16 cast
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 a;
  a.x = *reinterpret_cast<const uint32_t*>(&lo);
  a.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = a;
}

__device__ __forceinline__ void zero4(float* v) {
  v[0] = v[1] = v[2] = v[3] = 0.0f;
}

// (a, b) summed over the row's group of 32 * W threads.  For W > 1 every
// thread of the block must make the same calls: the sum holds the block's
// barrier.
__device__ __forceinline__ float2 group_sum(float a, float b, int W,
                                            float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if (W == 1) return make_float2(a, b);
  const int warp = threadIdx.x >> 5;
  __syncthreads();                      // the previous call's reads are done
  if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  const int first = warp - warp % W;
  float2 s = red[first];
  for (int i = 1; i < W; ++i) {
    s.x = __fadd_rn(s.x, red[first + i].x);
    s.y = __fadd_rn(s.y, red[first + i].y);
  }
  return s;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) tdr_layer_norm_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ y,
    float2* __restrict__ stats, int rows, int D, int W, float eps) {
  __shared__ float2 red[kWarps];
  const int G = 32 * W;
  const int t = threadIdx.x % G;
  const long long row =
      (long long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool live = row < rows;
  const int chunks = D >> 2;
  float v[NC][4];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = j * G + t;
    if (live && c < chunks) load4(x + row * D + 4 * c, v[j]);
    else zero4(v[j]);
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s1 = __fadd_rn(s1, v[j][u]);
      s2 = __fadd_rn(s2, __fmul_rn(v[j][u], v[j][u]));
    }
  }
  const float2 s = group_sum(s1, s2, W, red);
  if (!live) return;
  const float mean = __fdiv_rn(s.x, (float)D);
  const float raw =
      __fsub_rn(__fdiv_rn(s.y, (float)D), __fmul_rn(mean, mean));
  // clamp_min(0) lets a NaN through, as the plain version does
  const float rstd = rsqrtf(__fadd_rn(raw < 0.0f ? 0.0f : raw, eps));
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = j * G + t;
    if (c < chunks) {
      float wv[4], bv[4], o[4];
      load4(w + 4 * c, wv);
      load4(b + 4 * c, bv);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        o[u] = __fadd_rn(__fmul_rn(__fsub_rn(v[j][u], mean),
                                   __fmul_rn(rstd, wv[u])), bv[u]);
      store4(y + row * D + 4 * c, o);
    }
  }
  if (t == 0) stats[row] = make_float2(mean, raw < 0.0f ? -rstd : rstd);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) tdr_layer_norm_bwd_kernel(
    const float* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ w, const float2* __restrict__ stats,
    T* __restrict__ dx, float* __restrict__ part, int rows, int D, int W) {
  extern __shared__ float acc[];        // 2D floats, when groups > 1
  __shared__ float2 red[kWarps];
  const int G = 32 * W;
  const int groups = kThreads / G;
  const int grp = threadIdx.x / G;
  const int t = threadIdx.x % G;
  const int chunks = D >> 2;
  float wv[NC][4], dw[NC][4], db[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = j * G + t;
    if (c < chunks) load4(w + 4 * c, wv[j]);
    else zero4(wv[j]);
    zero4(dw[j]);
    zero4(db[j]);
  }
  const long long stride = (long long)gridDim.x * groups;
  // every group of a block makes the same number of passes (group_sum)
  for (long long base = (long long)blockIdx.x * groups; base < rows;
       base += stride) {
    const long long row = base + grp;
    const bool live = row < rows;
    float mean = 0.0f, rstd = 0.0f;
    bool clamped = false;
    if (live) {
      const float2 st = stats[row];
      mean = st.x;
      rstd = fabsf(st.y);
      clamped = st.y < 0.0f;
    }
    float d[NC][4], xh[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = j * G + t;
      if (live && c < chunks) {
        load4(x + row * D + 4 * c, xh[j]);
        load4(dy + row * D + 4 * c, d[j]);
      } else {
        zero4(xh[j]);
        zero4(d[j]);
      }
    }
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xh[j][u] = __fmul_rn(__fsub_rn(xh[j][u], mean), rstd);
        const float g = __fmul_rn(d[j][u], wv[j][u]);
        s1 = __fadd_rn(s1, g);
        s2 = __fadd_rn(s2, __fmul_rn(g, xh[j][u]));
      }
    }
    const float2 s = group_sum(s1, s2, W, red);
    if (!live) continue;
    const float c1 = __fdiv_rn(s.x, (float)D);
    const float c2 = clamped ? 0.0f : __fdiv_rn(s.y, (float)D);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = j * G + t;
      if (c < chunks) {
        float o[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float g = __fmul_rn(d[j][u], wv[j][u]);
          o[u] = __fmul_rn(__fsub_rn(__fsub_rn(g, c1),
                                     __fmul_rn(xh[j][u], c2)), rstd);
          dw[j][u] = __fadd_rn(dw[j][u], __fmul_rn(d[j][u], xh[j][u]));
          db[j][u] = __fadd_rn(db[j][u], d[j][u]);
        }
        store4(dx + row * D + 4 * c, o);
      }
    }
  }
  float* out = part + (size_t)blockIdx.x * 2 * D;
  if (groups == 1) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = j * G + t;
      if (c < chunks) {
        store4(out + 4 * c, dw[j]);
        store4(out + D + 4 * c, db[j]);
      }
    }
    return;
  }
  for (int k = 0; k < groups; ++k) {
    if (grp == k) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = j * G + t;
        if (c < chunks) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float* a = acc + 4 * c + u;
            a[0] = k ? __fadd_rn(a[0], dw[j][u]) : dw[j][u];
            a[D] = k ? __fadd_rn(a[D], db[j][u]) : db[j][u];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 2 * D; i += kThreads) out[i] = acc[i];
}

// The sum over p of part[p, col] for col < 2D, to dw[col] and then
// db[col - D]: a warp's lanes take 32 neighbouring columns, the 8 warps
// every 8th block's partials, then warp 0 adds the 8 in order.
__global__ void __launch_bounds__(kThreads) tdr_layer_norm_bwd_reduce(
    const float* __restrict__ part, int parts, int D,
    float* __restrict__ dw, float* __restrict__ db) {
  const int n = 2 * D;
  __shared__ float s[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float a = 0.0f;
  if (col < n) {
#pragma unroll 4
    for (int p = warp; p < parts; p += kWarps)
      a = __fadd_rn(a, part[(size_t)p * n + col]);
  }
  s[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && col < n) {
    float r = s[0][lane];
    for (int k = 1; k < kWarps; ++k) r = __fadd_rn(r, s[k][lane]);
    if (col < D) dw[col] = r;
    else db[col - D] = r;
  }
}

// threads to a row (32 * W) and chunks a thread holds (NC) for width D:
// the fewest warps that keep NC at 4 or under (16 values: the backward
// holds five such arrays), up to all 8 of the block, then NC up to 8
void shape_of(int D, int* W, int* NC) {
  const int chunks = D / 4;
  int w = 1;
  while (w < kWarps && chunks > 32 * w * (kMaxChunks / 2)) w *= 2;
  *W = w;
  *NC = (chunks + 32 * w - 1) / (32 * w);
}

size_t bwd_smem(int D, int W) {
  return kThreads / (32 * W) > 1 ? 2 * (size_t)D * sizeof(float) : 0;
}

template <typename T, int NC>
int fwd(const void* x, const float* w, const float* b, float* y,
        float* stats, int rows, int D, int W, float eps,
        cudaStream_t stream) {
  const int groups = kThreads / (32 * W);
  const int blocks = (int)(((long long)rows + groups - 1) / groups);
  tdr_layer_norm_fwd_kernel<T, NC><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, w, b, y, (float2*)stats, rows, D, W, eps);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int bwd_blocks(int D, int W, int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tdr_layer_norm_bwd_kernel<T, NC>, kThreads, bwd_smem(D, W));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = per_sm * sms;
  if (e == cudaSuccess && *blocks < 1) e = cudaErrorInvalidConfiguration;
  return (int)e;
}

template <typename T, int NC>
int bwd(const float* dy, const void* x, const float* w, const float* stats,
        void* dx, float* part, int blocks, float* dw, float* db, int rows,
        int D, int W, cudaStream_t stream) {
  const int groups = kThreads / (32 * W);
  const long long need = ((long long)rows + groups - 1) / groups;
  if (need < blocks) blocks = (int)need;
  tdr_layer_norm_bwd_kernel<T, NC>
      <<<blocks, kThreads, bwd_smem(D, W), stream>>>(
          dy, (const T*)x, w, (const float2*)stats, (T*)dx, part, rows, D, W);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tdr_layer_norm_bwd_reduce<<<(2 * D + 31) / 32, kThreads, 0, stream>>>(
      part, blocks, D, dw, db);
  return (int)cudaGetLastError();
}

// CALL(T, NC) for the chunk count of width D
#define TDR_LN_DISPATCH(CALL)                                  \
  int W, NC;                                                   \
  shape_of(D, &W, &NC);                                        \
  if (bf16) {                                                  \
    switch (NC) {                                              \
      case 1: return CALL(__nv_bfloat16, 1);                   \
      case 2: return CALL(__nv_bfloat16, 2);                   \
      case 3: return CALL(__nv_bfloat16, 3);                   \
      case 4: return CALL(__nv_bfloat16, 4);                   \
      case 5: return CALL(__nv_bfloat16, 5);                   \
      case 6: return CALL(__nv_bfloat16, 6);                   \
      case 7: return CALL(__nv_bfloat16, 7);                   \
      case 8: return CALL(__nv_bfloat16, 8);                   \
    }                                                          \
  } else {                                                     \
    switch (NC) {                                              \
      case 1: return CALL(float, 1);                           \
      case 2: return CALL(float, 2);                           \
      case 3: return CALL(float, 3);                           \
      case 4: return CALL(float, 4);                           \
      case 5: return CALL(float, 5);                           \
      case 6: return CALL(float, 6);                           \
      case 7: return CALL(float, 7);                           \
      case 8: return CALL(float, 8);                           \
    }                                                          \
  }                                                            \
  return (int)cudaErrorInvalidValue;

bool bad_width(int D) { return D < 4 || D > 8192 || D % 4 != 0; }

}  // namespace

// x (rows, D) bf16 (bf16 != 0) or f32; w, b (D,) f32; y (rows, D) f32;
// stats (rows, 2) f32.  D a multiple of 4 up to 8192, every pointer 16-byte
// aligned.
extern "C" int tdr_layer_norm_fwd(const void* x, int bf16, const float* w,
                                  const float* b, float* y, float* stats,
                                  int rows, int D, float eps, void* stream) {
  if (bad_width(D) || rows < 0) return (int)cudaErrorInvalidValue;
#define TDR_LN_FWD(T, N) \
  fwd<T, N>(x, w, b, y, stats, rows, D, W, eps, (cudaStream_t)stream)
  TDR_LN_DISPATCH(TDR_LN_FWD)
#undef TDR_LN_FWD
}

// The backward's persistent grid on the current device: the blocks of
// tdr_layer_norm_bwd that fit on all its SMs at once.  The caller sizes
// the partial sums (blocks, 2, D) f32 by it.
extern "C" int tdr_layer_norm_bwd_blocks(int bf16, int D, int* blocks) {
  if (bad_width(D)) return (int)cudaErrorInvalidValue;
#define TDR_LN_BLOCKS(T, N) bwd_blocks<T, N>(D, W, blocks)
  TDR_LN_DISPATCH(TDR_LN_BLOCKS)
#undef TDR_LN_BLOCKS
}

// dy (rows, D) f32; x (rows, D) and dx bf16 or f32; w (D,) f32; stats the
// forward's; part (blocks, 2, D) f32 scratch; dw and db (D,) f32.
extern "C" int tdr_layer_norm_bwd(const float* dy, const void* x, int bf16,
                                  const float* w, const float* stats,
                                  void* dx, float* part, int blocks,
                                  float* dw, float* db, int rows, int D,
                                  void* stream) {
  if (bad_width(D) || rows < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
#define TDR_LN_BWD(T, N)                                           \
  bwd<T, N>(dy, x, w, stats, dx, part, blocks, dw, db, rows, D, W, \
            (cudaStream_t)stream)
  TDR_LN_DISPATCH(TDR_LN_BWD)
#undef TDR_LN_BWD
}
