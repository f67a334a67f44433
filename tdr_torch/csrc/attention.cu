// The encoder's masked softmax attention over (B, H, L, DH) bf16 heads,
// forward and backward, written for Hopper (sm_90a).
//
// Replaces no TPU kernel: tdr's encoder (tdr/models/encoder.py) leaves its
// attention to XLA.  PyTorch ran the port's plain version
// (tdr_torch/ops/attention.py, attend_plain) as a kernel per pass over the
// (B, H, L, L) scores: the product, a masked fill against a broadcast
// (B, 1, L, L) mask, the softmax, the product with v, a transposing copy;
// autograd adds the products' dP, the softmax backward and a second masked
// fill, and keeps P alive from the forward.  Here the scores never leave
// the SM: the forward reads q, k and v and writes the output, the backward
// reads them with dO and writes dq, dk and dv.
//
// What it computes, at the plain version's rounding points (only the sums
// run in another order), with scale = bf16(sqrt(DH)):
//   forward:  q_s = bf16(q / scale);  S = bf16(q_s k^T) (f32 sums);
//     S = finfo(bf16).min where the key or the query is padded;
//     P = bf16(exp(S - max) / sum) over the whole key row in f32, so a
//     padded query row gets the uniform 1/L, never NaN;
//     O = bf16(P v), written straight into the (B, L, H * DH) layout of the
//     output projection's input; each row's f32 (max, sum) is saved.
//   backward: P recomputed from q, k and the saved (max, sum);
//     dP = bf16(dO v^T);  dv = bf16(P^T dO);
//     dS = bf16(P (dP - sum_j P dP)) in f32 from the bf16 P and dP (torch's
//     softmax backward), 0 wherever the mask is false (masked_fill's
//     backward: every entry of a padded query row);
//     dq = bf16(bf16(dS k) / scale);  dk = bf16(dS^T q_s).
//   The divisions are IEEE-rounded, by a correctly rounded reciprocal and
//   one fma step (Markstein), and exp is expf, as torch's kernels take them.
//
// What bounds it on this card: memory.  At the train path's shape,
// (2048, 12, 128, 32) a layer, the forward reads q, k, v and writes O and
// the statistics, 0.83 GB: 0.25 ms at 3.35 TB/s; the backward reads q, k,
// v, dO and the statistics and writes dq, dk, dv, 1.43 GB: 0.43 ms.  Its
// five products (the backward recomputes S) are 0.13 TFLOP a layer.  The
// exact softmax (expf and a division for each of the 16,384 scores of a
// head, twice) puts the issue of instructions close behind.
//
// The design: a block of 8 warps takes a tile of 128 rows, a warp 16 of
// them, with the mma.sync m16n8k16 bf16 tensor-core instruction and
// ldmatrix from shared memory (row strides padded by 16 bytes, so no bank
// conflicts); tiles arrive by cp.async.  A warp's 16 x 128 tile of S stays
// in registers in the accumulator layout: a thread holds 2 rows x 32 keys,
// the row max and sum are quad shuffles, and P is rounded to bf16 pairs in
// registers as the A operand of P v.  At L <= 128 one tile holds a whole
// key row.  The forward then runs persistent blocks, as many as fit on the
// card, each walking (sequence, head) pairs with the next pair's q, k and
// v in flight into a second stage of shared memory while it computes the
// current one.  The backward takes one (sequence, head) a block: S, P and
// dP for its rows in registers, D = sum_j P dP by quad shuffles, dS as bf16
// pairs in registers for dq = dS k; P and then dS go through one shared
// tile, where each warp reads them transposed (ldmatrix .trans) as the A
// operands of dv = P^T dO and dk = dS^T q_s for its 16 keys.  No atomics,
// so a step repeats bit for bit.  For 128 < L <= 512 the tiles loop,
// keeping the rounding points: the forward makes three passes over the key
// tiles (the row max, the sum, then P v); the backward first takes each
// row's D over every key tile, then walks the key tiles in the outer loop
// (dk and dv in registers) and the query tiles in the inner one, adding
// each tile pair's dS k to an f32 dq scratch that only this block touches,
// and rounds dq at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;     // 128 query or key rows a tile
constexpr int kMaxL = 512;
constexpr int kPS = kTile + 8;         // row stride of the P / dS tile

// a key of the tile: masked, valid, or past L (not part of the row)
constexpr uint8_t kMasked = 0, kValid = 1, kPast = 2;

struct Operands {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long sb, sh, sl;                // their strides, in elements
  const uint8_t* valid;                // (B, L)
  int H, L;
  float scale;                         // bf16(sqrt(DH))
};

__device__ __forceinline__ float mask_value() {
  return __uint_as_float(0xff7f0000u);  // finfo(bfloat16).min
}

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float lo_of(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_of(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// x / d rounded as IEEE division, from r = the correctly rounded 1 / d:
// the quotient x r is within an ulp, and one fma step on its remainder
// (exact by fma) rounds it right (Markstein), for the normal x and d here
__device__ __forceinline__ float div_by(float x, float d, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, d, x), r, q);
}

__device__ __forceinline__ uint32_t div_pair(uint32_t w, float d, float r) {
  return pack(div_by(lo_of(w), d, r), div_by(hi_of(w), d, r));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread but the newest n has landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldsm(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Starts the copy of rows r0 .. r0 + kTile - 1 of an (L, DH) slice at src
// (row stride ld, in elements) into dst (row stride DH + 8), zeros past L.
template <int DH>
__device__ __forceinline__ void issue_tile(bf16* dst, const bf16* src,
                                           long long ld, int r0, int L) {
  constexpr int C = DH / 8;            // 16-byte chunks a row
  for (int c = threadIdx.x; c < kTile * C; c += kThreads) {
    const int r = c / C, col = (c % C) * 8;
    const bool in = r0 + r < L;
    cp_async16(dst + r * (DH + 8) + col,
               in ? src + (long long)(r0 + r) * ld + col : src, in ? 16 : 0);
  }
}

// After its copies have landed: this thread's own chunks of a q tile (as
// issue_tile gave them out) divided by scale, q_s.
template <int DH>
__device__ __forceinline__ void scale_own(bf16* tile, float d, float r) {
  constexpr int C = DH / 8;
  for (int c = threadIdx.x; c < kTile * C; c += kThreads) {
    uint4* p = reinterpret_cast<uint4*>(tile + (c / C) * (DH + 8)
                                        + (c % C) * 8);
    uint4 x = *p;
    x.x = div_pair(x.x, d, r);
    x.y = div_pair(x.y, d, r);
    x.z = div_pair(x.z, d, r);
    x.w = div_pair(x.w, d, r);
    *p = x;
  }
}

__device__ __forceinline__ uint8_t key_state(const uint8_t* valid, int key,
                                             int L) {
  return key < L ? (valid[key] ? kValid : kMasked) : kPast;
}

__device__ __forceinline__ void load_keys(uint8_t* dst, const uint8_t* valid,
                                          int k0, int L) {
  for (int j = threadIdx.x; j < kTile; j += kThreads)
    dst[j] = key_state(valid, k0 + j, L);
}

// The A operand of this warp's 16 rows of a (kTile, DH) tile, DH / 16
// slices of 16 columns.
template <int DH>
__device__ __forceinline__ void row_operand(uint32_t a[DH / 16][4],
                                            const bf16* tile, int warp,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldsm(a[kk], tile + (16 * warp + (lane & 15)) * (DH + 8) + 16 * kk
                    + 8 * (lane >> 4));
}

// s = this warp's 16 rows (A operand a) times the tile's 128 rows of y
// transposed: s[n] holds columns 8n .. 8n + 7 in the accumulator layout
// (rows g and g + 8, columns 8n + 2t and 8n + 2t + 1).
template <int DH>
__device__ __forceinline__ void times_rows(float s[16][4],
                                           const uint32_t a[DH / 16][4],
                                           const bf16* y, int lane) {
#pragma unroll
  for (int n = 0; n < 16; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      uint32_t b[4];
      ldsm(b, y + (16 * np + (lane & 7) + 8 * (lane >> 4)) * (DH + 8)
                 + 16 * kk + 8 * ((lane >> 3) & 1));
      mma(s[2 * np], a[kk], b[0], b[1]);
      mma(s[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 rows x DH) += x (this warp's 16 rows x 128 columns as bf16 pairs:
// x[n][0] row g, x[n][1] row g + 8, columns 8n + 2t, + 1) times the tile y
// (128 rows x DH).
template <int DH>
__device__ __forceinline__ void times_tile(float acc[DH / 8][4],
                                           const uint32_t x[16][2],
                                           const bf16* y, int lane) {
#pragma unroll
  for (int kj = 0; kj < 8; ++kj) {
    const uint32_t a[4] = {x[2 * kj][0], x[2 * kj][1], x[2 * kj + 1][0],
                           x[2 * kj + 1][1]};
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t b[4];
      ldsm_t(b, y + (16 * kj + (lane & 7) + 8 * ((lane >> 3) & 1)) * (DH + 8)
                   + 16 * dp + 8 * (lane >> 4));
      mma(acc[2 * dp], a, b[0], b[1]);
      mma(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// acc (this warp's 16 columns c0 .. c0 + 15 of x, by DH) += x^T y: x the
// (128, kTile) P or dS tile (row stride kPS), y a (128, DH) tile.
template <int DH>
__device__ __forceinline__ void times_tile_t(float acc[DH / 8][4],
                                             const bf16* x, const bf16* y,
                                             int c0, int lane) {
#pragma unroll
  for (int kq = 0; kq < 8; ++kq) {
    uint32_t a[4];
    ldsm_t(a, x + (16 * kq + (lane & 7) + 8 * (lane >> 4)) * kPS + c0
                 + 8 * ((lane >> 3) & 1));
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t b[4];
      ldsm_t(b, y + (16 * kq + (lane & 7) + 8 * ((lane >> 3) & 1)) * (DH + 8)
                   + 16 * dp + 8 * (lane >> 4));
      mma(acc[2 * dp], a, b[0], b[1]);
      mma(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// S rounded to bf16 and masked: finfo.min where the key or the query is
// masked, -inf past L (out of the row).
__device__ __forceinline__ void mask_scores(float s[16][4],
                                            const uint8_t* keys, bool qv0,
                                            bool qv1, int t) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint8_t st = keys[8 * n + 2 * t + e];
      s[n][e] = st == kPast ? neg_inf()
              : (qv0 && st == kValid ? round_bf16(s[n][e]) : mask_value());
      s[n][2 + e] = st == kPast ? neg_inf()
              : (qv1 && st == kValid ? round_bf16(s[n][2 + e])
                                     : mask_value());
    }
  }
}

__device__ __forceinline__ void row_max(const float s[16][4], float& m0,
                                        float& m1) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
    m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
  }
}

// A row's softmax: its max, its sum, and 1 / sum correctly rounded.
struct RowStats {
  float m, l, r;
};

__device__ __forceinline__ RowStats row_stats(float m, float l) {
  return {m, l, __frcp_rn(l)};
}

// P = bf16(exp(S - max) / sum) for masked S, as bf16 pairs (low column
// first): p[n][0] row g, p[n][1] row g + 8.
__device__ __forceinline__ void probs(uint32_t p[16][2], const float s[16][4],
                                      RowStats r0, RowStats r1) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    p[n][0] = pack(div_by(expf(s[n][0] - r0.m), r0.l, r0.r),
                   div_by(expf(s[n][1] - r0.m), r0.l, r0.r));
    p[n][1] = pack(div_by(expf(s[n][2] - r1.m), r1.l, r1.r),
                   div_by(expf(s[n][3] - r1.m), r1.l, r1.r));
  }
}

// An accumulator's 16 x DH rows into a staging tile (row stride DH + 8),
// rounded to bf16; with kDiv first rounded, divided by d (1 / d = r) and
// rounded again (dq = bf16(bf16(dS k) / scale)).
template <int DH, bool kDiv>
__device__ __forceinline__ void stage(bf16* dst, const float acc[DH / 8][4],
                                      int lane, float d, float r) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = kDiv ? div_by(round_bf16(acc[n][e]), d, r) : acc[n][e];
    *reinterpret_cast<uint32_t*>(dst + g * (DH + 8) + 8 * n + 2 * t) =
        pack(v[0], v[1]);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * (DH + 8) + 8 * n + 2 * t) =
        pack(v[2], v[3]);
  }
}

// A warp's 16 staged rows (row stride DH + 8) to rows r0 .. r0 + 15 of an
// (L, DH) slice at dst with row stride ld; rows past L left out.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld,
                                           const bf16* src, int r0, int L,
                                           int lane) {
  constexpr int C = DH / 8;
  for (int c = lane; c < 16 * C; c += 32) {
    const int r = c / C, col = (c % C) * 8;
    if (r0 + r < L)
      *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * ld + col) =
          *reinterpret_cast<const uint4*>(src + r * (DH + 8) + col);
  }
}

// ---- forward ----------------------------------------------------------------

template <int DH>
struct FwdStage {
  bf16 q[kTile * (DH + 8)];
  bf16 k[kTile * (DH + 8)];
  bf16 v[kTile * (DH + 8)];
  uint8_t keys[kTile];
};

// this warp's q_s operand: the raw q tile's rows divided by scale
template <int DH>
__device__ __forceinline__ void query_operand(uint32_t qa[DH / 16][4],
                                              const bf16* sq, float d,
                                              float r, int warp, int lane) {
  row_operand<DH>(qa, sq, warp, lane);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) qa[kk][j] = div_pair(qa[kk][j], d, r);
}

// The output (bf16) and the rows' statistics of a warp's 16 rows from
// q0 + 16 warp on, staged through its own rows of the stage's q tile.
template <int DH>
__device__ __forceinline__ void write_rows(const Operands& a, bf16* out,
                                           float2* stats, bf16* sq, int bh,
                                           int b, int h, int q0,
                                           const float o[DH / 8][4],
                                           RowStats r0, RowStats r1,
                                           int warp, int lane) {
  const int L = a.L;
  bf16* st = sq + 16 * warp * (DH + 8);
  __syncwarp();
  stage<DH, false>(st, o, lane, 1.0f, 1.0f);
  __syncwarp();
  const long long ld = (long long)a.H * DH;
  store_rows<DH>(out + (long long)b * L * ld + h * DH, ld, st,
                 q0 + 16 * warp, L, lane);
  if ((lane & 3) == 0) {
    const int row0 = q0 + 16 * warp + (lane >> 2), row1 = row0 + 8;
    if (row0 < L) stats[(long long)bh * L + row0] = make_float2(r0.m, r0.l);
    if (row1 < L) stats[(long long)bh * L + row1] = make_float2(r1.m, r1.l);
  }
}

// One (sequence, head) at L <= 128, its tiles in stage st.
template <int DH>
__device__ __forceinline__ void forward_one_tile(const Operands& a,
                                                 bf16* out, float2* stats,
                                                 FwdStage<DH>& st, int bh,
                                                 float rscale) {
  const int b = bh / a.H, h = bh - b * a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, row0 = 16 * warp + (lane >> 2);
  // the tile's keys are its queries
  const bool qv0 = st.keys[row0] == kValid, qv1 = st.keys[row0 + 8] == kValid;
  float s[16][4];
  {
    uint32_t qa[DH / 16][4];
    query_operand<DH>(qa, st.q, a.scale, rscale, warp, lane);
    times_rows<DH>(s, qa, st.k, lane);
  }
  mask_scores(s, st.keys, qv0, qv1, t);
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.0f, l1 = 0.0f;
  row_max(s, m0, m1);
  m0 = quad_max(m0);
  m1 = quad_max(m1);
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[n][e] = expf(s[n][e] - m0);
      s[n][2 + e] = expf(s[n][2 + e] - m1);
      l0 = __fadd_rn(l0, s[n][e]);
      l1 = __fadd_rn(l1, s[n][2 + e]);
    }
  }
  const RowStats r0 = row_stats(m0, quad_sum(l0));
  const RowStats r1 = row_stats(m1, quad_sum(l1));
  uint32_t p[16][2];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    p[n][0] = pack(div_by(s[n][0], r0.l, r0.r), div_by(s[n][1], r0.l, r0.r));
    p[n][1] = pack(div_by(s[n][2], r1.l, r1.r), div_by(s[n][3], r1.l, r1.r));
  }
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  times_tile<DH>(o, p, st.v, lane);
  write_rows<DH>(a, out, stats, st.q, bh, b, h, 0, o, r0, r1, warp, lane);
}

// One query tile qt of (sequence, head) bh at L > 128: three passes over
// the key tiles, each through stage st.
template <int DH>
__device__ __forceinline__ void forward_tiles(const Operands& a, bf16* out,
                                              float2* stats,
                                              FwdStage<DH>& st, int bh,
                                              int qt, float rscale) {
  const int b = bh / a.H, h = bh - b * a.H;
  const int L = a.L, nt = (L + kTile - 1) / kTile, q0 = qt * kTile;
  const long long in = (long long)b * a.sb + (long long)h * a.sh;
  const uint8_t* valid = a.valid + (long long)b * L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int row0 = q0 + 16 * warp + (lane >> 2), row1 = row0 + 8;
  const bool qv0 = row0 < L && valid[row0], qv1 = row1 < L && valid[row1];

  __syncthreads();                     // the stage is free
  issue_tile<DH>(st.q, a.q + in, a.sl, q0, L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[DH / 16][4];
  query_operand<DH>(qa, st.q, a.scale, rscale, warp, lane);

  float s[16][4];
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.0f, l1 = 0.0f;
  for (int pass = 0; pass < 2; ++pass) {       // the max, then the sum
    for (int kt = 0; kt < nt; ++kt) {
      __syncthreads();
      issue_tile<DH>(st.k, a.k + in, a.sl, kt * kTile, L);
      cp_async_commit();
      load_keys(st.keys, valid, kt * kTile, L);
      cp_async_wait<0>();
      __syncthreads();
      times_rows<DH>(s, qa, st.k, lane);
      mask_scores(s, st.keys, qv0, qv1, t);
      if (pass == 0) {
        row_max(s, m0, m1);
      } else {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            l0 = __fadd_rn(l0, expf(s[n][e] - m0));
            l1 = __fadd_rn(l1, expf(s[n][2 + e] - m1));
          }
        }
      }
    }
    if (pass == 0) {
      m0 = quad_max(m0);
      m1 = quad_max(m1);
    } else {
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
    }
  }
  // the third pass: P v, the statistics whole
  const RowStats r0 = row_stats(m0, l0), r1 = row_stats(m1, l1);
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  for (int kt = 0; kt < nt; ++kt) {
    __syncthreads();
    issue_tile<DH>(st.k, a.k + in, a.sl, kt * kTile, L);
    issue_tile<DH>(st.v, a.v + in, a.sl, kt * kTile, L);
    cp_async_commit();
    load_keys(st.keys, valid, kt * kTile, L);
    cp_async_wait<0>();
    __syncthreads();
    times_rows<DH>(s, qa, st.k, lane);
    mask_scores(s, st.keys, qv0, qv1, t);
    uint32_t p[16][2];
    probs(p, s, r0, r1);
    times_tile<DH>(o, p, st.v, lane);
  }
  // no other warp reads this warp's rows of the q tile again
  write_rows<DH>(a, out, stats, st.q, bh, b, h, q0, o, r0, r1, warp, lane);
}

// kOne: L <= 128, a key row in one tile (the rows of a longer L take
// their own instantiation, and so their own registers)
template <int DH, bool kOne>
__global__ void __launch_bounds__(kThreads, 2) encoder_attention_fwd(
    Operands a, bf16* __restrict__ out, float2* __restrict__ stats,
    int items) {
  extern __shared__ __align__(16) uint8_t smem[];
  FwdStage<DH>* stages = reinterpret_cast<FwdStage<DH>*>(smem);
  const float rscale = __frcp_rn(a.scale);
  const int L = a.L;
  if constexpr (!kOne) {
    const int nt = (L + kTile - 1) / kTile;
    for (int item = blockIdx.x; item < items; item += gridDim.x)
      forward_tiles<DH>(a, out, stats, stages[0], item / nt, item % nt,
                        rscale);
    return;
  }
  // L <= 128: an item is a (sequence, head); the next one's tiles land in
  // the other stage while this one is computed
  int item = blockIdx.x;
  if (item >= items) return;
  const int tid = threadIdx.x;
  auto issue = [&](FwdStage<DH>& st, int bh) {
    const int b = bh / a.H, h = bh - b * a.H;
    const long long in = (long long)b * a.sb + (long long)h * a.sh;
    issue_tile<DH>(st.q, a.q + in, a.sl, 0, L);
    issue_tile<DH>(st.k, a.k + in, a.sl, 0, L);
    issue_tile<DH>(st.v, a.v + in, a.sl, 0, L);
  };
  auto state = [&](int bh) -> uint8_t {
    return key_state(a.valid + (long long)(bh / a.H) * L, tid, L);
  };
  issue(stages[0], item);
  cp_async_commit();
  if (tid < kTile) stages[0].keys[tid] = state(item);
  for (int i = 0; item < items; ++i, item += gridDim.x) {
    FwdStage<DH>& cur = stages[i & 1];
    FwdStage<DH>& nxt = stages[(i & 1) ^ 1];
    const int next = item + gridDim.x;
    if (next < items) issue(nxt, next);
    cp_async_commit();                 // (empty past the last item)
    const uint8_t ks = next < items && tid < kTile ? state(next) : 0;
    cp_async_wait<1>();                // this item's tiles have landed
    __syncthreads();
    forward_one_tile<DH>(a, out, stats, cur, item, rscale);
    if (tid < kTile) nxt.keys[tid] = ks;
    __syncthreads();                   // the next issue overwrites cur
  }
}

// ---- backward ---------------------------------------------------------------

// This warp's rows of a query tile against a key tile: P (from the saved
// statistics) into its rows of the P tile sp, dP = bf16(dO v^T) into dp;
// returns this thread's parts of sum_j P dP for its two rows.
template <int DH>
__device__ __forceinline__ float2 probs_and_dp(
    float dp[16][4], bf16* sp, const bf16* sq, const bf16* sdo,
    const bf16* sk, const bf16* sv, const uint8_t* keys, bool qv0, bool qv1,
    RowStats r0, RowStats r1, int warp, int lane) {
  const int t = lane & 3;
  uint32_t* pr = reinterpret_cast<uint32_t*>(sp + (16 * warp + (lane >> 2))
                                             * kPS + 2 * t);
  {
    uint32_t a[DH / 16][4];
    row_operand<DH>(a, sq, warp, lane);
    times_rows<DH>(dp, a, sk, lane);   // S, for now
  }
  mask_scores(dp, keys, qv0, qv1, t);
  {
    uint32_t p[16][2];
    probs(p, dp, r0, r1);
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      pr[4 * n] = p[n][0];
      pr[4 * kPS + 4 * n] = p[n][1];
    }
  }
  {
    uint32_t a[DH / 16][4];
    row_operand<DH>(a, sdo, warp, lane);
    times_rows<DH>(dp, a, sv, lane);
  }
  float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const uint32_t w0 = pr[4 * n], w1 = pr[4 * kPS + 4 * n];
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[n][e] = round_bf16(dp[n][e]);
    d0 = fmaf(lo_of(w0), dp[n][0], d0);
    d0 = fmaf(hi_of(w0), dp[n][1], d0);
    d1 = fmaf(lo_of(w1), dp[n][2], d1);
    d1 = fmaf(hi_of(w1), dp[n][3], d1);
  }
  return make_float2(d0, d1);
}

// A block's tiles in the backward.
template <int DH>
struct BwdTiles {
  bf16 q[kTile * (DH + 8)];            // q_s
  bf16 dout[kTile * (DH + 8)];
  bf16 k[kTile * (DH + 8)];
  bf16 v[kTile * (DH + 8)];
  bf16 p[kTile * kPS];                 // P, then dS
  float d[kMaxL];                      // each row's D, for L > 128
  uint8_t keys[kTile];
};

// What a block of the backward works on: one (sequence, head).
struct BwdHead {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const uint8_t* valid;
  const float2* stats;
  long long sl, ld;                    // row strides of q, k, v; of dO
  int L;
  float scale, rscale;
};

// The tiles qt (of q_s and dO) and, with keys_too, kt (of k, v and the
// key states); every thread of the block calls it.
template <int DH>
__device__ __forceinline__ void load_tiles(BwdTiles<DH>& s, const BwdHead& x,
                                           int qt, int kt, bool keys_too) {
  issue_tile<DH>(s.q, x.q, x.sl, qt * kTile, x.L);
  issue_tile<DH>(s.dout, x.dout, x.ld, qt * kTile, x.L);
  if (keys_too) {
    issue_tile<DH>(s.k, x.k, x.sl, kt * kTile, x.L);
    issue_tile<DH>(s.v, x.v, x.sl, kt * kTile, x.L);
  }
  cp_async_commit();
  if (keys_too) load_keys(s.keys, x.valid, kt * kTile, x.L);
  cp_async_wait<0>();
  scale_own<DH>(s.q, x.scale, x.rscale);
  __syncthreads();
}

// This thread's two rows of query tile qt.
struct BwdRows {
  int row0, row1;
  bool qv0, qv1;
  RowStats r0, r1;
};

__device__ __forceinline__ BwdRows rows_of(const BwdHead& x, int qt) {
  BwdRows r;
  r.row0 = qt * kTile + 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
  r.row1 = r.row0 + 8;
  r.qv0 = r.row0 < x.L && x.valid[r.row0] != 0;
  r.qv1 = r.row1 < x.L && x.valid[r.row1] != 0;
  const float2 s0 = r.row0 < x.L ? x.stats[r.row0] : make_float2(0.0f, 1.0f);
  const float2 s1 = r.row1 < x.L ? x.stats[r.row1] : make_float2(0.0f, 1.0f);
  r.r0 = row_stats(s0.x, s0.y);
  r.r1 = row_stats(s1.x, s1.y);
  return r;
}

// This warp's rows of the loaded query tile against the loaded key tile:
// P into its rows of s.p, and dS = bf16(P (dP - D)) (0 where masked) as
// bf16 pairs in ds; D from the quad's sums (the tile is the whole row) or,
// with s.d, from the first pass.
template <int DH>
__device__ __forceinline__ void row_phase(uint32_t ds[16][2],
                                          BwdTiles<DH>& s, const BwdRows& r,
                                          bool whole_row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  float dp[16][4];
  float2 d = probs_and_dp<DH>(dp, s.p, s.q, s.dout, s.k, s.v, s.keys, r.qv0,
                              r.qv1, r.r0, r.r1, warp, lane);
  if (whole_row) {
    d.x = quad_sum(d.x);
    d.y = quad_sum(d.y);
  } else {
    d.x = r.qv0 ? s.d[r.row0] : 0.0f;
    d.y = r.qv1 ? s.d[r.row1] : 0.0f;
  }
  const uint32_t* pr = reinterpret_cast<const uint32_t*>(
      s.p + (16 * warp + (lane >> 2)) * kPS + 2 * t);
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const uint32_t w0 = pr[4 * n], w1 = pr[4 * kPS + 4 * n];
    float x[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool kv = s.keys[8 * n + 2 * t + e] == kValid;
      x[e] = kv && r.qv0 ? __fmul_rn(e ? hi_of(w0) : lo_of(w0),
                                     __fsub_rn(dp[n][e], d.x)) : 0.0f;
      x[2 + e] = kv && r.qv1 ? __fmul_rn(e ? hi_of(w1) : lo_of(w1),
                                         __fsub_rn(dp[n][2 + e], d.y))
                             : 0.0f;
    }
    ds[n][0] = pack(x[0], x[1]);
    ds[n][1] = pack(x[2], x[3]);
  }
}

// This warp's 16 keys of the tile pair: dv += P^T dO, then (dS written
// over P) dk += dS^T q_s.  Every thread of the block calls it.
template <int DH>
__device__ __forceinline__ void column_phase(float dva[DH / 8][4],
                                             float dka[DH / 8][4],
                                             const uint32_t ds[16][2],
                                             BwdTiles<DH>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                     // the P tile is whole
  times_tile_t<DH>(dva, s.p, s.dout, 16 * warp, lane);
  __syncthreads();                     // every warp has read P
  uint32_t* dr = reinterpret_cast<uint32_t*>(
      s.p + (16 * warp + (lane >> 2)) * kPS + 2 * (lane & 3));
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    dr[4 * n] = ds[n][0];
    dr[4 * kPS + 4 * n] = ds[n][1];
  }
  __syncthreads();                     // the dS tile is whole
  times_tile_t<DH>(dka, s.p, s.q, 16 * warp, lane);
}

template <int DH>
__device__ __forceinline__ void zero(float acc[DH / 8][4]) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
}

// dk and dv of this warp's 16 keys of key tile kt, through its own rows
// of s.k and s.v: only once no warp reads those tiles again (past the
// column phase, whose first barrier every warp's products with k passed).
template <int DH>
__device__ __forceinline__ void write_kv(bf16* dk, bf16* dv, long long ld,
                                         BwdTiles<DH>& s,
                                         const float dka[DH / 8][4],
                                         const float dva[DH / 8][4], int kt,
                                         int L) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* stk = s.k + 16 * warp * (DH + 8);
  bf16* stv = s.v + 16 * warp * (DH + 8);
  stage<DH, false>(stk, dka, lane, 1.0f, 1.0f);
  stage<DH, false>(stv, dva, lane, 1.0f, 1.0f);
  __syncwarp();
  store_rows<DH>(dk, ld, stk, kt * kTile + 16 * warp, L, lane);
  store_rows<DH>(dv, ld, stv, kt * kTile + 16 * warp, L, lane);
}

template <int DH, bool kOne>
__global__ void __launch_bounds__(kThreads, kOne && DH <= 32 ? 2 : 1)
    encoder_attention_bwd(Operands a, const bf16* __restrict__ dout,
                          const float2* __restrict__ stats,
                          bf16* __restrict__ dq, bf16* __restrict__ dk,
                          bf16* __restrict__ dv,
                          float* __restrict__ dq_part) {
  extern __shared__ __align__(16) uint8_t smem[];
  BwdTiles<DH>& s = *reinterpret_cast<BwdTiles<DH>*>(smem);
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int L = a.L, nt = (L + kTile - 1) / kTile;
  const long long in = (long long)b * a.sb + (long long)h * a.sh;
  const long long ld = (long long)a.H * DH;
  const long long ob = (long long)b * L * ld + h * DH;
  const BwdHead x{a.q + in, a.k + in, a.v + in, dout + ob,
                  a.valid + (long long)b * L, stats + (long long)bh * L,
                  a.sl, ld, L, a.scale, __frcp_rn(a.scale)};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t ds[16][2];

  if constexpr (kOne) {
    load_tiles<DH>(s, x, 0, 0, true);
    row_phase<DH>(ds, s, rows_of(x, 0), true);
    float dqa[DH / 8][4];
    zero<DH>(dqa);
    times_tile<DH>(dqa, ds, s.k, lane);
    {
      float dka[DH / 8][4], dva[DH / 8][4];
      zero<DH>(dka);
      zero<DH>(dva);
      column_phase<DH>(dva, dka, ds, s);   // past it no warp reads s.k, s.v
      write_kv<DH>(dk + ob, dv + ob, ld, s, dka, dva, 0, L);
    }
    __syncthreads();                   // no warp reads s.q again
    bf16* stq = s.q + 16 * warp * (DH + 8);
    stage<DH, true>(stq, dqa, lane, x.scale, x.rscale);
    __syncwarp();
    store_rows<DH>(dq + ob, ld, stq, 16 * warp, L, lane);
    return;
  }

  // L > 128: each row's D = sum_j P dP over every key tile first
  const int t = lane & 3;
  for (int qt = 0; qt < nt; ++qt) {
    const BwdRows r = rows_of(x, qt);
    float d0 = 0.0f, d1 = 0.0f;
    for (int kt = 0; kt < nt; ++kt) {
      __syncthreads();
      load_tiles<DH>(s, x, qt, kt, true);
      float dp[16][4];
      const float2 d = probs_and_dp<DH>(dp, s.p, s.q, s.dout, s.k, s.v,
                                        s.keys, r.qv0, r.qv1, r.r0, r.r1,
                                        warp, lane);
      d0 = __fadd_rn(d0, d.x);
      d1 = __fadd_rn(d1, d.y);
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    if (t == 0) {
      if (r.row0 < L) s.d[r.row0] = d0;
      if (r.row1 < L) s.d[r.row1] = d1;
    }
  }
  // then the key tiles, each over every query tile; dS k summed over the
  // key tiles in the f32 scratch, each thread on its own elements of it
  float* part = dq_part + (long long)bh * L * DH;
  for (int kt = 0; kt < nt; ++kt) {
    float dka[DH / 8][4], dva[DH / 8][4];
    zero<DH>(dka);
    zero<DH>(dva);
    for (int qt = 0; qt < nt; ++qt) {
      __syncthreads();                 // every warp is done with the tiles
      load_tiles<DH>(s, x, qt, kt, qt == 0);
      const BwdRows r = rows_of(x, qt);
      row_phase<DH>(ds, s, r, false);
      float acc[DH / 8][4];
      zero<DH>(acc);
      times_tile<DH>(acc, ds, s.k, lane);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? r.row1 : r.row0;
          if (row < L) {
            float2* y = reinterpret_cast<float2*>(part + (long long)row * DH
                                                  + 8 * n + 2 * t);
            float2 z = kt ? *y : make_float2(0.0f, 0.0f);
            z.x = __fadd_rn(z.x, acc[n][2 * half]);
            z.y = __fadd_rn(z.y, acc[n][2 * half + 1]);
            *y = z;
          }
        }
      }
      column_phase<DH>(dva, dka, ds, s);
    }
    write_kv<DH>(dk + ob, dv + ob, ld, s, dka, dva, kt, L);
  }
  __syncthreads();                     // the block's scratch is whole
  // dq = bf16(bf16(dS k) / scale)
  for (int c = threadIdx.x; c < L * (DH / 4); c += kThreads) {
    const int row = c / (DH / 4), col = (c % (DH / 4)) * 4;
    const float4 y = *reinterpret_cast<const float4*>(
        part + (long long)row * DH + col);
    uint2 z;
    z.x = pack(div_by(round_bf16(y.x), x.scale, x.rscale),
               div_by(round_bf16(y.y), x.scale, x.rscale));
    z.y = pack(div_by(round_bf16(y.z), x.scale, x.rscale),
               div_by(round_bf16(y.w), x.scale, x.rscale));
    *reinterpret_cast<uint2*>(dq + ob + (long long)row * ld + col) = z;
  }
}

// the blocks of `kernel` that fit on the current device at once
template <typename K>
int resident_blocks(K kernel, size_t smem, int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = per_sm * sms;
  if (e == cudaSuccess && *blocks < 1) e = cudaErrorInvalidConfiguration;
  return (int)e;
}

template <int DH, bool kOne>
int fwd_launch(const Operands& a, int B, void* out, void* stats,
               cudaStream_t stream) {
  const auto kernel = encoder_attention_fwd<DH, kOne>;
  const size_t smem = 2 * sizeof(FwdStage<DH>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long items =
      (long long)B * a.H * ((a.L + kTile - 1) / kTile);
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = resident_blocks(kernel, smem, &blocks);
  if (err != 0) return err;
  if (items < blocks) blocks = (int)items;
  kernel<<<blocks, kThreads, smem, stream>>>(a, (bf16*)out, (float2*)stats,
                                             (int)items);
  return (int)cudaGetLastError();
}

template <int DH>
int fwd(const Operands& a, int B, void* out, void* stats,
        cudaStream_t stream) {
  return a.L <= kTile ? fwd_launch<DH, true>(a, B, out, stats, stream)
                      : fwd_launch<DH, false>(a, B, out, stats, stream);
}

template <int DH, bool kOne>
int bwd_launch(const Operands& a, int B, const void* dout, const void* stats,
               void* dq, void* dk, void* dv, float* dq_part,
               cudaStream_t stream) {
  const auto kernel = encoder_attention_bwd<DH, kOne>;
  const size_t smem = sizeof(BwdTiles<DH>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B * a.H, kThreads, smem, stream>>>(
      a, (const bf16*)dout, (const float2*)stats, (bf16*)dq, (bf16*)dk,
      (bf16*)dv, dq_part);
  return (int)cudaGetLastError();
}

template <int DH>
int bwd(const Operands& a, int B, const void* dout, const void* stats,
        void* dq, void* dk, void* dv, float* dq_part, cudaStream_t stream) {
  return a.L <= kTile
             ? bwd_launch<DH, true>(a, B, dout, stats, dq, dk, dv, dq_part,
                                    stream)
             : bwd_launch<DH, false>(a, B, dout, stats, dq, dk, dv, dq_part,
                                     stream);
}

bool bad_shape(int B, int H, int L) {
  return B < 1 || H < 1 || L < 1 || L > kMaxL
         || (long long)B * H > (long long)INT_MAX;
}

}  // namespace

// q, k, v (B, H, L, DH) bf16 sharing the strides (sb, sh, sl) in elements,
// the last dimension contiguous, every row 16-byte aligned; valid (B, L)
// bool; out (B, L, H * DH) bf16; stats (B, H, L, 2) f32.  DH 16, 32 or 64,
// L up to 512; scale = bf16(sqrt(DH)).
extern "C" int tdr_attention_fwd(const void* q, const void* k, const void* v,
                                 long long sb, long long sh, long long sl,
                                 const void* valid, void* out, void* stats,
                                 int B, int H, int L, int DH, float scale,
                                 void* stream) {
  if (bad_shape(B, H, L)) return (int)cudaErrorInvalidValue;
  const Operands a{(const bf16*)q, (const bf16*)k, (const bf16*)v, sb, sh,
                   sl, (const uint8_t*)valid, H, L, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (DH) {
    case 16: return fwd<16>(a, B, out, stats, s);
    case 32: return fwd<32>(a, B, out, stats, s);
    case 64: return fwd<64>(a, B, out, stats, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dout (B, L, H * DH) bf16, contiguous; q, k, v, valid and scale as the
// forward's, stats its output; dq, dk, dv (B, L, H * DH) bf16; dq_part
// (B, H, L, DH) f32 scratch for L > 128 (unused, may be null, below).
extern "C" int tdr_attention_bwd(const void* dout, const void* q,
                                 const void* k, const void* v, long long sb,
                                 long long sh, long long sl,
                                 const void* valid, const void* stats,
                                 void* dq, void* dk, void* dv, void* dq_part,
                                 int B, int H, int L, int DH, float scale,
                                 void* stream) {
  if (bad_shape(B, H, L) || (L > kTile && dq_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Operands a{(const bf16*)q, (const bf16*)k, (const bf16*)v, sb, sh,
                   sl, (const uint8_t*)valid, H, L, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (DH) {
    case 16: return bwd<16>(a, B, dout, stats, dq, dk, dv, (float*)dq_part, s);
    case 32: return bwd<32>(a, B, dout, stats, dq, dk, dv, (float*)dq_part, s);
    case 64: return bwd<64>(a, B, dout, stats, dq, dk, dv, (float*)dq_part, s);
  }
  return (int)cudaErrorInvalidValue;
}
