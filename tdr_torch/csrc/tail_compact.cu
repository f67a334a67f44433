// Tail-posting compaction for the BM25 tail terms, written for Hopper
// (sm_90a): one launch from a batch's query terms to its compacted rows.
//
// Replaces the TPU kernel `tail_compact_pallas` (tdr/ops/pallas_tail.py:152)
// together with the jitted program around its Pallas body: the level-1 term
// compaction (a stable T-wide sort), the offset scan and the overflow flag.
// The outputs are that function's, bit for bit, overflowed rows included:
//
//   docs (Q, W) int32, vals (Q, W) f32, overflow (Q,) bool.
//
// Per query, a term is a tail term when its (clamped) id has no head slot
// and its weight is > 0.  The first MT tail terms, in term order, each own
// one contiguous CSR segment [start, start + len) with len = df; their
// compacted offsets are off_t = min(sum_{s<t} len_s, budget).  Lane j of
// the row holds the LAST kept term t with off_t <= j < off_t + len_t,
// as (postings_doc[start_t + j - off_t], postings_w[...] * qw_t); a lane no
// term covers holds (sentinel, -1.0).  "Last" is the Pallas body's
// sequential overwrite order, which decides the lanes of an overflowed row
// whose clamped offsets overlap.  overflow = more than MT tail terms, or
// more than `budget` postings in the kept ones.
//
// What bounds it on this card: latency, then bytes.  At es Q = 256, W = 2048
// it writes 4.2 MB and reads under 0.2 MB (about 1.3 us at 3.35 TB/s), but
// each row sits behind three dependent loads (the query's terms, their
// slot/df/indptr, the postings).  So the design puts every step in one
// launch and keeps many rows in flight:
//
// * grid (Q, W / 512): a CTA of 128 threads owns 512 lanes of one row, so
//   a batch of 256 rows at W = 2048 is 1,024 CTAs, all resident at once on
//   the 132 SMs.  No lane can be live at or past budget + tail_pmax
//   (off <= budget, len <= tail_pmax): a CTA that starts there writes dead
//   lanes and does nothing else; at the main path's shapes (budget +
//   tail_pmax <= 272) only the first CTA of a row compacts its terms.
// * term compaction in one warp: each lane takes one term of a 32-term
//   chunk, the stable rank of a tail term is a __ballot_sync + __popc over
//   the chunk plus the count of earlier chunks (T = 69 on the PRF path
//   crosses two chunk boundaries), the kept terms go to shared memory, and
//   a __shfl_up_sync scan gives the offsets.
// * each thread owns 4 consecutive lanes, picks each lane's last covering
//   term from shared memory, loads its posting and stores the 4 lanes as
//   one 16-byte int4 and one float4: every lane is written once, with no
//   fill pass and no barrier per term.  __fmul_rn keeps the product a
//   rounded multiply, as the reference's is.
//
// The outputs have a fixed size, and nothing syncs with the host, so the
// launch can be captured in a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int kLanesPerThread = 4;
constexpr int kThreads = 128;
constexpr int kLanesPerCta = kThreads * kLanesPerThread;   // 512
constexpr int kMaxTerms = 32;                              // MT <= one warp
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) tail_compact_fused_kernel(
    const int* __restrict__ qids, const float* __restrict__ qw,
    const int* __restrict__ head_slot, const float* __restrict__ df,
    const int* __restrict__ indptr, const int* __restrict__ postings_doc,
    const float* __restrict__ postings_w, int* __restrict__ docs_out,
    float* __restrict__ vals_out, bool* __restrict__ overflow_out, int T,
    int MT, int W, int budget, int vocab, int pmax, int nnz, int sentinel) {
  const int q = blockIdx.x;
  const int lane0 = blockIdx.y * kLanesPerCta;
  const int j0 = lane0 + threadIdx.x * kLanesPerThread;
  int4* dst_d = reinterpret_cast<int4*>(docs_out + (size_t)q * W + j0);
  float4* dst_v = reinterpret_cast<float4*>(vals_out + (size_t)q * W + j0);

  if (lane0 >= budget + pmax) {          // uniform: every lane here is dead
    if (j0 < W) {
      *dst_d = make_int4(sentinel, sentinel, sentinel, sentinel);
      *dst_v = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
    }
    return;
  }

  __shared__ int s_start[kMaxTerms], s_off[kMaxTerms], s_len[kMaxTerms];
  __shared__ float s_w[kMaxTerms];
  __shared__ int s_kept;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int* qrow = qids + (size_t)q * T;
    const float* wrow = qw + (size_t)q * T;
    int n_tail = 0;                      // tail terms in earlier chunks
    for (int base = 0; base < T; base += 32) {
      const int t = base + lane;
      bool tail = false;
      int start = 0, len = 0;
      float w = 0.0f;
      if (t < T) {
        const int id = min(max(qrow[t], 0), vocab - 1);
        w = wrow[t];
        tail = head_slot[id] < 0 && w > 0.0f;
        if (tail) {
          start = indptr[id];
          len = (int)df[id];             // truncation, as .to(int32)
        }
      }
      const unsigned ballot = __ballot_sync(kFull, tail);
      const int rank = n_tail + __popc(ballot & ((1u << lane) - 1u));
      if (tail && rank < MT) {
        s_start[rank] = start;
        s_len[rank] = len;
        s_w[rank] = w;
      }
      n_tail += __popc(ballot);
    }
    __syncwarp();
    const int kept = min(n_tail, MT);
    const int len = lane < kept ? s_len[lane] : 0;
    int cum = len;                       // inclusive scan of the lengths
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, cum, d);
      if (lane >= d) cum += up;
    }
    const int total = __shfl_sync(kFull, cum, 31);
    if (lane < kept) {
      s_off[lane] = min(cum - len, budget);
      // the reference copies at most tail_pmax postings of a segment
      s_len[lane] = min(len, pmax);
    }
    if (lane == 0) {
      s_kept = kept;
      if (blockIdx.y == 0) overflow_out[q] = n_tail > MT || total > budget;
    }
  }
  __syncthreads();
  if (j0 >= W) return;

  bool hit[kLanesPerThread];
  int src[kLanesPerThread];
  float w[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) hit[k] = false;
  const int kept = s_kept;
  for (int t = 0; t < kept; ++t) {       // ascending: the last cover wins
    const int off = s_off[t], len = s_len[t], start = s_start[t];
    const float wt = s_w[t];
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k) {
      const int rel = j0 + k - off;
      if (rel >= 0 && rel < len) {
        hit[k] = true;
        src[k] = start + rel;
        w[k] = wt;
      }
    }
  }
  int d[kLanesPerThread];
  float v[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) {
    if (hit[k]) {
      const int i = min(max(src[k], 0), nnz - 1);
      d[k] = postings_doc[i];
      v[k] = __fmul_rn(postings_w[i], w[k]);
    } else {
      d[k] = sentinel;
      v[k] = -1.0f;
    }
  }
  *dst_d = make_int4(d[0], d[1], d[2], d[3]);
  *dst_v = make_float4(v[0], v[1], v[2], v[3]);
}

}  // namespace

extern "C" int tdr_tail_compact_fused(
    const int* qids, const float* qw, const int* head_slot, const float* df,
    const int* indptr, const int* postings_doc, const float* postings_w,
    int* docs_out, float* vals_out, bool* overflow_out, int Q, int T, int MT,
    int W, int budget, int vocab, int pmax, int nnz, int sentinel,
    void* stream) {
  if (MT > kMaxTerms || MT > T || W % kLanesPerThread) return -1;
  if (Q > 0) {
    const dim3 grid(Q, (W + kLanesPerCta - 1) / kLanesPerCta);
    tail_compact_fused_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        qids, qw, head_slot, df, indptr, postings_doc, postings_w, docs_out,
        vals_out, overflow_out, T, MT, W, budget, vocab, pmax, nnz, sentinel);
  }
  return (int)cudaGetLastError();
}
